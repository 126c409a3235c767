"""Port of ``ray_tpu/workflow/__init__.py``.

Durable workflows: DAGs whose step results survive process death.

Reference: python/ray/workflow/ (workflow_executor.py, workflow_storage.py,
api.py) — run a task DAG with each step's output persisted, so a crashed
driver resumes from the last completed step instead of recomputing.

Mechanics: ``workflow.run(dag, workflow_id)`` walks the DAG depth-first.
Each step has a deterministic id (function name + position in the graph);
before running a step the executor checks storage — a hit short-circuits the
whole subtree (reference: workflow_state_from_storage reconstruction).  The
DAG itself is cloudpickled at submission so ``workflow.resume(workflow_id)``
can re-drive it without the original driver code in scope.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.dag import DAGNode

def _storage_root(storage: Optional[str]) -> str:
    from ray_tpu_torch._private.config import RayConfig

    return os.path.expanduser(
        storage
        or os.environ.get("RAY_TPU_TORCH_WORKFLOW_STORAGE")
        or RayConfig.workflow_storage)


class _WorkflowStorage:
    """reference: workflow/workflow_storage.py — filesystem-backed."""

    def __init__(self, root: str, workflow_id: str):
        self.dir = os.path.join(root, workflow_id)
        os.makedirs(os.path.join(self.dir, "steps"), exist_ok=True)

    def save_dag(self, dag: DAGNode) -> None:
        import cloudpickle

        with open(os.path.join(self.dir, "dag.pkl"), "wb") as f:
            cloudpickle.dump(dag, f)

    def load_dag(self) -> DAGNode:
        with open(os.path.join(self.dir, "dag.pkl"), "rb") as f:
            return pickle.load(f)

    def set_status(self, status: str, **extra) -> None:
        rec = {"status": status, "time": time.time(), **extra}
        with open(os.path.join(self.dir, "status.json"), "w") as f:
            json.dump(rec, f)

    def get_status(self) -> Optional[dict]:
        try:
            with open(os.path.join(self.dir, "status.json")) as f:
                return json.load(f)
        except OSError:
            return None

    def has_step(self, step_id: str) -> bool:
        return os.path.exists(self._step_path(step_id))

    def load_step(self, step_id: str) -> Any:
        with open(self._step_path(step_id), "rb") as f:
            return pickle.load(f)

    def load_step_or_discard(self, step_id: str):
        """(True, value) for a readable step; (False, None) after discarding
        a half-written/corrupt file (a crash between open and the atomic
        rename can't produce one, but a torn disk or manual copy can — the
        recovery contract is re-run, never trust garbage).  ONLY corruption
        signatures discard: transient IO errors (EMFILE/EIO) propagate
        rather than destroying durable state and re-running side-effecting
        steps."""
        try:
            return True, self.load_step(step_id)
        except (EOFError, pickle.UnpicklingError, ValueError, KeyError,
                IndexError):
            try:
                os.remove(self._step_path(step_id))
            except OSError:
                pass
            return False, None

    def save_step(self, step_id: str, value: Any) -> None:
        tmp = self._step_path(step_id) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, self._step_path(step_id))  # atomic: crash-safe

    def _step_path(self, step_id: str) -> str:
        return os.path.join(self.dir, "steps", step_id + ".pkl")


def _step_ids(dag: DAGNode) -> Dict[int, str]:
    """Deterministic step ids from graph structure: '<position>_<fn name>'
    in depth-first postorder (stable across runs of the same DAG)."""
    order: Dict[int, str] = {}
    counter = [0]

    def visit(node: DAGNode):
        if id(node) in order:
            return
        for up in node.upstream():
            visit(up)
        order[id(node)] = f"{counter[0]:04d}_{node.fn_name()}"
        counter[0] += 1

    visit(dag)
    return order


def run(dag: DAGNode, *, workflow_id: Optional[str] = None,
        storage: Optional[str] = None) -> Any:
    """Execute a DAG durably; returns the root step's result."""
    import uuid

    if not isinstance(dag, DAGNode):
        raise TypeError("workflow.run takes a DAG built with fn.bind(...)")
    workflow_id = workflow_id or f"wf-{uuid.uuid4().hex[:10]}"
    store = _WorkflowStorage(_storage_root(storage), workflow_id)
    store.save_dag(dag)
    store.set_status("RUNNING", workflow_id=workflow_id)
    try:
        result = _execute(dag, store)
    except BaseException as e:
        store.set_status("FAILED", error=repr(e))
        raise
    store.set_status("SUCCEEDED")
    return result


def resume(workflow_id: str, *, storage: Optional[str] = None) -> Any:
    """Re-drive a workflow from its persisted DAG; completed steps load from
    storage, the rest run (reference: workflow resume-from-storage)."""
    store = _WorkflowStorage(_storage_root(storage), workflow_id)
    dag = store.load_dag()
    store.set_status("RUNNING", workflow_id=workflow_id, resumed=True)
    try:
        result = _execute(dag, store)
    except BaseException as e:
        store.set_status("FAILED", error=repr(e))
        raise
    store.set_status("SUCCEEDED")
    return result


def get_status(workflow_id: str, *, storage: Optional[str] = None) -> Optional[str]:
    rec = _WorkflowStorage(_storage_root(storage), workflow_id).get_status()
    return rec["status"] if rec else None


def list_all(storage: Optional[str] = None) -> List[Dict[str, Any]]:
    root = _storage_root(storage)
    out = []
    if not os.path.isdir(root):
        return out
    for wid in sorted(os.listdir(root)):
        status_path = os.path.join(root, wid, "status.json")
        if not os.path.isfile(status_path):
            continue  # not a workflow dir (read-only scan: create nothing)
        try:
            with open(status_path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        out.append({"workflow_id": wid, **rec})
    return out


def _execute(dag: DAGNode, store: _WorkflowStorage) -> Any:
    ids = _step_ids(dag)
    cache: Dict[int, Any] = {}

    def run_node(node: DAGNode) -> Any:
        key = id(node)
        if key in cache:
            return cache[key]
        step_id = ids[key]
        loaded = False
        if store.has_step(step_id):
            loaded, value = store.load_step_or_discard(step_id)
        if not loaded:
            args = [run_node(a) if isinstance(a, DAGNode) else a
                    for a in node._bound_args]
            kwargs = {k: (run_node(v) if isinstance(v, DAGNode) else v)
                      for k, v in node._bound_kwargs.items()}
            value = ray_tpu_torch.get(node._remote_fn.remote(*args, **kwargs))
            store.save_step(step_id, value)
        cache[key] = value
        return value

    return run_node(dag)
