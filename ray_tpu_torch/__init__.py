"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``.

A package beside ``ray_tpu`` that imports neither it nor JAX.  Module names
mirror the JAX package so each port module sits where its counterpart does:
the runtime (``_private/``, ``actor.py``, ``remote_function.py``; the port
of ``ray_tpu/__init__.py``'s surface is below), the Train backend
(``train/``: ``TorchTrainer`` on gang-scheduled GPU worker actors), and the
model stack (``ops/``, ``models/``, ``parallel/``, ``llm/``).  Kernels
written by hand for Hopper live in ``csrc/`` and are compiled with ``nvcc``
at first use (``_native/build.py``); importing the package builds and loads
nothing, and imports no torch (the runtime's GCS and nodelet run without
it).

It serves GPT-2 through ``llm.EngineCore`` and pretrains GPT-2 and Llama
through ``models.pretrain.ShardedPretrainer``, on one card or a mesh, with
hand-written CUDA flash-attention kernels, forward and backward
(``ops/attention.py``).  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.  The runtime's settings are read from
``RAY_TPU_TORCH_*`` variables and its sessions live under
``ray_tpu_torch`` in the temp directory (``TMPDIR``), apart from the JAX
package's.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

from ray_tpu_torch import exceptions
from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.worker import (
    get,
    get_async,
    init,
    is_initialized,
    put,
    shutdown,
    wait,
)
from ray_tpu_torch.actor import ActorClass, ActorHandle, get_actor, method
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.runtime_context import get_runtime_context

__version__ = "0.1.0"


def __getattr__(name):
    # torch is imported on first use only
    if name == "resolve_device":
        from ray_tpu_torch._private.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


# one-time warning flag for cancel(recursive=True) (unimplemented child
# propagation); module-global so it fires once per process, not per call
_warned_recursive_cancel = False


def remote(*args, **kwargs):
    """The @remote decorator (reference: python/ray/_private/worker.py:3151).

    Usage::

        @ray_tpu_torch.remote
        def f(x): ...

        @ray_tpu_torch.remote(num_cpus=2, num_gpus=1)
        class Trainer: ...
    """
    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)
    if args:
        raise TypeError("@remote takes keyword options only, e.g. @remote(num_cpus=2)")

    def wrap(target):
        if isinstance(target, type):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    return wrap


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    """Forcibly kill an actor (reference: ray.kill, worker.py:2828)."""
    _worker.require_core().kill_actor(actor._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True) -> None:
    """Cancel the task producing ``ref`` (reference: ray.cancel).

    Pending tasks fail with TaskCancelledError (dep-blocked tasks are
    caught at dispatch time); running tasks get a cooperative in-thread
    raise on their worker (delivered at the next Python bytecode —
    blocking C calls defer it), and ``force=True`` exits the worker
    process instead.  Cancelled tasks are never retried.  Finished tasks
    are a no-op.  Actor tasks: queued ones cancel immediately, running
    ASYNC methods cancel via asyncio on the actor's worker, running sync
    methods are best-effort (they complete) — the reference's
    async-actor-only cancellation semantics.

    Caveats vs the reference: ``recursive`` does not yet propagate to
    tasks the cancelled task itself spawned; ``force=True`` exits the
    whole worker process, so unrelated tasks pipelined onto the same
    worker are re-queued (retried) — avoid force-cancel around
    non-idempotent work."""
    global _warned_recursive_cancel
    if recursive and not _warned_recursive_cancel:
        # once per process: the default is recursive=True for reference API
        # compatibility, but child-task propagation is not implemented yet —
        # say so instead of silently leaving children running
        _warned_recursive_cancel = True
        import warnings

        warnings.warn(
            "ray_tpu_torch.cancel(recursive=True): cancellation does not yet "
            "propagate to tasks spawned BY the cancelled task — only the "
            "task producing this ref is cancelled (pass recursive=False "
            "to silence this warning)",
            UserWarning, stacklevel=2)
    _worker.require_core().cancel(ref, force=force, recursive=recursive)


def nodes() -> list:
    """Cluster membership (reference: ray.nodes)."""
    core = _worker.require_core()
    view = core.io.run(core.gcs_conn.call("get_all_node_info", None))
    out = []
    for n in view:
        out.append({
            "NodeID": NodeID(n["node_id"]).hex(),
            "Alive": n["alive"],
            "NodeManagerAddress": n["addr"][0],
            "NodeManagerPort": n["addr"][1],
            "Resources": n["total"],
            "Available": n["available"],
            "NodeName": n.get("node_name", ""),
            "Labels": n.get("labels", {}),
        })
    return out


def cluster_resources() -> Dict[str, float]:
    out: Dict[str, float] = {}
    for n in nodes():
        if not n["Alive"]:
            continue
        for k, v in n["Resources"].items():
            out[k] = out.get(k, 0.0) + v
    return out


def available_resources() -> Dict[str, float]:
    out: Dict[str, float] = {}
    for n in nodes():
        if not n["Alive"]:
            continue
        for k, v in n["Available"].items():
            out[k] = out.get(k, 0.0) + v
    return out


__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "kill", "cancel", "get_actor", "method", "nodes", "cluster_resources",
    "available_resources", "get_runtime_context", "get_async",
    "ObjectRef", "ActorHandle", "ActorClass", "RemoteFunction", "exceptions",
    "ActorID", "JobID", "NodeID", "ObjectID", "TaskID", "WorkerID",
    "resolve_device",
]
