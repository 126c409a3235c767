"""Port of ``ray_tpu/train/_session.py``.

Per-worker training session: runs the user loop, plumbs report().

Counterpart of the reference's ``_TrainSession`` (reference:
python/ray/train/_internal/session.py:111 init, :403 report, :667 the public
``train.report``).  The user train loop runs on a daemon thread inside the
train-worker actor; ``report(metrics, checkpoint)`` hands a result to the
actor thread (which ships it to the driver) and blocks until consumed, so the
loop and the driver stay in lockstep exactly like the reference.

Checkpoint flow on report: the worker uploads the user's checkpoint dir to
persistent storage *before* the result crosses the wire (reference:
train/_internal/storage.py persist_current_checkpoint), so the driver only
ever sees durable checkpoints.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ray_tpu_torch._private import fault_injection
from ray_tpu_torch.train._checkpoint import Checkpoint

_session_lock = threading.Lock()
_session: Optional["_TrainSession"] = None


@dataclass
class TrainContext:
    """What a worker knows about its place in the gang (reference:
    train/context.py TrainContext)."""

    world_size: int = 1
    world_rank: int = 0
    local_rank: int = 0
    local_world_size: int = 1
    node_rank: int = 0
    experiment_name: str = ""
    trial_name: str = ""
    trial_dir: str = ""

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_trial_dir(self) -> str:
        return self.trial_dir

    def get_experiment_name(self) -> str:
        return self.experiment_name


@dataclass
class _TrainingResult:
    """One report() payload from one worker."""

    metrics: Dict[str, Any]
    checkpoint_path: Optional[str] = None  # persisted path (storage), if any
    final: bool = False                    # train fn returned
    error: Optional[str] = None            # train fn raised (traceback text)


class _TrainSession:
    def __init__(self, train_fn, config: Dict[str, Any], context: TrainContext,
                 starting_checkpoint: Optional[str] = None,
                 checkpoint_seq_start: int = 0,
                 dataset_shards: Optional[Dict[str, Any]] = None):
        self.context = context
        self.starting_checkpoint = starting_checkpoint
        self.dataset_shards = dataset_shards or {}
        self._result_q: "queue.Queue[_TrainingResult]" = queue.Queue(maxsize=1)
        self._consumed = threading.Semaphore(0)
        # Continue numbering after any earlier attempt's checkpoints (passed
        # by the driver): restarting at 0 would merge fresh state into stale
        # same-numbered dirs.
        self._checkpoint_seq = checkpoint_seq_start
        # report() round counter: stamped into gang state (KV + gauge) at
        # each report START, so one slow rank shows as step skew while its
        # peers sit blocked in the lockstep queue.
        self._step = 0
        self._thread = threading.Thread(
            target=self._run, args=(train_fn, config), daemon=True,
            name="train-loop")

    def start(self) -> None:
        self._thread.start()

    # ------------------------------------------------- train-loop side
    def _run(self, train_fn, config) -> None:
        try:
            import inspect

            sig = inspect.signature(train_fn)
            if len(sig.parameters) >= 1:
                train_fn(config)
            else:
                train_fn()
            self._result_q.put(_TrainingResult(metrics={}, final=True))
        except BaseException:
            import traceback

            self._result_q.put(_TrainingResult(
                metrics={}, final=True, error=traceback.format_exc()))

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        """Called from the user loop.  Persists the checkpoint, enqueues the
        result, and blocks until the actor thread consumed it."""
        import time as _time

        from ray_tpu_torch.train._metrics import train_metrics

        m = train_metrics()
        labels = {"experiment": self.context.experiment_name or ""}
        m["reports"].inc(1, labels)
        self._step += 1
        m["rank_step"].set(self._step, {
            **labels, "rank": str(self.context.world_rank)})
        self._stamp_heartbeat()
        persisted = None
        if checkpoint is not None:
            t0 = _time.perf_counter()
            persisted = self._persist_checkpoint(checkpoint)
            m["ckpt_persist"].observe(_time.perf_counter() - t0, labels)
        if fault_injection.ENABLED and fault_injection.hit(
                "train.report",
                detail=self.context.experiment_name or "") == "kill":
            # dies AFTER the checkpoint persisted but before the result
            # reaches the driver: the restore path must treat the persisted
            # dir as durable only once every rank's report round-tripped
            fault_injection.kill_self()
        self._result_q.put(_TrainingResult(dict(metrics), persisted))
        self._consumed.acquire()  # lockstep with the driver (reference :403)

    def _stamp_heartbeat(self) -> None:
        """Per-rank step heartbeat into gang state (GCS KV, fire-and-forget):
        the driver's result loop folds these into the
        ray_tpu_train_gang_step_skew gauge, so a straggling rank is visible
        WHILE its peers block — lockstep results alone can't show skew."""
        import json
        import time as _time

        from ray_tpu_torch._private import worker as worker_mod

        core = worker_mod.global_worker_core()
        if core is None:
            return  # plain-script report(): no runtime to stamp into
        exp = self.context.experiment_name or self.context.trial_name or \
            "default"
        try:
            core.io.spawn(core.gcs_conn.notify("kv_put", {
                "ns": "train",
                "key": f"train/{exp}/heartbeat/{self.context.world_rank}",
                "value": json.dumps({"step": self._step,
                                     "ts": _time.time()}).encode(),
                "overwrite": True,
            }))
        except Exception:
            pass  # heartbeats must never fail a report

    def _persist_checkpoint(self, checkpoint: Checkpoint) -> str:
        from ray_tpu_torch.train import storage

        seq = self._checkpoint_seq
        self._checkpoint_seq += 1
        ckpt_dir = storage.join(self.context.trial_dir,
                                f"checkpoint_{seq:06d}")
        # Rank 0's files are the canonical checkpoint contents; nonzero ranks
        # (sharded/model-parallel state) land in rank_<k>/ subdirs.  Merge
        # (never replace) so concurrent rank uploads don't clobber each other;
        # completeness is recorded by the driver in progress.json only after
        # every rank's report round-trips, so a crash mid-upload can never
        # yield a trusted half-checkpoint.  The target may be a remote URI
        # (RunConfig(storage_path="gs://...")): TPU-VM disks die with the
        # slice, so durable checkpoints must leave the host.
        target = ckpt_dir if self.context.world_rank == 0 else storage.join(
            ckpt_dir, f"rank_{self.context.world_rank}")
        with checkpoint.as_directory() as local:
            storage.merge_dir(local, target)
        return ckpt_dir

    # ---------------------------------------------------- actor side
    def get_next(self, timeout: Optional[float] = None) -> Optional[_TrainingResult]:
        """Next result from the loop; None on timeout.  After a non-final
        result is returned the loop is released to continue."""
        try:
            result = self._result_q.get(timeout=timeout)
        except queue.Empty:
            return None
        if not result.final:
            self._consumed.release()
        return result

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)


# ============================================================ public API
def init_session(*args, **kwargs) -> _TrainSession:
    global _session
    with _session_lock:
        if _session is not None and _session._thread.is_alive():
            raise RuntimeError("a train session is already running in this process")
        _session = _TrainSession(*args, **kwargs)
        return _session


def get_session() -> Optional[_TrainSession]:
    return _session


def shutdown_session() -> None:
    global _session
    with _session_lock:
        _session = None


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and optionally a checkpoint) from a train worker
    (reference: train/_internal/session.py:667 ``train.report``).  Outside a
    session (plain script) it is a no-op print, so loops are portable."""
    s = get_session()
    if s is None:
        print(f"[train.report] {metrics}")
        return
    s.report(metrics, checkpoint)


def get_dataset_shard(name: str = "train"):
    """This worker's split of a Dataset passed to the trainer as
    ``datasets={name: ds}`` (reference: ray.train.get_dataset_shard) — a
    DataIterator whose iter_batches/iter_jax_batches pull from the shared
    streaming executor."""
    session = get_session()
    if session is None:
        raise RuntimeError("get_dataset_shard() outside a train session")
    shard = session.dataset_shards.get(name)
    if shard is None:
        raise KeyError(
            f"no dataset named {name!r} was passed to the trainer "
            f"(available: {sorted(session.dataset_shards)})")
    return shard


def get_checkpoint() -> Optional[Checkpoint]:
    """The checkpoint to resume from, if the run was restored (reference:
    train.get_checkpoint)."""
    s = get_session()
    if s is None or s.starting_checkpoint is None:
        return None
    return Checkpoint(s.starting_checkpoint)


def get_context() -> TrainContext:
    """World size/rank info inside a train worker (reference:
    train/context.py get_context)."""
    s = get_session()
    if s is None:
        return TrainContext()
    return s.context
