"""Port of ``ray_tpu/train/_backend_executor.py``.

BackendExecutor: worker-group lifecycle + lockstep result gathering.

Counterpart of the reference's ``BackendExecutor`` (reference:
python/ray/train/_internal/backend_executor.py:67, start :129,
start_training :445, get_next_results pattern in
train/_internal/training_loop_utils).  Owns the WorkerGroup, runs the backend
hooks (TorchConfig → torch.distributed bring-up), starts the per-worker sessions,
and gathers one ``report()`` result per worker per round so the driver sees
the gang advance in lockstep.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.exceptions import RayError
from ray_tpu_torch.train._session import TrainContext, _TrainingResult
from ray_tpu_torch.train._worker_group import WorkerGroup
from ray_tpu_torch.train.torch_config import BackendConfig


class TrainingFailedError(RayError):
    """A worker raised or died mid-training (reference:
    train/base_trainer.py TrainingFailedError)."""

    def __init__(self, msg: str, worker_rank: Optional[int] = None):
        super().__init__(msg)
        self.worker_rank = worker_rank


class BackendExecutor:
    def __init__(self, backend_config: BackendConfig,
                 scaling_config: ScalingConfig):
        self._backend_config = backend_config
        self._backend = backend_config.backend_cls()
        self._scaling_config = scaling_config
        self.worker_group: Optional[WorkerGroup] = None
        self._experiment = ""  # heartbeat key space, set by start_training
        self._experiment_label = ""

    # ---------------------------------------------------------- lifecycle
    def start(self) -> None:
        sc = self._scaling_config
        self.worker_group = WorkerGroup(
            num_workers=sc.num_workers,
            resources_per_worker=sc._worker_resources,
            placement_strategy=sc.placement_strategy,
        )
        try:
            self._backend.on_start(self.worker_group, self._backend_config)
        except Exception:
            self.worker_group.shutdown()
            self.worker_group = None
            raise

    def start_training(self, train_fn, train_loop_config: Dict[str, Any],
                       experiment_name: str, trial_name: str, trial_dir: str,
                       checkpoint_path: Optional[str] = None,
                       checkpoint_seq_start: int = 0,
                       dataset_shards: Optional[list] = None) -> None:
        assert self.worker_group is not None, "call start() first"
        wg = self.worker_group
        # heartbeat KV key space (must mirror _TrainSession._stamp_heartbeat)
        # vs metric label (must mirror the other train_* series' label)
        self._experiment = experiment_name or trial_name or "default"
        self._experiment_label = experiment_name or ""
        self._backend.on_training_start(wg, self._backend_config)

        # local ranks: position among the workers sharing a node (reference:
        # backend_executor.py _create_rank_world_size_mappings)
        per_node: Dict[str, List[int]] = collections.defaultdict(list)
        for rank, meta in enumerate(wg.metadata):
            per_node[meta.node_id].append(rank)
        node_order = list(per_node)
        contexts = []
        for rank, meta in enumerate(wg.metadata):
            siblings = per_node[meta.node_id]
            contexts.append(TrainContext(
                world_size=len(wg),
                world_rank=rank,
                local_rank=siblings.index(rank),
                local_world_size=len(siblings),
                node_rank=node_order.index(meta.node_id),
                experiment_name=experiment_name,
                trial_name=trial_name,
                trial_dir=trial_dir,
            ))
        ray_tpu_torch.get([
            w.session_start.remote(train_fn, train_loop_config, ctx,
                                   checkpoint_path, checkpoint_seq_start,
                                   dataset_shards[rank] if dataset_shards
                                   else None)
            for rank, (w, ctx) in enumerate(zip(wg.workers, contexts))
        ])

    # ------------------------------------------------------------ results
    def get_next_results(self, timeout_s: float = 600.0,
                         poll_s: float = 1.0) -> Optional[List[_TrainingResult]]:
        """One result per worker, or None once every worker's loop returned.

        Raises TrainingFailedError if any worker raised or its actor died.
        Workers must call report() the same number of times (lockstep
        invariant, same as the reference).
        """
        import time

        assert self.worker_group is not None
        wg = self.worker_group
        results: List[Optional[_TrainingResult]] = [None] * len(wg)
        deadline = time.monotonic() + timeout_s
        while any(r is None for r in results):
            self._observe_gang_skew()
            if time.monotonic() > deadline:
                raise TrainingFailedError(
                    f"no report() from workers "
                    f"{[i for i, r in enumerate(results) if r is None]} "
                    f"within {timeout_s}s")
            pending = [(i, wg.workers[i].session_get_next.remote(poll_s))
                       for i, r in enumerate(results) if r is None]
            for i, ref in pending:
                try:
                    results[i] = ray_tpu_torch.get(ref)
                except RayError as e:
                    # actor death OR an executor-side raise both kill the run
                    raise TrainingFailedError(
                        f"train worker {i} failed: {e}", worker_rank=i) from e
            # Surface a captured error IMMEDIATELY: peers of a crashed rank
            # may be blocked in a collective and will never report — waiting
            # for them would stall until the timeout and then mask the real
            # traceback behind a generic "no report()" message.
            for i, r in enumerate(results):
                if r is not None and r.error:
                    raise TrainingFailedError(
                        f"train loop failed on worker {i}:\n{r.error}",
                        worker_rank=i)
        finals = [r.final for r in results]
        if all(finals):
            return None
        if any(finals):
            uneven = [i for i, f in enumerate(finals) if f]
            raise TrainingFailedError(
                f"workers {uneven} finished while others are still "
                f"report()ing — all workers must report the same number of "
                f"times")
        return results  # type: ignore[return-value]

    def _observe_gang_skew(self) -> None:
        """Fold the workers' per-rank step heartbeats (stamped into the GCS
        KV by _TrainSession.report) into the ray_tpu_train_gang_step_skew
        gauge.  Runs on each driver poll round, i.e. exactly while the
        driver is waiting on the gang — when skew matters."""
        import json

        from ray_tpu_torch._private.worker import global_worker_core
        from ray_tpu_torch.train._metrics import train_metrics

        core = global_worker_core()
        if core is None or self.worker_group is None:
            return
        try:
            vals = core.gcs_call_sync("kv_multi_get", {
                "ns": "train",
                "keys": [f"train/{self._experiment}/heartbeat/{r}"
                         for r in range(len(self.worker_group))],
            }, timeout=10)
            steps = [json.loads(v)["step"] for v in vals.values()]
        except Exception:
            return  # a GCS hiccup must not fail the training loop
        if not steps:
            return
        train_metrics()["step_skew"].set(
            max(steps) - min(steps) if len(steps) > 1 else 0.0,
            {"experiment": self._experiment_label})

    def shutdown(self) -> None:
        if self.worker_group is None:
            return
        try:
            self._backend.on_shutdown(self.worker_group, self._backend_config)
        except Exception:
            pass
        self.worker_group.shutdown()
        self.worker_group = None
