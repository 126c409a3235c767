"""Port of ``ray_tpu/train/_worker_group.py``.

WorkerGroup: the gang of train-worker actors.

Counterpart of the reference's ``WorkerGroup`` (reference:
python/ray/train/_internal/worker_group.py:102) — N actors created against one
placement group (one bundle per worker) so the gang is scheduled atomically;
a gang that needs more ``GPU`` than the cluster advertises raises at once.
A backend may bind each worker thread that runs user code to a device
(``set_thread_setup``): the session's loop thread and every ``execute``.
"""

from __future__ import annotations

import socket
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy


@dataclass
class WorkerMetadata:
    """Reference: worker_group.py WorkerMetadata (node id/ip, pid)."""

    node_id: str
    node_ip: str
    pid: int


# run by each worker thread before user code (the backend's device binding:
# CUDA's current device is per thread); None when no backend set one
_thread_setup: Optional[Callable[[], None]] = None


def set_thread_setup(fn: Optional[Callable[[], None]]) -> None:
    global _thread_setup
    _thread_setup = fn


def _with_thread_setup(fn: Callable) -> Callable:
    setup = _thread_setup
    if setup is None:
        return fn

    @functools.wraps(fn)  # the session reads the loop's signature
    def run(*args, **kwargs):
        setup()
        return fn(*args, **kwargs)
    return run


class TrainWorker:
    """Actor body for one training worker: executes arbitrary functions and
    hosts the per-process train session (reference: train/_internal/
    worker_group.py RayTrainWorker)."""

    def get_metadata(self) -> WorkerMetadata:
        import os

        ctx = ray_tpu_torch.get_runtime_context()
        return WorkerMetadata(
            node_id=ctx.get_node_id() or "",
            node_ip=_local_ip(),
            pid=os.getpid(),
        )

    def execute(self, fn: Callable, *args, **kwargs):
        return _with_thread_setup(fn)(*args, **kwargs)

    # ------------------------------------------------------ session verbs
    def session_start(self, train_fn, config, context,
                      starting_checkpoint: Optional[str],
                      checkpoint_seq_start: int = 0,
                      dataset_shards=None) -> None:
        from ray_tpu_torch.train import _session

        s = _session.init_session(_with_thread_setup(train_fn),
                                  config or {}, context,
                                  starting_checkpoint=starting_checkpoint,
                                  checkpoint_seq_start=checkpoint_seq_start,
                                  dataset_shards=dataset_shards)
        s.start()

    def session_get_next(self, timeout: float):
        from ray_tpu_torch.train import _session

        s = _session.get_session()
        if s is None:
            raise RuntimeError("no train session running")
        return s.get_next(timeout=timeout)

    def session_shutdown(self) -> None:
        from ray_tpu_torch.train import _session

        _session.shutdown_session()


def _local_ip() -> str:
    # Best source: the local address of this worker's live GCS connection —
    # a route PROVEN to reach the cluster (the 8.8.8.8 UDP trick can return
    # an unroutable interface, e.g. a TEST-NET tunnel address, and loopback
    # as a coordinator address breaks every nonzero-rank host).
    try:
        from ray_tpu_torch._private import worker as worker_mod

        core = worker_mod.global_worker_core()
        if core is not None and not core.gcs_conn.closed:
            sockname = core.gcs_conn._writer.get_extra_info("sockname")
            if sockname and sockname[0] not in ("0.0.0.0", "::", "::1") \
                    and not sockname[0].startswith("127."):
                return sockname[0]
    except Exception:
        pass
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("8.8.8.8", 80))
            return s.getsockname()[0]
    except OSError:
        pass
    try:
        ip = socket.gethostbyname(socket.gethostname())
        if not ip.startswith("127."):
            return ip
    except OSError:
        pass
    return "127.0.0.1"


class WorkerGroup:
    """N gang-scheduled TrainWorker actors + their metadata."""

    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 placement_strategy: str = "PACK",
                 ready_timeout_s: float = 60.0):
        self.num_workers = num_workers
        self.resources_per_worker = dict(resources_per_worker)
        gpus = resources_per_worker.get("GPU", 0.0) * num_workers
        if gpus:
            have = ray_tpu_torch.cluster_resources().get("GPU", 0.0)
            if have < gpus:
                raise RuntimeError(
                    f"train worker group: {num_workers}x"
                    f"{resources_per_worker} needs {gpus:g} GPU, the "
                    f"cluster advertises {have:g}: run where the cards "
                    f"are, or pass ScalingConfig(use_gpu=False) for CPU "
                    f"workers")
        bundles = [dict(resources_per_worker) for _ in range(num_workers)]
        self._pg: Optional[PlacementGroup] = placement_group(
            bundles, strategy=placement_strategy, name="train-worker-group")
        if not self._pg.ready(timeout=ready_timeout_s):
            pg, self._pg = self._pg, None
            remove_placement_group(pg)
            raise TimeoutError(
                f"train worker group: {num_workers}x{resources_per_worker} "
                f"({placement_strategy}) not schedulable within "
                f"{ready_timeout_s}s")

        worker_cls = ray_tpu_torch.remote(TrainWorker)
        num_cpus = resources_per_worker.get("CPU", 1.0)
        num_gpus = resources_per_worker.get("GPU", 0.0)
        extra = {k: v for k, v in resources_per_worker.items()
                 if k not in ("CPU", "GPU")}
        self.workers: List = []
        try:
            self.workers = [
                worker_cls.options(
                    num_cpus=num_cpus,
                    num_gpus=num_gpus,
                    resources=extra or None,
                    scheduling_strategy=PlacementGroupSchedulingStrategy(
                        placement_group=self._pg,
                        placement_group_bundle_index=i),
                ).remote()
                for i in range(num_workers)
            ]
            self.metadata: List[WorkerMetadata] = ray_tpu_torch.get(
                [w.get_metadata.remote() for w in self.workers])
        except Exception:
            # never leak reserved bundles/actors out of a failed bring-up:
            # a leaked PG would starve every retry's scheduling forever
            self.shutdown()
            raise

    def execute_async(self, fn: Callable, *args, **kwargs) -> List:
        return [w.execute.remote(fn, *args, **kwargs) for w in self.workers]

    def execute(self, fn: Callable, *args, **kwargs) -> List:
        return ray_tpu_torch.get(self.execute_async(fn, *args, **kwargs))

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs) -> Any:
        return ray_tpu_torch.get(self.workers[rank].execute.remote(fn, *args, **kwargs))

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        if self._pg is not None:
            try:
                remove_placement_group(self._pg)
            except Exception:
                pass
            self._pg = None

    def __len__(self) -> int:
        return len(self.workers)
