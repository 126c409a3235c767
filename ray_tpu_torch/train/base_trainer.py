"""Port of ``ray_tpu/train/base_trainer.py``.

BaseTrainer + DataParallelTrainer.

Counterpart of the reference's trainer stack (reference:
python/ray/train/base_trainer.py:111 BaseTrainer, fit :567;
train/data_parallel_trainer.py:25 DataParallelTrainer, _run_training :362).
The reference routes every ``fit()`` through a single-trial Tuner
(base_trainer.py:577-623); here ``fit()`` runs through
``ray_tpu_torch.tune.run_single_trial`` — the same controller Tune uses — so
failure retries, experiment snapshots, and checkpoint bookkeeping are one
code path whether the trainer is used standalone or under a Tuner.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Callable, Dict, Optional

import cloudpickle

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train._backend_executor import BackendExecutor, TrainingFailedError
from ray_tpu_torch.train import storage
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.torch_config import BackendConfig

_TRAINER_PKL = "trainer.pkl"
_PROGRESS_JSON = "progress.json"


class BaseTrainer:
    """Reference: train/base_trainer.py:111."""

    def __init__(self, *, scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        import copy

        self.scaling_config = scaling_config or ScalingConfig()
        # private copy: auto-generating a name must not mutate a RunConfig
        # the caller may share between trainers
        self.run_config = copy.deepcopy(run_config) if run_config else RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        if self.run_config.name is None:
            self.run_config.name = (
                f"{type(self).__name__}_{time.strftime('%Y-%m-%d_%H-%M-%S')}"
                f"_{uuid.uuid4().hex[:6]}")

    # ------------------------------------------------------------------ fit
    def fit(self) -> Result:
        """Run to completion, with FailureConfig-driven retries restoring
        from the latest durable checkpoint (reference: fit routes through
        Tuner, base_trainer.py:577-623)."""
        from ray_tpu_torch.tune._single_trial import run_trainer_as_single_trial

        return run_trainer_as_single_trial(self)

    # --------------------------------------------------------- restoration
    @classmethod
    def can_restore(cls, path: str) -> bool:
        return storage.exists(
            storage.join(storage.expand(path), _TRAINER_PKL))

    @classmethod
    def restore(cls, path: str, **overrides) -> "BaseTrainer":
        """Rebuild a trainer from a trial dir written by a previous fit();
        training resumes from the latest complete checkpoint (reference:
        base_trainer.py restore/can_restore)."""
        path = storage.expand(path)
        state = cloudpickle.loads(
            storage.read_bytes(storage.join(path, _TRAINER_PKL)))
        trainer: BaseTrainer = state["trainer"]
        for k, v in overrides.items():
            if v is not None:
                setattr(trainer, k, v)
        latest = latest_checkpoint(path)
        if latest:
            trainer.resume_from_checkpoint = Checkpoint(latest)
        # keep writing into the same trial dir
        trainer.run_config.name = state["name"]
        trainer.run_config.storage_path = state["storage_path"]
        return trainer

    # ------------------------------------------------------------- plumbing
    @property
    def trial_dir(self) -> str:
        return storage.join(storage.expand(self.run_config.storage_path),
                            self.run_config.name)

    def _save_trainer_state(self) -> None:
        storage.makedirs(self.trial_dir)
        storage.write_bytes(
            storage.join(self.trial_dir, _TRAINER_PKL),
            cloudpickle.dumps({
                "trainer": self,
                "name": self.run_config.name,
                "storage_path": self.run_config.storage_path,
            }))

    def training_loop(self) -> Result:
        """One attempt; subclasses implement.  Retries are the caller's job
        (single-trial controller)."""
        raise NotImplementedError


def _next_checkpoint_seq(trial_dir: str) -> int:
    """First unused checkpoint number: a restarted attempt must not merge
    fresh state into a stale same-numbered dir."""
    seqs = []
    try:
        for d in storage.listdir(trial_dir):
            if d.startswith("checkpoint_"):
                try:
                    seqs.append(int(d.split("_", 1)[1]))
                except ValueError:
                    pass
    except OSError:
        pass
    return max(seqs) + 1 if seqs else 0


def latest_checkpoint(trial_dir: str) -> Optional[str]:
    """The newest checkpoint recorded COMPLETE in progress.json (written by
    the driver only after every rank's report round-tripped) — scanning the
    filesystem would trust half-written dirs."""
    progress = storage.join(trial_dir, _PROGRESS_JSON)
    try:
        data = json.loads(storage.read_bytes(progress))
    except (OSError, json.JSONDecodeError):
        return None
    path = data.get("latest_checkpoint")
    return path if path and storage.exists(path) else None


class DataParallelTrainer(BaseTrainer):
    """SPMD function-trainer: same ``train_loop_per_worker`` on every worker
    of the gang (reference: train/data_parallel_trainer.py:25)."""

    _default_backend_config: BackendConfig = BackendConfig()

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[Dict[str, Any]] = None,
                 backend_config: Optional[BackendConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        super().__init__(scaling_config=scaling_config, run_config=run_config,
                         resume_from_checkpoint=resume_from_checkpoint)
        if not callable(train_loop_per_worker):
            raise ValueError("train_loop_per_worker must be callable "
                             "(taking 0 or 1 argument: the config dict)")
        self.train_loop_per_worker = train_loop_per_worker
        self.train_loop_config = train_loop_config or {}
        self.backend_config = backend_config or self._default_backend_config
        # name -> ray_tpu_torch.data.Dataset; split per-worker at fit time and
        # consumed in the loop via train.get_dataset_shard (reference:
        # data_parallel_trainer.py datasets= + session dataset_shard)
        self.datasets = datasets or {}

    # ------------------------------------------------------- one attempt
    def training_loop(self) -> Result:
        """Reference: data_parallel_trainer.py:362 _run_training — but the
        executor lives on the driver side of the trial."""
        from ray_tpu_torch.train._metrics import GANG_STATES, train_metrics

        trial_dir = self.trial_dir
        storage.makedirs(trial_dir)
        self._save_trainer_state()

        metrics = train_metrics()
        mlabels = {"experiment": self.run_config.name or ""}
        metrics["gang_state"].set(GANG_STATES["STARTING"], mlabels)
        executor = BackendExecutor(self.backend_config, self.scaling_config)
        executor.start()
        metrics_history = []
        latest_ckpt: Optional[str] = (
            self.resume_from_checkpoint.path
            if self.resume_from_checkpoint else None)
        last_metrics: Dict[str, Any] = {}
        # Each named dataset splits into one coordinated streaming iterator
        # per worker; equal=True keeps lockstep SPMD loops in sync.
        n_workers = self.scaling_config.num_workers
        dataset_shards: Optional[list] = None
        if self.datasets:
            per_name = {name: ds.streaming_split(n_workers, equal=True)
                        for name, ds in self.datasets.items()}
            dataset_shards = [
                {name: its[rank] for name, its in per_name.items()}
                for rank in range(n_workers)
            ]
        try:
            executor.start_training(
                self.train_loop_per_worker, self.train_loop_config,
                experiment_name=self.run_config.name or "",
                trial_name=self.run_config.name or "",
                trial_dir=trial_dir,
                checkpoint_path=latest_ckpt,
                checkpoint_seq_start=_next_checkpoint_seq(trial_dir),
                dataset_shards=dataset_shards,
            )
            metrics["gang_state"].set(GANG_STATES["RUNNING"], mlabels)
            metrics["gang_workers"].set(n_workers, mlabels)
            while True:
                results = executor.get_next_results(
                    timeout_s=self.run_config.worker_report_timeout_s)
                if results is None:
                    break
                metrics["report_rounds"].inc(1, mlabels)
                rank0 = results[0]
                last_metrics = rank0.metrics
                metrics_history.append(rank0.metrics)
                ckpts = {r.checkpoint_path for r in results if r.checkpoint_path}
                if ckpts:
                    if len(ckpts) > 1:
                        raise TrainingFailedError(
                            f"ranks persisted to different checkpoint dirs: "
                            f"{sorted(ckpts)}")
                    latest_ckpt = ckpts.pop()
                    self._write_progress(trial_dir, latest_ckpt, last_metrics)
                    self._apply_retention(trial_dir, latest_ckpt)
            metrics["gang_state"].set(GANG_STATES["FINISHED"], mlabels)
        except BaseException:
            metrics["gang_state"].set(GANG_STATES["FAILED"], mlabels)
            raise
        finally:
            metrics["gang_workers"].set(0, mlabels)
            executor.shutdown()
            if dataset_shards is not None:
                import ray_tpu_torch

                for its in per_name.values():
                    ray_tpu_torch.kill(its[0]._coord)

        return Result(
            metrics=last_metrics,
            checkpoint=Checkpoint(latest_ckpt) if latest_ckpt else None,
            path=trial_dir,
            metrics_history=metrics_history,
        )

    def _write_progress(self, trial_dir: str, ckpt: str, metrics) -> None:
        storage.write_bytes(
            storage.join(trial_dir, _PROGRESS_JSON),
            json.dumps({"latest_checkpoint": ckpt,
                        "metrics": _jsonable(metrics),
                        "time": time.time()}).encode())

    def _apply_retention(self, trial_dir: str, latest: str) -> None:
        keep = self.run_config.checkpoint_config.num_to_keep
        if keep is None:
            return
        ckpts = sorted(
            d for d in storage.listdir(trial_dir)
            if d.startswith("checkpoint_"))
        for d in ckpts[:-keep]:
            full = storage.join(trial_dir, d)
            if full != latest:
                storage.rmtree(full)


def _jsonable(obj):
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return {k: v for k, v in obj.items()
                if isinstance(v, (int, float, str, bool, type(None)))} \
            if isinstance(obj, dict) else str(obj)
