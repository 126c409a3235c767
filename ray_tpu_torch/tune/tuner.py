"""Port of ``ray_tpu/tune/tuner.py``.

Tuner: concurrent fault-tolerant trial execution.

Counterpart of the reference's Tuner/TuneController (reference:
python/ray/tune/tuner.py:44, fit :344; tune/execution/tune_controller.py:68).
Redesign: each trial runs as a remote TASK in its own worker process — a
function trainable runs directly; a Trainer trainable becomes a nested trial
driver that builds its own gang-scheduled worker group (the reference's
trial-actor → BackendExecutor layering, collapsed by one level).  The
controller is an event loop over ``ray_tpu_torch.wait`` with per-trial retry
bookkeeping (FailureConfig.max_failures).

Experiment state is snapshotted to <storage>/<name>/tuner_state.json after
every trial transition (reference: tune/execution/experiment_state.py:61).
"""

from __future__ import annotations

import copy
import json
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import ray_tpu_torch
from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.train import storage as _storage
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.exceptions import RayError
from ray_tpu_torch.tune.search import generate_variants


@dataclass
class TuneConfig:
    """reference: tune/tune_config.py."""

    num_samples: int = 1
    max_concurrent_trials: int = 2
    metric: Optional[str] = None
    mode: str = "max"
    trial_resources: Dict[str, float] = field(default_factory=lambda: {"CPU": 1.0})
    scheduler: Optional[Any] = None  # FIFOScheduler | ASHAScheduler | PBT
    # Model-based searcher (e.g. search.TPESearcher): suggests each trial's
    # config from completed results instead of sampling independently
    # (reference: tune/search/ searchers).
    search_alg: Optional[Any] = None

    def __post_init__(self):
        if self.mode not in ("max", "min"):
            raise ValueError("mode must be 'max' or 'min'")


@dataclass
class Trial:
    """reference: tune/experiment/trial.py (state machine subset)."""

    index: int
    config: Dict[str, Any]
    name: str
    status: str = "PENDING"  # PENDING | RUNNING | TERMINATED | ERROR
    num_failures: int = 0
    result: Optional[Result] = None
    error: Optional[str] = None


class ResultGrid:
    """reference: tune/result_grid.py."""

    def __init__(self, results: List[Result], metric: Optional[str],
                 mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    @property
    def errors(self) -> List[Exception]:
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("pass metric= (or set TuneConfig.metric)")
        ok = [r for r in self._results
              if r.error is None and metric in r.metrics]
        if not ok:
            raise RuntimeError("no successful trial reported "
                               f"metric {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return max(ok, key=key) if mode == "max" else min(ok, key=key)

    def get_dataframe(self):
        rows = [dict(r.metrics, trial_path=r.path) for r in self._results
                if r.error is None]
        try:
            import pandas as pd

            return pd.DataFrame(rows)
        except ImportError:
            return rows


def _run_function_trial(fn: Callable, config: Dict[str, Any],
                        trial_dir: str, coordinator=None,
                        trial_index: int = -1,
                        start_checkpoint=None) -> Dict[str, Any]:
    """Task body for a function trainable: returns its final metrics dict.
    Installs a tune session so ``tune.report`` streams intermediate metrics
    to the controller and cooperative early-stop works (ASHA/PBT)."""
    from ray_tpu_torch.tune import session as tune_session

    _storage.makedirs(trial_dir)
    sess = None
    if coordinator is not None:
        sess = tune_session._TuneSession(coordinator, trial_index)
        sess.start_checkpoint = start_checkpoint
        tune_session._set_session(sess)
    try:
        out = fn(config)
    except tune_session.StopTrial:
        out = dict(sess.last_metrics or {})
        out["__early_stopped__"] = True
    finally:
        tune_session._set_session(None)
    if out is None:
        out = dict(sess.last_metrics or {}) if sess else {}
    if not isinstance(out, dict):
        raise TypeError(
            f"function trainable must return a metrics dict, got {type(out)}")
    return out


def _run_trainer_trial(trainer_blob: bytes, config: Dict[str, Any],
                       trial_name: str) -> Dict[str, Any]:
    """Task body for a Trainer trainable: this worker process becomes the
    trial driver — it deserializes the trainer, merges the trial config into
    train_loop_config, and runs fit() (which builds its own worker group)."""
    import cloudpickle

    trainer = cloudpickle.loads(trainer_blob)
    trainer.train_loop_config = {**trainer.train_loop_config, **config}
    trainer.run_config.name = trial_name
    result = trainer.fit()
    return {"_metrics": result.metrics, "_path": result.path,
            "_checkpoint": result.checkpoint.path if result.checkpoint else None,
            "_history": result.metrics_history}


class Tuner:
    def __init__(self, trainable: Union[Callable, Any], *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = copy.deepcopy(run_config) if run_config else RunConfig()
        if self._run_config.name is None:
            self._run_config.name = \
                f"tune_{time.strftime('%Y-%m-%d_%H-%M-%S')}_{uuid.uuid4().hex[:6]}"

    # ------------------------------------------------------------------ fit
    def fit(self) -> ResultGrid:
        from ray_tpu_torch.train.base_trainer import BaseTrainer

        is_trainer = isinstance(self._trainable, BaseTrainer)
        searcher = self._tune_config.search_alg
        if searcher is not None:
            # model-based search: configs are suggested lazily at submit
            # time so each suggestion sees every completed result
            searcher.setup(self._param_space, self._tune_config.metric,
                           self._tune_config.mode)
            variants = [None] * max(self._tune_config.num_samples, 1)
        else:
            variants = generate_variants(self._param_space,
                                         self._tune_config.num_samples)
        exp_dir = _storage.join(
            _storage.expand(self._run_config.storage_path),
            self._run_config.name)
        _storage.makedirs(exp_dir)
        trials = [
            Trial(index=i, config=v, name=f"trial_{i:05d}")
            for i, v in enumerate(variants)
        ]

        if is_trainer:
            import cloudpickle

            base = copy.deepcopy(self._trainable)
            base.run_config = copy.deepcopy(self._run_config)
            base.run_config.storage_path = exp_dir
            # per-trial retries happen inside the nested fit(); the
            # controller-level retry below handles process/node loss
            trainer_blob = cloudpickle.dumps(base)

        max_failures = self._run_config.failure_config.max_failures
        remote_opts = {"num_cpus":
                       self._tune_config.trial_resources.get("CPU", 1.0),
                       "max_retries": 0}
        extra = {k: v for k, v in self._tune_config.trial_resources.items()
                 if k != "CPU"}
        if extra:
            remote_opts["resources"] = extra

        fn_task = ray_tpu_torch.remote(_run_function_trial).options(**remote_opts)
        tr_task = ray_tpu_torch.remote(_run_trainer_trial).options(**remote_opts)

        # Scheduler + intermediate-result channel (reference: TuneController
        # feeding its TrialScheduler; schedulers.py ASHA/PBT).
        from ray_tpu_torch.tune._trial_coordinator import TrialCoordinator
        from ray_tpu_torch.tune.schedulers import FIFOScheduler

        scheduler = self._tune_config.scheduler or FIFOScheduler()
        scheduler.set_experiment(self._tune_config.metric,
                                 self._tune_config.mode)
        # Plain FIFO needs no intermediate-result channel: skip the
        # coordinator actor (and its 0.5s polling) entirely.
        needs_coordinator = type(scheduler) is not FIFOScheduler \
            and not is_trainer
        coordinator = TrialCoordinator.remote() if needs_coordinator else None

        def submit(trial: Trial, start_checkpoint=None):
            trial.status = "RUNNING"
            if coordinator is not None:
                ray_tpu_torch.get(coordinator.clear_trial.remote(trial.index),
                            timeout=60)
            if is_trainer:
                return tr_task.remote(trainer_blob, trial.config, trial.name)
            return fn_task.remote(self._trainable, trial.config,
                                  _storage.join(exp_dir, trial.name),
                                  coordinator, trial.index, start_checkpoint)

        by_index = {t.index: t for t in trials}

        def pump_scheduler():
            from ray_tpu_torch.tune.schedulers import STOP, PopulationBasedTraining

            if coordinator is None:
                return
            for ev in ray_tpu_torch.get(coordinator.drain.remote(), timeout=60):
                trial = by_index.get(ev["trial"])
                if trial is None or trial.status != "RUNNING":
                    continue
                if ev.get("checkpoint") is not None and \
                        isinstance(scheduler, PopulationBasedTraining):
                    scheduler.record_checkpoint(trial.index, ev["checkpoint"])
                if scheduler.on_result(trial, ev["metrics"]) == STOP:
                    ray_tpu_torch.get(coordinator.set_stop.remote(trial.index),
                                timeout=60)

        pending = list(trials)
        running: Dict[Any, Trial] = {}
        wait_timeout = 0.5 if coordinator is not None else None
        try:
            return self._drive(trials, pending, running, submit,
                               pump_scheduler, scheduler, exp_dir, is_trainer,
                               max_failures, wait_timeout)
        finally:
            if coordinator is not None:
                try:
                    ray_tpu_torch.kill(coordinator)
                except Exception:
                    pass

    def _drive(self, trials, pending, running, submit, pump_scheduler,
               scheduler, exp_dir, is_trainer, max_failures, wait_timeout):
        searcher = self._tune_config.search_alg
        while pending or running:
            while pending and len(running) < \
                    self._tune_config.max_concurrent_trials:
                t = pending.pop(0)
                if t.config is None:
                    t.config = searcher.suggest()
                ckpt = t.config.pop("__pbt_checkpoint__", None)
                running[submit(t, ckpt)] = t
            ready, _ = ray_tpu_torch.wait(list(running), num_returns=1,
                                    timeout=wait_timeout)
            pump_scheduler()
            if not ready:
                continue
            ref = ready[0]
            trial = running.pop(ref)
            try:
                out = ray_tpu_torch.get(ref)
            except (RayError, Exception) as e:  # noqa: B902
                trial.num_failures += 1
                if max_failures < 0 or trial.num_failures <= max_failures:
                    pending.append(trial)
                    trial.status = "PENDING"
                else:
                    trial.status = "ERROR"
                    trial.error = repr(e)
                    trial.result = Result(
                        metrics={"config": trial.config}, error=e,
                        path=_storage.join(exp_dir, trial.name))
                self._snapshot(exp_dir, trials)
                continue
            trial.status = "TERMINATED"
            if searcher is not None and isinstance(out, dict):
                final = out.get("_metrics", out) if is_trainer else out
                searcher.on_trial_complete(
                    trial.config, (final or {}).get(self._tune_config.metric))
            decision = scheduler.on_trial_complete(
                trial, out if isinstance(out, dict) else None)
            if decision is not None and decision[0] == "restart":
                trial.config = decision[1]
                trial.status = "PENDING"
                pending.append(trial)
                self._snapshot(exp_dir, trials)
                continue
            if is_trainer:
                from ray_tpu_torch.train._checkpoint import Checkpoint

                trial.result = Result(
                    metrics={**out["_metrics"], "config": trial.config},
                    checkpoint=(Checkpoint(out["_checkpoint"])
                                if out["_checkpoint"] else None),
                    path=out["_path"],
                    metrics_history=out["_history"])
            else:
                trial.result = Result(
                    metrics={**out, "config": trial.config},
                    path=_storage.join(exp_dir, trial.name))
            self._snapshot(exp_dir, trials)

        return ResultGrid([t.result for t in trials],
                          self._tune_config.metric, self._tune_config.mode)

    def _snapshot(self, exp_dir: str, trials: List[Trial]) -> None:
        _storage.write_bytes(
            _storage.join(exp_dir, "tuner_state.json"),
            json.dumps({
                "time": time.time(),
                "trials": [{
                    "name": t.name, "status": t.status,
                    "num_failures": t.num_failures, "error": t.error,
                    # config is None until a model-based searcher suggests it
                    "config": {k: repr(v)
                               for k, v in (t.config or {}).items()},
                } for t in trials],
            }, indent=2).encode())
