"""Port of ``ray_tpu/tune/schedulers.py``.

Trial schedulers: FIFO, ASHA early stopping, Population Based Training.

Reference: python/ray/tune/schedulers/ — async_hyperband.py (ASHA), pbt.py
(PopulationBasedTraining), FIFOScheduler.  Same decision surface, condensed:
``on_result(trial, metrics) -> "continue" | "stop"`` for intermediate
results, ``on_trial_complete(trial, metrics) -> None | ("restart", config)``
for PBT exploit/explore restarts.
"""

from __future__ import annotations

import copy
import math
import random
from typing import Any, Dict, List, Optional, Tuple

CONTINUE = "continue"
STOP = "stop"


class FIFOScheduler:
    """No early stopping (reference: FIFOScheduler — the default)."""

    def set_experiment(self, metric: Optional[str], mode: str) -> None:
        self.metric = metric
        self.mode = mode

    def on_result(self, trial, metrics: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial, metrics: Optional[Dict[str, Any]]):
        return None


class ASHAScheduler(FIFOScheduler):
    """Asynchronous Successive Halving (reference: schedulers/
    async_hyperband.py AsyncHyperBandScheduler).

    Rungs at grace_period * reduction_factor^k.  When a trial reaches a rung,
    it continues only if its metric is in the top 1/reduction_factor of
    results recorded AT that rung so far — asynchronous: no waiting for a
    full bracket.
    """

    def __init__(self, *, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        self._rungs: Dict[int, List[float]] = {}
        rung = grace_period
        while rung < max_t:
            self._rungs[rung] = []
            rung = int(math.ceil(rung * reduction_factor))

    def set_experiment(self, metric, mode):
        self.metric = self.metric or metric
        self.mode = self.mode or mode or "max"

    def on_result(self, trial, metrics: Dict[str, Any]) -> str:
        t = metrics.get(self.time_attr, 0)
        if t >= self.max_t:
            return STOP
        value = metrics.get(self.metric)
        if value is None:
            return CONTINUE
        value = float(value)
        if self.mode == "min":
            value = -value
        for rung in sorted(self._rungs, reverse=True):
            if t == rung:
                recorded = self._rungs[rung]
                recorded.append(value)
                if len(recorded) > 1:
                    k = max(1, int(len(recorded) / self.rf))
                    cutoff = sorted(recorded, reverse=True)[k - 1]
                    if value < cutoff:
                        return STOP
                break
        return CONTINUE


class PopulationBasedTraining(FIFOScheduler):
    """PBT (reference: schedulers/pbt.py).  At each perturbation interval a
    bottom-quantile trial is stopped and RESTARTED with a top-quantile
    trial's config (exploit), perturbed (explore); the donor's latest
    checkpoint rides along in config["__pbt_checkpoint__"] so the restarted
    trial can warm-start."""

    def __init__(self, *, metric: Optional[str] = None,
                 mode: Optional[str] = None,
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 perturb_factors: Tuple[float, float] = (0.8, 1.2),
                 seed: Optional[int] = None,
                 time_attr: str = "training_iteration",
                 max_exploits_per_trial: int = 4):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.perturb_factors = perturb_factors
        self.time_attr = time_attr
        self._rng = random.Random(seed)
        self._latest: Dict[int, Dict[str, Any]] = {}   # trial idx -> metrics
        self._configs: Dict[int, Dict[str, Any]] = {}
        self._checkpoints: Dict[int, Any] = {}
        self._restarts: Dict[int, Dict[str, Any]] = {}  # planned restarts
        # Our restarts re-run the trainable from its (warm-started) top, so
        # unlike the reference (which continues cumulative iterations from a
        # checkpoint) an unbounded exploit loop would never converge: budget
        # the exploits per trial.
        self.max_exploits = max_exploits_per_trial
        self._exploit_counts: Dict[int, int] = {}

    def set_experiment(self, metric, mode):
        self.metric = self.metric or metric
        self.mode = self.mode or mode or "max"

    def _score(self, metrics) -> Optional[float]:
        v = metrics.get(self.metric)
        if v is None:
            return None
        return float(v) if self.mode == "max" else -float(v)

    def record_checkpoint(self, trial_index: int, checkpoint) -> None:
        self._checkpoints[trial_index] = checkpoint

    def on_result(self, trial, metrics: Dict[str, Any]) -> str:
        self._latest[trial.index] = metrics
        self._configs[trial.index] = trial.config
        t = metrics.get(self.time_attr, 0)
        if t == 0 or t % self.interval:
            return CONTINUE
        scored = [(idx, self._score(m)) for idx, m in self._latest.items()]
        scored = [(i, sc) for i, sc in scored if sc is not None]
        if len(scored) < 2:
            return CONTINUE
        scored.sort(key=lambda x: x[1])
        n_q = max(1, int(len(scored) * self.quantile))
        bottom = {i for i, _ in scored[:n_q]}
        top = [i for i, _ in scored[-n_q:]]
        if trial.index not in bottom or trial.index in top:
            return CONTINUE
        if self._exploit_counts.get(trial.index, 0) >= self.max_exploits:
            return CONTINUE
        self._exploit_counts[trial.index] = \
            self._exploit_counts.get(trial.index, 0) + 1
        donor = self._rng.choice(top)
        new_config = self._explore(copy.deepcopy(self._configs.get(
            donor, trial.config)))
        if donor in self._checkpoints:
            new_config["__pbt_checkpoint__"] = self._checkpoints[donor]
        self._restarts[trial.index] = new_config
        return STOP

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        for key, spec in self.mutations.items():
            if key not in config:
                continue
            if callable(spec):
                config[key] = spec()
            elif isinstance(spec, (list, tuple)):
                config[key] = self._rng.choice(list(spec))
            elif isinstance(config[key], (int, float)):
                factor = self._rng.choice(self.perturb_factors)
                config[key] = type(config[key])(config[key] * factor)
        return config

    def on_trial_complete(self, trial, metrics):
        new_config = self._restarts.pop(trial.index, None)
        if new_config is not None:
            return ("restart", new_config)
        return None
