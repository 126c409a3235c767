"""Port of ``ray_tpu/tune/_trial_coordinator.py``.

TrialCoordinator: the intermediate-result channel between running trials
and the Tune controller.

Reference: the reference routes intermediate results trial-actor ->
TuneController over actor futures (tune_controller.py:68); here trials are
TASKS, so reporting flows through this small actor instead: trials push
metrics (and learn whether to stop), the controller drains the stream and
feeds its scheduler.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import ray_tpu_torch


@ray_tpu_torch.remote(num_cpus=0)
class TrialCoordinator:
    def __init__(self):
        self._events: List[dict] = []
        self._stopped: set = set()
        self._iters: Dict[int, int] = {}
        self._checkpoints: Dict[int, Any] = {}

    def report(self, trial_index: int, metrics: Dict[str, Any],
               checkpoint: Optional[str] = None) -> bool:
        """Called from inside a trial; returns True when the scheduler asked
        this trial to stop."""
        it = self._iters.get(trial_index, 0) + 1
        self._iters[trial_index] = it
        metrics = dict(metrics)
        metrics.setdefault("training_iteration", it)
        if checkpoint is not None:
            self._checkpoints[trial_index] = checkpoint
        self._events.append({"trial": trial_index, "metrics": metrics,
                             "checkpoint": checkpoint})
        return trial_index in self._stopped

    def drain(self) -> List[dict]:
        events, self._events = self._events, []
        return events

    def set_stop(self, trial_index: int) -> None:
        self._stopped.add(trial_index)

    def clear_trial(self, trial_index: int) -> None:
        """A restarted trial starts a fresh iteration counter and stop flag."""
        self._stopped.discard(trial_index)
        self._iters.pop(trial_index, None)

    def latest_checkpoint(self, trial_index: int):
        return self._checkpoints.get(trial_index)
