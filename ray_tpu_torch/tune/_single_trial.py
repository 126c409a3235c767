"""Port of ``ray_tpu/tune/_single_trial.py``.

Single-trial execution with failure retries.

The reference wraps every ``Trainer.fit()`` in a one-trial Tuner
(reference: python/ray/train/base_trainer.py:577-623 → tune/tuner.py:344 →
tune/execution/tune_controller.py:68).  This module is that path's core:
run one trainable, and on failure restart it from the latest durable
checkpoint up to FailureConfig.max_failures times.  The full Tuner drives
many of these concurrently.
"""

from __future__ import annotations

import logging

from ray_tpu_torch.air.result import Result
from ray_tpu_torch.exceptions import RayError
from ray_tpu_torch.train._backend_executor import TrainingFailedError

logger = logging.getLogger(__name__)

# What a retry can plausibly fix: a worker crash mid-loop
# (TrainingFailedError), a node/actor loss during worker-group bring-up
# (RayError), or the gang not being schedulable yet (TimeoutError).
_RETRYABLE = (TrainingFailedError, RayError, TimeoutError)


def run_trainer_as_single_trial(trainer) -> Result:
    from ray_tpu_torch.train._checkpoint import Checkpoint
    from ray_tpu_torch.train.base_trainer import latest_checkpoint

    max_failures = trainer.run_config.failure_config.max_failures
    attempt = 0
    while True:
        try:
            return trainer.training_loop()
        except _RETRYABLE as e:
            attempt += 1
            if max_failures >= 0 and attempt > max_failures:
                raise
            latest = latest_checkpoint(trainer.trial_dir)
            logger.warning(
                "trial %s failed (attempt %d/%s): %s — restarting from %s",
                trainer.run_config.name, attempt,
                max_failures if max_failures >= 0 else "inf", e,
                latest or "scratch")
            if latest:
                trainer.resume_from_checkpoint = Checkpoint(latest)
