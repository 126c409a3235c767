"""ray_tpu_torch.tune: the single-trial controller that ``fit()`` runs.

Of ``ray_tpu/tune/`` the port has ``_single_trial.py`` only: every
``Trainer.fit()`` runs one trial through it, with its FailureConfig
retries.  The Tuner, its searchers and schedulers are not ported.
"""

from ray_tpu_torch.tune._single_trial import run_trainer_as_single_trial

__all__ = ["run_trainer_as_single_trial"]
