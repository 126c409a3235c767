"""ray_tpu_torch.tune: experiment running (reference: python/ray/tune/).

The port of ``ray_tpu/tune/``: the Tuner, its searchers and schedulers,
and the single-trial controller that every ``Trainer.fit()`` runs, all
copies of the JAX package's modules.  A Tuner over a ``TorchTrainer`` runs
each trial as a CPU task that drives the trainer's own fit; the trainer's
gang asks for its cards there, so two trials of one worker each at
``gpus_per_worker=0.5`` share a card.
"""

from ray_tpu_torch.tune._single_trial import run_trainer_as_single_trial
from ray_tpu_torch.tune.search import (
    choice,
    grid_search,
    loguniform,
    randint,
    uniform,
)
from ray_tpu_torch.tune.schedulers import (ASHAScheduler, FIFOScheduler,
                                           PopulationBasedTraining)
from ray_tpu_torch.tune.session import get_checkpoint, report
from ray_tpu_torch.tune.search import TPESearcher
from ray_tpu_torch.tune.tuner import ResultGrid, Trial, TuneConfig, Tuner

__all__ = [
    "Tuner", "TuneConfig", "Trial", "ResultGrid", "TPESearcher",
    "grid_search", "choice", "uniform", "loguniform", "randint",
    "run_trainer_as_single_trial", "report", "get_checkpoint",
    "FIFOScheduler", "ASHAScheduler", "PopulationBasedTraining",
]
