"""Port of ``ray_tpu/air/config.py``.

Shared Train/Tune config dataclasses.

Counterpart of the reference's AIR configs (reference: python/ray/air/config.py —
ScalingConfig, RunConfig, FailureConfig, CheckpointConfig).  The port's
deltas: ``use_gpu``/``gpus_per_worker``, a card a worker by default, and the
gang strategy PACK: several GPU workers share a host, one card each.  A
share of a card (``0 < gpus_per_worker < 1``, the counterpart of a
fractional ``tpus_per_worker``) is for gangs of one worker (a one-worker
trainer, as a Tuner's trials sharing a card run, or an MPMD stage gang),
which bring up no process group: ``TorchTrainer`` refuses it for a gang
that does (``train/torch_config.check_card_share``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class ScalingConfig:
    """How many training workers and what resources each gets.

    Reference: python/ray/air/config.py ScalingConfig (num_workers,
    use_gpu, resources_per_worker, placement_strategy).
    """

    num_workers: int = 1
    # a card a worker unless the caller asks for CPU workers
    use_gpu: bool = True
    gpus_per_worker: float = 1.0
    resources_per_worker: Optional[Dict[str, float]] = None
    # None resolves to PACK (reference default): GPU workers share a host,
    # one card each
    placement_strategy: Optional[str] = None

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {self.num_workers}")
        g = self.gpus_per_worker
        if self.use_gpu and not (0 < g < 1 or (g >= 1 and g % 1 == 0)):
            raise ValueError(f"use_gpu: a worker owns whole cards "
                             f"(gpus_per_worker >= 1) or a share of one "
                             f"(0 < gpus_per_worker < 1), got {g}")
        if self.placement_strategy is None:
            self.placement_strategy = "PACK"

    @property
    def _worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        res.setdefault("CPU", 1.0)
        if self.use_gpu:
            res["GPU"] = float(self.gpus_per_worker)
        return res


@dataclass
class FailureConfig:
    """Trial/run retry policy (reference: air/config.py FailureConfig).

    max_failures: retries after a worker-group or trial crash; 0 = fail fast,
    -1 = retry forever.
    """

    max_failures: int = 0


@dataclass
class CheckpointConfig:
    """Checkpoint retention (reference: air/config.py CheckpointConfig)."""

    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"

    def __post_init__(self):
        if self.num_to_keep is not None and self.num_to_keep <= 0:
            raise ValueError("num_to_keep must be positive or None")
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclass
class RunConfig:
    """Run-level config: where results/checkpoints land and retry policy
    (reference: air/config.py RunConfig)."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    stop: Optional[Dict[str, Any]] = None
    verbose: int = 1
    # Max seconds between report() calls before the run is declared dead.
    # Must cover the FIRST step's XLA compile (minutes on big TPU programs).
    worker_report_timeout_s: float = 1800.0

    def __post_init__(self):
        if self.storage_path is None:
            from ray_tpu_torch._private.config import RayConfig

            self.storage_path = os.path.expanduser(
                os.environ.get("RAY_TPU_TORCH_STORAGE_PATH")
                or RayConfig.storage_path)
