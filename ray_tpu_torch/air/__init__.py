"""Port of ``ray_tpu/air/__init__.py``.

AIR glue: shared config/result dataclasses used by Train and Tune.

Counterpart of the reference's ``ray.air`` (reference: python/ray/air/config.py,
python/ray/air/result.py).
"""

from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result

__all__ = [
    "CheckpointConfig",
    "FailureConfig",
    "RunConfig",
    "ScalingConfig",
    "Result",
]
