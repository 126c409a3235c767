"""Port of ``ray_tpu/serve/config.py``.

Serve configuration dataclasses.

Reference: python/ray/serve/config.py (DeploymentConfig, AutoscalingConfig —
pydantic there; plain dataclasses here, validated in __post_init__).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class AutoscalingConfig:
    """Queue-depth-driven replica autoscaling (reference:
    serve/autoscaling_policy.py — replicas sized so each carries about
    ``target_ongoing_requests`` in-flight calls)."""

    min_replicas: int = 1
    max_replicas: int = 1
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 30.0

    def __post_init__(self):
        if self.min_replicas < 0 or self.max_replicas < self.min_replicas:
            raise ValueError("need 0 <= min_replicas <= max_replicas")
        if self.target_ongoing_requests <= 0:
            raise ValueError("target_ongoing_requests must be > 0")


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    autoscaling_config: Optional[AutoscalingConfig] = None
    health_check_period_s: float = 1.0
    health_check_timeout_s: float = 10.0

    def __post_init__(self):
        if self.num_replicas < 0:
            raise ValueError("num_replicas must be >= 0")
        if self.max_ongoing_requests <= 0:
            raise ValueError("max_ongoing_requests must be > 0")
        if isinstance(self.autoscaling_config, dict):
            self.autoscaling_config = AutoscalingConfig(**self.autoscaling_config)
