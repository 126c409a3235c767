"""Port of ``ray_tpu/autoscaler/__init__.py``.

ray_tpu_torch.autoscaler — demand-driven cluster scaling.

Reference: python/ray/autoscaler/ (StandardAutoscaler autoscaler.py:172,
NodeProvider node_provider.py:13, fake multi-node provider for tests).
"""

from ray_tpu_torch.autoscaler.autoscaler import (AutoscalingConfig, NodeTypeConfig,
                                           StandardAutoscaler)
from ray_tpu_torch.autoscaler.node_provider import LocalNodeProvider, NodeProvider

__all__ = ["AutoscalingConfig", "NodeTypeConfig", "StandardAutoscaler",
           "NodeProvider", "LocalNodeProvider"]
