"""Port of ``ray_tpu/experimental/__init__.py``.

Experimental surfaces (reference: python/ray/experimental/)."""

from ray_tpu_torch.experimental.channel import ShmChannel  # noqa: F401
