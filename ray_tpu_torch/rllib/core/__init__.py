"""Port of ``ray_tpu/rllib/core/__init__.py``."""
