"""Port of ``ray_tpu/rllib/algorithms/__init__.py``."""
