"""Port of ``ray_tpu/scripts/__init__.py``."""
