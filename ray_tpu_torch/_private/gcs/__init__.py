"""Port of ``ray_tpu/_private/gcs/__init__.py``."""
