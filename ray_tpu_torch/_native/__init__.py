"""Build and load of the port's hand-written CUDA kernels (``build.py``)."""
