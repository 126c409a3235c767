"""ray_tpu_torch — the PyTorch/CUDA port of ``ray_tpu``'s model stack.

A package beside ``ray_tpu`` that imports neither it nor JAX.  Module names
mirror the JAX package (``ops/``, ``models/``, ``llm/``) so each port module
sits where its counterpart does.  Kernels written by hand for Hopper live in
``csrc/`` and are compiled with ``nvcc`` at first use (``_native/build.py``);
importing the package builds and loads nothing.

It serves GPT-2 through ``llm.EngineCore`` and pretrains it through
``models.pretrain.ShardedPretrainer`` on one card, with hand-written CUDA
flash-attention kernels, forward and backward (``ops/attention.py``).  Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from ray_tpu_torch._private.device import resolve_device

__all__ = ["resolve_device"]
