"""Kernels written by hand for Hopper, with their plain PyTorch versions.

Counterpart of ``ray_tpu.ops``: flash attention (forward kernel in
``csrc/flash_fwd.cu``).  Ring attention and the GAE scans wait for later
slices.
"""

from ray_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    mha_reference,
)

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "mha_reference"]
