"""Kernels written by hand for Hopper, with their plain PyTorch versions.

Counterpart of ``ray_tpu.ops``: flash attention (forward and split-KV
combine kernels in ``csrc/flash_fwd.cu``).  Ring attention and the GAE
scans wait for later slices.
"""

from ray_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    flash_attention_fwd_split_plain,
    flash_fwd_combine,
    merge_partials_plain,
    mha_reference,
    split_plan,
)

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_fwd_split_plain",
           "flash_fwd_combine", "merge_partials_plain", "mha_reference",
           "split_plan"]
