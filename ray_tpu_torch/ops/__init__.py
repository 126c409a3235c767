"""Kernels written by hand for Hopper, with their plain PyTorch versions.

Counterpart of ``ray_tpu.ops``: flash attention (forward and split-KV
combine kernels in ``csrc/flash_fwd.cu``, backward kernels in
``csrc/flash_bwd.cu``), and ring attention over a sequence split, which
runs each chunk on those kernels; GAE (``gae.py``) and V-trace
(``vtrace.py``) as doubling scans in torch ops, which need no hand kernel.
"""

from ray_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    flash_attention_fwd_split_plain,
    flash_bwd_delta,
    flash_bwd_delta_plain,
    flash_fwd_combine,
    merge_partials_plain,
    mha_reference,
    ring_attention,
    ring_attention_bwd_unrolled,
    ring_attention_fwd_unrolled,
    ring_attention_sharded,
    split_plan,
)
from ray_tpu_torch.ops.gae import (
    discounted_returns,
    gae_advantages,
    gae_from_fragments,
)
from ray_tpu_torch.ops.vtrace import vtrace_from_fragments

__all__ = ["discounted_returns", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_fwd_split_plain",
           "flash_bwd_delta", "flash_bwd_delta_plain", "flash_fwd_combine",
           "gae_advantages", "gae_from_fragments", "merge_partials_plain",
           "mha_reference", "ring_attention", "ring_attention_bwd_unrolled",
           "ring_attention_fwd_unrolled", "ring_attention_sharded",
           "split_plan", "vtrace_from_fragments"]
