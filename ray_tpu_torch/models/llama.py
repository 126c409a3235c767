"""Llama-family decoder in PyTorch: the port of ``ray_tpu/models/llama.py``.

Rotary position embeddings (no learned positions), pre-RMSNorm blocks,
SwiGLU MLPs, grouped-query attention (``n_kv_head < n_head``) and an untied
``lm_head``, all without biases.  Parameters carry the flax model's names
(``wq``/``wk``/``wv``/``wo``, ``gate_proj``/``up_proj``/``down_proj``,
``attn_norm``/``mlp_norm``/``norm_f``), so a flax param tree loads through
``models/convert.llama_params_from_flax`` and ``llama_partition_rules``
shards it.  Parameters are f32 and compute runs in ``config.dtype`` (bf16
by default), as in ``models/gpt2.py``; attention is the hand-written flash
kernel forward and backward, ring attention on the same kernels over
``ring_axis`` (after the GQA repeat), or the naive reference; remat
recomputes each block as ``GPT2LMModel`` does.  RoPE's tables are taken
at global positions, so a sequence split over sp rotates each token by its
place in the whole sequence.  ``moe_every`` is kept, as the JAX model
keeps it, for the pretrainer: the blocks stay dense, and the pretrainer's
loss adds an aux loss of 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.gpt2 import _dense, _embed, run_blocks
from ray_tpu_torch.ops.attention import (
    flash_attention,
    mha_reference,
    ring_attention_sharded,
)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_positions: int = 2048          # max seq (RoPE extrapolates beyond)
    d_model: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_kv_head: int = 4               # GQA: kv heads shared across q groups
    d_ff: int = 2048                 # SwiGLU hidden
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "flash"    # "flash" | "ring" | "reference"
    ring_axis: str = "sp"
    remat: bool = True
    remat_policy: str = "full"       # "full" | "dots"
    moe_every: int = 0               # pretrainer compatibility (dense only)

    def __post_init__(self):
        if self.attention_impl not in ("flash", "ring", "reference"):
            raise ValueError(f"unknown attention_impl "
                             f"{self.attention_impl!r}")
        if self.n_head % self.n_kv_head:
            raise ValueError("n_head must be a multiple of n_kv_head")

    @staticmethod
    def tiny() -> "LlamaConfig":
        return LlamaConfig(vocab_size=512, n_positions=128, d_model=64,
                           n_layer=2, n_head=4, n_kv_head=2, d_ff=128)


def rope_frequencies(head_dim: int, positions, theta: float):
    """(S, head_dim/2) f32 cos/sin tables for the given absolute
    positions."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, H, S, D); rotate-half (GPT-NeoX) convention: the pairs
    (x_i, x_{i+D/2}) rotate by the position angle, in f32, and the result
    is cast back to x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    rot1 = x1 * cos - x2 * sin
    rot2 = x2 * cos + x1 * sin
    return torch.cat([rot1, rot2], dim=-1).to(x.dtype)


def _rmsnorm(norm: nn.RMSNorm, x, dtype: torch.dtype):
    """flax ``nn.RMSNorm``: the mean square in f32, x scaled by
    rsqrt(ms + eps) * scale, the output in the compute type."""
    xf = x.float()
    ms = xf.pow(2).mean(-1, keepdim=True)
    return (xf * (torch.rsqrt(ms + norm.eps) * norm.weight)).to(dtype)


def _replicated_like(x, t):
    """``t`` as a replicated DTensor on ``x``'s mesh when ``x`` is a
    DTensor (DTensor ops take no plain tensor operands), else ``t``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        E, H, KV = config.d_model, config.n_head, config.n_kv_head
        D = E // H
        self.wq = nn.Linear(E, H * D, bias=False)
        self.wk = nn.Linear(E, KV * D, bias=False)
        self.wv = nn.Linear(E, KV * D, bias=False)
        self.wo = nn.Linear(H * D, E, bias=False)

    def forward(self, x, cos, sin):
        cfg = self.config
        B, S, E = x.shape
        H, KV = cfg.n_head, cfg.n_kv_head
        D = E // H
        q = _dense(self.wq, x, cfg.dtype).reshape(B, S, H, D).transpose(1, 2)
        k = _dense(self.wk, x, cfg.dtype).reshape(B, S, KV, D).transpose(1, 2)
        v = _dense(self.wv, x, cfg.dtype).reshape(B, S, KV, D).transpose(1, 2)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if KV != H:  # GQA: each kv head serves H/KV consecutive query heads
            rep = H // KV
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        if cfg.attention_impl == "ring":
            out = ring_attention_sharded(q, k, v, causal=True,
                                         seq_axis=cfg.ring_axis)
        elif cfg.attention_impl == "reference":
            out = mha_reference(q, k, v, causal=True)
        else:
            out = flash_attention(q, k, v, causal=True)
        out = out.transpose(1, 2).reshape(B, S, H * D)
        return _dense(self.wo, out, cfg.dtype)


class SwiGLU(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.gate_proj = nn.Linear(config.d_model, config.d_ff, bias=False)
        self.up_proj = nn.Linear(config.d_model, config.d_ff, bias=False)
        self.down_proj = nn.Linear(config.d_ff, config.d_model, bias=False)

    def forward(self, x):
        dtype = self.config.dtype
        gate = _dense(self.gate_proj, x, dtype)
        up = _dense(self.up_proj, x, dtype)
        return _dense(self.down_proj, F.silu(gate) * up, dtype)


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.attn_norm = nn.RMSNorm(config.d_model, eps=config.rms_eps)
        self.attn = LlamaAttention(config)
        self.mlp_norm = nn.RMSNorm(config.d_model, eps=config.rms_eps)
        self.mlp = SwiGLU(config)

    def forward(self, x, cos, sin):
        dtype = self.config.dtype
        x = x + self.attn(_rmsnorm(self.attn_norm, x, dtype), cos, sin)
        return x + self.mlp(_rmsnorm(self.mlp_norm, x, dtype))


class LlamaLMModel(nn.Module):
    """``LlamaLMModel(config, device=None)``: f32 trainable parameters on
    ``device`` (the CUDA card unless ``"cpu"`` is passed)."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.d_model)
        self.h = nn.ModuleList(LlamaBlock(config)
                               for _ in range(config.n_layer))
        self.norm_f = nn.RMSNorm(config.d_model, eps=config.rms_eps)
        self.lm_head = nn.Linear(config.d_model, config.vocab_size,
                                 bias=False)
        self.to(resolve_device(device))

    def forward(self, input_ids, intermediates: Optional[list] = None):
        """The logits; ``intermediates`` is taken as ``GPT2LMModel``
        takes it, and these dense blocks append nothing to it."""
        cfg = self.config
        S = input_ids.shape[1]
        x = _embed(self.wte.weight, input_ids, cfg.dtype)
        positions = torch.arange(S, device=self.wte.weight.device)
        cos, sin = (_replicated_like(x, t) for t in rope_frequencies(
            cfg.d_model // cfg.n_head, positions, cfg.rope_theta))
        x, _ = run_blocks(self.h, x, cfg, cos, sin)
        x = _rmsnorm(self.norm_f, x, cfg.dtype)
        return _dense(self.lm_head, x, cfg.dtype)


__all__ = ["LlamaAttention", "LlamaBlock", "LlamaConfig", "LlamaLMModel",
           "SwiGLU", "apply_rope", "rope_frequencies"]
