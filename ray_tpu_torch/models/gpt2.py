"""GPT-2 in PyTorch: the port of ``ray_tpu/models/gpt2.py``.

Same structure and parameter names as the flax model (fused QKV, pre-LN
blocks, tanh-GELU MLP, untied ``lm_head`` without bias), so a flax param tree
loads through ``models/convert.params_from_flax``.  Parameters are f32 and
trainable, and compute runs in ``config.dtype`` (bf16 by default), as flax's
``dtype=`` does.  Attention is the hand-written flash kernel forward and
backward (``attention_impl="flash"``), ring attention over the mesh's
``ring_axis`` on the same kernels (``"ring"``, for a sequence split over
sp), or the naive reference.  ``remat`` recomputes each block in the
backward (``torch.utils.checkpoint``), and ``lm_loss`` is the f32
next-token cross entropy.  With ``moe_every = k > 0`` every k-th block
(``i % k == k - 1``) swaps its MLP for the expert-parallel
``models/moe.MoEMlpBlock``; each such block returns its aux loss beside its
output, and ``forward(ids, intermediates=terms)`` appends the terms to the
list ``terms``, where flax sows them (``models/moe.collect_moe_aux_loss``
sums them).

The parameters may be DTensors (``models/pretrain.ShardedPretrainer`` over
a mesh): every op here has a DTensor sharding rule (the embedding lookup
gathers a vocab-sharded table first, ``_embed``), and ``flash_attention``
runs its kernels on each rank's local shard.  Positions are global: on a
batch whose sequence is split over sp, ``wpe``'s rows are those of the
whole sequence, laid out as the activations are.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.ops.attention import (
    _is_dtensor,
    flash_attention,
    mha_reference,
    ring_attention_sharded,
)

# flax LayerNorm's default epsilon (torch's is 1e-5)
LN_EPS = 1e-6


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    attention_impl: str = "flash"  # "flash" | "ring" | "reference"
    ring_axis: str = "sp"
    # Rematerialize each block in backward (recompute activations) when
    # autograd records the forward.  "full" recomputes everything; "dots"
    # keeps the outputs of the matrix products and recomputes the rest.
    remat: bool = True
    remat_policy: str = "full"  # "full" | "dots"
    # MoE: every moe_every-th block has an expert-parallel FFN in place of
    # its MLP (0: dense everywhere); the experts shard over ep
    moe_every: int = 0
    n_experts: int = 8
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    def __post_init__(self):
        if self.attention_impl not in ("flash", "ring", "reference"):
            raise ValueError(f"unknown attention_impl "
                             f"{self.attention_impl!r}")

    @staticmethod
    def small() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def tiny() -> "GPT2Config":
        return GPT2Config(vocab_size=512, n_positions=128, n_embd=64,
                          n_layer=2, n_head=4)


def _dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype):
    """``lin`` applied to ``x`` (B, S, E) in ``dtype``.  A sharded DTensor
    goes through a product batched over B: ``F.linear`` folds B and S into
    one dim, which DTensor (torch 2.11) refuses where S is sharded, "Attempted
    to flatten multiple dimensions"; its backward meets that fold with S
    sharded even when the forward's input shards only B (tp x fsdp)."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    if _is_dtensor(x) and any(p.is_shard() for p in x.placements):
        w = lin.weight.to(dtype).t()
        out = torch.bmm(x.to(dtype), w.expand(x.shape[0], *w.shape))
        return out if bias is None else out + bias
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def _embed(table: torch.Tensor, ids, dtype: torch.dtype):
    """The rows ``ids`` of ``table`` in ``dtype``.  A DTensor table whose
    vocab dim is sharded (``wte`` over tp) has that dim gathered first:
    DTensor's vocab-parallel lookup fails when the same op also reshards
    the ids' batch dim (an IndexError in its mask buffer at tp=2 x
    fsdp=2, torch 2.13), so the lookup runs on the whole vocabulary."""
    table = table.to(dtype)
    if _is_dtensor(table):
        from torch.distributed.tensor import Replicate

        table = table.redistribute(table.device_mesh, [
            Replicate() if p.is_shard(0) else p for p in table.placements])
    return F.embedding(ids, table)


def _layernorm(ln: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype):
    # statistics in f32, output in the compute type (flax's LayerNorm)
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        LN_EPS).to(dtype)


class Attention(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        E = config.n_embd
        self.qkv_proj = nn.Linear(E, 3 * E)
        self.out_proj = nn.Linear(E, E)

    def forward(self, x):
        cfg = self.config
        B, S, E = x.shape
        H = cfg.n_head
        D = E // H
        qkv = _dense(self.qkv_proj, x, cfg.dtype)
        # contiguous thirds, then (B, S, H, D) -> (B, H, S, D)
        q, k, v = (t.reshape(B, S, H, D).transpose(1, 2)
                   for t in qkv.split(E, dim=-1))
        if cfg.attention_impl == "ring":
            out = ring_attention_sharded(q, k, v, causal=True,
                                         seq_axis=cfg.ring_axis)
        elif cfg.attention_impl == "reference":
            out = mha_reference(q, k, v, causal=True)
        else:
            out = flash_attention(q, k, v, causal=True)
        out = out.transpose(1, 2).reshape(B, S, E)
        return _dense(self.out_proj, out, cfg.dtype)


class MlpBlock(nn.Module):
    def __init__(self, config: GPT2Config):
        super().__init__()
        self.config = config
        self.fc_in = nn.Linear(config.n_embd, 4 * config.n_embd)
        self.fc_out = nn.Linear(4 * config.n_embd, config.n_embd)

    def forward(self, x):
        dtype = self.config.dtype
        h = F.gelu(_dense(self.fc_in, x, dtype), approximate="tanh")
        return _dense(self.fc_out, h, dtype)


class Block(nn.Module):
    """A pre-LN block: attention, then the MLP, or with ``use_moe`` the
    expert-parallel FFN ``moe_mlp``, whose block returns ``(x, aux
    term)``."""

    def __init__(self, config: GPT2Config, use_moe: bool = False):
        super().__init__()
        self.config = config
        self.ln_1 = nn.LayerNorm(config.n_embd, eps=LN_EPS)
        self.attn = Attention(config)
        self.ln_2 = nn.LayerNorm(config.n_embd, eps=LN_EPS)
        if use_moe:
            from ray_tpu_torch.models.moe import MoEConfig, MoEMlpBlock

            self.moe_mlp = MoEMlpBlock(MoEConfig(
                n_experts=config.n_experts, top_k=config.moe_top_k,
                capacity_factor=config.moe_capacity_factor,
                d_model=config.n_embd, d_ff=4 * config.n_embd,
                dtype=config.dtype))
        else:
            self.mlp = MlpBlock(config)

    def forward(self, x):
        dtype = self.config.dtype
        x = x + self.attn(_layernorm(self.ln_1, x, dtype))
        h = _layernorm(self.ln_2, x, dtype)
        if hasattr(self, "moe_mlp"):
            out, aux = self.moe_mlp(h)
            return x + out, aux
        return x + self.mlp(h)


# what remat_policy="dots" keeps from the forward: the outputs of the
# matrix products without batch dims, as JAX's
# dots_with_no_batch_dims_saveable does.  Attention's batched products
# (bmm: the (B*H, S, S) logits among them) are recomputed.
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def run_blocks(blocks, x, config, *args):
    """``x`` through ``blocks`` in turn (each called as ``block(x,
    *args)``), each recomputed in the backward when ``config.remat`` is set
    and autograd records: everything (``remat_policy="full"``) or all but
    ``_DOTS``'s outputs (``"dots"``).  Returns (x, the aux terms of the
    blocks that return ``(x, aux)``, in order).  The terms leave each
    block as outputs, so a recomputed block changes none of them."""
    if config.remat_policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy: {config.remat_policy!r} "
                         "(expected 'full' or 'dots')")
    remat = config.remat and torch.is_grad_enabled()
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _DOTS)
                  if config.remat_policy == "dots" else noop_context_fn)
    aux = []
    for block in blocks:
        out = (checkpoint(block, x, *args, use_reentrant=False,
                          context_fn=context_fn) if remat
               else block(x, *args))
        if isinstance(out, tuple):
            out, term = out
            aux.append(term)
        x = out
    return x, aux


class GPT2LMModel(nn.Module):
    """``GPT2LMModel(config, device=None)``: f32 trainable parameters on
    ``device`` (the CUDA card unless ``"cpu"`` is passed)."""

    def __init__(self, config: GPT2Config, device=None):
        super().__init__()
        self.config = config
        self.wte = nn.Embedding(config.vocab_size, config.n_embd)
        self.wpe = nn.Embedding(config.n_positions, config.n_embd)
        every = config.moe_every
        self.h = nn.ModuleList(
            Block(config, every > 0 and i % every == every - 1)
            for i in range(config.n_layer))
        self.ln_f = nn.LayerNorm(config.n_embd, eps=LN_EPS)
        self.lm_head = nn.Linear(config.n_embd, config.vocab_size,
                                 bias=False)
        self.to(resolve_device(device))

    def forward(self, input_ids, intermediates: Optional[list] = None):
        """The logits; the MoE blocks' aux terms are appended to
        ``intermediates`` when a list is given."""
        cfg = self.config
        S = input_ids.shape[1]
        x = (_embed(self.wte.weight, input_ids, cfg.dtype)
             + self.wpe.weight[:S].to(cfg.dtype))
        x, aux = run_blocks(self.h, x, cfg)
        if intermediates is not None:
            intermediates.extend(aux)
        x = _layernorm(self.ln_f, x, cfg.dtype)
        return _dense(self.lm_head, x, cfg.dtype)


def lm_loss(logits, targets, mask=None):
    """Mean next-token cross entropy in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets[..., None])[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)
