"""Plain GPT-2 in float32: the benchmark's reference.

The forward pass of GPT-2 (Radford et al. 2019) as the configuration files
describe it: learned token and position embeddings, pre-LayerNorm blocks
with a fused query/key/value projection, causal softmax attention scaled by
1/sqrt(head size), a tanh-GELU MLP of four times the width, a last
LayerNorm and an output projection without bias.  Parameters are named as a
PyTorch state dict (``h.{i}.attn.qkv_proj.weight``, shape (out, in)), so the
weights the benchmark makes go to both sides unchanged.

Everything is float32 with TF32 off, unless ``precision`` is ``"fp8"``,
which only the control asks for: each product of a linear layer in FP8,
operands scaled per tensor into e4m3's range and rounded to it in the
forward, the gradient rounded to e5m2 in the backward (the usual FP8
training recipe); the products inside attention stay float32.

This file imports only ``torch`` and uses none of the program's kernels,
weights or tables.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch

PRECISIONS = ("f32", "fp8")


def no_tf32() -> None:
    """Float32 products in float32: the GPU would otherwise be free to run
    them in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (an FP8 type) under a per-tensor scale
    that maps its largest magnitude to the type's largest finite value."""
    amax = x.abs().amax().clamp_min(1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).float() / scale


class _Fp8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x, torch.float8_e4m3fn), _fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        return xq @ wq.t()

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        gx = gq @ wq
        gw = gq.reshape(-1, gq.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
        return gx, gw


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
           precision: str = "f32") -> torch.Tensor:
    if precision == "fp8":
        out = _Fp8Linear.apply(x, w)
    else:
        out = x @ w.t()
    return out if b is None else out + b


def layer_norm(x, w, b, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def hidden(w: Mapping[str, torch.Tensor], ids: torch.Tensor, cfg: Mapping,
           precision: str = "f32") -> torch.Tensor:
    """The last LayerNorm's output, (B, S, E), for token ids (B, S)."""
    E, H = cfg["n_embd"], cfg["n_head"]
    D = E // H
    eps = cfg["layer_norm_epsilon"]
    B, S = ids.shape
    x = w["wte.weight"][ids] + w["wpe.weight"][:S]
    mask = torch.ones(S, S, dtype=torch.bool, device=ids.device).tril()
    for i in range(cfg["n_layer"]):
        p = f"h.{i}."
        h = layer_norm(x, w[p + "ln_1.weight"], w[p + "ln_1.bias"], eps)
        qkv = linear(h, w[p + "attn.qkv_proj.weight"],
                     w[p + "attn.qkv_proj.bias"], precision)
        q, k, v = (t.reshape(B, S, H, D).transpose(1, 2)
                   for t in qkv.split(E, dim=-1))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(D)
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), -1)
        att = (probs @ v).transpose(1, 2).reshape(B, S, E)
        x = x + linear(att, w[p + "attn.out_proj.weight"],
                       w[p + "attn.out_proj.bias"], precision)
        h = layer_norm(x, w[p + "ln_2.weight"], w[p + "ln_2.bias"], eps)
        h = gelu_tanh(linear(h, w[p + "mlp.fc_in.weight"],
                             w[p + "mlp.fc_in.bias"], precision))
        x = x + linear(h, w[p + "mlp.fc_out.weight"],
                       w[p + "mlp.fc_out.bias"], precision)
    return layer_norm(x, w["ln_f.weight"], w["ln_f.bias"], eps)


def logits(w, ids, cfg, precision: str = "f32") -> torch.Tensor:
    """Logits (B, S, V)."""
    return linear(hidden(w, ids, cfg, precision), w["lm_head.weight"], None,
                  precision)


def loss_sum(w, ids, targets, cfg, precision: str = "f32") -> torch.Tensor:
    """Sum over (B, S) of the next-token cross entropy."""
    lg = logits(w, ids, cfg, precision)
    return -torch.log_softmax(lg, -1).gather(-1, targets[..., None]).sum()


def leaf_norms(tensors: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """The norm of each leaf, the fused query/key/value projection taken as
    its three matrices (``...qkv_proj.weight.q`` and so on): the key's bias
    has no gradient under softmax but for round-off, and is a leaf of its
    own so that a rule on the gradient can find it."""
    out = {}
    for name, t in tensors.items():
        parts = ([(f"{name}.{x}", p) for x, p in zip("qkv", t.chunk(3))]
                 if "qkv_proj" in name else [(name, t)])
        for key, part in parts:
            out[key] = float(torch.linalg.vector_norm(part.float()))
    return out


def lr_at(count: int, opt: Mapping) -> float:
    """The rate of update ``count`` (0 for the first): linear warm-up from
    0, then a cosine to 0 over the rest of ``total_steps``."""
    lr, warmup, total = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if count < warmup:
        return lr * count / warmup
    decay = max(total, warmup + 1) - warmup
    t = min(count - warmup, decay)
    return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))


class Trainer:
    """Three or so steps of plain GPT-2 training: the mean next-token loss,
    the gradient clipped to a global norm, then AdamW with decoupled weight
    decay on every parameter.  The batch's rows go through in blocks of
    ``rows_per_block`` so that float32 activations fit; the gradient is the
    sum of the blocks' and equals the whole batch's."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: Mapping,
                 opt: Mapping, precision: str = "f32",
                 rows_per_block: int = 4):
        if precision not in PRECISIONS:
            raise ValueError(f"unknown precision {precision!r}")
        self.w = {k: v.detach().clone().requires_grad_(True)
                  for k, v in weights.items()}
        self.cfg, self.opt = cfg, opt
        self.precision = precision
        self.rows = rows_per_block
        self.m = {k: torch.zeros_like(v) for k, v in self.w.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.w.items()}
        self.count = 0
        self.first_grad_norms: Optional[Dict[str, float]] = None

    def step(self, ids: torch.Tensor, targets: torch.Tensor) -> float:
        """One step on the batch; returns its mean loss."""
        n = ids.numel()
        for p in self.w.values():
            p.grad = None
        total = 0.0
        for r in range(0, ids.shape[0], self.rows):
            loss = loss_sum(self.w, ids[r:r + self.rows],
                            targets[r:r + self.rows], self.cfg,
                            self.precision) / n
            loss.backward()
            total += float(loss.detach())
        grads = {k: p.grad for k, p in self.w.items()}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        clip = self.opt["clip_norm"]
        scale = clip / norm if float(norm) >= clip else 1.0
        if self.count == 0:
            self.first_grad_norms = leaf_norms(
                {k: g * scale for k, g in grads.items()})
        lr = lr_at(self.count, self.opt)
        b1, b2 = self.opt["betas"]
        eps, wd = self.opt["eps"], self.opt["weight_decay"]
        t = self.count + 1
        with torch.no_grad():
            for k, p in self.w.items():
                g = grads[k] * scale
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = self.m[k] / (1 - b1 ** t)
                vhat = self.v[k] / (1 - b2 ** t)
                p.sub_(lr * (mhat / (vhat.sqrt() + eps) + wd * p))
        self.count += 1
        return total

