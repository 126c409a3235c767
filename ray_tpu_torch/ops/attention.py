"""Flash attention for the port: a hand-written CUDA forward kernel, its plain
PyTorch version, and the reference.

Counterpart of ``ray_tpu/ops/attention.py``:

- ``mha_reference`` mirrors ``mha_reference`` (:51), the ground truth;
- ``flash_attention_fwd_plain`` mirrors ``_flash_forward`` (:136-185)
  blockwise: the same padding, online-softmax recurrence, causal block skip,
  masked-key handling and fully-masked-row convention, in PyTorch;
- ``flash_attention_fwd`` is the wrapper: on CPU tensors it runs the plain
  version, on CUDA tensors it launches ``csrc/flash_fwd.cu`` (which replaces
  the Pallas kernel ``_flash_fwd_kernel``, :66-129) or raises;
- ``flash_attention`` keeps the JAX signature and the (B, H, S, D) layout.

This slice serves inference only: the backward (``_flash_backward``,
:189-247) arrives with the training slice, so ``flash_attention`` raises when
autograd would need it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
NEG_INF = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each hand-written kernel, counted by its wrapper where it
# launches and nowhere else.  A run resets a count to 0 and reads it back to
# show which kernels its path went through.
KERNEL_LAUNCHES = {"flash_fwd": 0}

_fn = None


# =========================================================== reference
def mha_reference(q, k, v, *, causal: bool = True,
                  sm_scale: Optional[float] = None, q_offset: int = 0,
                  k_offset: int = 0):
    """Naive attention; ground truth for kernels. q,k,v: (B, H, S, D)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * sm_scale
    if causal:
        qi = torch.arange(q.shape[2], device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[2], device=q.device)[None, :] + k_offset
        logits = torch.where(qi >= ki, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)


# ======================================================= plain version
def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              q_offset: int = 0, k_offset: int = 0,
                              block_q: int = DEFAULT_BLOCK_Q,
                              block_k: int = DEFAULT_BLOCK_K
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise online-softmax attention in PyTorch, block for block what
    ``_flash_forward`` computes.  Returns ``(o, lse)``: o (B,H,Sq,D) in q's
    dtype, lse (B,H,Sq) f32 (-1e30 on rows with no visible key)."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    block_q = min(block_q, s_q)
    block_k = min(block_k, s_k)
    s_q_pad = _round_up(s_q, block_q)
    s_k_pad = _round_up(s_k, block_k)
    qf = torch.nn.functional.pad(q.float(), (0, 0, 0, s_q_pad - s_q))
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, s_k_pad - s_k))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, s_k_pad - s_k))
    out = torch.empty(b, h, s_q_pad, d, dtype=torch.float32, device=q.device)
    lse = torch.empty(b, h, s_q_pad, dtype=torch.float32, device=q.device)
    rows = torch.arange(block_q, device=q.device)[:, None]
    cols = torch.arange(block_k, device=q.device)[None, :]
    for iq in range(s_q_pad // block_q):
        qb = qf[:, :, iq * block_q:(iq + 1) * block_q] * sm_scale
        q_pos = rows + iq * block_q + q_offset
        m = torch.full((b, h, block_q), NEG_INF, device=q.device)
        l = torch.zeros((b, h, block_q), device=q.device)
        acc = torch.zeros((b, h, block_q, d), device=q.device)
        for j in range(s_k_pad // block_k):
            # only kv blocks at or before the diagonal contribute
            if causal and j * block_k + k_offset \
                    > iq * block_q + q_offset + block_q - 1:
                continue
            kb = kf[:, :, j * block_k:(j + 1) * block_k]
            vb = vf[:, :, j * block_k:(j + 1) * block_k]
            s = qb @ kb.transpose(-1, -2)
            k_idx = cols + j * block_k
            valid = k_idx < s_k
            if causal:
                valid = valid & (q_pos >= k_idx + k_offset)
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # a row with no visible key so far keeps p = 0, not exp(0) = 1
            p = torch.where(m_new[..., None] <= NEG_INF / 2, 0.0,
                            torch.exp(s - m_new[..., None]))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p @ vb
            m = m_new
        l_safe = torch.where(l == 0.0, 1.0, l)
        out[:, :, iq * block_q:(iq + 1) * block_q] = acc / l_safe[..., None]
        lse[:, :, iq * block_q:(iq + 1) * block_q] = torch.where(
            l == 0.0, NEG_INF, m + torch.log(l_safe))
    return out[:, :, :s_q].to(q.dtype), lse[:, :, :s_q]


# ============================================================ kernel
def _kernel():
    global _fn
    if _fn is None:
        from ray_tpu_torch._native import build

        fn = build.load("flash_fwd").ray_flash_fwd
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float, q_offset: int,
                    k_offset: int) -> Tuple[torch.Tensor, torch.Tensor]:
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4 or t.shape[:2] != q.shape[:2] or t.shape[3] != d:
            raise ValueError(f"{name} shape {tuple(t.shape)} does not match "
                             f"q {tuple(q.shape)} (B, H, S, D)")
    if k.shape[2] != v.shape[2]:
        raise ValueError("k and v differ in sequence length")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash_fwd kernel takes float32 or bfloat16, "
                         f"not {q.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd kernel takes head dim in "
                         f"{KERNEL_HEAD_DIMS}, not {d}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_fwd kernel needs a contiguous head dim")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel grid (65535)")
    o = torch.empty((b, h, s_q, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    if s_q == 0:
        return o, lse
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), _KERNEL_DTYPES[q.dtype], b, h, s_q, s_k, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 float(sm_scale), int(causal), int(q_offset), int(k_offset),
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    KERNEL_LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        sm_scale: Optional[float] = None, q_offset: int = 0,
                        k_offset: int = 0, block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward; returns ``(o, lse)``.  CPU tensors take the
    plain version; CUDA tensors launch the hand-written kernel (64 x 64
    tiles, so ``block_q``/``block_k`` shape only the plain version) or
    raise."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(
            q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset,
            k_offset=k_offset, block_q=block_q, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on CPU or CUDA tensors, "
                         f"not {q.device.type}")
    return _flash_fwd_cuda(q, k, v, causal, float(sm_scale), int(q_offset),
                           int(k_offset))


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None, q_offset: int = 0,
                    k_offset: int = 0, block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K):
    """Blockwise (flash) attention. q,k,v: (B, H, S, D) -> (B, H, S, D).
    Forward only in this slice."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet: the flash backward kernel "
            "arrives with the training slice; call it under torch.no_grad()")
    out, _ = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                 q_offset=q_offset, k_offset=k_offset,
                                 block_q=block_q, block_k=block_k)
    return out
