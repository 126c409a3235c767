"""Flash attention for the port: a hand-written CUDA forward kernel, its plain
PyTorch version, and the reference.

Counterpart of ``ray_tpu/ops/attention.py``:

- ``mha_reference`` mirrors ``mha_reference`` (:51), the ground truth;
- ``flash_attention_fwd_plain`` mirrors ``_flash_forward`` (:136-185)
  blockwise: the same padding, online-softmax recurrence, causal block skip,
  masked-key handling and fully-masked-row convention, in PyTorch;
- ``split_plan`` cuts the visible KV tiles of each query tile into
  contiguous runs (split-KV) when the grid would not fill the card;
  ``flash_attention_fwd_split_plain`` and ``merge_partials_plain`` are the
  plain versions of the split kernel and of its merge (done by the split
  launch's last CTAs, or by the standalone ``flash_fwd_combine``):
  un-normalised f32 partials ``(m, l, acc)`` as ``_chunk_attention``
  (:296-313) returns them, merged as ``_online_merge`` (:287-293) and
  normalised as the Pallas kernel's epilogue (:126-128);
- ``flash_attention_fwd`` is the wrapper: on CPU tensors it runs the plain
  version, on CUDA tensors it launches ``csrc/flash_fwd.cu`` (which replaces
  the Pallas kernel ``_flash_fwd_kernel``, :66-129) or raises;
- ``flash_attention_bwd_plain`` mirrors ``_flash_backward`` (:189-247)
  block by block: delta = rowsum(o·g), P recomputed from the saved lse with
  live-row and padded-key masking, dq with the extra ``sm_scale``;
- ``flash_attention_bwd`` is its wrapper: on CPU tensors the plain version,
  on CUDA tensors the two launches of ``csrc/flash_bwd.cu`` (dQ, which
  also writes delta, then dK/dV) or a raise; ``flash_bwd_delta`` launches
  the standalone delta kernel;
  ``bwd_variant`` says which dK/dV and dQ kernels a dtype and head dim
  take (tensor cores for bf16 at D 64/128, f32 FMA otherwise);
- ``flash_attention`` keeps the JAX signature and the (B, H, S, D) layout,
  and is differentiable: ``_FlashAttention`` is the ``custom_vjp`` of
  :251-273, forward by ``flash_attention_fwd`` and backward by
  ``flash_attention_bwd``;
- ``ring_attention`` mirrors ``ring_attention`` (:316-365) on local
  shards over the sp process group: ``_chunk_attention`` is the flash
  forward of one (q shard, K/V chunk) pair at its global offsets,
  ``_online_merge`` (:287-293) merges the pairs' ``(o, lse)`` in f32, and
  K/V rotate by ``torch.distributed`` P2P in place of ``ppermute``;
  ``_RingAttention`` writes the backward that JAX gets by transposition;
  ``ring_attention_sharded`` (:375-397) runs it on DTensors.

``flash_attention``, ``mha_reference`` and ``ring_attention_sharded`` take
DTensors (a model sharded over a mesh): ``_on_local_shards`` lays q, k and
v out with the batch over dp and fsdp, the heads over tp and, for the
ring, the sequence over sp, and runs the function on each rank's local
shard, as ``shard_map`` would.  The kernels see plain tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
NEG_INF = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' tiles: 64 keys each; 64 query rows, or up to 16 in the
# decode kernel
KERNEL_BLOCK_Q = 64
KERNEL_BLOCK_K = 64
DECODE_MAX_SQ = 16
# variant name -> the C entry's variant code
_VARIANTS = {"simt": 0, "wgmma": 1, "decode": 2}
MAX_SPLITS = 32

# Launches of each hand-written kernel, counted by its wrapper where it
# launches and nowhere else.  A run resets a count to 0 and reads it back to
# show which kernels its path went through.
KERNEL_LAUNCHES = {"flash_fwd": 0, "flash_fwd_combine": 0,
                   "flash_bwd_delta": 0, "flash_bwd_dkdv": 0,
                   "flash_bwd_dq": 0}
# Launches of another kernel that did the named kernel's job inside it:
# ``flash_fwd`` launches that merged their KV splits in their last CTA, and
# ``flash_bwd_dq`` launches that computed delta in their prologue.  Counted
# where those launches are, beside ``KERNEL_LAUNCHES``.
FUSED_LAUNCHES = {"flash_fwd_combine": 0, "flash_bwd_delta": 0}
# What the last CUDA launch of the flash forward chose: variant, splits,
# grid, where the splits were merged, and which inputs it copied to aligned
# memory.
LAST_PLAN: Optional[Dict] = None
# The same for the last CUDA backward: its variant (``bwd_variant``), grids,
# and the inputs it copied (a head dim that is not contiguous, or on the
# tensor-core path a base or stride that is not a 16-byte multiple).
LAST_BWD_PLAN: Optional[Dict] = None

_fn = None
_combine_fn = None
_bwd_fns = None
_num_sms: Dict[int, int] = {}
# The split forward's int32 counters, one zeroed buffer of num_sms entries
# per (device, stream); every launch leaves them at zero.
_merge_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}


# ========================================================= on a mesh
def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _on_local_shards(fn, q, k, v, *, batch_axes=("dp", "fsdp"),
                     head_axis="tp", seq_axis=None, **kw):
    """``fn(q, k, v, **kw)`` for DTensors of (B, H, S, D): each rank runs
    ``fn`` on its local shard with the batch over ``batch_axes``, the heads
    over ``head_axis`` and, for the ring, the sequence over ``seq_axis``
    (other mesh dims replicate); the output comes back as a DTensor in that
    layout.  Differentiable: the gradients return in the same layout.  An
    sp dim of more than one rank that is not ``seq_axis`` is refused: each
    rank would see a slice of the keys."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = q.device_mesh
    by_axis = {**{a: Shard(0) for a in batch_axes}, head_axis: Shard(1)}
    if seq_axis is not None:
        by_axis[seq_axis] = Shard(2)
    layout = []
    for name, size in zip(mesh.mesh_dim_names, mesh.mesh.shape):
        if name == "sp" and size > 1 and name not in by_axis:
            raise NotImplementedError(
                "attention over a sequence split (sp > 1) is ring "
                "attention: ring_attention_sharded, or attention_impl="
                "\"ring\" in the model's config")
        layout.append(by_axis.get(name, Replicate()))
    local = [t.redistribute(mesh, layout).to_local() for t in (q, k, v)]
    o = fn(*local, **kw)
    return DTensor.from_local(o, mesh, layout, run_check=False,
                              shape=q.shape,
                              stride=torch.empty(q.shape, device="meta")
                              .stride())


# =========================================================== reference
def mha_reference(q, k, v, *, causal: bool = True,
                  sm_scale: Optional[float] = None, q_offset: int = 0,
                  k_offset: int = 0):
    """Naive attention; ground truth for kernels. q,k,v: (B, H, S, D)."""
    if _is_dtensor(q):
        return _on_local_shards(mha_reference, q, k, v, causal=causal,
                                sm_scale=sm_scale, q_offset=q_offset,
                                k_offset=k_offset)
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


# ========================================================= split plan
def _visible_tiles(q0: int, q_end: int, s_k: int, causal: bool,
                   q_offset: int, k_offset: int, block_k: int) -> int:
    """KV tiles that the real query rows [q0, q_end) can see (the kernels'
    ``visible_tiles``)."""
    n = -(-s_k // block_k)
    if causal:
        last_k = q_end - 1 + q_offset - k_offset
        n = 0 if last_k < 0 else min(n, last_k // block_k + 1)
    return n


def _split_runs(n: int, num_splits: int) -> Tuple[Tuple[int, int], ...]:
    """``n`` tiles cut into ``num_splits`` contiguous runs (start, count),
    as the kernels cut them; a run may be empty."""
    bounds = [s * n // num_splits for s in range(num_splits + 1)]
    return tuple((bounds[s], bounds[s + 1] - bounds[s])
                 for s in range(num_splits))


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """``runs[iq][s] = (first tile, tiles)`` of split ``s`` of query tile
    ``iq``, in units of ``block_k`` keys."""
    num_splits: int
    block_q: int
    block_k: int
    runs: Tuple[Tuple[Tuple[int, int], ...], ...]


@functools.lru_cache(maxsize=4096)
def split_plan(B: int, H: int, Sq: int, Sk: int, causal: bool,
               q_offset: int, k_offset: int, block_q: int, block_k: int,
               num_sms: int) -> SplitPlan:
    """How the flash kernels cut the KV axis.  A pure function of shapes,
    so a repeated call repeats its plan and its results.

    Splits are taken only when ``B*H*ceil(Sq/block_q)`` CTAs are fewer than
    ``num_sms``: then ``ceil(num_sms / CTAs)`` splits, at most the visible
    tiles of the longest query tile and at most ``MAX_SPLITS``.  Cached:
    the serving path asks for the same few shapes at every step."""
    n_q = -(-Sq // block_q)
    vis = [_visible_tiles(iq * block_q, min((iq + 1) * block_q, Sq), Sk,
                          causal, q_offset, k_offset, block_k)
           for iq in range(n_q)]
    ctas = B * H * n_q
    splits = 1
    if 0 < ctas < num_sms:
        splits = max(1, min(-(-num_sms // ctas), max(vis, default=0),
                            MAX_SPLITS))
    return SplitPlan(splits, block_q, block_k,
                     tuple(_split_runs(n, splits) for n in vis))


def flash_attention_fwd_split_plain(q, k, v, *, causal: bool = True,
                                    sm_scale: Optional[float] = None,
                                    q_offset: int = 0, k_offset: int = 0,
                                    num_splits: int = 1,
                                    block_q: int = KERNEL_BLOCK_Q,
                                    block_k: int = KERNEL_BLOCK_K):
    """The split kernel's function in PyTorch: for each query tile and each
    of ``num_splits`` runs of its visible KV tiles, the online-softmax
    recurrence over that run only.  Returns un-normalised f32 partials
    ``(acc, m, l)``: acc (B,H,splits,Sq,D), m and l (B,H,splits,Sq); an
    empty or fully masked run carries m = -1e30, l = 0, acc = 0."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    dev = q.device
    qf = q.float() * sm_scale
    kf, vf = k.float(), v.float()
    acc = torch.zeros((b, h, num_splits, s_q, d), device=dev)
    m = torch.full((b, h, num_splits, s_q), NEG_INF, device=dev)
    l = torch.zeros((b, h, num_splits, s_q), device=dev)
    for iq in range(-(-s_q // block_q)):
        r0, r1 = iq * block_q, min((iq + 1) * block_q, s_q)
        n = _visible_tiles(r0, r1, s_k, causal, q_offset, k_offset, block_k)
        qb = qf[:, :, r0:r1]
        q_pos = torch.arange(r0, r1, device=dev)[:, None] + q_offset
        for split, (start, count) in enumerate(_split_runs(n, num_splits)):
            mi = torch.full((b, h, r1 - r0), NEG_INF, device=dev)
            li = torch.zeros((b, h, r1 - r0), device=dev)
            ai = torch.zeros((b, h, r1 - r0, d), device=dev)
            for t in range(start, start + count):
                k0, k1 = t * block_k, min((t + 1) * block_k, s_k)
                sc = qb @ kf[:, :, k0:k1].transpose(-1, -2)
                if causal:
                    k_pos = torch.arange(k0, k1, device=dev)[None, :]
                    sc = torch.where(q_pos >= k_pos + k_offset, sc, NEG_INF)
                m_new = torch.maximum(mi, sc.amax(dim=-1))
                # a row with no visible key so far keeps p = 0
                p = torch.where(m_new[..., None] <= NEG_INF / 2, 0.0,
                                torch.exp(sc - m_new[..., None]))
                alpha = torch.exp(mi - m_new)
                li = li * alpha + p.sum(dim=-1)
                ai = ai * alpha[..., None] + p @ vf[:, :, k0:k1]
                mi = m_new
            acc[:, :, split, r0:r1] = ai
            m[:, :, split, r0:r1] = mi
            l[:, :, split, r0:r1] = li
    return acc, m, l


def merge_partials_plain(acc, m, l, dtype=torch.float32):
    """The combine kernel's function: merge the splits (axis 2) of
    ``(acc, m, l)`` as ``_online_merge`` does, then normalise.  Returns
    ``(o, lse)``: o (B,H,Sq,D) in ``dtype``; a row dead in every split gives
    o = 0 and lse = -1e30."""
    mx = m.amax(dim=2, keepdim=True)
    w = torch.exp(m - mx)
    total = (l * w).sum(dim=2)
    o = (acc * w[..., None]).sum(dim=2)
    safe = torch.where(total == 0.0, 1.0, total)
    lse = torch.where(total == 0.0, NEG_INF, mx[:, :, 0] + torch.log(safe))
    return (o / safe[..., None]).to(dtype), lse


def flash_bwd_delta_plain(o, g) -> torch.Tensor:
    """delta = rowsum(o·g) in f32, (B, H, Sq): the backward's first pass
    (``_flash_backward``'s ``delta``, :198)."""
    return (o.float() * g.float()).sum(dim=-1)


def flash_attention_bwd_plain(q, k, v, o, lse, g, *, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              q_offset: int = 0, k_offset: int = 0,
                              block_k: int = DEFAULT_BLOCK_K
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``_flash_backward`` in PyTorch, block for block: recompute P over
    ``block_k``-key blocks from the saved ``lse`` (rows with lse = -1e30
    give P = 0), delta = rowsum(o·g) in f32, all math in f32.  Returns
    ``(dq, dk, dv)`` in the input dtypes."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    dev = q.device
    qf = q.float() * sm_scale
    gf = g.float()
    delta = flash_bwd_delta_plain(o, g)
    block_k = min(block_k, s_k)
    s_k_pad = _round_up(s_k, block_k)
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, s_k_pad - s_k))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, s_k_pad - s_k))
    q_pos = torch.arange(s_q, device=dev)[:, None] + q_offset
    live = (lse > NEG_INF / 2)[..., None]
    dq = torch.zeros((b, h, s_q, d), device=dev)
    dk = torch.empty((b, h, s_k_pad, d), device=dev)
    dv = torch.empty((b, h, s_k_pad, d), device=dev)
    for j in range(s_k_pad // block_k):
        blk = slice(j * block_k, (j + 1) * block_k)
        kj, vj = kf[:, :, blk], vf[:, :, blk]
        s = qf @ kj.transpose(-1, -2)
        k_idx = torch.arange(block_k, device=dev)[None, :] + j * block_k
        valid = k_idx < s_k
        if causal:
            valid = valid & (q_pos >= k_idx + k_offset)
        s = torch.where(valid, s, NEG_INF)
        p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
        dv[:, :, blk] = p.transpose(-1, -2) @ gf
        dp = gf @ vj.transpose(-1, -2)
        ds = p * (dp - delta[..., None])
        dq += ds @ kj
        dk[:, :, blk] = ds.transpose(-1, -2) @ qf
    # s = (q*sm_scale)·kᵀ: dq takes the extra sm_scale, dk has it through qf
    dq = dq * sm_scale
    return (dq.to(q.dtype), dk[:, :, :s_k].to(k.dtype),
            dv[:, :, :s_k].to(v.dtype))


# ============================================================ kernel
def _kernel():
    global _fn, _combine_fn
    if _fn is None:
        from ray_tpu_torch._native import build

        lib = build.load("flash_fwd")
        fn = lib.ray_flash_fwd
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                       + [ctypes.c_int64] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        comb = lib.ray_flash_fwd_combine
        comb.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                         + [ctypes.c_void_p])
        comb.restype = ctypes.c_int
        _fn, _combine_fn = fn, comb
    return _fn, _combine_fn


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _num_sms:
        _num_sms[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _num_sms[idx]


@functools.lru_cache(maxsize=4096)
def _kernel_strides(shape: Tuple[int, ...], stride: Tuple[int, ...],
                    esize: int) -> Tuple[Tuple[int, ...], bool]:
    """Strides (elements) of dims 0..2 as the kernels read them, and whether
    each is a 16-byte multiple.  A dim of size 1 is never stepped, so its
    stride is set to the span of the dims inside it: any value works there,
    and this one keeps TMA's 16-byte rule.  Cached: the wrapper's host time
    is part of every decode step."""
    st = list(stride[:3])
    if shape[2] == 1:
        st[2] = shape[3]
    if shape[1] == 1:
        st[1] = shape[2] * st[2]
    if shape[0] == 1:
        st[0] = shape[1] * st[1]
    return tuple(st), all(x * esize % 16 == 0 for x in st)


def _check_err(err: int, what: str) -> None:
    if err >= 10000:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a TMA map "
                           f"(CUresult {err - 10000})")
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def flash_fwd_combine(acc, m, l, dtype=torch.float32):
    """Merge split partials ``(acc, m, l)`` (the layout of
    ``flash_attention_fwd_split_plain``) into ``(o, lse)``.  CPU tensors
    take ``merge_partials_plain``; CUDA tensors launch the combine kernel of
    ``csrc/flash_fwd.cu`` or raise.  The forward merges its own splits in
    its last CTAs with the same code: this kernel stands alone, for
    partials handed to it."""
    if acc.device.type == "cpu":
        return merge_partials_plain(acc, m, l, dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"flash_fwd_combine runs on CPU or CUDA tensors, "
                         f"not {acc.device.type}")
    b, h, splits, s_q, d = acc.shape
    if dtype not in _KERNEL_DTYPES or d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_fwd_combine takes float32 or bfloat16 and "
                         f"D in {KERNEL_HEAD_DIMS}, not {dtype}, D={d}")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           or t.device != acc.device for t in (acc, m, l)):
        raise ValueError("flash_fwd_combine takes contiguous f32 partials "
                         "on one device")
    if m.shape != acc.shape[:4] or l.shape != acc.shape[:4]:
        raise ValueError(f"partials disagree: acc {tuple(acc.shape)}, m "
                         f"{tuple(m.shape)}, l {tuple(l.shape)}")
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"flash_fwd_combine merges 1 to {MAX_SPLITS} "
                         f"splits, not {splits}")
    if acc.data_ptr() % 16:  # the kernel reads acc as 16-byte vectors
        acc = acc.clone()
    o = torch.empty((b, h, s_q, d), dtype=dtype, device=acc.device)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=acc.device)
    _, comb = _kernel()
    with torch.cuda.device(acc.device):
        err = comb(acc.data_ptr(), m.data_ptr(), l.data_ptr(), o.data_ptr(),
                   lse.data_ptr(), _KERNEL_DTYPES[dtype], b * h, s_q, d,
                   splits, torch.cuda.current_stream(acc.device).cuda_stream)
        _check_err(err, "flash_fwd_combine kernel")
        KERNEL_LAUNCHES["flash_fwd_combine"] += 1
    return o, lse


def _flash_fwd_cuda(q, k, v, causal: bool, sm_scale: float, q_offset: int,
                    k_offset: int, partials: bool = False):
    """``(o, lse)`` from one launch of the forward kernels.  With
    ``partials``, ``(o, lse, part)``: ``part`` is the split launch's f32
    partials ``(acc, m, l)`` in ``flash_fwd_combine``'s layout, which its
    last CTAs merged into o and lse (None with one split)."""
    global LAST_PLAN
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
    if s_k == 0:
        raise ValueError("flash_fwd kernel needs at least one key")
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
        return (o, lse, None) if partials else (o, lse)
    if s_q <= DECODE_MAX_SQ:
        variant, block_q = "decode", DECODE_MAX_SQ
    elif q.dtype == torch.bfloat16 and d in (64, 128):
        variant, block_q = "wgmma", KERNEL_BLOCK_Q
    else:
        variant, block_q = "simt", KERNEL_BLOCK_Q
    # K/V rows arrive by 16-byte cp.async or TMA copies, and the tensor-core
    # path loads Q by TMA too: an input whose base or a stride is not a
    # 16-byte multiple is copied to fresh contiguous memory first.
    copied, inputs, strides = [], [], []
    for name, t in (("q", q), ("k", k), ("v", v)):
        st, ok = _kernel_strides(t.shape, t.stride(), t.element_size())
        if (name != "q" or variant == "wgmma") and not (
                ok and t.data_ptr() % 16 == 0):
            t = torch.empty_like(
                t, memory_format=torch.contiguous_format).copy_(t)
            st, _ = _kernel_strides(t.shape, t.stride(), t.element_size())
            copied.append(name)
        inputs.append(t)
        strides += st
    q, k, v = inputs
    plan = split_plan(b, h, s_q, s_k, causal, q_offset, k_offset, block_q,
                      KERNEL_BLOCK_K, _sm_count(q.device))
    splits = plan.num_splits
    LAST_PLAN = {"variant": variant, "num_splits": splits,
                 "grid": [-(-s_q // block_q), b * h, splits],
                 "merge": "in_kernel" if splits > 1 else None,
                 "copied": copied}
    part, ptrs = None, (None, None, None)
    if splits > 1:
        # one f32 workspace: acc (B,H,splits,Sq,D), then m, then l
        # (B,H,splits,Sq) each.  Dropping it on return is safe: PyTorch's
        # caching allocator hands the block out again only to work queued
        # on this stream after the kernel.
        n = b * h * splits * s_q
        ws = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
        part = (ws[:n * d].view(b, h, splits, s_q, d),
                ws[n * d:n * (d + 1)].view(b, h, splits, s_q),
                ws[n * (d + 1):].view(b, h, splits, s_q))
        ptrs = tuple(t.data_ptr() for t in part)
    fn, _ = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counters, key = None, (q.device, stream)
        if splits > 1:
            counters = _merge_counters.get(key)
            if counters is None:
                counters = _merge_counters[key] = torch.zeros(
                    _sm_count(q.device), dtype=torch.int32, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), *ptrs,
                 None if counters is None else counters.data_ptr(),
                 0 if counters is None else counters.numel(),
                 _KERNEL_DTYPES[q.dtype], _VARIANTS[variant], splits, b, h,
                 s_q, s_k, d, *strides, float(sm_scale), int(causal),
                 int(q_offset), int(k_offset), stream)
        if err and counters is not None:
            # a launch that failed may have left counts behind
            _merge_counters.pop(key, None)
        _check_err(err, "flash_fwd kernel")
        KERNEL_LAUNCHES["flash_fwd"] += 1
        if splits > 1:
            FUSED_LAUNCHES["flash_fwd_combine"] += 1
    return (o, lse, part) if partials else (o, lse)


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        sm_scale: Optional[float] = None, q_offset: int = 0,
                        k_offset: int = 0, block_q: int = DEFAULT_BLOCK_Q,
                        block_k: int = DEFAULT_BLOCK_K
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward; returns ``(o, lse)``.  CPU tensors take the
    plain version; CUDA tensors launch the hand-written kernels (64-key
    tiles, split-KV as ``split_plan`` says, so ``block_q``/``block_k`` shape
    only the plain version) or raise."""
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


def _bwd_kernels():
    global _bwd_fns
    if _bwd_fns is None:
        from ray_tpu_torch._native import build

        lib = build.load("flash_bwd")
        delta = lib.ray_flash_bwd_delta
        delta.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                          + [ctypes.c_int64] * 6 + [ctypes.c_void_p])
        delta.restype = ctypes.c_int
        fns = {"flash_bwd_delta": delta}
        for name in ("flash_bwd_dkdv", "flash_bwd_dq"):
            fn = getattr(lib, "ray_" + name)
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                           + [ctypes.c_int64] * 15
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            fns[name] = fn
        _bwd_fns = fns
    return _bwd_fns


def bwd_variant(dtype: torch.dtype, d: int) -> str:
    """Which dK/dV and dQ kernels ``csrc/flash_bwd.cu`` runs for inputs of
    ``dtype`` and head dim ``d`` (the C entries choose the same):
    ``"wgmma"`` (tensor cores, TMA tiles) for bf16 with D 64 or 128,
    ``"simt"`` (exact f32 FMA on the CUDA cores) otherwise."""
    return "wgmma" if dtype == torch.bfloat16 and d in (64, 128) else "simt"


def _bwd_inputs(variant: str, named):
    """The backward kernels' inputs ``(name, tensor)`` as they will read
    them: ``(tensors, strides, copied)``.  Every kernel needs a contiguous
    head dim; the tensor-core kernels load q, k, v and g by TMA, which also
    needs 16-byte bases and strides.  An input that fails is copied to
    fresh contiguous memory and named in ``copied``; strides are those of
    ``_kernel_strides`` (dims 0..2, elements)."""
    copied, inputs, strides = [], [], []
    for name, t in named:
        st, ok = _kernel_strides(t.shape, t.stride(), t.element_size())
        tma = variant == "wgmma" and name != "o"
        if t.stride(3) != 1 or (tma and not (ok and t.data_ptr() % 16 == 0)):
            t = torch.empty_like(
                t, memory_format=torch.contiguous_format).copy_(t)
            st, _ = _kernel_strides(t.shape, t.stride(), t.element_size())
            copied.append(name)
        inputs.append(t)
        strides.append(st)
    return inputs, strides, copied


def _flash_bwd_cuda(q, k, v, o, lse, g, causal: bool, sm_scale: float,
                    q_offset: int, k_offset: int, return_delta: bool = False):
    """``(dq, dk, dv)`` from the two backward launches: dQ, which also
    writes delta = rowsum(o·g), then dK/dV.  With ``return_delta``,
    ``(dq, dk, dv, delta)``: the delta the dQ launch wrote."""
    global LAST_BWD_PLAN
    b, h, s_q, d = q.shape
    s_k = k.shape[2]
    for name, t, rows in (("k", k, s_k), ("v", v, s_k), ("o", o, s_q),
                          ("g", g, s_q)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if tuple(t.shape) != (b, h, rows, d):
            raise ValueError(f"{name} shape {tuple(t.shape)} does not match "
                             f"q {tuple(q.shape)} (B, H, S, D)")
    if lse.device != q.device or tuple(lse.shape) != (b, h, s_q):
        raise ValueError(f"lse must be (B, H, Sq) = {(b, h, s_q)} on "
                         f"{q.device}, not {tuple(lse.shape)} on "
                         f"{lse.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash_bwd kernels take float32 or bfloat16, "
                         f"not {q.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_bwd kernels take head dim in "
                         f"{KERNEL_HEAD_DIMS}, not {d}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the kernel grid (65535)")
    dq = torch.empty((b, h, s_q, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, h, s_k, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, h, s_k, d), dtype=v.dtype, device=q.device)
    if s_q == 0 or s_k == 0:
        out = (dq.zero_(), dk.zero_(), dv.zero_())
        return (*out, flash_bwd_delta(o, g)) if return_delta else out
    variant = bwd_variant(q.dtype, d)
    (q, k, v, o, g), st, copied = _bwd_inputs(
        variant, (("q", q), ("k", k), ("v", v), ("o", o), ("g", g)))
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        lse = lse.float().contiguous()
        copied.append("lse")
    LAST_BWD_PLAN = {"variant": variant,
                     "grid_dkdv": [-(-s_k // KERNEL_BLOCK_K), b * h],
                     "grid_dq": [-(-s_q // KERNEL_BLOCK_Q), b * h],
                     "copied": copied}
    fns = _bwd_kernels()
    dt = _KERNEL_DTYPES[q.dtype]
    strides = [x for i in (0, 1, 2, 4, 3) for x in st[i]]  # q, k, v, g, o
    # written by the dQ launch, read by the dK/dV launch after it
    delta = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for name in ("flash_bwd_dq", "flash_bwd_dkdv"):
            err = fns[name](
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                o.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), dt, b, h, s_q, s_k, d,
                *strides, float(sm_scale), int(causal), int(q_offset),
                int(k_offset), stream)
            _check_err(err, f"{name} kernel")
            KERNEL_LAUNCHES[name] += 1
        FUSED_LAUNCHES["flash_bwd_delta"] += 1
    return (dq, dk, dv, delta) if return_delta else (dq, dk, dv)


def flash_bwd_delta(o, g) -> torch.Tensor:
    """rowsum(o·g) in f32.  CPU tensors take ``flash_bwd_delta_plain``;
    CUDA tensors launch the standalone delta kernel of
    ``csrc/flash_bwd.cu`` or raise.  The backward does not launch it: its
    dQ kernel computes delta in its prologue with the same code."""
    if o.device.type == "cpu":
        return flash_bwd_delta_plain(o, g)
    if o.device.type != "cuda":
        raise ValueError(f"flash_bwd_delta runs on CPU or CUDA tensors, "
                         f"not {o.device.type}")
    if (g.shape != o.shape or g.dtype != o.dtype or g.device != o.device
            or o.dim() != 4 or o.dtype not in _KERNEL_DTYPES):
        raise ValueError(f"flash_bwd_delta takes o and g of one (B, H, S, "
                         f"D) shape, device and dtype (float32 or "
                         f"bfloat16), not {tuple(o.shape)} {o.dtype} and "
                         f"{tuple(g.shape)} {g.dtype}")
    if o.shape[3] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_bwd_delta takes head dim in "
                         f"{KERNEL_HEAD_DIMS}, not {o.shape[3]}")
    if o.numel() == 0:
        return torch.zeros(o.shape[:3], device=o.device)
    o, g = (t if t.stride(3) == 1 else t.contiguous() for t in (o, g))
    b, h, s_q, d = o.shape
    delta = torch.empty((b, h, s_q), dtype=torch.float32, device=o.device)
    with torch.cuda.device(o.device):
        err = _bwd_kernels()["flash_bwd_delta"](
            o.data_ptr(), g.data_ptr(), delta.data_ptr(),
            _KERNEL_DTYPES[o.dtype], b, h, s_q, d, *o.stride()[:3],
            *g.stride()[:3], torch.cuda.current_stream(o.device).cuda_stream)
        _check_err(err, "flash_bwd_delta kernel")
        KERNEL_LAUNCHES["flash_bwd_delta"] += 1
    return delta


def flash_attention_bwd(q, k, v, o, lse, g, *, causal: bool = True,
                        sm_scale: Optional[float] = None, q_offset: int = 0,
                        k_offset: int = 0, block_k: int = DEFAULT_BLOCK_K
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-attention backward; returns ``(dq, dk, dv)`` in the input
    dtypes from the forward's ``o`` and ``lse`` and the output gradient
    ``g``.  CPU tensors take the plain version; CUDA tensors launch the
    hand-written kernels (64-key tiles, so ``block_k`` shapes only the plain
    version) or raise."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(
            q, k, v, o, lse, g, causal=causal, sm_scale=sm_scale,
            q_offset=q_offset, k_offset=k_offset, block_k=block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CPU or CUDA tensors, "
                         f"not {q.device.type}")
    return _flash_bwd_cuda(q, k, v, o, lse, g, causal, float(sm_scale),
                           int(q_offset), int(k_offset))


class _FlashAttention(torch.autograd.Function):
    """``_flash_attention``'s custom_vjp (:251-273): the forward saves
    ``(q, k, v, o, lse)``, the backward recomputes P from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, q_offset, k_offset,
                block_q, block_k):
        o, lse = flash_attention_fwd(q, k, v, causal=causal,
                                     sm_scale=sm_scale, q_offset=q_offset,
                                     k_offset=k_offset, block_q=block_q,
                                     block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, sm_scale, q_offset, k_offset, block_k)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        causal, sm_scale, q_offset, k_offset, block_k = ctx.args
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, g, causal=causal, sm_scale=sm_scale,
            q_offset=q_offset, k_offset=k_offset, block_k=block_k)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None, q_offset: int = 0,
                    k_offset: int = 0, block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K):
    """Blockwise (flash) attention. q,k,v: (B, H, S, D) -> (B, H, S, D).
    Differentiable: the backward is ``flash_attention_bwd``.  DTensors run
    the kernels on each rank's local shard (``_on_local_shards``)."""
    if _is_dtensor(q):
        return _on_local_shards(flash_attention, q, k, v, causal=causal,
                                sm_scale=sm_scale, q_offset=q_offset,
                                k_offset=k_offset, block_q=block_q,
                                block_k=block_k)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, float(sm_scale),
                                 int(q_offset), int(k_offset), block_q,
                                 block_k)


# ======================================================== ring attention
def _online_merge(o_a, lse_a, o_b, lse_b):
    """Two partials ``(o, lse)`` of the same query rows over disjoint keys
    merged into the union's, in f32: lse = logaddexp(lse_a, lse_b) and
    o = o_a·e^(lse_a−lse) + o_b·e^(lse_b−lse).  The reference's
    ``_online_merge`` (:287-293) on ``(m, l, acc)``, with lse = m + log l
    and o = acc / l.  A row dead in both (o = 0, lse = -1e30) stays so."""
    lse = torch.logaddexp(lse_a, lse_b)
    o = (o_a.float() * torch.exp(lse_a - lse)[..., None]
         + o_b.float() * torch.exp(lse_b - lse)[..., None])
    return o, lse


def _chunk_attention(q, k, v, sm_scale, causal, q_off, k_off):
    """The partials ``(o, lse)`` of one (q shard, kv chunk) pair: the flash
    forward at the pair's global offsets, so the kernel on CUDA tensors and
    its plain version on CPU ones.  The reference's ``_chunk_attention``
    (:296-313) computes the same function in XLA, un-normalised."""
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                               q_offset=q_off, k_offset=k_off)


def _ring_fwd_step(q, k_c, v_c, acc, *, me, src, chunk, causal, sm_scale):
    """The forward's step at ring position ``me`` holding the K/V chunk of
    position ``src``: ``acc``, the merged f32 ``(o, lse)`` so far (None
    before the first step), with this pair's partials merged in.  A step
    that causality hides entirely (``src > me``) launches nothing: the
    reference computes it to zero."""
    if causal and src > me:
        return acc
    o, lse = _chunk_attention(q, k_c, v_c, sm_scale, causal, me * chunk,
                              src * chunk)
    if acc is None:
        return o.float(), lse
    return _online_merge(*acc, o, lse)


def _ring_bwd_step(q, k_c, v_c, o, lse, g, dq, dkv, *, me, src, chunk,
                   causal, sm_scale):
    """The backward's step at ring position ``me`` holding ``src``'s K/V
    chunk: the flash backward of the pair with the merged (global) ``o``
    and ``lse``, so that delta and P are the whole softmax's; dq adds into
    the local f32 ``dq`` and dk, dv into ``dkv`` (f32, (2, B, H, c, D)),
    the sums that travel with the chunk.  The pair's gradients come in the
    inputs' dtype, so a bf16 ring rounds them once more than the whole
    sequence's backward does.  Hidden steps launch nothing."""
    if causal and src > me:
        return
    dq_c, dk_c, dv_c = flash_attention_bwd(
        q, k_c, v_c, o, lse, g, causal=causal, sm_scale=sm_scale,
        q_offset=me * chunk, k_offset=src * chunk)
    dq.add_(dq_c)
    dkv[0].add_(dk_c)
    dkv[1].add_(dv_c)


def _ring_pass(group, t: torch.Tensor):
    """Start sending ``t`` (contiguous) to the next rank of ``group``'s
    ring and receiving the previous rank's into a new buffer: (requests,
    buffer)."""
    import torch.distributed as dist

    sp, me = group.size(), group.rank()
    buf = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t, dist.get_global_rank(group, (me + 1) % sp),
                   group),
        dist.P2POp(dist.irecv, buf,
                   dist.get_global_rank(group, (me - 1) % sp), group)])
    return reqs, buf


def _wait(reqs) -> None:
    for req in reqs:
        req.wait()


def _ring_forward(q, k, v, group, causal: bool, sm_scale: float):
    """``ring_attention``'s forward: ``(o, lse)``, o in q's dtype.  K/V
    travel as one (2, B, H, c, D) tensor; each rotation is started before
    the step that uses the chunk in hand, and the last one is dropped."""
    sp, me = group.size(), group.rank()
    kv = torch.stack([k, v])
    acc = None
    for i in range(sp):
        if i + 1 < sp:
            reqs, nxt = _ring_pass(group, kv)
        acc = _ring_fwd_step(q, kv[0], kv[1], acc, me=me, src=(me - i) % sp,
                             chunk=q.shape[2], causal=causal,
                             sm_scale=sm_scale)
        if i + 1 < sp:
            _wait(reqs)
            kv = nxt
    o, lse = acc
    return o.to(q.dtype), lse


def _ring_backward(q, k, v, o, lse, g, group, causal: bool,
                   sm_scale: float):
    """``ring_attention``'s backward: ``(dq, dk, dv)`` in the inputs'
    dtypes.  K/V rotate again and their f32 dK/dV sums travel with them;
    after ``sp`` rotations of the sums each is back with its chunk's
    owner."""
    sp, me = group.size(), group.rank()
    kv = torch.stack([k, v])
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for i in range(sp):
        if i + 1 < sp:
            reqs, kv_next = _ring_pass(group, kv)
        _ring_bwd_step(q, kv[0], kv[1], o, lse, g, dq, dkv, me=me,
                       src=(me - i) % sp, chunk=q.shape[2], causal=causal,
                       sm_scale=sm_scale)
        if sp > 1:
            dkv_reqs, dkv = _ring_pass(group, dkv)
            _wait(dkv_reqs)
        if i + 1 < sp:
            _wait(reqs)
            kv = kv_next
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The ring's forward and its backward, which JAX gets by transposing
    ``scan`` and ``ppermute``.  Saves the local q, k, v and the merged o
    and lse: every rank keeps its own K/V chunk, never the rotated ones."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale):
        o, lse = _ring_forward(q, k, v, group, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (group, causal, sm_scale)
        return o

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv = _ring_backward(*ctx.saved_tensors, g, *ctx.args)
        return dq, dk, dv, None, None, None


def ring_attention(q, k, v, *, group, causal: bool = True,
                   sm_scale: Optional[float] = None):
    """Ring attention over the ranks of ``group`` (the sp process group; the
    reference's ``axis_name``, :316-365), on local shards: each rank holds
    the (B, H, S/sp, D) chunk of q, k and v at its group rank's position of
    the sequence.  K/V rotate to the next rank with
    ``torch.distributed`` P2P while each rank merges the partials of its
    queries against every chunk, as ``flash_attention`` of the whole
    sequence would compute them.  Differentiable."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, group, causal, float(sm_scale))


def ring_attention_sharded(q, k, v, *, mesh=None, causal: bool = True,
                           sm_scale: Optional[float] = None,
                           batch_axes=("dp", "fsdp"), head_axis: str = "tp",
                           seq_axis: str = "sp"):
    """Ring attention on DTensors of (B, H, S, D) (:375-397): laid out with
    the batch over ``batch_axes``, the heads over ``head_axis`` and the
    sequence over ``seq_axis``, each rank runs ``ring_attention`` on its
    local shard over ``seq_axis``'s process group.  ``mesh`` is the
    DTensors' own.  A mesh without ``seq_axis`` (an axis of one rank, which
    ``parallel.mesh.active_mesh`` leaves out) is a ring of one: flash
    attention on the local shards."""
    if not _is_dtensor(q):
        raise ValueError("ring_attention_sharded takes DTensors on a device "
                         "mesh (the reference's needs a mesh too); "
                         "ring_attention takes local shards")
    if mesh is not None and mesh != q.device_mesh:
        raise ValueError("ring_attention_sharded: mesh is not the mesh the "
                         "DTensors live on")
    kw = dict(causal=causal, sm_scale=sm_scale, batch_axes=batch_axes,
              head_axis=head_axis)
    if seq_axis not in q.device_mesh.mesh_dim_names:
        return _on_local_shards(flash_attention, q, k, v, **kw)
    return _on_local_shards(ring_attention, q, k, v, seq_axis=seq_axis,
                            group=q.device_mesh.get_group(seq_axis), **kw)


def ring_attention_fwd_unrolled(q, k, v, *, sp: int, causal: bool = True,
                                sm_scale: Optional[float] = None):
    """The ring's forward schedule in one process: q, k, v of the whole
    sequence cut into ``sp`` contiguous chunks, and at step i position r
    runs ``_ring_fwd_step`` on chunk (r − i) mod sp, no exchange.  Returns
    the whole ``(o, lse)``, as ``ring_attention`` on ``sp`` ranks puts it
    together: for checking the ring's steps where one process holds every
    position."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    chunk = q.shape[2] // sp
    qs, ks, vs = ([c.contiguous() for c in t.split(chunk, dim=2)]
                  for t in (q, k, v))
    acc = [None] * sp
    for i in range(sp):
        for r in range(sp):
            src = (r - i) % sp
            acc[r] = _ring_fwd_step(qs[r], ks[src], vs[src], acc[r], me=r,
                                    src=src, chunk=chunk, causal=causal,
                                    sm_scale=sm_scale)
    return (torch.cat([a[0] for a in acc], dim=2).to(q.dtype),
            torch.cat([a[1] for a in acc], dim=2))


def ring_attention_bwd_unrolled(q, k, v, o, lse, g, *, sp: int,
                                causal: bool = True,
                                sm_scale: Optional[float] = None):
    """The ring's backward schedule in one process (see
    ``ring_attention_fwd_unrolled``): at step i position r runs
    ``_ring_bwd_step`` on chunk (r − i) mod sp, whose f32 dK/dV sums take
    the additions in the ring's order.  Returns ``(dq, dk, dv)`` in the
    inputs' dtypes."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    chunk = q.shape[2] // sp
    qs, ks, vs, os_, gs = ([c.contiguous() for c in t.split(chunk, dim=2)]
                           for t in (q, k, v, o, g))
    lses = [c.contiguous() for c in lse.split(chunk, dim=2)]
    dq = [torch.zeros(c.shape, dtype=torch.float32, device=c.device)
          for c in qs]
    dkv = [torch.zeros((2, *c.shape), dtype=torch.float32, device=c.device)
           for c in ks]
    for i in range(sp):
        for r in range(sp):
            src = (r - i) % sp
            _ring_bwd_step(qs[r], ks[src], vs[src], os_[r], lses[r], gs[r],
                           dq[r], dkv[src], me=r, src=src, chunk=chunk,
                           causal=causal, sm_scale=sm_scale)
    return (torch.cat(dq, dim=2).to(q.dtype),
            torch.cat([d[0] for d in dkv], dim=2).to(k.dtype),
            torch.cat([d[1] for d in dkv], dim=2).to(v.dtype))
