"""Port of ``ray_tpu/util/collective/quantization.py``.

Block-scaled int8 wire quantization for host collectives.

Per EQuARX (arXiv:2506.17615): ship int8 on the wire with one fp32 scale
per ``collective_quant_block`` elements, dequantize -> reduce -> requantize
at each ring hop.  4x fewer wire bytes at a bounded, measurable error.

Format (symmetric, round-to-nearest):

    scale_b = absmax(block_b) / 127          (0 for an all-zero block)
    q       = clip(round(x / scale_b), -127, 127)  as int8
    dequant = q * scale_b                    (float32)

Per-element round-trip error is <= scale_b / 2 = absmax(block_b) / 254 —
the analytic bound :func:`max_error_bound` returns and tests assert
against.  A reduction that requantizes partial sums at each of H hops
accumulates at most ``sum_h scale_h / 2`` elementwise (triangle
inequality); the collective layer reports the *measured* per-op total via
the ``collective_quant_error`` metric.

The wire record is a plain dict (pickles through the RPC layer's
out-of-band buffer path: the int8 payload and the scales both ride
zero-copy).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ray_tpu_torch._private.config import RayConfig

# wire-record marker key; collective.py sniffs this to decide dequant
QKEY = "__q8__"


def quantize_blockwise(arr: np.ndarray, block: int = 0) -> Tuple[Dict, float]:
    """Quantize ``arr`` to the block-scaled int8 wire record.

    Returns ``(record, measured_max_error)`` where the error is the actual
    max |x - dequant(quant(x))| of this quantization (always <= the
    analytic :func:`max_error_bound` of the record's scales).
    """
    if block <= 0:
        block = RayConfig.collective_quant_block
    a = np.ascontiguousarray(arr, dtype=np.float32)
    flat = a.ravel()
    n = flat.size
    nblocks = max((n + block - 1) // block, 1)
    padded = nblocks * block
    if padded != n:
        buf = np.zeros(padded, np.float32)
        buf[:n] = flat
    else:
        buf = flat
    blocks = buf.reshape(nblocks, block)
    # per-block absmax without materializing a full |x| temp
    absmax = blocks.max(axis=1)
    np.maximum(absmax, -blocks.min(axis=1), out=absmax)
    scales = (absmax / 127.0).astype(np.float32)
    # all-zero blocks: scale 0 would divide by zero; quantize against 1.0
    # (values are all 0 so q is 0 regardless) and keep scale 0 on the wire
    safe = np.where(scales > 0.0, scales, 1.0).astype(np.float32)
    inv = np.float32(1.0) / safe
    # |x| <= absmax makes |x * inv| <= 127 up to one rounding ulp, which
    # rint absorbs — no clip pass needed
    r = blocks * inv[:, None]
    np.rint(r, out=r)
    q = r.astype(np.int8)
    # exact measured error, reusing r as the scratch: |x - q * scale|
    # (safe == scales except on all-zero blocks, where q is 0 and the
    # product is 0 under either)
    np.multiply(r, safe[:, None], out=r)
    np.subtract(blocks, r, out=r)
    np.abs(r, out=r)
    err = float(r.max()) if n else 0.0
    rec = {QKEY: 1, "d": q.reshape(-1)[:n].copy() if padded != n else q.ravel(),
           "s": scales, "n": n, "block": block,
           "shape": tuple(arr.shape), "dtype": np.dtype(arr.dtype).str}
    return rec, err


def dequantize_blockwise(rec: Dict) -> np.ndarray:
    """Inverse of :func:`quantize_blockwise` (float32, original shape)."""
    n, block = rec["n"], rec["block"]
    nblocks = max((n + block - 1) // block, 1)
    q = np.asarray(rec["d"], dtype=np.int8)
    if q.size != nblocks * block:
        buf = np.zeros(nblocks * block, np.int8)
        buf[:n] = q
        q = buf
    out = (q.reshape(nblocks, block).astype(np.float32)
           * np.asarray(rec["s"], np.float32)[:, None]).ravel()[:n]
    return out.reshape(rec["shape"])


def is_quantized(payload) -> bool:
    return isinstance(payload, dict) and payload.get(QKEY) == 1


def wire_bytes(rec: Dict) -> int:
    """Bytes the record puts on the wire (payload + scales)."""
    return int(np.asarray(rec["d"]).nbytes + np.asarray(rec["s"]).nbytes)


def max_error_bound(rec: Dict) -> float:
    """Analytic per-element round-trip error bound of one quantization:
    max block scale / 2."""
    s = np.asarray(rec["s"], np.float32)
    return float(s.max() / 2.0) if s.size else 0.0
