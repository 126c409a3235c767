"""Port of ``ray_tpu/train/pipeline/dp_sync.py``.

Bucketed, overlapped data-parallel gradient exchange for pipeline stages.

The 3D composition (ARCHITECTURE §4d) factors a ``JaxTrainer`` gang into
``dp`` replicas × ``P`` stage gangs × ``tp``-way in-stage meshes.  Each
stage's cross-replica gradient allreduce rides the host collective stack
(``util/collective``) through this module:

- :class:`DpGradSync` packs a stage's fp32-accumulated gradient tree into
  size-capped buckets (``train_grad_bucket_bytes``) and launches one async
  allreduce per bucket the moment the last backward microbatch completes —
  the transfers overlap the remaining 1F1B drain (send_grad frames, other
  microbatches' backward on peer stages) instead of serializing after it.
- Buckets optionally quantize (``train_grad_quant="int8"``) or run under a
  straggler quorum (``train_dp_quorum=K``); the stage-0 commit-frame scalar
  allreduce (loss mean + global grad-norm square) always runs exact and
  full-participation so clipping stays bitwise replica-consistent.
- :class:`LocalReplicaGroup` is the in-process test/bench double: real
  collective Groups register a per-name RPC handler, so two ranks of one
  group cannot share a process — thread-gang tests and the ``train_3d``
  bench replicate over :class:`LocalReplicaMember` instead, which
  implements the same async-handle protocol with a deterministic
  rank-ordered reduce (and the same one-quant-stage int8 round trip).

Flag values are env-first re-read at construction (idiom of
experimental/channel.py): ``RAY_TPU_TORCH_TRAIN_GRAD_BUCKET_BYTES`` etc. override
the RayConfig value per-DpGradSync, so tests and benches can retune a
trainer mid-process.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ray_tpu_torch._private.config import RayConfig
from ray_tpu_torch.exceptions import CollectiveTimeout
from ray_tpu_torch.util.collective import collective as col
from ray_tpu_torch.util.collective.quantization import (
    dequantize_blockwise,
    quantize_blockwise,
    wire_bytes,
)

__all__ = ["DpGradSync", "LocalReplicaGroup", "LocalReplicaMember",
           "resolve_grad_sync_flags"]


def resolve_grad_sync_flags(overrides: Optional[dict] = None) -> dict:
    """Resolve the three dp grad-exchange knobs: explicit override >
    ``RAY_TPU_TORCH_*`` env (re-read now, not at first RayConfig touch) >
    RayConfig default.  Returns ``{"bucket_bytes", "quant", "quorum"}``
    with quant normalized to None-or-"int8" and quorum to None-or-int."""
    overrides = overrides or {}

    def _env_or_config(env_key: str, conf_name: str, cast):
        raw = os.environ.get(env_key)  # env re-read per construction
        return cast(raw) if raw not in (None, "") else getattr(
            RayConfig, conf_name)

    bucket = overrides.get("bucket_bytes")
    if bucket is None:
        bucket = _env_or_config("RAY_TPU_TORCH_TRAIN_GRAD_BUCKET_BYTES",
                                "train_grad_bucket_bytes", int)
    quant = overrides.get("quant")
    if quant is None:
        quant = _env_or_config("RAY_TPU_TORCH_TRAIN_GRAD_QUANT",
                               "train_grad_quant", str)
    quorum = overrides.get("quorum")
    if quorum is None:
        quorum = _env_or_config("RAY_TPU_TORCH_TRAIN_DP_QUORUM",
                                "train_dp_quorum", int)
    return {
        "bucket_bytes": int(bucket),
        "quant": quant or None,  # "" means fp32-exact
        "quorum": int(quorum) if int(quorum or 0) > 0 else None,
    }


# --------------------------------------------------------------- local double
class LocalReplicaGroup:
    """In-process dp "world" for thread-gang tests and the train_3d bench.

    A real :class:`~ray_tpu_torch.util.collective.collective.Group` registers an
    RPC handler under ``col_<name>``, so two ranks of the same group can
    never coexist in one process.  This double gives each thread-rank a
    :class:`LocalReplicaMember` whose ``allreduce_async`` matches the real
    async-handle protocol: contributions post immediately (so peers'
    waits can complete while this thread computes on), and the reduce runs
    once, in rank order, when the last contribution for an op lands —
    deterministic regardless of thread scheduling.

    ``quant="int8"`` applies the wire path's single quantize→dequantize
    round trip to every contribution (a conservative superset of the real
    ring, where a rank's own shard stays exact), and wire-byte accounting
    models the pipelined ring: each rank sends ``2*(n-1)/n`` of the payload
    (reduce-scatter + allgather halves).
    """

    def __init__(self, world_size: int):
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        self.world_size = world_size
        self._cv = threading.Condition()
        # op index -> {rank: (array, op, quant)}; results[op index] set
        # once and garbage-collected after every rank has consumed it
        self._contrib: dict = {}
        self._results: dict = {}
        self._consumed: dict = {}

    def member(self, rank: int) -> "LocalReplicaMember":
        if not 0 <= rank < self.world_size:
            raise ValueError(f"rank {rank} out of range")
        return LocalReplicaMember(self, rank)

    def _post(self, op_idx: int, rank: int, arr: np.ndarray, op: str,
              quant: Optional[str]) -> None:
        with self._cv:
            slot = self._contrib.setdefault(op_idx, {})
            if rank in slot:
                raise RuntimeError(
                    f"rank {rank} posted op {op_idx} twice (launch order "
                    f"must match across replicas)")
            slot[rank] = (np.asarray(arr), op, quant)
            self._cv.notify_all()

    def _reduce(self, op_idx: int, timeout_s: float) -> np.ndarray:
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while True:
                slot = self._contrib.get(op_idx, {})
                if op_idx in self._results:
                    return self._consume(op_idx)
                if len(slot) == self.world_size:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise CollectiveTimeout(
                        f"LocalReplicaGroup op {op_idx}: "
                        f"{self.world_size - len(slot)} of "
                        f"{self.world_size} contributions missing after "
                        f"{timeout_s}s")
                self._cv.wait(left)
            # rank-ordered reduce, computed exactly once (by whichever
            # thread arrives here first holding the lock)
            arrs = []
            op = "sum"
            for r in range(self.world_size):
                a, op, quant = slot[r]
                if quant == "int8":
                    rec, _err = quantize_blockwise(
                        np.ascontiguousarray(a),
                        block=RayConfig.collective_quant_block)
                    a = dequantize_blockwise(rec).astype(a.dtype)
                arrs.append(np.asarray(a, dtype=np.float64))
            total = arrs[0].copy()
            for a in arrs[1:]:
                total += a
            if op == "mean":
                total = total / self.world_size
            out = total.astype(slot[0][0].dtype)
            self._results[op_idx] = out
            del self._contrib[op_idx]
            self._cv.notify_all()
            return self._consume(op_idx)

    def _consume(self, op_idx: int) -> np.ndarray:
        # caller holds self._cv
        out = self._results[op_idx]
        n = self._consumed.get(op_idx, 0) + 1
        if n >= self.world_size:
            del self._results[op_idx]
            self._consumed.pop(op_idx, None)
        else:
            self._consumed[op_idx] = n
        return out


class LocalReplicaMember:
    """One thread-rank's endpoint into a :class:`LocalReplicaGroup`."""

    def __init__(self, group: LocalReplicaGroup, rank: int):
        self._group = group
        self.rank = rank
        self.world_size = group.world_size
        self._op_idx = 0

    def allreduce_async(self, array, op: str = "sum",
                        timeout_s: Optional[float] = None,
                        quant: Optional[str] = None,
                        quorum: Optional[int] = None):
        # quorum is accepted for interface parity but the local double is
        # always full-participation (no wire, no stragglers to dodge)
        del quorum
        arr = np.ascontiguousarray(np.asarray(array))
        idx = self._op_idx
        self._op_idx += 1
        self._group._post(idx, self.rank, arr, op, quant)
        return _LocalHandle(self._group, idx, arr, quant)


class _LocalHandle:
    """Async-handle protocol double (same surface as
    AsyncCollectiveHandle: wait / done / wire_bytes / op_seconds)."""

    def __init__(self, group: LocalReplicaGroup, op_idx: int,
                 arr: np.ndarray, quant: Optional[str]):
        self._group = group
        self._op_idx = op_idx
        self.op_name = "allreduce"
        self.op_seconds = 0.0
        # modeled pipelined-ring accounting: each rank ships 2*(n-1)/n of
        # the (possibly quantized) payload across RS + AG
        n = group.world_size
        if quant == "int8":
            rec, _err = quantize_blockwise(
                arr, block=RayConfig.collective_quant_block)
            payload = wire_bytes(rec)
        else:
            payload = arr.nbytes
        self.wire_bytes = int(payload * 2 * (n - 1) / n)
        self._result = None

    def done(self) -> bool:
        with self._group._cv:
            return self._op_idx in self._group._results \
                or self._result is not None

    def wait(self, timeout_s: Optional[float] = None):
        if self._result is None:
            if timeout_s is None:
                timeout_s = RayConfig.collective_default_timeout_s
            t0 = time.monotonic()
            self._result = self._group._reduce(self._op_idx, timeout_s)
            self.op_seconds = time.monotonic() - t0
        return self._result


# ------------------------------------------------------------------ dp sync
class DpGradSync:
    """Per-stage bucketed dp gradient allreduce with overlap accounting.

    Lifecycle per step (the "bucket lifecycle" of ARCHITECTURE §4d):

    1. **ready** — the stage's last backward microbatch completes; the
       fp32-accumulated grad tree is final.
    2. **launch** — :meth:`launch` flattens the tree (a dict of host
       arrays by parameter name) in its key order, packs leaves greedily
       into buckets of at
       most ``bucket_bytes`` fp32 bytes (an oversized leaf gets its own
       bucket), and fires one ``allreduce_async(op="mean")`` per bucket on
       the group's comm thread.  Control returns immediately; the wire
       work overlaps the remaining 1F1B drain.
    3. **wait-at-clip-barrier** — :meth:`wait_all` blocks at the optim op
       (the grads are needed to compute the clip norm), unpacks the
       reduced flats back into the original tree structure, and records
       wire bytes / comm seconds / blocked seconds for the step.

    ``overlap_fraction`` is measured, not inferred: it is
    ``1 - blocked/op_seconds`` where ``op_seconds`` is time the bucket ops
    actually spent executing and ``blocked`` is how long the main thread
    sat in :meth:`wait_all` — on a single-core box it reports near 0,
    on a real multi-core rig it approaches 1 as comm hides behind compute.
    """

    def __init__(self, member, *, bucket_bytes: Optional[int] = None,
                 quant: Optional[str] = None,
                 quorum: Optional[int] = None,
                 timeout_s: Optional[float] = None):
        flags = resolve_grad_sync_flags({
            "bucket_bytes": bucket_bytes, "quant": quant, "quorum": quorum})
        self.member = member
        self.bucket_bytes = flags["bucket_bytes"]
        self.quant = flags["quant"]
        quorum = flags["quorum"]
        if quorum is not None and quorum >= member.world_size:
            quorum = None  # full participation: quorum of everyone
        self.quorum = quorum
        self.timeout_s = timeout_s
        self._pending: Optional[Tuple[list, Any, list]] = None
        # per-step stats, refreshed by wait_all()
        self.last_buckets = 0
        self.last_wire_bytes = 0
        self.last_op_seconds = 0.0
        self.last_blocked_s = 0.0
        # wall-clock stamps of the last launch/clip-barrier completion, so
        # the critical-path engine can place the dp exchange on a step's
        # absolute timeline next to the stage's op intervals
        self.last_launch_ts = 0.0
        self.last_complete_ts = 0.0
        # cumulative (for bench/report aggregation)
        self.total_wire_bytes = 0
        self.total_op_seconds = 0.0
        self.total_blocked_s = 0.0

    @property
    def world_size(self) -> int:
        return self.member.world_size

    # ------------------------------------------------------------- packing
    def _pack(self, leaves: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Greedy in-order packing into fp32 concat vectors <= bucket_bytes
        (deterministic: every replica sees the identical bucket layout
        because tree flatten order is identical)."""
        cap = self.bucket_bytes if self.bucket_bytes > 0 else 0
        buckets: List[List[np.ndarray]] = []
        cur: List[np.ndarray] = []
        cur_bytes = 0
        for leaf in leaves:
            nbytes = leaf.nbytes
            if cur and (cap <= 0 or cur_bytes + nbytes > cap):
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(leaf)
            cur_bytes += nbytes
        if cur:
            buckets.append(cur)
        return [np.concatenate([p.ravel() for p in b]) if len(b) > 1
                else b[0].ravel() for b in buckets]

    def launch(self, grad_tree) -> int:
        """Flatten + bucket the accumulated grad tree and fire the async
        allreduces.  Returns the number of buckets launched."""
        if self._pending is not None:
            raise RuntimeError("DpGradSync.launch: previous step's buckets "
                               "were never waited (missing wait_all?)")
        treedef = list(grad_tree)
        leaves = [grad_tree[k] for k in treedef]
        meta = [(l.shape, np.dtype(l.dtype)) for l in leaves]
        flat32 = [np.asarray(l).astype(np.float32, copy=False)
                  for l in leaves]
        handles = []
        for vec in self._pack(flat32):
            handles.append(self.member.allreduce_async(
                vec, op="mean", timeout_s=self.timeout_s,
                quant=self.quant, quorum=self.quorum))
        self._pending = (handles, treedef, meta)
        self.last_buckets = len(handles)
        self.last_launch_ts = time.time()
        return len(handles)

    def wait_all(self, timeout_s: Optional[float] = None):
        """Clip-barrier: block on every in-flight bucket (one shared
        deadline via :func:`ray_tpu_torch.util.collective.wait_all`), unpack, and
        return the dp-mean grad tree in the original structure/dtypes."""
        if self._pending is None:
            raise RuntimeError("DpGradSync.wait_all: nothing launched")
        handles, treedef, meta = self._pending
        self._pending = None
        t0 = time.monotonic()
        flats = col.wait_all(
            handles, timeout_s=timeout_s if timeout_s is not None
            else self.timeout_s)
        blocked = time.monotonic() - t0
        wire = sum(h.wire_bytes for h in handles)
        op_s = sum(h.op_seconds for h in handles)
        self.last_wire_bytes = wire
        self.last_op_seconds = op_s
        self.last_blocked_s = blocked
        self.last_complete_ts = time.time()
        self.total_wire_bytes += wire
        self.total_op_seconds += op_s
        self.total_blocked_s += blocked
        flat = np.concatenate(flats) if len(flats) > 1 \
            else np.asarray(flats[0])
        leaves = []
        off = 0
        for shape, dtype in meta:
            n = int(np.prod(shape)) if shape else 1
            leaves.append(flat[off:off + n].reshape(shape).astype(
                dtype, copy=False))
            off += n
        return dict(zip(treedef, leaves))

    def allreduce_scalars(self, values: Sequence[float],
                          timeout_s: Optional[float] = None) -> np.ndarray:
        """Exact full-participation dp-mean of a small float64 vector —
        the one extra scalar allreduce the stage-0 commit frame folds in
        (loss mean + global grad-norm square).  Never quantized, never
        quorum'd: the commit must be identical on every replica.  Routed
        through the same async queue as the buckets so every replica's op
        order stays aligned."""
        h = self.member.allreduce_async(
            np.asarray(values, dtype=np.float64), op="mean",
            timeout_s=timeout_s if timeout_s is not None else self.timeout_s)
        out = h.wait(timeout_s=timeout_s if timeout_s is not None
                     else self.timeout_s)
        self.last_wire_bytes += h.wire_bytes
        self.total_wire_bytes += h.wire_bytes
        return np.asarray(out)

    def last_overlap_fraction(self) -> float:
        """Measured overlap of the last step's bucket exchange: the share
        of comm-op execution time the main thread did NOT spend blocked at
        the clip barrier.  0.0 when there was no comm."""
        if self.last_op_seconds <= 0:
            return 0.0
        return max(0.0, 1.0 - self.last_blocked_s / self.last_op_seconds)
