"""Port of ``ray_tpu/data/iterator.py``.

DataIterator: batched consumption of a Dataset, including the card path.

Reference: python/ray/data/iterator.py (DataIterator.iter_batches /
iter_torch_batches) and _internal/execution/streaming_split coordination.
The card path is ``iter_torch_batches(device=...)``: numeric columns become
tensors and go host -> device, one batch at a time, as the consumer asks.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, BlockAccessor, format_batch


class DataIterator:
    def __init__(self, ds_or_source):
        self._source = ds_or_source

    def _iter_blocks(self) -> Iterator[Block]:
        src = self._source
        if hasattr(src, "iter_internal_blocks"):
            yield from src.iter_internal_blocks()
        else:
            yield from src()

    # ------------------------------------------------------------- rows
    def iter_rows(self) -> Iterator[Dict]:
        for block in self._iter_blocks():
            yield from BlockAccessor.iter_rows(block)

    # ------------------------------------------------------------ batches
    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: Optional[str] = "numpy",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None) -> Iterator[Any]:
        rng = np.random.default_rng(local_shuffle_seed)
        for block in _rebatch(self._iter_blocks(), batch_size, drop_last,
                              local_shuffle_buffer_size, rng):
            yield format_batch(block, batch_format)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           drop_last: bool = False, device=None,
                           dtypes=None,
                           local_shuffle_buffer_size: Optional[int] = None,
                           local_shuffle_seed: Optional[int] = None
                           ) -> Iterator[Any]:
        """Batches as dict[str, torch.Tensor] (reference:
        data/iterator.py iter_torch_batches) — numeric columns become
        tensors (optionally moved to ``device`` / cast via ``dtypes``),
        object columns stay numpy.  A read-only column (an Arrow-backed
        block's) is copied on the host first, so its tensor owns its
        memory; a writeable one passes zero-copy."""
        import torch

        rng = np.random.default_rng(local_shuffle_seed)
        for block in _rebatch(self._iter_blocks(), batch_size, drop_last,
                              local_shuffle_buffer_size, rng):
            batch = BlockAccessor.to_numpy_block(block)
            out = {}
            for k, v in batch.items():
                if v.dtype.kind == "O":
                    out[k] = v
                    continue
                if not v.flags.writeable:
                    v = np.array(v)
                t = torch.from_numpy(np.ascontiguousarray(v))
                if dtypes and k in dtypes:
                    t = t.to(dtypes[k])
                if device is not None:
                    t = t.to(device)
                out[k] = t
            yield out

    def materialize(self):
        blocks = list(self._iter_blocks())
        from ray_tpu_torch.data import from_blocks

        return from_blocks(blocks)


def _rebatch(blocks: Iterator[Block], batch_size: Optional[int],
             drop_last: bool, shuffle_buffer: Optional[int],
             rng) -> Iterator[Block]:
    """Slice/stitch a block stream into exact-size batches.

    Shuffle path: the buffer is merged + permuted once per REFILL and then
    emitted as slices — permuting the whole buffer per emitted batch would
    cost O(buffer) memcpy per batch (reference: shuffling batcher semantics).
    """
    if batch_size is None:
        yield from (b for b in blocks if BlockAccessor.num_rows(b))
        return
    buf: List[Block] = []
    buffered = 0
    min_buf = shuffle_buffer or 0
    for block in blocks:
        n = BlockAccessor.num_rows(block)
        if n == 0:
            continue
        buf.append(block)
        buffered += n
        if buffered >= batch_size + min_buf:
            merged = BlockAccessor.concat(buf)
            if shuffle_buffer:
                perm = rng.permutation(BlockAccessor.num_rows(merged))
                merged = BlockAccessor.take_idx(merged, perm)
            # emit whole batches down to the shuffle floor, keep the tail
            pos = 0
            total = BlockAccessor.num_rows(merged)
            while total - pos >= batch_size + min_buf:
                yield BlockAccessor.slice(merged, pos, pos + batch_size)
                pos += batch_size
            rest = BlockAccessor.slice(merged, pos, total)
            buf = [rest] if BlockAccessor.num_rows(rest) else []
            buffered = total - pos
    if buffered:
        merged = BlockAccessor.concat(buf)
        if shuffle_buffer:
            perm = rng.permutation(BlockAccessor.num_rows(merged))
            merged = BlockAccessor.take_idx(merged, perm)
        pos = 0
        total = BlockAccessor.num_rows(merged)
        while total - pos >= batch_size:
            yield BlockAccessor.slice(merged, pos, pos + batch_size)
            pos += batch_size
        if pos < total and not drop_last:
            yield BlockAccessor.slice(merged, pos, total)


# ===================================================== streaming split

@ray_tpu_torch.remote
class _SplitCoordinator:
    """Runs ONE streaming executor and deals its output blocks to n
    consumers (reference: StreamSplitDataIterator's SplitCoordinator actor).
    Each consumer may live in a different process (Train workers)."""

    def __init__(self, plan_blob: bytes, n: int, equal: bool):
        import cloudpickle

        self._plan = cloudpickle.loads(plan_blob)
        self._n = n
        self._equal = equal
        self._queues = [collections.deque() for _ in range(n)]
        self._rows = [0] * n
        self._delivered = [0] * n
        self._gen = None
        self._epoch = -1
        self._exhausted = False
        self._rebalanced = False

    def _ensure_epoch(self, epoch: int, split_idx: int) -> bool:
        """Returns True when the requested epoch is active.  The epoch flips
        only once the CURRENT one is fully delivered (generator exhausted and
        every queue drained) — flipping on the first request would wipe
        slower consumers' undelivered queues mid-epoch (lost/duplicated rows,
        desynced SPMD workers).  Serial consumers still work: by the time one
        asks for the next epoch serially, the previous one is complete."""
        if epoch <= self._epoch:
            return True
        if self._epoch >= 0 and not (
                self._exhausted and all(not q for q in self._queues)):
            return False  # stragglers still draining the previous epoch
        from ray_tpu_torch.data._executor import StreamingExecutor

        self._gen = StreamingExecutor(self._plan).execute()
        self._epoch = epoch
        self._exhausted = False
        self._rebalanced = False
        for q in self._queues:
            q.clear()
        self._rows = [0] * self._n
        self._delivered = [0] * self._n
        return True

    def _deal_until(self, split_idx: int, want: int):
        q = self._queues[split_idx]
        while len(q) < want and not self._exhausted:
            try:
                ref, meta = next(self._gen)
            except StopIteration:
                self._exhausted = True
                break
            # deal to the consumer with the fewest rows so far, so splits stay
            # balanced even when consumers pull at different rates
            tgt = min(range(self._n), key=lambda i: self._rows[i])
            self._queues[tgt].append((ref, meta.num_rows))
            self._rows[tgt] += meta.num_rows

    def get_next(self, split_idx: int, epoch: int):
        """Return (block_ref, num_rows), the string "wait" (epoch barrier not
        passed yet — caller retries), or None when the epoch is done."""
        if not self._ensure_epoch(epoch, split_idx):
            return "wait"
        q = self._queues[split_idx]
        # equal=True holds back one block per consumer until the stream's total
        # is known, then rebalances so every split delivers EXACTLY total//n
        # rows (reference: OutputSplitter equal=True — lockstep SPMD consumers
        # need identical batch counts or they deadlock in collectives).
        self._deal_until(split_idx, 2 if self._equal else 1)
        if self._equal and self._exhausted and not self._rebalanced:
            self._rebalance_equal()
        if not q:
            return None
        item = q.popleft()
        self._delivered[split_idx] += item[1]
        return item

    def process_facts(self) -> Dict[str, Any]:
        """The coordinator's process: its pid, whether CUDA is up in it,
        and the top-level packages it has loaded."""
        import os
        import sys

        torch = sys.modules.get("torch")
        return {"pid": os.getpid(),
                "cuda_initialized": bool(
                    torch is not None and torch.cuda.is_initialized()),
                "packages": sorted({m.split(".")[0]
                                    for m in list(sys.modules)})}

    def _rebalance_equal(self):
        """One-time end-of-stream redistribution: pool every undelivered block
        and re-deal so each consumer ends at exactly T = total_rows // n,
        slicing blocks at the boundaries (surplus rows are dropped)."""
        from ray_tpu_torch.data._executor import _slice_block

        self._rebalanced = True
        pool = collections.deque()
        for q in self._queues:
            pool.extend(q)
            q.clear()
        pool_rows = sum(r for _, r in pool)
        total = sum(self._delivered) + pool_rows
        target = max(total // self._n, max(self._delivered))
        for i in range(self._n):
            need = target - self._delivered[i]
            while need > 0 and pool:
                ref, rows = pool.popleft()
                if rows <= need:
                    self._queues[i].append((ref, rows))
                    need -= rows
                else:
                    head, _m = _slice_block.remote(ref, 0, need)
                    tail, _m2 = _slice_block.remote(ref, need, rows)
                    self._queues[i].append((head, need))
                    pool.appendleft((tail, rows - need))
                    need = 0


class _SplitIterator(DataIterator):
    def __init__(self, coord, idx: int):
        self._coord = coord
        self._idx = idx
        self._epoch = -1
        super().__init__(self._pull_blocks)

    def _pull_blocks(self):
        import time

        self._epoch += 1
        while True:
            item = ray_tpu_torch.get(
                self._coord.get_next.remote(self._idx, self._epoch))
            if item is None:
                return
            if item == "wait":  # epoch barrier: others still draining
                time.sleep(0.05)
                continue
            ref, _rows = item
            yield ray_tpu_torch.get(ref)


def build_streaming_split(ds, n: int, *, equal: bool = False):
    import cloudpickle

    coord = _SplitCoordinator.remote(cloudpickle.dumps(ds._plan), n, equal)
    return [_SplitIterator(coord, i) for i in range(n)]
