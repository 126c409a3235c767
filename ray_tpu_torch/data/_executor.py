"""Port of ``ray_tpu/data/_executor.py``.

Streaming executor: runs a logical plan as remote tasks over the runtime.

Reference: python/ray/data/_internal/execution/streaming_executor.py:48 and
operators/.  Same architecture, pull-driven instead of thread-driven: the
output iterator advances the scheduler each time the consumer asks for a
block, so a slow consumer naturally backpressures the whole pipeline (the
reference uses a scheduler thread + explicit backpressure policies; here the
bounded per-operator in-flight and output queues are the policy).

Map operators stream block->block with bounded in-flight tasks (or a bounded
actor pool for stateful transforms); all-to-all operators (shuffle, sort,
repartition, groupby) materialize their input then fan out map/reduce tasks,
exactly like the reference's push-based shuffle.
"""

from __future__ import annotations

import collections
import logging
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import _logical as L
from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata
from ray_tpu_torch.data.datasource import ReadTask, write_block

logger = logging.getLogger(__name__)

# Item flowing between operators: (block_ref, BlockMetadata)
RefBundle = Tuple[Any, BlockMetadata]


class DataContext:
    """Execution knobs (reference: data/context.py DataContext)."""

    max_tasks_in_flight_per_op = 8
    max_output_queue_blocks = 16
    target_min_block_size = 1 * 1024 * 1024
    actor_pool_util_threshold = 2  # queued-per-actor before scaling up
    # Explicit memory-budget backpressure (reference:
    # _internal/execution/backpressure_policy/ + resource_manager.py): once
    # the bytes buffered in operator output queues exceed this, no new
    # read/map tasks are admitted until the consumer drains.  The bounded
    # queues cap BLOCK counts; this caps BYTES, which is what actually
    # protects the object store when blocks are large.
    max_buffered_bytes = 512 * 1024 * 1024

    @classmethod
    def get_current(cls) -> "DataContext":
        return _ctx


_ctx = DataContext()


# ------------------------------------------------------- remote helpers

@ray_tpu_torch.remote(num_returns=2)
def _run_read_task(task: ReadTask):
    block = BlockAccessor.concat(task())
    return block, BlockAccessor.metadata(block, task.metadata.input_files)


@ray_tpu_torch.remote(num_returns=2)
def _run_stages(stages: List[L.MapStage], block: Block):
    out = L.apply_stages(stages, block)
    return out, BlockAccessor.metadata(out)


@ray_tpu_torch.remote(num_returns=2)
def _concat_blocks(*blocks):
    out = BlockAccessor.concat(list(blocks))
    return out, BlockAccessor.metadata(out)


@ray_tpu_torch.remote(num_returns=2)
def _slice_block(block: Block, start: int, end: int):
    out = BlockAccessor.slice(block, start, end)
    return out, BlockAccessor.metadata(out)


@ray_tpu_torch.remote
class _MapWorker:
    """Actor-pool worker: instantiates callable-class stages once, then maps
    every dispatched block through them (reference:
    actor_pool_map_operator.py)."""

    def __init__(self, stages: List[L.MapStage]):
        self._stages = stages
        self._fns = [s.instantiate() for s in stages]

    def run(self, block: Block):
        out = L._apply(self._stages, self._fns, block)
        return out, BlockAccessor.metadata(out)


# --------------------------------------------------------- operator states

class _OpState:
    def __init__(self, op: L.LogicalOp, name: str):
        self.op = op
        self.name = name
        self.input: collections.deque = collections.deque()
        self.output: collections.deque = collections.deque()
        self.inflight: Dict[Any, Any] = {}   # block_ref -> (seq, meta_ref, actor)
        # Reorder buffer: tasks finish in any order, but bundles must leave
        # in admission order (reference: preserve_order execution option —
        # here it's always on; repartition/take/files depend on it).
        self.seq_next = 0
        self.emit_fifo: collections.deque = collections.deque()
        self.done_results: Dict[int, Any] = {}
        self.upstream_done = False
        self.done = False
        self.rows_out = 0
        # Rows the executor has yielded to the caller from this op's output.
        # Kept separate from rows_out: Limit uses rows_out as its consumed-row
        # cap, so counting yielded bundles there again would under-emit when
        # input streams in across scheduler iterations.
        self.rows_emitted = 0
        self.tasks_launched = 0
        # Running average output-block size: the in-flight term of the byte
        # budget (seeded at the target block size until real data arrives).
        self.avg_block_bytes = DataContext.target_min_block_size
        self._blocks_seen = 0
        # actor pool
        self.pool: List[Any] = []
        self.pool_busy: Dict[Any, int] = {}

    def shutdown(self):
        for a in self.pool:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self.pool.clear()


class StreamingExecutor:
    def __init__(self, root: L.LogicalOp):
        import time as _time
        import uuid

        from ray_tpu_torch.data._metrics import data_metrics

        self.root = L.optimize(root)
        self.chain = L.plan_to_list(self.root)
        self.states = [_OpState(op, op.name()) for op in self.chain]
        self._stats: Dict[str, Dict[str, Any]] = {}
        # library metrics: short per-executor uid keeps two concurrent
        # pipelines' series distinct; operator label carries the plan index
        # so views render the chain in order
        self._id = uuid.uuid4().hex[:8]
        self._metrics = data_metrics()
        self._pipeline_labels = {"dataset": self._id}
        for i, st in enumerate(self.states):
            st.metric_labels = {"dataset": self._id,
                                "operator": f"{i}:{st.name}"}
        self._gated = False          # byte budget currently throttling reads
        self._last_buffered = 0
        self._gauge_clock = _time.monotonic
        self._last_gauge_ts = 0.0

    def _update_gauges(self, force: bool = False) -> None:
        """Refresh queue/backpressure gauges, throttled: the scheduler loop
        spins per block, but scrapes land every few seconds."""
        now = self._gauge_clock()
        if not force and now - self._last_gauge_ts < 0.2:
            return
        self._last_gauge_ts = now
        m = self._metrics
        for st in self.states:
            m["queue"].set(len(st.output), st.metric_labels)
        m["buffered_bytes"].set(self._last_buffered, self._pipeline_labels)
        m["backpressure"].set(1.0 if self._gated else 0.0,
                              self._pipeline_labels)

    # ------------------------------------------------------------ public
    def execute(self) -> Iterator[RefBundle]:
        """Yield output (block_ref, meta) bundles as they become available."""
        try:
            yield from self._run()
        finally:
            for st in self.states:
                st.shutdown()

    def stats(self) -> Dict[str, Dict[str, Any]]:
        return self._stats

    # ------------------------------------------------------------ engine
    def _run(self) -> Iterator[RefBundle]:
        states = self.states
        # Seed the source operator.
        src = states[0]
        self._seed_source(src)
        final = states[-1]
        while True:
            progressed = False
            # Schedule sinks-first so downstream demand admits upstream work.
            for i in reversed(range(len(states))):
                progressed |= self._schedule_op(i)
            self._drain_completed()
            self._propagate(states)
            self._update_gauges()
            while final.output:
                ref, meta = final.output.popleft()
                final.rows_emitted += meta.num_rows
                yield ref, meta
                progressed = True
            if final.done:
                break
            if not progressed:
                self._wait_any()
        self._gated = False
        self._update_gauges(force=True)
        for st in states:
            self._stats[st.name] = {
                "tasks": st.tasks_launched,
                "rows_out": max(st.rows_out, st.rows_emitted)}

    _BARRIER_OPS = (L.Repartition, L.RandomShuffle, L.Sort, L.GroupByAgg,
                    L.MapGroups, L.RandomizeBlockOrder, L.Zip, L.Union)

    def _buffered_bytes(self) -> int:
        """Bytes the pipeline currently holds: bundles queued in operator
        input/output deques PLUS an estimate for in-flight tasks (launched
        reads/maps land regardless of later admission decisions, so they
        must count against the budget at admission time).  Barrier ops'
        input is EXCLUDED: they materialize their whole input by design, so
        counting it would gate the source forever (livelock) without making
        the materialization any smaller."""
        total = 0
        for st in self.states:
            for item in st.output:
                total += max(item[1].size_bytes, 0)
            if not isinstance(st.op, self._BARRIER_OPS) and st.input and \
                    isinstance(st.input[0], tuple):
                # (Read ops queue ReadTasks, not (ref, meta) bundles)
                for item in st.input:
                    total += max(item[1].size_bytes, 0)
            total += len(st.inflight) * st.avg_block_bytes
        return total

    def _seed_source(self, src: _OpState):
        op = src.op
        if isinstance(op, L.Read):
            tasks = op.datasource.get_read_tasks(op.parallelism)
            for t in tasks:
                src.input.append(t)
        elif isinstance(op, L.InputBlocks):
            for ref, meta in zip(op.refs, op.metas):
                src.output.append((ref, meta))
            src.done = True
        else:
            raise TypeError(f"plan root must be Read/InputBlocks, got {op}")
        src.upstream_done = True

    # ------------------------------------------------- per-op scheduling
    def _schedule_op(self, i: int) -> bool:
        st = self.states[i]
        if st.done:
            return False
        op = st.op
        ctx = _ctx
        downstream_room = (len(st.output) < ctx.max_output_queue_blocks)
        progressed = False

        if isinstance(op, L.Read):
            # The byte budget throttles SOURCES only: bytes enter the
            # pipeline here, and downstream operators must stay free to
            # drain what is already buffered (gating them too would
            # deadlock once the budget trips).  Computed once per pass —
            # the admission burst it allows is bounded by the in-flight cap.
            # Liveness override: if NOTHING is running anywhere, admitting
            # one read is the only way the pipeline can make progress.
            base_bytes = self._buffered_bytes()
            admitted = 0
            forced = False
            if base_bytes >= ctx.max_buffered_bytes and st.input and \
                    not any(s.inflight for s in self.states):
                forced = True
            self._last_buffered = base_bytes
            self._gated = bool(st.input) and \
                base_bytes >= ctx.max_buffered_bytes and not forced
            while (st.input and downstream_room
                   and len(st.inflight) < ctx.max_tasks_in_flight_per_op
                   and (forced or base_bytes + admitted * st.avg_block_bytes
                        < ctx.max_buffered_bytes)):
                task = st.input.popleft()
                bref, mref = _run_read_task.remote(task)
                self._track(st, bref, mref)
                admitted += 1
                progressed = True
                if forced:
                    break  # liveness override admits exactly one read
                downstream_room = len(st.output) < ctx.max_output_queue_blocks
        elif isinstance(op, L.InputBlocks):
            pass
        elif isinstance(op, L.MapOp):
            if op.compute.kind == "actors":
                progressed |= self._schedule_actor_map(st, op)
            else:
                while (st.input and downstream_room
                       and len(st.inflight) < ctx.max_tasks_in_flight_per_op):
                    ref, _meta = st.input.popleft()
                    remote = _run_stages
                    if op.ray_remote_args:
                        remote = remote.options(**op.ray_remote_args)
                    bref, mref = remote.remote(op.stages, ref)
                    self._track(st, bref, mref)
                    progressed = True
        elif isinstance(op, L.Limit):
            while st.input and downstream_room:
                ref, meta = st.input.popleft()
                remaining = op.limit - st.rows_out
                if remaining <= 0:
                    st.done = True
                    break
                if meta.num_rows > remaining:
                    bref, mref = _slice_block.remote(ref, 0, remaining)
                    meta = BlockMetadata(num_rows=remaining, size_bytes=-1,
                                         schema=meta.schema)
                    st.output.append((bref, meta))
                else:
                    st.output.append((ref, meta))
                st.rows_out += meta.num_rows
                progressed = True
            if st.rows_out >= op.limit:
                st.done = True
        elif isinstance(op, self._BARRIER_OPS):
            # Barrier ops: wait for the full input, then run.
            if st.upstream_done and not st.inflight:
                bundles = list(st.input)
                st.input.clear()
                for out in self._run_all_to_all(op, bundles):
                    st.output.append(out)
                    self._metrics["blocks"].inc(1, st.metric_labels)
                    if out[1].num_rows > 0:
                        self._metrics["rows"].inc(out[1].num_rows,
                                                  st.metric_labels)
                st.done = True
                progressed = True
        elif isinstance(op, L.Write):
            while (st.input
                   and len(st.inflight) < ctx.max_tasks_in_flight_per_op):
                ref, _meta = st.input.popleft()
                idx = st.tasks_launched

                def _write(block, idx=idx, op=op):
                    path = write_block(block, op.path, op.fmt, idx,
                                       **op.write_args)
                    b = {"path": np.asarray([path], dtype=object)}
                    return b

                stages = [L.MapStage(kind="batches", fn=_write,
                                     batch_size=None)]
                bref, mref = _run_stages.remote(stages, ref)
                self._track(st, bref, mref)
                progressed = True
        else:
            raise TypeError(f"unknown operator {op}")

        if (st.upstream_done and not st.input and not st.inflight
                and not isinstance(op, (L.Read, L.InputBlocks))):
            st.done = True
        if isinstance(op, L.Read) and not st.input and not st.inflight:
            st.done = True
        return progressed

    def _schedule_actor_map(self, st: _OpState, op: L.MapOp) -> bool:
        progressed = False
        if not st.pool:
            for _ in range(op.compute.min_size):
                self._add_pool_actor(st, op)
        # scale up when the queue builds
        if (len(st.input) > _ctx.actor_pool_util_threshold * len(st.pool)
                and len(st.pool) < op.compute.max_size):
            self._add_pool_actor(st, op)
        downstream_room = len(st.output) < _ctx.max_output_queue_blocks
        while st.input and downstream_room:
            actor = min(st.pool, key=lambda a: st.pool_busy[a])
            if st.pool_busy[actor] >= 2:   # per-actor pipelining depth
                break
            ref, _meta = st.input.popleft()
            bref, mref = actor.run.options(num_returns=2).remote(ref)
            self._track(st, bref, mref, actor)
            st.pool_busy[actor] += 1
            progressed = True
        return progressed

    def _add_pool_actor(self, st: _OpState, op: L.MapOp):
        cls = _MapWorker
        if op.ray_remote_args:
            cls = cls.options(**op.ray_remote_args)
        a = cls.remote(op.stages)
        st.pool.append(a)
        st.pool_busy[a] = 0

    # ----------------------------------------------------------- plumbing
    def _track(self, st: _OpState, bref, mref, actor=None):
        seq = st.seq_next
        st.seq_next += 1
        st.emit_fifo.append(seq)
        st.inflight[bref] = (seq, mref, actor)
        st.tasks_launched += 1
        self._metrics["tasks"].inc(1, st.metric_labels)

    def _drain_completed(self):
        pending = []
        owners = {}
        for st in self.states:
            for bref in st.inflight:
                pending.append(bref)
                owners[bref] = st
        if not pending:
            return
        ready, _ = ray_tpu_torch.wait(pending, num_returns=len(pending), timeout=0)
        for bref in ready:
            st = owners[bref]
            seq, mref, actor = st.inflight.pop(bref)
            if actor is not None:
                st.pool_busy[actor] -= 1
            meta = ray_tpu_torch.get(mref)
            if meta.size_bytes > 0:
                st._blocks_seen += 1
                st.avg_block_bytes += (meta.size_bytes - st.avg_block_bytes) \
                    / st._blocks_seen
            self._metrics["blocks"].inc(1, st.metric_labels)
            if meta.num_rows > 0:
                self._metrics["rows"].inc(meta.num_rows, st.metric_labels)
            st.done_results[seq] = (bref, meta)
            while st.emit_fifo and st.emit_fifo[0] in st.done_results:
                st.output.append(st.done_results.pop(st.emit_fifo.popleft()))

    def _propagate(self, states: List[_OpState]):
        for up, down in zip(states, states[1:]):
            if down.done:
                # e.g. Limit reached: discard upstream surplus
                up.output.clear()
                continue
            while up.output:
                down.input.append(up.output.popleft())
            if up.done:
                down.upstream_done = True

    def _wait_any(self):
        pending = [bref for st in self.states for bref in st.inflight]
        if not pending:
            return
        ray_tpu_torch.wait(pending, num_returns=1, timeout=1.0)

    # -------------------------------------------------------- all-to-all
    def _run_all_to_all(self, op, bundles: List[RefBundle]) -> List[RefBundle]:
        refs = [r for r, _ in bundles]
        metas = [m for _, m in bundles]
        if isinstance(op, L.RandomizeBlockOrder):
            rng = np.random.default_rng(op.seed)
            order = rng.permutation(len(bundles))
            return [bundles[i] for i in order]
        if isinstance(op, L.Repartition):
            return _repartition(refs, metas, op.num_blocks)
        if isinstance(op, L.RandomShuffle):
            n_out = op.num_blocks or max(1, len(refs))
            return _shuffle(refs, n_out, op.seed)
        if isinstance(op, L.Sort):
            return _sort(refs, metas, op.key, op.descending)
        if isinstance(op, L.GroupByAgg):
            return _groupby_agg(refs, op.keys, op.aggs)
        if isinstance(op, L.MapGroups):
            return _map_groups(refs, op.keys, op.fn, op.batch_format)
        if isinstance(op, L.Zip):
            return _zip(refs, metas, op.other)
        if isinstance(op, L.Union):
            out = list(bundles)
            for branch in op.others:
                sub = StreamingExecutor(branch)
                out.extend(sub.execute())
            return out
        raise TypeError(op)


# ------------------------------------------------------ all-to-all kernels

def _repartition(refs, metas, n_out: int) -> List[RefBundle]:
    """Split/merge to exactly n_out blocks preserving order (reference:
    split_repartition — no shuffle)."""
    total = sum(m.num_rows for m in metas)
    per = [total // n_out + (1 if i < total % n_out else 0)
           for i in range(n_out)]
    return _repartition_to(refs, metas, per)


@ray_tpu_torch.remote
def _shuffle_map(block: Block, n_out: int, seed):
    rng = np.random.default_rng(seed)
    n = BlockAccessor.num_rows(block)
    assign = rng.integers(0, n_out, n)
    shards = [BlockAccessor.take_idx(block, np.nonzero(assign == j)[0])
              for j in range(n_out)]
    return shards[0] if n_out == 1 else tuple(shards)


def _scatter(map_fn, refs, n_out: int, extra_args_fn) -> List[List[Any]]:
    """Run map_fn per source block with num_returns=n_out so reducer j pulls
    ONLY shard j from each mapper — O(data) total transfer, not O(n_out x
    data) (reference: push-based shuffle moves each shard exactly once)."""
    per_map = []
    for i, r in enumerate(refs):
        out = map_fn.options(num_returns=n_out).remote(r, *extra_args_fn(i))
        per_map.append([out] if n_out == 1 else list(out))
    return [[m[j] for m in per_map] for j in range(n_out)]


@ray_tpu_torch.remote(num_returns=2)
def _shuffle_reduce(j: int, seed, *shards):
    block = BlockAccessor.concat(list(shards))
    # reduce-side permutation so rows from one source block don't stay adjacent
    rng = np.random.default_rng(None if seed is None else seed + j + 1)
    block = BlockAccessor.take_idx(
        block, rng.permutation(BlockAccessor.num_rows(block)))
    return block, BlockAccessor.metadata(block)


def _shuffle(refs, n_out: int, seed) -> List[RefBundle]:
    by_reducer = _scatter(
        _shuffle_map, refs, n_out,
        lambda i: (n_out, None if seed is None else seed + i))
    out = []
    for j in range(n_out):
        bref, mref = _shuffle_reduce.remote(j, seed, *by_reducer[j])
        out.append((bref, mref))
    return [(b, ray_tpu_torch.get(m)) for b, m in out]


@ray_tpu_torch.remote
def _sort_sample(block: Block, key: str):
    block = BlockAccessor.to_numpy_block(block)  # dict-indexing kernel
    col = block[key]
    k = min(len(col), 64)
    if len(col) == 0:
        return np.asarray([])
    idx = np.linspace(0, len(col) - 1, k).astype(int)
    return np.sort(col)[idx]


@ray_tpu_torch.remote
def _sort_map(block: Block, key: str, bounds):
    block = BlockAccessor.to_numpy_block(block)  # dict-indexing kernel
    col = block[key]
    order = np.argsort(col, kind="stable")
    sorted_block = BlockAccessor.take_idx(block, order)
    cuts = np.searchsorted(sorted_block[key], bounds, side="right")
    parts = []
    prev = 0
    for c in list(cuts) + [BlockAccessor.num_rows(sorted_block)]:
        parts.append(BlockAccessor.slice(sorted_block, prev, c))
        prev = c
    return parts[0] if len(parts) == 1 else tuple(parts)


@ray_tpu_torch.remote(num_returns=2)
def _sort_reduce(j: int, key: str, descending: bool, *parts):
    block = BlockAccessor.to_numpy_block(BlockAccessor.concat(list(parts)))
    order = np.argsort(block.get(key, np.asarray([])), kind="stable") \
        if block else np.asarray([], dtype=int)
    block = BlockAccessor.take_idx(block, order) if block else block
    if descending:
        block = {k: v[::-1] for k, v in block.items()}
    return block, BlockAccessor.metadata(block)


def _sort(refs, metas, key: str, descending: bool) -> List[RefBundle]:
    if not refs:
        return []
    samples = ray_tpu_torch.get([_sort_sample.remote(r, key) for r in refs])
    non_empty = [s for s in samples if len(s)]
    n_out = len(refs)
    if not non_empty:
        # every block is empty: still emit n_out (empty) parts per mapper so
        # the reduce arity matches num_returns
        bounds = np.zeros(max(n_out - 1, 0))
    else:
        allsamp = np.sort(np.concatenate(non_empty))
        idx = np.linspace(0, len(allsamp) - 1, n_out + 1).astype(int)[1:-1]
        bounds = allsamp[idx]
    by_reducer = _scatter(_sort_map, refs, n_out, lambda i: (key, bounds))
    outs = []
    for j in range(n_out):
        bref, mref = _sort_reduce.remote(j, key, descending, *by_reducer[j])
        outs.append((bref, mref))
    bundles = [(b, ray_tpu_torch.get(m)) for b, m in outs]
    if descending:
        bundles = bundles[::-1]
    return bundles


@ray_tpu_torch.remote
def _hash_partition(block: Block, keys: List[str], n_out: int):
    block = BlockAccessor.to_numpy_block(block)  # dict-indexing kernel
    n = BlockAccessor.num_rows(block)
    if n == 0:
        return block if n_out == 1 else tuple([block] * n_out)
    import hashlib

    def stable(x):
        # hash(str) is per-process randomized (PYTHONHASHSEED): partitions
        # computed in different workers MUST agree, so hash content instead.
        # Masked to uint64 range (Python hash() is signed).
        return int.from_bytes(
            hashlib.blake2b(str(x).encode(), digest_size=8).digest(),
            "little")

    mask = (1 << 64) - 1
    h = np.zeros(n, dtype=np.uint64)
    for k in keys:
        col = block[k]
        if col.dtype.kind in "OUS":
            kh = np.asarray([stable(x) for x in col], dtype=np.uint64)
        elif col.dtype.kind in "iu":
            kh = col.astype(np.int64, copy=False).view(np.uint64)
        else:
            kh = np.asarray([hash(float(x)) & mask for x in col],
                            dtype=np.uint64)
        h = h * np.uint64(1000003) + kh
    assign = (h % np.uint64(n_out)).astype(int)
    shards = [BlockAccessor.take_idx(block, np.nonzero(assign == j)[0])
              for j in range(n_out)]
    return shards[0] if n_out == 1 else tuple(shards)


@ray_tpu_torch.remote(num_returns=2)
def _agg_reduce(j: int, keys: List[str], aggs, *parts):
    from ray_tpu_torch.data.aggregate import apply_aggs_to_groups

    block = BlockAccessor.to_numpy_block(BlockAccessor.concat(list(parts)))
    out = apply_aggs_to_groups(block, keys, aggs)
    return out, BlockAccessor.metadata(out)


def _groupby_agg(refs, keys, aggs) -> List[RefBundle]:
    if not refs:
        return []
    # global aggregate (no keys) must reduce in ONE partition: empty hash
    # partitions would otherwise emit spurious init-value rows
    n_out = 1 if not keys else max(1, min(len(refs), 8))
    by_reducer = _scatter(_hash_partition, refs, n_out, lambda i: (keys, n_out))
    outs = []
    for j in range(n_out):
        bref, mref = _agg_reduce.remote(j, keys, aggs, *by_reducer[j])
        outs.append((bref, mref))
    return [(b, ray_tpu_torch.get(m)) for b, m in outs]


@ray_tpu_torch.remote(num_returns=2)
def _map_groups_reduce(j: int, keys, fn, batch_format, *parts):
    from ray_tpu_torch.data.block import format_batch

    block = BlockAccessor.to_numpy_block(BlockAccessor.concat(list(parts)))
    n = BlockAccessor.num_rows(block)
    outs = []
    if n:
        keycols = [block[k] for k in keys]
        tags = [tuple(c[i].item() if hasattr(c[i], "item") else c[i]
                      for c in keycols) for i in range(n)]
        seen = {}
        for i, t in enumerate(tags):
            seen.setdefault(t, []).append(i)
        for t, idxs in seen.items():
            grp = BlockAccessor.take_idx(block, np.asarray(idxs))
            res = fn(format_batch(grp, batch_format))
            outs.append(BlockAccessor.normalize(res, "map_groups"))
    out = BlockAccessor.concat(outs)
    return out, BlockAccessor.metadata(out)


def _map_groups(refs, keys, fn, batch_format) -> List[RefBundle]:
    if not refs:
        return []
    n_out = max(1, min(len(refs), 8))
    by_reducer = _scatter(_hash_partition, refs, n_out, lambda i: (keys, n_out))
    outs = []
    for j in range(n_out):
        bref, mref = _map_groups_reduce.remote(j, keys, fn, batch_format,
                                               *by_reducer[j])
        outs.append((bref, mref))
    return [(b, ray_tpu_torch.get(m)) for b, m in outs]


@ray_tpu_torch.remote(num_returns=2)
def _zip_blocks(a: Block, b: Block):
    a = BlockAccessor.to_numpy_block(a)
    b = BlockAccessor.to_numpy_block(b)
    dup = set(a) & set(b)
    merged = dict(a)
    for k, v in b.items():
        merged[k + "_1" if k in dup else k] = v
    return merged, BlockAccessor.metadata(merged)


def _zip(refs, metas, other_plan) -> List[RefBundle]:
    sub = StreamingExecutor(other_plan)
    other = list(sub.execute())
    total_l = sum(m.num_rows for m in metas)
    total_r = sum(m.num_rows for _, m in other)
    if total_l != total_r:
        raise ValueError(
            f"zip requires equal row counts, got {total_l} vs {total_r}")
    # realign the right side to the left side's EXACT block boundaries
    right = _repartition_to([r for r, _ in other], [m for _, m in other],
                            [m.num_rows for m in metas])
    out = []
    for (lref, _), (rref, _) in zip(zip(refs, metas), right):
        bref, mref = _zip_blocks.remote(lref, rref)
        out.append((bref, mref))
    return [(b, ray_tpu_torch.get(m)) for b, m in out]


def _repartition_to(refs, metas, sizes: List[int]) -> List[RefBundle]:
    out: List[RefBundle] = []
    src, offset = 0, 0
    for want in sizes:
        parts = []
        need = want
        while need > 0 and src < len(refs):
            avail = metas[src].num_rows - offset
            take = min(avail, need)
            parts.append(_slice_block.remote(refs[src], offset, offset + take)[0])
            offset += take
            need -= take
            if offset >= metas[src].num_rows:
                src += 1
                offset = 0
        bref, mref = _concat_blocks.remote(*parts) if parts else \
            _concat_blocks.remote()
        out.append((bref, ray_tpu_torch.get(mref)))
    return out
