"""Port of ``ray_tpu/data/dataset.py``.

Dataset: lazy, streaming, distributed data pipelines.

Reference: python/ray/data/dataset.py:139.  A Dataset is an immutable handle
on a logical plan; transformations append operators, consumption compiles the
plan (fusing map chains) and drives the streaming executor over the actor/
task runtime.  Blocks are dict-of-numpy (see block.py) — the layout that
feeds ``torch.from_numpy`` directly, which is the point: the terminal
consumer on this stack is a training loop on the card.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import _logical as L
from ray_tpu_torch.data._executor import StreamingExecutor, RefBundle
from ray_tpu_torch.data.aggregate import (AbsMax, AggregateFn, Count, Max, Mean,
                                    Min, Std, Sum)
from ray_tpu_torch.data.block import Block, BlockAccessor, format_batch
from ray_tpu_torch.data.iterator import DataIterator


class Dataset:
    def __init__(self, plan: L.LogicalOp):
        self._plan = plan

    # ===================================================== transformations
    def _map_op(self, stage: L.MapStage, name: str,
                compute: Optional[L.ComputeStrategy] = None,
                **ray_remote_args) -> "Dataset":
        return Dataset(L.MapOp(
            input=self._plan, stages=[stage],
            compute=compute or L.ComputeStrategy(),
            ray_remote_args=ray_remote_args, op_name=name))

    def map(self, fn: Callable, *, compute=None, fn_args=(), fn_kwargs=None,
            **ray_remote_args) -> "Dataset":
        return self._map_op(
            L.MapStage(kind="rows", fn=fn, fn_args=tuple(fn_args),
                       fn_kwargs=fn_kwargs or {}),
            f"Map({getattr(fn, '__name__', 'fn')})", compute,
            **ray_remote_args)

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = None,
                    batch_format: Optional[str] = None, compute=None,
                    fn_args=(), fn_kwargs=None, fn_constructor_args=(),
                    fn_constructor_kwargs=None, concurrency=None,
                    **ray_remote_args) -> "Dataset":
        if concurrency is not None and compute is None:
            if isinstance(concurrency, tuple):
                compute = L.ActorPoolStrategy(min_size=concurrency[0],
                                              max_size=concurrency[1])
            elif isinstance(fn, type):
                compute = L.ActorPoolStrategy(size=concurrency)
        stage = L.MapStage(
            kind="batches", fn=fn, batch_size=batch_size,
            batch_format=batch_format, fn_args=tuple(fn_args),
            fn_kwargs=fn_kwargs or {},
            fn_constructor_args=tuple(fn_constructor_args),
            fn_constructor_kwargs=fn_constructor_kwargs or {})
        return self._map_op(
            stage, f"MapBatches({getattr(fn, '__name__', 'fn')})", compute,
            **ray_remote_args)

    def flat_map(self, fn: Callable, *, compute=None,
                 **ray_remote_args) -> "Dataset":
        return self._map_op(L.MapStage(kind="flat", fn=fn),
                            f"FlatMap({getattr(fn, '__name__', 'fn')})",
                            compute, **ray_remote_args)

    def filter(self, fn: Callable, *, compute=None,
               **ray_remote_args) -> "Dataset":
        return self._map_op(L.MapStage(kind="filter", fn=fn),
                            f"Filter({getattr(fn, '__name__', 'fn')})",
                            compute, **ray_remote_args)

    def add_column(self, col: str, fn: Callable[[Block], np.ndarray],
                   **ray_remote_args) -> "Dataset":
        def add(batch):
            batch = dict(batch)
            batch[col] = np.asarray(fn(batch))
            return batch

        return self._map_op(L.MapStage(kind="batches", fn=add),
                            f"AddColumn({col})", None, **ray_remote_args)

    def drop_columns(self, cols: List[str], **ray_remote_args) -> "Dataset":
        return self._map_op(
            L.MapStage(kind="batches",
                       fn=lambda b: BlockAccessor.drop(b, cols)),
            f"DropColumns({cols})", None, **ray_remote_args)

    def select_columns(self, cols: List[str], **ray_remote_args) -> "Dataset":
        return self._map_op(
            L.MapStage(kind="batches",
                       fn=lambda b: BlockAccessor.select(b, cols)),
            f"SelectColumns({cols})", None, **ray_remote_args)

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        return self._map_op(
            L.MapStage(kind="batches",
                       fn=lambda b: {mapping.get(k, k): v
                                     for k, v in b.items()}),
            f"RenameColumns", None)

    def random_sample(self, fraction: float,
                      seed: Optional[int] = None) -> "Dataset":
        def sample(b):
            n = BlockAccessor.num_rows(b)
            if seed is None:
                rng = np.random.default_rng()
            else:
                # Per-block stream derived from the block CONTENTS: a fixed
                # seed in every map task would draw the identical mask per
                # block (position-correlated, biased sample).  Content-derived
                # entropy keeps seeded runs reproducible on the same data.
                import hashlib

                h = hashlib.blake2b(digest_size=8)
                for k in sorted(b):
                    col = b[k][: min(n, 64)]
                    h.update(col.tobytes() if col.dtype.kind != "O"
                             else repr(col.tolist()).encode())
                rng = np.random.default_rng(
                    [seed, int.from_bytes(h.digest(), "little")])
            keep = rng.random(n) < fraction
            return BlockAccessor.take_idx(b, np.nonzero(keep)[0])

        return self._map_op(L.MapStage(kind="batches", fn=sample),
                            "RandomSample", None)

    # --------------------------------------------------------- all-to-all
    def repartition(self, num_blocks: int, *, shuffle: bool = False) -> "Dataset":
        if shuffle:
            return Dataset(L.RandomShuffle(input=self._plan,
                                           num_blocks=num_blocks))
        return Dataset(L.Repartition(input=self._plan, num_blocks=num_blocks))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        return Dataset(L.RandomShuffle(input=self._plan, seed=seed))

    def randomize_block_order(self, *, seed: Optional[int] = None) -> "Dataset":
        return Dataset(L.RandomizeBlockOrder(input=self._plan, seed=seed))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return Dataset(L.Sort(input=self._plan, key=key,
                              descending=descending))

    def groupby(self, key: Union[str, List[str]]) -> "GroupedData":
        keys = [key] if isinstance(key, str) else list(key)
        return GroupedData(self, keys)

    def limit(self, limit: int) -> "Dataset":
        return Dataset(L.Limit(input=self._plan, limit=limit))

    def union(self, *others: "Dataset") -> "Dataset":
        return Dataset(L.Union(input=self._plan,
                               others=[o._plan for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return Dataset(L.Zip(input=self._plan, other=other._plan))

    # ========================================================= aggregates
    def aggregate(self, *aggs: AggregateFn):
        rows = Dataset(L.GroupByAgg(input=self._plan, keys=[],
                                    aggs=list(aggs))).take_all()
        merged: Dict[str, Any] = {}
        for r in rows:
            merged.update(r)
        if len(aggs) == 1:
            return merged.get(aggs[0].name)
        return merged

    def sum(self, on: Optional[str] = None):
        return self.aggregate(Sum(on))

    def min(self, on: Optional[str] = None):
        return self.aggregate(Min(on))

    def max(self, on: Optional[str] = None):
        return self.aggregate(Max(on))

    def mean(self, on: Optional[str] = None):
        return self.aggregate(Mean(on))

    def std(self, on: Optional[str] = None, ddof: int = 1):
        return self.aggregate(Std(on, ddof))

    def unique(self, column: str) -> List[Any]:
        vals = set()
        for batch in self.select_columns([column]).iter_batches():
            vals.update(batch[column].tolist())
        return sorted(vals, key=lambda x: (str(type(x)), x))

    # ======================================================== consumption
    def iter_bundles(self) -> Iterator[RefBundle]:
        ex = StreamingExecutor(self._plan)
        # exposed for stats/backpressure introspection (reference:
        # Dataset.stats() reads the last executor's metrics)
        self._last_executor = ex
        yield from ex.execute()

    def iter_internal_blocks(self) -> Iterator[Block]:
        for ref, _meta in self.iter_bundles():
            yield ray_tpu_torch.get(ref)

    def iterator(self) -> DataIterator:
        return DataIterator(self)

    def iter_rows(self, *, prefetch_blocks: int = 1) -> Iterator[Dict]:
        return self.iterator().iter_rows()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: Optional[str] = "numpy",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None) -> Iterator[Any]:
        return self.iterator().iter_batches(
            batch_size=batch_size, batch_format=batch_format,
            drop_last=drop_last,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            local_shuffle_seed=local_shuffle_seed)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           drop_last: bool = False, device=None, dtypes=None,
                           local_shuffle_buffer_size: Optional[int] = None,
                           local_shuffle_seed: Optional[int] = None
                           ) -> Iterator[Any]:
        return self.iterator().iter_torch_batches(
            batch_size=batch_size, drop_last=drop_last, device=device,
            dtypes=dtypes,
            local_shuffle_buffer_size=local_shuffle_buffer_size,
            local_shuffle_seed=local_shuffle_seed)

    def take(self, limit: int = 20) -> List[Dict]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= limit:
                break
        return out

    def take_all(self, limit: Optional[int] = None) -> List[Dict]:
        out = list(self.iter_rows())
        if limit is not None and len(out) > limit:
            raise ValueError(f"dataset has more than {limit} rows")
        return out

    def take_batch(self, batch_size: int = 20,
                   batch_format: Optional[str] = "numpy"):
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format=batch_format):
            return batch
        return {}

    def show(self, limit: int = 20) -> None:
        for row in self.take(limit):
            print(row)

    def count(self) -> int:
        # fast path: no map/filter ops -> sum block metadata
        return sum(meta.num_rows for _, meta in self.iter_bundles())

    def schema(self) -> Optional[Dict[str, str]]:
        for _, meta in self.iter_bundles():
            if meta.schema is not None:
                return meta.schema
        return None

    def columns(self) -> Optional[List[str]]:
        s = self.schema()
        return list(s) if s else None

    def num_blocks(self) -> int:
        return sum(1 for _ in self.iter_bundles())

    def size_bytes(self) -> int:
        return sum(max(meta.size_bytes, 0) for _, meta in self.iter_bundles())

    def input_files(self) -> List[str]:
        files: List[str] = []
        for _, meta in self.iter_bundles():
            files.extend(meta.input_files)
        return sorted(set(files))

    def stats(self) -> str:
        ex = StreamingExecutor(self._plan)
        for _ in ex.execute():
            pass
        lines = [f"{name}: {info}" for name, info in ex.stats().items()]
        return "\n".join(lines)

    # ========================================================== persist
    def materialize(self) -> "MaterializedDataset":
        refs, metas = [], []
        for ref, meta in self.iter_bundles():
            refs.append(ref)
            metas.append(meta)
        return MaterializedDataset(L.InputBlocks(refs=refs, metas=metas))

    def to_pandas(self, limit: Optional[int] = None):
        import pandas as pd

        frames = []
        n = 0
        for block in self.iter_internal_blocks():
            frames.append(BlockAccessor.to_pandas(block))
            n += len(frames[-1])
            if limit is not None and n >= limit:
                break
        if not frames:
            return pd.DataFrame()
        df = pd.concat(frames, ignore_index=True)
        return df.head(limit) if limit is not None else df

    def to_numpy_refs(self) -> List[Any]:
        return [ref for ref, _ in self.iter_bundles()]

    def write_parquet(self, path: str, **kwargs) -> None:
        self._write("parquet", path, "part-{i:05d}.parquet", **kwargs)

    def write_csv(self, path: str, **kwargs) -> None:
        self._write("csv", path, "part-{i:05d}.csv", **kwargs)

    def write_json(self, path: str, **kwargs) -> None:
        self._write("json", path, "part-{i:05d}.json", **kwargs)

    def write_numpy(self, path: str, column: Optional[str] = None, **kwargs):
        self._write("numpy", path, "part-{i:05d}.npy", column=column, **kwargs)

    def _write(self, fmt: str, path: str, template: str, **kwargs) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        plan = L.Write(input=self._plan, fmt=fmt,
                       path=os.path.join(path, template), write_args=kwargs)
        for _ in StreamingExecutor(plan).execute():
            pass

    # ============================================================ splits
    def split(self, n: int, *, equal: bool = False) -> List["MaterializedDataset"]:
        mat = self.materialize()
        bundles = list(zip(mat._plan.refs, mat._plan.metas))
        total = sum(m.num_rows for _, m in bundles)
        if equal:
            per = total // n
            sizes = [per] * n
        else:
            sizes = [total // n + (1 if i < total % n else 0)
                     for i in range(n)]
        from ray_tpu_torch.data._executor import _repartition_to

        refs = [r for r, _ in bundles]
        metas = [m for _, m in bundles]
        pieces = _repartition_to(refs, metas, sizes)
        return [MaterializedDataset(L.InputBlocks(refs=[r], metas=[m]))
                for r, m in pieces]

    def split_at_indices(self, indices: List[int]) -> List["MaterializedDataset"]:
        mat = self.materialize()
        total = sum(m.num_rows for m in mat._plan.metas)
        bounds = [0] + list(indices) + [total]
        sizes = [max(0, b - a) for a, b in zip(bounds, bounds[1:])]
        from ray_tpu_torch.data._executor import _repartition_to

        pieces = _repartition_to(mat._plan.refs, mat._plan.metas, sizes)
        return [MaterializedDataset(L.InputBlocks(refs=[r], metas=[m]))
                for r, m in pieces]

    def split_proportionately(self, proportions: List[float]) -> List["MaterializedDataset"]:
        if not proportions or any(p <= 0 for p in proportions) \
                or sum(proportions) >= 1:
            raise ValueError("proportions must be positive and sum to < 1")
        total = self.count()
        idx, acc = [], 0.0
        for p in proportions:
            acc += p
            idx.append(int(total * acc))
        return self.split_at_indices(idx)

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed: Optional[int] = None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        train, test = ds.split_proportionately([1 - test_size])
        return train, test

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None) -> List[DataIterator]:
        """n coordinated iterators over one shared executor (reference:
        Dataset.streaming_split / StreamSplitDataIterator).  equal=True
        delivers exactly total//n rows to every iterator (lockstep SPMD
        consumers).  locality_hints is accepted for API compatibility; block
        placement is owner-local here, so it has no effect."""
        from ray_tpu_torch.data.iterator import build_streaming_split

        return build_streaming_split(self, n, equal=equal)

    def __repr__(self):
        names = [op.name() for op in L.plan_to_list(self._plan)]
        return f"Dataset(plan={' -> '.join(names)})"


class MaterializedDataset(Dataset):
    """A Dataset whose blocks are already computed and held by refs."""

    @property
    def _refs(self):
        return self._plan.refs


class GroupedData:
    """Reference: python/ray/data/grouped_data.py."""

    def __init__(self, ds: Dataset, keys: List[str]):
        self._ds = ds
        self._keys = keys

    def aggregate(self, *aggs: AggregateFn) -> Dataset:
        return Dataset(L.GroupByAgg(input=self._ds._plan, keys=self._keys,
                                    aggs=list(aggs)))

    def count(self) -> Dataset:
        return self.aggregate(Count())

    def sum(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(Sum(on))

    def min(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(Min(on))

    def max(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(Max(on))

    def mean(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(Mean(on))

    def std(self, on: Optional[str] = None, ddof: int = 1) -> Dataset:
        return self.aggregate(Std(on, ddof))

    def map_groups(self, fn: Callable, *,
                   batch_format: Optional[str] = "numpy") -> Dataset:
        return Dataset(L.MapGroups(input=self._ds._plan, keys=self._keys,
                                   fn=fn, batch_format=batch_format))
