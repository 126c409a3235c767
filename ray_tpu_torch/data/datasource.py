"""Port of ``ray_tpu/data/datasource.py``.

Datasources: how blocks come into (and leave) a Dataset.

Reference: python/ray/data/datasource/ — a ``Datasource`` turns into a list
of ``ReadTask``s at plan time; each ReadTask runs remotely and yields blocks.
Writes are map tasks that consume blocks and persist them.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor, BlockMetadata


class ReadTask:
    """A serializable unit of reading: call it remotely, get blocks back."""

    def __init__(self, fn: Callable[[], Iterable[Block]],
                 metadata: Optional[BlockMetadata] = None):
        self._fn = fn
        self.metadata = metadata or BlockMetadata(num_rows=-1, size_bytes=-1)

    def __call__(self) -> List[Block]:
        return list(self._fn())


class Datasource:
    """Pluggable source. Subclasses implement get_read_tasks(parallelism)."""

    def name(self) -> str:
        return type(self).__name__

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        raise NotImplementedError


class RangeDatasource(Datasource):
    def __init__(self, n: int, column: str = "id"):
        self.n, self.column = n, column

    def estimate_inmemory_data_size(self):
        return self.n * 8

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        n, p = self.n, max(1, min(parallelism, self.n or 1))
        per = (n + p - 1) // p
        for start in range(0, n, per):
            end = min(start + per, n)
            col = self.column

            def read(start=start, end=end):
                yield {col: np.arange(start, end, dtype=np.int64)}

            tasks.append(ReadTask(read, BlockMetadata(
                num_rows=end - start, size_bytes=(end - start) * 8,
                schema={col: "int64"})))
        return tasks


class ItemsDatasource(Datasource):
    def __init__(self, items: Sequence[Any]):
        self.items = list(items)

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        items = self.items
        n = len(items)
        p = max(1, min(parallelism, n or 1))
        per = (n + p - 1) // p
        tasks = []
        for start in range(0, n, per):
            chunk = items[start:start + per]

            def read(chunk=chunk):
                yield BlockAccessor.from_rows(
                    [r if isinstance(r, dict) else {"item": r} for r in chunk])

            tasks.append(ReadTask(read, BlockMetadata(
                num_rows=len(chunk), size_bytes=-1)))
        return tasks


class BlocksDatasource(Datasource):
    """Wraps already-materialized in-memory blocks (from_numpy/from_pandas)."""

    def __init__(self, blocks: List[Block]):
        self.blocks = blocks

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        tasks = []
        for b in self.blocks:
            def read(b=b):
                yield b

            tasks.append(ReadTask(read, BlockAccessor.metadata(b)))
        return tasks


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        p = os.fspath(p)
        if os.path.isdir(p):
            out.extend(sorted(
                f for f in _glob.glob(os.path.join(p, "**", "*"), recursive=True)
                if os.path.isfile(f)))
        elif any(c in p for c in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched: {paths}")
    return out


class FileDatasource(Datasource):
    """Base for per-file readers: one ReadTask per group of files."""

    def __init__(self, paths, **kwargs):
        self.paths = _expand_paths(paths)
        self.kwargs = kwargs

    def read_file(self, path: str) -> Iterable[Block]:
        raise NotImplementedError

    def get_read_tasks(self, parallelism: int) -> List[ReadTask]:
        p = max(1, min(parallelism, len(self.paths)))
        per = (len(self.paths) + p - 1) // p
        tasks = []
        for i in range(0, len(self.paths), per):
            group = self.paths[i:i + per]

            def read(group=group, self=self):
                for path in group:
                    yield from self.read_file(path)

            tasks.append(ReadTask(read, BlockMetadata(
                num_rows=-1, size_bytes=sum(os.path.getsize(f) for f in group),
                input_files=group)))
        return tasks


class CSVDatasource(FileDatasource):
    def read_file(self, path):
        # stays on pandas: pyarrow.csv infers different dtypes (e.g. date
        # columns), which would silently change existing pipelines; the
        # Arrow-native path is parquet
        import pandas as pd

        yield BlockAccessor.from_pandas(pd.read_csv(path, **self.kwargs))


class JSONDatasource(FileDatasource):
    def read_file(self, path):
        import json

        with open(path) as f:
            first = f.read(1)
            f.seek(0)
            if first == "[":
                rows = json.load(f)
            else:  # jsonl
                rows = [json.loads(line) for line in f if line.strip()]
        yield BlockAccessor.from_rows(rows)


class ParquetDatasource(FileDatasource):
    def read_file(self, path):
        import pyarrow.parquet as pq

        # stays an Arrow table: schema-carrying blocks flow through
        # map_batches(batch_format="pyarrow") / iter_batches with no pivot
        yield pq.read_table(path, **self.kwargs)


class NumpyDatasource(FileDatasource):
    def read_file(self, path):
        arr = np.load(path)
        yield {self.kwargs.get("column", "data"): arr}


class TextDatasource(FileDatasource):
    def read_file(self, path):
        with open(path, encoding=self.kwargs.get("encoding", "utf-8")) as f:
            lines = [ln.rstrip("\n") for ln in f]
        yield {"text": np.asarray(lines, dtype=object)}


class BinaryDatasource(FileDatasource):
    def read_file(self, path):
        with open(path, "rb") as f:
            data = f.read()
        col = np.empty(1, dtype=object)
        col[0] = data
        yield {"bytes": col, "path": np.asarray([path], dtype=object)}


# ---------------------------------------------------------------- writers

def write_block(block: Block, path_template: str, fmt: str, index: int,
                **kwargs) -> str:
    os.makedirs(os.path.dirname(path_template) or ".", exist_ok=True)
    path = path_template.format(i=index)
    if fmt == "parquet":
        import pyarrow.parquet as pq

        pq.write_table(BlockAccessor.to_arrow(block), path, **kwargs)
    elif fmt == "csv":
        BlockAccessor.to_pandas(block).to_csv(path, index=False, **kwargs)
    elif fmt == "json":
        BlockAccessor.to_pandas(block).to_json(
            path, orient="records", lines=True, **kwargs)
    elif fmt == "numpy":
        column = kwargs.pop("column", None)
        nb = BlockAccessor.to_numpy_block(block)
        arr = nb[column] if column else next(iter(nb.values()))
        np.save(path, arr)
    else:
        raise ValueError(f"unknown write format: {fmt}")
    return path
