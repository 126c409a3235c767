"""Port of ``ray_tpu/data/block.py``.

Columnar block model for ray_tpu_torch.data.

A *block* is the unit of data the streaming executor moves between tasks.
TWO representations are first-class (reference: python/ray/data/block.py,
_internal/arrow_block.py — blocks are pyarrow Tables or pandas frames):

- dict[str, np.ndarray] — the card hand-off layout: round-trips the
  shared-memory store zero-copy via pickle-5 buffers and feeds
  ``torch.from_numpy`` without a pivot;
- ``pyarrow.Table`` — schema-carrying columnar format; parquet reads stay
  Arrow end-to-end through map_batches(batch_format="pyarrow") and
  iter_batches(batch_format="pyarrow") with no numpy round-trip (arrow
  buffers also pickle out-of-band, so plasma transport is zero-copy too);
- ``pandas.DataFrame`` — a pandas pipeline (``from_pandas`` source or a
  map_batches(batch_format="pandas") chain returning frames) flows
  frame-native with no per-stage pivot (reference:
  python/ray/data/_internal/pandas_block.py).

``BlockAccessor`` dispatches on the representation; all-to-all ops
(sort/shuffle/groupby) pivot to numpy at their barrier, where a row pivot
happens anyway.  Non-numeric python objects live in ``dtype=object``
columns, so arbitrary rows still fit the columnar frame.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

Block = Union[Dict[str, np.ndarray], "pyarrow.Table", "pandas.DataFrame"]
Row = Dict[str, Any]


def is_arrow_block(block: Any) -> bool:
    if isinstance(block, dict):
        return False
    try:
        import pyarrow as pa

        return isinstance(block, pa.Table)
    except ImportError:
        return False


def is_pandas_block(block: Any) -> bool:
    if isinstance(block, dict):
        return False
    if "pandas" not in sys.modules:  # never import pandas just to say no
        return False
    import pandas as pd

    return isinstance(block, pd.DataFrame)


@dataclass
class BlockMetadata:
    """Sidecar stats the executor and Dataset.stats() read without fetching
    the block itself (reference: data/block.py BlockMetadata)."""

    num_rows: int
    size_bytes: int
    schema: Optional[Dict[str, str]] = None
    input_files: List[str] = field(default_factory=list)


def _column(values: List[Any]) -> np.ndarray:
    """Build one column; fall back to object dtype for ragged/non-numeric."""
    try:
        arr = np.asarray(values)
        if arr.dtype.kind in "OUSV" and not all(
                isinstance(v, (str, bytes, np.str_, np.bytes_)) for v in values):
            raise ValueError
        # np.asarray silently collapses mixed-length sequences only on
        # dtype=object; anything else is a clean column.
        return arr
    except (ValueError, TypeError):
        arr = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            arr[i] = v
        return arr


class BlockAccessor:
    """Stateless helpers over the dict-of-numpy block format."""

    # ------------------------------------------------------------ construct
    @staticmethod
    def from_rows(rows: Sequence[Row]) -> Block:
        if not rows:
            return {}
        cols: Dict[str, List[Any]] = {}
        for i, r in enumerate(rows):
            if not isinstance(r, dict):
                r = {"item": r}
            for k in r:
                if k not in cols:
                    # column appearing late: backfill
                    cols[k] = [None] * i
            for k, vals in cols.items():
                vals.append(r.get(k) if isinstance(r, dict) else None)
        return {k: _column(v) for k, v in cols.items()}

    @staticmethod
    def from_pandas(df) -> Block:
        """DataFrames ARE a block representation: pass through unchanged so
        a pandas pipeline never pays a per-stage pivot."""
        return df

    @staticmethod
    def to_pandas(block: Block):
        import pandas as pd

        if is_pandas_block(block):
            return block
        if is_arrow_block(block):
            return block.to_pandas()
        return pd.DataFrame({k: list(v) if v.ndim > 1 else v
                             for k, v in block.items()})

    @staticmethod
    def from_arrow(table) -> Dict[str, np.ndarray]:
        out = {}
        for name in table.column_names:
            col = table.column(name)
            try:
                out[name] = col.to_numpy(zero_copy_only=False)
            except Exception:
                out[name] = _column(col.to_pylist())
        return out

    @staticmethod
    def to_numpy_block(block: Block) -> Dict[str, np.ndarray]:
        """Canonical numpy view (the torch hand-off / all-to-all pivot)."""
        if is_arrow_block(block):
            return BlockAccessor.from_arrow(block)
        if is_pandas_block(block):
            return {c: block[c].to_numpy() for c in block.columns}
        return block

    @staticmethod
    def to_arrow(block: Block):
        import pyarrow as pa

        if is_arrow_block(block):
            return block
        if is_pandas_block(block):
            return pa.Table.from_pandas(block, preserve_index=False)
        return pa.table({k: (list(v) if v.ndim > 1 or v.dtype.kind == "O"
                             else v)
                         for k, v in block.items()})

    # ------------------------------------------------------------ inspect
    @staticmethod
    def num_rows(block: Block) -> int:
        if is_arrow_block(block):
            return block.num_rows
        if is_pandas_block(block):
            return len(block)
        if not block:
            return 0
        return len(next(iter(block.values())))

    @staticmethod
    def size_bytes(block: Block) -> int:
        if is_arrow_block(block):
            return block.nbytes
        if is_pandas_block(block):
            # deep=True scans every object cell (O(n) strings); sample like
            # the numpy-dict path below — metadata runs on the read path
            total = 0
            for c in block.columns:
                col = block[c]
                if col.dtype == object:
                    n = len(col)
                    head = col.iloc[:100]
                    per = sum(64 + getattr(x, "nbytes", len(repr(x)))
                              for x in head)
                    total += per * max(1, n // max(1, min(n, 100)))
                else:
                    total += int(col.memory_usage(index=False, deep=False))
            return total
        total = 0
        for v in block.values():
            if v.dtype.kind == "O":
                # rough: object columns priced per-element via repr length
                total += sum(64 + getattr(x, "nbytes", len(repr(x)))
                             for x in v[:100]) * max(1, len(v) // max(1, min(len(v), 100)))
            else:
                total += v.nbytes
        return total

    @staticmethod
    def schema(block: Block) -> Dict[str, str]:
        if is_arrow_block(block):
            return {f.name: str(f.type) for f in block.schema}
        if is_pandas_block(block):
            return {c: str(block.dtypes[c]) for c in block.columns}
        out = {}
        for k, v in block.items():
            t = "object" if v.dtype.kind == "O" else str(v.dtype)
            if v.ndim > 1:
                t += str(list(v.shape[1:]))
            out[k] = t
        return out

    @staticmethod
    def metadata(block: Block,
                 input_files: Optional[List[str]] = None) -> BlockMetadata:
        return BlockMetadata(
            num_rows=BlockAccessor.num_rows(block),
            size_bytes=BlockAccessor.size_bytes(block),
            schema=BlockAccessor.schema(block),
            input_files=input_files or [])

    # ------------------------------------------------------------ transform
    @staticmethod
    def slice(block: Block, start: int, end: int) -> Block:
        if is_arrow_block(block):
            return block.slice(start, max(end - start, 0))
        if is_pandas_block(block):
            # reset: a UDF assigning a fresh RangeIndex series to a batch
            # with index 5..9 would align-on-index into all-NaN
            return block.iloc[start:end].reset_index(drop=True)
        return {k: v[start:end] for k, v in block.items()}

    @staticmethod
    def concat(blocks: Sequence[Block]) -> Block:
        blocks = [b for b in blocks if BlockAccessor.num_rows(b) > 0]
        if not blocks:
            return {}
        if len(blocks) == 1:
            return blocks[0]
        if all(is_pandas_block(b) for b in blocks):
            import pandas as pd

            first = set(blocks[0].columns)
            for i, b in enumerate(blocks[1:], 1):
                if set(b.columns) != first:
                    # pd.concat would silently outer-join with NaN fill;
                    # loud beats silent column loss (same rule as the dict
                    # and arrow paths)
                    raise ValueError(
                        f"cannot concat blocks with mismatched columns: "
                        f"{sorted(first)} vs {sorted(b.columns)} (block {i})")
            return pd.concat(list(blocks), ignore_index=True)
        if any(is_pandas_block(b) for b in blocks):
            blocks = [BlockAccessor.to_numpy_block(b)
                      if is_pandas_block(b) else b for b in blocks]
        if all(is_arrow_block(b) for b in blocks):
            import pyarrow as pa

            first = blocks[0].schema
            aligned = [blocks[0]]
            for i, b in enumerate(blocks[1:], 1):
                if b.schema != first:
                    # same columns in a different order is fine (multi-file
                    # reads don't guarantee order); anything else is a loud
                    # error (reference: arrow_block schema unification)
                    if set(b.schema.names) == set(first.names):
                        b = b.select(first.names)
                    if b.schema != first:
                        raise ValueError(
                            f"cannot concat Arrow blocks with mismatched "
                            f"schemas:\n{first}\nvs (block {i}):\n{b.schema}")
                aligned.append(b)
            return pa.concat_tables(aligned)
        if any(is_arrow_block(b) for b in blocks):
            blocks = [BlockAccessor.to_numpy_block(b) for b in blocks]
        keys = list(blocks[0].keys())
        for i, b in enumerate(blocks[1:], 1):
            if set(b.keys()) != set(keys):
                # loud beats silent column loss (reference: Arrow unification
                # errors on incompatible schemas)
                raise ValueError(
                    f"cannot concat blocks with mismatched columns: "
                    f"{sorted(keys)} vs {sorted(b.keys())} (block {i})")
        out = {}
        for k in keys:
            cols = [b[k] for b in blocks]
            if any(c.dtype.kind == "O" for c in cols):
                merged = np.empty(sum(len(c) for c in cols), dtype=object)
                i = 0
                for c in cols:
                    merged[i:i + len(c)] = c
                    i += len(c)
                out[k] = merged
            else:
                out[k] = np.concatenate(cols, axis=0)
        return out

    @staticmethod
    def iter_rows(block: Block) -> Iterator[Row]:
        if is_arrow_block(block):
            yield from block.to_pylist()
            return
        if is_pandas_block(block):
            cols = list(block.columns)
            for tup in block.itertuples(index=False, name=None):
                yield dict(zip(cols, tup))
            return
        keys = list(block.keys())
        for i in range(BlockAccessor.num_rows(block)):
            yield {k: block[k][i] for k in keys}

    @staticmethod
    def take_idx(block: Block, idx: np.ndarray) -> Block:
        if is_arrow_block(block):
            import pyarrow as pa

            return block.take(pa.array(np.asarray(idx)))
        if is_pandas_block(block):
            return block.iloc[np.asarray(idx)].reset_index(drop=True)
        return {k: v[idx] for k, v in block.items()}

    @staticmethod
    def select(block: Block, cols: Sequence[str]) -> Block:
        if is_arrow_block(block):
            missing = [c for c in cols if c not in block.column_names]
            if missing:
                raise KeyError(f"columns not in block: {missing}; "
                               f"available: {block.column_names}")
            return block.select(list(cols))
        if is_pandas_block(block):
            missing = [c for c in cols if c not in block.columns]
            if missing:
                raise KeyError(f"columns not in block: {missing}; "
                               f"available: {list(block.columns)}")
            return block[list(cols)]
        missing = [c for c in cols if c not in block]
        if missing:
            raise KeyError(f"columns not in block: {missing}; "
                           f"available: {list(block)}")
        return {c: block[c] for c in cols}

    @staticmethod
    def drop(block: Block, cols: Sequence[str]) -> Block:
        if is_arrow_block(block):
            return block.drop_columns(
                [c for c in cols if c in block.column_names])
        if is_pandas_block(block):
            return block.drop(columns=[c for c in cols
                                       if c in block.columns])
        return {k: v for k, v in block.items() if k not in cols}

    @staticmethod
    def sort_key_array(block: Block, key: str, descending: bool = False):
        if is_arrow_block(block):
            col = block.column(key).to_numpy(zero_copy_only=False)
        elif is_pandas_block(block):
            col = block[key].to_numpy()
        else:
            col = block[key]
        order = np.argsort(col, kind="stable")
        if descending:
            order = order[::-1]
        return order

    @staticmethod
    def normalize(batch: Any, what: str = "map_batches") -> Block:
        """Coerce a user function's return value back into a block.  Arrow
        tables pass THROUGH — a pyarrow pipeline stays Arrow end-to-end."""
        if batch is None:
            return {}
        if isinstance(batch, dict):
            return {k: v if isinstance(v, np.ndarray) else _column(list(v))
                    for k, v in batch.items()}
        if is_pandas_block(batch):
            return batch  # frames pass through: pandas stays pandas
        try:
            import pyarrow as pa

            if isinstance(batch, pa.Table):
                return batch
        except ImportError:
            pass
        if isinstance(batch, list):
            return BlockAccessor.from_rows(batch)
        raise TypeError(
            f"{what} must return dict[str, np.ndarray], pandas.DataFrame, "
            f"pyarrow.Table, or list[dict]; got {type(batch)}")


def format_batch(block: Block, batch_format: Optional[str]):
    """Present a block to user code in the requested format.

    None/'default' mean dict-of-numpy — the card-first canonical layout and
    the pre-Arrow behavior, so existing numpy-style UDFs keep working on
    Arrow-sourced datasets.  Arrow stays Arrow only when asked for
    ('pyarrow'), which is what keeps a parquet pipeline pivot-free."""
    if batch_format in (None, "numpy", "native", "default"):
        return BlockAccessor.to_numpy_block(block)
    if batch_format == "pandas":
        return BlockAccessor.to_pandas(block)
    if batch_format == "pyarrow":
        return BlockAccessor.to_arrow(block)
    raise ValueError(f"unknown batch_format: {batch_format!r}")
