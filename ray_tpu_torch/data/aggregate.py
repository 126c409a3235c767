"""Port of ``ray_tpu/data/aggregate.py``.

Aggregations for Dataset.groupby / Dataset.aggregate.

Reference: python/ray/data/aggregate.py (AggregateFn, Count/Sum/Min/Max/
Mean/Std/AbsMax...).  Each aggregation is (init, accumulate-block, merge,
finalize) so partial aggregation runs remote-side per hash partition.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor


class AggregateFn:
    def __init__(self, init: Callable[[], Any],
                 accumulate_block: Callable[[Any, Block], Any],
                 merge: Callable[[Any, Any], Any],
                 finalize: Callable[[Any], Any] = lambda a: a,
                 name: str = "agg"):
        self.init = init
        self.accumulate_block = accumulate_block
        self.merge = merge
        self.finalize = finalize
        self.name = name


def _col(block: Block, on: Optional[str]):
    if on is None:
        # first numeric column
        for k, v in block.items():
            if v.dtype.kind in "iuf":
                return v
        raise ValueError("no numeric column to aggregate on")
    return block[on]


class Count(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        super().__init__(
            init=lambda: 0,
            accumulate_block=lambda a, b: a + BlockAccessor.num_rows(b),
            merge=lambda a, b: a + b,
            name="count()")


class Sum(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        super().__init__(
            init=lambda: 0,
            accumulate_block=lambda a, b: a + _col(b, on).sum(),
            merge=lambda a, b: a + b,
            name=f"sum({on or ''})")


class Min(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        super().__init__(
            init=lambda: None,
            accumulate_block=lambda a, b: _col(b, on).min() if a is None
            else min(a, _col(b, on).min()),
            merge=lambda a, b: b if a is None else (a if b is None else min(a, b)),
            name=f"min({on or ''})")


class Max(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        super().__init__(
            init=lambda: None,
            accumulate_block=lambda a, b: _col(b, on).max() if a is None
            else max(a, _col(b, on).max()),
            merge=lambda a, b: b if a is None else (a if b is None else max(a, b)),
            name=f"max({on or ''})")


class Mean(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        super().__init__(
            init=lambda: (0.0, 0),
            accumulate_block=lambda a, b: (a[0] + _col(b, on).sum(),
                                           a[1] + len(_col(b, on))),
            merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
            finalize=lambda a: a[0] / a[1] if a[1] else None,
            name=f"mean({on or ''})")


class Std(AggregateFn):
    """Welford-style mergeable variance."""

    def __init__(self, on: Optional[str] = None, ddof: int = 1):
        def acc(a, b):
            col = _col(b, on).astype(np.float64)
            if len(col) == 0:
                return a
            chunk_mean = float(col.mean())
            chunk = (len(col), chunk_mean,
                     float(((col - chunk_mean) ** 2).sum()))
            return merge(a, chunk)

        def merge(a, b):
            n1, mean1, m21 = a
            n2, mean2, m22 = b
            if n1 == 0:
                return b
            if n2 == 0:
                return a
            delta = mean2 - mean1
            tot = n1 + n2
            return (tot, mean1 + delta * n2 / tot,
                    m21 + m22 + delta ** 2 * n1 * n2 / tot)

        super().__init__(
            init=lambda: (0, 0.0, 0.0),
            accumulate_block=acc,
            merge=merge,
            finalize=lambda a: float(np.sqrt(a[2] / (a[0] - ddof)))
            if a[0] > ddof else None,
            name=f"std({on or ''})")


class AbsMax(AggregateFn):
    def __init__(self, on: Optional[str] = None):
        super().__init__(
            init=lambda: 0,
            accumulate_block=lambda a, b: max(a, float(np.abs(_col(b, on)).max())),
            merge=lambda a, b: max(a, b),
            name=f"abs_max({on or ''})")


def apply_aggs_to_groups(block: Block, keys: List[str],
                         aggs: List[AggregateFn]) -> Block:
    """Group one (hash-partitioned) block by keys and apply every agg.
    With no keys: global aggregate -> single-row block."""
    n = BlockAccessor.num_rows(block)
    rows = []
    if not keys:
        accs = [a.init() for a in aggs]
        if n:
            accs = [a.accumulate_block(acc, block)
                    for a, acc in zip(aggs, accs)]
        rows.append({a.name: a.finalize(acc) for a, acc in zip(aggs, accs)})
    else:
        if n == 0:
            return {}
        keycols = [block[k] for k in keys]
        groups: Dict[tuple, List[int]] = {}
        for i in range(n):
            groups.setdefault(tuple(c[i] for c in keycols), []).append(i)
        for tag in sorted(groups, key=lambda t: tuple(str(x) for x in t)):
            idxs = np.asarray(groups[tag])
            sub = BlockAccessor.take_idx(block, idxs)
            row = {k: v for k, v in zip(keys, tag)}
            for a in aggs:
                row[a.name] = a.finalize(a.accumulate_block(a.init(), sub))
            rows.append(row)
    return BlockAccessor.from_rows(rows)
