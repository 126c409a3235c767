"""Port of ``ray_tpu/data/_logical.py``.

Logical plan for ray_tpu_torch.data: operators, fusion, and block transforms.

Reference: python/ray/data/_internal/logical/ (operators + optimizer rules)
and _internal/planner/.  The key optimization is the same one the reference's
``OperatorFusionRule`` does: consecutive row/batch-level maps collapse into a
single remote task per block, so a ``map().filter().map_batches()`` chain
costs one task launch and zero intermediate materialization.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.data.block import Block, BlockAccessor, format_batch


@dataclass
class ComputeStrategy:
    """tasks (default) or a bounded actor pool."""

    kind: str = "tasks"  # "tasks" | "actors"
    min_size: int = 1
    max_size: int = 1


def ActorPoolStrategy(size: Optional[int] = None, *, min_size: int = 1,
                      max_size: Optional[int] = None) -> ComputeStrategy:
    if size is not None:
        min_size = max_size = size
    return ComputeStrategy("actors", min_size, max_size or max(min_size, 2))


# ------------------------------------------------------------- stage model

@dataclass
class MapStage:
    """One user transform inside a (possibly fused) map chain."""

    kind: str                      # "rows" | "batches" | "filter" | "flat"
    fn: Any                        # callable or callable *class*
    batch_size: Optional[int] = None
    batch_format: Optional[str] = None
    fn_args: tuple = ()
    fn_kwargs: dict = field(default_factory=dict)
    fn_constructor_args: tuple = ()
    fn_constructor_kwargs: dict = field(default_factory=dict)

    def instantiate(self) -> Callable:
        """Resolve a callable-class stage to a bound instance (once per
        worker/actor, so expensive setup like model loading amortizes)."""
        if isinstance(self.fn, type):
            inst = self.fn(*self.fn_constructor_args,
                           **self.fn_constructor_kwargs)
            return inst
        return self.fn


def apply_stages(stages: List[MapStage], block: Block) -> Block:
    """Run a fused chain of stages over one block (remote-side hot path)."""
    instantiated = [s.instantiate() for s in stages]
    return _apply(stages, instantiated, block)


def _apply(stages: List[MapStage], fns: List[Callable], block: Block) -> Block:
    for stage, fn in zip(stages, fns):
        n = BlockAccessor.num_rows(block)
        if stage.kind == "batches":
            bs = stage.batch_size
            pieces = []
            for start in range(0, max(n, 1), bs or max(n, 1)):
                batch = BlockAccessor.slice(block, start, min(start + (bs or n), n)) \
                    if n else block
                out = fn(format_batch(batch, stage.batch_format),
                         *stage.fn_args, **stage.fn_kwargs)
                pieces.append(BlockAccessor.normalize(out))
                if not n:
                    break
            block = BlockAccessor.concat(pieces) if pieces else {}
        elif stage.kind == "rows":
            rows = [fn(r, *stage.fn_args, **stage.fn_kwargs)
                    for r in BlockAccessor.iter_rows(block)]
            block = BlockAccessor.from_rows(rows)
        elif stage.kind == "filter":
            keep = np.fromiter(
                (bool(fn(r, *stage.fn_args, **stage.fn_kwargs))
                 for r in BlockAccessor.iter_rows(block)),
                dtype=bool, count=n)
            block = BlockAccessor.take_idx(block, np.nonzero(keep)[0])
        elif stage.kind == "flat":
            rows = []
            for r in BlockAccessor.iter_rows(block):
                rows.extend(fn(r, *stage.fn_args, **stage.fn_kwargs))
            block = BlockAccessor.from_rows(rows)
        else:
            raise ValueError(stage.kind)
    return block


# ------------------------------------------------------------ logical ops

@dataclass
class LogicalOp:
    input: Optional["LogicalOp"] = None

    def name(self) -> str:
        return type(self).__name__


@dataclass
class Read(LogicalOp):
    datasource: Any = None
    parallelism: int = -1

    def name(self):
        return f"Read{self.datasource.name()}"


@dataclass
class InputBlocks(LogicalOp):
    """Already-executed blocks (a MaterializedDataset's plan root)."""

    refs: List[Any] = field(default_factory=list)
    metas: List[Any] = field(default_factory=list)


@dataclass
class MapOp(LogicalOp):
    stages: List[MapStage] = field(default_factory=list)
    compute: ComputeStrategy = field(default_factory=ComputeStrategy)
    ray_remote_args: Dict[str, Any] = field(default_factory=dict)
    op_name: str = "Map"

    def name(self):
        return self.op_name


@dataclass
class Repartition(LogicalOp):
    num_blocks: int = 1
    shuffle: bool = False


@dataclass
class RandomShuffle(LogicalOp):
    seed: Optional[int] = None
    num_blocks: Optional[int] = None


@dataclass
class RandomizeBlockOrder(LogicalOp):
    seed: Optional[int] = None


@dataclass
class Sort(LogicalOp):
    key: str = ""
    descending: bool = False


@dataclass
class GroupByAgg(LogicalOp):
    keys: List[str] = field(default_factory=list)
    aggs: List[Any] = field(default_factory=list)   # AggregateFn list


@dataclass
class MapGroups(LogicalOp):
    keys: List[str] = field(default_factory=list)
    fn: Any = None
    batch_format: Optional[str] = None


@dataclass
class Limit(LogicalOp):
    limit: int = 0


@dataclass
class Union(LogicalOp):
    others: List[LogicalOp] = field(default_factory=list)


@dataclass
class Zip(LogicalOp):
    other: Optional[LogicalOp] = None


@dataclass
class Write(LogicalOp):
    fmt: str = ""
    path: str = ""
    write_args: Dict[str, Any] = field(default_factory=dict)


# --------------------------------------------------------------- optimizer

def _fusable(a: MapOp, b: MapOp) -> bool:
    """Two adjacent map chains fuse when they'd run on the same workers."""
    if a.compute.kind != b.compute.kind:
        return False
    if a.compute.kind == "actors":
        # different pool shapes must not merge (sizes are user-visible)
        if (a.compute.min_size, a.compute.max_size) != \
           (b.compute.min_size, b.compute.max_size):
            return False
    return a.ray_remote_args == b.ray_remote_args


def optimize(op: LogicalOp) -> LogicalOp:
    """Bottom-up fusion of consecutive MapOps (reference: OperatorFusionRule,
    python/ray/data/_internal/logical/rules/operator_fusion.py)."""
    if op is None:
        return None
    op = copy.copy(op)
    op.input = optimize(op.input)
    if isinstance(op, Union):
        op.others = [optimize(o) for o in op.others]
    if isinstance(op, Zip):
        op.other = optimize(op.other)
    if isinstance(op, MapOp) and isinstance(op.input, MapOp) \
            and _fusable(op.input, op):
        parent = op.input
        return replace(parent,
                       stages=parent.stages + op.stages,
                       op_name=f"{parent.op_name}->{op.op_name}",
                       input=parent.input)
    return op


def plan_to_list(op: LogicalOp) -> List[LogicalOp]:
    """Linear chain root-first (Union/Zip branches hang off their op)."""
    out = []
    while op is not None:
        out.append(op)
        op = op.input
    return list(reversed(out))
