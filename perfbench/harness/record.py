"""What a loop hands back: its end-to-end numbers, the facts the per-layer
readers read, and its correctness readings beside their limits."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from perfbench.harness.trace import TraceSummary


@dataclass
class Check:
    """One number compared with the reference, and its limit: the run is
    correct where every value is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    attempted: int
    failed: int
    # end-to-end metrics by name (the untraced run's)
    metrics: Dict[str, float] = field(default_factory=dict)
    checks: List[Check] = field(default_factory=list)
    # what the per-layer readers read
    facts: Dict = field(default_factory=dict)
    trace: Optional[TraceSummary] = None
    memory_peak_bytes: int = 0
    # why the run is not correct, besides a check over its limit
    faults: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return (not self.faults and self.failed == 0
                and all(c.ok for c in self.checks))


def gap_of_norms(prog: Dict[str, float], ref: Dict[str, float],
                 keep: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between the program's and the reference's norm,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger (some leaves' norms are all but zero)."""
    names = keep if keep is not None else list(ref)
    med = sorted(ref[n] for n in names)[len(names) // 2]
    return max(abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)
