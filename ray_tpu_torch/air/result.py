"""Port of ``ray_tpu/air/result.py``.

Result of a training/tuning run (reference: python/ray/air/result.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Any] = None  # train.Checkpoint
    path: Optional[str] = None
    error: Optional[Exception] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    best_checkpoints: List[Tuple[Any, Dict[str, Any]]] = field(default_factory=list)

    @property
    def config(self) -> Optional[Dict[str, Any]]:
        return self.metrics.get("config")
