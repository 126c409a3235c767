"""What a run is asked to do, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; this
module finds their files (``configs/<config>.json``,
``traffic/<traffic>.json``, ``limits/<workload>.json``) and the readers of
the cell's per-layer metrics (``metrics/<metric>.py``).  Nothing here knows
a cell, a configuration or a metric by name: a later cell comes as new files
and new entries.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict          # the configuration file, as run
    traffic: dict         # the traffic mix's parameters
    limits: dict          # the correctness limits of this cell
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    bench_dir: Path = BENCH_DIR

    def reader(self, metric: str) -> Callable:
        """``metrics/<metric>.py``'s ``read``."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _applies(metric: dict, workload: str, reported: set) -> bool:
    """A metric with ``workloads`` is this cell's where it names it.  One
    without is every cell's: an end-to-end metric's always, a per-layer
    metric's where the cell reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(workload: str, bench: Optional[dict] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``bench`` (``BENCHMARK.json`` beside the
    benchmark's folder when not given)."""
    if bench is None:
        bench = load_json(bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(bench_dir.parent / cfg_entry["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = load_json(bench_dir / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload, reported)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e,
                per_layer, bench_dir)
