"""One run of one cell, after the look for cards: the cell's loop, then its
metrics, then the result line's object."""

from __future__ import annotations

import importlib
from types import SimpleNamespace
from typing import Dict

from perfbench.harness.device import PEAKS, device_facts
from perfbench.harness.trace import Tracer


def execute(cell, seed: int, seconds: float, trace: bool, device,
            setup_started: float) -> Dict:
    """Run ``cell`` (its traffic's ``loop``, ``perfbench/loops/<loop>.py``)
    and build the result: the end-to-end metrics untraced, the per-layer
    metrics that their readers find with ``trace``."""
    loop = importlib.import_module(f"perfbench.loops.{cell.traffic['loop']}")
    tracer = Tracer(trace, device)
    out = loop.run(cell, seed, seconds, tracer, device, setup_started)
    metrics = {}
    if trace:
        view = SimpleNamespace(config=cell.config, traffic=cell.traffic,
                               trace=out.trace, facts=out.facts,
                               peaks=PEAKS)
        for m in cell.per_layer:
            value = cell.reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in out.metrics:
                metrics[m["name"]] = {"value": out.metrics[m["name"]],
                                      "unit": m["unit"]}
    dev = device_facts(device, cell.chips, out.memory_peak_bytes)
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in out.checks}
    if out.faults:
        result["checks"]["faults"] = {"value": len(out.faults), "limit": 0,
                                      "what": out.faults}
    return result
