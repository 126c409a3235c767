"""The program's own spans and counters in a traced window.

``ray_tpu_torch`` marks its phases in the profiler's trace as host ranges
named ``ray_tpu_torch.<name>`` (``util/tracing.device_span``: the training
step, its forward, backward and optimizer, each flash call), and counts the
work of its flash calls (``util/tracing.counters``).  This module reduces
them: for each span name, its instances, host seconds and device seconds,
and the counters' difference over the window.

A span's device seconds are the union of the device operations that
``trace.summarize`` unions into ``busy_s``, clipped to the window, whose
launch lies inside an open instance of the span, on any thread: autograd
launches the backward's kernels from its own device thread while the main
thread sits in ``train.backward``.  Spans nest, and each operation counts
in every span it lies in.

An operation's launch is the host call (CUDA runtime or driver) that shares
its correlation id and the torch operation it links to
(``linked_correlation_id``), as ``torch.autograd.profiler``'s own parser
pairs them.  The pair is needed: torch operations number their correlation
ids apart from CUPTI's, so an id alone names two events, and torch 2.11's
events do not say which kind they are.  Only launch calls link to a torch
operation; the device-side copies of host annotations link to none, and
are no operation.  A kernel launched outside every torch operation links to
none either, and counts in no span.

``trace.py`` does not call this module yet: ``TraceSummary`` has no field
for what it returns (``PERF.md``, Open questions).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np

from perfbench.harness.trace import WINDOW

PREFIX = "ray_tpu_torch."


def read_counters() -> Dict[str, int]:
    """The program's counters now, or ``{}`` where it has no
    ``counters()``."""
    try:
        from ray_tpu_torch.util.tracing import counters
    except ImportError:
        return {}
    return counters()


def counter_window(before: Mapping[str, int],
                   after: Mapping[str, int]) -> Dict[str, int]:
    """Each counter's growth between two reads: the window's work."""
    return {k: v - before.get(k, 0) for k, v in after.items()}


def _union_s(intervals: List[Tuple[int, int]]) -> float:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-9


def program_spans(events) -> Dict[str, Dict[str, float]]:
    """``{name: {"instances", "host_s", "device_s"}}`` for each program
    span that meets the window, the prefix taken off the name; ``{}`` where
    the trace holds none."""
    from torch.autograd import DeviceType

    w0 = w1 = None
    spans: Dict[str, List[Tuple[int, int]]] = {}
    # (correlation id, linked op's) -> the launching call's start
    launches: Dict[Tuple[int, int], int] = {}
    dev = []
    for ev in events:
        if ev.device_type() != DeviceType.CPU:
            dev.append(ev)
            continue
        linked = ev.linked_correlation_id()
        if linked:
            launches[(ev.correlation_id(), linked)] = ev.start_ns()
            continue
        name = ev.name()
        if name == WINDOW:
            w0 = ev.start_ns()
            w1 = w0 + ev.duration_ns()
        elif name.startswith(PREFIX):
            start = ev.start_ns()
            spans.setdefault(name[len(PREFIX):], []).append(
                (start, start + ev.duration_ns()))
    if w0 is None or not spans:
        return {}
    # each operation clipped to the window, and its launch's time
    clipped, at = [], []
    for ev in dev:
        t = launches.get((ev.correlation_id(), ev.linked_correlation_id()))
        if t is None:
            continue
        s = ev.start_ns()
        s, e = max(s, w0), min(s + ev.duration_ns(), w1)
        if e > s:
            clipped.append((s, e))
            at.append(t)
    at_ns = np.array(at, dtype=np.int64)
    out: Dict[str, Dict[str, float]] = {}
    for name, inst in spans.items():
        inst = sorted((s, e) for s, e in inst if min(e, w1) > max(s, w0))
        if not inst:
            continue
        starts = np.array([s for s, _ in inst], dtype=np.int64)
        # the latest end of the instances opened by each start: a launch at
        # t lies in an instance when the latest end up to t reaches it
        reach = np.maximum.accumulate(np.array([e for _, e in inst],
                                               dtype=np.int64))
        i = np.searchsorted(starts, at_ns, side="right") - 1
        inside = (i >= 0) & (reach[np.maximum(i, 0)] >= at_ns)
        out[name] = {
            "instances": len(inst),
            "host_s": sum(min(e, w1) - max(s, w0) for s, e in inst) * 1e-9,
            "device_s": _union_s([clipped[j]
                                  for j in np.nonzero(inside)[0]]),
        }
    return out
