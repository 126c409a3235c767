"""The traced window: ``torch.profiler`` over the measured window, reduced to
what the per-layer metrics and the result line read.

The window is a user annotation (``bench.window``) around the measured work
and a final synchronise, so the host's and the device's events share its
clock.  Device time is the union of the device's operations (kernels,
copies, fills; not the device-side copies of host annotations, which span
whatever they enclose) inside it; an idle gap is named by the innermost host event
that was running at its middle.
"""

from __future__ import annotations

import contextlib
import re
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW = "bench.window"
# gaps attributed to what the host was doing, the longest first
ATTRIBUTED_GAPS = 1000
TOP = 10


def note(text: str) -> None:
    """A line of progress on standard error."""
    print(f"perfbench: {text}", file=sys.stderr, flush=True)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    # device operations in the window by name: [launches, seconds]
    device_ops: Dict[str, List[float]] = field(default_factory=dict)
    # idle seconds by what the host was doing, for the longest gaps
    idle_by_host: Dict[str, float] = field(default_factory=dict)
    # from the start of the window's first device operation to the end of
    # its last: the device's time for the window's work
    span_s: float = 0.0

    def seconds_matching(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for name, (_, s) in self.device_ops.items()
                   if rx.search(name))

    def breakdown(self) -> Dict[str, List[Tuple[str, float]]]:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1][1])
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[short(n), s] for n, (_, s) in ops[:TOP]],
                "idle_gaps": [[short(n), s] for n, s in gaps[:TOP]]}


def short(name: str, limit: int = 120) -> str:
    """A kernel's name without its trailing argument list, at most
    ``limit`` characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name[:limit]


class Tracer:
    """``with tracer.window(): ...`` profiles the block when ``enabled``;
    ``summary`` then holds its reduction."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.summary: Optional[TraceSummary] = None

    @contextlib.contextmanager
    def window(self):
        import torch
        from torch.autograd.profiler import record_function

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        if not self.enabled:
            yield
            sync()
            return
        prof = _profile_class()(
            use_device="cuda" if self.device.type == "cuda" else None,
            use_kineto=True)
        with prof:
            with record_function(WINDOW):
                yield
                sync()
        t0 = time.perf_counter()
        self.summary = summarize(prof.kineto_results.events())
        note(f"trace read in {time.perf_counter() - t0:.1f} s")


def _profile_class():
    import torch.autograd.profiler as autograd_profiler

    class Profile(autograd_profiler.profile):
        """The profiler, leaving its events as kineto gave them: building
        its tree of Python events would take longer than the window."""

        def _parse_kineto_results(self, result):
            return []

    return Profile


def _span(ev) -> Tuple[int, int]:
    start = ev.start_ns()
    return start, start + ev.duration_ns()


def summarize(events) -> TraceSummary:
    from torch.autograd import DeviceType

    w0 = w1 = None
    dev, host = [], []
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name == WINDOW:
                w0, w1 = _span(ev)
            else:
                host.append((name, *_span(ev)))
        else:
            dev.append((name, *_span(ev)))
    # a host annotation's device-side copy bears its name; kernels and
    # copies never bear a host event's
    host_names = {h[0] for h in host} | {WINDOW}
    dev = [d for d in dev if d[0] not in host_names]
    if w0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    ops: Dict[str, List[float]] = {}
    intervals = []
    for name, s, e in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        entry = ops.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (e - s) * 1e-9
        intervals.append((s, e))
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-9
    span = (merged[-1][1] - merged[0][0]) * 1e-9 if merged else 0.0
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    return TraceSummary((w1 - w0) * 1e-9, busy, ops,
                        _attribute(gaps, host), span)


def _attribute(gaps, host) -> Dict[str, float]:
    """Seconds of the longest idle gaps, by the innermost host event at
    each gap's middle."""
    if not gaps:
        return {}
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:ATTRIBUTED_GAPS]
    names = [h[0] for h in host]
    starts = np.array([h[1] for h in host], dtype=np.int64)
    ends = np.array([h[2] for h in host], dtype=np.int64)
    out: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) // 2
        cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if len(cover):
            inner = cover[np.argmin(ends[cover] - starts[cover])]
            name = names[inner]
        else:
            name = "(no host event)"
        out[name] = out.get(name, 0.0) + (e - s) * 1e-9
    return out
