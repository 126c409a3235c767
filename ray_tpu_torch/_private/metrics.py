"""Port of ``ray_tpu/_private/metrics.py``.

Metrics: registry + Prometheus text exposition.

Counterpart of the reference's metrics pipeline (reference: C++ opencensus
metrics src/ray/stats/metric.h + metric_defs.cc, exported to the node metrics
agent python/ray/_private/metrics_agent.py:483 and scraped by Prometheus via
the text format :595).  Condensed: every ray_tpu_torch process keeps a local
Registry; workers push theirs to the nodelet periodically; the nodelet (and
GCS) serve the merged registry over a minimal HTTP /metrics endpoint that
Prometheus scrapes directly — no separate agent process.
"""

from __future__ import annotations

import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]

_PUSH_TTL_S = 30.0  # dead workers' pushed series age out of the scrape

# Bucket boundaries for task hot-path phase timings (task_phase_seconds):
# sub-millisecond resolution at the bottom (serialize/stage run in tens of
# microseconds) up to tens of seconds for long task bodies.  One shared
# constant so driver, worker, and nodelet histograms merge into one metric.
PHASE_SECONDS_BOUNDARIES = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def _escape_label(v: str) -> str:
    # prometheus text format: backslash, quote, newline must be escaped or
    # one bad label invalidates the whole scrape document
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labelkey(labels: Optional[Dict[str, str]]) -> _LabelKey:
    return tuple(sorted((labels or {}).items()))


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 registry: Optional["Registry"] = None):
        self.name = name
        self.description = description
        self._values: Dict[_LabelKey, float] = {}
        self._lock = threading.Lock()
        existing = (registry or default_registry).register(self)
        if existing is not None:
            # Re-instantiating a metric by name (e.g. inside a task body that
            # runs repeatedly on one worker) adopts the existing series —
            # reference ray.util.metrics allows re-creation.
            self._values = existing._values
            self._lock = existing._lock

    def _set(self, labels, value):
        with self._lock:
            self._values[_labelkey(labels)] = value

    def _add(self, labels, delta):
        with self._lock:
            k = _labelkey(labels)
            self._values[k] = self._values.get(k, 0.0) + delta

    def samples(self) -> List[Tuple[_LabelKey, float]]:
        with self._lock:
            return list(self._values.items())


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        self._add(labels, value)


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
        self._set(labels, value)

    def inc(self, value: float = 1.0, labels=None) -> None:
        self._add(labels, value)

    def dec(self, value: float = 1.0, labels=None) -> None:
        self._add(labels, -value)


class Histogram(Metric):
    """Fixed-boundary histogram (prometheus-style cumulative buckets)."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (0.001, 0.01, 0.1, 1, 10, 100),
                 registry: Optional["Registry"] = None):
        self.boundaries = list(boundaries)
        self._counts: Dict[_LabelKey, List[float]] = {}
        self._sums: Dict[_LabelKey, float] = {}
        super().__init__(name, description, registry)
        reg = registry or default_registry
        existing = reg.get(name)
        if existing is not None and existing is not self \
                and isinstance(existing, Histogram):
            self._counts = existing._counts
            self._sums = existing._sums

    def observe(self, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        k = _labelkey(labels)
        with self._lock:
            counts = self._counts.setdefault(
                k, [0.0] * (len(self.boundaries) + 1))
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value

    def samples(self):
        out = []
        with self._lock:
            for k, counts in self._counts.items():
                cum = 0.0
                for b, c in zip(self.boundaries, counts):
                    cum += c
                    out.append((k + (("le", repr(b)),), cum))
                cum += counts[-1]
                out.append((k + (("le", "+Inf"),), cum))
                out.append((k + (("__stat__", "sum"),), self._sums[k]))
                out.append((k + (("__stat__", "count"),), cum))
        return out


class Registry:
    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.Lock()
        # merged snapshots pushed by other processes (worker -> nodelet);
        # value = (monotonic ts, snapshot) — evicted after _PUSH_TTL_S so dead
        # workers' series age out of the scrape
        self._pushed: Dict[str, tuple] = {}

    def register(self, metric: Metric) -> Optional[Metric]:
        """Returns the pre-existing metric of the same name (caller adopts
        its storage), or None for a first registration."""
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None and existing is not metric:
                if existing.kind != metric.kind:
                    raise ValueError(
                        f"metric {metric.name!r} already registered as "
                        f"{existing.kind}, not {metric.kind}")
                return existing
            self._metrics[metric.name] = metric
            return None

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    # ---------------------------------------------------------- export
    def snapshot(self) -> dict:
        """Wire format for pushing to an aggregator."""
        out = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            out[m.name] = {
                "kind": m.kind, "description": m.description,
                "samples": [(list(k), v) for k, v in m.samples()],
            }
        return out

    def merge_pushed(self, source: str, snapshot: dict) -> None:
        # tag every pushed sample with its source: two workers emitting the
        # same metric+labels must stay distinct series, or Prometheus rejects
        # the whole scrape as duplicates (reference Ray adds WorkerId)
        tagged = {}
        for name, rec in snapshot.items():
            tagged[name] = {
                "kind": rec["kind"], "description": rec["description"],
                "samples": [(list(k) + [["source", source]], v)
                            for k, v in rec["samples"]],
            }
        self._pushed[source] = (time.monotonic(), tagged)

    def prometheus_text(self) -> str:
        """Render local + pushed metrics in Prometheus exposition format."""
        merged: Dict[str, dict] = {}
        for name, rec in self.snapshot().items():
            merged.setdefault(name, {"kind": rec["kind"],
                                     "description": rec["description"],
                                     "samples": []})["samples"] += rec["samples"]
        cutoff = time.monotonic() - _PUSH_TTL_S
        for source in [s for s, (ts, _) in self._pushed.items() if ts < cutoff]:
            del self._pushed[source]
        for _ts, snap in self._pushed.values():
            for name, rec in snap.items():
                merged.setdefault(name, {"kind": rec["kind"],
                                         "description": rec["description"],
                                         "samples": []})["samples"] += rec["samples"]
        lines = []
        for name, rec in sorted(merged.items()):
            pname = f"ray_tpu_{name}"
            if rec["description"]:
                lines.append(f"# HELP {pname} {rec['description']}")
            kind = rec["kind"] if rec["kind"] != "untyped" else "gauge"
            lines.append(f"# TYPE {pname} {kind}")
            for labelpairs, value in rec["samples"]:
                suffix = ""
                shown = []
                for k, v in labelpairs:
                    if k == "__stat__":
                        suffix = "_" + v
                    elif k == "le":
                        suffix = "_bucket"
                        shown.append((k, v))
                    else:
                        shown.append((k, v))
                label_s = ",".join(
                    f'{k}="{_escape_label(str(v))}"' for k, v in shown)
                label_s = "{" + label_s + "}" if label_s else ""
                lines.append(f"{pname}{suffix}{label_s} {value}")
        return "\n".join(lines) + "\n"


default_registry = Registry()

# Registered names are exported as ray_tpu_<name>, so they must be bare
# Prometheus identifiers WITHOUT the prefix (a pre-prefixed name would
# export double-prefixed and every dashboard query would miss it).
METRIC_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")


def validate_registry(registry: Optional[Registry] = None) -> List[str]:
    """Metrics-hygiene walk: return a list of violations (empty = clean).
    Rules: valid bare Prometheus name, no ray_tpu_ double prefix, nonempty
    help text.  Conflicting-type duplicates cannot coexist — register()
    raises at construction — so they need no walk here."""
    reg = registry or default_registry
    with reg._lock:
        metrics = list(reg._metrics.values())
    problems = []
    for m in metrics:
        if not METRIC_NAME_RE.match(m.name):
            problems.append(f"{m.name!r}: not a valid metric name")
        if m.name.startswith("ray_tpu_"):
            problems.append(
                f"{m.name!r}: names are exported with the ray_tpu_ prefix; "
                "registering a pre-prefixed name double-prefixes the export")
        if not (m.description or "").strip():
            problems.append(f"{m.name!r}: empty help text")
    return problems


async def serve_metrics_http(registry: Registry, host: str = "127.0.0.1",
                             port: int = 0) -> Tuple[str, int]:
    """Minimal asyncio HTTP server exposing GET /metrics (Prometheus scrape
    target).  Hand-rolled on purpose: the nodelet must not depend on aiohttp."""
    import asyncio

    async def handle(reader, writer):
        try:
            request = await asyncio.wait_for(reader.readline(), timeout=10)
            while True:  # drain headers
                line = await asyncio.wait_for(reader.readline(), timeout=10)
                if line in (b"\r\n", b"\n", b""):
                    break
            if b"/metrics" in request:
                body = registry.prometheus_text().encode()
                head = (b"HTTP/1.1 200 OK\r\n"
                        b"Content-Type: text/plain; version=0.0.4\r\n"
                        b"Content-Length: " + str(len(body)).encode() +
                        b"\r\nConnection: close\r\n\r\n")
                writer.write(head + body)
            else:
                writer.write(b"HTTP/1.1 404 Not Found\r\n"
                             b"Content-Length: 0\r\nConnection: close\r\n\r\n")
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    server = await asyncio.start_server(handle, host, port)
    addr = server.sockets[0].getsockname()
    return addr[0], addr[1]
