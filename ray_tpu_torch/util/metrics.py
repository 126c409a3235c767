"""Port of ``ray_tpu/util/metrics.py``.

User-facing metrics API (reference: python/ray/util/metrics.py —
Metric :23, Counter :163, Gauge :236, Histogram :297).

Metrics created here live in the process-local registry
(`ray_tpu_torch._private.metrics.default_registry`).  Every driver and worker
pushes its registry snapshot to its nodelet periodically
(`CoreWorker._push_metrics_loop`), and the nodelet's HTTP ``/metrics``
endpoint serves the merged node view to Prometheus — so a Counter
incremented inside a remote task or actor shows up on the cluster scrape
within one push interval, tagged with a ``source`` label identifying the
emitting process.  Exported names carry the ``ray_tpu_`` prefix
automatically: a counter named ``my_requests`` scrapes as
``ray_tpu_my_requests``.

Usage (inside or outside a task/actor)::

    from ray_tpu_torch.util import metrics

    hits = metrics.Counter("cache_hits", "cache hits served",
                           tag_keys=("shard",))
    hits.inc(1, tags={"shard": "eu"})

Like the reference, declaring ``tag_keys`` makes tagging strict: every
record must resolve a value for each declared key (from ``tags`` or
``set_default_tags``), and undeclared keys are rejected.  Without
``tag_keys`` the metric accepts ad-hoc tag dicts.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from ray_tpu_torch._private import metrics as _m

__all__ = ["Metric", "Counter", "Gauge", "Histogram"]


def _validate_name(name: str) -> str:
    if not isinstance(name, str) or not _m.METRIC_NAME_RE.match(name):
        raise ValueError(
            f"invalid metric name {name!r}: expected a Prometheus "
            "identifier ([a-zA-Z_][a-zA-Z0-9_]*)")
    if name.startswith("ray_tpu_"):
        raise ValueError(
            f"metric name {name!r} must not carry the ray_tpu_ prefix; "
            "it is added automatically at export time")
    return name


def _validate_tag_keys(tag_keys) -> Tuple[str, ...]:
    if tag_keys is None:
        return ()
    if isinstance(tag_keys, str) or not all(
            isinstance(k, str) for k in tag_keys):
        raise TypeError("tag_keys must be a tuple/list of strings")
    return tuple(tag_keys)


class Metric:
    """Common tag handling; subclasses bind the registry-backed storage."""

    _inner: _m.Metric

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        self._name = _validate_name(name)
        self._description = description
        self._tag_keys = _validate_tag_keys(tag_keys)
        self._default_tags: Dict[str, str] = {}

    def set_default_tags(self, default_tags: Dict[str, str]) -> "Metric":
        """Tag values merged under every record (reference:
        metrics.py Metric.set_default_tags); returns self for chaining."""
        for k, v in default_tags.items():
            if self._tag_keys and k not in self._tag_keys:
                raise ValueError(
                    f"default tag {k!r} is not in tag_keys {self._tag_keys}")
            if not isinstance(v, str):
                raise TypeError(f"tag value for {k!r} must be a str")
        self._default_tags = dict(default_tags)
        return self

    @property
    def info(self) -> Dict[str, object]:
        return {
            "name": self._name,
            "description": self._description,
            "tag_keys": self._tag_keys,
            "default_tags": dict(self._default_tags),
        }

    def _merged(self, tags: Optional[Dict[str, str]]) -> Optional[Dict[str, str]]:
        if not tags and not self._default_tags:
            if self._tag_keys:
                raise ValueError(
                    f"metric {self._name!r} declares tag_keys "
                    f"{self._tag_keys} but no tags were provided")
            return None
        merged = dict(self._default_tags)
        merged.update(tags or {})
        if self._tag_keys:
            unknown = set(merged) - set(self._tag_keys)
            if unknown:
                raise ValueError(
                    f"unknown tag keys {sorted(unknown)} for metric "
                    f"{self._name!r} (declared: {self._tag_keys})")
            missing = set(self._tag_keys) - set(merged)
            if missing:
                raise ValueError(
                    f"missing values for declared tag keys "
                    f"{sorted(missing)} on metric {self._name!r}")
        return merged

    def __repr__(self):
        return f"{type(self).__name__}({self._name!r})"


class Counter(Metric):
    """Monotonically increasing counter (reference: metrics.py:163)."""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        self._inner = _m.Counter(name, description)

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value <= 0:
            raise ValueError("Counter.inc value must be positive")
        self._inner.inc(value, self._merged(tags))


class Gauge(Metric):
    """Point-in-time value that can move both ways (reference:
    metrics.py:236)."""

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        self._inner = _m.Gauge(name, description)

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        self._inner.set(float(value), self._merged(tags))

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        self._inner.inc(float(value), self._merged(tags))

    def dec(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        self._inner.dec(float(value), self._merged(tags))


class Histogram(Metric):
    """Fixed-boundary distribution (reference: metrics.py:297; exported as
    Prometheus cumulative buckets + _sum/_count)."""

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        if boundaries is not None:
            bl = list(boundaries)
            if not bl or any(b <= 0 for b in bl) or \
                    any(a >= b for a, b in zip(bl, bl[1:])):
                raise ValueError(
                    "boundaries must be a nonempty strictly-increasing "
                    f"sequence of positive numbers, got {boundaries!r}")
            self._inner = _m.Histogram(name, description, boundaries=bl)
        else:
            self._inner = _m.Histogram(name, description)

    @property
    def boundaries(self):
        return list(self._inner.boundaries)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        self._inner.observe(float(value), self._merged(tags))
