"""LLM-engine metrics of the port, kept in process.

The same metric names and boundaries as ``ray_tpu/llm/_metrics.py``, on a
small in-process Counter / Gauge / Histogram.  Pushing them to the GCS for
the ``ray_tpu_llm_*`` scrape waits for the runtime slice of the port.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

# TTFT spans a sub-ms cache hit to a multi-second cold prefill.
TTFT_BOUNDARIES = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
# Inter-token latency is one decode step: tighter bottom end.
ITL_BOUNDARIES = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0,
)
DECODE_BATCH_BOUNDARIES = (1, 2, 4, 8, 16, 32, 64, 128, 256)

_LabelKey = Tuple[Tuple[str, str], ...]


def _key(labels: Optional[Dict[str, str]]) -> _LabelKey:
    return tuple(sorted((labels or {}).items()))


class Metric:
    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._values: Dict[_LabelKey, float] = {}
        self._lock = threading.Lock()

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._values.get(_key(labels), 0.0)


class Counter(Metric):
    def inc(self, value: float = 1.0,
            labels: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        with self._lock:
            k = _key(labels)
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(Metric):
    def set(self, value: float,
            labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_key(labels)] = value


class Histogram(Metric):
    """Fixed-boundary histogram; ``value`` reads the observation count."""

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = ()):
        super().__init__(name, description)
        self.boundaries = list(boundaries)
        self._counts: Dict[_LabelKey, List[int]] = {}
        self._sums: Dict[_LabelKey, float] = {}

    def observe(self, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        k = _key(labels)
        with self._lock:
            counts = self._counts.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._values[k] = self._values.get(k, 0.0) + 1

    def sum(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return self._sums.get(_key(labels), 0.0)


_lock = threading.Lock()
_metrics: Dict[str, Metric] = {}


def llm_metrics() -> Dict[str, Metric]:
    """The process-local LLM metric set (built once; the ``engine`` label
    keys every series, so several engines stay distinguishable)."""
    with _lock:
        if not _metrics:
            _metrics.update({
                "requests": Counter(
                    "llm_requests_total",
                    "generation requests submitted, per engine"),
                "prompt_tokens": Counter(
                    "llm_prompt_tokens_total",
                    "prompt tokens received, per engine"),
                "tokens": Counter(
                    "llm_tokens_generated_total",
                    "tokens generated (decode output), per engine"),
                "ttft": Histogram(
                    "llm_ttft_seconds",
                    "time from submit to first generated token, per engine",
                    boundaries=TTFT_BOUNDARIES),
                "itl": Histogram(
                    "llm_inter_token_seconds",
                    "latency between consecutive tokens of one request, "
                    "per engine",
                    boundaries=ITL_BOUNDARIES),
                "decode_batch": Histogram(
                    "llm_decode_batch_size",
                    "sequences advanced per decode step (continuous "
                    "batching occupancy), per engine",
                    boundaries=DECODE_BATCH_BOUNDARIES),
                "kv_util": Gauge(
                    "llm_kv_page_utilization",
                    "fraction of KV-cache pages in use, per engine"),
                "preemptions": Counter(
                    "llm_preemptions_total",
                    "requests evicted for recompute-on-resume on page "
                    "exhaustion, per engine"),
                "queue_depth": Gauge(
                    "llm_queue_depth",
                    "requests waiting for admission, per engine"),
                "running": Gauge(
                    "llm_running_requests",
                    "requests in the running decode batch, per engine"),
                "tokens_per_second": Gauge(
                    "llm_tokens_per_second",
                    "generation throughput since the first token of the "
                    "current run, per engine"),
                "prefix_hit_tokens": Counter(
                    "llm_prefix_cache_hit_tokens_total",
                    "prompt tokens adopted from the radix prefix cache "
                    "instead of prefilled, per engine"),
                "prefill_tokens": Counter(
                    "llm_prefill_tokens_total",
                    "prompt tokens actually computed by prefill "
                    "(prefix-cache misses), per engine"),
                "prefix_pages": Gauge(
                    "llm_prefix_cache_pages",
                    "KV pages currently held by the prefix-cache trie, "
                    "per engine"),
            })
        return _metrics
