"""Port of ``ray_tpu/llm/_metrics.py``.

LLM-engine metrics (exported as ray_tpu_llm_* on every node's /metrics
scrape; reference: vLLM's engine stats — TTFT/ITL histograms, tokens/s,
KV-cache utilization, preemptions — folded through the same
push->scrape->view pipeline the Serve/Data/Train series ride).

One lazily-built singleton set per process; the ``engine`` label keys every
series, so several engine actors on one node stay distinguishable and the
view layer sums/maxes them per engine name.
"""

from __future__ import annotations

import threading
from typing import Dict

from ray_tpu_torch._private import metrics as M

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
# Admission queue wait: sub-ms fast path through the shed deadline range.
QUEUE_WAIT_BOUNDARIES = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

_lock = threading.Lock()
_metrics: Dict[str, M.Metric] = {}


def llm_metrics() -> Dict[str, M.Metric]:
    """The process-local LLM metric set (idempotent; re-instantiation by
    name adopts existing storage)."""
    global _metrics
    if not _metrics:
        with _lock:
            if not _metrics:
                _metrics = {
                    "requests": M.Counter(
                        "llm_requests_total",
                        "generation requests submitted, per engine"),
                    "prompt_tokens": M.Counter(
                        "llm_prompt_tokens_total",
                        "prompt tokens received, per engine"),
                    "tokens": M.Counter(
                        "llm_tokens_generated_total",
                        "tokens generated (decode output), per engine"),
                    "ttft": M.Histogram(
                        "llm_ttft_seconds",
                        "time from submit to first generated token, "
                        "per engine",
                        boundaries=TTFT_BOUNDARIES),
                    "itl": M.Histogram(
                        "llm_inter_token_seconds",
                        "latency between consecutive tokens of one "
                        "request, per engine",
                        boundaries=ITL_BOUNDARIES),
                    "decode_batch": M.Histogram(
                        "llm_decode_batch_size",
                        "sequences advanced per decode step (continuous "
                        "batching occupancy), per engine",
                        boundaries=DECODE_BATCH_BOUNDARIES),
                    "kv_util": M.Gauge(
                        "llm_kv_page_utilization",
                        "fraction of KV-cache pages in use, per engine"),
                    "preemptions": M.Counter(
                        "llm_preemptions_total",
                        "requests evicted for recompute-on-resume on page "
                        "exhaustion, per engine"),
                    "queue_depth": M.Gauge(
                        "llm_queue_depth",
                        "requests waiting for admission, per engine"),
                    "running": M.Gauge(
                        "llm_running_requests",
                        "requests in the running decode batch, per engine"),
                    "tokens_per_second": M.Gauge(
                        "llm_tokens_per_second",
                        "generation throughput since the first token of "
                        "the current run, per engine"),
                    "prefix_hit_tokens": M.Counter(
                        "llm_prefix_cache_hit_tokens_total",
                        "prompt tokens adopted from the radix prefix cache "
                        "instead of prefilled, per engine"),
                    "prefill_tokens": M.Counter(
                        "llm_prefill_tokens_total",
                        "prompt tokens actually computed by prefill "
                        "(prefix-cache misses), per engine"),
                    "prefix_pages": M.Gauge(
                        "llm_prefix_cache_pages",
                        "KV pages currently held by the prefix-cache trie, "
                        "per engine"),
                    "shed": M.Counter(
                        "llm_shed_total",
                        "requests rejected by admission control, per "
                        "engine and shed reason"),
                    "queue_wait": M.Histogram(
                        "llm_queue_wait_seconds",
                        "time a request spent in the admission queue "
                        "before dispatch, per engine",
                        boundaries=QUEUE_WAIT_BOUNDARIES),
                }
    return _metrics
