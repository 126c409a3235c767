"""Port of ``ray_tpu/serve/_metrics.py``.

Serve library metrics (reference: the ray_serve_* series emitted by
serve/_private/replica.py, proxy.py and autoscaling_state.py; exported here
as ray_tpu_serve_* on every node's /metrics scrape).

One lazily-built singleton set per process: replicas, the proxy and the
controller each record into their own process-local registry, their
CoreWorker pushes snapshots to the nodelet, and the per-node scrape merges
them (distinct ``source`` labels keep per-replica series apart; the view
layer in `_private/metrics_view.py` sums them back per deployment).
"""

from __future__ import annotations

import threading
from typing import Dict

from ray_tpu_torch._private import metrics as M

# Request latencies: sub-ms cache hits up to multi-second model generations.
REQUEST_LATENCY_BOUNDARIES = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_lock = threading.Lock()
_metrics: Dict[str, M.Metric] = {}


def serve_metrics() -> Dict[str, M.Metric]:
    """The process-local Serve metric set (idempotent; re-instantiation by
    name adopts existing storage, so the lock only avoids wasted work)."""
    global _metrics
    if not _metrics:
        with _lock:
            if not _metrics:
                _metrics = {
                    "requests": M.Counter(
                        "serve_request_total",
                        "requests handled, per app/deployment"),
                    "request_errors": M.Counter(
                        "serve_request_error_total",
                        "requests that raised, per app/deployment"),
                    "latency": M.Histogram(
                        "serve_request_latency_seconds",
                        "replica-side request latency, per app/deployment",
                        boundaries=REQUEST_LATENCY_BOUNDARIES),
                    "queue_depth": M.Gauge(
                        "serve_replica_queue_depth",
                        "requests in flight on a replica (per-source "
                        "series sum to deployment queue depth)"),
                    "replicas": M.Gauge(
                        "serve_deployment_replicas",
                        "running replicas, per app/deployment"),
                    "target_replicas": M.Gauge(
                        "serve_deployment_target_replicas",
                        "reconcile target replica count, per "
                        "app/deployment"),
                    "autoscale_decisions": M.Counter(
                        "serve_autoscale_decisions_total",
                        "committed autoscaler scale decisions, per "
                        "app/deployment/direction"),
                    "streams": M.Counter(
                        "serve_streams_total",
                        "streaming (generator) responses started, per "
                        "app/deployment"),
                    "ingress_requests": M.Counter(
                        "serve_ingress_requests_total",
                        "proxy ingress requests, per protocol/status"),
                    "ingress_latency": M.Histogram(
                        "serve_ingress_latency_seconds",
                        "proxy ingress end-to-end latency, per protocol",
                        boundaries=REQUEST_LATENCY_BOUNDARIES),
                }
    return _metrics
