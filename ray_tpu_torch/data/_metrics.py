"""Port of ``ray_tpu/data/_metrics.py``.

Data library metrics (reference: the ray_data_* series emitted by
data/_internal/stats.py OpRuntimeMetrics; exported here as ray_tpu_data_*).

The streaming executor runs on the driver (or inside a train worker for
streaming splits), so its process pushes these to the nodelet like any
other registry.  Labels: ``dataset`` is a short per-executor uid (two
concurrent pipelines stay distinct), ``operator`` is ``<index>:<name>`` so
a view can render the chain in plan order even when two operators share a
name.
"""

from __future__ import annotations

import threading
from typing import Dict

from ray_tpu_torch._private import metrics as M

_lock = threading.Lock()
_metrics: Dict[str, M.Metric] = {}


def data_metrics() -> Dict[str, M.Metric]:
    global _metrics
    if not _metrics:
        with _lock:
            if not _metrics:
                _metrics = {
                    "rows": M.Counter(
                        "data_rows_output_total",
                        "rows emitted, per dataset/operator"),
                    "blocks": M.Counter(
                        "data_blocks_output_total",
                        "blocks emitted, per dataset/operator"),
                    "tasks": M.Counter(
                        "data_tasks_launched_total",
                        "remote tasks launched, per dataset/operator"),
                    "queue": M.Gauge(
                        "data_output_queue_blocks",
                        "blocks waiting in an operator's output queue"),
                    "buffered_bytes": M.Gauge(
                        "data_buffered_bytes",
                        "bytes buffered across a pipeline (queued + "
                        "in-flight estimate), per dataset"),
                    "backpressure": M.Gauge(
                        "data_backpressure",
                        "1 while the byte budget is gating source "
                        "admission, per dataset"),
                }
    return _metrics
