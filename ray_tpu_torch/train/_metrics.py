"""Port of ``ray_tpu/train/_metrics.py``.

Train library metrics (reference: the ray_train_* series from
train/_internal metrics; exported here as ray_tpu_train_*).

Two emitting sides: each train-worker session counts its own ``report()``
calls and checkpoint persists (pushed by the worker's CoreWorker), and the
driver-side trainer publishes the gang lifecycle gauge plus the consumed
report rounds.  ``GANG_STATES`` maps the gauge's numeric values — the view
layer (`_private/metrics_view.py`) decodes them back to names.
"""

from __future__ import annotations

import threading
from typing import Dict

from ray_tpu_torch._private import metrics as M
from ray_tpu_torch._private.metrics_view import GANG_STATES  # noqa: F401 (re-export)

# Checkpoint persists range from tiny local dirs to multi-GB uploads that
# leave the host.
CHECKPOINT_SECONDS_BOUNDARIES = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
    30.0, 60.0, 120.0, 300.0, 600.0,
)

_lock = threading.Lock()
_metrics: Dict[str, M.Metric] = {}


def train_metrics() -> Dict[str, M.Metric]:
    global _metrics
    if not _metrics:
        with _lock:
            if not _metrics:
                _metrics = {
                    "reports": M.Counter(
                        "train_report_total",
                        "worker report() calls, per experiment"),
                    "report_rounds": M.Counter(
                        "train_report_rounds_total",
                        "driver-consumed lockstep report rounds, per "
                        "experiment"),
                    "gang_state": M.Gauge(
                        "train_gang_state",
                        "worker-gang lifecycle (0 starting, 1 running, "
                        "2 finished, 3 failed), per experiment"),
                    "gang_workers": M.Gauge(
                        "train_gang_workers",
                        "world size of the running gang, per experiment"),
                    "rank_step": M.Gauge(
                        "train_rank_step",
                        "last report() step begun, per experiment and rank "
                        "(worker-side heartbeat)"),
                    "step_skew": M.Gauge(
                        "train_gang_step_skew",
                        "max-min report step across the gang's ranks, per "
                        "experiment (straggler indicator)"),
                    "ckpt_persist": M.Histogram(
                        "train_checkpoint_persist_seconds",
                        "report()-side checkpoint persist duration, per "
                        "experiment",
                        boundaries=CHECKPOINT_SECONDS_BOUNDARIES),
                    "ckpt_restore": M.Histogram(
                        "train_checkpoint_restore_seconds",
                        "checkpoint download/materialize duration",
                        boundaries=CHECKPOINT_SECONDS_BOUNDARIES),
                    "pipeline_bubble": M.Counter(
                        "pipeline_bubble_seconds",
                        "seconds a pipeline stage spent blocked on "
                        "inter-stage recv (schedule bubble), per experiment "
                        "and stage"),
                    "pipeline_bubble_fraction": M.Gauge(
                        "pipeline_bubble_fraction",
                        "recv-blocked fraction of the last step's wall "
                        "clock on this stage, per experiment and stage"),
                    "pipeline_stage_busy": M.Gauge(
                        "pipeline_stage_busy_seconds",
                        "compute (fwd+bwd+optim) seconds of the last step "
                        "on this stage — the overlap-accounting numerator, "
                        "per experiment and stage"),
                    "pipeline_comm": M.Counter(
                        "pipeline_comm_seconds",
                        "seconds a pipeline stage spent on the dp gradient "
                        "collective (bucket packing/launch + blocked at "
                        "the clip barrier), per experiment and stage — "
                        "split out of the wait bucket so bubble keeps "
                        "meaning schedule stall"),
                    "pipeline_overlap_fraction": M.Gauge(
                        "pipeline_overlap_fraction",
                        "share of the last step's dp-collective execution "
                        "time hidden behind 1F1B compute (1 - blocked/"
                        "comm-op seconds; 0 when no dp comm), per "
                        "experiment and stage"),
                    "train_dp_wire_bytes": M.Counter(
                        "train_dp_wire_bytes",
                        "wire bytes this stage's replica shipped for the "
                        "dp gradient exchange (bucket allreduces + commit "
                        "scalar), per experiment and stage"),
                }
    return _metrics
