"""Port of ``ray_tpu/rllib/_metrics.py``.

RL training metrics (exported as ray_tpu_rllib_* on every node's
/metrics scrape; reference: rllib's env-steps/learner throughput stats —
folded through the same push->scrape->view pipeline the Serve/Data/Train/LLM
series ride).

One lazily-built singleton set per process; the ``job`` label keys every
series so several concurrently running algorithms (or a bench's A/B arms)
stay distinguishable, and the view layer sums/folds them per job.
"""

from __future__ import annotations

import threading
from typing import Dict

from ray_tpu_torch._private import metrics as M

# Staleness is measured in POLICY VERSIONS (published weight generations
# between the fragment's behavior policy and the learner's current one) —
# small integers, so unit-width buckets at the bottom.
STALENESS_BOUNDARIES = (0, 1, 2, 3, 4, 6, 8, 12, 16, 32)
# One pooled forward serves this many concurrent act() requests.
INFER_BATCH_BOUNDARIES = (1, 2, 4, 8, 16, 32, 64, 128)

_lock = threading.Lock()
_metrics: Dict[str, M.Metric] = {}


def rllib_metrics() -> Dict[str, M.Metric]:
    """The process-local RL metric set (idempotent; re-instantiation by
    name adopts existing storage)."""
    global _metrics
    if not _metrics:
        with _lock:
            if not _metrics:
                _metrics = {
                    "env_steps": M.Counter(
                        "rllib_env_steps_total",
                        "environment steps sampled by env-runners, per job"),
                    "fragments": M.Counter(
                        "rllib_fragments_total",
                        "trajectory fragments consumed by the learner(s), "
                        "per job"),
                    "staleness": M.Histogram(
                        "rllib_fragment_staleness",
                        "policy-version lag of each consumed fragment "
                        "(published versions behind the learner), per job",
                        boundaries=STALENESS_BOUNDARIES),
                    "update_seconds": M.Histogram(
                        "rllib_learner_update_seconds",
                        "one learner update (grads + fold + apply), per job",
                        boundaries=M.PHASE_SECONDS_BOUNDARIES),
                    "allreduce_seconds": M.Histogram(
                        "rllib_learner_allreduce_seconds",
                        "gradient allreduce inside one learner update, "
                        "per job",
                        boundaries=M.PHASE_SECONDS_BOUNDARIES),
                    "infer_batch": M.Histogram(
                        "rllib_inference_batch_size",
                        "act() requests folded into one pooled forward "
                        "(Sebulba batched-inference occupancy), per job",
                        boundaries=INFER_BATCH_BOUNDARIES),
                    "infer_requests": M.Counter(
                        "rllib_inference_requests_total",
                        "act() requests served by InferencePool actors, "
                        "per job"),
                    "weight_version": M.Gauge(
                        "rllib_weight_version",
                        "latest policy version published to the weight "
                        "mailbox, per job"),
                    "runner_restarts": M.Counter(
                        "rllib_runner_restarts_total",
                        "env-runner actors respawned after death, per job"),
                }
    return _metrics
