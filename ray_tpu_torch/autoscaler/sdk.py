"""Port of ``ray_tpu/autoscaler/sdk.py``.

Programmatic autoscaler API (reference: ray.autoscaler.sdk).

``request_resources`` posts a STANDING demand the autoscaler provisions for
whether or not tasks are queued — the knob for pre-warming capacity before
a burst (e.g. reserve a TPU slice ahead of a training job).  Each caller's
latest request replaces its previous one; requesting nothing withdraws it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private.worker import require_core


def request_resources(*, num_cpus: Optional[int] = None,
                      bundles: Optional[List[Dict[str, float]]] = None
                      ) -> None:
    """Ask the autoscaler to hold capacity for ``bundles`` (plus
    ``num_cpus`` 1-CPU bundles).  ``request_resources()`` with no arguments
    withdraws this process's standing request."""
    req: List[Dict[str, float]] = [dict(b) for b in (bundles or [])]
    if num_cpus:
        req.extend({"CPU": 1.0} for _ in range(int(num_cpus)))
    core = require_core()
    core.gcs_call_sync("request_resources", {
        "requester": core.worker_id.binary(), "bundles": req})
