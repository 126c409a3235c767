"""Port of ``ray_tpu/tune/session.py``.

tune.report: intermediate metric reporting from inside a trial.

Reference: ray.tune.report / ray.train.report (session.py:403).  The trial
task wrapper installs a session (coordinator handle + trial index); user code
calls ``tune.report(metrics, checkpoint=...)`` each iteration.  When the
scheduler has decided to stop this trial (ASHA rung cut, PBT exploit), the
NEXT report raises ``StopTrial``, which the wrapper treats as a graceful
early exit — cooperative stopping, same contract as reference trainables.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

_tls = threading.local()


class StopTrial(Exception):
    """Raised inside a trial when the scheduler stops it early."""


class _TuneSession:
    def __init__(self, coordinator, trial_index: int):
        self.coordinator = coordinator
        self.trial_index = trial_index
        self.last_metrics: Optional[Dict[str, Any]] = None


def _set_session(session: Optional[_TuneSession]) -> None:
    _tls.session = session


def get_session() -> Optional[_TuneSession]:
    return getattr(_tls, "session", None)


def report(metrics: Dict[str, Any], *, checkpoint: Optional[str] = None) -> None:
    """Report one iteration's metrics (and optionally a checkpoint path).

    Outside a Tune trial this is a no-op, so the same training function runs
    standalone and under the Tuner unchanged (reference behavior).
    """
    import ray_tpu_torch

    session = get_session()
    if session is None:
        return
    session.last_metrics = dict(metrics)
    should_stop = ray_tpu_torch.get(
        session.coordinator.report.remote(
            session.trial_index, metrics, checkpoint),
        timeout=60)
    if should_stop:
        raise StopTrial()


def get_checkpoint() -> Optional[str]:
    """The checkpoint handed to this trial (PBT warm start), if any."""
    session = get_session()
    if session is None:
        return None
    return getattr(session, "start_checkpoint", None)
