"""Port of ``ray_tpu/_private/incidents.py``.

First-class incident records with named recovery phases and SLO bars.

``recovery_seconds{subsystem}`` says a rank-death recovery took 10.6 s; it
cannot say which of detect / quarantine / rebuild / restore / resume ate
them.  This module makes every detected failure a first-class *incident*:
the detection path opens one, recovery code stamps named phases as it works
through them, and ``close()`` turns the stamps into a timeline —

- phase durations are consecutive-stamp diffs from ``started_mono``, so
  ``sum(phase_seconds) == recovery_seconds`` *by construction*;
- the one ``recovery_seconds`` emission point lives here (``observe`` via
  ``fault_injection._recovery_metric``) plus the new per-phase histogram
  ``recovery_phase_seconds{subsystem,phase}``, so the two ledgers cannot
  drift;
- each timeline is checked against the declarative SLO bars in
  ``RayConfig.recovery_slo`` (``subsystem[.phase]<seconds``, comma
  separated — e.g. ``collective.detect<15,serve<1``);
- the closed record is published to the GCS (``incident_report`` notify) so
  ``state.list_incidents()`` / ``ray_tpu_torch incidents`` / the dashboard see a
  cluster-wide ledger, and kept in a local bounded ledger for in-process
  consumers (the recovery bench reads its own rank's incident).

Canonical phase order: detect -> quarantine -> rebuild -> restore ->
resume.  Subsystems stamp the subset that exists in their recovery path.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import _fast_unique

PHASES = ("detect", "quarantine", "rebuild", "restore", "resume")

_lock = threading.Lock()
_ledger: Optional[deque] = None
_publisher: Optional[Callable[[dict], None]] = None
_m_phase = None
_m_total = None


class Incident:
    """One detected failure, from detection to restored service."""

    def __init__(self, subsystem: str, kind: str = "", detail: str = "",
                 victim: str = "", started_mono: Optional[float] = None):
        self.id = _fast_unique(8).hex()
        self.subsystem = subsystem
        self.kind = kind
        self.detail = detail
        self.victim = victim  # worker_id hex of the dead process, if known
        self.opened_at = time.time()
        self.started_mono = (time.monotonic() if started_mono is None
                             else started_mono)
        self.stamps: List[Tuple[str, float]] = []
        self.blackbox: Optional[List[dict]] = None
        self.closed: Optional[dict] = None

    def stamp(self, phase: str) -> None:
        """Mark the end of ``phase``; its duration is the time since the
        previous stamp (or since ``started_mono`` for the first)."""
        if self.closed is None:
            self.stamps.append((phase, time.monotonic()))

    def close(self, ok: bool = True) -> dict:
        """Finalize: compute the phase timeline, emit metrics, evaluate SLO
        bars, publish to the GCS.  Idempotent (returns the first record)."""
        if self.closed is not None:
            return self.closed
        if not self.stamps or self.stamps[-1][0] != "resume":
            self.stamp("resume")
        phases: List[Tuple[str, float]] = []
        prev = self.started_mono
        for name, t in self.stamps:
            phases.append((name, max(t - prev, 0.0)))
            prev = t
        recovery_s = max(self.stamps[-1][1] - self.started_mono, 0.0)
        rec = {
            "id": self.id,
            "subsystem": self.subsystem,
            "kind": self.kind,
            "detail": self.detail,
            "victim": self.victim,
            "ok": ok,
            "opened_at": self.opened_at,
            "closed_at": time.time(),
            "recovery_seconds": recovery_s,
            "phases": [[n, s] for n, s in phases],
        }
        bars = _check_slo(self.subsystem, dict(phases), recovery_s)
        rec["slo_bars"] = bars
        rec["slo"] = ("none" if not bars
                      else "pass" if all(b["pass"] for b in bars)
                      else "fail")
        if self.blackbox is not None:
            rec["blackbox"] = self.blackbox
        self.closed = rec
        _emit(rec, phases)
        _remember(rec)
        _publish(rec)
        return rec


def open_incident(subsystem: str, kind: str = "", detail: str = "",
                  victim: str = "",
                  started_mono: Optional[float] = None) -> Incident:
    """Open an incident at the point of failure *detection*.  Pass
    ``started_mono`` to backdate (e.g. to the op start the failure
    interrupted) so the first phase measures real elapsed time."""
    inc = Incident(subsystem, kind, detail, victim, started_mono)
    from ray_tpu_torch._private import flight_recorder

    if flight_recorder.RECORDING:
        flight_recorder.record(
            "incident.open", f"{subsystem}|{kind}|{detail}")
    return inc


def observe(subsystem: str, seconds: float, kind: str = "span") -> dict:
    """Back-compat shim for one-number recovery observations: a pre-timed
    interval becomes a single-phase incident ending now.  This is what
    ``fault_injection.observe_recovery`` delegates to."""
    inc = Incident(subsystem, kind=kind,
                   started_mono=time.monotonic() - max(seconds, 0.0))
    return inc.close()


def list_local(limit: Optional[int] = None) -> List[dict]:
    """Closed incidents recorded by THIS process, oldest first."""
    with _lock:
        rows = list(_ledger) if _ledger is not None else []
    if limit is not None and len(rows) > limit:
        rows = rows[-limit:]
    return rows


def set_publisher(fn: Optional[Callable[[dict], None]]) -> None:
    """Override how closed incidents reach the GCS (the nodelet installs
    its own connection; ``None`` restores the core-worker default)."""
    global _publisher
    _publisher = fn


def reset() -> None:
    """Drop the local ledger + publisher (tests)."""
    global _ledger, _publisher
    with _lock:
        _ledger = None
        _publisher = None


# ---------------------------------------------------------------- internals

def _slo_bars() -> List[Tuple[str, str, str, float]]:
    """Parse ``RayConfig.recovery_slo`` -> (raw, subsystem, phase, limit)."""
    from ray_tpu_torch._private.config import RayConfig

    try:
        raw = RayConfig.recovery_slo
    except Exception:
        return []
    bars = []
    for part in filter(None, (p.strip() for p in raw.split(","))):
        lhs, sep, rhs = part.partition("<")
        if not sep:
            continue
        try:
            limit = float(rhs)
        except ValueError:
            continue
        subsystem, _, phase = lhs.strip().partition(".")
        bars.append((part, subsystem, phase, limit))
    return bars


def _check_slo(subsystem: str, phase_s: Dict[str, float],
               recovery_s: float) -> List[dict]:
    out = []
    for raw, sub, phase, limit in _slo_bars():
        if sub != subsystem:
            continue
        if phase:
            if phase not in phase_s:
                continue  # bar names a phase this recovery path lacks
            seconds = phase_s[phase]
        else:
            seconds = recovery_s
        out.append({"bar": raw, "seconds": seconds,
                    "pass": seconds < limit})
    return out


def _emit(rec: dict, phases: List[Tuple[str, float]]) -> None:
    global _m_phase, _m_total
    from ray_tpu_torch._private import fault_injection, flight_recorder
    from ray_tpu_torch._private import metrics as M

    if _m_phase is None:
        _m_phase = M.Histogram(
            "recovery_phase_seconds",
            "per-phase breakdown of failure recoveries (detect / "
            "quarantine / rebuild / restore / resume), by subsystem",
            boundaries=M.PHASE_SECONDS_BOUNDARIES)
        _m_total = M.Counter(
            "incidents_total",
            "closed failure incidents, by subsystem and SLO verdict "
            "(pass / fail / none when no bar matches)")
    sub = rec["subsystem"]
    for name, seconds in phases:
        _m_phase.observe(seconds, {"subsystem": sub, "phase": name})
    _m_total.inc(1, {"subsystem": sub, "slo": rec["slo"]})
    fault_injection._recovery_metric().observe(
        rec["recovery_seconds"], {"subsystem": sub})
    if flight_recorder.RECORDING:
        flight_recorder.record(
            "incident.close",
            f"{sub}|{rec['slo']}|{rec['recovery_seconds']:.3f}s")


def _remember(rec: dict) -> None:
    global _ledger
    with _lock:
        if _ledger is None:
            from ray_tpu_torch._private.config import RayConfig

            try:
                keep = int(RayConfig.incident_retention)
            except Exception:
                keep = 256
            _ledger = deque(maxlen=max(keep, 1))
        _ledger.append(rec)


def _swallow(fut) -> None:
    try:
        fut.exception()
    except Exception:
        pass


def _publish(rec: dict) -> None:
    pub = _publisher
    if pub is not None:
        try:
            pub(rec)
        except Exception:
            pass
        return
    try:
        from ray_tpu_torch._private import worker as _worker_mod

        core = _worker_mod.global_worker_core()
        if core is None:
            return
        coro = core.gcs_conn.notify("incident_report", rec)
        if core.io.on_loop_thread():
            # recovery paths close incidents ON the IO loop (nodelet conn
            # loss, serve failover, task-retry completions): blocking here
            # would stall the loop for the whole timeout, so downgrade to
            # fire-and-forget
            core.io.spawn(coro).add_done_callback(_swallow)
        else:
            core.io.run(coro, timeout=5)
    except Exception:
        pass  # publishing is best-effort; the local ledger keeps the record
