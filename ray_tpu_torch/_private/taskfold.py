"""Port of ``ray_tpu/_private/taskfold.py``.

Fold raw task lifecycle events into one row per (task, attempt).

Shared by the driver-side state API (``ray_tpu_torch.util.state.list_tasks``) and
the dashboard (a pure GCS RPC client that must not import the worker
module) — one copy so the two surfaces can never disagree on folding
semantics (reference: the GcsTaskManager event aggregation both the state
API and dashboard read, src/ray/gcs/gcs_server/gcs_task_manager.cc).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

# Driver and workers flush on independent timers, so GCS arrival order is
# not event order — fold by emission timestamp (rank breaks exact ties).
_RANK = {"SUBMITTED": 0, "RUNNING": 1, "FAILED": 2, "FINISHED": 2}

# Canonical order of the task hot-path phases (driver submit -> driver
# wake).  Shared by the state API's timeline sub-slices, the OTLP export's
# span events, and the CLI profile table so every surface renders the same
# chain.  Durations in seconds, stamped by CoreWorker._observe_phases.
PHASE_ORDER = (
    "driver_serialize",  # arg + function payload serialization at .remote()
    "driver_stage",      # staged in the driver before the push frame left
    "dispatch",          # wire + nodelet dispatch + worker exec queue
    "exec",              # user function body (incl. arg resolution)
    "result_put",        # return-value serialization / plasma put
    "result_wake",       # worker done -> completion landing at the driver
)


def fold_task_events(events, limit: int = 1000,
                     job_id: Optional[str] = None,
                     name: Optional[str] = None) -> List[Dict[str, Any]]:
    """One row per (task, attempt): latest state + per-state timestamps."""
    rows: Dict[tuple, Dict[str, Any]] = {}
    for ev in sorted(events, key=lambda e: (e["ts"], _RANK.get(e["state"], 1))):
        if job_id is not None and ev.get("job_id") != job_id:
            continue
        if name is not None and ev.get("name") != name:
            continue
        key = (ev["task_id"], ev.get("attempt", 0))
        row = rows.setdefault(key, {
            "task_id": ev["task_id"],
            "attempt": ev.get("attempt", 0),
            "name": ev.get("name"),
            "type": ev.get("type"),
            "job_id": ev.get("job_id"),
            "actor_id": ev.get("actor_id"),
            "trace_id": ev.get("trace_id"),
            "span_id": ev.get("span_id"),
            "parent_span_id": ev.get("parent_span_id"),
            "state_ts": {},
        })
        if ev["state"] == "HUNG":
            # Watchdog annotation (nodelet-emitted): suspected-hang flag +
            # one-shot stack, merged without disturbing the lifecycle state
            # machine — the task is still RUNNING; its terminal event is
            # what clears the flag from the hang views.
            row["hung"] = {
                "ts": ev["ts"],
                "elapsed_s": ev.get("elapsed_s"),
                "threshold_s": ev.get("threshold_s"),
                "stack": ev.get("stack"),
            }
            for k in ("node_id", "worker_id"):
                if ev.get(k) is not None:
                    row[k] = ev[k]
            # only running tasks get flagged; if the lifecycle events were
            # dropped (buffer cap) the row must still carry a state
            row.setdefault("state", "RUNNING")
            continue
        if ev["state"] == "CPATH":
            # Critical-path annotation (train-step op intervals from a
            # pipeline StageExecutor, or an LLM request's TTFT
            # decomposition).  Pure payload carrier: the synthetic task_id
            # never has lifecycle events, so default a terminal state.
            row["cpath"] = ev.get("cpath")
            row.setdefault("state", "FINISHED")
            continue
        if ev["state"] == "PHASES":
            # Phase-breakdown annotation emitted by the driver when the
            # completion lands: merged into the row without disturbing the
            # lifecycle state machine (it arrives after FINISHED).
            if ev.get("phases"):
                row.setdefault("phases", {}).update(ev["phases"])
            # phases are only emitted for completions; if the lifecycle
            # events were dropped (buffer cap), the row must still carry a
            # terminal state for consumers
            row.setdefault("state", "FINISHED")
            continue
        row["state_ts"][ev["state"]] = ev["ts"]
        row["state"] = ev["state"]
        for k in ("node_id", "worker_id", "pid", "error", "attributes"):
            if ev.get(k) is not None:
                row[k] = ev[k]
    return list(rows.values())[-limit:]
