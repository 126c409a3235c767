"""Port of ``ray_tpu/util/tracing.py``.

User-facing tracing: span annotations + OTLP export.

Counterpart of the reference's OpenTelemetry integration (reference:
python/ray/util/tracing/tracing_helper.py — `_inject_tracing_into_function`
wraps task/actor calls in OTel spans and propagates the span context inside
task metadata).  Here the span context already rides every TaskSpec
(`_private/task_spec.py` trace_id/span_id/parent_span_id, emitted into the
task-event pipeline), so this module adds the two user-visible pieces:

- :func:`trace_span` — annotate a region of driver/task code with a named
  span; tasks submitted inside it parent under it automatically (the same
  contextvar the executor sets around task bodies).
- :func:`export_otlp` — serialize one trace (or all traces) to an
  OTLP/JSON file (`resourceSpans` shape) that any OpenTelemetry collector
  or Jaeger/Tempo ingester accepts — no otel SDK dependency.
- :func:`device_span` — a named range of the program's own code in the
  trace of ``torch.profiler``, on the clock of the device's kernels; it
  costs one check when no profiler is recording.
- :func:`counters` — the program's counters (kernel launches, the work
  each flash call asked for) under dotted names, read where they live.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


def get_current_trace_id() -> Optional[str]:
    """The ambient trace id (set inside task bodies and trace_span blocks).
    Alias of ``runtime_context.get_runtime_context().get_trace_id()``."""
    from ray_tpu_torch.runtime_context import get_runtime_context

    return get_runtime_context().get_trace_id()


class Span:
    """Handle yielded by :func:`trace_span`; carries ids + attributes."""

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_span_id: Optional[str]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.attributes: Dict[str, Any] = {}

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value


def _emit_span_event(core, span: Span, state: str, ts: float,
                     error: Optional[str] = None) -> None:
    """User spans ride the same task-event pipeline as task lifecycles, so
    state.get_trace / the dashboard see them with zero extra plumbing."""
    ev = {
        "trace_id": span.trace_id,
        "span_id": span.span_id,
        "parent_span_id": span.parent_span_id,
        "task_id": span.span_id,  # synthetic: user spans have no TaskID
        "attempt": 0,
        "name": span.name,
        "state": state,
        "ts": ts,
        "job_id": core.job_id.hex(),
        "type": "USER_SPAN",
        "actor_id": None,
        "node_id": core._node_id_hex,
        "worker_id": core._worker_id_hex,
        "pid": core._pid,
    }
    if span.attributes:
        # events feed JSON surfaces (dashboard, OTLP export): coerce
        # non-JSON attribute values to strings at the source
        ev["attributes"] = {
            k: (v if isinstance(v, (bool, int, float, str)) or v is None
                else str(v))
            for k, v in span.attributes.items()}
    if error:
        ev["error"] = error[:500]
    core.emit_raw_event(ev, terminal=state in ("FINISHED", "FAILED"))


@contextmanager
def trace_span(name: str, attributes: Optional[Dict[str, Any]] = None):
    """Annotate a code region as a span of the ambient trace.

    Inside a task, the span parents under the task's span; at the driver
    with no active trace, a fresh trace starts.  Tasks/actor calls submitted
    within the block become children of this span (their specs inherit the
    contextvar).  Usage::

        with trace_span("preprocess", {"rows": n}) as span:
            refs = [transform.remote(b) for b in blocks]
            ...
    """
    from ray_tpu_torch._private.core_worker import _trace_ctx
    from ray_tpu_torch._private.ids import _fast_unique
    from ray_tpu_torch._private.worker import require_core

    core = require_core()
    trace_id, parent = _trace_ctx.get()
    if trace_id is None:
        trace_id = _fast_unique(16).hex()
    span = Span(name, trace_id, _fast_unique(8).hex(), parent)
    if attributes:
        span.attributes.update(attributes)
    token = _trace_ctx.set((trace_id, span.span_id))
    _emit_span_event(core, span, "RUNNING", time.time())
    try:
        yield span
    except BaseException as e:
        _emit_span_event(core, span, "FAILED", time.time(),
                         error=f"{type(e).__name__}: {e}")
        raise
    else:
        _emit_span_event(core, span, "FINISHED", time.time())
    finally:
        _trace_ctx.reset(token)


# ------------------------------------------------------ the device's trace

SPAN_PREFIX = "ray_tpu_torch."


@contextmanager
def device_span(name: str):
    """Mark the block as ``ray_tpu_torch.<name>`` in the trace of a
    recording ``torch.profiler``: a host range on the clock of the kernels
    it launches, on any thread.  With no profiler recording it only checks
    that, once.  Nothing else switches it on."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        yield
        return
    with torch.autograd.profiler.record_function(SPAN_PREFIX + name):
        yield


def counters() -> Dict[str, int]:
    """The program's counters, read where they live, under dotted names:
    ``attention.<kernel>.launches`` and ``.fused_launches`` (the flash
    kernels' launches), ``attention.<call>.calls``, ``.flops`` and
    ``.bytes`` (the work each flash forward and backward call asked for,
    ``ops.attention.KERNEL_WORK``).  A reader takes the difference of
    two reads: the counts grow, and a run may set them back to 0."""
    from ray_tpu_torch.ops import attention

    out = {f"attention.{k}.launches": n
           for k, n in attention.KERNEL_LAUNCHES.items()}
    out.update({f"attention.{k}.fused_launches": n
                for k, n in attention.FUSED_LAUNCHES.items()})
    for call, work in attention.KERNEL_WORK.items():
        out.update({f"attention.{call}.{k}": n for k, n in work.items()})
    return out


# ------------------------------------------------------------- OTLP export

def _otlp_attr(key: str, value: Any) -> Dict[str, Any]:
    if isinstance(value, bool):
        v = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}


def export_otlp(filename: str, trace_id: Optional[str] = None,
                service_name: str = "ray_tpu_torch",
                limit: int = 100_000) -> int:
    """Write trace spans as OTLP/JSON (``resourceSpans``) and return the
    span count.  ``trace_id=None`` exports every trace seen by the GCS;
    ``limit`` caps the exported task rows (newest first — exceeding it
    logs the dropped count rather than truncating silently).  Closed
    failure incidents export too: one span per incident, a child span per
    recovery phase.

    The output loads into any OTLP-ingesting backend (Jaeger, Tempo, an
    otel collector's file receiver) — the reference achieves the same by
    linking the OTel SDK's exporters (tracing_helper.py); here the wire
    shape is produced directly so tracing works with zero extra deps.
    """
    from ray_tpu_torch.util import state

    # Read-your-writes: the local driver's event buffer flushes on a small
    # throttle; an export issued right after a span closes must still see
    # it, so force this process's buffer to the GCS first.
    from ray_tpu_torch._private import worker as _worker_mod

    core = _worker_mod.global_worker_core()
    if core is not None:
        try:
            core.io.run(core._flush_task_events(), timeout=2)
        except Exception:
            pass  # export proceeds on whatever has landed

    # fold everything, THEN apply the cap, so a hit limit can name exactly
    # how many rows it dropped (no-silent-caps)
    rows = state.list_tasks(limit=2 ** 31)
    if len(rows) > limit:
        logger.warning(
            "export_otlp: %d task rows exceed limit=%d; dropping the %d "
            "oldest (raise the limit= parameter to export them)",
            len(rows), limit, len(rows) - limit)
        rows = rows[-limit:]  # fold order is oldest-first
    # Per-trace critical paths, so Jaeger/Tempo can filter/highlight the
    # chain that actually bounded each trace (ray_tpu_torch.on_critical_path).
    from ray_tpu_torch._private import critical_path as _cp

    on_path = _cp.on_path_span_ids(rows)
    spans: List[Dict[str, Any]] = []
    for row in rows:
        if row.get("trace_id") is None:
            continue
        if trace_id is not None and row["trace_id"] != trace_id:
            continue
        ts = row.get("state_ts", {})
        start = ts.get("RUNNING", ts.get("SUBMITTED"))
        if start is None:
            continue
        end = ts.get("FINISHED") or ts.get("FAILED") or time.time()
        attrs = [
            _otlp_attr("ray_tpu_torch.task_id", row["task_id"]),
            _otlp_attr("ray_tpu_torch.type", row.get("type") or "?"),
            _otlp_attr("ray_tpu_torch.state", row.get("state") or "?"),
        ]
        for k in ("node_id", "worker_id", "pid", "attempt"):
            if row.get(k) is not None:
                attrs.append(_otlp_attr(f"ray_tpu_torch.{k}", row[k]))
        span_key = row.get("span_id") or row["task_id"]
        if span_key in on_path.get(row["trace_id"], ()):
            attrs.append(_otlp_attr("ray_tpu_torch.on_critical_path", True))
        for k, v in (row.get("attributes") or {}).items():
            attrs.append(_otlp_attr(k, v))
        span = {
            "traceId": row["trace_id"],
            "spanId": row["span_id"] or row["task_id"][:16],
            "name": row.get("name") or "task",
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(int(start * 1e9)),
            "endTimeUnixNano": str(int(end * 1e9)),
            "attributes": attrs,
            "status": ({"code": 2, "message": row.get("error", "")[:200]}
                       if row.get("state") == "FAILED" else {"code": 1}),
        }
        if row.get("parent_span_id"):
            span["parentSpanId"] = row["parent_span_id"]
        # Phase breakdown as OTLP span events: one event per hot-path phase
        # at the phase's reconstructed start, duration as an attribute —
        # Jaeger/Tempo render them as span logs on the task's timeline.
        events = []
        for phase, p_start, p_dur in state._phase_intervals(row):
            events.append({
                "timeUnixNano": str(int(p_start * 1e9)),
                "name": f"phase.{phase}",
                "attributes": [_otlp_attr("duration_s", p_dur)],
            })
        if events:
            span["events"] = events
        spans.append(span)
    spans.extend(_incident_spans(trace_id))
    doc = {
        "resourceSpans": [{
            "resource": {"attributes": [
                _otlp_attr("service.name", service_name)]},
            "scopeSpans": [{
                "scope": {"name": "ray_tpu_torch", "version": "1"},
                "spans": spans,
            }],
        }],
    }
    with open(filename, "w") as f:
        json.dump(doc, f)
    return len(spans)


def _incident_spans(trace_id: Optional[str]) -> List[Dict[str, Any]]:
    """Closed failure incidents as OTLP spans: one root span per incident
    (trace id derived from the incident id, so each incident is its own
    trace) with one child span per recovery phase — Jaeger/Tempo render the
    detect/quarantine/rebuild/resume timeline as a waterfall."""
    from ray_tpu_torch.util import state

    try:
        recs = state.list_incidents()
    except Exception:
        return []  # no GCS (e.g. exporting before init): tasks only
    spans: List[Dict[str, Any]] = []
    for rec in recs:
        inc_trace = (rec["id"] * 4)[:32]
        if trace_id is not None and inc_trace != trace_id:
            continue
        end = rec.get("closed_at") or time.time()
        start = end - rec.get("recovery_seconds", 0.0)
        attrs = [
            _otlp_attr("ray_tpu_torch.incident_id", rec["id"]),
            _otlp_attr("ray_tpu_torch.subsystem", rec.get("subsystem", "?")),
            _otlp_attr("ray_tpu_torch.kind", rec.get("kind", "")),
            _otlp_attr("ray_tpu_torch.detail", rec.get("detail", "")),
            _otlp_attr("ray_tpu_torch.victim", rec.get("victim", "")),
            _otlp_attr("ray_tpu_torch.slo", rec.get("slo", "none")),
            _otlp_attr("ray_tpu_torch.recovered", bool(rec.get("ok"))),
        ]
        root_id = rec["id"][:16].ljust(16, "0")
        spans.append({
            "traceId": inc_trace,
            "spanId": root_id,
            "name": f"incident:{rec.get('subsystem', '?')}",
            "kind": 1,
            "startTimeUnixNano": str(int(start * 1e9)),
            "endTimeUnixNano": str(int(end * 1e9)),
            "attributes": attrs,
            "status": ({"code": 1} if rec.get("ok")
                       else {"code": 2, "message": "unrecovered"}),
        })
        t = start
        for i, (phase, dur) in enumerate(rec.get("phases") or []):
            spans.append({
                "traceId": inc_trace,
                "spanId": f"{i + 1:04x}" + root_id[4:],
                "parentSpanId": root_id,
                "name": f"phase.{phase}",
                "kind": 1,
                "startTimeUnixNano": str(int(t * 1e9)),
                "endTimeUnixNano": str(int((t + dur) * 1e9)),
                "attributes": [_otlp_attr("duration_s", dur)],
                "status": {"code": 1},
            })
            t += dur
    return spans
