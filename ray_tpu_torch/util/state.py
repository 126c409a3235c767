"""Port of ``ray_tpu/util/state.py``.

State API: uniform listing of cluster entities + task timeline.

Counterpart of the reference's ``ray.util.state`` (reference:
python/ray/util/state/api.py — list_nodes/list_actors/list_tasks/
list_objects/list_placement_groups; ``ray timeline`` chrome-trace export in
python/ray/scripts).  Everything reads through the GCS over the driver's
existing connection; task rows are folded from the task-event stream the
core workers flush (the GcsTaskManager equivalent).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.ids import NodeID, PlacementGroupID
from ray_tpu_torch._private.worker import require_core


def _gcs_call(method: str, msg=None):
    core = require_core()
    return core.io.run(core.gcs_conn.call(method, msg))


def list_nodes() -> List[Dict[str, Any]]:
    out = []
    for n in _gcs_call("get_all_node_info", None):
        out.append({
            "node_id": NodeID(n["node_id"]).hex(),
            "state": "ALIVE" if n["alive"] else "DEAD",
            "address": f"{n['addr'][0]}:{n['addr'][1]}",
            "resources_total": n["total"],
            "resources_available": n["available"],
            "node_name": n.get("node_name", ""),
            "labels": n.get("labels", {}),
        })
    return out


def list_actors() -> List[Dict[str, Any]]:
    out = []
    for a in _gcs_call("get_all_actor_info", None):
        out.append({k: (v.hex() if isinstance(v, bytes) else v)
                    for k, v in a.items()})
    return out


def list_jobs() -> List[Dict[str, Any]]:
    return [
        {k: (v.hex() if isinstance(v, bytes) else v) for k, v in j.items()}
        for j in _gcs_call("get_all_job_info", None)
    ]


def list_placement_groups() -> List[Dict[str, Any]]:
    out = []
    for i in _gcs_call("get_all_placement_group_info", None):
        out.append({
            **{k: v for k, v in i.items() if k not in ("pg_id", "bundle_nodes")},
            "placement_group_id": PlacementGroupID(i["pg_id"]).hex(),
            "bundle_nodes": [n.hex() if n else None for n in i["bundle_nodes"]],
        })
    return out


def list_objects() -> List[Dict[str, Any]]:
    """Plasma objects known to the object directory (oid -> holder nodes)."""
    return _gcs_call("get_all_object_info", None)


def list_tasks(limit: int = 1000, job_id: Optional[str] = None,
               name: Optional[str] = None) -> List[Dict[str, Any]]:
    """One row per (task, attempt), folded from lifecycle events: latest
    state plus per-state timestamps."""
    from ray_tpu_torch._private.taskfold import fold_task_events

    events = _gcs_call("get_task_events", {"limit": 100_000})
    return fold_task_events(events, limit, job_id=job_id, name=name)


def summarize_tasks() -> Dict[str, Dict[str, int]]:
    """{task name: {state: count}} (reference: ray summary tasks)."""
    summary: Dict[str, Dict[str, int]] = {}
    for row in list_tasks(limit=100_000):
        per = summary.setdefault(row["name"] or "?", {})
        per[row["state"]] = per.get(row["state"], 0) + 1
    return summary


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(int(round(q / 100.0 * (len(sorted_vals) - 1))),
              len(sorted_vals) - 1)
    return sorted_vals[idx]


def summarize_task_phases(name: Optional[str] = None,
                          limit: int = 100_000) -> Dict[str, Dict[str, Any]]:
    """Per-phase latency distribution of completed tasks, computed from the
    PHASES annotations the driver emits when each completion lands (see
    CoreWorker._observe_phases): {phase: {count, p50, p95, p99, mean,
    total}}.  Phases are keyed in hot-path order (taskfold.PHASE_ORDER);
    ``name`` filters to one task name."""
    from ray_tpu_torch._private.taskfold import PHASE_ORDER

    per: Dict[str, List[float]] = {}
    for row in list_tasks(limit=limit, name=name):
        for k, v in (row.get("phases") or {}).items():
            per.setdefault(k, []).append(v)
    out: Dict[str, Dict[str, Any]] = {}
    order = list(PHASE_ORDER) + sorted(set(per) - set(PHASE_ORDER))
    for k in order:
        vals = per.get(k)
        if not vals:
            continue
        vals.sort()
        out[k] = {
            "count": len(vals),
            "p50": _percentile(vals, 50),
            "p95": _percentile(vals, 95),
            "p99": _percentile(vals, 99),
            "mean": sum(vals) / len(vals),
            "total": sum(vals),
        }
    return out


def _collect_metric_samples():
    """Labeled metric samples for the whole cluster: every alive nodelet's
    scrape PLUS this process's local registry.  A driver's own series reach
    the nodelet only on the periodic push, so reading the local registry
    makes just-recorded driver metrics (e.g. a Data pipeline that finished
    milliseconds ago) visible immediately; the pushed copies are excluded
    by source so nothing double counts."""
    from ray_tpu_torch._private import metrics_view as mv
    from ray_tpu_torch._private.metrics import default_registry

    core = require_core()
    my_source = f"{core.mode}-{core.worker_id.hex()[:12]}"
    texts = []
    for n in list_nodes():
        if n["state"] != "ALIVE":
            continue
        try:
            texts.append(_nodelet_call(n["node_id"], "get_metrics_text"))
        except Exception:
            continue
    samples = mv.collect_samples(texts, exclude_sources=(my_source,))
    samples.extend(mv.parse_prometheus(default_registry.prometheus_text()))
    return samples


def summarize_serve() -> Dict[str, Any]:
    """Per-deployment Serve metrics view + the controller's bounded
    autoscaler decision log (reference: `serve status` + the dashboard
    Serve view fed by ray_serve_* series)."""
    from ray_tpu_torch._private import metrics_view as mv

    out = {"deployments": mv.summarize_serve(_collect_metric_samples()),
           "autoscale_events": []}
    try:
        import ray_tpu_torch
        from ray_tpu_torch.serve._controller import get_controller

        out["autoscale_events"] = ray_tpu_torch.get(
            get_controller().get_autoscaler_events.remote(), timeout=10)
    except Exception:
        pass  # serve not running: metrics-only view
    return out


def summarize_data() -> Dict[str, Any]:
    """Per-operator Data pipeline view: rows/blocks/tasks, output-queue
    depth, and the byte-budget backpressure state per pipeline."""
    from ray_tpu_torch._private import metrics_view as mv

    return mv.summarize_data(_collect_metric_samples())


def summarize_train() -> Dict[str, Any]:
    """Per-experiment Train view: gang lifecycle, report() counters, and
    checkpoint-persist latency stats."""
    from ray_tpu_torch._private import metrics_view as mv

    return mv.summarize_train(_collect_metric_samples())


def summarize_llm() -> Dict[str, Any]:
    """Per-engine LLM inference view: TTFT/inter-token latency percentiles,
    tokens/s, decode-batch occupancy, KV-page utilization, preemptions and
    queue depth (the ray_tpu_llm_* series the continuous-batching engine
    exports; reference: vLLM's engine stats surface)."""
    from ray_tpu_torch._private import metrics_view as mv

    return mv.summarize_llm(_collect_metric_samples())


def summarize_rllib() -> Dict[str, Any]:
    """Per-job Podracer RL view: env-step/fragment throughput, fragment
    staleness percentiles, learner update + gradient-allreduce latency,
    Sebulba inference-batch occupancy, published weight version and
    env-runner respawns (the ray_tpu_rllib_* series)."""
    from ray_tpu_torch._private import metrics_view as mv

    return mv.summarize_rllib(_collect_metric_samples())


def summarize_rpc() -> Dict[str, Any]:
    """Served-RPC observability joined against the static wire contract.

    Pulls every server's per-method handler counters (``rpc_stats`` on the
    GCS and each alive nodelet — recorded when ``RayConfig.event_stats`` is
    on) and cross-checks the observed method names against the extracted
    contract snapshot (``ray_tpu_torch/_lint/wire_contract.json``, the generated
    IDL the ``wire-contract`` lint rules gate).  A method that served
    traffic but is absent from the contract means the static model and the
    runtime have diverged — exactly what the join exists to catch.

    Returns ``{methods: {name: {count, total_s, servers, in_contract}},
    unknown: [names...], contract_methods: N}``.
    """
    from ray_tpu_torch._lint import wire_contract as wc

    snapshot = wc.load_snapshot() or {}
    contract_methods = set(snapshot.get("methods") or {})
    per_server: Dict[str, Dict[str, Any]] = {}
    per_server["gcs"] = _gcs_call("rpc_stats", None) or {}
    for n in list_nodes():
        if n["state"] != "ALIVE":
            continue
        try:
            per_server[f"nodelet-{n['node_id'][:12]}"] = \
                _nodelet_call(n["node_id"], "rpc_stats") or {}
        except Exception:
            continue  # a dying nodelet must not fail the summary
    methods: Dict[str, Dict[str, Any]] = {}
    for server, stats in per_server.items():
        for m, st in stats.items():
            row = methods.setdefault(
                m, {"count": 0, "total_s": 0.0, "servers": []})
            row["count"] += st["count"]
            row["total_s"] += st["total_s"]
            row["servers"].append(server)
    for m, row in methods.items():
        row["servers"].sort()
        row["in_contract"] = (m in contract_methods
                              or m in wc.INTERNAL_METHODS)
    return {
        "methods": methods,
        "unknown": sorted(m for m, row in methods.items()
                          if not row["in_contract"]),
        "contract_methods": len(contract_methods),
    }


def get_stacks(node_id: Optional[str] = None,
               task_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Live Python stacks across the cluster (the `ray_tpu_torch stack` payload).

    Routed through the GCS, which fans out to each nodelet's ``dump_stacks``
    RPC; every worker samples its own threads via ``sys._current_frames()``
    — no py-spy, no ptrace.  ``node_id`` (hex prefix) narrows to one node;
    ``task_id`` narrows to the worker(s) currently executing that task (the
    returned threads carry ``task_id``/``task_name`` where attributable).
    Returns one payload per node: {node_id, addr, workers: [...], nodelet?}.
    """
    core = require_core()
    out = core.gcs_call_sync(
        "dump_stacks", {"node_id": node_id, "task_id": task_id}, timeout=30)
    if task_id:
        out = [p for p in out if p.get("workers")]
    elif node_id is None:
        # the driver isn't under any nodelet: sample it locally so
        # "stacks of everything" really is everything
        out.append({"node_id": None, "addr": None,
                    "workers": [core.capture_stacks()]})
    return out


def summarize_hangs() -> List[Dict[str, Any]]:
    """Suspected-hung tasks: rows the nodelet watchdog flagged (running
    past their hang threshold) that have not yet finished, each with the
    one-shot stack the watchdog attached at flag time."""
    out = []
    for row in list_tasks(limit=100_000):
        hung = row.get("hung")
        if not hung or row.get("state") in ("FINISHED", "FAILED"):
            continue
        out.append({
            "task_id": row["task_id"],
            "attempt": row.get("attempt", 0),
            "name": row.get("name"),
            "state": row.get("state"),
            "node_id": row.get("node_id"),
            "worker_id": row.get("worker_id"),
            "flagged_ts": hung.get("ts"),
            "elapsed_s": hung.get("elapsed_s"),
            "threshold_s": hung.get("threshold_s"),
            "stack": hung.get("stack"),
        })
    out.sort(key=lambda r: r.get("flagged_ts") or 0.0)
    return out


def get_blackbox(worker_id: Optional[str] = None,
                 node_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Harvested flight-recorder rings of dead workers ("black boxes").

    Each row is one dead process's last recorded moments — the nodelet read
    the victim's crash-surviving mmap'd ring off disk at death and shipped
    the tail to the GCS: ``{worker_id, node_id, harvested_at, reason,
    records: [{seq, ts, kind, detail}, ...]}``.  Filter by ``worker_id`` or
    ``node_id`` hex prefix; no filter returns every retained harvest.
    """
    return _gcs_call("get_blackbox",
                     {"worker_id": worker_id, "node_id": node_id})


def list_incidents(subsystem: Optional[str] = None,
                   limit: int = 1000) -> List[Dict[str, Any]]:
    """Closed failure incidents, newest first (the cluster-wide ledger).

    Each row is one detected failure's recovery timeline: ``{id, subsystem,
    kind, detail, victim, ok, opened_at, closed_at, recovery_seconds,
    phases: [[name, seconds], ...], slo, slo_bars}`` — plus ``blackbox``
    when the GCS could join the victim's harvested ring (explicit victim
    worker id, or a harvest inside the incident's time window, flagged via
    ``victim_match``).  Phase durations sum to ``recovery_seconds``.
    """
    return _gcs_call("list_incidents",
                     {"subsystem": subsystem, "limit": limit})


def _nodelet_call(node_id: Optional[str], method: str, msg=None):
    """RPC straight to one node's nodelet (address from the GCS node table).
    ``node_id=None`` targets the first alive node."""
    from ray_tpu_torch._private import rpc

    core = require_core()
    target = None
    for n in _gcs_call("get_all_node_info", None):
        hexid = NodeID(n["node_id"]).hex()
        if not n["alive"]:
            continue
        if node_id is None or hexid == node_id or hexid.startswith(node_id):
            target = tuple(n["addr"])
            break
    if target is None:
        raise ValueError(f"no alive node matching {node_id!r}")

    async def call():
        conn = await rpc.connect(*target, name="state->nodelet")
        try:
            return await conn.call(method, msg, timeout=30)
        finally:
            await conn.close()

    return core.io.run(call())


def list_workers(node_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Worker processes on one node — or, with ``node_id=None``, across
    every alive node (reference: util/state/api.py list_workers)."""
    if node_id is not None:
        return _nodelet_call(node_id, "list_workers")
    out = []
    for n in list_nodes():
        if n["state"] != "ALIVE":
            continue
        try:
            for w in _nodelet_call(n["node_id"], "list_workers"):
                out.append({**w, "node_id": n["node_id"]})
        except Exception:
            continue
    return out


def list_logs(node_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Log files on one node (worker stdout, nodelet/gcs logs) — the
    ``ray logs`` surface (reference: python/ray/_private/log_monitor.py,
    python/ray/util/state/api.py list_logs)."""
    return _nodelet_call(node_id, "list_log_files")


def get_log(filename: str, node_id: Optional[str] = None,
            tail: int = 64 * 1024) -> str:
    """Tail of one log file on one node (reference: state api get_log)."""
    blob = _nodelet_call(node_id, "tail_log",
                         {"name": filename, "nbytes": tail})
    if blob is None:
        raise FileNotFoundError(f"{filename} on node {node_id or '<head>'}")
    return blob.decode(errors="replace")


def _phase_intervals(row: Dict[str, Any]) -> List[tuple]:
    """Reconstruct absolute (phase, start, dur) intervals by chaining the
    recorded phase durations backward from the completion timestamp (the
    one absolute stamp every phased row has)."""
    from ray_tpu_torch._private.taskfold import PHASE_ORDER

    phases = row.get("phases") or {}
    chain = [(p, phases[p]) for p in PHASE_ORDER if p in phases]
    if not chain:
        return []
    ts = row.get("state_ts", {})
    # SUBMITTED is stamped right after serialization, i.e. between the
    # driver_serialize and driver_stage phases; fall back to chaining
    # backward from the terminal timestamp when lifecycle events were capped
    submitted = ts.get("SUBMITTED")
    if submitted is not None:
        t = submitted - (chain[0][1] if chain[0][0] == "driver_serialize"
                         else 0.0)
    else:
        end = ts.get("FINISHED") or ts.get("FAILED")
        if end is None:
            return []
        t = end - sum(d for _, d in chain)
    out = []
    for p, d in chain:
        out.append((p, t, d))
        t += d
    return out


def timeline(filename: Optional[str] = None) -> List[Dict[str, Any]]:
    """Chrome-tracing events (load via chrome://tracing or Perfetto) from the
    task stream (reference: `ray timeline`).  Each completed task with a
    phase breakdown also gets per-phase sub-slices on a parallel track.
    Returns the event list; also writes JSON to ``filename`` when given."""
    trace = []
    for row in list_tasks(limit=100_000):
        ts = row["state_ts"]
        start = ts.get("RUNNING")
        if start is None:
            continue
        end = ts.get("FINISHED") or ts.get("FAILED") or time.time()
        trace.append({
            "ph": "X",
            "cat": "task",
            "name": row["name"],
            "pid": (row.get("node_id") or "?")[:8],
            "tid": (row.get("worker_id") or "?")[:8],
            "ts": start * 1e6,
            "dur": max((end - start) * 1e6, 1.0),
            "args": {
                "task_id": row["task_id"],
                "attempt": row["attempt"],
                "state": row["state"],
                "type": row["type"],
            },
        })
        for phase, p_start, p_dur in _phase_intervals(row):
            trace.append({
                "ph": "X",
                "cat": "task_phase",
                "name": f"{row['name']}:{phase}",
                "pid": (row.get("node_id") or "?")[:8],
                # parallel track so sub-ms phases stay visible next to the
                # exec slice instead of nesting under it
                "tid": f"{(row.get('worker_id') or '?')[:8]}-phases",
                "ts": p_start * 1e6,
                "dur": max(p_dur * 1e6, 0.5),
                "args": {"task_id": row["task_id"], "phase": phase},
            })
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace


def critical_path(trace_id: Optional[str] = None,
                  step: Optional[int] = None,
                  request_id: Optional[str] = None,
                  experiment: Optional[str] = None) -> Dict[str, Any]:
    """Critical path of one trace, training step, or served LLM request —
    the longest dependent chain that bounded the end-to-end wall, with each
    on-path second attributed to a named bucket (queue, dispatch, exec,
    object-transfer, collective-comm, pipeline-bubble, admission-wait).

    Exactly one selector:

    - ``trace_id``: DAG reconstruction over the trace's spans (tasks +
      user spans), per-node self time + per-edge slack.
    - ``step`` (+ optional ``experiment``): per-stage breakdown of one
      pipeline training step from the CPATH stamps each StageExecutor
      emits, reconciled against its BubbleClock.
    - ``request_id``: TTFT decomposition of one LLM request (admission
      queue -> prefill chunks -> decode -> preemption re-waits).

    Also publishes the result's bucket attribution as the
    ``critical_path_seconds{bucket=...}`` gauge so the last analyzed
    path is scrapeable.
    """
    from ray_tpu_torch._private import critical_path as cp
    from ray_tpu_torch._private.metrics import Gauge

    selectors = [s is not None for s in (trace_id, step, request_id)]
    if sum(selectors) != 1:
        raise ValueError(
            "critical_path() needs exactly one of trace_id=, step=, "
            "request_id=")
    rows = list_tasks(limit=100_000)
    if trace_id is not None:
        result = cp.compute(rows, trace_id)
    elif step is not None:
        result = cp.train_step(rows, step, experiment=experiment)
    else:
        result = cp.llm_request(rows, request_id)
    g = Gauge("critical_path_seconds",
              "bucket attribution of the most recently analyzed critical "
              "path (state.critical_path publishes on each call)")
    for bucket, v in result["buckets"].items():
        g.set(v, {"bucket": bucket})
    return result


def get_profile(node_id: Optional[str] = None,
                task_name: Optional[str] = None) -> List[List[Any]]:
    """Raw cluster profile aggregate from the GCS:
    ``[[node, task, subsystem, tag, stack, count], ...]``.  The local
    process's not-yet-pushed delta is merged in so a driver profiling
    itself sees its own samples immediately."""
    from ray_tpu_torch._private import profiler

    entries = _gcs_call("get_profile",
                        {"node_id": node_id, "task_name": task_name})
    if profiler.SAMPLING and node_id is None:
        for task, subsystem, stack, count in profiler.peek():
            if task_name is not None and task != task_name:
                continue
            entries.append(["driver", task, subsystem, "", stack, count])
    return entries


def flamegraph_collapsed(node_id: Optional[str] = None,
                         task_name: Optional[str] = None,
                         include_hung: bool = True,
                         critical_path_trace: Optional[str] = None
                         ) -> List[str]:
    """The cluster profile in standard collapsed-stack format (one
    ``frame;frame;frame count`` line per distinct stack — flamegraph.pl /
    speedscope input).  Hang-watchdog one-shot stacks appear under a
    ``hung`` root frame; with ``critical_path_trace`` set, samples of tasks
    on that trace's critical path gain an ``on_critical_path`` root frame
    (a read-time join — sampling itself never computes paths)."""
    from ray_tpu_torch._private import profiler

    entries = [[task, subsystem, stack, count, tag]
               for _node, task, subsystem, tag, stack, count
               in get_profile(node_id=node_id, task_name=task_name)
               if include_hung or tag != "hung"]
    critical: Optional[set] = None
    if critical_path_trace is not None:
        critical = set(critical_path(trace_id=critical_path_trace)
                       .get("on_path_task_ids", []))
        names = {row.get("name") for row in list_tasks(limit=100_000)
                 if row.get("task_id") in critical}
        critical |= {n for n in names if n}
    return profiler.collapsed_lines(entries, tag_hung=include_hung,
                                    critical_tasks=critical)


def get_trace(trace_id: str) -> List[Dict[str, Any]]:
    """Spans of one trace, parent-linked and time-ordered — the span context
    travels inside task specs, so every task/actor call submitted (however
    transitively) under one root shares its trace_id (reference:
    util/tracing/tracing_helper.py span propagation; here spans ride the
    task-event pipeline instead of an external OTLP collector).

    Each span: task_id/name/span_id/parent_span_id plus start/end drawn
    from the RUNNING/FINISHED (or FAILED) timestamps.
    """
    spans = []
    for row in list_tasks(limit=100_000):
        if row.get("trace_id") != trace_id:
            continue
        ts = row.get("state_ts", {})
        spans.append({
            "span_id": row.get("span_id"),
            "parent_span_id": row.get("parent_span_id"),
            "trace_id": trace_id,
            "name": row.get("name"),
            "task_id": row["task_id"],
            "state": row.get("state"),
            "start": ts.get("RUNNING", ts.get("SUBMITTED")),
            "end": ts.get("FINISHED", ts.get("FAILED")),
            "node_id": row.get("node_id"),
            "worker_id": row.get("worker_id"),
        })
    spans.sort(key=lambda s: (s["start"] is None, s["start"]))
    return spans
