"""Port of ``ray_tpu/_private/critical_path.py``.

Critical-path engine: "where did the time go?" over the task-event store.

Reconstructs the dependency DAG of one trace (or one training step, or one
LLM serve request) from folded task rows and computes the longest dependent
chain — the chain of spans that actually bounded the end-to-end wall — with
per-edge slack and a bucket attribution of every on-path second:

    queue            waiting for a worker (wire + dispatch + exec queue)
    dispatch         driver-side submit machinery (serialize + stage)
    exec             user code running
    object-transfer  result serialization/put + completion wake
    collective-comm  collective ops (dp allreduce, named col ops)
    pipeline-bubble  pipeline stage recv waits (the 1F1B bubble)
    admission-wait   serve admission-control queueing
    untracked        on-path time no instrumentation claims

Pure functions over folded rows (``taskfold.fold_task_events`` output) —
dependency-free like taskfold itself, so the driver-side state API, the CLI
and the dashboard (a pure GCS RPC client that must not import the worker
module) share one implementation and can never disagree.

DAG reconstruction rules (documented in docs/ARCHITECTURE.md §5f):

- Nodes are spans: task attempts and USER_SPANs, keyed by span_id
  (task_id as fallback), linked child -> parent via parent_span_id.
- A parent's end was bounded by whichever of its children finished last
  before each point in time: walking backward from the parent's end, the
  child with the latest end <= the current frontier joins the path, the
  frontier jumps to that child's start, and the uncovered gaps are the
  parent's own on-path time.  Off-path children get ``slack_s`` — how much
  later they could have finished without changing the path.
- A node's own on-path time is bucketed by its phase intervals (PHASES
  sub-slices), by an explicit ``cpath.bucket`` span attribute, or by the
  SUBMITTED->RUNNING / RUNNING->end split when neither exists.

All floats are rounded at the JSON boundary and every ordering is
total (ties break on span_id), so the same event fixture always renders
byte-identical JSON — asserted by tests/test_critical_path.py.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

BUCKETS = (
    "queue", "dispatch", "exec", "object-transfer",
    "collective-comm", "pipeline-bubble", "admission-wait", "untracked",
)

# hot-path phases (taskfold.PHASE_ORDER) -> bucket
PHASE_BUCKET = {
    "driver_serialize": "dispatch",
    "driver_stage": "dispatch",
    "dispatch": "queue",
    "exec": "exec",
    "result_put": "object-transfer",
    "result_wake": "object-transfer",
}

# pipeline op kinds (schedule.StageExecutor CPATH stamps) -> bucket
_OP_BUCKET = {
    "fwd": "exec", "bwd": "exec", "optim": "exec",
    "send_act": "object-transfer", "send_grad": "object-transfer",
    "recv_act": "pipeline-bubble", "recv_grad": "pipeline-bubble",
}

_EPS = 1e-9


def _round(x: float) -> float:
    # one rounding rule at every float boundary so repeated runs over the
    # same fixture serialize byte-identically
    return round(float(x), 6)


def _phase_intervals(row: Dict[str, Any]) -> List[Tuple[str, float, float]]:
    """Absolute (phase, start, dur) tuples — same reconstruction as
    util.state._phase_intervals, duplicated here because this module must
    stay importable without the driver-side worker package."""
    from ray_tpu_torch._private.taskfold import PHASE_ORDER

    phases = row.get("phases") or {}
    chain = [(p, phases[p]) for p in PHASE_ORDER if p in phases]
    if not chain:
        return []
    ts = row.get("state_ts", {})
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


class _Node:
    __slots__ = ("row", "span_id", "parent", "start", "end", "children",
                 "self_segments", "slack_s")

    def __init__(self, row, span_id, start, end):
        self.row = row
        self.span_id = span_id
        self.parent = row.get("parent_span_id")
        self.start = start
        self.end = end
        self.children: List["_Node"] = []
        self.self_segments: List[Tuple[float, float]] = []  # on-path
        self.slack_s: Optional[float] = None  # off-path children only


def _node_interval(row) -> Optional[Tuple[float, float]]:
    ts = row.get("state_ts", {})
    start = ts.get("SUBMITTED", ts.get("RUNNING"))
    end = ts.get("FINISHED", ts.get("FAILED"))
    # a still-RUNNING row has no end: it cannot anchor a finished chain
    if start is None or end is None or end < start:
        return None
    for _p, p_start, p_dur in _phase_intervals(row):
        start = min(start, p_start)
        end = max(end, p_start + p_dur)
    return start, end


def _span_bucket(row) -> Optional[str]:
    """Explicit bucket tag on a USER_SPAN (``cpath.bucket`` attribute), or
    a name-based collective classification."""
    attrs = row.get("attributes") or {}
    b = attrs.get("cpath.bucket")
    if b in BUCKETS:
        return b
    name = (row.get("name") or "")
    if name.startswith(("col_", "allreduce", "collective")):
        return "collective-comm"
    return None


def _bucket_node_segment(node: _Node, lo: float, hi: float,
                         buckets: Dict[str, float]) -> None:
    """Attribute one on-path self-segment [lo, hi] of ``node`` to buckets."""
    if hi - lo <= _EPS:
        return
    row = node.row
    forced = _span_bucket(row)
    if forced is not None:
        buckets[forced] += hi - lo
        return
    intervals = _phase_intervals(row)
    if intervals:
        covered = 0.0
        for phase, p_start, p_dur in intervals:
            a = max(lo, p_start)
            b = min(hi, p_start + p_dur)
            if b - a > _EPS:
                buckets[PHASE_BUCKET.get(phase, "untracked")] += b - a
                covered += b - a
        rest = (hi - lo) - covered
        if rest > _EPS:
            buckets["untracked"] += rest
        return
    ts = row.get("state_ts", {})
    running = ts.get("RUNNING")
    if running is not None and running > lo:
        # waiting-to-run portion is queueing; the rest is the body
        buckets["queue"] += min(running, hi) - lo
        if hi > running:
            buckets["exec"] += hi - running
    else:
        buckets["exec"] += hi - lo


def compute(rows: List[Dict[str, Any]],
            trace_id: Optional[str] = None) -> Dict[str, Any]:
    """Critical path of one trace's folded rows.

    Returns {trace_id, start, end, wall_s, path_s, buckets, nodes,
    off_path, on_path_span_ids}; ``buckets`` sums to ``path_s`` exactly
    (bucket-conservation is asserted by tests).  Raises ValueError when the
    trace has no finished spans to anchor a path.
    """
    nodes: Dict[str, _Node] = {}
    for row in rows:
        if trace_id is not None and row.get("trace_id") != trace_id:
            continue
        if row.get("cpath") is not None:
            continue  # step/request annotations have their own surfaces
        iv = _node_interval(row)
        if iv is None:
            continue
        span_id = row.get("span_id") or row["task_id"]
        # duplicate span ids (retried attempts): keep the latest-ending
        prev = nodes.get(span_id)
        if prev is not None and prev.end >= iv[1]:
            continue
        nodes[span_id] = _Node(row, span_id, iv[0], iv[1])
    if not nodes:
        raise ValueError(
            f"no finished spans for trace {trace_id!r} in the event store")

    for n in nodes.values():
        parent = nodes.get(n.parent) if n.parent else None
        if parent is not None and parent is not n:
            parent.children.append(n)
    roots = [n for n in nodes.values()
             if not n.parent or n.parent not in nodes]
    # the chain that decided the trace's end starts at the latest-ending
    # root; ties break on span_id so the choice is deterministic
    root = max(roots, key=lambda n: (n.end, n.span_id))

    path_nodes: List[_Node] = []

    def walk(node: _Node, frontier: float) -> None:
        """Backward frontier walk: attribute [node.start, frontier] between
        the node itself and the child chain that bounded it."""
        path_nodes.append(node)
        t = frontier
        # slack reference: an off-path child could slip until it out-ended
        # the on-path sibling that covered it (at which point the path
        # would reroute through it) — start at the parent's frontier
        cover = frontier
        kids = sorted(node.children, key=lambda c: (-c.end, c.span_id))
        for child in kids:
            if child.end > t + _EPS or child.end <= node.start + _EPS:
                # finished after the frontier (not what we were waiting on)
                # or before the node even started: off-path
                child.slack_s = max(cover - child.end, 0.0)
                continue
            if t - child.end > _EPS:
                node.self_segments.append((child.end, t))
            walk(child, child.end)
            cover = child.end
            t = max(child.start, node.start)
        if t - node.start > _EPS:
            node.self_segments.append((node.start, t))

    walk(root, root.end)

    buckets = {b: 0.0 for b in BUCKETS}
    rendered = []
    path_s = root.end - root.start
    for n in path_nodes:
        per = {b: 0.0 for b in BUCKETS}
        for lo, hi in n.self_segments:
            _bucket_node_segment(n, lo, hi, per)
        self_s = sum(per.values())
        for b, v in per.items():
            buckets[b] += v
        rendered.append({
            "span_id": n.span_id,
            "task_id": n.row.get("task_id"),
            "name": n.row.get("name"),
            "type": n.row.get("type"),
            "node_id": n.row.get("node_id"),
            "start": _round(n.start),
            "end": _round(n.end),
            "dur_s": _round(n.end - n.start),
            "self_s": _round(self_s),
            "pct_of_path": _round(100.0 * self_s / path_s) if path_s else 0.0,
            "buckets": {b: _round(v) for b, v in sorted(per.items())
                        if v > _EPS},
        })
    # conservation: self-segments tile [root.start, root.end] exactly, so
    # bucket mass must equal the path length; absorb float dust into
    # 'untracked' instead of letting the invariant drift
    drift = path_s - sum(buckets.values())
    buckets["untracked"] += drift

    off_path = sorted(
        ({"span_id": n.span_id, "name": n.row.get("name"),
          "slack_s": _round(n.slack_s)}
         for n in nodes.values() if n.slack_s is not None),
        key=lambda d: (-d["slack_s"], d["span_id"]))
    starts = [n.start for n in nodes.values()]
    ends = [n.end for n in nodes.values()]
    return {
        "trace_id": trace_id if trace_id is not None
        else root.row.get("trace_id"),
        "root": root.row.get("name"),
        "start": _round(root.start),
        "end": _round(root.end),
        "wall_s": _round(max(ends) - min(starts)),
        "path_s": _round(path_s),
        "buckets": {b: _round(buckets[b]) for b in BUCKETS},
        "nodes": rendered,
        "off_path": off_path,
        "on_path_span_ids": [n.span_id for n in path_nodes],
        "on_path_task_ids": sorted(
            {n.row.get("task_id") for n in path_nodes
             if n.row.get("task_id")}),
    }


def on_path_span_ids(rows: List[Dict[str, Any]]) -> Dict[str, set]:
    """{trace_id: set(span ids on the critical path)} for every trace in
    ``rows`` — the OTLP export's ``ray_tpu_torch.on_critical_path`` source."""
    by_trace: Dict[str, List[dict]] = {}
    for row in rows:
        tid = row.get("trace_id")
        if tid is not None:
            by_trace.setdefault(tid, []).append(row)
    out: Dict[str, set] = {}
    for tid, trace_rows in by_trace.items():
        try:
            out[tid] = set(compute(trace_rows, tid)["on_path_span_ids"])
        except ValueError:
            out[tid] = set()
    return out


# ------------------------------------------------- train-step reconciliation

def train_step(rows: List[Dict[str, Any]], step: int,
               experiment: Optional[str] = None) -> Dict[str, Any]:
    """Per-step breakdown of a pipeline training step from the CPATH
    annotations each StageExecutor emits (one per stage per step), with the
    critical stage's bucket attribution reconciled against its BubbleClock.

    The stages of one step run concurrently, so the step's critical path is
    the stage whose wall was longest; its recv waits are the bubble that
    bounded the step.
    """
    stages = []
    for row in rows:
        cp = row.get("cpath")
        if not cp or cp.get("kind") != "train_step":
            continue
        if int(cp.get("step", -1)) != int(step):
            continue
        if experiment is not None and cp.get("experiment") != experiment:
            continue
        stages.append(cp)
    if not stages:
        raise ValueError(
            f"no train_step stamps for step {step}"
            + (f" experiment {experiment!r}" if experiment else ""))
    stages.sort(key=lambda c: (c.get("experiment") or "",
                               int(c.get("stage", 0))))

    rendered = []
    for cp in stages:
        buckets = {b: 0.0 for b in BUCKETS}
        for kind, _start, dur, comm_s in cp.get("ops", []):
            comm = min(max(comm_s, 0.0), dur)
            buckets["collective-comm"] += comm
            buckets[_OP_BUCKET.get(kind, "exec")] += dur - comm
        wall = float(cp.get("wall_s", 0.0))
        accounted = sum(buckets.values())
        if wall > accounted:
            buckets["untracked"] += wall - accounted
        rendered.append({
            "experiment": cp.get("experiment"),
            "stage": int(cp.get("stage", 0)),
            "wall_s": _round(wall),
            "buckets": {b: _round(v) for b, v in buckets.items()},
            "clock": cp.get("clock") or {},
        })
    crit = max(rendered, key=lambda s: (s["wall_s"], s["stage"]))
    clock = crit.get("clock") or {}
    wall = crit["wall_s"]
    bubble = crit["buckets"]["pipeline-bubble"]
    return {
        "kind": "train_step",
        "step": int(step),
        "experiment": crit.get("experiment"),
        "stages": rendered,
        "critical_stage": crit["stage"],
        "path_s": wall,
        "buckets": crit["buckets"],
        "bubble_fraction": _round(bubble / wall) if wall else 0.0,
        "bubble_clock": {
            "bubble_s": clock.get("bubble_s"),
            "bubble_fraction": clock.get("bubble_fraction"),
            "step_wall_s": clock.get("step_wall_s"),
        },
    }


# --------------------------------------------------- LLM TTFT decomposition

def llm_request(rows: List[Dict[str, Any]], request_id: str
                ) -> Dict[str, Any]:
    """TTFT decomposition of one served LLM request from the CPATH
    annotation the engine emits at first token: admission queue -> prefill
    chunks -> decode -> preemption re-waits.  Buckets sum to the measured
    TTFT by construction."""
    for row in rows:
        cp = row.get("cpath")
        if cp and cp.get("kind") == "llm_request" \
                and cp.get("rid", "").startswith(request_id):
            decomp = dict(cp.get("decomposition") or {})
            buckets = {b: 0.0 for b in BUCKETS}
            buckets["admission-wait"] = decomp.get("admission_wait_s", 0.0)
            buckets["exec"] = decomp.get("prefill_exec_s", 0.0)
            buckets["queue"] = (decomp.get("queue_s", 0.0)
                                + decomp.get("preempt_wait_s", 0.0))
            return {
                "kind": "llm_request",
                "request_id": cp.get("rid"),
                "engine": cp.get("engine"),
                "ttft_s": cp.get("ttft_s"),
                "path_s": _round(sum(buckets.values())),
                "buckets": {b: _round(v) for b, v in buckets.items()},
                "decomposition": decomp,
            }
    raise ValueError(f"no llm_request stamp for request {request_id!r}")


# ------------------------------------------------------------- rendering

def render_tree(result: Dict[str, Any]) -> str:
    """CLI tree view: one line per on-path node with its % of the path."""
    lines = [
        f"critical path: {result.get('root') or result.get('kind')}  "
        f"path={result['path_s']:.6f}s  wall={result.get('wall_s', result['path_s']):.6f}s",
        "buckets: " + "  ".join(
            f"{b}={v:.6f}s" for b, v in result["buckets"].items() if v),
    ]
    for i, n in enumerate(result.get("nodes", [])):
        bucket_s = " ".join(f"{b}={v:.6f}" for b, v in n["buckets"].items())
        bar = "#" * max(int(n["pct_of_path"] / 4), 1 if n["self_s"] else 0)
        lines.append(
            f"  {'  ' * min(i, 8)}{n['name'] or n['span_id'][:12]}  "
            f"self={n['self_s']:.6f}s ({n['pct_of_path']:.1f}%) "
            f"{bar}  [{bucket_s}]")
    for s in result.get("stages", []):
        mark = " <- critical" if s["stage"] == result.get(
            "critical_stage") else ""
        bucket_s = " ".join(f"{b}={v:.6f}"
                            for b, v in s["buckets"].items() if v)
        lines.append(f"  stage {s['stage']}: wall={s['wall_s']:.6f}s "
                     f"[{bucket_s}]{mark}")
    off = result.get("off_path") or []
    if off:
        lines.append("off-path slack:")
        for o in off[:8]:
            lines.append(f"  {o['name'] or o['span_id'][:12]}: "
                         f"slack={o['slack_s']:.6f}s")
    return "\n".join(lines)


def to_json(result: Dict[str, Any]) -> str:
    """Deterministic serialization (sorted keys; floats pre-rounded)."""
    return json.dumps(result, sort_keys=True, separators=(",", ":"))
