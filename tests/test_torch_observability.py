"""The port's observability surface on the CPU: ``_private/taskfold.py``,
``_private/critical_path.py``, ``util/{state,tracing,metrics}.py``,
``dashboard/`` and ``_lint/`` (core and wire contract).

Without a runtime: every case of ``tests/test_critical_path.py`` on the
port's ``compute``, ``train_step`` and ``llm_request``, whose JSON is byte
for byte the JAX package's on the same rows; ``fold_task_events`` equal to
the JAX package's on the same events, shuffled; the live TTFT
decomposition on the port's ``EngineCore(device="cpu")`` (buckets within 5 %
of each request's TTFT); the metrics registry's Prometheus text and the
user-metric API's validation; the port's wire-contract snapshot equal to a
fresh extraction from the port's tree, and no lint checker registered yet.

On one port runtime for the module (``init(num_cpus=4)``, no GPU): the
cases of ``tests/test_state.py``, ``test_tracing.py``,
``test_dashboard.py``, ``test_metrics.py``'s scrape and
``test_library_metrics.py``'s user counter, and the live trace's critical
path with its OTLP export; ``python -m ray_tpu_torch.dashboard`` as a
subprocess answering ``/api/critical_path`` and ``/api/llm`` with no CUDA,
JAX or JAX package in its process.

JAX and the JAX package are imported inside the tests only: the workers
that import this module never load them.
"""

import json
import os
import pathlib
import random
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private import critical_path as cp
from ray_tpu_torch._private.taskfold import fold_task_events
from ray_tpu_torch.util import state

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=256 * 1024 ** 2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


# ============================================== recorded fixture trace
# tests/test_critical_path.py's trace: one driver span (r) with three task
# children and one grandchild; critical chain r -> d -> (gap) -> a -> c,
# b off-path with slack 3.0.

def _fixture_events():
    t = 1_000_000.0  # absolute epoch base; all assertions use deltas
    ev = []

    def emit(task_id, st, ts, **kw):
        e = {"task_id": task_id, "attempt": 0, "state": st,
             "ts": t + ts, "job_id": "j1", "trace_id": "tr-fix"}
        e.update(kw)
        ev.append(e)

    emit("drv", "SUBMITTED", 0.0, name="step_driver", type="USER_SPAN",
         span_id="r")
    emit("drv", "FINISHED", 10.0, name="step_driver", type="USER_SPAN",
         span_id="r")
    emit("ta", "SUBMITTED", 0.5, name="stage_fwd", type="NORMAL_TASK",
         span_id="a", parent_span_id="r")
    emit("ta", "RUNNING", 0.95, name="stage_fwd", type="NORMAL_TASK",
         span_id="a", parent_span_id="r")
    emit("ta", "FINISHED", 6.0, name="stage_fwd", type="NORMAL_TASK",
         span_id="a", parent_span_id="r")
    ev.append({"task_id": "ta", "attempt": 0, "state": "PHASES",
               "ts": t + 6.01, "job_id": "j1",
               "phases": {"driver_serialize": 0.05, "driver_stage": 0.05,
                          "dispatch": 0.4, "exec": 4.5,
                          "result_put": 0.1, "result_wake": 0.2}})
    emit("tb", "SUBMITTED", 0.5, name="short_sibling", type="NORMAL_TASK",
         span_id="b", parent_span_id="r")
    emit("tb", "FINISHED", 3.0, name="short_sibling", type="NORMAL_TASK",
         span_id="b", parent_span_id="r")
    emit("tc", "SUBMITTED", 2.0, name="col_sum", type="NORMAL_TASK",
         span_id="c", parent_span_id="a")
    emit("tc", "FINISHED", 5.5, name="col_sum", type="NORMAL_TASK",
         span_id="c", parent_span_id="a")
    emit("td", "SUBMITTED", 6.0, name="tail_task", type="NORMAL_TASK",
         span_id="d", parent_span_id="r")
    emit("td", "RUNNING", 6.5, name="tail_task", type="NORMAL_TASK",
         span_id="d", parent_span_id="r")
    emit("td", "FINISHED", 9.5, name="tail_task", type="NORMAL_TASK",
         span_id="d", parent_span_id="r")
    return ev


def _compute_fixture(shuffle_seed=None):
    events = _fixture_events()
    if shuffle_seed is not None:
        random.Random(shuffle_seed).shuffle(events)
    return cp.compute(fold_task_events(events), "tr-fix")


def _jax_json(fn_name, rows, *args):
    """The JAX package's ``critical_path.<fn_name>`` on ``rows``, as JSON."""
    from ray_tpu._private import critical_path as jcp

    return jcp.to_json(getattr(jcp, fn_name)(rows, *args))


@pytest.mark.parametrize("shuffle_seed", [None, 7, 1234])
def test_fold_task_events_matches_jax(shuffle_seed):
    from ray_tpu._private.taskfold import PHASE_ORDER as J_ORDER
    from ray_tpu._private.taskfold import fold_task_events as jfold
    from ray_tpu_torch._private.taskfold import PHASE_ORDER

    events = _fixture_events()
    if shuffle_seed is not None:
        random.Random(shuffle_seed).shuffle(events)
    assert PHASE_ORDER == J_ORDER
    assert fold_task_events([dict(e) for e in events]) == \
        jfold([dict(e) for e in events])


def test_fixture_path_bounds_and_chain():
    out = _compute_fixture()
    assert out["path_s"] <= out["wall_s"] + 1e-9
    longest = max(n["dur_s"] for n in out["nodes"])
    assert out["path_s"] >= longest - 1e-9
    assert out["path_s"] == pytest.approx(10.0, abs=1e-6)
    assert out["root"] == "step_driver"
    assert out["on_path_span_ids"] == ["r", "d", "a", "c"]
    assert out["on_path_task_ids"] == ["drv", "ta", "tc", "td"]


def test_fixture_bucket_conservation_and_classification():
    out = _compute_fixture()
    assert sum(out["buckets"].values()) == pytest.approx(
        out["path_s"], abs=5e-6)
    assert set(out["buckets"]) == set(cp.BUCKETS)
    assert out["buckets"]["collective-comm"] == pytest.approx(3.5, abs=1e-6)
    assert out["buckets"]["dispatch"] == pytest.approx(0.1, abs=1e-6)
    assert out["buckets"]["queue"] > 0
    assert out["buckets"]["object-transfer"] > 0
    for b, v in out["buckets"].items():
        per_node = sum(n["buckets"].get(b, 0.0) for n in out["nodes"])
        assert per_node == pytest.approx(v, abs=5e-6)


def test_fixture_off_path_slack():
    out = _compute_fixture()
    slack = {o["span_id"]: o["slack_s"] for o in out["off_path"]}
    assert slack == {"b": pytest.approx(3.0, abs=1e-6)}


def test_fixture_json_is_byte_identical_across_runs_and_to_jax():
    j1 = cp.to_json(_compute_fixture())
    j2 = cp.to_json(_compute_fixture(shuffle_seed=7))
    j3 = cp.to_json(_compute_fixture(shuffle_seed=1234))
    assert j1 == j2 == j3
    json.loads(j1)
    from ray_tpu._private.taskfold import fold_task_events as jfold

    assert j1 == _jax_json("compute", jfold(_fixture_events()), "tr-fix")


def test_render_tree_shows_percent_and_slack():
    text = cp.render_tree(_compute_fixture())
    assert "critical path: step_driver" in text
    assert "col_sum" in text and "tail_task" in text
    assert "%" in text
    assert "off-path slack:" in text and "short_sibling" in text


def test_no_finished_spans_raises():
    rows = fold_task_events([
        {"task_id": "x", "attempt": 0, "state": "RUNNING", "ts": 1.0,
         "trace_id": "tr-run", "span_id": "x"},
    ])
    with pytest.raises(ValueError, match="no finished spans"):
        cp.compute(rows, "tr-run")
    with pytest.raises(ValueError):
        cp.compute([], "tr-empty")


def test_on_path_span_ids_multi_trace():
    events = _fixture_events()
    events.append({"task_id": "oz", "attempt": 0, "state": "SUBMITTED",
                   "ts": 1_000_100.0, "trace_id": "tr-other",
                   "span_id": "z"})
    events.append({"task_id": "oz", "attempt": 0, "state": "FINISHED",
                   "ts": 1_000_101.0, "trace_id": "tr-other",
                   "span_id": "z"})
    by_trace = cp.on_path_span_ids(fold_task_events(events))
    assert by_trace["tr-fix"] == {"r", "d", "a", "c"}
    assert by_trace["tr-other"] == {"z"}


def test_retried_attempt_keeps_latest_ending_span():
    events = _fixture_events()
    events.append({"task_id": "td", "attempt": 1, "state": "SUBMITTED",
                   "ts": 1_000_005.0, "trace_id": "tr-fix", "span_id": "d",
                   "name": "tail_task", "parent_span_id": "r"})
    events.append({"task_id": "td", "attempt": 1, "state": "FAILED",
                   "ts": 1_000_005.5, "trace_id": "tr-fix", "span_id": "d",
                   "name": "tail_task", "parent_span_id": "r"})
    rows = fold_task_events(events)
    out = cp.compute(rows, "tr-fix")
    d = next(n for n in out["nodes"] if n["span_id"] == "d")
    assert d["end"] - d["start"] == pytest.approx(3.5, abs=1e-6)
    from ray_tpu._private.taskfold import fold_task_events as jfold

    assert cp.to_json(out) == _jax_json("compute", jfold(events), "tr-fix")


# =============================================== train-step reconciliation
def _train_stamp(stage, wall, ops, clock):
    return {"cpath": {
        "kind": "train_step", "experiment": "exp1", "stage": stage,
        "step": 3, "t0": 0.0, "wall_s": wall, "ops": ops, "clock": clock}}


def _train_rows():
    ops0 = [["fwd", 0.0, 0.4, 0.0], ["send_act", 0.4, 0.1, 0.0],
            ["recv_grad", 0.5, 0.2, 0.0], ["bwd", 0.7, 0.5, 0.0],
            ["optim", 1.2, 0.1, 0.05]]
    ops1 = [["recv_act", 0.0, 0.5, 0.0], ["fwd", 0.5, 0.4, 0.0],
            ["bwd", 0.9, 0.5, 0.0], ["send_grad", 1.4, 0.1, 0.0],
            ["optim", 1.5, 0.2, 0.1]]
    clock1 = {"step_wall_s": 1.7, "busy_s": 1.1, "xfer_s": 0.1,
              "bubble_s": 0.5, "bubble_fraction": round(0.5 / 1.7, 6),
              "comm_s": 0.1}
    return [_train_stamp(0, 1.3, ops0, {"step_wall_s": 1.3, "busy_s": 1.0,
                                        "xfer_s": 0.1, "bubble_s": 0.2,
                                        "bubble_fraction": round(0.2 / 1.3, 6),
                                        "comm_s": 0.05}),
            _train_stamp(1, 1.7, ops1, clock1)]


def test_train_step_reconciles_with_bubble_clock():
    rows = _train_rows()
    out = cp.train_step(rows, 3, "exp1")
    assert out["critical_stage"] == 1
    assert out["path_s"] == pytest.approx(1.7, abs=1e-6)
    assert sum(out["buckets"].values()) == pytest.approx(1.7, abs=5e-6)
    assert out["buckets"]["pipeline-bubble"] == pytest.approx(0.5, abs=1e-6)
    assert out["buckets"]["collective-comm"] == pytest.approx(0.1, abs=1e-6)
    assert abs(out["bubble_fraction"]
               - out["bubble_clock"]["bubble_fraction"]) < 0.15
    assert [s["stage"] for s in out["stages"]] == [0, 1]
    assert cp.to_json(out) == cp.to_json(cp.train_step(rows, 3, "exp1"))
    assert cp.to_json(out) == _jax_json("train_step", _train_rows(), 3,
                                        "exp1")


def test_train_step_missing_raises():
    with pytest.raises(ValueError, match="no train_step stamps"):
        cp.train_step([], 0)


# ================================================= LLM TTFT decomposition
def _llm_rows():
    decomp = {"request_id": "abc123", "ttft_s": 0.9,
              "admission_wait_s": 0.2, "queue_s": 0.25,
              "prefill_exec_s": 0.4, "preempt_wait_s": 0.05,
              "chunks": 2, "preemptions": 1}
    return [{"cpath": {"kind": "llm_request", "rid": "abc123",
                       "engine": "e1", "ttft_s": 0.9,
                       "decomposition": decomp}}]


def test_llm_request_buckets_sum_to_ttft():
    rows = _llm_rows()
    out = cp.llm_request(rows, "abc")  # prefix match
    assert out["request_id"] == "abc123"
    assert out["path_s"] == pytest.approx(0.9, abs=1e-6)
    assert sum(out["buckets"].values()) == pytest.approx(0.9, abs=5e-6)
    assert out["buckets"]["admission-wait"] == pytest.approx(0.2)
    assert out["buckets"]["queue"] == pytest.approx(0.3)  # queue + preempt
    assert out["buckets"]["exec"] == pytest.approx(0.4)
    assert cp.to_json(out) == _jax_json("llm_request", _llm_rows(), "abc")
    with pytest.raises(ValueError, match="no llm_request stamp"):
        cp.llm_request(rows, "zzz")


def test_live_ttft_decomposition_sums_within_5pct():
    """8 concurrent streams on a page-tight engine on the CPU (preemptions
    guaranteed): every request's buckets sum to its TTFT within 5 %."""
    from ray_tpu_torch.llm.engine import EngineCore

    core = EngineCore(num_pages=6, page_size=2, seed=3,
                      engine_name="cpath-ttft", device="cpu")
    rids = [core.submit([3 + i, 5, 7], {"max_tokens": 6},
                        admission_wait_s=0.01 * i) for i in range(8)]
    core.run_until_done(rids)
    assert core.stats()["preemptions"] >= 1
    for i, rid in enumerate(rids):
        d = core.ttft_decomposition(rid)
        parts = (d["admission_wait_s"] + d["queue_s"]
                 + d["prefill_exec_s"] + d["preempt_wait_s"])
        assert parts == pytest.approx(d["ttft_s"],
                                      rel=0.05, abs=1e-4), (rid, d)
        assert d["admission_wait_s"] == pytest.approx(0.01 * i, abs=1e-6)
        assert d["chunks"] >= 1
    core.cache.check_leaks()


# ====================================================== metrics and lint
def test_registry_and_prometheus_text():
    from ray_tpu_torch._private.metrics import (Counter, Gauge, Histogram,
                                                Registry)

    reg = Registry()
    c = Counter("requests_total", "total requests", registry=reg)
    g = Gauge("temperature", registry=reg)
    h = Histogram("latency_s", boundaries=[0.1, 1.0], registry=reg)
    c.inc(3, {"route": "/a"})
    c.inc(1, {"route": "/b"})
    g.set(42.5)
    h.observe(0.05)
    h.observe(0.5)
    h.observe(5.0)
    text = reg.prometheus_text()
    assert 'ray_tpu_requests_total{route="/a"} 3.0' in text
    assert "# TYPE ray_tpu_requests_total counter" in text
    assert "ray_tpu_temperature 42.5" in text
    assert 'ray_tpu_latency_s_bucket{le="0.1"} 1.0' in text
    assert 'ray_tpu_latency_s_bucket{le="+Inf"} 3.0' in text
    assert "ray_tpu_latency_s_count 3.0" in text
    with pytest.raises(ValueError):
        c.inc(-1)


def test_user_metrics_api_validation():
    from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

    with pytest.raises(ValueError):
        Counter("bad name")
    with pytest.raises(ValueError):
        Counter("ray_tpu_already_prefixed")
    with pytest.raises(TypeError):
        Counter("tags_typed", "d", tag_keys="shard")  # str, not tuple

    c = Counter("um_validated_total", "validated ops",
                tag_keys=("shard", "kind"))
    assert c.info["tag_keys"] == ("shard", "kind")
    with pytest.raises(ValueError):
        c.inc(1)
    with pytest.raises(ValueError):
        c.inc(1, tags={"shard": "a"})
    with pytest.raises(ValueError):
        c.inc(1, tags={"shard": "a", "kind": "b", "extra": "x"})
    with pytest.raises(ValueError):
        c.inc(0, tags={"shard": "a", "kind": "b"})
    c.set_default_tags({"kind": "write"})
    c.inc(2, tags={"shard": "a"})
    assert dict(c._inner.samples()) == {
        (("kind", "write"), ("shard", "a")): 2.0}

    g = Gauge("um_level", "level")
    g.set(5)
    g.dec(2)
    assert dict(g._inner.samples()) == {(): 3.0}

    with pytest.raises(ValueError):
        Histogram("um_bad_bounds", "d", boundaries=[0.5, 0.1])
    h = Histogram("um_lat_seconds", "latency", boundaries=[0.1, 1.0],
                  tag_keys=("route",)).set_default_tags({"route": "/"})
    h.observe(0.05)
    assert h.boundaries == [0.1, 1.0]


def test_wire_contract_snapshot_is_the_ports_tree():
    """``_lint/wire_contract.json`` is the copy's extraction from the
    port's own tree, byte for byte; the eight checkers are registered."""
    from ray_tpu_torch import _lint
    from ray_tpu_torch._lint import wire_contract as wc

    files = _lint.collect_files([str(REPO / "ray_tpu_torch")])
    contract = wc.extract_contract(files)
    with open(wc.DEFAULT_SNAPSHOT, encoding="utf-8") as fh:
        assert fh.read() == wc.contract_json(contract)
    assert {"assign_cards", "add_task_events", "get_task_events"} <= set(
        contract["methods"])
    assert sorted(_lint.all_checkers()) == [
        "async-blocking", "collective-timeout", "config-drift",
        "graph-capture-hygiene", "lock-discipline", "metrics-hygiene",
        "no-flatten", "wire-contract"]
    assert _lint.run_lint(files=files, baseline=None).findings == []


# ==================================================== on a port runtime
@ray_tpu_torch.remote
def _tracked_add(a, b):
    return a + b


@ray_tpu_torch.remote
def _tracked_fail():
    raise ValueError("observable failure")


@ray_tpu_torch.remote
class _Counter:
    def __init__(self):
        self.n = 0

    def incr(self):
        self.n += 1
        return self.n


def _wait_for_tasks(predicate, timeout=40.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rows = state.list_tasks(limit=10_000)
        if predicate(rows):
            return rows
        time.sleep(0.3)
    raise TimeoutError("task events did not arrive")


def test_task_events_flow_to_state_api(runtime):
    assert ray_tpu_torch.get(_tracked_add.remote(20, 22)) == 42
    with pytest.raises(ValueError):
        ray_tpu_torch.get(_tracked_fail.remote())
    rows = _wait_for_tasks(lambda rows: any(
        r["name"] == "_tracked_add" and r["state"] == "FINISHED"
        and {"SUBMITTED", "RUNNING", "FINISHED"} <= set(r["state_ts"])
        for r in rows) and any(
        r["name"] == "_tracked_fail" and r["state"] == "FAILED"
        for r in rows))
    ok = next(r for r in rows if r["name"] == "_tracked_add"
              and r["state"] == "FINISHED")
    assert ok["state_ts"]["SUBMITTED"] <= ok["state_ts"]["RUNNING"] \
        <= ok["state_ts"]["FINISHED"]
    assert ok["type"] == "NORMAL_TASK"
    assert ok["node_id"] and ok["worker_id"]
    failed = next(r for r in rows if r["name"] == "_tracked_fail")
    assert "observable failure" in failed.get("error", "")
    summary = state.summarize_tasks()
    assert summary["_tracked_add"]["FINISHED"] >= 1
    assert summary["_tracked_fail"]["FAILED"] >= 1


def test_actor_task_events(runtime):
    c = _Counter.remote()
    assert ray_tpu_torch.get(c.incr.remote()) == 1
    rows = _wait_for_tasks(lambda rows: any(
        r["name"] == "incr" and r["state"] == "FINISHED" for r in rows))
    incr = next(r for r in rows if r["name"] == "incr")
    assert incr["type"] == "ACTOR_TASK"
    assert incr["actor_id"]
    creation = [r for r in rows if r["type"] == "ACTOR_CREATION_TASK"
                and r["actor_id"] == incr["actor_id"]]
    assert creation, "actor creation must be tracked too"
    ray_tpu_torch.kill(c)


def test_timeline_dump(runtime, tmp_path):
    ray_tpu_torch.get([_tracked_add.remote(i, i) for i in range(3)])
    _wait_for_tasks(lambda rows: sum(
        1 for r in rows if r["name"] == "_tracked_add"
        and r["state"] == "FINISHED") >= 3)
    out = tmp_path / "timeline.json"
    events = state.timeline(str(out))
    assert any(e["name"] == "_tracked_add" for e in events)
    loaded = json.loads(out.read_text())
    ev = next(e for e in loaded if e["name"] == "_tracked_add")
    assert ev["ph"] == "X" and ev["dur"] >= 1.0 and ev["ts"] > 0


def test_entity_listings(runtime):
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    nodes = state.list_nodes()
    assert nodes and nodes[0]["state"] == "ALIVE"
    assert "CPU" in nodes[0]["resources_total"]
    c = _Counter.options(name="state-test-actor").remote()
    ray_tpu_torch.get(c.incr.remote())
    actors = state.list_actors()
    assert any(a.get("name") == "state-test-actor" for a in actors)
    pg = placement_group([{"CPU": 1}], name="state-test-pg")
    assert pg.ready(timeout=30)
    pgs = state.list_placement_groups()
    mine = next(p for p in pgs if p.get("name") == "state-test-pg")
    assert mine["state"] == "CREATED"
    remove_placement_group(pg)
    ref = ray_tpu_torch.put(np.zeros(1024 * 1024, np.uint8))  # plasma-sized
    time.sleep(0.5)
    objs = state.list_objects()
    assert any(o["object_id"] == ref.oid.hex() for o in objs)
    del ref
    assert state.list_jobs()
    ray_tpu_torch.kill(c)


@ray_tpu_torch.remote
class _Leaf:
    def work(self, x):
        return x + 1


@ray_tpu_torch.remote
def _inner():
    ctx = ray_tpu_torch.get_runtime_context()
    return ctx.get_trace_id(), ctx.get_span_id()


@ray_tpu_torch.remote
def _outer(leaf):
    ctx = ray_tpu_torch.get_runtime_context()
    nested = ray_tpu_torch.get(_inner.remote())
    actor_val = ray_tpu_torch.get(leaf.work.remote(1))
    return ctx.get_trace_id(), ctx.get_span_id(), nested, actor_val


def test_trace_spans_propagate_through_nesting(runtime):
    leaf = _Leaf.options(num_cpus=0.1).remote()
    trace_id, root_span, (inner_trace, inner_span), actor_val = \
        ray_tpu_torch.get(_outer.remote(leaf), timeout=60)
    assert actor_val == 2
    assert trace_id and root_span
    assert inner_trace == trace_id
    assert inner_span != root_span

    def short(name):
        return (name or "").split(".")[-1]

    deadline = time.monotonic() + 60
    spans = []
    while time.monotonic() < deadline:
        spans = state.get_trace(trace_id)
        names = {short(s["name"]) for s in spans}
        if {"_outer", "_inner", "work"} <= names and all(
                s["end"] is not None for s in spans
                if short(s["name"]) in ("_outer", "_inner", "work")):
            break
        time.sleep(0.5)
    by_name = {short(s["name"]): s for s in spans}
    assert {"_outer", "_inner", "work"} <= set(by_name), spans
    assert by_name["_inner"]["parent_span_id"] == \
        by_name["_outer"]["span_id"]
    assert by_name["work"]["parent_span_id"] == by_name["_outer"]["span_id"]
    assert by_name["_outer"]["parent_span_id"] is None
    t2, _s, _n, _a = ray_tpu_torch.get(_outer.remote(leaf), timeout=60)
    assert t2 != trace_id
    ray_tpu_torch.kill(leaf)


@ray_tpu_torch.remote
class _Held:
    def ping(self):
        return 1


def test_list_workers(runtime):
    a = _Held.options(num_cpus=0.1).remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=60) == 1
    workers = state.list_workers()
    assert workers and all("pid" in w and "state" in w for w in workers)
    actors = [w for w in workers if w["is_actor"]]
    assert actors, workers
    assert any(w["actor_id"] for w in actors)
    assert all(w["node_id"] for w in workers)
    ray_tpu_torch.kill(a)


def test_summarize_rpc_cross_checks_wire_contract(runtime):
    assert ray_tpu_torch.get(_tracked_add.remote(20, 22)) == 42
    summary = state.summarize_rpc()
    methods = summary["methods"]
    assert methods, "no RPC handler stats (event_stats defaults on)"
    served_by = {s for row in methods.values() for s in row["servers"]}
    assert "gcs" in served_by
    assert summary["contract_methods"] >= 100
    assert summary["unknown"] == [], summary["unknown"]
    row = methods[sorted(methods)[0]]
    assert row["count"] >= 1 and row["total_s"] >= 0.0


@ray_tpu_torch.remote
def _traced_child(x):
    return x * 2


def test_trace_span_parents_tasks_and_exports_otlp(runtime, tmp_path):
    from ray_tpu_torch.util.tracing import export_otlp, trace_span

    with trace_span("my-pipeline", {"rows": 7}) as span:
        assert span.trace_id and span.span_id
        out = ray_tpu_torch.get(_traced_child.remote(21), timeout=60)
        assert out == 42
        span.set_attribute("result", out)
        tid = span.trace_id
    deadline = time.time() + 30
    while time.time() < deadline:
        spans = state.get_trace(tid)
        names = {s["name"].rsplit(".", 1)[-1] for s in spans}
        if {"my-pipeline", "_traced_child"} <= names and all(
                s["end"] is not None for s in spans
                if s["name"].rsplit(".", 1)[-1] in ("my-pipeline",
                                                    "_traced_child")):
            break
        time.sleep(0.3)
    spans = state.get_trace(tid)
    by_name = {s["name"].rsplit(".", 1)[-1]: s for s in spans}
    assert "my-pipeline" in by_name and "_traced_child" in by_name, by_name
    assert by_name["_traced_child"]["parent_span_id"] == \
        by_name["my-pipeline"]["span_id"]
    path = tmp_path / "trace.json"
    assert export_otlp(str(path), trace_id=tid) >= 2
    doc = json.loads(path.read_text())
    otlp_spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
    assert all(s["traceId"] == tid for s in otlp_spans)
    mine = next(s for s in otlp_spans if s["name"] == "my-pipeline")
    assert {"rows", "result"} <= {a["key"] for a in mine["attributes"]}
    child = next(s for s in otlp_spans
                 if s["name"].endswith("_traced_child"))
    assert child["parentSpanId"] == mine["spanId"]
    assert int(mine["endTimeUnixNano"]) >= int(mine["startTimeUnixNano"])


def test_trace_span_failure_status(runtime, tmp_path):
    from ray_tpu_torch.util.tracing import export_otlp, trace_span

    with pytest.raises(RuntimeError):
        with trace_span("exploding") as span:
            tid = span.trace_id
            raise RuntimeError("kaboom")
    path = tmp_path / "fail.json"
    assert export_otlp(str(path), trace_id=tid) >= 1
    doc = json.loads(path.read_text())
    spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
    bad = next(s for s in spans if s["name"] == "exploding")
    assert bad["status"]["code"] == 2
    assert "kaboom" in bad["status"]["message"]


@ray_tpu_torch.remote
def _cpath_child(x):
    time.sleep(0.05)
    return x + 1


def _wait_for_cpath(tid, names, timeout=30):
    deadline = time.time() + timeout
    out = None
    while time.time() < deadline:
        try:
            out = state.critical_path(trace_id=tid)
            if names <= {n["name"].rsplit(".", 1)[-1] for n in out["nodes"]}:
                return out
        except ValueError:
            pass
        time.sleep(0.3)
    return out


def test_state_critical_path_on_real_trace(runtime, tmp_path):
    from ray_tpu_torch.util.tracing import export_otlp, trace_span

    with trace_span("cpath-e2e") as span:
        tid = span.trace_id
        assert ray_tpu_torch.get(_cpath_child.remote(1), timeout=60) == 2
    out = _wait_for_cpath(tid, {"cpath-e2e", "_cpath_child"})
    assert out is not None, "critical path never materialized"
    assert sum(out["buckets"].values()) == pytest.approx(
        out["path_s"], abs=5e-6)
    assert out["path_s"] <= out["wall_s"] + 1e-9
    assert "_cpath_child" in cp.render_tree(out)
    path = tmp_path / "cpath.json"
    assert export_otlp(str(path), trace_id=tid) >= 2
    doc = json.loads(path.read_text())
    spans = doc["resourceSpans"][0]["scopeSpans"][0]["spans"]
    tagged = [s["name"] for s in spans if any(
        a["key"] == "ray_tpu_torch.on_critical_path"
        for a in s["attributes"])]
    assert tagged, "no span carried ray_tpu_torch.on_critical_path"
    with pytest.raises(ValueError):
        state.critical_path()
    with pytest.raises(ValueError):
        state.critical_path(trace_id=tid, step=1)


# ------------------------------------------------------------- metrics
def _nodelet_text():
    core = ray_tpu_torch._private.worker.require_core()
    return core.io.run(core.nodelet_conn.call("get_metrics_text", None))


def _poll_text(needle, timeout=30.0):
    deadline = time.monotonic() + timeout
    text = ""
    while time.monotonic() < deadline:
        text = _nodelet_text()
        if needle in text:
            break
        time.sleep(0.3)
    return text


@ray_tpu_torch.remote
def _bump():
    from ray_tpu_torch.util.metrics import Counter

    Counter("app_things_done", "things").inc(5, {"kind": "test"})
    time.sleep(0.1)
    return True


def test_node_scrape_endpoint_and_worker_push(runtime):
    assert ray_tpu_torch.get(_bump.remote(), timeout=60)
    core = ray_tpu_torch._private.worker.require_core()
    assert "ray_tpu_node_resources_total" in _poll_text(
        "ray_tpu_node_resources_total")
    text = _poll_text("app_things_done")
    assert 'ray_tpu_app_things_done{kind="test",source="worker-' in text
    view = core.io.run(core.gcs_conn.call("get_cluster_view", None))
    scraped = False
    for n in view:
        ma = n.get("metrics_addr")
        if ma:
            with urllib.request.urlopen(
                    f"http://{ma[0]}:{ma[1]}/metrics", timeout=10) as resp:
                assert "ray_tpu_node_resources_total" in resp.read().decode()
            scraped = True
    assert scraped, "no node exposed a metrics endpoint"


@ray_tpu_torch.remote
def _widgets():
    from ray_tpu_torch.util.metrics import Counter

    c = Counter("um_task_widgets_total", "widgets made",
                tag_keys=("stage",))
    c.inc(7, tags={"stage": "etl"})
    time.sleep(0.1)  # outlive the increment so a push tick sees it
    return True


def test_user_counter_roundtrip_from_task(runtime):
    assert ray_tpu_torch.get(_widgets.remote(), timeout=60)
    text = _poll_text("um_task_widgets_total")
    assert 'ray_tpu_um_task_widgets_total{stage="etl",source="worker-' \
        in text


# ------------------------------------------------------------- dashboard
def _start_dashboard():
    """Run a Dashboard on a daemon thread; returns (dash, port)."""
    import asyncio

    from ray_tpu_torch.dashboard import Dashboard

    core = ray_tpu_torch._private.worker.require_core()
    dash = Dashboard(tuple(core._gcs_addr))
    port_holder = {}
    started = threading.Event()

    def run_loop():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)

        async def main():
            port_holder["port"] = await dash.serve(port=0)
            started.set()
            await asyncio.Event().wait()

        try:
            loop.run_until_complete(main())
        except RuntimeError:
            pass

    threading.Thread(target=run_loop, daemon=True).start()
    assert started.wait(30)
    return dash, port_holder["port"]


def _getter(port):
    def get(path):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return json.loads(r.read())
    return get


@ray_tpu_torch.remote
class _Marker:
    def ping(self):
        return 1


def test_dashboard_endpoints(runtime):
    dash, port = _start_dashboard()
    get = _getter(port)
    m = _Marker.options(name="dash-marker", num_cpus=0.1).remote()
    assert ray_tpu_torch.get(m.ping.remote(), timeout=30) == 1
    nodes = get("/api/nodes")
    assert nodes and any(n["alive"] for n in nodes)
    assert any(a.get("name") == "dash-marker" for a in get("/api/actors"))
    assert "pending_demand" in get("/api/cluster_status")
    assert isinstance(get("/api/jobs"), list)
    deadline = time.time() + 30
    while time.time() < deadline:
        tasks = get("/api/tasks?limit=1000")
        if any(t["name"] == "ping" and t["state"] == "FINISHED"
               for t in tasks):
            break
        time.sleep(0.5)
    else:
        raise AssertionError("Marker.ping never FINISHED in /api/tasks")
    assert "ping" in get("/api/task_summary")
    metrics = get("/api/node_metrics")
    alive = [n for n in nodes if n["alive"]]
    assert any(n["node_id"] in metrics for n in alive)
    some = next(iter(metrics.values()))
    assert some["mem_frac"] is None or 0 <= some["mem_frac"] <= 1
    node_id = alive[0]["node_id"]
    files = get(f"/api/logs?node_id={node_id}")
    assert isinstance(files, list) and files, "no log files listed"
    assert "text" in get(f"/api/log?node_id={node_id}&name={files[0]['name']}")
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
        assert b"ray_tpu_torch" in r.read()
    ray_tpu_torch.kill(m)


def test_history_endpoint_shapes(runtime):
    dash, port = _start_dashboard()
    get = _getter(port)
    dash._history.clear()
    out = get("/api/history")
    assert isinstance(out["interval_s"], (int, float))
    assert out["samples"] == []
    dash._history.clear()
    dash._history.append({"ts": time.time(), "nodes": {}, "tasks": {}})
    dash._history.append({
        "ts": time.time(), "nodes": {"n1": {"cpu_frac": 0.5}},
        "tasks": {"RUNNING": 2},
        "serve": {"a/D": {"requests": 3, "queue": 1, "replicas": 1}},
        "data": {}, "train": {},
    })
    out = get("/api/history")
    assert len(out["samples"]) == 2
    assert "serve" not in out["samples"][0]
    assert out["samples"][1]["serve"]["a/D"]["requests"] == 3
    assert out["samples"][1]["nodes"]["n1"]["cpu_frac"] == 0.5
    assert isinstance(get("/api/serve"), dict)
    assert set(get("/api/data")) == {"operators", "pipelines"}
    assert isinstance(get("/api/train"), dict)
    assert isinstance(get("/api/llm"), dict)


def test_state_log_api(runtime):
    files = state.list_logs()
    assert isinstance(files, list)
    if files:
        assert isinstance(state.get_log(files[0]["name"], tail=1024), str)


@ray_tpu_torch.remote
def _dash_cpath_child(x):
    return x * 3


def test_critical_path_and_flamegraph_endpoints(runtime):
    from ray_tpu_torch._private.profiler import parse_collapsed
    from ray_tpu_torch.util.tracing import trace_span

    dash, port = _start_dashboard()
    get = _getter(port)
    with trace_span("dash-cpath") as span:
        tid = span.trace_id
        assert ray_tpu_torch.get(_dash_cpath_child.remote(2),
                                 timeout=30) == 6
    deadline = time.time() + 30
    out = None
    while time.time() < deadline:
        try:
            out = get(f"/api/critical_path?trace_id={tid}")
        except urllib.error.HTTPError:
            out = None  # 500 until the trace's spans all land
        if out and {"dash-cpath", "_dash_cpath_child"} <= {
                n["name"].rsplit(".", 1)[-1] for n in out["nodes"]}:
            break
        time.sleep(0.5)
    assert out is not None, "critical_path endpoint never served the trace"
    assert abs(sum(out["buckets"].values()) - out["path_s"]) < 5e-6
    assert out["on_path_span_ids"]
    flame = get("/api/flamegraph")
    assert isinstance(flame["collapsed"], list)
    parse_collapsed(flame["collapsed"])
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/flamegraph.svg", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("image/svg+xml")
        assert r.read().startswith(b"<svg")


def test_hangs_and_stacks_endpoints(runtime):
    dash, port = _start_dashboard()
    get = _getter(port)
    hangs = get("/api/hangs")
    assert isinstance(hangs, list)
    for h in hangs:
        assert {"task_id", "elapsed_s", "stack"} <= set(h)
    stacks = get("/api/stacks")
    assert isinstance(stacks, list) and stacks
    for node in stacks:
        assert "node_id" in node and "workers" in node
        for w in node["workers"]:
            assert isinstance(w["threads"], list)


_PROBE = """
import sys, runpy, threading, os
sys.argv = ["ray_tpu_torch.dashboard"] + sys.argv[1:]
def report():
    import time
    while not os.path.exists(os.environ["PROBE_ASK"]):
        time.sleep(0.05)
    torch = sys.modules.get("torch")
    with open(os.environ["PROBE_OUT"], "w") as fh:
        fh.write(repr(({m.split(".")[0] for m in list(sys.modules)},
                       torch is not None and torch.cuda.is_initialized())))
threading.Thread(target=report, daemon=True).start()
runpy.run_module("ray_tpu_torch.dashboard", run_name="__main__")
"""


def test_dashboard_process_answers_critical_path(runtime, tmp_path):
    """``python -m ray_tpu_torch.dashboard --address ...`` as a process of
    its own: ``/api/critical_path`` serves a trace, ``/api/llm`` answers,
    and the process holds no JAX, no JAX package and no CUDA."""
    from ray_tpu_torch.util.tracing import trace_span

    core = ray_tpu_torch._private.worker.require_core()
    host, port = core._gcs_addr
    env = dict(os.environ, PYTHONPATH=str(REPO),
               PROBE_ASK=str(tmp_path / "ask"),
               PROBE_OUT=str(tmp_path / "out"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _PROBE, "--address", f"{host}:{port}",
         "--port", "0"], env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("DASHBOARD_PORT "), line
        get = _getter(int(line.split()[1]))
        with trace_span("dash-proc") as span:
            tid = span.trace_id
            assert ray_tpu_torch.get(_dash_cpath_child.remote(3),
                                     timeout=30) == 9
        deadline = time.time() + 30
        out = None
        while time.time() < deadline:
            try:
                out = get(f"/api/critical_path?trace_id={tid}")
            except urllib.error.HTTPError:
                out = None
            if out and "dash-proc" in {n["name"] for n in out["nodes"]}:
                break
            time.sleep(0.5)
        assert out is not None and out["path_s"] > 0
        direct = state.critical_path(trace_id=tid)
        assert (out["path_s"], out["buckets"]) == (direct["path_s"],
                                                   direct["buckets"])
        assert isinstance(get("/api/llm"), dict)
        (tmp_path / "ask").touch()
        deadline = time.time() + 30
        while not (tmp_path / "out").exists() and time.time() < deadline:
            time.sleep(0.1)
        time.sleep(0.2)
        packages, cuda_up = eval((tmp_path / "out").read_text())
        assert not packages & {"jax", "jaxlib", "flax", "optax", "ray_tpu"}
        assert cuda_up is False
    finally:
        proc.kill()
        proc.wait(30)
