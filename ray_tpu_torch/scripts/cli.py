"""Port of ``ray_tpu/scripts/cli.py``.

ray_tpu_torch command-line interface.

Reference: python/ray/scripts/scripts.py (`ray start` :571, `ray stop`,
`ray status`) and the `ray job` CLI (dashboard/modules/job/cli.py), condensed
to argparse (zero extra deps).  `start --head` launches a detached cluster
whose address lands in both RAY_TPU_TORCH_ADDRESS guidance and a well-known file so
later shells (and `ray_tpu_torch.init()` inside jobs) can find it.

Usage:
    python -m ray_tpu_torch start --head [--num-cpus N] [--resources JSON]
    python -m ray_tpu_torch start --address HOST:PORT [--num-cpus N]
    python -m ray_tpu_torch status [--address HOST:PORT]
    python -m ray_tpu_torch stop
    python -m ray_tpu_torch job submit [--address A] -- CMD...
    python -m ray_tpu_torch job list/status/logs/stop [ID]
    python -m ray_tpu_torch lint [PATHS...] [--json] [--baseline PATH]
    python -m ray_tpu_torch timeline [--output PATH]
    python -m ray_tpu_torch profile [--name TASK]
    python -m ray_tpu_torch summary tasks|serve|data|train|llm|rllib|hangs
    python -m ray_tpu_torch stack [TASK_ID] [--node NODE_ID]
    python -m ray_tpu_torch logs FILE --follow
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ray_tpu_torch._private.config import temp_root

_ADDR_FILE = os.path.join(
    temp_root(), "current_cluster")


def _resolve_address(explicit: str = None) -> str:
    addr = explicit or os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if addr:
        return addr
    try:
        with open(_ADDR_FILE) as f:
            rec = json.load(f)
        return rec["address"]
    except (OSError, ValueError, KeyError):
        raise SystemExit(
            "no running cluster found: pass --address, set RAY_TPU_TORCH_ADDRESS, "
            "or `ray_tpu_torch start --head` first")


def _cmd_start(args) -> int:
    from ray_tpu_torch._private.node import Node

    resources = json.loads(args.resources) if args.resources else {}
    if args.num_cpus is not None:
        resources["CPU"] = float(args.num_cpus)
    if args.head:
        node = Node(head=True, resources=resources or None,
                    object_store_memory=args.object_store_memory)
        node.start()
        address = f"{node.gcs_addr[0]}:{node.gcs_addr[1]}"
        os.makedirs(os.path.dirname(_ADDR_FILE), exist_ok=True)
        with open(_ADDR_FILE, "w") as f:
            json.dump({"address": address,
                       "session_dir": node.session_dir,
                       "pids": [p.pid for p in
                                (node.gcs_proc, node.nodelet_proc) if p]},
                      f)
        print(f"ray_tpu_torch head started at {address}")
        print(f"  session dir: {node.session_dir}")
        print(f"  connect with: ray_tpu_torch.init(address=\"{address}\") or "
              f"RAY_TPU_TORCH_ADDRESS={address}")
    else:
        address = _resolve_address(args.address)
        host, port = address.rsplit(":", 1)
        node = Node(head=False, gcs_addr=(host, int(port)),
                    resources=resources or None,
                    object_store_memory=args.object_store_memory)
        node.start()
        # record the extra node's pids so `stop` reaps them too
        try:
            with open(_ADDR_FILE) as f:
                rec = json.load(f)
            rec.setdefault("pids", []).append(node.nodelet_proc.pid)
            with open(_ADDR_FILE, "w") as f:
                json.dump(rec, f)
        except (OSError, ValueError):
            pass
        print(f"ray_tpu_torch worker node joined {address}")
    # Detach: the spawned daemons own their lifetime now.
    return 0


def _cmd_stop(args) -> int:
    import signal

    try:
        with open(_ADDR_FILE) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        print("no recorded cluster; nothing to stop")
        return 0
    for pid in rec.get("pids", []):
        try:
            os.kill(pid, signal.SIGTERM)
            print(f"stopped pid {pid}")
        except ProcessLookupError:
            pass
    try:
        os.remove(_ADDR_FILE)
    except OSError:
        pass
    return 0


def _gcs_call(address: str, method: str, msg=None):
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.rpc import EventLoopThread

    host, port = address.rsplit(":", 1)
    io = EventLoopThread(name="cli")
    conn = io.run(rpc.connect(host, int(port), name="cli->gcs"))
    try:
        return conn.call_sync(method, msg, timeout=30)
    finally:
        try:
            io.run(conn.close(), timeout=5)
        except Exception:
            pass
        io.stop()


def _cmd_status(args) -> int:
    address = _resolve_address(args.address)
    status = _gcs_call(address, "get_cluster_status")
    print(f"cluster at {address}")
    print(f"{'node':24} {'alive':6} {'resources (avail/total)'}")
    for n in status["nodes"]:
        res = ", ".join(
            f"{k}: {n['available'].get(k, 0):g}/{v:g}"
            for k, v in sorted(n["total"].items()))
        print(f"{n['node_name']:24} {str(n['alive']):6} {res}")
    demand = status.get("pending_demand", [])
    if demand:
        print(f"pending demand ({len(demand)} requests):")
        from collections import Counter

        shapes = Counter(json.dumps(d, sort_keys=True) for d in demand)
        for shape, count in shapes.most_common():
            print(f"  {count} x {shape}")
    else:
        print("no pending demand")
    if status.get("gcs_storage_degraded"):
        print("WARNING: GCS persistence is degraded (writes failing); "
              "a GCS restart may restore stale state")
    return 0


def _cmd_timeline(args) -> int:
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    address = _resolve_address(args.address)
    ray_tpu_torch.init(address=address, ignore_reinit_error=True)
    path = args.output or "ray-tpu-timeline.json"
    events = state.timeline(path)
    print(f"chrome://tracing timeline ({len(events)} events) written to {path}")
    return 0


def _fmt_phase_table(summary: dict) -> str:
    """Render {phase: {count,p50,p95,p99,mean,total}} as an aligned table
    (milliseconds — phase times are sub-second in the healthy case)."""
    lines = [f"{'phase':18} {'count':>7} {'p50 ms':>9} {'p95 ms':>9} "
             f"{'p99 ms':>9} {'mean ms':>9}"]
    total_mean = 0.0
    for phase, st in summary.items():
        lines.append(
            f"{phase:18} {st['count']:>7} {st['p50']*1e3:>9.3f} "
            f"{st['p95']*1e3:>9.3f} {st['p99']*1e3:>9.3f} "
            f"{st['mean']*1e3:>9.3f}")
        if phase in ("driver_serialize", "driver_stage", "dispatch",
                     "exec", "result_put", "result_wake"):
            total_mean += st["mean"]
    lines.append(f"{'sum(mean) end-to-end':18} {'':>7} {'':>9} {'':>9} "
                 f"{'':>9} {total_mean*1e3:>9.3f}")
    return "\n".join(lines)


def _cmd_profile(args) -> int:
    """Per-phase latency percentiles of completed tasks (the evidence layer
    for 'where does a round-trip spend its time')."""
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    address = _resolve_address(args.address)
    ray_tpu_torch.init(address=address, ignore_reinit_error=True)
    summary = state.summarize_task_phases(name=args.name)
    if not summary:
        print("no phased task completions recorded yet")
        return 0
    title = f"task phases ({args.name})" if args.name else "task phases"
    print(title)
    print(_fmt_phase_table(summary))
    return 0


def _cmd_summary(args) -> int:
    """`ray_tpu_torch summary tasks|serve|data|train`: per-entity metric views
    (reference: `ray summary tasks` + the dashboard's Serve/Data/Train
    pages)."""
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    address = _resolve_address(args.address)
    ray_tpu_torch.init(address=address, ignore_reinit_error=True)
    if args.what == "tasks":
        summary = state.summarize_tasks()
        print(f"{'task':28} states")
        for name, states in sorted(summary.items()):
            shown = " ".join(f"{s}={c}" for s, c in sorted(states.items()))
            print(f"{name:28} {shown}")
        phases = state.summarize_task_phases()
        if phases:
            print()
            print(_fmt_phase_table(phases))
    elif args.what == "serve":
        _print_serve_summary(state.summarize_serve())
    elif args.what == "data":
        _print_data_summary(state.summarize_data())
    elif args.what == "train":
        _print_train_summary(state.summarize_train())
    elif args.what == "llm":
        _print_llm_summary(state.summarize_llm())
    elif args.what == "rllib":
        _print_rllib_summary(state.summarize_rllib())
    elif args.what == "hangs":
        _print_hangs_summary(state.summarize_hangs())
    elif args.what == "rpc":
        return _print_rpc_summary(state.summarize_rpc())
    return 0


def _print_rpc_summary(summary: dict) -> int:
    """Served-RPC traffic per method, cross-checked against the static
    wire contract (exit 1 if any served method is absent from it)."""
    methods = summary["methods"]
    if not methods:
        print("no RPC handler stats recorded yet "
              "(RayConfig.event_stats off, or no traffic)")
        return 0
    print(f"{'method':32} {'calls':>8} {'total s':>9} {'contract':>8} "
          f"servers")
    for name, row in sorted(methods.items()):
        mark = "ok" if row["in_contract"] else "UNKNOWN"
        print(f"{name:32} {row['count']:>8} {row['total_s']:>9.3f} "
              f"{mark:>8} {','.join(row['servers'])}")
    unknown = summary["unknown"]
    print(f"{len(methods)} served method(s); contract covers "
          f"{summary['contract_methods']}")
    if unknown:
        print(f"served but NOT in the static contract: "
              f"{', '.join(unknown)} — regenerate with "
              f"`python -m ray_tpu_torch lint --update-contract`")
        return 1
    return 0


def _print_llm_summary(summary: dict) -> None:
    if not summary:
        print("no llm metrics recorded yet (is an engine serving?)")
        return
    print(f"{'engine':24} {'reqs':>6} {'tokens':>8} {'tok/s':>8} "
          f"{'ttft p50 ms':>12} {'ttft p95 ms':>12} {'itl p50 ms':>11} "
          f"{'batch':>6} {'kv%':>5} {'preempt':>8} {'queue':>6} "
          f"{'hit%':>5} {'shed':>5}")
    for name, d in sorted(summary.items()):
        print(f"{name:24} {d['requests']:>6g} {d['generated_tokens']:>8g} "
              f"{d['tokens_per_second']:>8.1f} "
              f"{d['ttft_p50_s']*1e3:>12.3f} {d['ttft_p95_s']*1e3:>12.3f} "
              f"{d['itl_p50_s']*1e3:>11.3f} {d['decode_batch_mean']:>6.1f} "
              f"{d['kv_page_utilization']*100:>5.1f} "
              f"{d['preemptions']:>8g} {d['queue_depth']:>6g} "
              f"{d.get('prefix_hit_rate', 0.0)*100:>5.1f} "
              f"{d.get('shed', 0.0):>5g}")


def _print_rllib_summary(summary: dict) -> None:
    if not summary:
        print("no rllib metrics recorded yet (is an algorithm training?)")
        return
    print(f"{'job':24} {'steps':>9} {'frags':>7} {'ver':>5} "
          f"{'stale p50':>10} {'stale p95':>10} {'upd ms':>8} "
          f"{'allr ms':>8} {'inf batch':>10} {'respawns':>9}")
    for name, d in sorted(summary.items()):
        print(f"{name:24} {d['env_steps']:>9g} {d['fragments']:>7g} "
              f"{d['weight_version']:>5g} {d['staleness_p50']:>10.1f} "
              f"{d['staleness_p95']:>10.1f} {d['update_mean_s']*1e3:>8.2f} "
              f"{d['allreduce_mean_s']*1e3:>8.2f} "
              f"{d['inference_batch_mean']:>10.1f} "
              f"{d['runner_restarts']:>9g}")


def _print_hangs_summary(hangs: list) -> None:
    if not hangs:
        print("no suspected hung tasks")
        return
    print(f"{'task':34} {'name':20} {'node':10} {'elapsed s':>10} "
          f"{'threshold s':>12}")
    for h in hangs:
        print(f"{h['task_id'][:32]:34} {(h['name'] or '?')[:20]:20} "
              f"{(h['node_id'] or '?')[:8]:10} {h['elapsed_s'] or 0:>10.1f} "
              f"{h['threshold_s'] or 0:>12.1f}")
    for h in hangs:
        if h.get("stack"):
            print(f"\nstack of {h['task_id'][:16]} ({h['name']}) "
                  f"at flag time:")
            print(h["stack"].rstrip())


def _print_serve_summary(summary: dict) -> None:
    deployments = summary["deployments"]
    if not deployments:
        print("no serve metrics recorded yet (is an application deployed?)")
        return
    print(f"{'app/deployment':32} {'repl':>9} {'requests':>9} {'errors':>7} "
          f"{'queue':>6} {'p50 ms':>9} {'p95 ms':>9} {'mean ms':>9}")
    for name, d in sorted(deployments.items()):
        repl = f"{d['replicas']:g}/{d['target_replicas']:g}"
        print(f"{name:32} {repl:>9} {d['requests']:>9g} {d['errors']:>7g} "
              f"{d['queue_depth']:>6g} {d['latency_p50_s']*1e3:>9.3f} "
              f"{d['latency_p95_s']*1e3:>9.3f} "
              f"{d['latency_mean_s']*1e3:>9.3f}")
    events = summary.get("autoscale_events") or []
    if events:
        print(f"\nautoscaler decisions (last {min(len(events), 10)}):")
        for ev in events[-10:]:
            when = time.strftime("%H:%M:%S", time.localtime(ev["ts"]))
            print(f"  {when} {ev['app']}/{ev['deployment']}: "
                  f"{ev['from']} -> {ev['to']} ({ev['direction']}, "
                  f"ongoing={ev['ongoing']})")


def _print_data_summary(summary: dict) -> None:
    ops = summary["operators"]
    if not ops:
        print("no data-pipeline metrics recorded yet")
        return
    print(f"{'dataset/operator':44} {'rows':>10} {'blocks':>8} "
          f"{'tasks':>7} {'queue':>6}")
    for name, d in sorted(ops.items()):
        print(f"{name:44} {d['rows']:>10g} {d['blocks']:>8g} "
              f"{d['tasks']:>7g} {d['output_queue_blocks']:>6g}")
    pipelines = summary.get("pipelines") or {}
    for ds, p in sorted(pipelines.items()):
        gated = "BACKPRESSURED" if p["backpressure"] else "flowing"
        print(f"pipeline {ds}: buffered "
              f"{p['buffered_bytes']/2**20:.1f} MiB, {gated}")


def _print_train_summary(summary: dict) -> None:
    if not summary:
        print("no train metrics recorded yet")
        return
    print(f"{'experiment':40} {'state':>9} {'workers':>8} {'reports':>8} "
          f"{'rounds':>7} {'skew':>5} {'ckpts':>6} {'ckpt p50 s':>11}")
    for name, d in sorted(summary.items()):
        print(f"{name:40} {d['gang_state']:>9} {d['workers']:>8g} "
              f"{d['reports']:>8g} {d['report_rounds']:>7g} "
              f"{d.get('step_skew', 0):>5g} "
              f"{d['checkpoints']:>6g} {d['checkpoint_p50_s']:>11.3f}")


def _cmd_memory(args) -> int:
    """Per-node object-store summary (reference: `ray memory` /
    memory_summary): capacity, usage, spill counters, object counts."""
    import ray_tpu_torch
    from ray_tpu_torch._private import rpc as _rpc
    from ray_tpu_torch.util import state

    import asyncio

    address = _resolve_address(args.address)
    ray_tpu_torch.init(address=address, ignore_reinit_error=True)
    core = ray_tpu_torch._private.worker.require_core()

    alive = [n for n in core.gcs_call_sync("get_all_node_info") if n["alive"]]

    async def info(addr):
        # one bounded dial per node, all nodes concurrently: a wedged
        # nodelet costs ~the timeout once, not once per node
        conn = await _rpc.connect(*addr, name="memory->nodelet")
        try:
            return await conn.call("node_info", None, timeout=15)
        finally:
            await conn.close()

    async def gather():
        return await asyncio.gather(
            *(info(tuple(n["addr"])) for n in alive), return_exceptions=True)

    rows = []
    for n, ni in zip(alive, core.io.run(gather())):
        name = n["node_id"].hex()[:8]  # same id the state API prints
        if isinstance(ni, BaseException):
            rows.append((name, f"<unreachable: {ni}>"))
            continue
        st = ni["store"]
        rows.append((
            name,
            f"{st['used']/2**20:8.1f} / {st['capacity']/2**20:8.1f} MiB  "
            f"objects={st['num_objects']:<6} "
            f"spilled={st['num_spilled']} ({st['bytes_spilled']/2**20:.1f} MiB)"))
    print(f"{'node':<10} object store")
    for name, desc in rows:
        print(f"{name:<10} {desc}")
    objs = state.list_objects()
    print(f"\nobject directory: {len(objs)} cluster-visible objects")
    if args.verbose:
        for o in objs[:200]:
            print(f"  {o['object_id'][:16]}  on {len(o['locations'])} node(s)")
    return 0


def _cmd_stack(args) -> int:
    """Live Python stacks of cluster processes (reference: `ray stack`,
    which shells out to py-spy; here every process samples itself via
    sys._current_frames() over the RPC plane — zero external deps).  With a
    TASK_ID, prints the stack of the worker executing that task."""
    import ray_tpu_torch
    from ray_tpu_torch._private.introspect import format_stack_payload
    from ray_tpu_torch.util import state

    address = _resolve_address(args.address)
    ray_tpu_torch.init(address=address, ignore_reinit_error=True)
    dumps = state.get_stacks(node_id=args.node, task_id=args.task_id)
    if not dumps:
        where = f"task {args.task_id}" if args.task_id else "cluster"
        print(f"no stacks found for {where} (task finished, or no "
              f"matching node)")
        return 1
    if getattr(args, "collapsed", False):
        # point-in-time dump folded into the profiler's collapsed-stack
        # universe: one line (count=1) per thread, task-tagged when the
        # thread was executing a task
        from ray_tpu_torch._private.profiler import (collapsed_lines,
                                               fold_formatted_stack)

        entries = []
        for node in dumps:
            payloads = list(node.get("workers", []))
            if node.get("nodelet"):
                payloads.append(node["nodelet"])
            for payload in payloads:
                for t in payload.get("threads", []):
                    stack = fold_formatted_stack(t.get("stack") or "")
                    if stack:
                        entries.append(
                            [t.get("task_name") or "", "core", stack, 1])
        for line in collapsed_lines(entries):
            print(line)
        return 0
    for node in dumps:
        nid = node.get("node_id")
        print(f"==== node {nid[:12] if nid else '<driver>'} ====")
        for payload in node.get("workers", []):
            print(format_stack_payload(payload))
            print()
        if node.get("nodelet"):
            print(format_stack_payload(node["nodelet"]))
            print()
    return 0


def _cmd_critical_path(args) -> int:
    """Critical path of one trace / training step / LLM request: the
    dependent chain that bounded the end-to-end wall, each node with its %
    of the path and bucket attribution (queue, dispatch, exec,
    object-transfer, collective-comm, pipeline-bubble, admission-wait)."""
    import ray_tpu_torch
    from ray_tpu_torch._private import critical_path as cp
    from ray_tpu_torch.util import state

    address = _resolve_address(args.address)
    ray_tpu_torch.init(address=address, ignore_reinit_error=True)
    try:
        result = state.critical_path(
            trace_id=args.trace, step=args.step,
            request_id=args.request, experiment=args.experiment)
    except ValueError as e:
        print(f"critical-path: {e}")
        return 1
    if args.json:
        print(cp.to_json(result))
    else:
        print(cp.render_tree(result))
    return 0


def _cmd_flamegraph(args) -> int:
    """Cluster-wide flamegraph from the continuous profiler's aggregate:
    collapsed-stack lines (flamegraph.pl / speedscope input) to stdout, or
    a self-contained SVG with --svg.  Needs profile_hz > 0 somewhere
    (RAY_TPU_TORCH_PROFILE_HZ=19 is the canonical enabled rate); hang-watchdog
    one-shot stacks appear under a 'hung' root frame regardless."""
    import ray_tpu_torch
    from ray_tpu_torch._private import profiler
    from ray_tpu_torch.util import state

    address = _resolve_address(args.address)
    ray_tpu_torch.init(address=address, ignore_reinit_error=True)
    lines = state.flamegraph_collapsed(
        node_id=args.node, task_name=args.task_name,
        critical_path_trace=args.critical_path)
    if not lines:
        print("no profile samples yet (set RAY_TPU_TORCH_PROFILE_HZ=19 to enable "
              "continuous sampling; hung-task stacks appear automatically)")
        return 1
    if args.svg:
        svg = profiler.render_svg(lines)
        with open(args.svg, "w") as f:
            f.write(svg)
        print(f"wrote {args.svg} ({sum(1 for _l in lines)} stacks)")
    else:
        for line in lines:
            print(line)
    return 0


def _cmd_blackbox(args) -> int:
    """Harvested flight-recorder rings of dead workers: the last records a
    SIGKILL'd process wrote into its crash-surviving mmap'd ring before it
    died (the nodelet reads the ring off disk at death and ships the tail
    to the GCS)."""
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    address = _resolve_address(args.address)
    ray_tpu_torch.init(address=address, ignore_reinit_error=True)
    boxes = state.get_blackbox(worker_id=args.worker_id, node_id=args.node)
    if not boxes:
        print("no harvested black boxes (no worker deaths, or the flight "
              "recorder is disabled: flight_recorder_bytes=0)")
        return 1
    for bb in boxes:
        when = time.strftime("%H:%M:%S", time.localtime(bb["harvested_at"]))
        print(f"==== worker {bb['worker_id'][:12]} on node "
              f"{bb.get('node_id', '?')[:12]} (harvested {when}; "
              f"{bb.get('reason', '?')}) ====")
        records = bb.get("records", [])
        for r in records[-args.tail:]:
            ts = time.strftime("%H:%M:%S", time.localtime(r["ts"]))
            frac = f"{r['ts'] % 1:.3f}"[1:]
            print(f"  #{r['seq']:<6} {ts}{frac}  {r['kind']:<16} "
                  f"{r['detail']}")
        print()
    return 0


def _cmd_incidents(args) -> int:
    """Closed failure incidents: one line per incident with its per-phase
    recovery timeline and SLO verdict (detect -> quarantine -> rebuild ->
    restore -> resume, durations summing to recovery_seconds)."""
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    address = _resolve_address(args.address)
    ray_tpu_torch.init(address=address, ignore_reinit_error=True)
    rows = state.list_incidents(subsystem=args.subsystem, limit=args.limit)
    if not rows:
        print("no incidents recorded")
        return 0
    for rec in rows:
        when = time.strftime("%H:%M:%S", time.localtime(rec["opened_at"]))
        phases = " ".join(f"{n}={s * 1000:.1f}ms"
                          for n, s in rec.get("phases", []))
        slo = rec.get("slo", "none")
        ok = "recovered" if rec.get("ok") else "UNRECOVERED"
        print(f"{when}  {rec['subsystem']:<12} {rec.get('kind', ''):<22} "
              f"{rec['recovery_seconds'] * 1000:8.1f}ms  slo={slo:<5} "
              f"{ok}  [{phases}]  {rec.get('detail', '')}")
        if args.verbose and rec.get("blackbox"):
            bb = rec["blackbox"]
            match = bb.get("victim_match", "worker_id")
            print(f"    blackbox: worker {bb['worker_id'][:12]} "
                  f"({len(bb.get('records', []))} records, "
                  f"matched by {match}); last:")
            for r in bb.get("records", [])[-8:]:
                print(f"      #{r['seq']:<6} {r['kind']:<16} {r['detail']}")
    return 0


def _cmd_logs(args) -> int:
    """List/tail log files across the cluster (reference:
    python/ray/_private/log_monitor.py + `ray logs` in scripts.py).
    ``--follow`` poll-tails the file through the same state.get_log path,
    so hang debugging doesn't require re-running the command."""
    import ray_tpu_torch
    from ray_tpu_torch.util import state

    address = _resolve_address(args.address)
    ray_tpu_torch.init(address=address, ignore_reinit_error=True)
    if args.filename is None:
        if args.follow:
            raise SystemExit("--follow requires a log file name")
        for f in state.list_logs(node_id=args.node_id):
            print(f"{f['size']:>10}  {f['name']}")
        return 0
    if not args.follow:
        sys.stdout.write(state.get_log(args.filename, node_id=args.node_id,
                                       tail=args.tail))
        return 0
    # follow: print the current tail, then poll the file's size and fetch
    # only the newly-appended bytes each round (size from list_logs, bytes
    # via the bounded get_log tail — no new RPC surface needed)
    seen = None
    try:
        while True:
            sizes = {f["name"]: f["size"]
                     for f in state.list_logs(node_id=args.node_id)}
            size = sizes.get(args.filename)
            if size is not None:
                if seen is None or size < seen:  # first round / truncated
                    sys.stdout.write(state.get_log(
                        args.filename, node_id=args.node_id, tail=args.tail))
                    seen = size
                elif size > seen:
                    sys.stdout.write(state.get_log(
                        args.filename, node_id=args.node_id,
                        tail=size - seen))
                    seen = size
                sys.stdout.flush()
            time.sleep(args.poll_interval)
    except KeyboardInterrupt:
        return 0


def _cmd_job(args) -> int:
    from ray_tpu_torch.job_submission import JobSubmissionClient

    address = _resolve_address(args.address)
    client = JobSubmissionClient(address)
    try:
        if args.job_cmd == "submit":
            parts = list(args.entrypoint)
            if parts and parts[0] == "--":  # argparse REMAINDER keeps the sep
                parts = parts[1:]
            entrypoint = " ".join(parts)
            env = {"env_vars": dict(kv.split("=", 1) for kv in args.env)} \
                if args.env else None
            sid = client.submit_job(entrypoint=entrypoint, runtime_env=env,
                                    submission_id=args.submission_id)
            print(f"submitted job {sid}")
            if args.wait:
                status = client.wait_until_finished(sid, timeout=args.timeout)
                print(client.get_job_logs(sid), end="")
                print(f"job {sid}: {status}")
                return 0 if status == "SUCCEEDED" else 1
        elif args.job_cmd == "list":
            for j in client.list_jobs():
                print(f"{j.submission_id:28} {j.status:10} {j.entrypoint}")
        elif args.job_cmd == "status":
            print(client.get_job_status(args.submission_id))
        elif args.job_cmd == "logs":
            print(client.get_job_logs(args.submission_id), end="")
        elif args.job_cmd == "stop":
            ok = client.stop_job(args.submission_id)
            print("stopped" if ok else "not running")
        return 0
    finally:
        client.close()


def _cmd_lint(args) -> int:
    """Static distributed-runtime invariant checks (no cluster needed):
    async-blocking, lock discipline, config drift, collective timeouts, JAX
    tracer hygiene, metrics hygiene — see ray_tpu_torch/_lint/ and
    docs/ARCHITECTURE.md §7.  Exit 1 on any non-baselined finding."""
    from ray_tpu_torch import _lint

    if args.list_rules:
        for name, cls in _lint.all_checkers().items():
            print(f"{name:22} {cls.description}")
        return 0
    if args.contract or args.update_contract:
        return _lint_contract(args)
    baseline = None if args.no_baseline else (args.baseline
                                              or _lint.DEFAULT_BASELINE)
    checkers = args.select.split(",") if args.select else None
    result = _lint.run_lint(paths=args.paths or None, checkers=checkers,
                            baseline=baseline)
    if args.update_baseline:
        if baseline is None:
            raise SystemExit("--update-baseline needs a baseline path "
                             "(drop --no-baseline)")
        notes = {fp: e.get("note", "")
                 for fp, e in _lint.load_baseline(baseline).items()}
        every = sorted(result.findings + result.baselined,
                       key=_lint.Finding.key)
        _lint.save_baseline(baseline, every, notes)
        print(f"baseline updated: {len(every)} entr(ies) -> {baseline}")
        return 0
    if args.json:
        print(_lint.render_json(result))
    else:
        print(_lint.render_text(result, verbose=args.verbose))
    return 0 if result.ok else 1


def _lint_contract(args) -> int:
    """``ray_tpu_torch lint --contract``: extract the wire contract (the generated
    IDL of the msgpack RPC plane) and diff it against the checked-in
    snapshot; ``--update-contract`` regenerates the snapshot JSON plus
    docs/WIRE_CONTRACT.md.  Exit 0 in sync, 1 drifted."""
    import os

    from ray_tpu_torch import _lint
    from ray_tpu_torch._lint import wire_contract as wc

    pkg_dir = os.path.dirname(os.path.dirname(
        os.path.abspath(_lint.__file__)))
    files = _lint.collect_files(args.paths or [pkg_dir])
    contract = wc.extract_contract(files)
    if args.update_contract:
        wc.save_snapshot(contract)
        docs = os.path.join(os.path.dirname(pkg_dir), "docs")
        md_path = os.path.join(docs, "WIRE_CONTRACT.md")
        if os.path.isdir(docs):
            with open(md_path, "w", encoding="utf-8") as fh:
                fh.write(wc.contract_markdown(contract))
            print(f"wrote {md_path}")
        print(f"wrote {wc.DEFAULT_SNAPSHOT} "
              f"({len(contract['methods'])} methods)")
        return 0
    if args.json:
        print(wc.contract_json(contract), end="")
    else:
        p = contract["protocol"]
        print(f"wire contract: protocol v{p.get('version')} "
              f"(min compatible v{p.get('min_compatible')}), "
              f"{len(contract['methods'])} methods, "
              f"{sum(len(v) for v in contract['callers'].values())} "
              f"static call sites")
    snapshot = wc.load_snapshot()
    if snapshot is None:
        print("no snapshot checked in — run "
              "`python -m ray_tpu_torch lint --update-contract`")
        return 1
    diff = wc.diff_contract(snapshot, contract)
    if not diff:
        if not args.json:
            print("in sync with snapshot "
                  f"({os.path.basename(wc.DEFAULT_SNAPSHOT)})")
        return 0
    print(f"{len(diff)} difference(s) vs snapshot:")
    for line in diff:
        print(f"  {line}")
    print("bump PROTOCOL_VERSION or run "
          "`python -m ray_tpu_torch lint --update-contract`")
    return 1


def _cmd_chaos(args) -> int:
    """Deterministic fault-injection engine: list the registered injection
    points, or validate a schedule string before arming a run with it
    (grammar: ray_tpu_torch/_private/fault_injection.py)."""
    from ray_tpu_torch._private import fault_injection

    if args.validate is not None:
        try:
            st = fault_injection._State(args.validate)
        except ValueError as e:
            print(f"invalid schedule: {e}")
            return 1
        n = sum(len(rs) for rs in st.rules.values())
        print(f"schedule ok: seed={st.seed}, {n} rule(s)")
        for point, rules in sorted(st.rules.items()):
            for r in rules:
                trig = f"p={r.prob}" if r.prob is not None else \
                    f"hit {r.nth}{'+' if r.and_after else ''}"
                det = f"[{r.detail}]" if r.detail else ""
                print(f"  {point}{det} -> {r.action} @ {trig}")
        return 0
    # default: --list-points
    rows = fault_injection.describe_points()
    wn = max(len(r[0]) for r in rows)
    wa = max(len(r[1]) for r in rows)
    print(f"{'POINT':<{wn}}  {'ACTIONS':<{wa}}  WHERE (detail)")
    for name, actions, detail, where in rows:
        print(f"{name:<{wn}}  {actions:<{wa}}  {where} (detail: {detail})")
    print()
    print("schedule: seed=<int>;<point>[<detail-substr>]=<action>@<trigger>")
    print("trigger:  p<float> | <Nth hit> | <Nth hit>+  "
          "(env RAY_TPU_TORCH_CHAOS_SCHEDULE)")
    return 0


def _cmd_up(args) -> int:
    from ray_tpu_torch.autoscaler.launcher import cluster_up

    state = cluster_up(args.config, start_monitor=not args.no_monitor)
    print(f"cluster {state['cluster_name']} up at {state['address']}")
    if state.get("monitor_pid"):
        print(f"  autoscaler monitor pid: {state['monitor_pid']}")
    print(f"  connect with: ray_tpu_torch.init(address=\"{state['address']}\")")
    return 0


def _cmd_down(args) -> int:
    from ray_tpu_torch.autoscaler.launcher import cluster_down

    cluster_down(args.config)
    print("cluster down")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start", help="start a head or worker node")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", default=None)
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--resources", default=None, help="JSON resource dict")
    p.add_argument("--object-store-memory", type=int, default=None)
    p.set_defaults(fn=_cmd_start)

    p = sub.add_parser("stop", help="stop the recorded local cluster")
    p.set_defaults(fn=_cmd_stop)

    p = sub.add_parser(
        "up", help="launch a cluster from a YAML config "
        "(reference: scripts.py:1282 `ray up`)")
    p.add_argument("config", help="cluster YAML path")
    p.add_argument("--no-monitor", action="store_true",
                   help="skip the autoscaler monitor daemon")
    p.set_defaults(fn=_cmd_up)

    p = sub.add_parser("down",
                       help="tear down a cluster launched with `up`")
    p.add_argument("config", help="cluster YAML path")
    p.set_defaults(fn=_cmd_down)

    p = sub.add_parser(
        "lint", help="static distributed-runtime invariant checks "
        "(AST-based; exit 1 on non-baselined findings)")
    p.add_argument("paths", nargs="*", default=None,
                   help="files/dirs to lint (default: the ray_tpu_torch package)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report (deterministic)")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: ray_tpu_torch/_lint/baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report grandfathered findings as failures too")
    p.add_argument("--update-baseline", action="store_true",
                   help="grandfather every current finding into the baseline")
    p.add_argument("--select", default=None,
                   help="comma-separated checker names (default: all)")
    p.add_argument("--verbose", action="store_true",
                   help="also print baselined findings")
    p.add_argument("--list-rules", action="store_true",
                   help="print the checker table and exit")
    p.add_argument("--contract", action="store_true",
                   help="print the extracted wire contract + diff vs the "
                        "checked-in snapshot (exit 1 on drift)")
    p.add_argument("--update-contract", action="store_true",
                   help="regenerate the wire-contract snapshot JSON and "
                        "docs/WIRE_CONTRACT.md from the tree")
    p.set_defaults(fn=_cmd_lint)

    p = sub.add_parser(
        "chaos", help="deterministic fault-injection engine: list "
        "injection points / validate a schedule")
    p.add_argument("--list-points", action="store_true",
                   help="enumerate registered injection points (default)")
    p.add_argument("--validate", default=None, metavar="SCHEDULE",
                   help="parse a schedule string and print its rules")
    p.set_defaults(fn=_cmd_chaos)

    p = sub.add_parser("status", help="cluster nodes + pending demand")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=_cmd_status)

    p = sub.add_parser("timeline", help="dump a chrome://tracing timeline")
    p.add_argument("--address", default=None)
    p.add_argument("--output", default=None)
    p.set_defaults(fn=_cmd_timeline)

    p = sub.add_parser("profile",
                       help="per-phase task latency percentiles "
                            "(p50/p95/p99 of the submit->wake hot path)")
    p.add_argument("--address", default=None)
    p.add_argument("--name", default=None,
                   help="restrict to one task name")
    p.set_defaults(fn=_cmd_profile)

    p = sub.add_parser("summary",
                       help="summarize cluster entities "
                            "(tasks, serve, data, train, llm, rllib, "
                            "hangs, rpc)")
    p.add_argument("what",
                   choices=["tasks", "serve", "data", "train", "llm",
                            "rllib", "hangs", "rpc"],
                   help="entity kind to summarize")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=_cmd_summary)

    p = sub.add_parser("stack",
                       help="dump live Python stacks of cluster processes "
                            "(optionally of the worker running one task)")
    p.add_argument("task_id", nargs="?", default=None,
                   help="task id (hex prefix ok): only the worker "
                        "executing it")
    p.add_argument("--node", default=None,
                   help="node id (hex prefix ok); default: every node")
    p.add_argument("--collapsed", action="store_true",
                   help="emit one collapsed-stack line per thread "
                        "(flamegraph.pl format, same universe as "
                        "`ray_tpu_torch flamegraph`) instead of readable dumps")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=_cmd_stack)

    p = sub.add_parser("critical-path",
                       help="longest dependent chain of a trace / training "
                            "step / LLM request with per-bucket attribution")
    p.add_argument("--trace", default=None,
                   help="trace id: DAG reconstruction over its spans")
    p.add_argument("--step", type=int, default=None,
                   help="pipeline training step number")
    p.add_argument("--experiment", default=None,
                   help="with --step: restrict to one experiment")
    p.add_argument("--request", default=None,
                   help="LLM request id: TTFT decomposition")
    p.add_argument("--json", action="store_true",
                   help="machine-readable JSON instead of the tree view")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=_cmd_critical_path)

    p = sub.add_parser("flamegraph",
                       help="cluster flamegraph from the continuous "
                            "profiler (collapsed stacks or --svg)")
    p.add_argument("--node", default=None,
                   help="node id (hex prefix ok); default: every node")
    p.add_argument("--task-name", default=None,
                   help="restrict to samples of one task name")
    p.add_argument("--critical-path", default=None, metavar="TRACE_ID",
                   help="tag samples of tasks on this trace's critical "
                        "path with an on_critical_path root frame")
    p.add_argument("--svg", default=None, metavar="FILE",
                   help="write a self-contained SVG flamegraph here")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=_cmd_flamegraph)

    p = sub.add_parser("blackbox",
                       help="harvested flight-recorder rings of dead "
                            "workers (their last recorded moments)")
    p.add_argument("worker_id", nargs="?", default=None,
                   help="worker id (hex prefix ok); default: every harvest")
    p.add_argument("--node", default=None,
                   help="node id (hex prefix ok): harvests from one node")
    p.add_argument("--tail", type=int, default=50,
                   help="records shown per black box (newest)")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=_cmd_blackbox)

    p = sub.add_parser("incidents",
                       help="closed failure incidents with per-phase "
                            "recovery timelines and SLO verdicts")
    p.add_argument("--subsystem", default=None,
                   help="filter (collective, serve, pipeline, task_retry, "
                        "lease_cache)")
    p.add_argument("--limit", type=int, default=50)
    p.add_argument("--verbose", action="store_true",
                   help="also print each incident's harvested black-box "
                        "tail")
    p.add_argument("--address", default=None)
    p.set_defaults(fn=_cmd_incidents)

    p = sub.add_parser("memory",
                       help="per-node object-store usage + spill counters")
    p.add_argument("--address", default=None)
    p.add_argument("--verbose", action="store_true",
                   help="also list cluster-visible object ids")
    p.set_defaults(fn=_cmd_memory)

    p = sub.add_parser("logs", help="list or tail cluster log files")
    p.add_argument("filename", nargs="?", default=None,
                   help="log file to tail (omit to list)")
    p.add_argument("--address", default=None)
    p.add_argument("--node-id", default=None,
                   help="node id (hex prefix ok); default: head node")
    p.add_argument("--tail", type=int, default=64 * 1024,
                   help="bytes from the end of the file")
    p.add_argument("--follow", "-f", action="store_true",
                   help="poll-tail the file until interrupted")
    p.add_argument("--poll-interval", type=float, default=1.0,
                   help="seconds between --follow polls")
    p.set_defaults(fn=_cmd_logs)

    p = sub.add_parser("job", help="submit and manage jobs")
    jsub = p.add_subparsers(dest="job_cmd", required=True)
    ps = jsub.add_parser("submit")
    ps.add_argument("--address", default=None)
    ps.add_argument("--submission-id", default=None)
    ps.add_argument("--env", action="append", default=[],
                    help="KEY=VALUE runtime env var (repeatable)")
    ps.add_argument("--wait", action="store_true")
    ps.add_argument("--timeout", type=float, default=600.0)
    ps.add_argument("entrypoint", nargs=argparse.REMAINDER)
    ps.set_defaults(fn=_cmd_job)
    for name in ("list", "status", "logs", "stop"):
        pj = jsub.add_parser(name)
        pj.add_argument("--address", default=None)
        if name != "list":
            pj.add_argument("submission_id")
        pj.set_defaults(fn=_cmd_job)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
