"""Port of ``ray_tpu/_private/config.py``.

Typed flag registry with environment-variable overrides.

Counterpart of the reference's RAY_CONFIG system (reference:
src/ray/common/ray_config_def.h — 216 flags, each overridable via ``RAY_<name>``;
src/ray/common/ray_config.h:102 for the getenv hook).  Here every flag is declared
once with a type and default, and ``RAY_TPU_TORCH_<NAME>`` env vars override it at first
read.  Flags are process-local; cross-process propagation happens by the parent
serializing overrides into the child's environment (see _private/services.py).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Callable, Dict

ENV_PREFIX = "RAY_TPU_TORCH_"


def temp_root() -> str:
    """Where the port's sessions live: ``RAY_TPU_TORCH_TMPDIR``, else
    ``ray_tpu_torch`` under the process's temp directory (``TMPDIR``)."""
    return os.environ.get(ENV_PREFIX + "TMPDIR", os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch"))


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: int,
    float: float,
    str: str,
}


class _Config:
    def __init__(self):
        self._defs: Dict[str, tuple] = {}  # name -> (type, default)
        self._values: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def define(self, name: str, typ: type, default: Any, doc: str = ""):
        self._defs[name] = (typ, default, doc)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            typ, default, _ = self._defs[name]
        except KeyError:
            raise AttributeError(f"unknown config flag: {name}") from None
        with self._lock:
            if name not in self._values:
                env = os.environ.get(ENV_PREFIX + name.upper())
                if env is None:
                    env = os.environ.get(ENV_PREFIX + name)
                self._values[name] = _PARSERS[typ](env) if env is not None else default
            return self._values[name]

    def set(self, name: str, value: Any):
        """Programmatic override (tests)."""
        if name not in self._defs:
            raise AttributeError(f"unknown config flag: {name}")
        with self._lock:
            self._values[name] = value

    def reset(self, name: str | None = None):
        with self._lock:
            if name is None:
                self._values.clear()
            else:
                self._values.pop(name, None)

    def overrides_as_env(self) -> Dict[str, str]:
        """Serialize explicitly-set values as env vars for child processes."""
        with self._lock:
            out = {}
            for name, value in self._values.items():
                typ, default, _ = self._defs[name]
                if value != default:
                    out[ENV_PREFIX + name.upper()] = json.dumps(value) if typ is bool else str(value)
            return out

    def dump(self) -> Dict[str, Any]:
        return {name: getattr(self, name) for name in self._defs}


RayConfig = _Config()
_d = RayConfig.define

# --- Timeouts & heartbeats (ms unless noted) ---
_d("heartbeat_interval_ms", int, 500, "nodelet -> GCS resource/health report period")
_d("health_check_timeout_ms", int, 10_000, "GCS marks a node dead after this silence")
_d("gcs_rpc_timeout_s", float, 30.0, "client-side timeout for GCS RPCs")
_d("worker_register_timeout_s", float, 60.0, "worker must register with nodelet within this")
_d("wait_poll_interval_ms", int, 20, "poll granularity for ray.wait fallbacks")

# --- Worker pool ---
_d("maximum_startup_concurrency", int, 4, "max concurrently-starting workers")
_d("idle_worker_killing_time_ms", int, 300_000, "idle worker reap delay")

# --- Scheduler ---
_d("scheduler_spread_threshold", float, 0.5, "hybrid policy: pack below this utilization, then spread")
_d("lease_cache_idle_s", float, 2.0, "a drained scheduling class keeps its worker leases warm this long (so the next burst skips the lease round trip); nodelet reclaim hints cut it short under resource pressure")
_d("max_pending_lease_requests_per_scheduling_category", int, 10, "pipelined lease requests")
_d("lease_pipeline_depth", int, 48, "in-flight tasks per leased worker (exec queue serializes)")
_d("worker_exec_threads", int, 12, "executor threads per worker (chunks share threads, so this can be < pipeline depth)")

# --- Object store ---
_d("object_store_memory_bytes", int, 2 * 1024**3, "default per-node shm store capacity")
_d("arena_enabled", bool, True, "pre-faulted slab arena for local plasma puts (fused put/seal over bulk extent leases); off = per-object create/seal round trips")
_d("arena_slab_bytes", int, 64 * 1024**2, "arena slab size; a larger object gets a dedicated slab of its own size")
_d("extent_lease_bytes", int, 16 * 1024**2, "extra extent bytes a client leases beyond the current put, so steady-state puts skip the lease RPC")
_d("extent_lease_idle_s", float, 10.0, "clients return unused leased extents after this idle time")
_d("max_direct_call_object_size", int, 100 * 1024, "objects <= this are inlined in the owner memory store")
_d("object_store_full_delay_ms", int, 100, "retry delay when store is full")
_d("object_transfer_inflight_bytes", int, 32 * 1024 * 1024, "max in-flight bytes per object pull")
_d("max_lineage_entries", int, 10_000, "task specs retained per owner for object reconstruction")
_d("object_recovery_max_attempts", int, 3, "reconstruction attempts per lost object")
_d("fetch_chunk_bytes", int, 8 * 1024**2, "chunk size for node-to-node object transfer")

# --- Fault tolerance ---
_d("gcs_storage_path", str, "", "sqlite file for GCS persistence; empty = in-memory only")
_d("gcs_reconnect_timeout_s", float, 60.0, "nodelets/workers retry the GCS connection this long")
_d("gcs_restart_actor_grace_s", float, 10.0, "restarted GCS waits this long for nodes to re-report actors before declaring them failed")
_d("task_max_retries_default", int, 3, "default retries for tasks (on worker/node death)")
_d("task_retry_backoff_s", float, 0.4,
   "base delay before resubmitting a task whose worker/node died; doubles "
   "per attempt with +/-25% jitter so a retry storm cannot hammer a node "
   "that is still shedding load (error-result retries resubmit "
   "immediately: the worker is healthy).  0 restores immediate resubmit")
_d("task_retry_backoff_max_s", float, 5.0,
   "cap on the exponential task-retry backoff")
_d("max_lease_spillbacks", int, 4, "max times one lease request hops between nodelets before it must settle")
_d("actor_max_restarts_default", int, 0, "default actor restarts")

# --- Chaos engine (fault injection; see _private/fault_injection.py) ---
_d("chaos_schedule", str, "",
   "seeded fault-injection schedule, e.g. "
   "'seed=7;worker.pre_exec=kill@2;rpc.frame.send[col_]=drop@p0.05'; "
   "empty (the default) disables every injection point at one attribute "
   "check of cost")
_d("chaos_trace_file", str, "",
   "append each fired injection ('point[detail]#hit:action') to this file "
   "so cross-process determinism can be asserted; empty keeps the trace "
   "in-process only")
_d("chaos_delay_ms", int, 25,
   "duration of the 'delay' action on rpc.frame.send")

# --- Flight recorder + incidents (see _private/flight_recorder.py) ---
_d("flight_recorder_bytes", int, 256 * 1024,
   "size of each process's crash-surviving mmap'd flight-recorder ring "
   "file in the session dir (the 'black box' the nodelet harvests when "
   "the process dies); 0 disables recording")
_d("incident_retention", int, 256,
   "closed failure incidents and harvested worker black boxes kept by "
   "the GCS (and by each process's local incident ledger)")
_d("recovery_slo", str, "collective.detect<15,serve<1",
   "declarative recovery SLO bars checked when an incident closes: "
   "comma-separated 'subsystem[.phase]<seconds' entries; an incident "
   "exceeding a matching bar closes with slo=fail")

# --- Memory monitor ---
_d("memory_monitor_refresh_ms", int, 1000, "node memory pressure check period; 0 disables")
_d("memory_usage_threshold", float, 0.95, "kill a retriable worker above this node memory fraction")

# --- Metrics / events ---
_d("event_stats", bool, True, "record per-handler event-loop stats")
_d("metrics_report_interval_ms", int, 5_000, "metrics push period")
_d("task_events_enabled", bool, True, "buffer + flush task lifecycle events to GCS")
_d("local_fs_capacity_threshold", float, 0.95, "nodelet stops taking leases when the session filesystem is this full")
_d("fs_monitor_interval_s", float, 2.0, "disk-usage check cadence")
_d("test_hooks", bool, False, "enable fault-injection RPCs (set_env); never on in production")
_d("task_events_flush_interval_ms", int, 1_000, "task event flush period")
_d("task_events_max_buffer_size", int, 10_000, "drop task events beyond this")

# --- Hang diagnosis ---
_d("hang_watchdog_interval_s", float, 2.0,
   "nodelet hang-watchdog poll period; 0 disables the watchdog")
_d("hang_threshold_s", float, 300.0,
   "absolute fallback: a task running longer than this is flagged as "
   "suspected hung (used when no per-name p95 history exists)")
_d("hang_p95_multiplier", float, 10.0,
   "flag a task as suspected hung past this multiple of its name's "
   "recent exec p95")
_d("hang_p95_floor_s", float, 5.0,
   "never flag via the p95 path below this elapsed time (sub-second tasks "
   "jitter well past 10x p95 without being hung)")
_d("hang_min_samples", int, 5,
   "completed same-name tasks required before the p95 path applies")

# --- Continuous profiler (_private/profiler.py) ---
_d("profile_hz", float, 0.0,
   "continuous-profiler sampling rate per process; 0 disables (the "
   "default — disabled cost is one attribute read on the metrics-push "
   "path); 19 Hz is the canonical enabled rate (prime, so it cannot "
   "alias against periodic work); env re-read at sampler start so "
   "subprocesses inherit RAY_TPU_TORCH_PROFILE_HZ")
_d("profile_max_stacks", int, 20_000,
   "GCS-side cap on distinct aggregated profile stacks; lowest-count "
   "entries evict first when exceeded")

# --- Event loop / channels ---
_d("loop_stall_threshold_s", float, 5.0,
   "warn (with the loop thread's stack) when the per-process IO event loop "
   "stops heartbeating this long; 0 disables; env re-read per loop start")
_d("chan_connect_timeout_s", float, 60.0,
   "compiled-DAG tcp channel connect/accept budget (tests shorten it); "
   "env re-read per channel construction")
_d("native_channel", str, "",
   "compiled-DAG channel backend: '1' forces native futex channels, '0' "
   "the Python fallback, '' auto-selects by core count")

# --- Sanitizers ---
_d("race_detector", bool, False,
   "wrap max_concurrency>1 actors so unsynchronized shared-state writes "
   "are reported (see _private/race_detector.py)")
_d("race_detector_allow", str, "",
   "comma-separated ClassName.attr suppressions for the race detector; "
   "env re-read per report so suppressions apply live")

# --- Storage roots ---
_d("workflow_storage", str, "~/ray_tpu_workflows",
   "filesystem root for workflow checkpoints")
_d("storage_path", str, "~/ray_tpu_results",
   "default air.RunConfig.storage_path (trial results + checkpoints)")

# --- Collectives ---
_d("collective_rendezvous_timeout_s", float, 60.0, "collective group formation timeout")
_d("collective_op_timeout_s", float, 300.0, "single collective op timeout")
_d("collective_default_timeout_s", float, 300.0,
   "default timeout_s for recv/barrier (and the other collectives); on "
   "expiry CollectiveTimeout names the group, op, and lagging rank(s)")
_d("collective_liveness_grace_s", float, 2.0,
   "how long a collective recv may sit empty-handed before probing the "
   "waited-on rank for liveness (progress-stamp freshness, then a TCP "
   "probe); a dead rank then raises CollectiveWorkerDied naming it "
   "instead of burning the full op timeout.  <= 0 disables probing")
_d("collective_liveness_interval_s", float, 2.0,
   "minimum spacing between liveness probes of the same rank while a "
   "recv keeps waiting (probes are sockets + KV reads; don't spam them)")
_d("collective_pipeline", bool, True,
   "pipelined ring data path: fire-and-forget chunked sends overlapped "
   "with recv+reduce; off = the legacy serial blocking-send ring "
   "(kept for interleaved A/B benchmarking)")
_d("collective_chunk_bytes", int, 2 * 1024 * 1024,
   "wire chunk size for pipelined ring collectives; each ring step's "
   "payload is split into chunks this size so send, recv, and reduce "
   "overlap instead of alternating; 0 = one chunk per step.  Smaller "
   "chunks overlap better on fast links; larger ones amortize per-message "
   "wakeups on shared-core hosts")
_d("collective_shm_min_bytes", int, 64 * 1024,
   "pipelined chunks at/above this size ride the per-group shared-memory "
   "arena when sender and receiver share a node (only a small descriptor "
   "crosses the RPC; the receiver reduces zero-copy out of the mapped "
   "segment); 0 disables the shm channel")
_d("collective_quant_block", int, 256,
   "elements per int8 quantization scale block for quant='int8' "
   "collectives (block-scaled symmetric quantization)")
_d("collective_hier_min_bytes", int, 64 * 1024,
   "topology='auto' picks the hierarchical two-level path at/above this "
   "payload size when ranks span multiple nodes; below it the flat ring's "
   "fewer hops win")
_d("collective_virtual_nodes", int, 0,
   "test/bench knob: partition ranks into this many synthetic nodes for "
   "hierarchical topology (>0 overrides real node placement, so a "
   "single-host world can exercise the two-level path)")

# --- Train: 3D-parallel dp gradient exchange (train/pipeline/dp_sync.py;
# --- env re-read at DpGradSync construction so tests/benches can retune a
# --- trainer mid-process, but declared here for dump/propagation)
_d("train_grad_bucket_bytes", int, 4 * 1024 * 1024,
   "size cap (fp32 bytes) for gradient allreduce buckets in dp-composed "
   "pipeline training; grads flush into buckets the moment the last "
   "backward microbatch completes so the allreduce overlaps the "
   "remaining 1F1B drain.  <= 0 = one bucket per parameter leaf")
_d("train_grad_quant", str, "",
   "wire quantization for the dp gradient allreduce ('' = fp32 exact, "
   "'int8' = block-scaled int8: ~4x fewer wire bytes at a bounded "
   "per-element error; see ARCHITECTURE §4d parity band)")
_d("train_dp_quorum", int, 0,
   "straggler quorum K for the dp gradient allreduce: each bucket "
   "completes once K of dp replicas contribute, late contributions fold "
   "into the next step (sum/mean semantics preserved cumulatively); "
   "0 = full participation.  The stage-0 commit-frame scalar allreduce "
   "always runs full-participation so clip/loss stay replica-consistent")

# --- Bench rig (_private/bench_rig.py; read via os.environ each call so
# --- benches can toggle mid-process, but declared here for dump/propagation)
_d("bench_rig", bool, True,
   "pin bench workers to dedicated cores where the box allows it; "
   "0 = unpinned fallback everywhere, rows stamped pinned=false")
_d("bench_pin_cpus", str, "",
   "comma-separated CPU pool bench-run workers pin themselves to at "
   "startup (exported by bench.py; empty = no pinning)")
_d("bench_serve_streams", int, 256,
   "concurrent SSE streams the serve_load bench drives against the "
   "2-replica llm_deployment")

# --- Runtime environments ---
_d("runtime_env_pip_no_index", bool, False,
   "pass --no-index to pip installs (hermetic/offline clusters)")
_d("runtime_env_pip_find_links", str, "",
   "extra --find-links wheel directory for pip runtime envs")
_d("runtime_env_setup_timeout_s", float, 600.0,
   "creating one pip/container env must finish within this")
_d("runtime_env_container_runtime", str, "",
   "container binary for image_uri envs ('docker'/'podman'; "
   "'fake' = in-process test double; auto-detect when empty)")
