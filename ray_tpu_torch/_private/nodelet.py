"""Port of ``ray_tpu/_private/nodelet.py``.

Nodelet: the per-node daemon (raylet equivalent).

Counterpart of the reference's raylet/NodeManager (reference:
src/ray/raylet/node_manager.h:119) fused with its helpers:

- worker pool: spawn/reuse/reap Python worker subprocesses
  (WorkerPool, raylet/worker_pool.h, PopWorkerCallbackAsync worker_pool.cc:186)
- lease-based local scheduler with spillback to the best node
  (ClusterTaskManager cluster_task_manager.cc:44 + LocalTaskManager dispatch loop
  local_task_manager.cc:122; hybrid policy hybrid_scheduling_policy.h:50)
- plasma store hosting + node-to-node object transfer (pull-based, chunked)
  (ObjectManager object_manager.h:117, PullManager pull_manager.h:52)
- placement-group bundle reservations (PlacementGroupResourceManager,
  raylet/placement_group_resource_manager.h) with 2PC prepare/commit/cancel
- GCS sync: register, periodic resource reports, cluster-view subscription
  (ray_syncer bidi stream equivalent), worker/actor death reporting

Design notes (TPU-host-native, not a translation): one asyncio process per node; the
plasma store lives on the nodelet loop (the reference embeds it in the raylet too);
liveness to workers is the persistent RPC connection + subprocess exit codes rather
than unix-socket heartbeats.
"""

from __future__ import annotations

import asyncio
import logging
import os
import subprocess
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import fault_injection, flight_recorder, incidents, rpc
from ray_tpu_torch._private.config import RayConfig, temp_root
from ray_tpu_torch._private.ids import NodeID, ObjectID, WorkerID
from ray_tpu_torch._private.object_store import PlasmaStore, register_store_handlers
from ray_tpu_torch.exceptions import ObjectStoreFullError

logger = logging.getLogger(__name__)


class _LeaseCancelled(Exception):
    """A queued lease request was cancelled by its client."""


class WorkerHandle:
    __slots__ = ("worker_id", "proc", "conn", "addr", "pid", "state", "lease_id",
                 "is_actor", "actor_id", "started_at", "idle_since",
                 "leased_since", "env_key")

    def __init__(self, worker_id: bytes, proc: Optional[subprocess.Popen],
                 env_key: str = ""):
        self.worker_id = worker_id
        self.proc = proc
        self.conn: Optional[rpc.Connection] = None
        self.addr: Optional[Tuple[str, int]] = None
        self.pid = proc.pid if proc else None
        self.state = "starting"  # starting -> idle -> leased | actor | retiring -> dead
        self.lease_id: Optional[int] = None
        self.is_actor = False
        self.actor_id: Optional[bytes] = None  # hosting this actor (re-reported on GCS reconnect)
        self.started_at = time.monotonic()
        self.idle_since = time.monotonic()
        self.leased_since = 0.0  # stamped when state flips to "leased"
        # isolation-env pool this worker belongs to ("" = default pool;
        # runtime_env.env_key of the pip/image env it was booted inside)
        self.env_key = env_key


class Bundle:
    __slots__ = ("pg_id", "index", "resources", "available", "committed")

    def __init__(self, pg_id: bytes, index: int, resources: Dict[str, float]):
        self.pg_id = pg_id
        self.index = index
        self.resources = dict(resources)
        self.available = dict(resources)
        self.committed = False


class Nodelet:
    def __init__(
        self,
        gcs_addr: Tuple[str, int],
        resources: Optional[Dict[str, float]] = None,
        object_store_memory: Optional[int] = None,
        session_dir: str = temp_root(),
        node_name: str = "",
        labels: Optional[Dict[str, str]] = None,
    ):
        self.node_id = NodeID.from_random()
        self.gcs_addr = gcs_addr
        self.session_dir = session_dir
        self.node_name = node_name or f"node-{self.node_id.hex()[:8]}"
        self.labels = labels or {}

        from ray_tpu_torch._private.resources import default_node_resources

        self.resources_total = default_node_resources(resources)
        self.resources_available = dict(self.resources_total)
        # a GPU lease's worker sees only the lease's cards
        from ray_tpu_torch.accelerators.gpu import CardPool, gpu_ids

        self.cards = CardPool(gpu_ids(int(self.resources_total.get("GPU", 0))))

        cap = object_store_memory or RayConfig.object_store_memory_bytes
        self.store = PlasmaStore(
            capacity_bytes=cap,
            spill_dir=os.path.join(session_dir, "spill", self.node_id.hex()[:8]),
            node_id_hex=self.node_id.hex(),
        )
        self.store.on_sealed = self._on_object_sealed
        self.store.on_deleted = self._on_object_deleted
        self.waiters: Dict[ObjectID, List[asyncio.Future]] = {}

        self.workers: Dict[bytes, WorkerHandle] = {}
        # (future, env_key) pairs waiting for an idle worker of that pool
        self._pop_queue: deque = deque()
        self._starting_count = 0
        self._starting_by_key: Dict[str, int] = {}
        # env_key -> worker-launch adjustments (venv python / image wrap),
        # resolved once per key by _prepare_env and reused by every spawn
        self._env_launch: Dict[str, dict] = {}
        self._env_pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="rtpu-envs")

        self.leases: Dict[int, dict] = {}
        self._lease_seq = 0
        self._queued_leases: deque = deque()  # (msg, future) waiting for resources
        # client token -> the future its lease request currently waits on
        # (resource queue or worker pop); cancellation resolves it with
        # _LeaseCancelled (reference: CancelWorkerLease,
        # normal_task_submitter.cc lease cancellation on queue drain)
        self._lease_waiters: Dict[str, asyncio.Future] = {}

        self.bundles: Dict[Tuple[bytes, int], Bundle] = {}

        self.cluster_view: Dict[bytes, dict] = {}  # node_id -> {addr,total,available}
        self.gcs: Optional[rpc.Connection] = None
        self._peer_conns: Dict[Tuple[str, int], rpc.Connection] = {}
        self._pulls_inflight: Set[ObjectID] = set()

        self._dir_added: List[bytes] = []
        self._dir_removed: List[bytes] = []
        # resource-shape -> (last_seen_ts, resources, last_warned_ts) of
        # recently-rejected lease requests: reported (deduped per shape) as
        # autoscaler demand until the submitter's retries land somewhere
        self._infeasible_demand: Dict[tuple, tuple] = {}

        handlers = {}
        register_store_handlers(handlers, self.store, self.waiters,
                                on_miss=self._on_store_miss,
                                on_full=self._broadcast_extent_reclaim)
        for name in dir(self):
            if name.startswith("rpc_"):
                handlers[name[4:]] = getattr(self, name)
        handlers["publish"] = self._on_publish
        self.handlers = handlers
        self.server = rpc.Server(handlers, name=f"nodelet-{self.node_id.hex()[:6]}")
        self.server.on_disconnect = self._on_conn_lost
        self.addr: Tuple[str, int] = ("", 0)
        self._bg: List[asyncio.Task] = []
        self._shutting_down = False
        self._gcs_reconnecting = False
        self._disk_full = False
        # hang watchdog: (task_id hex, attempt) -> flag record of tasks
        # currently running past their threshold on this node
        self._suspected_hung: Dict[Tuple[str, int], dict] = {}

    # ------------------------------------------------------------------ boot
    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
        self.addr = await self.server.start(host, port)
        # This process's own black box + incident publisher (the nodelet has
        # no core worker, so incidents ride its GCS connection instead)
        flight_recorder.init_process(self.session_dir,
                                     f"nodelet-{self.node_id.hex()}")
        incidents.set_publisher(self._publish_incident)
        # Prometheus scrape endpoint for this node's merged metrics
        # (reference: the per-node metrics agent, _private/metrics_agent.py:483)
        from ray_tpu_torch._private.metrics import default_registry, serve_metrics_http

        self.metrics_registry = default_registry
        # bind the same interface as the RPC server: a loopback-bound scrape
        # endpoint would be advertised cluster-wide yet unreachable remotely
        self.metrics_addr = await serve_metrics_http(default_registry,
                                                     host=self.addr[0] or host)
        await self._connect_gcs()
        if self.gcs.closed:  # dropped before _on_close was attached
            self._on_gcs_lost(self.gcs)
        self._bg.append(asyncio.get_event_loop().create_task(self._report_loop()))
        self._bg.append(asyncio.get_event_loop().create_task(self._monitor_workers_loop()))
        self._bg.append(asyncio.get_event_loop().create_task(self._flush_dir_loop()))
        self._bg.append(asyncio.get_event_loop().create_task(self._fs_monitor_loop()))
        self._bg.append(asyncio.get_event_loop().create_task(self._hang_watchdog_loop()))
        # The nodelet's own threads join the cluster flamegraph too (no-op
        # unless profile_hz > 0); its deltas ship via _report_loop's push.
        from ray_tpu_torch._private import profiler

        profiler.ensure_started()
        logger.info("nodelet %s on %s:%s resources=%s",
                    self.node_id.hex()[:8], *self.addr, self.resources_total)
        return self.addr

    async def _connect_gcs(self):
        """Connect + (re)register with the GCS.  Registration always carries
        the node's FULL live state — hosted actors, PG bundles, local objects
        — so a restarted GCS reconciles its restored tables against reality
        (reference: ray_syncer resync + GcsInitData replay on GCS failover).

        self.gcs is swapped only AFTER registration succeeds, and the close
        callback is attached last: a half-initialized connection must neither
        receive resource reports (a not-yet-registered node would be told
        'unknown') nor spawn a second reconnect loop when it fails."""
        # Full handler table: the GCS calls back over this same connection
        # (lease_worker_for_actor, prepare/commit/cancel_bundle, ...).
        gcs = await rpc.connect(*self.gcs_addr, handlers=self.handlers,
                                name="nodelet->gcs")
        resp = await gcs.call("register_node", {
            "node_id": self.node_id.binary(),
            "addr": list(self.addr),
            "resources": self.resources_total,
            "labels": self.labels,
            "node_name": self.node_name,
            "object_store_capacity": self.store.capacity,
            "metrics_addr": list(getattr(self, "metrics_addr", ("", 0))),
            "actors": [
                {"actor_id": w.actor_id, "worker_addr": list(w.addr),
                 "worker_id": w.worker_id}
                for w in self.workers.values()
                if w.is_actor and w.actor_id is not None and w.addr
                and w.state != "dead"
            ],
            "bundles": [
                {"pg_id": b.pg_id, "index": b.index, "resources": b.resources}
                for b in self.bundles.values() if b.committed
            ],
            "objects": [oid.binary() for oid, e in self.store.objects.items()
                        if e.sealed],
        })
        for view in resp["cluster_view"]:
            self.cluster_view[view["node_id"]] = view
        await gcs.call("subscribe", {"channel": "resource_view"})
        await gcs.call("subscribe", {"channel": "node"})
        old, self.gcs = self.gcs, gcs
        if old is not None and old is not gcs and not old.closed:
            await old.close()
        gcs._on_close = self._on_gcs_lost

    def _on_gcs_lost(self, conn):
        if self._shutting_down or self._gcs_reconnecting:
            return
        self._gcs_reconnecting = True
        logger.warning("nodelet %s lost the GCS connection; reconnecting",
                       self.node_id.hex()[:8])
        asyncio.get_event_loop().create_task(self._gcs_reconnect_loop())

    async def _gcs_reconnect_loop(self):
        """Retry the GCS with backoff (reference: raylets reconnect to a
        restarted GCS when FT is on); give up and die after the window —
        an isolated nodelet holding a TPU chip is worse than a dead one."""
        deadline = time.monotonic() + RayConfig.gcs_reconnect_timeout_s
        delay = 0.2
        try:
            while not self._shutting_down:
                await asyncio.sleep(delay)
                try:
                    await self._connect_gcs()
                    if self.gcs.closed:
                        continue  # dropped in the attach window: retry
                    logger.info("nodelet %s re-registered with the GCS",
                                self.node_id.hex()[:8])
                    return
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    if time.monotonic() > deadline:
                        logger.error(
                            "GCS unreachable for %.0fs; nodelet exiting",
                            RayConfig.gcs_reconnect_timeout_s)
                        os._exit(1)
                    delay = min(delay * 1.5, 3.0)
        finally:
            self._gcs_reconnecting = False

    async def stop(self):
        self._shutting_down = True
        for t in self._bg:
            t.cancel()
        for w in list(self.workers.values()):
            self._kill_worker_proc(w)
        await self.server.stop()
        if self.gcs is not None:
            await self.gcs.close()
        for c in self._peer_conns.values():
            await c.close()
        self.store.shutdown()

    # ------------------------------------------------------------- pubsub in
    async def _on_publish(self, conn, msg):
        channel, data = msg["channel"], msg["data"]
        if channel == "resource_view":
            version = data.get("version")
            view = self.cluster_view.get(data["node_id"])
            if view is not None:
                last = view.get("view_version")
                if version is not None and last is not None and \
                        version <= last:
                    return  # stale/reordered delta: versions apply monotonically
                view["available"] = data["available"]
                view["total"] = data["total"]
                if version is not None:
                    view["view_version"] = version
            else:
                self.cluster_view[data["node_id"]] = {
                    "node_id": data["node_id"], "available": data["available"],
                    "total": data["total"], "addr": None, "alive": True,
                    "view_version": version,
                }
            self._pump_queued_leases()
        elif channel == "node":
            node = msg["data"]["node"]
            if msg["data"]["event"] == "added":
                self.cluster_view[node["node_id"]] = node
            else:
                self.cluster_view.pop(node["node_id"], None)

    # ---------------------------------------------------------- gcs reports
    async def _report_loop(self):
        interval = RayConfig.heartbeat_interval_ms / 1000.0
        # Versioned resource view (reference: ray_syncer.proto:62 versioned
        # snapshots): the version bumps ONLY when the view changes, so the
        # GCS can skip rebroadcasting unchanged reports — steady-state sync
        # traffic drops to liveness pings instead of O(nodes^2) view spam.
        view_version = 0
        last_fingerprint = None
        while True:
            await asyncio.sleep(interval)
            try:
                # Pending demand: resource shapes of leases queued behind
                # busy capacity — the autoscaler's scale-up signal
                # (reference: ResourceLoad in the raylet's report).
                demand = [dict(res) for res, _b, f in self._queued_leases
                          if not f.done()]
                cutoff = time.monotonic() - 5.0
                for shape in list(self._infeasible_demand):
                    ts, res, _w = self._infeasible_demand[shape]
                    if ts < cutoff:
                        del self._infeasible_demand[shape]
                    else:
                        demand.append(dict(res))
                self._update_builtin_metrics()
                # Zero-resource actors (num_cpus=0 queues, Serve replicas)
                # don't show up in resource accounting, so the autoscaler
                # must not infer idleness from available==total alone.
                busy = sum(1 for w in self.workers.values()
                           if w.state == "leased"
                           or (w.is_actor and w.state != "dead"))
                # fingerprint covers ONLY the broadcast payload
                # (available/total): demand and busy-count ride every report
                # regardless, and versioning them would rebroadcast identical
                # views on queue churn
                fingerprint = (tuple(sorted(self.resources_available.items())),
                               tuple(sorted(self.resources_total.items())))
                if fingerprint != last_fingerprint:
                    view_version += 1
                    last_fingerprint = fingerprint
                from ray_tpu_torch._private import profiler

                if profiler.SAMPLING:
                    delta = profiler.take_delta()
                    if delta:
                        await self.gcs.notify("profile_push", {
                            "node_id": self.node_id.hex(),
                            "entries": delta})
                resp = await self.gcs.call("resource_report", {
                    "node_id": self.node_id.binary(),
                    "available": self.resources_available,
                    "total": self.resources_total,
                    "pending_demand": demand,
                    "busy_workers": busy,
                    "version": view_version,
                }, timeout=RayConfig.gcs_rpc_timeout_s)
                if resp.get("dead"):
                    logger.error("GCS declared this node dead; exiting")
                    os._exit(1)
                if resp.get("unknown") and not self._gcs_reconnecting:
                    # A restarted GCS hasn't seen us: re-register in place.
                    self._gcs_reconnecting = True
                    try:
                        await self._connect_gcs()
                        logger.info("nodelet %s re-registered after GCS "
                                    "restart", self.node_id.hex()[:8])
                    except (ConnectionError, OSError, asyncio.TimeoutError):
                        pass
                    finally:
                        self._gcs_reconnecting = False
            except (ConnectionError, asyncio.TimeoutError):
                logger.warning("GCS unreachable from nodelet %s", self.node_id.hex()[:8])

    def _update_builtin_metrics(self):
        """Node-level gauges (reference: metric_defs.cc canonical metrics)."""
        from ray_tpu_torch._private import metrics as M

        if not hasattr(self, "_m_resources"):
            self._m_resources = M.Gauge(
                "node_resources_available", "available per resource")
            self._m_resources_total = M.Gauge(
                "node_resources_total", "total per resource")
            self._m_workers = M.Gauge("node_workers", "worker processes")
            self._m_store_bytes = M.Gauge(
                "object_store_bytes_used", "plasma bytes in use")
            self._m_store_objects = M.Gauge(
                "object_store_objects", "local objects")
            self._m_store_capacity = M.Gauge(
                "object_store_capacity_bytes", "plasma capacity")
            self._m_store_arena = M.Gauge(
                "object_store_arena_bytes",
                "pre-faulted arena slab bytes (live + leased + free)")
            self._m_mem_used = M.Gauge(
                "node_mem_used_bytes", "host memory in use")
            self._m_mem_total = M.Gauge(
                "node_mem_total_bytes", "host memory total")
        nid = self.node_id.hex()[:12]
        for k, v in self.resources_available.items():
            self._m_resources.set(v, {"node": nid, "resource": k})
        for k, v in self.resources_total.items():
            self._m_resources_total.set(v, {"node": nid, "resource": k})
        self._m_workers.set(
            sum(1 for w in self.workers.values() if w.state != "dead"),
            {"node": nid})
        st = self.store.stats()
        self._m_store_bytes.set(st.get("used", 0), {"node": nid})
        self._m_store_objects.set(st.get("num_objects", len(self.store.objects)),
                                  {"node": nid})
        self._m_store_capacity.set(self.store.capacity, {"node": nid})
        self._m_store_arena.set(st.get("arena_bytes", 0), {"node": nid})
        from ray_tpu_torch._private.memory_monitor import _read_meminfo

        mem = _read_meminfo()
        if mem is not None:
            self._m_mem_used.set(mem[0], {"node": nid})
            self._m_mem_total.set(mem[1], {"node": nid})

    async def rpc_metrics_push(self, conn, msg):
        """A worker pushes its metric snapshot for this node's scrape
        endpoint (reference: core-worker -> metrics agent export)."""
        self.metrics_registry.merge_pushed(msg["source"], msg["snapshot"])
        profile = msg.get("profile")
        if profile:
            # piggybacked profiler delta: forward to the GCS aggregate (the
            # nodelet only relays — cluster-wide merging happens once)
            try:
                await self.gcs.notify("profile_push", {
                    "node_id": self.node_id.hex(), "entries": profile})
            except (ConnectionError, rpc.ConnectionLost):
                pass  # observability must never fail the push path
        return True

    async def rpc_get_metrics_text(self, conn, msg):
        return self.metrics_registry.prometheus_text()

    # --------------------------------------------------------- disk monitor
    def _disk_usage_fraction(self) -> Optional[float]:
        """Fraction of the session-dir filesystem in use (test hook:
        RAY_TPU_TORCH_FAKE_DISK_USAGE)."""
        fake = os.environ.get("RAY_TPU_TORCH_FAKE_DISK_USAGE")
        if fake:
            try:
                return float(fake)
            except ValueError:
                pass
        try:
            st = os.statvfs(self.session_dir)
        except OSError:
            return None
        total = st.f_blocks * st.f_frsize
        if total <= 0:
            return None
        return 1.0 - (st.f_bavail * st.f_frsize) / total

    async def _fs_monitor_loop(self):
        """Reject new work while the local filesystem is nearly full
        (reference: _private/utils FileSystemMonitor + raylet's
        over-capacity rejection): a full disk fails spills, log writes, and
        runtime-env installs in ways that masquerade as unrelated bugs —
        better to stop taking leases and say why."""
        while True:
            frac = self._disk_usage_fraction()
            threshold = RayConfig.local_fs_capacity_threshold
            over = frac is not None and frac >= threshold
            if over and not self._disk_full:
                logger.warning(
                    "local filesystem is %.1f%% full (threshold %.0f%%): "
                    "this node stops accepting new leases until space "
                    "frees up", frac * 100, threshold * 100)
            elif self._disk_full and not over:
                logger.info("local filesystem back under the capacity "
                            "threshold; accepting leases again")
            self._disk_full = over
            await asyncio.sleep(RayConfig.fs_monitor_interval_s)

    # ------------------------------------------------------------- log files
    def _log_dir(self) -> str:
        return os.path.join(self.session_dir, "logs")

    async def rpc_list_workers(self, conn, msg):
        """This node's worker processes (reference: util/state list_workers
        — worker id, pid, state, actor binding, env pool, uptime)."""
        now = time.monotonic()
        out = []
        for w in self.workers.values():
            out.append({
                "worker_id": w.worker_id.hex() if hasattr(w.worker_id, "hex")
                else bytes(w.worker_id).hex(),
                "pid": w.pid,
                "state": w.state,
                "is_actor": w.is_actor,
                "actor_id": w.actor_id.hex() if w.actor_id else None,
                "env_key": w.env_key,
                "uptime_s": round(now - w.started_at, 1),
            })
        return out

    async def rpc_list_log_files(self, conn, msg):
        """Names + sizes of this node's log files (worker stdout/stderr,
        nodelet/gcs logs) — the `ray logs` surface (reference:
        python/ray/_private/log_monitor.py; dashboard log module)."""
        log_dir = self._log_dir()
        out = []
        try:
            names = sorted(os.listdir(log_dir))
        except FileNotFoundError:
            return out
        for name in names:
            path = os.path.join(log_dir, name)
            try:
                if not os.path.isfile(path):
                    continue
                st = os.stat(path)
            except FileNotFoundError:
                continue  # rotated/unlinked between listdir and stat
            out.append({"name": name, "size": st.st_size,
                        "mtime": st.st_mtime})
        return out

    async def rpc_tail_log(self, conn, msg):
        """Last ``nbytes`` of one log file.  The name is sanitized to a
        basename inside the session logs dir — no path traversal."""
        name = os.path.basename(msg["name"])
        path = os.path.join(self._log_dir(), name)
        nbytes = min(int(msg.get("nbytes", 64 * 1024)), 4 * 1024 * 1024)
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - nbytes))
                return f.read()
        except FileNotFoundError:
            return None

    # ------------------------------------------------- stacks / hang watchdog
    def _live_worker_conns(self) -> List[WorkerHandle]:
        return [w for w in self.workers.values()
                if w.conn is not None and not w.conn.closed
                and w.state not in ("starting", "dead")]

    async def rpc_rpc_stats(self, conn, msg):
        """Per-method served-RPC counters over this nodelet's live
        connections ({method: {count, total_s}}); `ray_tpu_torch summary rpc`
        cross-checks the observed names against the static wire contract."""
        agg: Dict[str, list] = {}
        for c in self.server.connections:
            for method, (count, total_s) in c.handler_stats().items():
                st = agg.setdefault(method, [0, 0.0])
                st[0] += count
                st[1] += total_s
        return {m: {"count": v[0], "total_s": v[1]}
                for m, v in agg.items()}

    async def rpc_dump_stacks(self, conn, msg):
        """Fan `dump_stacks` out to every registered worker on this node and
        capture the nodelet's own threads (the `ray_tpu_torch stack` node payload;
        reference: `ray stack` shells out to py-spy per process — here each
        process samples itself via sys._current_frames()).  ``task_id``
        narrows the reply to workers currently executing that task."""
        from ray_tpu_torch._private.introspect import capture_thread_stacks

        msg = msg or {}
        task_id = msg.get("task_id")

        async def one(w: WorkerHandle):
            try:
                return await w.conn.call("dump_stacks", None, timeout=10)
            except (ConnectionError, rpc.ConnectionLost,
                    asyncio.TimeoutError):
                return None

        dumps = await asyncio.gather(*(one(w)
                                       for w in self._live_worker_conns()))
        workers = [d for d in dumps if d is not None]
        if task_id:
            workers = [d for d in workers
                       if any(t["task_id"].startswith(task_id)
                              for t in d.get("running_tasks", []))]
        out = {"node_id": self.node_id.hex(), "addr": list(self.addr),
               "workers": workers}
        if not task_id:
            out["nodelet"] = {"kind": "nodelet", "pid": os.getpid(),
                              "threads": capture_thread_stacks(),
                              "running_tasks": []}
        return out

    @staticmethod
    def _env_float(name: str, default: float) -> float:
        """Live env override (read per tick, unlike RayConfig's first-read
        cache) so tests and operators can retune the watchdog on a running
        node via the set_env hook / environment."""
        raw = os.environ.get(name)
        if raw:
            try:
                return float(raw)
            except ValueError:
                pass
        return default

    async def _hang_watchdog_loop(self):
        """Flag tasks running suspiciously long (reference: the dashboard's
        hanging-task diagnosis from task events).  Each tick polls every
        busy worker's running tasks; a task is suspected hung past
        max(hang_p95_multiplier x its name's recent exec p95,
        hang_p95_floor_s), or past the absolute RAY_TPU_TORCH_HANG_THRESHOLD_S
        when no history exists.  First flag attaches a one-shot stack dump
        and rides the task-event pipeline; the ray_tpu_suspected_hung_tasks
        gauge tracks the live count."""
        from ray_tpu_torch._private import metrics as M

        m_hung = M.Gauge("suspected_hung_tasks",
                         "running tasks past their hang threshold, per node")
        nid = self.node_id.hex()[:12]
        while True:
            interval = self._env_float("RAY_TPU_TORCH_HANG_WATCHDOG_INTERVAL_S",
                                       RayConfig.hang_watchdog_interval_s)
            if interval <= 0:
                await asyncio.sleep(2.0)
                continue
            await asyncio.sleep(interval)
            try:
                await self._hang_watchdog_tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("hang watchdog tick failed")
            m_hung.set(len(self._suspected_hung), {"node": nid})

    async def _hang_watchdog_tick(self):
        threshold = self._env_float("RAY_TPU_TORCH_HANG_THRESHOLD_S",
                                    RayConfig.hang_threshold_s)
        mult = RayConfig.hang_p95_multiplier
        floor = RayConfig.hang_p95_floor_s
        min_samples = RayConfig.hang_min_samples
        events = []
        seen: Set[Tuple[str, int]] = set()
        for w in self._live_worker_conns():
            try:
                tasks = await w.conn.call("get_running_tasks", None,
                                          timeout=10)
            except (ConnectionError, rpc.ConnectionLost,
                    asyncio.TimeoutError):
                continue
            for t in tasks:
                key = (t["task_id"], t.get("attempt", 0))
                seen.add(key)
                p95, samples = t.get("p95_s"), t.get("samples", 0)
                elapsed = t["elapsed_s"]
                limit = threshold
                if p95 is not None and samples >= min_samples:
                    limit = min(limit, max(mult * p95, floor))
                if elapsed <= limit or key in self._suspected_hung:
                    continue
                stack = await self._task_stack(w, t["task_id"])
                self._suspected_hung[key] = {
                    "worker_id": w.worker_id.hex(), "flagged_at": time.time()}
                logger.warning(
                    "task %s (%s) has been running %.1fs (threshold %.1fs): "
                    "suspected hung; stack attached to its task row",
                    t["task_id"][:16], t["name"], elapsed, limit)
                events.append({
                    "task_id": t["task_id"], "attempt": t.get("attempt", 0),
                    "name": t["name"], "state": "HUNG", "ts": time.time(),
                    "node_id": self.node_id.hex(),
                    "worker_id": w.worker_id.hex(),
                    "elapsed_s": round(elapsed, 3),
                    "threshold_s": round(limit, 3),
                    "stack": stack,
                })
        # a flagged task that stopped running (finished/failed/worker died)
        # clears here; its terminal lifecycle event clears the state fold
        for key in [k for k in self._suspected_hung if k not in seen]:
            del self._suspected_hung[key]
        if events:
            try:
                await self.gcs.notify("add_task_events", {"events": events})
            except ConnectionError:
                pass
            # One-shot hung stacks join the cluster flamegraph too (tagged
            # 'hung' at render time) — a hung task shows up in the profile
            # even when continuous sampling is off, not only in /api/hangs.
            from ray_tpu_torch._private.profiler import fold_formatted_stack

            entries = [
                [ev["name"] or "", "core",
                 fold_formatted_stack(ev["stack"]), 1, "hung"]
                for ev in events if ev.get("stack")]
            if entries:
                try:
                    await self.gcs.notify("profile_push", {
                        "node_id": self.node_id.hex(), "entries": entries})
                except ConnectionError:
                    pass

    async def _task_stack(self, w: WorkerHandle, task_id: str):
        """One-shot stack dump of the worker, reduced to the executing
        task's thread (whole-process dump as fallback for async tasks)."""
        try:
            dump = await w.conn.call("dump_stacks", None, timeout=10)
        except (ConnectionError, rpc.ConnectionLost, asyncio.TimeoutError):
            return None
        for t in dump.get("threads", []):
            if t.get("task_id") == task_id:
                return t["stack"]
        from ray_tpu_torch._private.introspect import format_stack_payload

        return format_stack_payload(dump)

    async def _flush_dir_loop(self):
        while True:
            await asyncio.sleep(0.05)
            if self._dir_added:
                batch, self._dir_added = self._dir_added, []
                try:
                    await self.gcs.notify("object_locations_added",
                                          {"node_id": self.node_id.binary(), "oids": batch})
                except ConnectionError:
                    pass
            if self._dir_removed:
                batch, self._dir_removed = self._dir_removed, []
                try:
                    await self.gcs.notify("object_locations_removed",
                                          {"node_id": self.node_id.binary(), "oids": batch})
                except ConnectionError:
                    pass

    def _on_object_sealed(self, oid: ObjectID, size: int):
        self._dir_added.append(oid.binary())

    def _on_object_deleted(self, oid: ObjectID):
        self._dir_removed.append(oid.binary())

    # -------------------------------------------------------- object transfer
    def _on_store_miss(self, oid: ObjectID):
        if oid in self._pulls_inflight:
            return
        self._pulls_inflight.add(oid)
        asyncio.get_event_loop().create_task(self._pull(oid))

    async def _pull(self, oid: ObjectID):
        """Pull one object from any remote holder (reference: PullManager +
        chunked push, object_manager.proto:61; pull-retries until a holder appears)."""
        try:
            delay = 0.05
            while not self.store.contains(oid):
                if self._shutting_down:
                    return
                try:
                    locs = await self.gcs.call("get_object_locations", {"oids": [oid.binary()]})
                except ConnectionError:
                    return
                addrs = [tuple(a) for a in locs.get(oid.binary(), [])]
                addrs = [a for a in addrs if a != self.addr]
                fetched = False
                for addr in addrs:
                    if await self._fetch_from(addr, oid):
                        fetched = True
                        break
                if fetched:
                    break
                # No holder yet: the object may still be being produced; waiters
                # are resolved by seal (local production) or a later pull round.
                await asyncio.sleep(delay)
                delay = min(delay * 2, 1.0)
            for fut in self.waiters.pop(oid, []):
                if not fut.done():
                    fut.set_result(True)
        finally:
            self._pulls_inflight.discard(oid)

    async def _peer(self, addr: Tuple[str, int]) -> rpc.Connection:
        conn = self._peer_conns.get(addr)
        if conn is None or conn.closed:
            conn = await rpc.connect(*addr, name=f"nodelet-peer-{addr[1]}")
            self._peer_conns[addr] = conn
        return conn

    async def _fetch_from(self, addr: Tuple[str, int], oid: ObjectID) -> bool:
        """Chunked pull of one object from one holder, with bounded in-flight
        bytes (reference: PullManager admission pull_manager.h:52, chunked
        transfer object_manager.proto:61).  A multi-GiB object never becomes
        one giant RPC frame; chunks land directly in the pre-allocated local
        segment."""
        chunk = RayConfig.fetch_chunk_bytes
        timeout = RayConfig.gcs_rpc_timeout_s
        try:
            conn = await self._peer(addr)
            # the first chunk also carries the total size, so sub-chunk
            # objects (the common case) complete in ONE round trip
            first = await conn.call(
                "fetch_object_chunk",
                {"oid": oid.binary(), "off": 0, "len": chunk},
                timeout=timeout)
            if first is None:
                return False
            size = first["size"]
            if size <= chunk:
                self.store.write_and_seal(oid, memoryview(first["data"]),
                                          is_primary=False)
                return True
            try:
                self.store.create(oid, size, is_primary=False)
            except FileExistsError:
                return self.store.contains(oid)  # sealed locally mid-pull
            buf = self.store.write_buffer(oid)
            buf[0:len(first["data"])] = first["data"]
            sem = asyncio.Semaphore(
                max(RayConfig.object_transfer_inflight_bytes // chunk, 1))
            failed = False

            async def fetch_chunk(off: int):
                nonlocal failed
                async with sem:
                    if failed:
                        return
                    try:
                        resp = await conn.call(
                            "fetch_object_chunk",
                            {"oid": oid.binary(), "off": off,
                             "len": min(chunk, size - off)},
                            timeout=timeout)
                    except (ConnectionError, asyncio.TimeoutError):
                        failed = True
                        return
                    if resp is None:  # holder evicted it mid-transfer
                        failed = True
                        return
                    buf[off:off + len(resp["data"])] = resp["data"]

            await asyncio.gather(
                *[fetch_chunk(off) for off in range(chunk, size, chunk)])
            if failed:
                self.store.abort(oid)
                return False
            try:
                self.store.seal(oid)
            except KeyError:
                return False  # freed mid-transfer; caller re-loops
            return True
        except (ConnectionError, asyncio.TimeoutError, ObjectStoreFullError):
            self.store.abort(oid)
            return False

    async def rpc_fetch_object_chunk(self, conn, msg):
        mv = self.store.read_bytes(ObjectID(msg["oid"]))
        if mv is None:
            return None
        off, ln = msg["off"], msg["len"]
        # bytes() copy: bounded by the chunk size, and decouples the send
        # from store eviction.
        return {"size": mv.nbytes, "data": bytes(mv[off:off + ln])}

    async def rpc_free_local_objects(self, conn, msg):
        for b in msg["oids"]:
            self.store.delete(ObjectID(b))
        return True

    # ------------------------------------------------------------ worker pool
    def _spawn_worker(self, env_key: str = "") -> WorkerHandle:
        worker_id = WorkerID.from_random()
        log_dir = os.path.join(self.session_dir, "logs")
        os.makedirs(log_dir, exist_ok=True)
        out = open(os.path.join(log_dir, f"worker-{worker_id.hex()[:8]}.out"), "ab")
        env = dict(os.environ)
        env.update(RayConfig.overrides_as_env())
        env["RAY_TPU_TORCH_NODE_ID"] = self.node_id.hex()
        launch = self._env_launch.get(env_key) if env_key else None
        python = sys.executable
        if launch is not None and launch.get("python"):
            # venv worker: the framework itself must stay importable from
            # the venv interpreter (--system-site-packages covers installed
            # deps; PYTHONPATH covers a source checkout)
            python = launch["python"]
            repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            env["PYTHONPATH"] = repo_root + (
                os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        cmd = [
            python, "-u", "-m", "ray_tpu_torch._private.worker_main",
            "--nodelet-host", self.addr[0], "--nodelet-port", str(self.addr[1]),
            "--gcs-host", self.gcs_addr[0], "--gcs-port", str(self.gcs_addr[1]),
            "--worker-id", worker_id.hex(),
            "--node-id", self.node_id.hex(),
            "--session-dir", self.session_dir,
        ]
        if launch is not None and launch.get("image"):
            from ray_tpu_torch.runtime_env.container import wrap_worker_command

            cmd, extra_env = wrap_worker_command(
                launch["image"], cmd, env, self.session_dir,
                launch.get("image_args"))
            env.update(extra_env)
        proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, env=env,
                                cwd=os.getcwd())
        out.close()
        h = WorkerHandle(worker_id.binary(), proc, env_key=env_key)
        self.workers[worker_id.binary()] = h
        self._starting_count += 1
        if env_key:
            self._starting_by_key[env_key] = \
                self._starting_by_key.get(env_key, 0) + 1
        return h

    async def rpc_register_worker(self, conn, msg):
        wid = msg["worker_id"]
        h = self.workers.get(wid)
        if h is None:
            # A worker we didn't spawn (e.g. driver connecting as a client).
            return {"ok": True, "driver": True}
        h.conn = conn
        h.addr = tuple(msg["addr"])
        # the worker's self-reported pid wins over the spawner's proc.pid:
        # under a pid namespace the two differ, and the self-reported one is
        # what appears in the worker's own logs and flight-recorder records
        h.pid = msg.get("pid", h.pid)
        h.state = "idle"
        h.idle_since = time.monotonic()
        self._starting_count = max(0, self._starting_count - 1)
        if h.env_key:
            self._starting_by_key[h.env_key] = max(
                0, self._starting_by_key.get(h.env_key, 0) - 1)
        conn.context["worker_id"] = wid
        self._fulfill_pops()
        return {"ok": True}

    def _idle_workers(self, env_key: str = "") -> List[WorkerHandle]:
        return [w for w in self.workers.values()
                if w.state == "idle" and w.env_key == env_key]

    def _fulfill_pops(self):
        # match waiters to idle workers of the SAME env pool; leave
        # unmatched waiters queued (their pool's worker is still booting)
        unmatched: deque = deque()
        while self._pop_queue:
            fut, env_key = self._pop_queue.popleft()
            if fut.done():
                continue
            idle = self._idle_workers(env_key)
            if not idle:
                unmatched.append((fut, env_key))
                continue
            w = idle[0]
            w.state = "leased"
            w.leased_since = time.monotonic()
            fut.set_result(w)
        self._pop_queue = unmatched
        # Maintain pipeline: spawn if LIVE demand outstrips starting workers —
        # cancelled pops (done futures) must not trigger spawns, or a drained
        # burst leaves a late wave of workers booting (pure CPU theft on small
        # hosts) with no tasks to run.  Deficits are per env pool: a venv
        # waiter is never satisfied by a default-pool boot.
        live_by_key: Dict[str, int] = {}
        for f, k in self._pop_queue:
            if not f.done():
                live_by_key[k] = live_by_key.get(k, 0) + 1
        budget = RayConfig.maximum_startup_concurrency - self._starting_count
        for k, live in live_by_key.items():
            starting = self._starting_by_key.get(k, 0) if k else (
                self._starting_count
                - sum(self._starting_by_key.values()))
            deficit = live - starting
            for _ in range(min(max(deficit, 0), max(budget, 0))):
                self._spawn_worker(k)
                budget -= 1

    async def _pop_worker(self, token: Optional[str] = None,
                          env_key: str = "") -> WorkerHandle:
        idle = self._idle_workers(env_key)
        if idle:
            w = idle[0]
            w.state = "leased"
            w.leased_since = time.monotonic()
            return w
        fut = asyncio.get_event_loop().create_future()
        self._pop_queue.append((fut, env_key))
        if token:
            self._lease_waiters[token] = fut
        starting_here = self._starting_by_key.get(env_key, 0) if env_key \
            else self._starting_count - sum(self._starting_by_key.values())
        if self._starting_count < RayConfig.maximum_startup_concurrency \
                or (env_key and starting_here == 0):
            self._spawn_worker(env_key)
        try:
            return await fut
        finally:
            if token:
                self._lease_waiters.pop(token, None)

    async def _prepare_env(self, env_key: str, runtime_env: dict) -> None:
        """Resolve an isolation env (pip venv build / container image) into
        launch adjustments, cached per env_key.  Runs in the env thread pool
        so a venv build never blocks the event loop — the nodelet plays the
        reference runtime-env agent's role in-process (reference:
        runtime_env/agent/runtime_env_agent.py GetOrCreateRuntimeEnv)."""
        if env_key in self._env_launch:
            return
        from ray_tpu_torch import runtime_env as renv_mod

        launch = await asyncio.get_event_loop().run_in_executor(
            self._env_pool, renv_mod.prepare_worker_launch,
            runtime_env, self.session_dir)
        self._env_launch[env_key] = launch or {}

    async def rpc_cancel_lease_requests(self, conn, msg):
        """Client gave up on outstanding lease requests (its task queue
        drained); resolve their waits so no worker is spawned/held for them."""
        cancelled = 0
        for token in msg.get("tokens", ()):
            fut = self._lease_waiters.pop(token, None)
            if fut is not None and not fut.done():
                fut.set_exception(_LeaseCancelled())
                cancelled += 1
        await self._reap_surplus_starting()
        return {"cancelled": cancelled}

    async def _reap_surplus_starting(self) -> None:
        """With no live demand, kill workers still BOOTING: a Python worker
        costs ~2 s of pure CPU to start, and on small hosts a wave of
        no-longer-needed boots visibly steals the cores from whatever runs
        next.  Booted (idle) workers are kept — they are already paid for."""
        if any(not f.done() for f, _k in self._pop_queue):
            return
        # leases queued on resources will need workers the moment capacity
        # frees — their boots are not surplus
        if any(not f.done() for _, _, f in self._queued_leases):
            return
        for w in list(self.workers.values()):
            if w.state == "starting" and w.proc is not None:
                self._kill_worker_proc(w)
                # intentional reap, not a crash: no GCS worker_died report
                await self._handle_worker_death(w, "surplus boot reaped",
                                                report=False)

    async def _monitor_workers_loop(self):
        from ray_tpu_torch._private.memory_monitor import MemoryMonitor

        mm = MemoryMonitor(RayConfig.memory_usage_threshold) \
            if RayConfig.memory_monitor_refresh_ms > 0 else None
        last_mm_check = 0.0
        while True:
            await asyncio.sleep(0.2)
            # refresh each tick so a schedule armed at runtime (rpc_set_env
            # test hook) takes effect live; unchanged schedules cost one env
            # read + string compare
            fault_injection.refresh()
            if fault_injection.ENABLED and fault_injection.hit(
                    "nodelet.tick", detail=self.node_id.hex()) == "kill":
                fault_injection.kill_self()
            for w in list(self.workers.values()):
                if w.proc is not None and w.proc.poll() is not None and w.state != "dead":
                    await self._handle_worker_death(w, f"exit code {w.proc.returncode}")
            # Reap long-idle workers.
            now = time.monotonic()
            reap_after = RayConfig.idle_worker_killing_time_ms / 1000.0
            for w in list(self.workers.values()):
                if w.state == "retiring" or (
                        w.state == "idle" and now - w.idle_since > reap_after):
                    self._kill_worker_proc(w)
                    await self._handle_worker_death(w, "idle reaped", report=False)
            # Memory pressure: kill the cheapest-to-retry worker before the
            # kernel OOM-killer shoots something load-bearing (reference:
            # MemoryMonitor + retriable-FIFO worker killing policy).
            if mm is not None and \
                    now - last_mm_check > RayConfig.memory_monitor_refresh_ms / 1000.0:
                last_mm_check = now
                if mm.is_pressured():
                    victim = self._pick_oom_victim()
                    if victim is not None:
                        frac = mm.usage_fraction()
                        logger.warning(
                            "node memory at %.0f%% (threshold %.0f%%): "
                            "killing worker %s to relieve pressure",
                            (frac or 0) * 100,
                            RayConfig.memory_usage_threshold * 100,
                            victim.worker_id.hex()[:8])
                        await self._notify_pressure_kill(victim)
                        self._kill_worker_proc(victim)
                        await self._handle_worker_death(
                            victim, "killed by the memory monitor: node "
                            "memory usage above threshold")

    def _pick_oom_victim(self):
        """Idle workers first (zero work lost), then the task worker with
        the NEWEST lease (least progress lost), actors only as a last resort
        — their state dies with them (reference:
        worker_killing_policy_group_by_owner / _retriable_fifo, approximated:
        the nodelet never sees the task spec, so per-task retriability is
        unknown here — the submitter's retry budget decides what happens
        next)."""
        idle = [w for w in self.workers.values() if w.state == "idle"]
        if idle:
            return idle[0]
        leased = [w for w in self.workers.values()
                  if w.state == "leased" and not w.is_actor]
        if leased:
            return max(leased, key=lambda w: w.leased_since)
        actors = [w for w in self.workers.values()
                  if w.is_actor and w.state != "dead"]
        if actors:
            return max(actors, key=lambda w: w.started_at)
        return None

    async def _handle_worker_death(self, w: WorkerHandle, reason: str, report: bool = True):
        if w.state == "dead":
            return
        prev_state = w.state
        w.state = "dead"
        self.workers.pop(w.worker_id, None)
        if prev_state == "starting":
            self._starting_count = max(0, self._starting_count - 1)
            if w.env_key:
                self._starting_by_key[w.env_key] = max(
                    0, self._starting_by_key.get(w.env_key, 0) - 1)
            # A booting worker died (crash or surplus reap).  Live pops may
            # have been counting on it; without a re-pump they would wait
            # forever — nothing else spawns until the next register/return.
            self._fulfill_pops()
        if w.lease_id is not None:
            self._release_lease(w.lease_id)
        # Post-mortem harvest BEFORE reporting: the death notify carries the
        # victim's last recorded moments so the GCS can serve them with the
        # failure instead of them dying with the process.
        blackbox = self._harvest_blackbox(w.worker_id, reason)
        if report and (w.is_actor or prev_state != "idle"):
            try:
                await self.gcs.notify("worker_died", {
                    "worker_id": w.worker_id,
                    "node_id": self.node_id.binary(),
                    "reason": f"worker process died: {reason}",
                    "blackbox": blackbox,
                })
            except ConnectionError:
                pass
        elif blackbox is not None:
            # unreported deaths (idle worker reaped) still archive the ring
            try:
                await self.gcs.notify("blackbox_harvest", {
                    "worker_id": w.worker_id,
                    "node_id": self.node_id.binary(),
                    "blackbox": blackbox,
                })
            except ConnectionError:
                pass

    def _harvest_blackbox(self, worker_id: bytes, reason: str):
        """Read the dead worker's crash-surviving flight-recorder ring out
        of the session dir (the kernel kept the mmap'd pages; SIGKILL could
        not take them), then unlink it — one harvest per death."""
        path = flight_recorder.ring_path(self.session_dir, worker_id.hex())
        records = flight_recorder.harvest(path, limit=200)
        try:
            os.unlink(path)
        except OSError:
            pass
        if not records:
            return None
        if flight_recorder.RECORDING:
            flight_recorder.record(
                "blackbox.harvest",
                f"{worker_id.hex()[:12]}|{len(records)} records")
        return {
            "worker_id": worker_id.hex(),
            "node_id": self.node_id.hex(),
            "harvested_at": time.time(),
            "reason": reason,
            "records": records,
        }

    def _publish_incident(self, rec: dict) -> None:
        gcs = self.gcs
        if gcs is None or gcs.closed:
            return
        try:
            asyncio.get_running_loop().create_task(
                gcs.notify("incident_report", rec))
        except RuntimeError:
            pass  # off-loop close: the local ledger keeps the record

    def _kill_worker_proc(self, w: WorkerHandle):
        if w.proc is not None and w.proc.poll() is None:
            try:
                w.proc.kill()
            except OSError:
                pass

    def _on_conn_lost(self, conn: rpc.Connection):
        from ray_tpu_torch._private.object_store import cleanup_client_connection

        cleanup_client_connection(self.store, conn, waiters=self.waiters)
        # leases granted to a vanished client (driver death, cached leases
        # included): the workers are healthy — return them to the idle pool
        # instead of stranding them in "leased" forever
        for lease_id in conn.context.pop("granted_leases", set()):
            self._release_lease(lease_id)
        wid = conn.context.get("worker_id")
        if wid is not None and not self._shutting_down:
            w = self.workers.get(wid)
            if w is not None:
                asyncio.get_event_loop().create_task(
                    self._handle_worker_death(w, "connection lost"))

    async def rpc_kill_worker(self, conn, msg):
        w = self.workers.get(msg["worker_id"])
        if w is None:
            return False
        self._kill_worker_proc(w)
        await self._handle_worker_death(w, "killed", report=False)
        return True

    # ---------------------------------------------------------- lease broker
    def _record_infeasible_demand(self, resources: Dict[str, float]) -> None:
        """Dedupe one unmet resource shape into the demand view the
        autoscaler reads, warning at most every 30 s per shape (retries come
        every second and must look like one task, not N)."""
        now = time.monotonic()
        shape = tuple(sorted(resources.items()))
        prev = self._infeasible_demand.get(shape)
        warned = prev[2] if prev else 0.0
        if now - warned > 30.0:
            logger.warning(
                "task requiring %s cannot be scheduled on any current "
                "node; it stays pending (an autoscaler may add capacity)",
                resources)
            warned = now
        if len(self._infeasible_demand) < 256 or prev:
            self._infeasible_demand[shape] = (now, dict(resources), warned)

    def _fits_local(self, resources: Dict[str, float], bundle: Optional[Tuple[bytes, int]]) -> bool:
        if bundle is not None:
            b = self.bundles.get(tuple(bundle))
            if b is None:
                return False
            return all(b.available.get(k, 0.0) >= v for k, v in resources.items() if v > 0)
        return all(self.resources_available.get(k, 0.0) >= v
                   for k, v in resources.items() if v > 0)

    def _feasible_local(self, resources: Dict[str, float]) -> bool:
        return all(self.resources_total.get(k, 0.0) >= v for k, v in resources.items() if v > 0)

    def _resolve_bundle(self, bundle, resources: Dict[str, float]):
        """Resolve a lease's bundle key; index -1 means "any bundle of this
        placement group with capacity" (reference: bundle_index=-1 semantics in
        bundle_spec.h — the reference picks any bundle that fits).  Returns
        (concrete_bundle, error_reason)."""
        if bundle is None:
            return None, None
        bundle = (bundle[0], bundle[1])
        if bundle[1] >= 0:
            if bundle not in self.bundles:
                return None, "unknown placement bundle"
            return bundle, None
        cands = sorted(k for k in self.bundles if k[0] == bundle[0])
        if not cands:
            return None, "no bundle of this placement group on this node"
        for k in cands:
            if self._fits_local(resources, k):
                return k, None
        # All busy now — but only queue on a bundle whose TOTAL can ever fit;
        # a request exceeding every bundle's capacity must error, not hang.
        for k in cands:
            total = self.bundles[k].resources
            if all(total.get(rk, 0.0) >= v
                   for rk, v in resources.items() if v > 0):
                return k, None
        return None, "request exceeds every bundle's total resources"

    def _acquire(self, resources: Dict[str, float], bundle) -> None:
        if bundle is not None:
            b = self.bundles[tuple(bundle)]
            for k, v in resources.items():
                b.available[k] = b.available.get(k, 0.0) - v
        else:
            for k, v in resources.items():
                self.resources_available[k] = self.resources_available.get(k, 0.0) - v

    def _release(self, resources: Dict[str, float], bundle) -> None:
        if bundle is not None:
            b = self.bundles.get(tuple(bundle))
            if b is None:
                return
            for k, v in resources.items():
                b.available[k] = min(b.available.get(k, 0.0) + v, b.resources.get(k, 0.0))
        else:
            for k, v in resources.items():
                self.resources_available[k] = min(
                    self.resources_available.get(k, 0.0) + v, self.resources_total.get(k, 0.0))

    def _pick_node(self, resources: Dict[str, float], strategy: dict) -> Optional[bytes]:
        """Cluster-level node choice (reference: ClusterResourceScheduler +
        hybrid/spread policies, hybrid_scheduling_policy.h:50)."""
        my_id = self.node_id.binary()
        feasible = []
        for nid, view in self.cluster_view.items():
            total = view.get("total", {})
            if all(total.get(k, 0.0) >= v for k, v in resources.items() if v > 0):
                avail = view.get("available", {}) if nid != my_id else self.resources_available
                has_now = all(avail.get(k, 0.0) >= v for k, v in resources.items() if v > 0)
                feasible.append((nid, view, has_now))
        if not feasible:
            return None
        kind = strategy.get("kind", "default")
        if kind == "node_label":
            # label policy (reference: NodeLabelSchedulingStrategy,
            # node_label_scheduling_policy.h): hard selectors filter,
            # soft selectors rank; resources break ties via readiness
            sel = strategy.get("label_selector") or {}
            hard = sel.get("hard") or {}
            soft = sel.get("soft") or {}

            def labels_of(f):
                nid, view, _ = f
                return self.labels if nid == my_id \
                    else (view.get("labels") or {})

            if hard:
                feasible = [f for f in feasible if all(
                    labels_of(f).get(k) == v for k, v in hard.items())]
                if not feasible:
                    return None  # no labeled node: stays pending demand
            pool = [f for f in feasible if f[2]] or feasible
            if soft:
                pool.sort(key=lambda f: -sum(
                    labels_of(f).get(k) == v for k, v in soft.items()))
            return pool[0][0]
        ready = [f for f in feasible if f[2]]
        # Score by the REQUESTED resource shape, not CPU alone: a TPU-saturated
        # node must not look idle to a TPU task just because its CPUs are free
        # (reference: LeastResourceScorer scores the demanded resources,
        # scorer.h:41).
        req_keys = [k for k, v in resources.items() if v > 0] or ["CPU"]
        if kind == "spread":
            # Prefer ready nodes, most headroom for this request first.
            pool = ready or feasible
            def load_key(f):
                nid, view, _ = f
                avail = view.get("available", {}) if nid != my_id else self.resources_available
                return -min(avail.get(k, 0.0) / max(resources.get(k, 1.0), 1e-9)
                            for k in req_keys)
            pool.sort(key=load_key)
            return pool[0][0]
        # hybrid default: prefer local while it has capacity, else first ready
        # node, else queue locally (return my_id with no capacity -> queued).
        if self._fits_local(resources, None) or not ready:
            return my_id
        local_util = max(
            1.0 - (self.resources_available.get(k, 0.0)
                   / max(self.resources_total.get(k, 1e-9), 1e-9))
            for k in req_keys)
        if local_util < RayConfig.scheduler_spread_threshold and self._feasible_local(resources):
            return my_id
        return ready[0][0]

    async def rpc_request_worker_lease(self, conn, msg):
        """Grant a worker lease, spill to a better node, or queue.

        Reply: {type: granted, lease_id, worker_addr, worker_id}
             | {type: spillback, node_addr}
             | {type: infeasible}
        (reference: NodeManager::HandleRequestWorkerLease node_manager.cc:1794)
        """
        t_req = time.monotonic()
        resources = msg.get("resources", {})
        strategy = msg.get("strategy", {})
        bundle = msg.get("bundle")
        spillback_count = msg.get("spillback_count", 0)
        if self._disk_full:
            # a nearly-full local filesystem fails spills/logs/runtime-envs
            # in confusing ways — push work AWAY: spill to a healthy node
            # when one exists, bounce a retry otherwise (reference:
            # FileSystemMonitor over-capacity rejection).  A plain retry
            # here would pin the task to this node forever: the client's
            # retry path re-picks its preferred node.
            if bundle is None and strategy.get("kind") != "node_affinity":
                target = self._pick_node(resources, strategy)
                if target is not None and target != self.node_id.binary():
                    view = self.cluster_view.get(target)
                    if view and view.get("addr"):
                        return {"type": "spillback",
                                "node_addr": view["addr"]}
            return {"type": "retry", "delay": 2.0,
                    "reason": "node local filesystem is over the capacity "
                              "threshold"}
        if bundle is not None:
            bundle, err = self._resolve_bundle(bundle, resources)
            if err is not None:
                return {"type": "infeasible", "reason": err}
        elif strategy.get("kind") not in ("node_affinity",):
            # Spilled requests grant locally when they fit (no pointless
            # extra hops: the sender already chose this node); they re-spill
            # only while they DON'T fit here, up to a bounded chain
            # (reference: grant_or_reject spillback leases,
            # node_manager.cc:1794 — the cap replaces reject-and-retry;
            # the previous hard `< 2` cap could also queue a spilled
            # request forever on a node where it is locally infeasible).
            local_fit = self._fits_local(resources, None)
            consult = spillback_count == 0 or not local_fit
            max_spill = RayConfig.max_lease_spillbacks
            target = self._pick_node(resources, strategy) if consult else None
            if consult and target is None:
                if strategy.get("kind") == "node_label":
                    # resources may fit HERE, but a hard label selector that
                    # matched no node must never fall through to a local
                    # grant on a non-matching node.  NOT recorded as
                    # resource demand: the autoscaler would provision
                    # generic capacity that still lacks the label.
                    sel = strategy.get("label_selector") or {}
                    now = time.monotonic()
                    if now - getattr(self, "_label_warned", 0.0) > 30.0:
                        self._label_warned = now
                        logger.warning(
                            "task requiring labels %s matches no node; it "
                            "stays pending (label-selector demand is not "
                            "autoscalable)", sel.get("hard"))
                    return {"type": "retry", "delay": 1.0,
                            "reason": "no node matches the label selector"}
                if not self._feasible_local(resources):
                    # No node fits today — but the autoscaler may launch one:
                    # record the unmet shape as demand and have the submitter
                    # retry, keeping the task pending (reference: infeasible
                    # tasks wait; ResourceLoad drives scale-up, with periodic
                    # infeasible-task warnings).
                    self._record_infeasible_demand(resources)
                    return {"type": "retry", "delay": 1.0,
                            "reason": f"no node currently satisfies {resources}"}
            elif target is not None and target != self.node_id.binary() \
                    and spillback_count < max_spill:
                view = self.cluster_view.get(target)
                if view and view.get("addr"):
                    return {"type": "spillback", "node_addr": view["addr"]}
            if not local_fit and not self._feasible_local(resources):
                # end of the chain on a node that can NEVER run this shape:
                # bounce to the client rather than queueing forever — and
                # record the shape so demand-driven scale-up still sees it
                self._record_infeasible_demand(resources)
                return {"type": "retry", "delay": 1.0,
                        "reason": f"node cannot ever satisfy {resources}"}
        token = msg.get("token")
        # Local grant (or queue until resources free up).  The pump ACQUIRES on
        # behalf of the waiter before waking it, so concurrent waiters can never
        # be granted against the same capacity.
        if self._fits_local(resources, bundle):
            self._acquire(resources, bundle)
        else:
            fut = asyncio.get_event_loop().create_future()
            self._queued_leases.append((resources, bundle, fut))
            if token:
                self._lease_waiters[token] = fut
            # the capacity we're queueing on may be held by drivers' cached
            # idle leases: ask them to give the warm workers back
            self._hint_lease_reclaim()
            try:
                await fut  # resources are acquired by _pump_queued_leases
            except _LeaseCancelled:
                return {"type": "cancelled"}
            except asyncio.CancelledError:
                if fut.done() and not fut.cancelled():
                    self._release(resources, bundle)
                raise
            finally:
                if token:
                    self._lease_waiters.pop(token, None)
        t_acquired = time.monotonic()
        env_key = msg.get("env_key") or ""
        if env_key:
            try:
                await self._prepare_env(env_key, msg.get("runtime_env") or {})
            except Exception as e:
                logger.warning("runtime env %s setup failed: %r", env_key, e)
                self._release(resources, bundle)
                self._pump_queued_leases()
                return {"type": "env_failed",
                        "reason": f"runtime env setup failed: {e}"}
        try:
            w, cards = await self._pop_worker_with_cards(resources, token,
                                                         env_key)
        except _LeaseCancelled:
            self._release(resources, bundle)
            self._pump_queued_leases()  # freed capacity may unblock waiters
            return {"type": "cancelled"}
        except BaseException:
            self._release(resources, bundle)
            self._pump_queued_leases()
            raise
        self._lease_seq += 1
        lease_id = self._lease_seq
        w.lease_id = lease_id
        self.leases[lease_id] = {"resources": resources, "bundle": bundle,
                                 "worker": w, "cards": cards}
        # remember who holds it: conn loss returns the lease (a dead driver's
        # cached leases must not strand healthy workers in "leased")
        conn.context.setdefault("granted_leases", set()).add(lease_id)
        self._observe_lease_phases(t_req, t_acquired, time.monotonic())
        if flight_recorder.RECORDING:
            flight_recorder.record(
                "lease.grant",
                f"id={lease_id}|worker={w.worker_id.hex()[:12]}")
        return {"type": "granted", "lease_id": lease_id,
                "worker_addr": list(w.addr), "worker_id": w.worker_id}

    def _observe_lease_phases(self, t_req: float, t_acquired: float,
                              t_granted: float) -> None:
        """Lease-grant timing into this node's task_phase_seconds histogram
        (same metric name as the driver/worker phases, so one Prometheus
        query covers the whole chain): lease_queue is time spent waiting for
        resources, worker_pop is env prep + waiting for / booting a worker
        process.  Per lease, not per task — pipelined tasks amortize it."""
        if not hasattr(self, "_m_phase"):
            from ray_tpu_torch._private import metrics as M

            self._m_phase = M.Histogram(
                "task_phase_seconds",
                "task hot-path time per phase (driver submit -> result wake)",
                boundaries=M.PHASE_SECONDS_BOUNDARIES)
        self._m_phase.observe(max(t_acquired - t_req, 0.0),
                              {"phase": "lease_queue"})
        self._m_phase.observe(max(t_granted - t_acquired, 0.0),
                              {"phase": "worker_pop"})

    def _pump_queued_leases(self):
        n = len(self._queued_leases)
        for _ in range(n):
            resources, bundle, fut = self._queued_leases.popleft()
            if fut.done():
                continue
            if self._fits_local(resources, bundle):
                self._acquire(resources, bundle)  # reserve before waking
                fut.set_result(True)
            else:
                self._queued_leases.append((resources, bundle, fut))

    def _retire(self, w: WorkerHandle) -> None:
        """A worker that held cards, or could not take them, is not reused:
        CUDA may be up in it with other cards visible.  The reaper ends
        it."""
        w.state = "retiring"
        w.lease_id = None

    async def _pop_worker_with_cards(self, resources: Dict[str, float],
                                     token: Optional[str] = None,
                                     env_key: str = ""):
        """A worker for a lease, and the lease's card ids, which the
        worker's CUDA alone sees from then on.  A bundle's cancel returns
        its resources before its lease's worker is dead: the cards may
        come free a moment after the resources."""
        gpus = resources.get("GPU", 0.0)
        cards = self.cards.take(gpus)
        deadline = time.monotonic() + 30.0
        while cards is None:
            if time.monotonic() > deadline:
                raise RuntimeError(f"no card came free for a lease of "
                                   f"{gpus:g} GPU: {self.cards.held}")
            await asyncio.sleep(0.05)
            cards = self.cards.take(gpus)
        try:
            while True:
                w = await self._pop_worker(token, env_key)
                if not cards:
                    return w, cards
                try:
                    if await w.conn.call("assign_cards", {"ids": cards},
                                         timeout=30.0):
                        return w, cards
                except ConnectionError:
                    pass
                self._retire(w)
        except BaseException:
            self.cards.give_back(cards, gpus)
            raise

    def _release_lease(self, lease_id: int):
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return
        self._release(lease["resources"], lease["bundle"])
        self.cards.give_back(lease.get("cards", []),
                             lease["resources"].get("GPU", 0.0))
        w = lease["worker"]
        if w.state == "leased" and lease.get("cards"):
            self._retire(w)
        elif w.state == "leased":
            w.state = "idle"
            w.idle_since = time.monotonic()
            w.lease_id = None
            self._fulfill_pops()
        self._pump_queued_leases()

    async def rpc_return_worker(self, conn, msg):
        conn.context.get("granted_leases", set()).discard(msg["lease_id"])
        self._release_lease(msg["lease_id"])
        return True

    async def _notify_pressure_kill(self, w: WorkerHandle) -> None:
        """Heads-up to the lease holder BEFORE the SIGKILL: the imminent
        'lost' completion is a deliberate pressure kill, not a crash, so
        the submitter retries the task without consuming its crash-retry
        budget (reference: OOM-killed tasks retry on their own counter,
        unlimited by default, so pressure can't exhaust max_retries)."""
        if w.lease_id is None:
            return
        for conn in list(self.server.connections):
            if w.lease_id in conn.context.get("granted_leases", ()):
                try:
                    await conn.notify("pressure_kill",
                                      {"worker_id": w.worker_id})
                except ConnectionError:
                    pass
                return

    # ---------------------------------------------------- reclaim hints
    def _hint_lease_reclaim(self) -> None:
        """Ask clients with cached idle leases to return them: a lease /
        bundle reservation is queued behind resources they hold.  Throttled;
        fire-and-forget over the coalesced batch."""
        now = time.monotonic()
        if now - getattr(self, "_last_lease_hint", 0.0) < 0.5:
            return
        self._last_lease_hint = now
        for conn in list(self.server.connections):
            if conn.context.get("granted_leases"):
                try:
                    conn.notify_coalesced("lease_reclaim", None)
                except ConnectionError:
                    pass

    def _broadcast_extent_reclaim(self) -> None:
        """Store hit full during an extent lease: ask clients to hand back
        idle leased extents before the requester's retry."""
        now = time.monotonic()
        if now - getattr(self, "_last_extent_hint", 0.0) < 0.2:
            return
        self._last_extent_hint = now
        for conn in list(self.server.connections):
            if conn.context.get("plasma_extents"):
                try:
                    conn.notify_coalesced("extent_reclaim", None)
                except ConnectionError:
                    pass

    async def rpc_set_env(self, conn, msg):
        """Fault-injection hook for chaos tests (fake disk usage, fake
        memory pressure): set/clear an env var in THIS nodelet process.
        DISABLED unless RayConfig.test_hooks — an open env-set RPC would
        hand code execution (LD_PRELOAD/PYTHONPATH into spawned workers)
        to anything that can reach the nodelet port."""
        if not RayConfig.test_hooks:
            raise PermissionError("set_env requires RAY_TPU_TORCH_TEST_HOOKS=1")
        if msg.get("value"):
            os.environ[msg["key"]] = msg["value"]
        else:
            os.environ.pop(msg["key"], None)
        return True

    # ------------------------------------------------------------ actor leases
    async def rpc_lease_worker_for_actor(self, conn, msg):
        """GCS asks this node to host an actor: lease a dedicated worker and run
        the creation task on it (reference: GcsActorScheduler leasing path)."""
        import pickle

        spec = pickle.loads(msg["spec"])
        if self._disk_full:
            # same capacity guard as task leases: a full disk breaks the
            # actor's runtime-env install and log writes
            return {"ok": False, "reason": "node local filesystem is over "
                                           "the capacity threshold"}
        bundle = msg.get("bundle")
        if bundle is not None:
            bundle, err = self._resolve_bundle(bundle, spec.resources)
            if err is not None:
                return {"ok": False, "reason": err}
        if self._fits_local(spec.resources, bundle):
            self._acquire(spec.resources, bundle)
        else:
            if not self._feasible_local(spec.resources) and bundle is None:
                return {"ok": False, "reason": "infeasible"}
            fut = asyncio.get_event_loop().create_future()
            self._queued_leases.append((spec.resources, bundle, fut))
            self._hint_lease_reclaim()
            try:
                await asyncio.wait_for(fut, RayConfig.gcs_rpc_timeout_s * 0.8)
            except asyncio.TimeoutError:
                # wait_for cancelled fut; the pump skips done futures, so the
                # reservation was never made for us.
                return {"ok": False, "reason": "timed out waiting for resources"}
        from ray_tpu_torch import runtime_env as renv_mod

        env_key = renv_mod.env_key(spec.runtime_env)
        if env_key:
            try:
                await self._prepare_env(env_key, spec.runtime_env)
            except Exception as e:
                import pickle

                from ray_tpu_torch.exceptions import RuntimeEnvSetupError

                logger.warning("actor runtime env %s setup failed: %r",
                               env_key, e)
                self._release(spec.resources, bundle)
                self._pump_queued_leases()
                # carry a pickled error: the GCS treats error-bearing
                # replies as deterministic failures (actor marked DEAD)
                # rather than retrying the broken env forever
                return {"ok": False,
                        "reason": f"runtime env setup failed: {e}",
                        "error": pickle.dumps(RuntimeEnvSetupError(  # lint: disable=no-flatten (error record)
                            f"runtime env setup failed: {e}"))}
        try:
            w, cards = await self._pop_worker_with_cards(spec.resources,
                                                         env_key=env_key)
        except BaseException:
            self._release(spec.resources, bundle)
            self._pump_queued_leases()
            raise
        self._lease_seq += 1
        w.lease_id = self._lease_seq
        w.is_actor = True
        w.actor_id = spec.actor_creation_id.binary() if spec.actor_creation_id else None
        self.leases[w.lease_id] = {"resources": spec.resources, "bundle": bundle,
                                   "worker": w, "cards": cards}
        try:
            # No timeout: actor __init__ may legitimately take minutes (model
            # load, jax backend init); worker death surfaces as ConnectionLost.
            reply = await w.conn.call("push_task", msg["spec"], timeout=None)
            if reply.get("status") == "error":
                # Kill the leased process too: _handle_worker_death only
                # untracks it, and an untracked live worker is unreclaimable
                # (reference kills the leased worker when creation fails).
                self._kill_worker_proc(w)
                await self._handle_worker_death(w, "actor constructor raised", report=False)
                return {"ok": False, "reason": "actor constructor raised",
                        "error": reply.get("error")}
        except ConnectionError as e:
            await self._handle_worker_death(w, f"actor creation failed: {e}")
            return {"ok": False, "reason": f"actor creation failed: {e}"}
        return {"ok": True, "worker_addr": list(w.addr), "worker_id": w.worker_id}

    # ------------------------------------------------------- bundles (2PC)
    async def rpc_prepare_bundle(self, conn, msg):
        key = (msg["pg_id"], msg["index"])
        if key in self.bundles:
            return True
        resources = msg["resources"]
        if not all(self.resources_available.get(k, 0.0) >= v
                   for k, v in resources.items() if v > 0):
            # the shortfall may be drivers' cached idle leases: hint, give
            # them one beat to come back, recheck (the GCS retries a failed
            # prepare, so this only shortens the failure window)
            self._hint_lease_reclaim()
            await asyncio.sleep(0.25)
            if not all(self.resources_available.get(k, 0.0) >= v
                       for k, v in resources.items() if v > 0):
                return False
        for k, v in resources.items():
            self.resources_available[k] = self.resources_available.get(k, 0.0) - v
        self.bundles[key] = Bundle(msg["pg_id"], msg["index"], resources)
        return True

    async def rpc_commit_bundle(self, conn, msg):
        b = self.bundles.get((msg["pg_id"], msg["index"]))
        if b is None:
            return False
        b.committed = True
        return True

    async def rpc_cancel_bundle(self, conn, msg):
        b = self.bundles.pop((msg["pg_id"], msg["index"]), None)
        if b is None:
            return True
        # Return the bundle's unused reservation to the node pool.
        for k, v in b.resources.items():
            self.resources_available[k] = min(
                self.resources_available.get(k, 0.0) + v, self.resources_total.get(k, 0.0))
        self._pump_queued_leases()
        return True

    # ----------------------------------------------------------------- misc
    async def rpc_node_info(self, conn, msg):
        return {
            "node_id": self.node_id.binary(),
            "addr": list(self.addr),
            "resources_total": self.resources_total,
            "resources_available": self.resources_available,
            "num_workers": len(self.workers),
            "store": self.store.stats(),
        }


def main(argv=None):
    """Entry point for the nodelet process (reference: raylet/main.cc)."""
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs-host", required=True)
    parser.add_argument("--gcs-port", type=int, required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--labels", default="{}",
                        help="JSON node labels for label-selector scheduling")
    parser.add_argument("--object-store-memory", type=int, default=0)
    parser.add_argument("--session-dir", default=temp_root())
    parser.add_argument("--node-name", default="")
    args = parser.parse_args(argv)

    import json

    logging.basicConfig(level=logging.INFO, format="[nodelet] %(levelname)s %(message)s")

    async def run():
        import signal

        nodelet = Nodelet(
            (args.gcs_host, args.gcs_port),
            resources=json.loads(args.resources) or None,
            labels=json.loads(args.labels) or None,
            object_store_memory=args.object_store_memory or None,
            session_dir=args.session_dir,
            node_name=args.node_name,
        )
        host, port = await nodelet.start(args.host, args.port)
        print(f"NODELET_PORT {port}", flush=True)
        print(f"NODELET_ID {nodelet.node_id.hex()}", flush=True)
        # Graceful SIGTERM/SIGINT: run Nodelet.stop() so spawned workers are
        # killed rather than orphaned (Node.stop() SIGTERMs this process; a
        # bare default handler would leak every worker).
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await nodelet.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
