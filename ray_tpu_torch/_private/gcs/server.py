"""Port of ``ray_tpu/_private/gcs/server.py``.

GCS server: the head-node control plane.

Counterpart of the reference's GCS (reference: src/ray/gcs/gcs_server/gcs_server.h:78)
with its managers condensed into one asyncio process:

- node directory + health checking      (GcsNodeManager, gcs_node_manager.h:44;
                                         GcsHealthCheckManager, gcs_health_check_manager.h:39)
- actor directory + scheduling/restart  (GcsActorManager, gcs_actor_manager.h:278;
                                         GcsActorScheduler ScheduleByGcs, gcs_actor_scheduler.cc:60)
- placement groups                      (GcsPlacementGroupManager/Scheduler)
- internal KV                           (gcs_kv_manager.h; used for the function table,
                                         cluster metadata, named config)
- cluster resource aggregation + view   (GcsResourceManager + ray_syncer broadcast,
                                         ray_syncer.proto:62 — here: pubsub pushes)
- object directory                      (the owner/location table the reference keeps in
                                         OwnershipBasedObjectDirectory; centralized here)
- pub/sub broker                        (src/ray/pubsub/ — here: push over the persistent
                                         bidirectional RPC connections, no long-polling)
- job manager                           (gcs_job_manager.h:41)
- task events sink                      (GcsTaskManager, gcs_task_manager.h:86)

Liveness: each nodelet keeps one persistent RPC connection; TCP teardown marks the
node dead immediately, and a periodic ping catches hangs (the reference health-checks
over gRPC on a timer).  Storage is in-memory (the reference's default StoreClient);
a pluggable store seam exists for persistence (store_client.h:33 equivalent).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.config import RayConfig, temp_root
from ray_tpu_torch._private.ids import ActorID, JobID, NodeID, ObjectID, PlacementGroupID
from ray_tpu_torch._private.task_spec import TaskSpec

logger = logging.getLogger(__name__)


class NodeInfo:
    __slots__ = ("node_id", "addr", "resources_total", "resources_available",
                 "labels", "conn", "alive", "last_seen", "start_time", "node_name",
                 "object_store_capacity", "death_cause", "pending_demand",
                 "metrics_addr", "busy_workers", "view_version")

    def __init__(self, node_id: NodeID, addr: Tuple[str, int], resources_total: Dict[str, float],
                 labels: Dict[str, str], conn: rpc.Connection, node_name: str = ""):
        self.node_id = node_id
        self.addr = addr
        self.resources_total = dict(resources_total)
        self.resources_available = dict(resources_total)
        self.labels = labels
        self.conn = conn
        self.alive = True
        self.last_seen = time.monotonic()
        self.start_time = time.time()
        self.node_name = node_name
        self.pending_demand = []  # queued lease resource shapes (autoscaler)
        self.metrics_addr: Optional[Tuple[str, int]] = None  # /metrics scrape
        self.object_store_capacity = 0
        self.death_cause = ""
        self.busy_workers = 0  # leased workers + live actors (idle detection)
        self.view_version = -1  # versioned sync (reference: ray_syncer.proto)

    def view(self) -> dict:
        return {
            "node_id": self.node_id.binary(),
            "addr": self.addr,
            "total": self.resources_total,
            "available": self.resources_available,
            "labels": self.labels,
            "alive": self.alive,
            "node_name": self.node_name,
            "start_time": self.start_time,
            "metrics_addr": self.metrics_addr,
            # versioned-sync seed: subscribers apply later deltas only when
            # newer than this snapshot
            "view_version": self.view_version,
        }


class ActorInfo:
    __slots__ = ("actor_id", "spec", "state", "addr", "worker_id", "node_id", "name",
                 "namespace", "num_restarts", "max_restarts", "death_cause", "pending_waiters",
                 "class_name", "job_id", "start_time", "detached", "creation_conn",
                 "holders", "had_holder")

    def __init__(self, actor_id: ActorID, spec: bytes, name: Optional[str], namespace: str,
                 max_restarts: int, class_name: str, job_id: bytes, detached: bool):
        self.actor_id = actor_id
        self.spec = spec  # pickled ACTOR_CREATION TaskSpec
        self.state = "PENDING_CREATION"  # -> ALIVE -> RESTARTING/DEAD
        self.addr: Optional[Tuple[str, int]] = None
        self.worker_id: Optional[bytes] = None
        self.node_id: Optional[bytes] = None
        self.name = name
        self.namespace = namespace
        self.num_restarts = 0
        self.max_restarts = max_restarts
        self.death_cause = ""
        self.pending_waiters: List[asyncio.Future] = []
        self.class_name = class_name
        self.job_id = job_id
        self.start_time = time.time()
        self.detached = detached
        # Distributed handle refcount: processes currently holding handles
        # (reference: actor out-of-scope destruction).
        self.holders: set = set()
        self.had_holder = False

    def to_record(self) -> dict:
        """Persistable snapshot (reference: GcsActorTableData)."""
        return {
            "actor_id": self.actor_id.binary(), "spec": self.spec,
            "state": self.state, "addr": self.addr, "worker_id": self.worker_id,
            "node_id": self.node_id, "name": self.name,
            "namespace": self.namespace, "num_restarts": self.num_restarts,
            "max_restarts": self.max_restarts, "death_cause": self.death_cause,
            "class_name": self.class_name, "job_id": self.job_id,
            "start_time": self.start_time, "detached": self.detached,
        }

    @classmethod
    def from_record(cls, rec: dict) -> "ActorInfo":
        info = cls(ActorID(rec["actor_id"]), rec["spec"], rec["name"],
                   rec["namespace"], rec["max_restarts"], rec["class_name"],
                   rec["job_id"], rec["detached"])
        info.state = rec["state"]
        info.addr = tuple(rec["addr"]) if rec["addr"] else None
        info.worker_id = rec["worker_id"]
        info.node_id = rec["node_id"]
        info.num_restarts = rec["num_restarts"]
        info.death_cause = rec["death_cause"]
        info.start_time = rec["start_time"]
        return info

    def public_info(self) -> dict:
        return {
            "actor_id": self.actor_id.binary(),
            "state": self.state,
            "addr": self.addr,
            "worker_id": self.worker_id,
            "node_id": self.node_id,
            "name": self.name,
            "namespace": self.namespace,
            "class_name": self.class_name,
            "num_restarts": self.num_restarts,
            "death_cause": self.death_cause,
            "job_id": self.job_id,
            "start_time": self.start_time,
        }


class GcsServer:
    def __init__(self, node_for_bundle=None, session_dir: Optional[str] = None):
        self.session_dir = session_dir
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}  # (namespace, name)
        self.kv: Dict[str, Dict[str, bytes]] = {}  # namespace -> {key: value}
        # requester -> standing resource bundles (autoscaler sdk)
        self.requested_resources: Dict[bytes, list] = {}
        self.object_dir: Dict[bytes, Set[bytes]] = {}  # oid binary -> {node_id binary}
        self.subscribers: Dict[str, Set[rpc.Connection]] = {}  # channel -> conns
        self.next_job = 1
        self.jobs: Dict[bytes, dict] = {}
        self._submitted: Dict[str, dict] = {}  # submission_id -> {rec, proc}
        self.placement_groups: Dict[PlacementGroupID, Any] = {}  # filled by pg_manager
        self.task_events: deque = deque(maxlen=RayConfig.task_events_max_buffer_size)
        # Observability ledgers: harvested dead-worker black boxes (keyed by
        # worker_id hex, insertion-ordered for retention eviction) + closed
        # failure incidents reported by every process in the cluster.
        self.blackboxes: Dict[str, dict] = {}
        self.incidents: deque = deque(maxlen=max(RayConfig.incident_retention, 1))
        # Cluster-wide continuous-profiler aggregate: one entry per distinct
        # (node, task, subsystem, tag, stack), bounded by profile_max_stacks
        # with lowest-count-first eviction (rare stacks go before hot ones).
        self.profile: Dict[Tuple[str, str, str, str, str], int] = {}
        self.server = rpc.Server(self._handlers(), name="gcs")
        self.server.on_disconnect = self._on_disconnect
        self._started = asyncio.Event()
        self.addr: Tuple[str, int] = ("", 0)
        self.cluster_id = NodeID.from_random().hex()
        self._bg: List[asyncio.Task] = []
        from ray_tpu_torch._private.gcs.pg_manager import PlacementGroupManager

        self.pg_manager = PlacementGroupManager(self)
        # Persistence seam (reference: store_client.h:33).  With a sqlite
        # path configured, actors/jobs/kv/PGs survive a GCS restart; nodes
        # re-register over their reconnect loops and re-report live actors,
        # bundles, and object locations (reference: GcsInitData replay +
        # ray_syncer resync after GCS failover).
        from ray_tpu_torch._private.gcs.storage import make_store

        self.store = make_store(RayConfig.gcs_storage_path or None)
        self._restored_unconfirmed: Set[ActorID] = set()
        self.resource_broadcasts = 0  # versioned-sync effectiveness counter
        self._load_from_store()

    # ------------------------------------------------------------ persistence
    def _load_from_store(self):
        import pickle

        if not self.store.persistent:
            return
        meta = self.store.get("meta", "next_job")
        if meta is not None:
            self.next_job = int(meta)
        for key, blob in self.store.get_all("kv").items():
            ns, _, k = key.partition("\x00")
            self.kv.setdefault(ns, {})[k] = blob
        for _, blob in self.store.get_all("jobs").items():
            rec = pickle.loads(blob)
            self.jobs[rec["job_id"]] = rec
        restored_actors = 0
        for _, blob in self.store.get_all("actors").items():
            info = ActorInfo.from_record(pickle.loads(blob))
            self.actors[info.actor_id] = info
            if info.name:
                self.named_actors[(info.namespace, info.name)] = info.actor_id
            if info.state in ("ALIVE", "PENDING_CREATION", "RESTARTING"):
                # Liveness unknown until the hosting node re-registers and
                # re-reports it; the confirmation sweep reschedules unplaced
                # actors and fails unreachable ones after a grace period.
                self._restored_unconfirmed.add(info.actor_id)
                restored_actors += 1
        self.pg_manager.load_from_store(self.store)
        if restored_actors or self.jobs or self.kv:
            logger.info(
                "GCS state restored: %d actors (%d awaiting confirmation), "
                "%d jobs, %d kv namespaces, %d placement groups",
                len(self.actors), restored_actors, len(self.jobs),
                len(self.kv), len(self.pg_manager.groups))

    def _persist_actor(self, info: ActorInfo):
        if self.store.persistent:
            import pickle

            self.store.put("actors", info.actor_id.hex(),
                           pickle.dumps(info.to_record()))  # lint: disable=no-flatten (KV record)

    def _persist_job(self, rec: dict):
        if self.store.persistent:
            import pickle

            self.store.put("jobs", rec["job_id"].hex(),
                           pickle.dumps(rec))  # lint: disable=no-flatten (KV record)

    async def _confirmation_sweep(self):
        """After a restart, actors whose node never re-reported them within
        the grace period go through the normal failure path (restart policy
        applies) instead of staying ALIVE-but-unreachable forever."""
        await asyncio.sleep(RayConfig.gcs_restart_actor_grace_s)
        for actor_id in list(self._restored_unconfirmed):
            info = self.actors.get(actor_id)
            self._restored_unconfirmed.discard(actor_id)
            if info is None:
                continue
            if info.state in ("PENDING_CREATION", "RESTARTING"):
                # Never placed (or mid-restart) when the GCS died and no node
                # re-reported it: just schedule it — this is not a failure, so
                # it must not consume a restart.
                logger.info("rescheduling restored actor %s (%s)",
                            actor_id.hex()[:12], info.class_name)
                asyncio.get_event_loop().create_task(
                    self._schedule_actor(info))
            elif info.state == "ALIVE":
                logger.warning(
                    "restored actor %s (%s) unconfirmed after GCS restart; "
                    "driving failure path", actor_id.hex()[:12],
                    info.class_name)
                await self._handle_actor_failure(
                    info, "hosting node did not re-report after GCS restart")
        # Restored CREATED placement groups whose nodes never came back get
        # their lost bundles rescheduled (same grace, same reasoning).
        alive = {n.node_id.binary() for n in self.nodes.values() if n.alive}
        self.pg_manager.reconcile_after_restart(alive)

    # ------------------------------------------------------------------ setup
    def _handlers(self) -> dict:
        h = {}
        for name in dir(self):
            if name.startswith("rpc_"):
                h[name[4:]] = getattr(self, name)
        return h

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
        self.addr = await self.server.start(host, port)
        self._bg.append(asyncio.get_event_loop().create_task(self._health_check_loop()))
        if self._restored_unconfirmed or self.pg_manager.groups:
            self._bg.append(asyncio.get_event_loop().create_task(
                self._confirmation_sweep()))
        self._started.set()
        logger.info("GCS listening on %s:%s", *self.addr)
        return self.addr

    async def stop(self):
        for t in self._bg:
            t.cancel()
        await self.server.stop()

    # ------------------------------------------------------------ liveness
    def _on_disconnect(self, conn: rpc.Connection):
        loop = asyncio.get_event_loop()
        node_id = conn.context.get("node_id")
        if node_id is not None:
            loop.create_task(self._mark_node_dead(NodeID(node_id), "nodelet connection lost"))
        holder = conn.context.get("client_worker_id")
        if holder is not None:
            loop.create_task(self._drop_holder_everywhere(holder))

    async def rpc_client_hello(self, conn, msg):
        """CoreWorkers announce themselves so holder state dies with them."""
        conn.context["client_worker_id"] = msg["worker_id"]
        return True

    async def _health_check_loop(self):
        interval = RayConfig.heartbeat_interval_ms / 1000.0
        timeout = RayConfig.health_check_timeout_ms / 1000.0
        while True:
            await asyncio.sleep(interval * 4)
            now = time.monotonic()
            for info in list(self.nodes.values()):
                if not info.alive:
                    continue
                if now - info.last_seen > timeout:
                    await self._mark_node_dead(info.node_id, "health check timed out")

    async def _mark_node_dead(self, node_id: NodeID, reason: str):
        info = self.nodes.get(node_id)
        if info is None or not info.alive:
            return
        info.alive = False
        info.death_cause = reason
        logger.warning("node %s marked dead: %s", node_id.hex()[:8], reason)
        # Drop object locations on that node.
        nid = node_id.binary()
        for oid, locs in list(self.object_dir.items()):
            locs.discard(nid)
            if not locs:
                del self.object_dir[oid]
        await self.publish("node", {"event": "dead", "node": info.view()})
        # Fail/restart actors that lived there.
        for actor in list(self.actors.values()):
            if actor.node_id == nid and actor.state in ("ALIVE", "PENDING_CREATION", "RESTARTING"):
                await self._handle_actor_failure(actor, f"node died: {reason}")
        self.pg_manager.on_node_dead(node_id)

    # ------------------------------------------------------------- pub/sub
    async def publish(self, channel: str, data: Any):
        dead = []
        # Copy: rpc_subscribe can mutate the set while we await a notify.
        for conn in list(self.subscribers.get(channel, ())):
            try:
                await conn.notify("publish", {"channel": channel, "data": data})
            except ConnectionError:
                dead.append(conn)
        for c in dead:
            self.subscribers.get(channel, set()).discard(c)

    async def rpc_subscribe(self, conn, msg):
        self.subscribers.setdefault(msg["channel"], set()).add(conn)
        return True

    async def rpc_unsubscribe(self, conn, msg):
        self.subscribers.get(msg["channel"], set()).discard(conn)
        return True

    # --------------------------------------------------------------- nodes
    async def rpc_register_node(self, conn, msg):
        node_id = NodeID(msg["node_id"])
        info = NodeInfo(
            node_id, tuple(msg["addr"]), msg["resources"], msg.get("labels", {}),
            conn, node_name=msg.get("node_name", ""),
        )
        info.object_store_capacity = msg.get("object_store_capacity", 0)
        ma = msg.get("metrics_addr")
        info.metrics_addr = tuple(ma) if ma and ma[1] else None
        self.nodes[node_id] = info
        conn.context["node_id"] = node_id.binary()
        # Subscribe the node's channels ATOMICALLY with the snapshot it gets
        # in this reply: a delta published between the reply and a separate
        # subscribe RPC would otherwise be lost — and with versioned sync
        # suppressing unchanged rebroadcasts, never repaired.
        self.subscribers.setdefault("resource_view", set()).add(conn)
        self.subscribers.setdefault("node", set()).add(conn)
        # Re-registration after a GCS restart (or a dropped connection): the
        # node re-reports its live actors, PG bundles, and local objects so
        # restored state reconciles with reality (reference: raylets
        # resync via ray_syncer after GCS failover).
        for oid in msg.get("objects", []):
            self.object_dir.setdefault(oid, set()).add(node_id.binary())
        for b in msg.get("bundles", []):
            self.pg_manager.reconcile_bundle(
                b["pg_id"], b["index"], node_id.binary())
        for a in msg.get("actors", []):
            actor = self.actors.get(ActorID(a["actor_id"]))
            if actor is not None and actor.state != "DEAD":
                actor.state = "ALIVE"
                actor.addr = tuple(a["worker_addr"])
                actor.worker_id = a["worker_id"]
                actor.node_id = node_id.binary()
                self._restored_unconfirmed.discard(actor.actor_id)
                self._persist_actor(actor)
        await self.publish("node", {"event": "added", "node": info.view()})
        return {"cluster_id": self.cluster_id, "cluster_view": self.cluster_view()}

    async def rpc_resource_report(self, conn, msg):
        node_id = NodeID(msg["node_id"])
        info = self.nodes.get(node_id)
        if info is None:
            # Not "dead": a restarted GCS simply hasn't seen this node's
            # re-registration yet — telling it to re-register (not exit)
            # is what makes GCS failover survivable.
            return {"unknown": True}
        if not info.alive:
            return {"dead": True}
        info.last_seen = time.monotonic()
        info.resources_available = msg["available"]
        info.pending_demand = msg.get("pending_demand", [])
        info.busy_workers = msg.get("busy_workers", 0)
        if msg.get("total"):
            info.resources_total = msg["total"]
        # Versioned sync (reference: ray_syncer.proto:62 snapshot versions):
        # an UNCHANGED view (same version as last broadcast) is liveness
        # only — rebroadcasting it would make steady-state traffic
        # O(nodes^2) for no information.
        version = msg.get("version")
        if version is not None and version == info.view_version:
            return {"dead": False}
        if version is not None:
            info.view_version = version
        self.resource_broadcasts += 1
        await self.publish("resource_view", {
            "node_id": msg["node_id"],
            "available": msg["available"],
            "total": info.resources_total,
            "version": version,
        })
        return {"dead": False}

    async def rpc_request_resources(self, conn, msg):
        """Programmatic autoscaler demand (reference:
        ray.autoscaler.sdk.request_resources / autoscaler.proto
        RequestClusterResources): each requester's LATEST call replaces its
        previous request; an empty bundle list withdraws it."""
        requester = msg.get("requester") or b"default"
        bundles = [dict(b) for b in (msg.get("bundles") or [])]
        if bundles:
            self.requested_resources[requester] = bundles
        else:
            self.requested_resources.pop(requester, None)
        return True

    async def rpc_get_cluster_status(self, conn, msg):
        """Aggregate load view for the autoscaler (reference: the GCS
        autoscaler state service, autoscaler.proto:315 GetClusterStatus)."""
        demand = []
        for n in self.nodes.values():
            if n.alive:
                demand.extend(n.pending_demand)
        # standing programmatic requests (request_resources) are demand the
        # autoscaler must hold capacity for, tasks or no tasks
        for bundles in self.requested_resources.values():
            demand.extend(dict(b) for b in bundles)
        # actors stuck pending for lack of resources are demand too
        for a in self.actors.values():
            if a.state == "PENDING_CREATION":
                try:
                    import pickle as _p

                    spec = _p.loads(a.spec)
                    s = spec.scheduling_strategy
                    if getattr(s, "kind", None) == "placement_group":
                        continue  # its bundle below is the demand already
                    if spec.resources:
                        demand.append(dict(spec.resources))
                except Exception:
                    pass
        # unplaced placement-group bundles: gang demand the autoscaler must
        # provision for (reference: placement-group demand in the autoscaler
        # state service, autoscaler.proto GangResourceRequest).  STRICT
        # strategies carry a _gang marker so the bin-packer preserves
        # anti-affinity (one bundle per node) instead of absorbing the whole
        # gang into one node's free capacity.
        for pg in self.pg_manager.groups.values():
            if pg.state in ("PENDING", "RESCHEDULING"):
                for bundle, node in zip(pg.bundles, pg.bundle_nodes):
                    if node is None:
                        d = dict(bundle)
                        if pg.strategy in ("STRICT_SPREAD", "SPREAD"):
                            d["_gang"] = pg.pg_id.hex()
                        demand.append(d)
        return {
            "nodes": [
                {"node_id": n.node_id.binary(), "node_name": n.node_name,
                 "alive": n.alive, "total": n.resources_total,
                 "available": n.resources_available,
                 "labels": n.labels, "start_time": n.start_time,
                 # age computed on THIS clock so autoscalers on other
                 # machines aren't exposed to cross-host clock skew
                 "age_s": max(time.time() - n.start_time, 0.0),
                 # A node hosting any leased worker or live actor is never
                 # idle, even when resource accounting looks free: queue
                 # actors / Serve replicas default to num_cpus=0 and would
                 # otherwise be torn down with their state (advisor r3).
                 "idle": n.busy_workers == 0 and all(
                     n.resources_available.get(k, 0.0) >= v
                     for k, v in n.resources_total.items())}
                for n in self.nodes.values()
            ],
            "pending_demand": demand,
            # Degraded persistence (e.g. disk full): the cluster runs, but a
            # GCS restart may restore stale state.  Surfaced here so `status`
            # CLI / dashboards can warn before the restart happens.
            "gcs_storage_degraded": getattr(self.store, "degraded", False),
            "resource_broadcasts": self.resource_broadcasts,
        }

    async def rpc_get_cluster_view(self, conn, msg):
        return self.cluster_view()

    def cluster_view(self) -> list:
        return [n.view() for n in self.nodes.values()]

    async def rpc_get_all_node_info(self, conn, msg):
        return [n.view() for n in self.nodes.values()]

    async def rpc_drain_node(self, conn, msg):
        await self._mark_node_dead(NodeID(msg["node_id"]), msg.get("reason", "drained"))
        return True

    async def rpc_check_alive(self, conn, msg):
        return {"alive": True, "cluster_id": self.cluster_id}

    # ----------------------------------------------------------------- jobs
    async def rpc_register_job(self, conn, msg):
        job_id = JobID.from_int(self.next_job)
        self.next_job += 1
        rec = {
            "job_id": job_id.binary(),
            "driver_addr": msg.get("driver_addr"),
            "start_time": time.time(),
            "status": "RUNNING",
            "entrypoint": msg.get("entrypoint", ""),
            "metadata": msg.get("metadata", {}),
        }
        self.jobs[job_id.binary()] = rec
        if self.store.persistent:
            self.store.put("meta", "next_job", str(self.next_job).encode())
        self._persist_job(rec)
        conn.context["job_id"] = job_id.binary()
        return {"job_id": job_id.binary()}

    # ------------------------------------------------- submitted jobs
    # Driver scripts submitted over RPC run as subprocesses of the head node
    # (reference: JobManager, dashboard/modules/job/job_manager.py:58 — there
    # a per-job supervisor actor; here the GCS supervises directly).

    async def rpc_submit_job(self, conn, msg):
        import os
        import subprocess
        import uuid

        submission_id = msg.get("submission_id") or f"rtpu-job-{uuid.uuid4().hex[:10]}"
        if submission_id in self._submitted:
            raise ValueError(f"submission_id {submission_id!r} already used")
        log_dir = os.path.join(self.session_dir or temp_root(), "logs")
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, f"job-{submission_id}.log")
        env = dict(os.environ)
        env["RAY_TPU_TORCH_ADDRESS"] = f"{self.addr[0]}:{self.addr[1]}"
        env.update((msg.get("runtime_env") or {}).get("env_vars") or {})
        cwd = (msg.get("runtime_env") or {}).get("working_dir") or None
        with open(log_path, "ab") as logf:
            proc = subprocess.Popen(
                msg["entrypoint"], shell=True, stdout=logf,
                stderr=subprocess.STDOUT, env=env, cwd=cwd,
                start_new_session=True)
        rec = {
            "job_id": b"",  # filled if/when the driver registers
            "submission_id": submission_id,
            "entrypoint": msg["entrypoint"],
            "status": "RUNNING",
            "start_time": time.time(),
            "metadata": msg.get("metadata", {}),
            "log_path": log_path,
            "pid": proc.pid,
        }
        self._submitted[submission_id] = {"rec": rec, "proc": proc}
        if not getattr(self, "_job_watcher_running", False):
            self._job_watcher_running = True
            asyncio.get_event_loop().create_task(self._watch_jobs_loop())
        return {"submission_id": submission_id}

    async def _watch_jobs_loop(self):
        """One poller for ALL submitted jobs (a thread-per-job proc.wait
        would exhaust the default executor past ~32 concurrent jobs)."""
        while True:
            running = [(sid, e) for sid, e in self._submitted.items()
                       if e["rec"].get("end_time") is None]
            if not running:
                self._job_watcher_running = False
                return
            for sid, entry in running:
                rc = entry["proc"].poll()
                if rc is None:
                    continue
                if entry["rec"]["status"] != "STOPPED":  # user stop persists
                    entry["rec"]["status"] = "SUCCEEDED" if rc == 0 else "FAILED"
                entry["rec"]["end_time"] = time.time()
                entry["rec"]["return_code"] = rc
            await asyncio.sleep(0.5)

    async def rpc_get_submitted_job(self, conn, msg):
        entry = self._submitted.get(msg["submission_id"])
        return dict(entry["rec"]) if entry else None

    async def rpc_list_submitted_jobs(self, conn, msg):
        return [dict(e["rec"]) for e in self._submitted.values()]

    async def rpc_get_job_logs(self, conn, msg):
        entry = self._submitted.get(msg["submission_id"])
        if entry is None:
            return None
        try:
            with open(entry["rec"]["log_path"], "rb") as f:
                return f.read()[-int(msg.get("tail_bytes", 1 << 20)):]
        except OSError:
            return b""

    async def rpc_stop_job(self, conn, msg):
        import os
        import signal

        entry = self._submitted.get(msg["submission_id"])
        if entry is None or entry["proc"].poll() is not None:
            return False
        try:
            # the driver may have spawned children: signal the process group
            os.killpg(os.getpgid(entry["proc"].pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            entry["proc"].terminate()
        entry["rec"]["status"] = "STOPPED"
        return True

    async def rpc_mark_job_finished(self, conn, msg):
        j = self.jobs.get(msg["job_id"])
        if j:
            j["status"] = msg.get("status", "SUCCEEDED")
            j["end_time"] = time.time()
            self._persist_job(j)
        return True

    async def rpc_get_all_job_info(self, conn, msg):
        return list(self.jobs.values())

    # ------------------------------------------------------------------- kv
    async def rpc_kv_put(self, conn, msg):
        ns_name = msg.get("ns", "")
        ns = self.kv.setdefault(ns_name, {})
        existed = msg["key"] in ns
        if msg.get("overwrite", True) or not existed:
            ns[msg["key"]] = msg["value"]
            if self.store.persistent:
                self.store.put("kv", f"{ns_name}\x00{msg['key']}", msg["value"])
        return existed

    async def rpc_kv_get(self, conn, msg):
        return self.kv.get(msg.get("ns", ""), {}).get(msg["key"])

    async def rpc_kv_multi_get(self, conn, msg):
        ns = self.kv.get(msg.get("ns", ""), {})
        return {k: ns[k] for k in msg["keys"] if k in ns}

    async def rpc_kv_del(self, conn, msg):
        ns_name = msg.get("ns", "")
        ns = self.kv.get(ns_name, {})
        if msg.get("prefix"):
            doomed = [k for k in ns if k.startswith(msg["key"])]
            for k in doomed:
                del ns[k]
                if self.store.persistent:
                    self.store.delete("kv", f"{ns_name}\x00{k}")
            return len(doomed)
        hit = ns.pop(msg["key"], None) is not None
        if hit and self.store.persistent:
            self.store.delete("kv", f"{ns_name}\x00{msg['key']}")
        return 1 if hit else 0

    async def rpc_kv_keys(self, conn, msg):
        ns = self.kv.get(msg.get("ns", ""), {})
        prefix = msg.get("prefix", "")
        return [k for k in ns if k.startswith(prefix)]

    async def rpc_kv_exists(self, conn, msg):
        return msg["key"] in self.kv.get(msg.get("ns", ""), {})

    # ------------------------------------------------------- object directory
    async def rpc_object_locations_added(self, conn, msg):
        # Batched {node_id, oids: [bytes]} from nodelets on seal.
        nid = msg["node_id"]
        for ob in msg["oids"]:
            self.object_dir.setdefault(ob, set()).add(nid)
        return True

    async def rpc_object_locations_removed(self, conn, msg):
        nid = msg["node_id"]
        for ob in msg["oids"]:
            locs = self.object_dir.get(ob)
            if locs is not None:
                locs.discard(nid)
                if not locs:
                    del self.object_dir[ob]
        return True

    async def rpc_get_object_locations(self, conn, msg):
        out = {}
        for ob in msg["oids"]:
            locs = self.object_dir.get(ob, set())
            out[ob] = [
                self.nodes[NodeID(n)].addr for n in locs
                if NodeID(n) in self.nodes and self.nodes[NodeID(n)].alive
            ]
        return out

    async def rpc_free_objects(self, conn, msg):
        """Owner-driven free: delete every copy cluster-wide (distributed GC)."""
        by_node: Dict[bytes, List[bytes]] = {}
        for ob in msg["oids"]:
            for nid in self.object_dir.pop(ob, set()):
                by_node.setdefault(nid, []).append(ob)
        for nid, obs in by_node.items():
            info = self.nodes.get(NodeID(nid))
            if info and info.alive:
                try:
                    await info.conn.notify("free_local_objects", {"oids": obs})
                except ConnectionError:
                    pass
        return True

    # ---------------------------------------------------------------- actors
    def _pick_node_for(self, resources: Dict[str, float],
                       label_selector: Optional[dict] = None
                       ) -> Optional[NodeInfo]:
        """GCS-side actor placement (reference: GcsActorScheduler::ScheduleByGcs,
        gcs_actor_scheduler.cc:60) — least-loaded feasible node; hard label
        selectors filter, soft selectors outrank headroom."""
        hard = (label_selector or {}).get("hard") or {}
        soft = (label_selector or {}).get("soft") or {}
        best, best_score = None, None
        for info in self.nodes.values():
            if not info.alive:
                continue
            if hard and any(info.labels.get(k) != v for k, v in hard.items()):
                continue
            if any(info.resources_total.get(k, 0.0) < v for k, v in resources.items() if v > 0):
                continue
            if any(info.resources_available.get(k, 0.0) < v for k, v in resources.items() if v > 0):
                continue
            # LeastResourceScorer-style: prefer the node with most headroom;
            # soft label matches dominate the headroom term
            score = sum(info.resources_available.get(k, 0.0) for k in ("CPU",))
            if soft:
                score += 1e9 * sum(info.labels.get(k) == v
                                   for k, v in soft.items())
            if best_score is None or score > best_score:
                best, best_score = info, score
        return best

    async def rpc_create_actor(self, conn, msg):
        import pickle

        spec: TaskSpec = pickle.loads(msg["spec"])
        actor_id = spec.actor_creation_id
        name = spec.actor_name
        namespace = spec.namespace or ""
        if name:
            key = (namespace, name)
            if key in self.named_actors:
                existing = self.actors.get(self.named_actors[key])
                if existing is not None and existing.state != "DEAD":
                    raise ValueError(f"actor name {name!r} already taken in namespace {namespace!r}")
            self.named_actors[key] = actor_id
        info = ActorInfo(
            actor_id, msg["spec"], name, namespace, spec.max_restarts,
            class_name=spec.name, job_id=spec.job_id.binary(), detached=bool(msg.get("detached")),
        )
        self.actors[actor_id] = info
        self._persist_actor(info)
        asyncio.get_event_loop().create_task(self._schedule_actor(info))
        return {"actor_id": actor_id.binary()}

    async def _schedule_actor(self, info: ActorInfo):
        import pickle

        spec: TaskSpec = pickle.loads(info.spec)
        # No scheduling deadline: an actor queued behind busy resources (or an
        # infeasible one awaiting a node that may yet join) stays PENDING
        # indefinitely, surfaced via the state API (reference: GcsActorManager
        # keeps pending actors queued until resources appear).
        delay = 0.2
        while True:
            # Placement-group bundles pin the actor to the bundle's node.
            target = None
            s = spec.scheduling_strategy
            if s.kind == "placement_group" and s.placement_group_id is not None:
                node_id = self.pg_manager.node_for_bundle(
                    s.placement_group_id, s.placement_group_bundle_index
                )
                if node_id is not None:
                    target = self.nodes.get(NodeID(node_id))
                    if target is not None and not target.alive:
                        target = None
            elif s.kind == "node_affinity" and s.node_id is not None:
                target = self.nodes.get(NodeID(s.node_id))
                if target is not None and (not target.alive):
                    target = None
                if target is None and not s.soft:
                    info.state = "DEAD"
                    info.death_cause = "node affinity target is dead"
                    await self._publish_actor(info)
                    return
            if target is None:
                target = self._pick_node_for(
                    spec.resources,
                    s.label_selector if s.kind == "node_label" else None)
            if target is not None:
                try:
                    # No timeout: this RPC spans the actor's __init__ (can be
                    # minutes); nodelet/worker death surfaces as ConnectionLost.
                    resp = await target.conn.call(
                        "lease_worker_for_actor",
                        {"spec": info.spec,
                         "bundle": (s.placement_group_id.binary(), s.placement_group_bundle_index)
                         if s.kind == "placement_group" and s.placement_group_id else None},
                        timeout=None,
                    )
                except (ConnectionError, asyncio.TimeoutError):
                    resp = None
                if resp and not resp.get("ok") and resp.get("error") is not None:
                    # Constructor raised: deterministic failure, don't retry
                    # elsewhere (reference: creation task error marks the actor
                    # dead with the exception as cause).
                    info.state = "DEAD"
                    info.death_cause = f"actor constructor raised: {resp.get('reason')}"
                    await self._publish_actor(info)
                    return
                if resp and resp.get("ok"):
                    info.state = "ALIVE"
                    info.addr = tuple(resp["worker_addr"])
                    info.worker_id = resp["worker_id"]
                    info.node_id = target.node_id.binary()
                    await self._publish_actor(info)
                    for fut in info.pending_waiters:
                        if not fut.done():
                            fut.set_result(True)
                    info.pending_waiters.clear()
                    return
            if info.state not in ("PENDING_CREATION", "RESTARTING"):
                return  # killed / job-reclaimed while we were waiting
            await asyncio.sleep(delay)
            delay = min(delay * 1.5, 2.0)

    async def _publish_actor(self, info: ActorInfo):
        self._persist_actor(info)  # every state transition flows through here
        await self.publish("actor", info.public_info())
        await self.publish(f"actor:{info.actor_id.hex()}", info.public_info())

    async def _handle_actor_failure(self, info: ActorInfo, reason: str):
        if info.state == "DEAD":
            return
        if info.num_restarts < info.max_restarts or info.max_restarts < 0:
            info.num_restarts += 1
            info.state = "RESTARTING"
            info.addr = None
            await self._publish_actor(info)
            asyncio.get_event_loop().create_task(self._schedule_actor(info))
        else:
            info.state = "DEAD"
            info.death_cause = reason
            await self._publish_actor(info)
            if info.name:
                self.named_actors.pop((info.namespace, info.name), None)

    async def rpc_worker_died(self, conn, msg):
        """Nodelet reports a worker process exit; fail any actor bound to it.
        The report may carry the victim's harvested black box (its flight
        recorder's last records), archived for `state.get_blackbox`."""
        wid = msg["worker_id"]
        self._store_blackbox(msg.get("blackbox"), wid, msg.get("node_id"))
        for info in list(self.actors.values()):
            if info.worker_id == wid and info.state in ("ALIVE", "PENDING_CREATION"):
                await self._handle_actor_failure(
                    info, msg.get("reason", "the worker process died")
                )
        await self._drop_holder_everywhere(wid)
        return True

    def _store_blackbox(self, bb, worker_id=None, node_id=None) -> None:
        if not bb:
            return
        # the notify envelope is authoritative for identity: a harvest ring
        # that lost its header still files under the reporter's ids
        if worker_id is not None and not bb.get("worker_id"):
            bb["worker_id"] = worker_id.hex() \
                if isinstance(worker_id, bytes) else worker_id
        if node_id is not None and not bb.get("node_id"):
            bb["node_id"] = node_id.hex() \
                if isinstance(node_id, bytes) else node_id
        if not bb.get("worker_id"):
            return
        self.blackboxes[bb["worker_id"]] = bb
        keep = max(RayConfig.incident_retention, 1)
        while len(self.blackboxes) > keep:  # evict oldest harvest
            self.blackboxes.pop(next(iter(self.blackboxes)))

    async def rpc_blackbox_harvest(self, conn, msg):
        """Archive a harvested ring for a death that had no worker_died
        report (idle worker reaped, surplus pool shrink)."""
        self._store_blackbox(msg.get("blackbox"), msg.get("worker_id"),
                             msg.get("node_id"))
        return True

    async def rpc_get_blackbox(self, conn, msg):
        """Harvested black boxes by worker_id hex (prefix ok) or node_id
        hex (prefix ok, every harvest from that node); both None = all."""
        wid = msg.get("worker_id")
        nid = msg.get("node_id")
        out = []
        for bb in self.blackboxes.values():
            if wid is not None and not bb["worker_id"].startswith(wid):
                continue
            if nid is not None and not bb.get("node_id", "").startswith(nid):
                continue
            out.append(bb)
        return out

    async def rpc_incident_report(self, conn, msg):
        """A process closed a failure incident.  Join it against the
        harvested black boxes: an explicit victim worker id wins; otherwise
        a harvest from inside the incident's open..close window (the usual
        case for a collective rank kill, where survivors know the dead
        *rank* but not its worker id) rides along flagged as a time match."""
        if msg.get("blackbox") is None:
            bb = self.blackboxes.get(msg.get("victim") or "")
            if bb is None:
                lo = msg.get("opened_at", 0.0) - 1.0
                hi = msg.get("closed_at", 0.0) + 1.0
                for cand in reversed(list(self.blackboxes.values())):
                    if lo <= cand.get("harvested_at", 0.0) <= hi:
                        bb = dict(cand)
                        bb["victim_match"] = "time_window"
                        break
            if bb is not None:
                msg["blackbox"] = bb
        self.incidents.append(msg)
        return True

    async def rpc_list_incidents(self, conn, msg):
        """Closed incidents, newest first; filterable by subsystem."""
        msg = msg or {}
        limit = msg.get("limit", 1000)
        subsystem = msg.get("subsystem")
        out = []
        for rec in reversed(self.incidents):
            if subsystem is not None and rec.get("subsystem") != subsystem:
                continue
            out.append(rec)
            if len(out) >= limit:
                break
        return out

    async def rpc_actor_holder_update(self, conn, msg):
        info = self.actors.get(ActorID(msg["actor_id"]))
        if info is None:
            return True
        if msg["add"]:
            info.holders.add(msg["holder"])
            info.had_holder = True
        else:
            info.holders.discard(msg["holder"])
            await self._maybe_reclaim(info)
        return True

    async def _maybe_reclaim(self, info: ActorInfo):
        """Destroy an actor whose handles are all out of scope (reference:
        GcsActorManager::OnActorOutOfScope)."""
        if (info.had_holder and not info.holders and not info.detached
                and info.state not in ("DEAD",)):
            info.max_restarts = info.num_restarts
            if info.node_id is not None and info.worker_id is not None:
                node = self.nodes.get(NodeID(info.node_id))
                if node and node.alive:
                    try:
                        await node.conn.call("kill_worker", {"worker_id": info.worker_id})
                    except ConnectionError:
                        pass
            await self._handle_actor_failure(info, "all actor handles went out of scope")

    async def _drop_holder_everywhere(self, holder: bytes):
        # a dead client's standing resource request must die with it — the
        # per-requester key means nobody else could ever withdraw it
        self.requested_resources.pop(holder, None)
        for info in list(self.actors.values()):
            if holder in info.holders:
                info.holders.discard(holder)
                await self._maybe_reclaim(info)

    async def rpc_get_actor_info(self, conn, msg):
        actor_id = ActorID(msg["actor_id"])
        info = self.actors.get(actor_id)
        if info is None:
            return None
        if msg.get("wait_alive") and info.state in ("PENDING_CREATION", "RESTARTING"):
            fut = asyncio.get_event_loop().create_future()
            info.pending_waiters.append(fut)
            try:
                await asyncio.wait_for(fut, msg.get("timeout", RayConfig.gcs_rpc_timeout_s))
            except asyncio.TimeoutError:
                pass
        return info.public_info()

    async def rpc_get_named_actor(self, conn, msg):
        actor_id = self.named_actors.get((msg.get("namespace", ""), msg["name"]))
        if actor_id is None:
            return None
        info = self.actors.get(actor_id)
        return info.public_info() if info and info.state != "DEAD" else None

    async def rpc_list_named_actors(self, conn, msg):
        ns = msg.get("namespace")
        out = []
        for (namespace, name), aid in self.named_actors.items():
            info = self.actors.get(aid)
            if info is None or info.state == "DEAD":
                continue
            if ns is None or ns == namespace:
                out.append({"name": name, "namespace": namespace})
        return out

    async def rpc_kill_actor(self, conn, msg):
        actor_id = ActorID(msg["actor_id"])
        info = self.actors.get(actor_id)
        if info is None:
            return False
        no_restart = msg.get("no_restart", True)
        if no_restart:
            info.max_restarts = info.num_restarts  # exhaust restarts
        if info.node_id is not None:
            node = self.nodes.get(NodeID(info.node_id))
            if node and node.alive and info.worker_id:
                try:
                    await node.conn.call("kill_worker", {"worker_id": info.worker_id})
                except ConnectionError:
                    pass
        await self._handle_actor_failure(info, "killed via ray.kill" if no_restart else "actor restart requested")
        return True

    async def rpc_get_all_actor_info(self, conn, msg):
        return [a.public_info() for a in self.actors.values()]

    # ------------------------------------------------------ placement groups
    async def rpc_create_placement_group(self, conn, msg):
        return await self.pg_manager.create(msg)

    async def rpc_remove_placement_group(self, conn, msg):
        return await self.pg_manager.remove(PlacementGroupID(msg["pg_id"]))

    async def rpc_wait_placement_group_ready(self, conn, msg):
        return await self.pg_manager.wait_ready(PlacementGroupID(msg["pg_id"]), msg.get("timeout"))

    async def rpc_get_placement_group(self, conn, msg):
        return self.pg_manager.get_info(PlacementGroupID(msg["pg_id"]))

    async def rpc_get_all_placement_group_info(self, conn, msg):
        return self.pg_manager.list_info()

    async def rpc_get_all_object_info(self, conn, msg):
        """Object directory listing for the state API: oid -> holder nodes."""
        out = []
        for oid, locs in self.object_dir.items():
            out.append({
                "object_id": oid.hex(),
                "locations": [NodeID(n).hex() for n in locs],
            })
        return out

    # ------------------------------------------------------------ task events
    async def rpc_add_task_events(self, conn, msg):
        self.task_events.extend(msg["events"])
        return True

    async def rpc_dump_stacks(self, conn, msg):
        """Proxy a live stack dump to one node's nodelet — or fan out to
        every alive node — over the nodes' existing registration
        connections, so the state API / CLI / dashboard reach any process
        through the GCS they already talk to (the `ray_tpu_torch stack` path)."""
        msg = msg or {}
        node_hex = msg.get("node_id")
        task_id = msg.get("task_id")
        targets = [info for nid, info in self.nodes.items()
                   if info.alive and (node_hex is None
                                      or nid.hex().startswith(node_hex))]

        async def one(info):
            try:
                return await info.conn.call(
                    "dump_stacks", {"task_id": task_id}, timeout=20)
            except (ConnectionError, rpc.ConnectionLost,
                    asyncio.TimeoutError):
                return None

        dumps = await asyncio.gather(*(one(i) for i in targets))
        return [d for d in dumps if d is not None]

    async def rpc_profile_push(self, conn, msg):
        """A nodelet relays profiler deltas (its own threads' and its
        workers', piggybacked on the metrics push): merge into the bounded
        cluster-wide aggregate."""
        node = msg.get("node_id") or "?"
        for entry in msg.get("entries", ()):
            task, subsystem, stack, count = entry[:4]
            tag = entry[4] if len(entry) > 4 else ""
            key = (node, task or "", subsystem or "user", tag or "", stack)
            self.profile[key] = self.profile.get(key, 0) + int(count)
        cap = RayConfig.profile_max_stacks
        if len(self.profile) > cap:
            # evict the coldest stacks first — the flamegraph's wide frames
            # (the answer to "where did the time go") survive
            for key, _n in sorted(self.profile.items(),
                                  key=lambda kv: kv[1])[:len(self.profile)
                                                        - cap]:
                del self.profile[key]
        return True

    async def rpc_rpc_stats(self, conn, msg):
        """Per-method served-RPC counters aggregated over this server's live
        connections ({method: {count, total_s}}) — the runtime half of the
        wire contract.  `ray_tpu_torch summary rpc` joins these observed method
        names against the statically extracted contract snapshot so the two
        views can't silently diverge."""
        agg: Dict[str, list] = {}
        for c in self.server.connections:
            for method, (count, total_s) in c.handler_stats().items():
                st = agg.setdefault(method, [0, 0.0])
                st[0] += count
                st[1] += total_s
        return {m: {"count": v[0], "total_s": v[1]}
                for m, v in agg.items()}

    async def rpc_get_profile(self, conn, msg):
        """The cluster profile aggregate, optionally filtered by node /
        task-name prefix, as ``[[node, task, subsystem, tag, stack, count],
        ...]`` — the flamegraph CLI's and dashboard's read path."""
        msg = msg or {}
        node_hex = msg.get("node_id")
        task_name = msg.get("task_name")
        out = []
        for (node, task, subsystem, tag, stack), count in \
                self.profile.items():
            if node_hex is not None and not node.startswith(node_hex):
                continue
            if task_name is not None and task != task_name:
                continue
            out.append([node, task, subsystem, tag, stack, count])
        return out

    async def rpc_get_task_events(self, conn, msg):
        limit = msg.get("limit", 1000)
        job = msg.get("job_id")
        out = []
        for ev in reversed(self.task_events):
            if job is not None and ev.get("job_id") != job:
                continue
            out.append(ev)
            if len(out) >= limit:
                break
        return out


def main(argv=None):
    """Entry point for the gcs_server process (reference: gcs_server_main.cc)."""
    import argparse
    import sys

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--session-dir", default="")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="[gcs] %(levelname)s %(message)s")

    async def run():
        server = GcsServer(session_dir=args.session_dir or None)
        host, port = await server.start(args.host, args.port)
        # Parent discovers the bound port from this line.
        print(f"GCS_PORT {port}", flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
