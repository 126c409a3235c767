"""Port of ``ray_tpu/_private/gcs/pg_manager.py``.

Placement groups: gang resource reservation with 2-phase commit.

Counterpart of the reference's GcsPlacementGroupManager/Scheduler (reference:
src/ray/gcs/gcs_server/gcs_placement_group_manager.h, gcs_placement_group_scheduler.h)
and the bundle scheduling policies (src/ray/raylet/scheduling/policy/
bundle_scheduling_policy.h:31,82,90,98,106 — PACK / SPREAD / STRICT_PACK /
STRICT_SPREAD).

Why this matters for TPU: STRICT_SPREAD over hosts of a slice is how SPMD jax
processes gang-schedule (one process per TPU host, all-or-nothing), mirroring the
reference's TPU `-head` resource trick (python/ray/_private/accelerators/tpu.py:334).

Protocol: pick nodes per strategy against the GCS cluster view, then 2PC against
the chosen nodelets — prepare_bundle reserves resources (can fail on a race with a
lease), commit_bundle finalizes, cancel_bundle rolls back.  Node death returns the
group to PENDING and reschedules lost bundles (reference: placement-group rescheduling
on node failure).
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import RayConfig
from ray_tpu_torch._private.ids import NodeID, PlacementGroupID

logger = logging.getLogger(__name__)

STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PgInfo:
    __slots__ = ("pg_id", "bundles", "strategy", "name", "state", "bundle_nodes",
                 "ready_event", "creator_job", "detached", "scheduling")

    def __init__(self, pg_id, bundles, strategy, name, creator_job, detached):
        self.pg_id: PlacementGroupID = pg_id
        self.bundles: List[Dict[str, float]] = bundles
        self.strategy = strategy
        self.name = name
        self.state = "PENDING"  # PENDING -> CREATED -> REMOVED ; RESCHEDULING
        self.bundle_nodes: List[Optional[bytes]] = [None] * len(bundles)
        self.ready_event = asyncio.Event()
        self.creator_job = creator_job
        self.detached = detached
        self.scheduling = False  # a _schedule_loop task is live (single-flight)

    def info(self) -> dict:
        return {
            "pg_id": self.pg_id.binary(),
            "name": self.name,
            "strategy": self.strategy,
            "state": self.state,
            "bundles": self.bundles,
            "bundle_nodes": list(self.bundle_nodes),
        }

    def to_record(self) -> dict:
        rec = self.info()
        rec["creator_job"] = self.creator_job
        rec["detached"] = self.detached
        return rec

    @classmethod
    def from_record(cls, rec: dict) -> "PgInfo":
        pg = cls(PlacementGroupID(rec["pg_id"]), rec["bundles"],
                 rec["strategy"], rec["name"], rec["creator_job"],
                 rec["detached"])
        pg.state = rec["state"]
        pg.bundle_nodes = list(rec["bundle_nodes"])
        if pg.state == "CREATED":
            pg.ready_event.set()
        return pg


class PlacementGroupManager:
    def __init__(self, gcs):
        self.gcs = gcs
        self.groups: Dict[PlacementGroupID, PgInfo] = {}
        self._pending: List[PlacementGroupID] = []

    def _spawn_schedule(self, pg: PgInfo):
        """At most ONE _schedule_loop per group: concurrent loops would race
        2PC bundle placement against each other (each can be mid-prepare on
        different nodes for the same index)."""
        if pg.scheduling:
            return
        pg.scheduling = True

        async def _run():
            try:
                await self._schedule_loop(pg)
            finally:
                pg.scheduling = False

        asyncio.get_event_loop().create_task(_run())

    # ------------------------------------------------------- persistence
    def _persist(self, pg: PgInfo):
        store = getattr(self.gcs, "store", None)
        if store is not None and store.persistent:
            import pickle

            if pg.state == "REMOVED":
                store.delete("placement_groups", pg.pg_id.hex())
            else:
                store.put("placement_groups", pg.pg_id.hex(),
                          pickle.dumps(pg.to_record()))  # lint: disable=no-flatten (KV record)

    def load_from_store(self, store):
        if not store.persistent:
            return
        import pickle

        for _, blob in store.get_all("placement_groups").items():
            pg = PgInfo.from_record(pickle.loads(blob))
            self.groups[pg.pg_id] = pg
            if pg.state in ("PENDING", "RESCHEDULING"):
                self._spawn_schedule(pg)

    def reconcile_after_restart(self, alive_node_ids: set):
        """Post-restart sweep: bundles restored onto nodes that never
        re-registered are lost — clear them and reschedule (the normal
        on_node_dead path can't fire for nodes the restarted GCS never saw)."""
        for pg in self.groups.values():
            if pg.state not in ("CREATED", "PENDING", "RESCHEDULING"):
                continue
            lost = [i for i, n in enumerate(pg.bundle_nodes)
                    if n is not None and n not in alive_node_ids]
            if lost:
                for i in lost:
                    pg.bundle_nodes[i] = None
                pg.state = "RESCHEDULING"
                pg.ready_event.clear()
                self._persist(pg)
                logger.warning(
                    "placement group %s lost %d bundle(s) across GCS "
                    "restart; rescheduling", pg.pg_id.hex()[:12], len(lost))
                self._spawn_schedule(pg)

    def reconcile_bundle(self, pg_id_bin: bytes, index: int,
                         node_id_bin: bytes):
        """A re-registering node reports a bundle it still holds (after a GCS
        restart the restored pg record should already agree; this heals any
        divergence)."""
        pg = self.groups.get(PlacementGroupID(pg_id_bin))
        if pg is None or pg.state == "REMOVED":
            return
        if 0 <= index < len(pg.bundle_nodes):
            pg.bundle_nodes[index] = node_id_bin
            if all(n is not None for n in pg.bundle_nodes) \
                    and pg.state in ("PENDING", "RESCHEDULING", "CREATED"):
                pg.state = "CREATED"
                pg.ready_event.set()
            self._persist(pg)

    # ---------------------------------------------------------------- public
    async def create(self, msg) -> dict:
        pg_id = PlacementGroupID(msg["pg_id"])
        strategy = msg.get("strategy", "PACK")
        if strategy not in STRATEGIES:
            raise ValueError(f"invalid placement strategy {strategy!r}")
        pg = PgInfo(pg_id, msg["bundles"], strategy, msg.get("name", ""),
                    msg.get("job_id"), msg.get("detached", False))
        self.groups[pg_id] = pg
        self._persist(pg)
        self._spawn_schedule(pg)
        return {"pg_id": pg_id.binary()}

    async def remove(self, pg_id: PlacementGroupID) -> bool:
        pg = self.groups.get(pg_id)
        if pg is None:
            return False
        pg.state = "REMOVED"
        self._persist(pg)
        await self._release_bundles(pg, range(len(pg.bundles)))
        await self.gcs.publish("placement_group", pg.info())
        return True

    async def wait_ready(self, pg_id: PlacementGroupID, timeout: Optional[float]) -> bool:
        pg = self.groups.get(pg_id)
        if pg is None:
            return False
        try:
            await asyncio.wait_for(pg.ready_event.wait(), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    def get_info(self, pg_id: PlacementGroupID) -> Optional[dict]:
        pg = self.groups.get(pg_id)
        return pg.info() if pg else None

    def list_info(self) -> list:
        return [pg.info() for pg in self.groups.values()]

    def node_for_bundle(self, pg_id: PlacementGroupID, index: int) -> Optional[bytes]:
        pg = self.groups.get(pg_id)
        if pg is None or pg.state != "CREATED":
            return None
        if index < 0:
            # Any-bundle request: pick among the PG's nodes at random — the
            # chosen nodelet resolves to a local bundle with capacity, and the
            # actor scheduling loop re-picks on each retry, so a busy node
            # doesn't pin the request forever (reference: bundle_index=-1).
            cands = [nid for nid in pg.bundle_nodes if nid is not None]
            return random.choice(cands) if cands else None
        if index >= len(pg.bundle_nodes):
            return None
        return pg.bundle_nodes[index]

    def on_node_dead(self, node_id: NodeID):
        nid = node_id.binary()
        for pg in self.groups.values():
            if pg.state not in ("CREATED", "PENDING", "RESCHEDULING"):
                continue
            lost = [i for i, n in enumerate(pg.bundle_nodes) if n == nid]
            if lost:
                for i in lost:
                    pg.bundle_nodes[i] = None
                pg.state = "RESCHEDULING"
                pg.ready_event.clear()
                self._persist(pg)
                self._spawn_schedule(pg)

    # -------------------------------------------------------------- internal
    def _alive_nodes(self):
        return [n for n in self.gcs.nodes.values() if n.alive]

    def _feasible(self, node, resources) -> bool:
        return all(node.resources_total.get(k, 0.0) >= v for k, v in resources.items() if v > 0)

    def _plan(self, pg: PgInfo) -> Optional[List[Tuple[int, object]]]:
        """Choose a node per unplaced bundle. Returns [(bundle_idx, NodeInfo)] or
        None if infeasible right now.  Planning uses *available* resources from the
        latest reports; the prepare phase is what makes it safe under races."""
        nodes = self._alive_nodes()
        if not nodes:
            return None
        todo = [i for i, n in enumerate(pg.bundle_nodes) if n is None]
        # Track planned deductions so one node isn't double-booked in this plan.
        avail = {id(n): dict(n.resources_available) for n in nodes}

        def fits(n, res):
            a = avail[id(n)]
            return all(a.get(k, 0.0) >= v for k, v in res.items() if v > 0)

        def take(n, res):
            a = avail[id(n)]
            for k, v in res.items():
                a[k] = a.get(k, 0.0) - v

        plan: List[Tuple[int, object]] = []
        if pg.strategy == "STRICT_PACK":
            # Every bundle on one node (including previously-placed ones).
            placed_nodes = {n for n in pg.bundle_nodes if n is not None}
            for n in nodes:
                if placed_nodes and n.node_id.binary() not in placed_nodes:
                    continue
                ok = True
                snapshot = dict(avail[id(n)])
                for i in todo:
                    if fits(n, pg.bundles[i]):
                        take(n, pg.bundles[i])
                    else:
                        ok = False
                        break
                if ok:
                    return [(i, n) for i in todo]
                avail[id(n)] = snapshot
            return None
        if pg.strategy == "STRICT_SPREAD":
            # One bundle per distinct node, all-or-nothing.
            used = {n for n in pg.bundle_nodes if n is not None}
            cand = [n for n in nodes if n.node_id.binary() not in used]
            for i in todo:
                pick = next((n for n in cand if fits(n, pg.bundles[i])), None)
                if pick is None:
                    return None
                take(pick, pg.bundles[i])
                cand.remove(pick)
                plan.append((i, pick))
            return plan
        # PACK: prefer fewest nodes (fill the first feasible); SPREAD: round-robin
        # across nodes by least-loaded first.
        for i in todo:
            cands = [n for n in nodes if fits(n, pg.bundles[i])]
            if not cands:
                return None
            if pg.strategy == "PACK":
                pick = cands[0]
            else:  # SPREAD: most available CPU first
                pick = max(cands, key=lambda n: avail[id(n)].get("CPU", 0.0))
            take(pick, pg.bundles[i])
            plan.append((i, pick))
        return plan

    async def _schedule_loop(self, pg: PgInfo):
        while pg.state in ("PENDING", "RESCHEDULING"):
            plan = self._plan(pg)
            if plan is not None:
                ok = await self._try_place(pg, plan)
                if ok:
                    pg.state = "CREATED"
                    pg.ready_event.set()
                    self._persist(pg)
                    await self.gcs.publish("placement_group", pg.info())
                    return
            await asyncio.sleep(0.2)

    async def _try_place(self, pg: PgInfo, plan) -> bool:
        # Phase 1: prepare every bundle.
        prepared: List[Tuple[int, object]] = []
        for i, node in plan:
            try:
                ok = await node.conn.call("prepare_bundle", {
                    "pg_id": pg.pg_id.binary(), "index": i, "resources": pg.bundles[i],
                }, timeout=RayConfig.gcs_rpc_timeout_s)
            except (ConnectionError, asyncio.TimeoutError):
                ok = False
            if not ok:
                for j, n2 in prepared:
                    try:
                        await n2.conn.call("cancel_bundle", {"pg_id": pg.pg_id.binary(), "index": j})
                    except ConnectionError:
                        pass
                return False
            prepared.append((i, node))
        # Phase 2: commit.
        for i, node in prepared:
            try:
                await node.conn.call("commit_bundle", {"pg_id": pg.pg_id.binary(), "index": i})
            except ConnectionError:
                pass  # node death is handled by on_node_dead rescheduling
            pg.bundle_nodes[i] = node.node_id.binary()
        return True

    async def _release_bundles(self, pg: PgInfo, indices):
        for i in indices:
            nid = pg.bundle_nodes[i]
            if nid is None:
                continue
            node = self.gcs.nodes.get(NodeID(nid))
            pg.bundle_nodes[i] = None
            if node and node.alive:
                try:
                    await node.conn.call("cancel_bundle", {"pg_id": pg.pg_id.binary(), "index": i})
                except ConnectionError:
                    pass
