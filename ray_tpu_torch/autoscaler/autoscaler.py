"""Port of ``ray_tpu/autoscaler/autoscaler.py``.

StandardAutoscaler: demand-driven cluster scaling.

Reference: python/ray/autoscaler/_private/autoscaler.py:172 (StandardAutoscaler)
+ _private/resource_demand_scheduler.py (bin-packing pending demand onto node
types) + _private/monitor.py (the polling loop).  Condensed to the load-bearing
behavior:

- poll the GCS for cluster status (per-node utilization + pending resource
  demand — queued leases and unplaceable actors);
- bin-pack unmet demand onto configured node types, bounded by per-type
  max_workers and the global max_workers; launch via the NodeProvider;
- terminate nodes idle longer than idle_timeout_s (never the head);
- crash-loop protection: a type that failed to launch backs off.

TPU note: a "node type" maps naturally to a TPU VM shape; gang demand from
STRICT_SPREAD placement groups appears as multiple single-host shapes, which
bin-pack onto multiple hosts exactly like the reference.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import (
    NodeProvider, STATUS_UP, TAG_NODE_STATUS, TAG_NODE_TYPE)

logger = logging.getLogger(__name__)


@dataclass
class NodeTypeConfig:
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10
    # Provider-specific launch parameters (reference: the node_config block
    # of cluster YAMLs) — e.g. {"tpu_pod_type": "v5e-16"} makes the TPU
    # provider provision whole slices.
    node_config: Dict[str, Any] = field(default_factory=dict)


@dataclass
class AutoscalingConfig:
    node_types: Dict[str, NodeTypeConfig]
    max_workers: int = 10
    idle_timeout_s: float = 60.0
    update_interval_s: float = 1.0


def _fits(avail: Dict[str, float], req: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v for k, v in req.items() if v > 0)


def _consume(avail: Dict[str, float], req: Dict[str, float]) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0.0) - v


class StandardAutoscaler:
    """One update() pass = read status -> launch/terminate.  Run via
    start()/stop() for the monitor-loop mode (reference: monitor.py)."""

    def __init__(self, config: AutoscalingConfig, provider: NodeProvider,
                 gcs_call):
        """gcs_call(method, msg) -> reply; injected so the autoscaler can run
        inside any process that can reach the GCS."""
        self.config = config
        self.provider = provider
        self.gcs_call = gcs_call
        self._idle_since: Dict[str, float] = {}   # node_name -> first idle ts
        # launched-but-not-yet-registered capacity: cloud create_node returns
        # long before the node joins the GCS; without crediting these, every
        # update relaunches for the same demand (reference: pending-launch
        # accounting in resource_demand_scheduler)
        self._pending_launches: List[tuple] = []  # (ts, resources)
        self.launch_grace_s = 180.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.launched: Dict[str, int] = {t: 0 for t in config.node_types}
        self.terminated = 0

    # ------------------------------------------------------------- loop
    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        # minimum footprint first
        self._ensure_min_workers()
        while not self._stop.is_set():
            try:
                self.update()
            except Exception:
                logger.exception("autoscaler update failed")
            self._stop.wait(self.config.update_interval_s)

    def _ensure_min_workers(self) -> None:
        for tname, tcfg in self.config.node_types.items():
            have = len(self.provider.non_terminated_nodes(
                {TAG_NODE_TYPE: tname}))
            if have < tcfg.min_workers:
                self._launch(tname, tcfg.min_workers - have)

    # ------------------------------------------------------------ update
    def update(self) -> None:
        status = self.gcs_call("get_cluster_status", None)
        self._scale_up(status)
        self._scale_down(status)

    def _scale_up(self, status: dict) -> None:
        demand: List[Dict[str, float]] = list(status.get("pending_demand", []))
        if not demand:
            return
        # capacity still free on live nodes absorbs demand first, then
        # capacity already on its way up (pending launches within the grace).
        # Each free-capacity slot tracks which gangs it already absorbed a
        # bundle of: STRICT_SPREAD bundles are node-anti-affine, so a single
        # node must never swallow two of them (it could not actually host
        # them, deadlocking the gang with zero launches).
        now = time.monotonic()
        self._pending_launches = [
            (ts, res) for ts, res in self._pending_launches
            if now - ts < self.launch_grace_s]
        frees = [[dict(n["available"]), set()]
                 for n in status["nodes"] if n["alive"]]
        frees.extend([dict(res), set()]
                     for _ts, res in self._pending_launches)
        unmet: List[Dict[str, float]] = []
        for d in demand:
            req = dict(d)
            gang = req.pop("_gang", None)
            placed = False
            for avail, gangs in frees:
                if gang is not None and gang in gangs:
                    continue
                if _fits(avail, req):
                    _consume(avail, req)
                    if gang is not None:
                        gangs.add(gang)
                    placed = True
                    break
            if not placed:
                unmet.append(d)
        if not unmet:
            return
        # bin-pack unmet demand onto new nodes of the configured types
        to_launch: Dict[str, int] = {}
        virtual: List[list] = []  # [avail, gangs]
        counts = {t: len(self.provider.non_terminated_nodes(
            {TAG_NODE_TYPE: t})) for t in self.config.node_types}
        total_now = sum(counts.values())
        for d in unmet:
            req = dict(d)
            gang = req.pop("_gang", None)
            placed = False
            for avail, gangs in virtual:
                if gang is not None and gang in gangs:
                    continue
                if _fits(avail, req):
                    _consume(avail, req)
                    if gang is not None:
                        gangs.add(gang)
                    placed = True
                    break
            if placed:
                continue
            for tname, tcfg in self.config.node_types.items():
                planned = counts[tname] + to_launch.get(tname, 0)
                global_planned = total_now + sum(to_launch.values())
                if not _fits(dict(tcfg.resources), req):
                    continue
                if planned >= tcfg.max_workers or \
                        global_planned >= self.config.max_workers:
                    continue
                to_launch[tname] = to_launch.get(tname, 0) + 1
                fresh = dict(tcfg.resources)
                _consume(fresh, req)
                virtual.append([fresh, {gang} if gang is not None else set()])
                placed = True
                break
            if not placed:
                logger.warning("demand %s unsatisfiable by any node type", req)
        for tname, count in to_launch.items():
            self._launch(tname, count)

    def _launch(self, tname: str, count: int) -> None:
        tcfg = self.config.node_types[tname]
        logger.info("autoscaler launching %d x %s (%s)", count, tname,
                    tcfg.resources)
        created = 0
        try:
            # providers may return how many nodes they actually created
            # (slice providers can partially succeed); None means all
            created = self.provider.create_node(
                {"resources": tcfg.resources, **tcfg.node_config},
                {TAG_NODE_TYPE: tname, TAG_NODE_STATUS: STATUS_UP}, count)
            if created is None:
                created = count
        except Exception:
            logger.exception("launch of %s failed", tname)
        if created:
            self.launched[tname] = self.launched.get(tname, 0) + created
            now = time.monotonic()
            self._pending_launches.extend(
                (now, dict(tcfg.resources)) for _ in range(created))

    def _scale_down(self, status: dict) -> None:
        now = time.monotonic()
        # Launch grace: a freshly-provisioned node is idle until the demand
        # that caused its launch schedules onto it (gangs wait for EVERY
        # host of a slice) — reaping it in that window livelocks scale-up.
        # age_s is computed on the GCS clock, immune to cross-host skew.
        grace = min(self.launch_grace_s, self.config.idle_timeout_s + 30.0)
        idle_names = {n["node_name"] for n in status["nodes"]
                      if n["alive"] and n["idle"]
                      and n.get("age_s", float("inf")) >= grace}

        # Standing demand (request_resources) holds capacity: an idle node
        # is only reapable if the remaining nodes still fit every pending
        # bundle — otherwise held nodes would flap launch/idle/terminate.
        demand = [dict(d) for d in status.get("pending_demand", [])]
        for d in demand:
            d.pop("_gang", None)

        def demand_fits_without(doomed_name: str) -> bool:
            if not demand:
                return True
            frees = [dict(n["available"]) for n in status["nodes"]
                     if n["alive"] and n["node_name"] != doomed_name]
            for req in demand:
                for avail in frees:
                    if _fits(avail, req):
                        _consume(avail, req)
                        break
                else:
                    return False
            return True
        for nid in list(self._idle_since):
            if nid not in idle_names:
                del self._idle_since[nid]
        # map provider nodes by name; never terminate below min_workers
        for tname, tcfg in self.config.node_types.items():
            nodes = self.provider.non_terminated_nodes({TAG_NODE_TYPE: tname})
            reapable = len(nodes) - tcfg.min_workers
            for nid in nodes:
                if reapable <= 0:
                    break
                name = self.provider.node_name(nid) \
                    if hasattr(self.provider, "node_name") else nid
                if name not in idle_names:
                    continue
                first = self._idle_since.setdefault(name, now)
                if now - first >= self.config.idle_timeout_s:
                    if not demand_fits_without(name):
                        continue  # this node covers standing demand
                    logger.info("autoscaler terminating idle node %s", nid)
                    self.provider.terminate_node(nid)
                    self.terminated += 1
                    self._idle_since.pop(name, None)
                    reapable -= 1
