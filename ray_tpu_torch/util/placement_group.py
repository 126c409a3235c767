"""Port of ``ray_tpu/util/placement_group.py``.

Public placement-group API: gang resource reservation.

Counterpart of the reference's ``ray.util.placement_group`` (reference:
python/ray/util/placement_group.py:41 PlacementGroup handle, :145
placement_group()).  The server side — strategy planning, 2PC bundle
reservation, node-death rescheduling — lives in
``ray_tpu_torch/_private/gcs/pg_manager.py``; this module is the user-facing handle.

Why first-class for TPU: STRICT_SPREAD over the hosts of a slice is how SPMD
jax processes gang-schedule (one process per TPU host, all-or-nothing) — the
reference's TPU ``-head`` resource recipe
(python/ray/_private/accelerators/tpu.py:334) rides on exactly this.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.worker import require_core

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    """Handle to a created placement group."""

    def __init__(self, id: PlacementGroupID,
                 bundles: Optional[List[Dict[str, float]]] = None,
                 strategy: str = "PACK", name: str = ""):
        self.id = id
        self._bundles = bundles
        self._strategy = strategy
        self._name = name

    # ------------------------------------------------------------- queries
    def ready(self, timeout: Optional[float] = None) -> bool:
        """Block until every bundle is reserved (or timeout).  Returns True
        once the group reached CREATED.  (The reference returns an ObjectRef
        here; a direct blocking call is the natural shape without a dummy
        task round-trip.)"""
        core = require_core()
        return bool(core.gcs_call_sync(
            "wait_placement_group_ready",
            {"pg_id": self.id.binary(), "timeout": timeout}))

    def wait(self, timeout_seconds: Optional[float] = None) -> bool:
        """Reference-compatible alias of ready()."""
        return self.ready(timeout_seconds)

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        if self._bundles is None:
            info = self._info()
            self._bundles = info["bundles"] if info else []
        return self._bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    @property
    def name(self) -> str:
        return self._name

    @property
    def state(self) -> str:
        info = self._info()
        return info["state"] if info else "REMOVED"

    def bundle_node_ids(self) -> List[Optional[str]]:
        """Hex node id hosting each bundle (None while unplaced) — the gang
        layout, used e.g. to map jax process ranks onto slice hosts."""
        info = self._info()
        if not info:
            return [None] * self.bundle_count
        return [n.hex() if n else None for n in info["bundle_nodes"]]

    def _info(self) -> Optional[dict]:
        core = require_core()
        return core.gcs_call_sync(
            "get_placement_group", {"pg_id": self.id.binary()})

    def __repr__(self):
        return f"PlacementGroup({self.id.hex()[:8]}, {self._strategy})"


def placement_group(bundles: List[Dict[str, float]], strategy: str = "PACK",
                    name: str = "", lifetime: Optional[str] = None) -> PlacementGroup:
    """Atomically reserve groups of resources across the cluster
    (reference: util/placement_group.py:145; strategy kw :147)."""
    if not isinstance(bundles, list) or not bundles:
        raise ValueError("bundles must be a non-empty list of resource dicts")
    for b in bundles:
        if not isinstance(b, dict) or not b:
            raise ValueError(f"each bundle must be a non-empty dict, got {b!r}")
        for k, v in b.items():
            if not isinstance(v, (int, float)) or v < 0:
                raise ValueError(f"bundle resource {k}={v!r} must be >= 0")
        if all(v == 0 for v in b.values()):
            raise ValueError(f"bundle {b!r} has no positive resource")
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"invalid strategy {strategy!r}; one of {VALID_STRATEGIES}")
    if lifetime not in (None, "detached"):
        raise ValueError(f"lifetime must be None or 'detached', got {lifetime!r}")

    core = require_core()
    pg_id = PlacementGroupID.from_random()
    core.io.run(core.gcs_conn.call("create_placement_group", {
        "pg_id": pg_id.binary(),
        "bundles": [{k: float(v) for k, v in b.items()} for b in bundles],
        "strategy": strategy,
        "name": name,
        "job_id": core.job_id.binary(),
        "detached": lifetime == "detached",
    }))
    return PlacementGroup(pg_id, list(bundles), strategy, name)


def remove_placement_group(pg: PlacementGroup) -> None:
    """Release all bundles; queued leases against them fail over to the node
    pool (reference: util/placement_group.py remove_placement_group)."""
    core = require_core()
    core.gcs_call_sync(
        "remove_placement_group", {"pg_id": pg.id.binary()})


def placement_group_table() -> List[dict]:
    """All placement groups' info (reference: util/placement_group.py
    placement_group_table)."""
    core = require_core()
    infos = core.gcs_call_sync("get_all_placement_group_info", None)
    return [{**i, "pg_id": i["pg_id"].hex(),
             "bundle_nodes": [n.hex() if n else None for n in i["bundle_nodes"]]}
            for i in infos]


def get_placement_group(name: str) -> PlacementGroup:
    """Look up a placement group by name."""
    core = require_core()
    infos = core.gcs_call_sync("get_all_placement_group_info", None)
    for i in infos:
        if i.get("name") == name and i["state"] != "REMOVED":
            return PlacementGroup(PlacementGroupID(i["pg_id"]), i["bundles"],
                                  i["strategy"], name)
    raise ValueError(f"placement group with name {name!r} not found")
