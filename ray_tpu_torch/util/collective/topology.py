"""Port of ``ray_tpu/util/collective/topology.py``.

Topology selection for host collectives: flat ring vs hierarchical.

"The Big Send-off" (arXiv:2504.18658) shape: when ranks span multiple
nodes, a two-level reduction — intra-node members reduce into a per-node
leader, leaders run the inter-node ring, leaders broadcast back down —
moves the cross-node traffic once per *node* instead of once per *rank*,
and keeps the intra-node hops on loopback/shm-class links.

Node placement comes from the KV rendezvous (each rank registers its node
id alongside its RPC address); ``collective_virtual_nodes`` > 0 overrides
it with a synthetic partition so single-host worlds (tests, bench) can
exercise the two-level path for real.

Selection (``topology='auto'``): hierarchical when the world spans >= 2
nodes, at least one node holds >= 2 ranks (otherwise the two levels
degenerate to the flat ring plus overhead), and the payload is at least
``collective_hier_min_bytes`` (small messages are latency-bound: the flat
ring's 2(N-1) pipelined hops beat the gather/broadcast fan-in).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ray_tpu_torch._private.config import RayConfig

TOPOLOGIES = ("auto", "ring", "hier")


@dataclasses.dataclass(frozen=True)
class Plan:
    """One rank's view of the selected topology."""

    kind: str                    # "ring" | "hier"
    leaders: List[int]           # inter-node ring, sorted (kind == "hier")
    leader: int                  # this rank's node leader
    members: List[int]           # non-leader ranks on this node (leader view)

    _self_is_leader: bool = False

    @property
    def is_leader(self) -> bool:
        return self._self_is_leader


def node_map(world_size: int, nodes: Optional[Dict[int, str]]) -> Dict[int, str]:
    """rank -> node key, honoring the ``collective_virtual_nodes`` test
    override (contiguous blocks, so 'one node' still means neighbor ranks)."""
    v = RayConfig.collective_virtual_nodes
    if v and v > 0:
        per = max((world_size + v - 1) // v, 1)
        return {r: f"vnode-{r // per}" for r in range(world_size)}
    if not nodes:
        return {r: "node-0" for r in range(world_size)}
    return {r: nodes.get(r, f"rank-{r}") for r in range(world_size)}


def select(world_size: int, nodes: Optional[Dict[int, str]],
           payload_bytes: int, topology: Optional[str] = None) -> str:
    """Resolve the topology kind for one op ('ring' or 'hier')."""
    topo = topology or "auto"
    if topo not in TOPOLOGIES:
        raise ValueError(
            f"unknown topology {topo!r}; expected one of {TOPOLOGIES}")
    nm = node_map(world_size, nodes)
    distinct = set(nm.values())
    if topo == "hier":
        # honored even when every rank shares one node and the two levels
        # degenerate to gather+ring (bench/tests rely on the explicit
        # request)
        return "hier"
    if topo == "ring":
        return "ring"
    # auto
    if len(distinct) < 2 or len(distinct) == world_size:
        return "ring"
    if payload_bytes < RayConfig.collective_hier_min_bytes:
        return "ring"
    return "hier"


def plan(rank: int, world_size: int, nodes: Optional[Dict[int, str]],
         payload_bytes: int, topology: Optional[str] = None) -> Plan:
    """Build this rank's :class:`Plan` for one op."""
    kind = select(world_size, nodes, payload_bytes, topology)
    if kind == "ring":
        return Plan(kind="ring", leaders=list(range(world_size)),
                    leader=rank, members=[], _self_is_leader=True)
    nm = node_map(world_size, nodes)
    by_node: Dict[str, List[int]] = {}
    for r in range(world_size):
        by_node.setdefault(nm[r], []).append(r)
    leaders = sorted(min(rs) for rs in by_node.values())
    my_node_ranks = by_node[nm[rank]]
    leader = min(my_node_ranks)
    members = [r for r in my_node_ranks if r != leader]
    return Plan(kind="hier", leaders=leaders, leader=leader,
                members=members if rank == leader else [],
                _self_is_leader=(rank == leader))
