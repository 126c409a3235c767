"""Port of ``ray_tpu/cluster_utils.py``.

In-process multi-node cluster for tests.

Counterpart of the reference's Cluster (reference: python/ray/cluster_utils.py:135
Cluster, :201 add_node): extra nodelets started on one machine, each believing it
is a distinct node — the load-bearing test fixture for multi-node behavior
without real machines (SURVEY §4 takeaway (a)).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from ray_tpu_torch._private.node import Node


class Cluster:
    def __init__(self, initialize_head: bool = False, head_node_args: Optional[dict] = None):
        self.head_node: Optional[Node] = None
        self.worker_nodes: list[Node] = []
        self._n = 0
        if initialize_head:
            self.add_node(**(head_node_args or {}))

    @property
    def address(self) -> str:
        assert self.head_node is not None, "no head node started"
        return f"{self.head_node.gcs_addr[0]}:{self.head_node.gcs_addr[1]}"

    @property
    def gcs_addr(self):
        return self.head_node.gcs_addr

    def add_node(self, *, num_cpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None,
                 object_store_memory: Optional[int] = None,
                 node_name: str = "") -> Node:
        res = dict(resources or {})
        if num_cpus is not None:
            res["CPU"] = float(num_cpus)
        self._n += 1
        node = Node(
            head=self.head_node is None,
            gcs_addr=self.head_node.gcs_addr if self.head_node else None,
            resources=res or None,
            labels=labels,
            object_store_memory=object_store_memory,
            session_dir=self.head_node.session_dir if self.head_node else None,
            node_name=node_name or f"node{self._n}",
        )
        node.start()
        if self.head_node is None:
            self.head_node = node
        else:
            self.worker_nodes.append(node)
        return node

    def remove_node(self, node: Node, allow_graceful: bool = False):
        node.stop()
        if node in self.worker_nodes:
            self.worker_nodes.remove(node)

    def kill_node(self, node: Node):
        """Hard-kill a nodelet to simulate node failure (reference:
        test_utils.py kill_raylet :1951)."""
        node.kill_nodelet()

    def wait_for_nodes(self, timeout: float = 30.0) -> None:
        import ray_tpu_torch

        expected = 1 + len(self.worker_nodes)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            alive = [n for n in ray_tpu_torch.nodes() if n["Alive"]]
            if len(alive) >= expected:
                return
            time.sleep(0.1)
        raise TimeoutError(f"cluster did not reach {expected} alive nodes")

    def shutdown(self):
        for node in self.worker_nodes:
            node.stop()
        self.worker_nodes.clear()
        if self.head_node is not None:
            self.head_node.stop()
            self.head_node = None
