"""Port of ``ray_tpu/autoscaler/node_provider.py``.

NodeProvider: the cloud-abstraction plugin surface of the autoscaler.

Reference: python/ray/autoscaler/node_provider.py:13 (NodeProvider ABC) and
autoscaler/_private/fake_multi_node/node_provider.py:237 (the fake provider
the reference uses to test autoscaling without a cloud).  The local provider
here launches REAL extra nodes as processes on this machine — the same
trick as cluster_utils.Cluster — so autoscaler behavior is testable
end-to-end; a GCE/TPU-VM provider implements the same five methods against
the cloud API.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

TAG_NODE_TYPE = "node-type"
TAG_NODE_STATUS = "node-status"
STATUS_UP = "up-to-date"


class NodeProvider:
    """Minimal provider surface (create/terminate/list/tags)."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        self.provider_config = provider_config
        self.cluster_name = cluster_name

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        raise NotImplementedError

    def node_tags(self, node_id: str) -> Dict[str, str]:
        raise NotImplementedError

    def create_node(self, node_config: Dict[str, Any], tags: Dict[str, str],
                    count: int) -> Optional[int]:
        """Returns how many nodes were actually created, or None meaning
        `count` (slice providers can partially succeed)."""
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def is_running(self, node_id: str) -> bool:
        raise NotImplementedError

    def internal_ip(self, node_id: str) -> Optional[str]:
        return None


class LocalNodeProvider(NodeProvider):
    """Launches worker nodes as local processes attached to a running head
    (reference: FakeMultiNodeProvider — fake cloud, real raylets)."""

    def __init__(self, provider_config: Dict[str, Any], cluster_name: str):
        super().__init__(provider_config, cluster_name)
        # gcs address of the running head node this provider attaches to
        self.gcs_addr = provider_config["gcs_addr"]
        self.session_dir = provider_config.get("session_dir")
        self._nodes: Dict[str, Any] = {}   # provider node id -> Node
        self._tags: Dict[str, Dict[str, str]] = {}
        self._counter = 0
        self._lock = threading.Lock()

    def non_terminated_nodes(self, tag_filters: Dict[str, str]) -> List[str]:
        with self._lock:
            out = []
            for nid, tags in self._tags.items():
                if all(tags.get(k) == v for k, v in tag_filters.items()):
                    node = self._nodes[nid]
                    if node.nodelet_proc and node.nodelet_proc.poll() is None:
                        out.append(nid)
            return out

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            return dict(self._tags.get(node_id, {}))

    def create_node(self, node_config: Dict[str, Any], tags: Dict[str, str],
                    count: int) -> None:
        from ray_tpu_torch._private.node import Node

        for _ in range(count):
            with self._lock:
                self._counter += 1
                nid = f"{self.cluster_name}-node-{self._counter}"
            resources = dict(node_config.get("resources", {}))
            node = Node(
                head=False, gcs_addr=tuple(self.gcs_addr),
                resources=resources or None,
                session_dir=self.session_dir,
                node_name=nid,
            )
            node.start()
            with self._lock:
                self._nodes[nid] = node
                self._tags[nid] = dict(tags)
                self._tags[nid][TAG_NODE_STATUS] = STATUS_UP

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            node = self._nodes.pop(node_id, None)
            self._tags.pop(node_id, None)
        if node is not None:
            node.stop()

    def is_running(self, node_id: str) -> bool:
        with self._lock:
            node = self._nodes.get(node_id)
        return bool(node and node.nodelet_proc and
                    node.nodelet_proc.poll() is None)

    def node_name(self, node_id: str) -> str:
        return node_id

    def shutdown(self) -> None:
        with self._lock:
            nodes = list(self._nodes.values())
            self._nodes.clear()
            self._tags.clear()
        for n in nodes:
            n.stop()
