"""Port of ``ray_tpu/_private/worker.py``.

Global worker singleton + init/shutdown/connect.

Counterpart of the reference's driver bootstrap (reference:
python/ray/_private/worker.py:414 Worker, :1227 init, :1826 shutdown).  ``init``
either starts a local cluster (head Node: GCS + nodelet subprocesses) or connects
to an existing one by GCS address; the driver embeds a CoreWorker either way.
"""

from __future__ import annotations

import atexit
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple, Union

from ray_tpu_torch._private.ids import JobID, NodeID, WorkerID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch.exceptions import RaySystemError

logger = logging.getLogger(__name__)

_global_worker = None
_global_core = None  # CoreWorker for *this* process (driver or task worker)
_init_lock = threading.RLock()


class Worker:
    """Driver-side runtime handle."""

    def __init__(self, core, node=None, namespace: str = ""):
        self.core = core
        self.node = node  # Node process supervisor if we started the cluster
        self.namespace = namespace
        self.connected = True

    @property
    def gcs_addr(self):
        return tuple(self.core.gcs_conn.peername() or ("", 0))


def global_worker() -> Worker:
    if _global_worker is None:
        raise RaySystemError(
            "ray_tpu_torch.init() has not been called (or shutdown() already ran)")
    return _global_worker


def global_worker_core():
    """The process-local CoreWorker, if any (drivers and task workers)."""
    return _global_core


def set_global_core(core) -> None:
    global _global_core
    _global_core = core


def is_initialized() -> bool:
    return _global_worker is not None


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    object_store_memory: Optional[int] = None,
    namespace: str = "",
    ignore_reinit_error: bool = False,
    log_to_driver: bool = True,
    _node_name: str = "",
) -> Worker:
    global _global_worker
    with _init_lock:
        if _global_worker is not None:
            if ignore_reinit_error:
                return _global_worker
            raise RuntimeError("ray_tpu_torch.init() called twice; use ignore_reinit_error=True")

        from ray_tpu_torch._private.core_worker import CoreWorker
        from ray_tpu_torch._private.node import Node

        if address is None:
            # submitted-job drivers and `ray_tpu_torch start` shells connect to the
            # running cluster via the env (reference: RAY_ADDRESS)
            address = os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
        # ray:// scheme = client mode (reference: Ray Client, util/client/):
        # the driver may be on a DIFFERENT machine; object data moves over
        # RPC instead of shared memory.
        client_mode = False
        if address and address.startswith("ray://"):
            client_mode = True
            address = address[len("ray://"):]
        node = None
        if address is None or address == "local":
            res = dict(resources or {})
            if num_cpus is not None:
                res["CPU"] = float(num_cpus)
            if num_gpus is not None:
                res["GPU"] = float(num_gpus)
            node = Node(
                head=True,
                resources=res or None,
                object_store_memory=object_store_memory,
                node_name=_node_name,
            )
            node.start()
            gcs_addr = node.gcs_addr
            nodelet_addr = node.nodelet_addr
        else:
            host, port = address.rsplit(":", 1)
            gcs_addr = (host, int(port))
            nodelet_addr = _find_nodelet(gcs_addr)

        core = CoreWorker(
            mode="driver",
            gcs_addr=gcs_addr,
            nodelet_addr=nodelet_addr,
            remote_plasma=client_mode,
            namespace=namespace,
        )
        core.register_with_nodelet()
        core.register_driver(entrypoint=os.environ.get("_", ""))
        _global_worker = Worker(core, node=node, namespace=namespace)
        set_global_core(core)
        atexit.register(_atexit_shutdown)
        return _global_worker


def _find_nodelet(gcs_addr) -> Tuple[str, int]:
    """Connecting driver: attach to an alive nodelet registered in the GCS."""
    from ray_tpu_torch._private import rpc

    io = rpc.EventLoopThread(name="rtpu-bootstrap")
    try:
        conn = io.run(rpc.connect(*gcs_addr, name="bootstrap"))
        deadline = time.monotonic() + 30
        while True:
            view = io.run(conn.call("get_cluster_view", None))
            alive = [n for n in view if n["alive"]]
            if alive:
                # Prefer a nodelet on this host.
                for n in alive:
                    if n["addr"][0] in ("127.0.0.1", "localhost"):
                        return tuple(n["addr"])
                return tuple(alive[0]["addr"])
            if time.monotonic() > deadline:
                raise RaySystemError("no alive nodes in the cluster")
            time.sleep(0.1)
    finally:
        io.stop()


def _atexit_shutdown():
    try:
        shutdown()
    except Exception:
        pass


def shutdown() -> None:
    global _global_worker
    with _init_lock:
        w = _global_worker
        if w is None:
            return
        _global_worker = None
        set_global_core(None)
        try:
            w.core.shutdown()
        finally:
            if w.node is not None:
                w.node.stop()


# =========================================================== public verbs
def require_core():
    """The CoreWorker for this process; works in drivers AND task workers."""
    core = global_worker_core()
    if core is None:
        raise RaySystemError("ray_tpu_torch runtime not initialized in this process")
    return core


def put(value: Any) -> ObjectRef:
    return require_core().put(value)


def get(refs: Union[ObjectRef, List[ObjectRef]], *, timeout: Optional[float] = None):
    core = require_core()
    if isinstance(refs, ObjectRef):
        return core.get([refs], timeout)[0]
    if not isinstance(refs, list):
        raise TypeError(f"ray.get expects an ObjectRef or list, got {type(refs)}")
    return core.get(refs, timeout)


def wait(refs: List[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    if isinstance(refs, ObjectRef):
        raise TypeError("ray.wait expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError(f"num_returns={num_returns} > len(refs)={len(refs)}")
    return require_core().wait(refs, num_returns, timeout, fetch_local)


async def get_async(ref: ObjectRef):
    """Awaitable get for async actors and drivers."""
    import asyncio

    core = require_core()
    return await asyncio.wrap_future(core.as_future(ref))
