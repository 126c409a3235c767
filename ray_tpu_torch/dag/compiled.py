"""Port of ``ray_tpu/dag/compiled.py``.

Compiled DAGs: actor graphs over persistent shared-memory channels.

Counterpart of the reference's accelerated DAGs (reference:
python/ray/dag/compiled_dag_node.py:480 CompiledDAG;
experimental/channel/shared_memory_channel.py;
src/ray/core_worker/experimental_mutable_object_manager.h).  The shape is
the same — compile once, then ``execute()`` repeatedly with no per-call task
submission — but the transport is TPU-host-native: every edge is an SPSC
shm ring (``ray_tpu_torch.experimental.channel.ShmChannel``), and each
participating actor is taken over by a channel-driven loop (read inputs ->
run method -> write outputs) started as ONE ordinary actor task.  After
compile, a hop costs one pickle + one memcpy + one ring-counter publish;
no lease, no RPC frame, no event loop.

Restrictions: every non-input node is an actor-method call.  An actor may
host SEVERAL nodes (its loop runs them in topological order each tick), and
``MultiOutputNode`` roots return a list per execute (reference:
dag/output_node.py).

Edges are node-aware: when both endpoints live on the driver's node the edge
is an shm ring; an edge that crosses nodes falls back to a TCP channel with
the same depth-bounded SPSC semantics (``experimental.channel.TcpChannel``,
rendezvous via GCS KV) — so a gang-scheduled per-host pipeline compiles and
runs without driver co-location (reference analogue: the remote-reader path
of shared_memory_channel.py; the NCCL device channel,
torch_tensor_nccl_channel.py:191, is the future device-plane upgrade).
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

from ray_tpu_torch.dag import (ClassMethodNode, DAGNode, InputNode,
                         MultiOutputNode)
from ray_tpu_torch.experimental.channel import (ChannelClosed, ShmChannel,
                                          TcpChannel)

CHANNEL_LOOP_METHOD = "__ray_tpu_channel_loop__"

# Driver-side registry of actors currently serving a compiled DAG: their
# executor is occupied by the channel loop, so a second compile over the
# same actor would queue forever with no diagnostic.
_ACTORS_IN_USE: set = set()


class DagError:
    """An upstream failure riding the channels (re-raised at get())."""

    def __init__(self, exc: BaseException):
        try:
            self.payload = pickle.dumps(exc)  # lint: disable=no-flatten (error frame)
        except Exception:
            self.payload = pickle.dumps(  # lint: disable=no-flatten (error frame)
                RuntimeError(f"unpicklable DAG error: {exc!r}"))

    def raise_(self):
        raise pickle.loads(self.payload)


class CompiledDAGRef:
    """Result handle of one execute(); reads the output channel lazily."""

    def __init__(self, dag: "CompiledDAG", seq: int):
        self._dag = dag
        self._seq = seq

    def get(self, timeout: Optional[float] = None) -> Any:
        value = self._dag._result_for(self._seq, timeout)
        members = value if self._dag._is_multi else [value]
        for v in members:  # multi-output: any member's failure raises
            if isinstance(v, DagError):
                v.raise_()
        return value

    def __await__(self):
        """``await ref`` from asyncio code (reference: CompiledDAGFuture):
        the blocking channel read runs on a worker thread so the event loop
        stays live."""
        import asyncio

        loop = asyncio.get_event_loop()
        return loop.run_in_executor(None, self.get).__await__()


class CompiledDAG:
    def __init__(self, output_node: DAGNode, max_buf: int = 1 << 20,
                 depth: int = 2):
        self._output = output_node
        self._max_buf = max_buf
        self._depth = depth
        self._nodes: List[ClassMethodNode] = []
        self._input: Optional[InputNode] = None
        self._channels: List[Any] = []
        self._input_channels: List[Any] = []
        self._out_channels: List[Any] = []
        self._final_descs: List[Any] = []
        self._partial: List[Any] = []  # mid-row reads surviving a timeout
        self._is_multi = False
        self._loop_refs = []
        import threading
        import uuid

        self._dag_uid = uuid.uuid4().hex[:12]  # KV keys must not collide
        # concurrent awaiters (execute_async) drain results from threads;
        # the in-order channel reads must be serialized
        self._result_lock = threading.Lock()
        self._seq = 0
        self._drained = -1
        self._results: Dict[int, Any] = {}
        self._torn_down = False
        try:
            self._build()
        except BaseException:
            for ch in self._channels:
                ch.close()
            raise

    # ------------------------------------------------------------ compile
    def _build(self) -> None:
        # topo order (DFS post-order); validate node kinds
        seen: Dict[int, DAGNode] = {}
        order: List[ClassMethodNode] = []

        def visit(node: DAGNode):
            if id(node) in seen:
                return
            seen[id(node)] = node
            if isinstance(node, InputNode):
                if self._input is not None and self._input is not node:
                    raise ValueError("compiled DAGs take exactly one InputNode")
                self._input = node
                return
            if isinstance(node, MultiOutputNode):
                if node is not self._output:
                    raise ValueError("MultiOutputNode may only be the "
                                     "compiled graph's root")
                for up in node.outputs:
                    visit(up)
                return
            if not isinstance(node, ClassMethodNode):
                raise ValueError(
                    "compiled DAGs support actor-method nodes only; "
                    f"got {node!r} (reference restriction: compiled_dag_node)")
            for up in node.upstream():
                visit(up)
            order.append(node)

        visit(self._output)
        if self._input is None:
            raise ValueError("compiled DAG needs an InputNode")
        self._nodes = order
        self._is_multi = isinstance(self._output, MultiOutputNode)
        self._output_members: List[ClassMethodNode] = (
            list(self._output.outputs) if self._is_multi else [self._output])
        actors = set()
        for n in order:
            aid = n._actor_method._handle._actor_id
            if aid in _ACTORS_IN_USE:
                raise ValueError(
                    f"actor {aid.hex()[:8]} already serves a live compiled "
                    "DAG; tear it down first")
            actors.add(aid)
            if not any(isinstance(a, DAGNode) for a in n._bound_args):
                # a loop with zero channel inputs would spin its method
                # forever with nothing to stop it
                raise ValueError(
                    f"compiled node {n.fn_name()!r} has no upstream channel "
                    "input; every node needs at least one DAG-valued arg")
        self._actor_ids = actors

        # Edge placement: shm ring when producer, consumer AND driver share a
        # node; TCP channel (KV-rendezvous'd by edge id) when the edge leaves
        # the driver's host.  Node lookup blocks until each actor is alive —
        # its placement is undefined earlier.
        from ray_tpu_torch._private.worker import require_core

        core = require_core()
        if core.node_id is not None:
            driver_node = core.node_id.binary()
        else:
            # drivers carry no node id; their locality is the nodelet they
            # are attached to
            info = core.io.run(core.nodelet_conn.call("node_info", None))
            driver_node = info["node_id"]
        actor_node: Dict[Any, bytes] = {}
        for n in order:
            aid = n._actor_method._handle._actor_id
            if aid in actor_node:
                continue
            info = core.gcs_call_sync(
                "get_actor_info",
                {"actor_id": aid.binary(), "wait_alive": True, "timeout": 60})
            if info is None or info.get("node_id") is None:
                raise RuntimeError(
                    f"cannot compile: actor {aid.hex()[:8]} has no node "
                    "placement (dead or never scheduled)")
            actor_node[aid] = info["node_id"]

        def node_of(dag_node) -> bytes:
            if isinstance(dag_node, InputNode):
                return driver_node
            return actor_node[dag_node._actor_method._handle._actor_id]

        self._edge_seq = 0
        self._edge_kinds: List[str] = []  # compile summary ("shm"/"tcp")

        def new_edge(src_node: bytes, dst_node: bytes):
            """Returns (descriptor, driver_endpoint_factory)."""
            if src_node == dst_node == driver_node:
                ch = ShmChannel(create=True, slot_size=self._max_buf,
                                depth=self._depth)
                self._channels.append(ch)
                self._edge_kinds.append("shm")
                return ch.name, ch
            self._edge_seq += 1
            cid = f"dag-{self._dag_uid}-{self._edge_seq}"
            self._edge_kinds.append("tcp")
            return ("tcp", cid, self._depth), None

        # node -> list of out-edge descriptors
        out_edges: Dict[int, List[Any]] = {id(n): [] for n in order}
        input_edges: List[Any] = []   # driver-side writer endpoints
        node_cfg: Dict[int, dict] = {}
        for n in order:
            arg_sources = []
            for a in n._bound_args:
                if isinstance(a, InputNode):
                    desc, ch = new_edge(driver_node, node_of(n))
                    if ch is None:
                        ch = TcpChannel(desc[1], role="w", depth=self._depth)
                        self._channels.append(ch)
                    input_edges.append(ch)
                    arg_sources.append(("ch", desc))
                elif isinstance(a, ClassMethodNode):
                    desc, _ = new_edge(node_of(a), node_of(n))
                    out_edges[id(a)].append(desc)
                    arg_sources.append(("ch", desc))
                else:
                    arg_sources.append(("const", a))
            if n._bound_kwargs and any(
                    isinstance(v, DAGNode) for v in n._bound_kwargs.values()):
                raise ValueError("DAG-valued kwargs not supported in "
                                 "compiled DAGs; pass them positionally")
            node_cfg[id(n)] = {
                "method": n._actor_method._name,
                "args": arg_sources,
                "kwargs": dict(n._bound_kwargs),
            }
        # each output member feeds the driver on its own edge
        self._final_descs: List[Any] = []
        self._out_channels: List[Any] = []  # None entries: tcp, opened lazily
        for member in self._output_members:
            final_desc, final_ch = new_edge(node_of(member), driver_node)
            out_edges[id(member)].append(final_desc)
            self._final_descs.append(final_desc)
            self._out_channels.append(final_ch)
        self._input_channels = input_edges

        # ONE loop per actor serving all of that actor's nodes in global
        # topological order (multiple bound methods on one actor are legal;
        # channel depth buffers same-actor node-to-node edges)
        from ray_tpu_torch.actor import ActorMethod

        per_actor: Dict[Any, dict] = {}
        for n in order:
            cfg = node_cfg[id(n)]
            cfg["out"] = list(out_edges[id(n)])
            aid = n._actor_method._handle._actor_id
            entry = per_actor.setdefault(
                aid, {"handle": n._actor_method._handle, "nodes": []})
            entry["nodes"].append(cfg)
        for entry in per_actor.values():
            # reserved method: handled by the worker runtime, so it is not
            # in the user class's method table
            loop_method = ActorMethod(entry["handle"], CHANNEL_LOOP_METHOD)
            self._loop_refs.append(
                loop_method.remote({"nodes": entry["nodes"]}))
        _ACTORS_IN_USE.update(self._actor_ids)

    # ------------------------------------------------------------ execute
    def execute(self, value: Any = None,
                timeout: Optional[float] = None) -> CompiledDAGRef:
        if self._torn_down:
            raise RuntimeError("compiled DAG was torn down")
        # Serialize ONCE through the SerializationContext (pickle-5
        # out-of-band buffers), then scatter-gather the same frame into
        # every input edge — a numpy input reaches each ring slot with one
        # memcpy and no pickle flatten.
        from ray_tpu_torch._private.serialization import get_serialization_context

        ser = get_serialization_context().serialize(value)
        # Connect the (possibly TCP) output edges NOW: a driver that executes
        # and then delays its first get() past the producer's accept timeout
        # would otherwise kill the edge while the result waits to be written.
        self._ensure_out_channels()
        # Wait for room on EVERY input channel before writing any: a partial
        # write followed by a timeout would desynchronize multi-input DAGs
        # for all later executes.
        for ch in self._input_channels:
            ch.wait_writable(timeout)
        for ch in self._input_channels:
            ch.write_serialized(ser, timeout=None)
        ref = CompiledDAGRef(self, self._seq)
        self._seq += 1
        return ref

    async def execute_async(self, value: Any = None,
                            timeout: Optional[float] = None
                            ) -> "CompiledDAGRef":
        """Asyncio-native execute (reference: CompiledDAG.execute_async):
        input-channel backpressure waits on a worker thread, and the
        returned ref is awaitable (``result = await ref``)."""
        import asyncio
        import functools as _ft

        loop = asyncio.get_event_loop()
        return await loop.run_in_executor(
            None, _ft.partial(self.execute, value, timeout))

    def _ensure_out_channels(self):
        """Each final edge's driver endpoint: eager for shm; a tcp edge is
        constructed here on first use AND dialed immediately on a background
        thread.  The dial must not wait for the first get(): the producer's
        first write blocks in accept() with a bounded timeout, so a driver
        that executes and then delays its first result fetch past that
        timeout would otherwise kill the edge from the producer's side.
        (Background thread because the producer registers the rendezvous
        only when its loop starts — execute() must not block on that.)"""
        import threading

        for i, ch in enumerate(self._out_channels):
            if ch is None:
                ch = TcpChannel(self._final_descs[i][1], role="r",
                                depth=self._depth)
                self._channels.append(ch)
                self._out_channels[i] = ch
                threading.Thread(target=ch.dial, daemon=True,
                                 name="dag-out-dial").start()
        return self._out_channels

    def _result_for(self, seq: int, timeout: Optional[float]) -> Any:
        """Results arrive in execute order (the graph is static): read
        forward, buffering values for refs fetched out of order.  A
        MultiOutputNode graph yields a list, one element per member."""
        outs = self._ensure_out_channels()
        with self._result_lock:
            return self._result_for_locked(seq, timeout, outs)

    def _result_for_locked(self, seq, timeout, outs):
        if seq <= self._drained and seq not in self._results:
            raise RuntimeError(
                f"result for execute #{seq} was already consumed")
        while seq not in self._results:
            # A timeout partway through a multi-member row must not
            # desynchronize members: partially-read values persist in
            # self._partial so the retry resumes at the channel that
            # timed out (the single-channel read was atomic; this keeps
            # the multi-channel row atomic too).
            while len(self._partial) < len(outs):
                self._partial.append(outs[len(self._partial)].read(timeout))
            row, self._partial = self._partial, []
            self._drained += 1
            self._results[self._drained] = row if self._is_multi else row[0]
        return self._results.pop(seq)

    # ------------------------------------------------------------ teardown
    def teardown(self) -> None:
        if self._torn_down:
            return
        self._torn_down = True
        import ray_tpu_torch

        for ch in self._input_channels:
            ch.close_write()
        try:
            ray_tpu_torch.get(self._loop_refs, timeout=30)
        except Exception:
            pass
        for ch in self._channels:
            ch.close()
        _ACTORS_IN_USE.difference_update(getattr(self, "_actor_ids", ()))

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass
