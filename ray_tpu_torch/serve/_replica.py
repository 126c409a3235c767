"""Port of ``ray_tpu/serve/_replica.py``.

Replica actor: hosts one instance of a deployment's user class.

Reference: python/ray/serve/_private/replica.py — the replica wraps the user
callable, enforces max_ongoing_requests, exposes health checks and stats.
TPU note: a replica is the natural unit that owns a chip (or a mesh slice);
the user class jit-compiles once in __init__ and every request hits the
compiled function, so the request path stays out of Python-compile land.
"""

from __future__ import annotations

import asyncio
import inspect
import time
from typing import Any, Dict, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
class ServeReplica:
    def __init__(self, serialized_cls: bytes, init_args, init_kwargs,
                 max_ongoing_requests: int, app_name: str = "",
                 deployment_name: str = ""):
        import cloudpickle

        cls = cloudpickle.loads(serialized_cls)
        self._user = cls(*init_args, **(init_kwargs or {}))
        self._max_ongoing = max_ongoing_requests
        self._app = app_name
        self._deployment = deployment_name
        self._ongoing = 0
        self._total = 0
        self._started_at = time.time()
        # library metrics: per-deployment request counter/latency/queue
        # depth, pushed to the nodelet by this worker's CoreWorker loop
        from ray_tpu_torch.serve._metrics import serve_metrics

        self._metrics = serve_metrics()
        self._metric_labels = {"app": app_name, "deployment": deployment_name}
        # multiplex: loader caches report loaded-model sets through this
        # hook; fire-and-forget to the controller, fanned to routers via
        # long-poll (reference: replica multiplexed_model_ids reporting)
        from ray_tpu_torch.serve import multiplex as _mux

        self._mux = _mux
        self._mux_seq = 0
        self._mux_seq_lock = __import__("threading").Lock()
        _mux._set_report_hook(self._report_models)
        # in-flight response streams (generator-returning callables):
        # stream_id -> _StreamState, IO-loop confined
        self._streams: Dict[str, Any] = {}

    def _report_models(self, model_ids):
        # Runs on the replica's IO loop (model-cache finally): the controller
        # LOOKUP is a blocking runtime call and would wedge the loop (pings
        # stop dispatching, health checks kill the replica) — do the whole
        # report on a thread.  Each report carries a sequence number: the
        # threads' fire-and-forget sends can arrive out of order, and a
        # stale earlier snapshot must not overwrite a newer one.
        import threading

        with self._mux_seq_lock:
            self._mux_seq += 1
            seq = self._mux_seq

        def do():
            try:
                from ray_tpu_torch.serve._controller import get_controller

                rid = ray_tpu_torch.get_runtime_context().get_actor_id()
                get_controller().record_multiplexed_models.remote(
                    self._app, self._deployment, rid, model_ids, seq)
            except Exception:
                pass

        threading.Thread(target=do, daemon=True,
                         name="serve-mux-report").start()

    async def handle_request(self, method: str, args, kwargs,
                             multiplexed_model_id: str = "") -> Any:
        """Run one request through the user callable.  The handle-level router
        already respects max_ongoing_requests; the replica enforces it again
        as a backstop (reference: replica backpressure).

        Sync user code runs on an executor thread: this method itself runs on
        the worker's IO loop, and user code may make blocking runtime calls
        (composition: handle.remote().result()) that must not block the loop.
        Async user code (incl. @serve.batch wrappers) stays on the loop."""
        while self._ongoing >= self._max_ongoing:
            await asyncio.sleep(0.005)
        self._ongoing += 1
        self._total += 1
        m, labels = self._metrics, self._metric_labels
        m["queue_depth"].set(self._ongoing, labels)
        start = time.perf_counter()
        failed = False
        token = self._mux._model_id_ctx.set(multiplexed_model_id)
        try:
            call = getattr(self._user, method, None)
            if call is None:
                raise AttributeError(f"deployment has no method {method!r}")
            kwargs = kwargs or {}
            args, kwargs = await self._resolve_refs(args, kwargs)
            if inspect.iscoroutinefunction(call):
                out = call(*args, **kwargs)
            else:
                loop = asyncio.get_event_loop()
                ctx = __import__("contextvars").copy_context()
                out = await loop.run_in_executor(
                    None, lambda: ctx.run(call, *args, **kwargs))
            if inspect.isawaitable(out):
                out = await out
            if inspect.isgenerator(out) or inspect.isasyncgen(out):
                # streaming result: park the generator here, hand the
                # caller a pull handle (see serve/_streaming.py)
                out = self._start_stream(out)
                m["streams"].inc(1, labels)
            return out
        except BaseException:
            failed = True
            raise
        finally:
            self._mux._model_id_ctx.reset(token)
            self._ongoing -= 1
            m["queue_depth"].set(self._ongoing, labels)
            m["requests"].inc(1, labels)
            if failed:
                m["request_errors"].inc(1, labels)
            m["latency"].observe(time.perf_counter() - start, labels)

    async def _resolve_refs(self, args, kwargs):
        """Resolve top-level ObjectRefs (chained DeploymentResponses) to
        values, mirroring actor-call argument semantics (reference: handles
        pass the upstream ref; the downstream replica awaits it)."""
        from ray_tpu_torch._private.object_ref import ObjectRef
        from ray_tpu_torch._private.worker import get_async

        args = list(args)
        for i, a in enumerate(args):
            if isinstance(a, ObjectRef):
                args[i] = await get_async(a)
        kwargs = dict(kwargs)
        for k, v in list(kwargs.items()):
            if isinstance(v, ObjectRef):
                kwargs[k] = await get_async(v)
        return tuple(args), kwargs

    # ------------------------------------------------------- streaming
    def _start_stream(self, gen):
        """Register a generator result as a pullable stream; returns the
        StreamHeader the caller unwraps into a ResponseStream."""
        import uuid

        from ray_tpu_torch.serve._streaming import (
            STREAM_TTL_S,
            StreamHeader,
            _StreamState,
        )

        # lazy sweep: done-but-never-drained streams must not accumulate
        now = time.monotonic()
        for sid, st in list(self._streams.items()):
            if st.done and now - st.created > STREAM_TTL_S:
                del self._streams[sid]

        sid = uuid.uuid4().hex[:16]
        st = _StreamState()
        st.producer_ev = asyncio.Event()
        self._streams[sid] = st
        st.producer = asyncio.get_event_loop().create_task(
            self._pump_stream(sid, st, gen))
        return StreamHeader(sid)

    async def _pump_stream(self, sid, st, gen):
        """Drain the generator into the stream buffer.  Sync generators are
        pulled item-by-item on executor threads (their body may block on
        runtime calls); async generators run on the loop."""
        from ray_tpu_torch.serve._streaming import MAX_BUFFERED_ITEMS

        import inspect as _inspect

        _SENTINEL = object()
        loop = asyncio.get_event_loop()
        try:
            if _inspect.isasyncgen(gen):
                async for item in gen:
                    await self._stream_put(st, item, MAX_BUFFERED_ITEMS)
            else:
                while True:
                    item = await loop.run_in_executor(
                        None, next, gen, _SENTINEL)
                    if item is _SENTINEL:
                        break
                    await self._stream_put(st, item, MAX_BUFFERED_ITEMS)
        except asyncio.CancelledError:
            st.error = "stream cancelled"
            raise
        except BaseException as e:
            st.error = f"{type(e).__name__}: {e}"
        finally:
            st.done = True
            st.wake()
            # cancelled/abandoned streams: the entry survives until drained
            # or swept; st.created reset so TTL counts from completion
            st.created = time.monotonic()

    async def _stream_put(self, st, item, cap):
        while len(st.items) - st.consumed >= cap:
            # backpressure: wait for a consumer to advance
            st.producer_ev.clear()
            await st.producer_ev.wait()
        st.items.append(item)
        st.wake()

    async def stream_next(self, stream_id: str, cursor: int,
                          timeout_s: float = 30.0) -> Dict[str, Any]:
        """Long-poll: items past ``cursor`` (or done/error state).  Fully
        drained done streams are dropped from the table."""
        st = self._streams.get(stream_id)
        if st is None:
            raise KeyError(f"unknown or expired stream {stream_id!r}")
        deadline = time.monotonic() + timeout_s
        while len(st.items) <= cursor and not st.done:
            ev = asyncio.Event()
            st.waiters.append(ev)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return {"items": [], "done": False, "error": None}
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                return {"items": [], "done": False, "error": None}
        items = st.items[cursor:]
        new_cursor = cursor + len(items)
        if new_cursor > st.consumed:
            st.consumed = new_cursor
            if st.producer_ev is not None:
                st.producer_ev.set()
        done = st.done and new_cursor >= len(st.items)
        if done:
            self._streams.pop(stream_id, None)
        return {"items": items, "done": done, "error": st.error}

    async def stream_cancel(self, stream_id: str) -> bool:
        st = self._streams.pop(stream_id, None)
        if st is None:
            return False
        if st.producer is not None and not st.producer.done():
            st.producer.cancel()
        st.done = True
        st.wake()
        return True

    def stats(self) -> Dict[str, Any]:
        ongoing = self._ongoing
        # deployments that queue work behind the request path (e.g. an LLM
        # engine's admission queue) surface it through this protocol hook so
        # the controller's queue-depth autoscaler sees the real backlog
        extra = getattr(self._user, "__serve_queue_len__", None)
        if extra is not None:
            try:
                ongoing += int(extra())
            except Exception:
                pass
        return {"ongoing": ongoing, "total": self._total,
                "streams": len(self._streams),
                "uptime_s": time.time() - self._started_at}

    def ping(self) -> bool:
        check = getattr(self._user, "check_health", None)
        if check is not None:
            check()
        return True

    async def drain(self, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while self._ongoing > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        return self._ongoing == 0
