"""Port of ``ray_tpu/_private/core_worker.py``.

CoreWorker: embedded runtime in every driver and worker process.

Counterpart of the reference's CoreWorker (reference: src/ray/core_worker/
core_worker.h:295, core_worker.cc) plus the pieces it owns:

- task submission with lease-based scheduling + spillback
  (NormalTaskSubmitter, transport/normal_task_submitter.h:75)
- local dependency resolution + small-arg inlining
  (LocalDependencyResolver, transport/dependency_resolver.h:29)
- actor task submission with per-handle ordering over one TCP stream
  (ActorTaskSubmitter, transport/actor_task_submitter.h:73 — sequence numbers are
  implicit here: one connection per actor, FIFO stream, in-order dispatch)
- task execution loop + scheduling queues (TaskReceiver, transport/task_receiver.h:51)
- in-process memory store + plasma provider (store_provider/)
- ownership & distributed GC (ReferenceCounter, reference_count.h:61)
- lineage for retries (TaskManager, task_manager.h:208 — retries implemented,
  lineage reconstruction arriving with object recovery)

Threading model: one IO loop thread per process (all RPC), a small executor pool
for running user task code (worker mode), and the user thread (driver mode) that
blocks on memory-store events — mirroring the reference's io_service + task
execution thread split.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import pickle
import random
import sys
import threading
import time
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch._private import fault_injection, flight_recorder, incidents, rpc
from ray_tpu_torch._private.config import RayConfig, temp_root
from ray_tpu_torch._private.ids import (ACTOR_ID_UNIQUE_BYTES, ActorID, JobID,
                                  NodeID, ObjectID, TaskID, WorkerID,
                                  _fast_unique)
from ray_tpu_torch._private.memory_store import IN_PLASMA, MemoryStore
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.object_store import PlasmaClient
from ray_tpu_torch._private.reference_count import ReferenceCounter
from ray_tpu_torch._private.serialization import (
    SerializedObject,
    freeze_buffers,
    get_serialization_context,
)
from ray_tpu_torch._private.task_spec import (
    InlineArg,
    RefArg,
    SchedulingStrategy,
    TaskSpec,
    TaskType,
)
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    ObjectReconstructionFailedError,
    OwnerDiedError,
    RayActorError,
    RaySystemError,
    RayTaskError,
    RuntimeEnvSetupError,
    TaskCancelledError,
    WorkerCrashedError,
)

logger = logging.getLogger(__name__)

_FUNCTION_TABLE_THRESHOLD = 512 * 1024


def _dumps_ctrl(obj) -> bytes:
    """Control-plane pickle: error records, task specs, spec batches.
    These are small, traverse RPC as opaque bytes, and flattening them IS
    the wire format — the no-flatten rule guards payload buffers, not
    these.  Protocol 5 so PickleBuffer inline args inside specs serialize
    (in-band here; the rpc encoder takes large ones out-of-band)."""
    return pickle.dumps(obj, protocol=5)  # lint: disable=no-flatten


class _TaskContext(threading.local):
    def __init__(self):
        self.task_id: Optional[TaskID] = None
        self.actor_id: Optional[ActorID] = None
        self.job_id: Optional[JobID] = None
        self.attempt_number: int = 0
        self.task_name: str = ""


# Tracing context: a ContextVar, NOT thread-local — async actor methods all
# share the IO-loop thread, and each asyncio task carries its own context
# copy, so spans stay correct across interleaved coroutines.
import contextvars  # noqa: E402

_trace_ctx: "contextvars.ContextVar" = contextvars.ContextVar(
    "ray_tpu_trace", default=(None, None))


class CoreWorker:
    def __init__(
        self,
        mode: str,  # "driver" | "worker"
        gcs_addr: Tuple[str, int],
        nodelet_addr: Tuple[str, int],
        worker_id: Optional[WorkerID] = None,
        session_dir: str = temp_root(),
        node_id: Optional[NodeID] = None,
        namespace: str = "",
        remote_plasma: bool = False,
    ):
        self.mode = mode
        self.worker_id = worker_id or WorkerID.from_random()
        self.node_id = node_id
        # Hot-path constants for emit_task_event (one per task lifecycle hop).
        self._worker_id_hex = self.worker_id.hex()
        self._node_id_hex = node_id.hex() if node_id else None
        self._pid = os.getpid()
        self._race_guard = None  # set when the race detector wraps an actor
        # task cancellation (executor side): ids cancelled before start +
        # the thread currently running each normal task.  The set gives O(1)
        # membership on the execution hot path; the deque remembers insertion
        # order so the bound evicts the OLDEST marker, not an arbitrary one
        # (a set.pop() bound could forget a still-pending cancel under a
        # cancellation flood and let the task run).
        self._cancelled_exec: set = set()
        self._cancelled_exec_order: deque = deque()
        self._running_threads: Dict[bytes, int] = {}
        self._running_async: Dict[bytes, "asyncio.Task"] = {}
        # Live-introspection state (`ray_tpu_torch stack` / hang watchdog): every
        # currently-executing task keyed by task id -> {name, attempt,
        # start (monotonic), thread (ident, None for async)}, plus a small
        # per-name reservoir of recent exec durations so the nodelet's
        # watchdog can compare a running task against its own history.
        self._running_tasks: Dict[bytes, dict] = {}
        self._exec_hist: Dict[str, deque] = {}
        self._exec_hist_lock = threading.Lock()
        # driver side: tasks the user cancelled (suppresses retry-on-death
        # when force-cancel kills the worker mid-task)
        self._cancelled_tasks: set = set()
        # workers the nodelet warned us it is pressure-killing: their
        # 'lost' completions retry for free (worker_id -> warn time)
        self._pressure_killed: dict = {}
        # GC-safe release pipeline: ObjectRef.__del__ only appends here
        # (deque ops are reentrancy-safe); the IO loop drains
        self._release_queue: deque = deque()
        self._release_scheduled = False
        self.session_dir = session_dir
        # Crash-surviving black box: hot paths append into an mmap'd ring
        # in the session dir; the nodelet harvests it if this process dies.
        flight_recorder.init_process(session_dir, self._worker_id_hex)
        self.namespace = namespace
        self.job_id = JobID.from_int(0)
        self.ctx = get_serialization_context()
        self.task_ctx = _TaskContext()

        self.io = rpc.EventLoopThread(name=f"rtpu-io-{mode}")
        self.shutdown_event = threading.Event()
        self.memory_store = MemoryStore()
        self.ref_counter = ReferenceCounter(
            self.worker_id.binary(), self._on_out_of_scope, self._notify_owner
        )

        # RPC server: owner services + task execution endpoint.
        handlers = {}
        for name in dir(self):
            if name.startswith("rpc_"):
                handlers[name[4:]] = getattr(self, name)
        self.server = rpc.Server(handlers, name=f"worker-{self.worker_id.hex()[:6]}")
        self._rpc_handlers = handlers
        self.addr: Tuple[str, int] = self.io.run(self.server.start("127.0.0.1", 0))
        # Completion routing for batched task submission: task_id -> callback
        # invoked with the result item when the executor's tasks_done notify
        # arrives.  IO-loop-thread only.
        self._completion_router: Dict[bytes, Any] = {}
        # Executor side: per-connection buffer of finished-task results, so
        # completions landing in the same loop tick coalesce into one frame.
        self._done_buf: Dict[Any, list] = {}
        # Normal-task inflight registry per worker connection: lets a closed
        # connection fail/retry exactly the tasks that were riding it.
        self._conn_tasks: Dict[Any, set] = {}

        # Connections.
        self.nodelet_conn: rpc.Connection = self.io.run(
            rpc.connect(*nodelet_addr, handlers=handlers, name="worker->nodelet")
        )
        if mode == "worker":
            # The nodelet owns this process's lifetime: if the connection
            # drops (nodelet died / was SIGTERMed), exit instead of orphaning
            # — an orphan holding the TPU chip wedges every later run.
            self.nodelet_conn._on_close = lambda _c: self.shutdown_event.set()
            if self.nodelet_conn.closed:
                # Dropped in the window before the callback was attached (an
                # already-closed connection never re-fires it).
                self.shutdown_event.set()
        self._gcs_addr = gcs_addr
        self._gcs_handlers = {"publish": self._on_publish, **handlers}
        self.gcs_conn: rpc.Connection = self.io.run(
            rpc.connect(*gcs_addr, handlers=self._gcs_handlers,
                        name="worker->gcs")
        )
        self.gcs_conn._on_close = self._on_gcs_lost
        if remote_plasma:
            # client mode (ray:// — reference: Ray Client): the driver may be
            # on another machine; objects move over RPC, not shared memory
            from ray_tpu_torch._private.object_store import RemotePlasmaClient

            self.plasma = RemotePlasmaClient(self.io, self.nodelet_conn)
        else:
            self.plasma = PlasmaClient(self.io, self.nodelet_conn)
        self.io.run(self.gcs_conn.call("client_hello",
                                       {"worker_id": self.worker_id.binary()}))

        self._put_task_id = TaskID.for_task(JobID.from_int(0))
        self._put_index = 0
        self._put_lock = threading.Lock()

        # RLock, not Lock: ActorHandle.__del__ (via remove_actor_handle)
        # acquires this, and a GC cycle can run that finalizer on a thread
        # ALREADY inside a _refs_lock section (observed: complete_task's
        # discard triggered gc -> __del__ -> self-deadlock wedging the IO
        # loop).  Reentrancy makes the finalizer path safe wherever gc runs.
        self._refs_lock = threading.RLock()
        self._contained: Dict[ObjectID, List[ObjectRef]] = {}
        self._owned_in_plasma: set = set()
        self._actor_handle_counts: Dict[ActorID, int] = {}
        # Lineage: creating TaskSpec per owned plasma return, so a lost
        # object can be rebuilt by re-running its task (reference:
        # ObjectRecoveryManager object_recovery_manager.h:41, TaskManager
        # lineage task_manager.h:208).  Bounded; dropped when the ref dies.
        self._lineage: Dict[ObjectID, TaskSpec] = {}
        self._recovery_attempts: Dict[ObjectID, int] = {}
        self._recovery_inflight: set = set()

        # oid -> mark callbacks of wait() calls sharing one inflight
        # plasma_wait seal long-poll (see _arm_plasma_wait)
        self._plasma_waits: Dict[ObjectID, List] = {}
        self._plasma_waits_lock = threading.Lock()

        self._owner_conns: Dict[Tuple[str, int], rpc.Connection] = {}
        self._worker_conns: Dict[Tuple[str, int], rpc.Connection] = {}
        self._nodelet_conns: Dict[Tuple[str, int], rpc.Connection] = {self_addr_key(nodelet_addr): self.nodelet_conn}
        self._subscriptions: Dict[str, List] = {}

        self.submitter = NormalTaskSubmitter(self)
        if mode != "worker":
            # drivers: a dying LOCAL nodelet must invalidate cached leases
            # too (workers instead treat it as their own death, above)
            self.nodelet_conn._on_close = self.submitter._on_nodelet_conn_lost
        self.actor_submitters: Dict[ActorID, ActorTaskSubmitter] = {}

        self._fn_cache: Dict[Any, Any] = {}
        self._pushed_fns: set = set()
        self._fn_payload_cache: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()

        self._get_pool = ThreadPoolExecutor(max_workers=4, thread_name_prefix="rtpu-get")

        # Executor state (worker mode).
        self.executor_pool: Optional[ThreadPoolExecutor] = None
        self.actor_instance: Any = None
        self.actor_id: Optional[ActorID] = None
        self._actor_sem: Optional[asyncio.Semaphore] = None
        self._task_sem: Optional[asyncio.Semaphore] = None
        self._exec_queue: Optional[asyncio.Queue] = None
        self._dispatch_task = None
        if mode == "worker":
            # Concurrency matches the submitter's per-lease pipeline depth:
            # every pipelined task gets a thread IMMEDIATELY, so a task that
            # blocks on a nested ray.get can't head-of-line-block the tasks
            # queued behind it (they run concurrently; resource oversubscribe
            # is bounded by the depth, mirroring the reference's
            # blocked-worker CPU release).
            depth = max(RayConfig.lease_pipeline_depth, 1)
            # Fewer threads than pipelined tasks: chunked execution packs a
            # whole burst onto one thread, so the pool only needs enough
            # threads to ride out tasks that block on nested gets.
            threads = min(depth, max(RayConfig.worker_exec_threads, 1))
            self.executor_pool = ThreadPoolExecutor(
                max_workers=threads, thread_name_prefix="rtpu-exec")
            self._task_permits = threads
            self._task_sem = asyncio.Semaphore(threads)
            self._exec_queue = asyncio.Queue()
            self._dispatch_task = self.io.spawn(self._execute_loop())

        # Task-event buffer: lifecycle events accumulate here and flush to
        # the GCS sink periodically (reference: TaskEventBuffer
        # core_worker/task_event_buffer.h:206 → GcsTaskManager).  Oldest
        # events drop when the buffer overflows, never blocking the task path.
        self._task_events: deque = deque(
            maxlen=RayConfig.task_events_max_buffer_size)
        self._flush_scheduled = False
        self._last_event_flush = 0.0
        self._shut = False  # must exist before the flush loop's first check
        if RayConfig.task_events_enabled:
            self.io.spawn(self._flush_task_events_loop())
        # Synthetic return-pins awaiting caller registration (see
        # _pin_returned_ref); swept by TTL so a caller that died before
        # complete_task doesn't leak the pinned object forever.
        self._return_pins: deque = deque()
        self.io.spawn(self._sweep_return_pins_loop())
        # Per-phase latency histogram for the task hot path (lazy init off
        # the hot path would race; one Histogram up front is cheap).
        from ray_tpu_torch._private.metrics import (PHASE_SECONDS_BOUNDARIES,
                                              Counter, Histogram)

        self._phase_hist = Histogram(
            "task_phase_seconds",
            "task hot-path time per phase (driver submit -> result wake)",
            boundaries=PHASE_SECONDS_BOUNDARIES)
        # Defensive copies taken on the data plane (writable buffer inlined
        # into a spec/return while the owner could still mutate it) — the
        # zero-copy path's residual; should stay near zero for readonly
        # payloads.
        self._m_put_copies = Counter(
            "put_copies_total",
            "defensive buffer copies taken on the put/inline data plane")
        # Both modes push: the DRIVER owns the submit/stage/wake phases, so
        # without a driver push the phase breakdown never reaches the
        # nodelet's Prometheus scrape.
        self.io.spawn(self._push_metrics_loop())
        # Continuous profiler (no-op unless profile_hz > 0): samples every
        # thread in this process, tagging threads executing a task with the
        # task's name via the running-task registry — pull-based, so the
        # task hot path carries no profiling instrumentation at all.
        from ray_tpu_torch._private import profiler

        profiler.ensure_started(self._profile_tags)

    def _profile_tags(self, thread_ident: int) -> Optional[str]:
        """Task name currently executing on ``thread_ident``, if any (the
        profiler's sample-time tag source)."""
        for rec in list(self._running_tasks.values()):
            if rec.get("thread") == thread_ident:
                return rec.get("name")
        return None

    def _mark_cancelled_exec(self, tkey: bytes) -> None:
        """Record a cancelled-before-start marker, bounded to 4096 entries
        with oldest-first eviction (a cancel that raced its completion would
        otherwise leave its 24-byte key behind forever; evicting an ARBITRARY
        entry instead could forget a still-pending cancel under a flood)."""
        if tkey in self._cancelled_exec:
            return
        self._cancelled_exec.add(tkey)
        self._cancelled_exec_order.append(tkey)
        while len(self._cancelled_exec) > 4096 and self._cancelled_exec_order:
            # order entries whose marker was already consumed (discarded at
            # task start/finish) no longer count against the bound
            self._cancelled_exec.discard(self._cancelled_exec_order.popleft())
        if len(self._cancelled_exec_order) > 4 * 4096:
            # consumed markers leave stale keys behind in the order deque;
            # compact occasionally so it tracks the live set, not history
            self._cancelled_exec_order = deque(
                k for k in self._cancelled_exec_order
                if k in self._cancelled_exec)

    # ------------------------------------------------------- task events
    def emit_task_event(self, spec: TaskSpec, state: str,
                        error: Optional[str] = None,
                        ts: Optional[float] = None) -> None:
        """Record one lifecycle transition; cheap append, flushed async."""
        if not RayConfig.task_events_enabled:
            return
        aid = spec.actor_id or spec.actor_creation_id
        ev = {
            "trace_id": spec.trace_id,
            "span_id": spec.span_id,
            "parent_span_id": spec.parent_span_id,
            "task_id": spec.task_id.hex(),
            "attempt": spec.attempt_number,
            "name": spec.name,
            "state": state,
            "ts": ts if ts is not None else time.time(),
            "job_id": spec.job_id.hex(),
            "type": spec.task_type.name,
            "actor_id": aid.hex() if aid else None,
            "node_id": self._node_id_hex,
            "worker_id": self._worker_id_hex,
            "pid": self._pid,
        }
        if error:
            ev["error"] = error[:500]
        self.emit_raw_event(ev, terminal=state in ("FINISHED", "FAILED"))

    def emit_raw_event(self, ev: dict, *, terminal: bool = False) -> None:
        """Append one pre-built event (task lifecycle or user span) to the
        buffer; terminal events flush eagerly — a worker reused for the next
        task may be killed by it before the periodic tick, losing this
        task's whole lifecycle from the state API.  One pending flush is
        enough: under a burst of completions the first drain takes
        everything queued behind it."""
        if not RayConfig.task_events_enabled:
            return
        self._task_events.append(ev)
        if terminal and not self._flush_scheduled:
            self._flush_scheduled = True
            # Throttle, don't debounce: an isolated terminal event flushes
            # NOW (a read right after a task completes must see it); during
            # a completion storm later flushes wait out the interval, so a
            # sync-call loop batches ~dozens of events per GCS frame
            # instead of one frame + one GCS wakeup per task.
            delay = max(
                0.0, self._last_event_flush + 0.02 - time.monotonic())
            coro = self._flush_task_events_once(delay)
            try:
                self.io.spawn(coro)
            except RuntimeError:  # loop closed: shutdown path
                coro.close()
                self._flush_scheduled = False

    def _observe_phases(self, spec: TaskSpec, item: dict) -> None:
        """Fold the driver's and executor's phase stamps into per-phase
        durations: observe each into the task_phase_seconds histogram and
        ride one PHASES annotation down the task-event pipeline so the state
        API / CLI profile can compute per-task percentiles.  Runs on the IO
        loop when a completion lands; a few time.time()/dict ops per task —
        cheap next to the two events the lifecycle already emits."""
        wp = item.get("phases")
        pt = spec.phase_ts
        if wp is None or pt is None:
            return
        recv = time.time()
        exec_start, exec_end, put_s = wp
        submit = pt.get("submit", exec_start)
        ser = pt.get("ser", 0.0)
        ship = pt.get("ship", submit + ser)
        # contiguous by construction: the six durations sum to recv - submit
        # (modulo clamping of cross-process clock skew), so a profile's
        # per-phase breakdown accounts for the whole observed round-trip
        durs = {
            "driver_serialize": ser,
            "driver_stage": max(ship - submit - ser, 0.0),
            "dispatch": max(exec_start - ship, 0.0),
            "exec": max(exec_end - exec_start - put_s, 0.0),
            "result_put": max(put_s, 0.0),
            "result_wake": max(recv - exec_end, 0.0),
        }
        observe = self._phase_hist.observe
        for phase, dur in durs.items():
            observe(dur, {"phase": phase})
        if not RayConfig.task_events_enabled:
            return
        self.emit_raw_event({
            "task_id": spec.task_id.hex(),
            "attempt": spec.attempt_number,
            "name": spec.name,
            "state": "PHASES",
            "ts": recv,
            "job_id": spec.job_id.hex(),
            "type": spec.task_type.name,
            "trace_id": spec.trace_id,
            "span_id": spec.span_id,
            "parent_span_id": spec.parent_span_id,
            "phases": durs,
        })

    async def _push_metrics_loop(self):
        """Push this worker's metrics (built-in + user-defined via
        ray_tpu_torch.util.metrics) to the nodelet's scrape endpoint (reference:
        core worker -> per-node metrics agent)."""
        from ray_tpu_torch._private import profiler
        from ray_tpu_torch._private.metrics import default_registry

        interval = RayConfig.metrics_report_interval_ms / 1000.0
        source = f"{self.mode}-{self.worker_id.hex()[:12]}"
        while not self._shut:
            await asyncio.sleep(interval)
            try:
                msg = {
                    "source": source,
                    "snapshot": default_registry.snapshot()}
                # one attribute read when profiling is off — the profiler's
                # entire disabled-state cost on this path
                if profiler.SAMPLING:
                    delta = profiler.take_delta()
                    if delta:
                        msg["profile"] = delta
                self.nodelet_conn.notify_coalesced("metrics_push", msg)
            except (ConnectionError, rpc.ConnectionLost):
                pass

    async def _sweep_return_pins_loop(self):
        """Expire synthetic return-pins whose caller never claimed them (the
        caller died between our reply and its complete_task).  TTL is generous:
        live callers release pins within one RPC round-trip."""
        ttl = 120.0
        while not self._shut:
            await asyncio.sleep(ttl / 4)
            now = time.monotonic()
            while self._return_pins and now - self._return_pins[0][0] > ttl:
                _, cref, token = self._return_pins.popleft()
                self._release_return_pin(cref, token, claim=False)

    async def _flush_task_events_loop(self):
        interval = RayConfig.task_events_flush_interval_ms / 1000.0
        while not self._shut:
            await asyncio.sleep(interval)
            await self._flush_task_events()

    async def _flush_task_events_once(self, delay: float = 0.0):
        if delay > 0:
            await asyncio.sleep(delay)
        self._flush_scheduled = False
        self._last_event_flush = time.monotonic()
        await self._flush_task_events()

    async def _flush_task_events(self):
        if not self._task_events:
            return
        # drain via popleft: a snapshot-then-clear would drop events appended
        # from other threads between the two calls
        events = []
        while True:
            try:
                events.append(self._task_events.popleft())
            except IndexError:
                break
        try:
            await self.gcs_conn.notify("add_task_events", {"events": events})
        except (ConnectionError, rpc.ConnectionLost):
            pass  # observability must never take down the task path

    # ====================================================== setup / teardown
    def register_with_nodelet(self):
        # bounded: a wedged nodelet must fail the worker's startup loudly,
        # not park it in an unkillable unregistered state
        return self.io.run(
            self.nodelet_conn.call(
                "register_worker",
                {"worker_id": self.worker_id.binary(), "addr": list(self.addr),
                 "pid": os.getpid()},
                timeout=RayConfig.worker_register_timeout_s,
            )
        )

    def register_driver(self, entrypoint: str = ""):
        resp = self.io.run(
            self.gcs_conn.call("register_job", {"driver_addr": list(self.addr),
                                                "entrypoint": entrypoint})
        )
        self.job_id = JobID(resp["job_id"])
        self._put_task_id = TaskID.for_task(self.job_id)
        return self.job_id

    def shutdown(self):
        if self._shut:
            return
        self._shut = True
        try:  # last task events would otherwise be lost with the process
            self.io.run(self._flush_task_events(), timeout=2)
        except Exception:
            pass
        try:
            # flush coalesced plasma releases + return leased extents so the
            # store's accounting is exact even before conn-loss cleanup runs
            self.plasma.close()
        except Exception:
            pass
        try:
            self.io.run(self.server.stop(), timeout=5)
        except Exception:
            pass
        for conn in [self.nodelet_conn, self.gcs_conn, *self._owner_conns.values(),
                     *self._worker_conns.values()]:
            try:
                self.io.run(conn.close(), timeout=2)
            except Exception:
                pass
        if self.executor_pool:
            self.executor_pool.shutdown(wait=False)
        self._get_pool.shutdown(wait=False)
        self.io.stop()

    # ============================================================== pub/sub
    async def _on_publish(self, conn, msg):
        for cb in self._subscriptions.get(msg["channel"], []):
            try:
                res = cb(msg["data"])
                if asyncio.iscoroutine(res):
                    await res
            except Exception:
                logger.exception("subscription callback failed for %s", msg["channel"])

    def subscribe(self, channel: str, cb) -> None:
        self._subscriptions.setdefault(channel, []).append(cb)
        self.io.run(self.gcs_conn.call("subscribe", {"channel": channel}))

    # ------------------------------------------------- GCS reconnect (FT)
    def _on_gcs_lost(self, conn) -> None:
        if getattr(self, "_shut", False) or getattr(self, "_gcs_reconnecting", False):
            return
        self._gcs_reconnecting = True
        logger.warning("lost the GCS connection; reconnecting")
        self.io.spawn(self._gcs_reconnect_loop())

    async def _gcs_reconnect_loop(self) -> None:
        """Outlive a GCS restart (reference: workers survive GCS failover when
        FT is enabled).  Calls issued during the outage fail with
        ConnectionLost; retry loops around the runtime already tolerate that."""
        deadline = time.monotonic() + RayConfig.gcs_reconnect_timeout_s
        delay = 0.2
        handed_off = False
        try:
            while not self._shut:
                await asyncio.sleep(delay)
                try:
                    conn = await rpc.connect(*self._gcs_addr,
                                             handlers=self._gcs_handlers,
                                             name="worker->gcs")
                    await conn.call("client_hello",
                                    {"worker_id": self.worker_id.binary()})
                    for channel in self._subscriptions:
                        await conn.call("subscribe", {"channel": channel})
                    self.gcs_conn = conn
                    # attach last so a failed half-setup can't spawn a second
                    # loop; re-fire manually if it dropped in the window
                    conn._on_close = self._on_gcs_lost
                    logger.info("reconnected to the GCS")
                    if conn.closed:
                        # Hand off to a fresh loop.  The flag must stay
                        # owned by that loop: clearing it again in our
                        # finally would let a later drop spawn a third
                        # concurrent loop racing on self.gcs_conn.
                        handed_off = True
                        self._gcs_reconnecting = False
                        self._on_gcs_lost(conn)
                    return
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    # Never give up permanently: a driver wedged on a dead
                    # connection after the GCS comes BACK would fail every
                    # control-plane call forever (the nodelet exits instead;
                    # a user-facing driver must not).
                    if time.monotonic() > deadline:
                        logger.warning(
                            "GCS still unreachable after %.0fs; retrying "
                            "in the background", RayConfig.gcs_reconnect_timeout_s)
                        deadline = float("inf")
                    delay = min(delay * 1.5, 5.0)
        finally:
            if not handed_off:
                self._gcs_reconnecting = False

    async def gcs_call(self, method: str, obj=None, timeout=None):
        """A GCS call that survives a GCS restart.

        Blocking user-facing calls (``pg.ready()``, state queries, kv reads)
        must not surface ``ConnectionLost`` while ``_gcs_reconnect_loop`` is
        swapping in a fresh connection — the reference's GcsClient retries
        transparently under GCS FT (reference:
        src/ray/gcs/gcs_client/gcs_client.cc retry-on-unavailable).  Only
        idempotent methods may be routed here: a request that died in flight
        is re-issued verbatim against the restarted server.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            conn = self.gcs_conn
            try:
                # each attempt gets the REMAINING budget, not a fresh one
                attempt_timeout = None if deadline is None else \
                    max(deadline - time.monotonic(), 0.001)
                return await conn.call(method, obj, attempt_timeout)
            except (rpc.ConnectionLost, ConnectionError):
                if self._shut:
                    raise
                if conn.closed:
                    # Guarded against double-start; covers a drop in the
                    # window where the close callback never fired.
                    self._on_gcs_lost(conn)
                # Bounded wait for the reconnect loop to install a live conn.
                wait_until = time.monotonic() + RayConfig.gcs_reconnect_timeout_s
                while self.gcs_conn is conn or self.gcs_conn.closed:
                    now = time.monotonic()
                    if self._shut or now > wait_until or \
                            (deadline is not None and now > deadline):
                        raise
                    await asyncio.sleep(0.05)

    def gcs_call_sync(self, method: str, obj=None, timeout=None):
        """Blocking helper around :meth:`gcs_call` for API-surface modules."""
        return self.io.run(self.gcs_call(method, obj, timeout))

    # ======================================================== object: put/get
    def _next_put_id(self) -> ObjectID:
        with self._put_lock:
            self._put_index += 1
            return ObjectID.from_task(self._put_task_id, self._put_index)

    def put(self, value: Any) -> ObjectRef:
        ser = self.ctx.serialize(value)
        oid = self._next_put_id()
        self.ref_counter.add_owned(oid, initial_local=0)
        if ser.total_bytes() > RayConfig.max_direct_call_object_size:
            self.plasma.put_serialized(oid, ser)
            self.memory_store.put(oid, IN_PLASMA)
            with self._refs_lock:
                self._owned_in_plasma.add(oid)
        else:
            self.memory_store.put(oid, ser)
        if ser.contained_refs:
            with self._refs_lock:
                self._contained[oid] = list(ser.contained_refs)
        return ObjectRef(oid, self.addr, self.worker_id.binary())

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        return [self._resolve_one(r, deadline) for r in refs]

    def _remaining(self, deadline) -> Optional[float]:
        if deadline is None:
            return None
        rem = deadline - time.monotonic()
        if rem <= 0:
            raise GetTimeoutError("ray.get timed out")
        return rem

    def _resolve_one(self, ref: ObjectRef, deadline=None) -> Any:
        oid = ref.oid
        # 1. The in-process memory store (owned objects & cached borrows):
        # one lock acquisition resolves the common already-ready case.
        known, ready, value, err = self.memory_store.try_get(oid)
        if known:
            if not ready:
                if not self.memory_store.wait_ready(oid, self._remaining(deadline)):
                    raise GetTimeoutError(f"object {oid.hex()} not ready within timeout")
                ok, value, err = self.memory_store.get_if_ready(oid)
            if err is not None:
                raise err
            if value is IN_PLASMA:
                return self._get_from_plasma(oid, deadline)
            if isinstance(value, SerializedObject):
                return self.ctx.deserialize(value)
            return value
        # 2. Borrowed ref: ask the owner where/what the value is.
        owner_addr = ref.owner_addr()
        if owner_addr is None or owner_addr == self.addr:
            # Owned but unknown (e.g. ref survived a restart): try plasma.
            return self._get_from_plasma(oid, deadline)
        try:
            conn = self._owner_conn(owner_addr)
            resp = conn.call_sync(
                "get_object", {"oid": oid.binary()}, timeout=self._remaining(deadline)
            )
        except rpc.ConnectionLost:
            raise OwnerDiedError(oid) from None
        except asyncio.TimeoutError:
            raise GetTimeoutError(f"object {oid.hex()} not ready within timeout") from None
        if resp.get("plasma"):
            return self._get_from_plasma(oid, deadline, owner_addr=owner_addr)
        if "error" in resp:
            raise pickle.loads(resp["error"])
        ser = SerializedObject(resp["value"][0], [memoryview(b) for b in resp["value"][1]])
        value = self.ctx.deserialize(ser)
        # Cache small borrowed values for repeat gets.
        self.memory_store.put(oid, ser)
        return value

    def _get_from_plasma(self, oid: ObjectID, deadline=None,
                         owner_addr=None) -> Any:
        # Bounded local/pull rounds with a loss check between rounds: if the
        # object has no live location anywhere, its OWNER resubmits the
        # creating task to rebuild it (reference:
        # ObjectRecoveryManager::RecoverObject).  Borrowers trigger the
        # owner's recovery over RPC — only the owner holds the lineage.
        quick = 2.0
        while True:
            rem = self._remaining(deadline)
            round_timeout = quick if rem is None else min(quick, rem)
            mv = self.plasma.get_mapped(oid, round_timeout)
            if mv is not None:
                ser = SerializedObject.from_buffer(mv)
                # hand deserialization refcount-probeable view handles: the
                # client defers the server-side pin release until no live
                # view remains (arena extents must not be reused under a
                # deserialized numpy array)
                ser.buffers = self.plasma.wrap_views(oid, ser.buffers)
                return self.ctx.deserialize(ser)
            # A reconstruction may have resolved through the MEMORY store
            # instead of plasma (the re-run errored, or returned small this
            # time): plasma polling alone would never see it.
            if self.memory_store.known(oid):
                ok, value, err = self.memory_store.get_if_ready(oid)
                if err is not None:
                    raise err
                if ok and value is not IN_PLASMA:
                    if isinstance(value, SerializedObject):
                        return self.ctx.deserialize(value)
                    return value
            if owner_addr is None or owner_addr == self.addr:
                status = self.io.run(self._recover_object(oid))
            else:
                status = self._request_owner_recovery(oid, owner_addr)
            if status == "lost":
                raise ObjectLostError(oid)
            if status == "exhausted":
                raise ObjectReconstructionFailedError(oid)
            if rem is not None and rem <= round_timeout:
                raise GetTimeoutError(
                    f"object {oid.hex()} not available within timeout")

    def _request_owner_recovery(self, oid: ObjectID, owner_addr) -> str:
        try:
            resp = self._owner_conn(tuple(owner_addr)).call_sync(
                "recover_object", {"oid": oid.binary()},
                timeout=RayConfig.gcs_rpc_timeout_s)
            return resp.get("status", "ok")
        except (rpc.ConnectionLost, ConnectionError, asyncio.TimeoutError):
            return "ok"  # owner unreachable: keep polling; owner-death
            # detection raises OwnerDiedError elsewhere

    async def rpc_recover_object(self, conn, msg):
        """A borrower noticed one of our owned objects is gone."""
        return {"status": await self._recover_object(ObjectID(msg["oid"]))}

    async def _recover_object(self, oid: ObjectID) -> str:
        """If an owned plasma object is LOST (no live holder), re-drive its
        creating task.  Returns "ok" (recovering / transient / not ours),
        "lost" (no lineage: put() object or evicted), or "exhausted" (retry
        budget spent).  No-op for borrowed or still-transferring objects."""
        with self._refs_lock:
            if oid not in self._owned_in_plasma:
                # Not a plasma object of ours.  If we have no record of it at
                # all (freed, or we restarted and lost the table), the borrower
                # must not poll forever: declare it lost unless some node still
                # holds a plasma copy (checked below via the GCS directory).
                if (not self.ref_counter.has(oid)
                        and not self.memory_store.known(oid)):
                    pass  # fall through to the location check
                else:
                    return "ok"
            if oid in self._recovery_inflight:
                return "ok"  # a reconstruction is already running
            # claim the slot BEFORE the blocking locations RPC: a concurrent
            # get must not resubmit the same (possibly side-effecting) task
            self._recovery_inflight.add(oid)
            spec = self._lineage.get(oid)
        resubmitted = False
        try:
            try:
                locs = await self.gcs_conn.call(
                    "get_object_locations", {"oids": [oid.binary()]},
                    timeout=RayConfig.gcs_rpc_timeout_s)
            except (ConnectionError, rpc.ConnectionLost, asyncio.TimeoutError):
                return "ok"  # GCS unreachable/stalled: treat as transient
            if locs.get(oid.binary()):
                return "ok"  # a live holder exists; the pull path fetches it
            if spec is None:
                # put() objects / evicted lineage are unrecoverable
                return "lost"
            attempts = self._recovery_attempts.get(oid, 0)
            if attempts >= RayConfig.object_recovery_max_attempts:
                return "exhausted"
            self._recovery_attempts[oid] = attempts + 1
            logger.warning(
                "object %s lost; reconstructing by resubmitting task %s "
                "(attempt %d)", oid.hex()[:16], spec.name, attempts + 1)
            # A hard node affinity to the node that just died would make the
            # reconstruction unschedulable; recovery prefers the placement
            # but must not require it.
            if spec.scheduling_strategy.kind == "node_affinity":
                spec.scheduling_strategy.soft = True
            # Re-pin the re-run's argument refs exactly like the original
            # submit did — without holds, distributed GC could free an arg
            # mid-reconstruction.
            holds = []
            for a in spec.args:
                if isinstance(a, RefArg):
                    self.ref_counter.add_submitted(a.object_id)
                    holds.append(ObjectRef(a.object_id, a.owner_addr,
                                           a.owner_worker_id))
            await self.submitter.submit(spec, holds)
            resubmitted = True
            return "ok"
        finally:
            if not resubmitted:
                with self._refs_lock:
                    self._recovery_inflight.discard(oid)

    def wait(self, refs: List[ObjectRef], num_returns: int, timeout: Optional[float],
             fetch_local: bool = True) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        """Event-driven wait (reference: raylet/wait_manager.h — the v1 poll
        loop issued one sync RPC per borrowed ref per tick).

        Owned refs arm memory-store ready callbacks; borrowed refs issue ONE
        long-poll RPC each to their owner (wait_object blocks server-side).
        The caller thread then sleeps on a single Event instead of polling;
        only owned-but-unknown refs (post-restart plasma residents) still
        need a slow poll, and only those."""
        deadline = None if timeout is None else time.monotonic() + timeout
        pending = list(refs)
        ready: List[ObjectRef] = []
        done_event = threading.Event()
        ready_oids: Set[bytes] = set()
        ready_lock = threading.Lock()

        def mark(oid_bin: bytes):
            with ready_lock:
                ready_oids.add(oid_bin)
            done_event.set()

        slow_poll: List[ObjectRef] = []
        for r in pending:
            oid = r.oid
            if self.memory_store.known(oid):
                if self.memory_store.add_ready_callback(
                        oid, lambda b=oid.binary(): mark(b)):
                    mark(oid.binary())
                continue
            owner_addr = r.owner_addr()
            if owner_addr is None or owner_addr == self.addr:
                # plasma-resident (e.g. a streaming item ref): sealed-ness
                # is checked by the contains sweep below; if it comes up
                # empty and we are about to sleep, a seal-event long-poll
                # (_arm_plasma_wait) becomes the event source
                slow_poll.append(r)
                continue
            self.io.spawn(self._wait_borrowed(r, deadline, mark))

        slow_armed = not slow_poll
        while True:
            with ready_lock:
                snapshot = set(ready_oids)
            ready = [r for r in pending if r.oid.binary() in snapshot]
            if len(ready) >= num_returns:
                ready = ready[:num_returns]
                break
            for r in slow_poll:
                if r.oid.binary() not in snapshot and self.plasma.contains(r.oid):
                    mark(r.oid.binary())
            rem = None if deadline is None else deadline - time.monotonic()
            if rem is not None and rem <= 0:
                break
            done_event.clear()
            if not slow_armed:
                # arm seal long-polls only for refs the first contains sweep
                # missed, and only when this wait() actually sleeps — a
                # timeout=0 scoop or an already-sealed item needs no event
                # source (one RPC + one io task per arm is not free)
                slow_armed = True
                with ready_lock:
                    snapshot = set(ready_oids)
                for r in slow_poll:
                    if r.oid.binary() not in snapshot:
                        self._arm_plasma_wait(r.oid, mark)
            # with the long-poll armed the contains sweep is a backstop,
            # not the event source: tick it at 250ms, not
            # wait_poll_interval_ms — per-tick contains RPCs otherwise eat
            # the very CPU the producers need
            step = max(RayConfig.wait_poll_interval_ms, 250) / 1000.0 \
                if slow_poll else 5.0
            done_event.wait(step if rem is None else min(step, rem))
        ready_set = {id(r) for r in ready}
        return ready, [r for r in pending if id(r) not in ready_set]

    def _arm_plasma_wait(self, oid: ObjectID, mark) -> None:
        """Attach ``mark`` to a seal-event long-poll for a locally-owned
        plasma-resident oid.  One in-flight ``plasma_wait`` per oid no
        matter how many wait() calls watch it (a fragment-stream consumer
        re-waits the same speculative item ref every pass); callbacks
        accumulate on the inflight entry and all fire on seal."""
        with self._plasma_waits_lock:
            cbs = self._plasma_waits.get(oid)
            if cbs is not None:
                cbs.append(mark)
                return
            self._plasma_waits[oid] = [mark]
        self.io.spawn(self._plasma_wait_loop(oid))

    async def _plasma_wait_loop(self, oid: ObjectID):
        """Long-poll the local store until ``oid`` seals.  Holds the bare
        ObjectID only — an ObjectRef here would pin the ref count and keep
        a dead stream's items alive forever.  Exits (leaving the slow poll
        as the only watcher) when the oid stops being locally tracked, on
        any RPC failure, or once sealed."""
        ready = False
        try:
            while self.ref_counter.has(oid):
                try:
                    ready = await self.nodelet_conn.call(
                        "plasma_wait",
                        {"oid": oid.binary(), "timeout": 10.0},
                        timeout=10.0 + RayConfig.gcs_rpc_timeout_s)
                except Exception:
                    return
                if ready:
                    return
        finally:
            with self._plasma_waits_lock:
                cbs = self._plasma_waits.pop(oid, [])
            if ready:
                for cb in cbs:
                    cb(oid.binary())

    async def _wait_borrowed(self, ref: ObjectRef, deadline, mark):
        """One long-poll to the owner per borrowed ref (owner blocks until
        the object is ready or the timeout lapses)."""
        while True:
            rem = None if deadline is None else deadline - time.monotonic()
            if rem is not None and rem <= 0:
                return
            chunk = 10.0 if rem is None else min(10.0, rem)
            try:
                conn = await self._owner_conn_async(tuple(ref.owner_addr()))
                resp = await conn.call(
                    "wait_object", {"oid": ref.oid.binary(), "timeout": chunk},
                    timeout=chunk + RayConfig.gcs_rpc_timeout_s)
            except (ConnectionError, OSError, rpc.ConnectionLost,
                    asyncio.TimeoutError):
                mark(ref.oid.binary())  # owner died: get() raises quickly
                return
            if resp.get("ready"):
                mark(ref.oid.binary())
                return

    def _is_ready(self, ref: ObjectRef) -> bool:
        oid = ref.oid
        if self.memory_store.contains(oid):
            return True
        if self.memory_store.known(oid):
            return False  # owned, still pending
        owner_addr = ref.owner_addr()
        if owner_addr is None or owner_addr == self.addr:
            return self.plasma.contains(oid)
        try:
            st = self._owner_conn(owner_addr).call_sync(
                "object_status", {"oid": oid.binary()}, timeout=RayConfig.gcs_rpc_timeout_s)
            return bool(st.get("ready"))
        except rpc.ConnectionLost:
            return True  # owner died: get() will raise quickly

    def as_future(self, ref: ObjectRef):
        return self._get_pool.submit(self._resolve_one, ref, None)

    def free(self, refs: List[ObjectRef]) -> None:
        for r in refs:
            self._on_out_of_scope(r.oid)

    # ================================================== ref counting plumbing
    def register_ref(self, ref: ObjectRef) -> None:
        self.ref_counter.add_local(ref.oid, ref.owner_addr(), ref.owner_worker_id())

    def deregister_ref(self, ref: ObjectRef) -> None:
        """Called from ObjectRef.__del__ — i.e. potentially from the GARBAGE
        COLLECTOR, reentrantly inside ANY allocation site, including one
        that already holds the ref-counter lock (observed: gc fired inside
        add_owned and remove_local self-deadlocked the non-reentrant lock).
        __del__ therefore never does synchronous release work: the oid is
        queued (deque appends are GC-safe) and drained outside GC context."""
        if self._shut:
            return
        self._release_queue.append((ref.oid, ref.owner_worker_id()))
        if not self._release_scheduled:
            # schedule at most one drain per burst; the IO loop is never
            # inside the ref-counter lock
            self._release_scheduled = True
            try:
                self.io.loop.call_soon_threadsafe(self._drain_releases)
            except RuntimeError:
                self._release_scheduled = False  # loop closed: shutdown path

    def _drain_releases(self) -> None:
        """Run deferred ObjectRef releases (on the IO loop, outside GC).
        Chunked: a huge GC burst must not stall every RPC connection for
        the whole queue — drain a slice, then yield the loop."""
        self._release_scheduled = False
        for _ in range(1024):
            try:
                oid, owner = self._release_queue.popleft()
            except IndexError:
                return
            if self._shut:
                return
            if not self.ref_counter.remove_local(oid):
                self.plasma.release(oid)
                if owner is not None and owner != self.worker_id.binary():
                    # Borrowed value cached by _resolve_one: drop with the
                    # last ref (owned entries drop via _on_out_of_scope).
                    self.memory_store.delete(oid)
        if self._release_queue and not self._release_scheduled:
            self._release_scheduled = True
            self.io.loop.call_soon(self._drain_releases)

    def _on_out_of_scope(self, oid: ObjectID) -> None:
        """Owner-side free: reclaim the value everywhere (reference: distributed
        GC driven by reference_count.cc going to zero)."""
        self.memory_store.delete(oid)
        with self._refs_lock:
            contained = self._contained.pop(oid, None)
            in_plasma = oid in self._owned_in_plasma
            self._owned_in_plasma.discard(oid)
            self._lineage.pop(oid, None)
            self._recovery_attempts.pop(oid, None)
        del contained  # dropping the ObjectRefs decrements their counts
        if in_plasma and not self._shut:
            # local fast path first: the nearby store's capacity frees on the
            # next loop tick (coalesced notify) instead of waiting out the
            # seal->directory->GCS->broadcast round trip; the GCS free still
            # sweeps remote copies and the directory.
            try:
                self.plasma.free_async([oid])
            except Exception:
                pass
            try:
                self.gcs_conn.notify_coalesced_threadsafe(
                    "free_objects", {"oids": [oid.binary()]})
            except Exception:
                pass

    def _notify_owner(self, owner_addr, action: str, oid: ObjectID) -> None:
        if self._shut:
            return
        async def _go():
            try:
                conn = await self._owner_conn_async(tuple(owner_addr))
                # borrow-count updates are pure control noise on the hot
                # path: ride the per-tick coalesced batch frame
                conn.notify_coalesced("ref_borrow", {
                    "action": action, "oid": oid.binary(),
                    "borrower": self.worker_id.binary(),
                })
            except (ConnectionError, OSError):
                pass
        self.io.spawn(_go())

    def _owner_conn(self, addr: Tuple[str, int]) -> rpc.Connection:
        conn = self._owner_conns.get(tuple(addr))
        if conn is None or conn.closed:
            conn = self.io.run(self._owner_conn_async(tuple(addr)))
        return conn

    async def _owner_conn_async(self, addr: Tuple[str, int]) -> rpc.Connection:
        conn = self._owner_conns.get(addr)
        if conn is None or conn.closed:
            conn = await rpc.connect(*addr, name=f"->owner-{addr[1]}")
            self._owner_conns[addr] = conn
        return conn

    # ============================================== owner-side RPC services
    async def rpc_get_object(self, conn, msg):
        """Serve an owned object's value/location to a borrower."""
        oid = ObjectID(msg["oid"])
        if not self.memory_store.known(oid):
            return {"plasma": True}  # not ours or already plasma-only
        if not self.memory_store.contains(oid):
            loop = asyncio.get_event_loop()
            fut = loop.create_future()
            already = self.memory_store.add_ready_callback(
                oid, lambda: loop.call_soon_threadsafe(
                    lambda: fut.done() or fut.set_result(True)))
            if not already:
                await fut
        ok, value, err = self.memory_store.get_if_ready(oid)
        if err is not None:
            return {"error": _dumps_ctrl(err)}
        if value is IN_PLASMA:
            return {"plasma": True}
        if isinstance(value, SerializedObject):
            bufs, copied = freeze_buffers(value.buffers)
            if copied:
                self._m_put_copies.inc(copied)
            return {"value": (value.inband, bufs)}
        ser = self.ctx.serialize(value)
        bufs, copied = freeze_buffers(ser.buffers)
        if copied:
            self._m_put_copies.inc(copied)
        return {"value": (ser.inband, bufs)}

    async def rpc_object_status(self, conn, msg):
        oid = ObjectID(msg["oid"])
        return {"ready": self.memory_store.contains(oid)}

    async def rpc_wait_object(self, conn, msg):
        """Long-poll: block until an owned object is ready (or timeout) so
        borrowers' wait() needs one RPC per ref, not one per poll tick
        (reference: WaitManager event-driven waits)."""
        oid = ObjectID(msg["oid"])
        timeout = msg.get("timeout", 10.0)
        if self.memory_store.contains(oid):
            return {"ready": True}
        if not self.memory_store.known(oid):
            return {"ready": True}  # freed/unknown: let get() surface it
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        cb = lambda: loop.call_soon_threadsafe(  # noqa: E731
            lambda: fut.done() or fut.set_result(True))
        if self.memory_store.add_ready_callback(oid, cb):
            return {"ready": True}
        try:
            await asyncio.wait_for(fut, timeout)
            return {"ready": True}
        except asyncio.TimeoutError:
            # deregister, or every long-poll round leaks a closure on a
            # long-pending object
            self.memory_store.remove_ready_callback(oid, cb)
            return {"ready": False}

    async def rpc_ref_borrow(self, conn, msg):
        oid = ObjectID(msg["oid"])
        if msg["action"] == "add":
            self.ref_counter.add_borrower(oid, msg["borrower"])
        else:
            self.ref_counter.remove_borrower(oid, msg["borrower"])
        return True

    async def rpc_ping(self, conn, msg):
        return {"worker_id": self.worker_id.binary(), "pid": os.getpid()}

    async def rpc_assign_cards(self, conn, msg):
        """The nodelet gives this worker its lease's cards: CUDA in this
        process sees only them.  CUDA reads the variable once, when it
        starts, so a worker in which it is already up with other cards
        visible refuses (False) and the nodelet retires it."""
        ids = ",".join(msg["ids"])
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized() and \
                os.environ.get("CUDA_VISIBLE_DEVICES") != ids:
            return False
        os.environ["CUDA_VISIBLE_DEVICES"] = ids
        return True

    async def rpc_lease_reclaim(self, conn, msg):
        """Nodelet hint: a lease request / bundle reservation is queued
        behind resources our cached idle leases hold — return them now."""
        await self.submitter.return_cached_leases()
        return True

    async def rpc_extent_reclaim(self, conn, msg):
        """Nodelet hint: the store hit full during an extent lease — hand
        back idle leased extents so the requester's retry succeeds."""
        self.plasma.return_idle_extents(force=True)
        return True

    async def rpc_pressure_kill(self, conn, msg):
        """Nodelet heads-up: it is about to SIGKILL one of our leased
        workers to relieve memory pressure.  Mark the worker so its
        'lost' completions retry without consuming the tasks' crash-retry
        budget (reference: memory-monitor kills are charged to a separate
        OOM-retry counter, not max_retries)."""
        now = time.monotonic()
        self._pressure_killed = {
            w: t for w, t in self._pressure_killed.items()
            if now - t < 60.0}
        self._pressure_killed[msg["worker_id"]] = now
        return True

    # ----------------------------------------------- live introspection
    def _track_task_start(self, spec: TaskSpec, thread_ident) -> None:
        """Register an executing task for the stack sampler / hang watchdog
        (dict assignment: safe from executor threads under the GIL)."""
        self._running_tasks[spec.task_id.binary()] = {
            "task_id": spec.task_id.hex(), "name": spec.name,
            "attempt": spec.attempt_number, "start": time.monotonic(),
            "thread": thread_ident,
        }

    def _track_task_end(self, spec: TaskSpec) -> None:
        info = self._running_tasks.pop(spec.task_id.binary(), None)
        if info is None:
            return
        dur = time.monotonic() - info["start"]
        name = spec.name or "?"
        with self._exec_hist_lock:
            dq = self._exec_hist.get(name)
            if dq is None:
                if len(self._exec_hist) >= 512:
                    # unbounded task-name churn (closures minted per call)
                    # must not grow a long-lived worker without limit
                    self._exec_hist.clear()
                dq = self._exec_hist[name] = deque(maxlen=64)
            dq.append(dur)

    def _exec_p95(self, name: str) -> Tuple[Optional[float], int]:
        """(p95, sample count) of this worker's recent exec durations for
        one task name — the watchdog's per-name baseline."""
        with self._exec_hist_lock:
            dq = self._exec_hist.get(name)
            vals = sorted(dq) if dq else None
        if not vals:
            return None, 0
        idx = min(int(round(0.95 * (len(vals) - 1))), len(vals) - 1)
        return vals[idx], len(vals)

    async def rpc_get_running_tasks(self, conn, msg):
        """Currently-executing tasks with elapsed time + this worker's
        per-name exec p95 — the nodelet hang watchdog's poll target."""
        now = time.monotonic()
        out = []
        for info in list(self._running_tasks.values()):
            p95, count = self._exec_p95(info["name"] or "?")
            out.append({
                "task_id": info["task_id"], "name": info["name"],
                "attempt": info["attempt"],
                "elapsed_s": now - info["start"],
                "p95_s": p95, "samples": count,
            })
        return out

    async def rpc_dump_stacks(self, conn, msg):
        """All Python thread stacks of this process plus the running-task
        map (the `ray_tpu_torch stack` payload; reference: `ray stack` via py-spy,
        here in-process with zero external deps)."""
        return self.capture_stacks()

    async def rpc_rpc_stats(self, conn, msg):
        """Per-method served-RPC counters over this worker's connections
        ({method: {count, total_s}}) — same surface the GCS and nodelet
        serve, so any peer holding a direct worker connection (owner,
        borrower, nodelet) can ask what traffic this process handled when
        debugging the task path."""
        agg: Dict[str, list] = {}
        for c in self.server.connections:
            for method, (count, total_s) in c.handler_stats().items():
                st = agg.setdefault(method, [0, 0.0])
                st[0] += count
                st[1] += total_s
        return {m: {"count": v[0], "total_s": v[1]}
                for m, v in agg.items()}

    def capture_stacks(self) -> dict:
        from ray_tpu_torch._private.introspect import capture_thread_stacks

        now = time.monotonic()
        by_thread: Dict[int, dict] = {}
        running = []
        for info in list(self._running_tasks.values()):
            if info.get("thread") is not None:
                by_thread[info["thread"]] = info
            running.append({
                "task_id": info["task_id"], "name": info["name"],
                "attempt": info["attempt"],
                "elapsed_s": now - info["start"],
            })
        return {
            "kind": self.mode,
            "pid": self._pid,
            "worker_id": self._worker_id_hex,
            "actor_id": self.actor_id.hex() if self.actor_id else None,
            "node_id": self._node_id_hex,
            "threads": capture_thread_stacks(by_thread),
            "running_tasks": running,
        }

    async def rpc_debug_state(self, conn, msg):
        """Introspection for the state API + stuck-worker diagnosis."""
        disp = self._dispatch_task
        disp_state = None
        if disp is not None:
            if disp.done():
                exc = disp.exception()
                disp_state = f"DEAD: {exc!r}" if exc else "finished"
            else:
                disp_state = "running"
        return {
            "mode": self.mode,
            "pid": os.getpid(),
            "actor_id": self.actor_id.hex() if self.actor_id else None,
            "queue_size": self._exec_queue.qsize() if self._exec_queue else None,
            "dispatch_loop": disp_state,
            "memory_store_size": self.memory_store.size(),
            "owned_refs": self.ref_counter.owned_count(),
            "task": self.task_ctx.task_name if self.task_ctx.task_id else None,
        }

    async def rpc_exit_worker(self, conn, msg):
        logger.info("worker exiting on request")
        os._exit(0)

    async def rpc_cancel_task(self, conn, msg):
        """Cooperative cancel of one normal task on this worker (reference:
        CoreWorker::HandleCancelTask raising in the executing thread).  A
        queued task is marked and never starts; a RUNNING task gets
        TaskCancelledError raised at its thread's next bytecode boundary
        (PyThreadState_SetAsyncExc — blocking C calls like time.sleep defer
        delivery until they return; force=True kills the worker instead)."""
        import ctypes

        tkey = msg["task_id"]
        self._mark_cancelled_exec(tkey)
        atask = self._running_async.get(tkey)
        if atask is not None:
            atask.cancel()  # async actor task: asyncio cancellation
            return True
        tid = self._running_threads.get(tkey)
        if tid is not None:
            # microscopic race: the thread may finish between the lookup and
            # the raise, delivering onto its next task — same caveat the
            # reference's in-thread cancellation carries
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(tid), ctypes.py_object(TaskCancelledError))
        return True

    # ========================================================= task submission
    def _child_trace(self) -> tuple:
        """(trace_id, span_id, parent_span_id) for a task submitted from
        this context: inherits the executing task's trace (the span context
        travels INSIDE the spec, reference tracing_helper.py:36-60); a
        driver-side submission with no active span starts a new trace."""
        span_id = _fast_unique(8).hex()
        trace_id, parent = _trace_ctx.get()
        if trace_id is not None:
            return trace_id, span_id, parent
        return _fast_unique(16).hex(), span_id, None

    def _function_payload(self, fn) -> Tuple[Optional[bytes], Optional[str]]:
        # Cache per function object: re-cloudpickling an unchanged function on
        # every `.remote()` cost ~0.4ms/call and dominated the submit path.
        # Pickling once also matches the reference's capture-at-decoration
        # semantics (remote_function.py pickles when @ray.remote runs).
        ent = self._fn_payload_cache.get(fn)
        if ent is None:
            blob = cloudpickle.dumps(fn)
            if len(blob) <= _FUNCTION_TABLE_THRESHOLD:
                ent = (blob, None)
            else:
                ent = (None, "fn:" + hashlib.sha1(blob).hexdigest())
                key = ent[1]
                if key not in self._pushed_fns:
                    self.io.run(self.gcs_conn.call("kv_put", {
                        "ns": "fn", "key": key, "value": blob,
                        "overwrite": False}))
                    self._pushed_fns.add(key)
            try:
                self._fn_payload_cache[fn] = ent
            except TypeError:
                pass  # unweakrefable callable: just re-pickle next time
        return ent

    def _build_args(self, args, kwargs) -> Tuple[List[Any], List[str], List[ObjectRef]]:
        """Serialize call arguments (reference: dependency_resolver.h inlining +
        plasma promotion of big args)."""
        out: List[Any] = []
        holds: List[ObjectRef] = []
        kw_keys = list(kwargs.keys())
        for value in list(args) + [kwargs[k] for k in kw_keys]:
            if isinstance(value, ObjectRef):
                self.ref_counter.add_submitted(value.oid)
                holds.append(value)
                out.append(RefArg(value.oid, value.owner_addr(), value.owner_worker_id()))
                continue
            ser = self.ctx.serialize(value)
            for cref in ser.contained_refs:
                self.ref_counter.add_submitted(cref.oid)
                holds.append(cref)
            if ser.total_bytes() > RayConfig.max_direct_call_object_size:
                ref = self.put(value)
                self.ref_counter.add_submitted(ref.oid)
                holds.append(ref)
                out.append(RefArg(ref.oid, ref.owner_addr(), ref.owner_worker_id()))
            else:
                bufs, copied = freeze_buffers(ser.buffers)
                if copied:
                    self._m_put_copies.inc(copied)
                out.append(InlineArg(ser.inband, bufs))
        return out, kw_keys, holds

    def submit_task(self, fn, args, kwargs, *, name: str, num_returns: int,
                    resources: Dict[str, float], strategy: SchedulingStrategy,
                    max_retries: int, retry_exceptions: bool = False,
                    runtime_env: Optional[dict] = None,
                    stream_returns: bool = False) -> List[ObjectRef]:
        t_submit = time.time()
        blob, key = self._function_payload(fn)
        spec_args, kw_keys, holds = self._build_args(args, kwargs)
        t_ser = time.time()
        task_id = TaskID.for_task(self.job_id)
        trace_id, span_id, parent_span = self._child_trace()
        spec = TaskSpec(
            phase_ts={"submit": t_submit, "ser": t_ser - t_submit},
            task_id=task_id, job_id=self.job_id, task_type=TaskType.NORMAL_TASK,
            name=name, function_blob=blob, function_key=key, args=spec_args,
            kwargs_keys=kw_keys, num_returns=num_returns, resources=resources,
            scheduling_strategy=strategy, max_retries=max_retries,
            retry_exceptions=retry_exceptions,
            owner_worker_id=self.worker_id.binary(), owner_addr=self.addr,
            runtime_env=runtime_env, stream_returns=stream_returns,
            trace_id=trace_id, span_id=span_id, parent_span_id=parent_span,
        )
        refs = []
        for oid in spec.return_ids():
            self.ref_counter.add_owned(oid, initial_local=0)
            self.memory_store.register_pending(oid)
            refs.append(ObjectRef(oid, self.addr, self.worker_id.binary()))
        self.emit_task_event(spec, "SUBMITTED")
        self.submitter.enqueue(spec, holds)
        return refs

    # ------------------------------------------------------------- actors
    def create_actor(self, cls, args, kwargs, *, name: Optional[str], namespace: Optional[str],
                     num_returns: int = 0, resources: Dict[str, float],
                     strategy: SchedulingStrategy, max_restarts: int,
                     max_task_retries: int, max_concurrency: int,
                     detached: bool = False, runtime_env: Optional[dict] = None) -> ActorID:
        blob, key = self._function_payload(cls)
        spec_args, kw_keys, holds = self._build_args(args, kwargs)
        actor_id = ActorID.of(self.job_id)
        task_id = TaskID.for_actor_creation(actor_id)
        trace_id, span_id, parent_span = self._child_trace()
        spec = TaskSpec(
            task_id=task_id, job_id=self.job_id, task_type=TaskType.ACTOR_CREATION_TASK,
            name=getattr(cls, "__name__", "Actor"), function_blob=blob, function_key=key,
            args=spec_args, kwargs_keys=kw_keys, num_returns=0, resources=resources,
            scheduling_strategy=strategy, owner_worker_id=self.worker_id.binary(),
            owner_addr=self.addr, actor_creation_id=actor_id, max_restarts=max_restarts,
            max_task_retries=max_task_retries, max_concurrency=max_concurrency,
            actor_name=name, namespace=namespace if namespace is not None else self.namespace,
            runtime_env=runtime_env,
            trace_id=trace_id, span_id=span_id, parent_span_id=parent_span,
        )
        self.io.run(self.gcs_conn.call("create_actor", {
            "spec": _dumps_ctrl(spec), "detached": detached,
        }, timeout=RayConfig.gcs_rpc_timeout_s))
        # holds released once the actor is alive; keep it simple: creation args
        # stay pinned for the actor's lifetime via the submitter.
        self._actor_submitter(actor_id).creation_holds = holds
        return actor_id

    def _actor_submitter(self, actor_id: ActorID) -> "ActorTaskSubmitter":
        sub = self.actor_submitters.get(actor_id)
        if sub is None:
            sub = ActorTaskSubmitter(self, actor_id)
            self.actor_submitters[actor_id] = sub
        return sub

    def submit_actor_task(self, actor_id: ActorID, method_name: str, args, kwargs,
                          *, num_returns: int = 1,
                          max_task_retries: int = 0,
                          stream_returns: bool = False) -> List[ObjectRef]:
        t_submit = time.time()
        spec_args, kw_keys, holds = self._build_args(args, kwargs)
        t_ser = time.time()
        task_id = TaskID.for_actor_task(actor_id)
        trace_id, span_id, parent_span = self._child_trace()
        spec = TaskSpec(
            phase_ts={"submit": t_submit, "ser": t_ser - t_submit},
            task_id=task_id, job_id=self.job_id, task_type=TaskType.ACTOR_TASK,
            name=method_name, function_blob=None, function_key=None, args=spec_args,
            kwargs_keys=kw_keys, num_returns=num_returns, resources={},
            owner_worker_id=self.worker_id.binary(), owner_addr=self.addr,
            actor_id=actor_id, actor_method_name=method_name,
            max_task_retries=max_task_retries, stream_returns=stream_returns,
            trace_id=trace_id, span_id=span_id, parent_span_id=parent_span,
        )
        refs = []
        for oid in spec.return_ids():
            self.ref_counter.add_owned(oid, initial_local=0)
            self.memory_store.register_pending(oid)
            refs.append(ObjectRef(oid, self.addr, self.worker_id.binary()))
        self.emit_task_event(spec, "SUBMITTED")
        self._actor_submitter(actor_id).enqueue(spec, holds)
        return refs

    def cancel(self, ref: ObjectRef, force: bool = False,
               recursive: bool = False) -> None:
        """Cancel the task that produces ``ref`` (reference: ray.cancel /
        CoreWorker::CancelTask).  Pending tasks are failed locally with
        TaskCancelledError; running tasks get a cooperative in-thread raise
        on their worker, or the worker is told to exit with ``force=True``.
        Finished/unknown tasks are a no-op.  Actor tasks: queued cancel
        immediately, running async methods cancel via asyncio, running
        sync methods are best-effort (complete normally)."""
        self.io.run(self._cancel_async(ref, force))

    async def _cancel_async(self, ref: ObjectRef, force: bool) -> None:
        task_id = ref.oid.task_id()
        tkey = task_id.binary()
        err = TaskCancelledError(f"task {task_id.hex()} was cancelled")
        for sub in self.actor_submitters.values():
            with sub._queue_lock:
                for item in list(sub._queue):
                    if item[0].task_id == task_id:
                        sub._queue.remove(item)
                        self.fail_task(item[0], err, item[1])
                        return
            if tkey in sub._inflight:
                # async actor methods cancel via asyncio on the actor's
                # worker; sync methods are best-effort (the marker stops a
                # not-yet-started task, a running sync method completes) —
                # mirrors the reference's async-only actor cancellation
                if sub.conn is not None and not sub.conn.closed:
                    try:
                        await sub.conn.notify("cancel_task",
                                              {"task_id": tkey})
                    except (rpc.ConnectionLost, ConnectionError):
                        pass
                return
        aid = task_id.actor_id()
        is_actor_task = not aid.binary().startswith(
            b"\xff" * ACTOR_ID_UNIQUE_BYTES)  # for_task embeds a nil actor
        if is_actor_task and not self.memory_store.contains(ref.oid):
            # an actor task caught in its submitter's _drain window (popped
            # from _queue, not yet inflight): leave the marker _drain
            # consumes at ship time
            self._cancelled_tasks.add(tkey)
            return
        sub = self.submitter
        # 1. staged (never left the caller-side queue)
        with sub._stage_lock:
            for item in list(sub._stage):
                if item[0].task_id == task_id:
                    sub._stage.remove(item)
                    self.fail_task(item[0], err, item[1])
                    return
        # 2. pending in a lease class (waiting for a worker)
        for st in sub.classes.values():
            for item in list(st["pending"]):
                if item[0].task_id == task_id:
                    st["pending"].remove(item)
                    self.fail_task(item[0], err, item[1])
                    return
        # 3. dispatched: signal the worker that runs it
        if tkey in self._completion_router:
            self._cancelled_tasks.add(tkey)
            for conn, tasks in list(self._conn_tasks.items()):
                if tkey in tasks:
                    try:
                        if force:
                            # hard stop: the worker process exits; the lost
                            # completion resolves as cancelled, not a retry
                            await conn.notify("exit_worker", {})
                        else:
                            await conn.notify("cancel_task",
                                              {"task_id": tkey})
                    except (rpc.ConnectionLost, ConnectionError):
                        pass
                    return
        if self.memory_store.known(ref.oid) and \
                not self.memory_store.contains(ref.oid):
            # still pending but in none of the scannable queues: it is
            # dep-blocked inside a submit() coroutine — leave a marker the
            # dispatch choke point (_pump) honors once the deps resolve
            self._cancelled_tasks.add(tkey)
            return
        # finished or foreign: no-op (reference behavior)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self.io.run(self.gcs_conn.call("kill_actor", {
            "actor_id": actor_id.binary(), "no_restart": no_restart}))

    # Distributed actor-handle refcount: this process reports to the GCS when
    # it starts/stops holding handles for an actor; the GCS reclaims the actor
    # once no process holds one (reference: actor out-of-scope destruction via
    # reference counting in core_worker + GcsActorManager).
    def add_actor_handle(self, actor_id: ActorID) -> None:
        with self._refs_lock:
            n = self._actor_handle_counts.get(actor_id, 0)
            self._actor_handle_counts[actor_id] = n + 1
        if n == 0 and not self._shut:
            try:
                self.io.spawn(self.gcs_conn.notify("actor_holder_update", {
                    "actor_id": actor_id.binary(),
                    "holder": self.worker_id.binary(), "add": True}))
            except Exception:
                pass

    def remove_actor_handle(self, actor_id: ActorID) -> None:
        with self._refs_lock:
            n = self._actor_handle_counts.get(actor_id, 0) - 1
            if n <= 0:
                self._actor_handle_counts.pop(actor_id, None)
            else:
                self._actor_handle_counts[actor_id] = n
        if n <= 0 and not self._shut:
            try:
                self.io.spawn(self.gcs_conn.notify("actor_holder_update", {
                    "actor_id": actor_id.binary(),
                    "holder": self.worker_id.binary(), "add": False}))
            except Exception:
                pass

    def get_actor_info(self, actor_id: ActorID, wait_alive=False, timeout=None):
        return self.io.run(self.gcs_conn.call("get_actor_info", {
            "actor_id": actor_id.binary(), "wait_alive": wait_alive, "timeout": timeout},
            timeout=None))

    # ----------------------------------------------- completion bookkeeping
    def complete_task(self, spec: TaskSpec, returns, holds: List[ObjectRef]):
        """Record task results into the owner memory store (runs on IO loop)."""
        declared = {o.binary() for o in spec.return_ids()} \
            if spec.num_returns == -1 else None
        for item in returns:
            oid = ObjectID(item[0])
            if declared is not None and item[0] not in declared:
                # dynamically created return: this driver owns it from now on
                self.ref_counter.add_owned(oid, initial_local=0)
                self.memory_store.register_pending(oid)
            kind = item[1]
            contained_meta = ()
            # force=True throughout: a reconstruction re-run's outcome must
            # replace the stale pre-loss memory-store entry (plain put is
            # idempotent and would silently drop it)
            if kind == "val":
                contained_meta = item[4] if len(item) > 4 else ()
                with self._refs_lock:
                    self._recovery_inflight.discard(oid)
                    self._owned_in_plasma.discard(oid)
                self.memory_store.put(
                    oid, SerializedObject(item[2], [memoryview(b) for b in item[3]]),
                    force=True)
            elif kind == "plasma":
                contained_meta = item[3] if len(item) > 3 else ()
                with self._refs_lock:
                    self._owned_in_plasma.add(oid)
                    self._recovery_inflight.discard(oid)
                    # successful (re)construction resets the retry budget —
                    # the cap is per loss, not per object lifetime
                    self._recovery_attempts.pop(oid, None)
                    if len(self._lineage) < RayConfig.max_lineage_entries:
                        self._lineage[oid] = spec
                self.memory_store.put(oid, IN_PLASMA, force=True)
            elif kind == "error":
                with self._refs_lock:
                    self._recovery_inflight.discard(oid)
                    self._owned_in_plasma.discard(oid)
                err = pickle.loads(item[2])
                if isinstance(err, RayTaskError):
                    err = err.as_instanceof_cause()
                self.memory_store.put(oid, None, error=err, force=True)
            if contained_meta:
                # Take our own holds on refs nested in the return value (same
                # bookkeeping as put() with contained refs: they live until the
                # outer object goes out of scope), then release the executor's
                # synthetic return-pin.
                crefs = [ObjectRef(ObjectID(b), addr, wid)
                         for b, addr, wid in contained_meta]
                with self._refs_lock:
                    self._contained[oid] = crefs
                token = spec.task_id.binary()
                for cr in crefs:
                    self._release_return_pin(cr, token)
        self.release_holds(spec, holds)

    def _release_return_pin(self, cref: ObjectRef, token: bytes,
                            claim: bool = True) -> None:
        """Drop the executor's synthetic return-pin.  With claim=True (caller
        side) our own borrow is REGISTERED first (call, not notify) on the
        same connection, so the owner can't free the object between the two
        messages; claim=False (executor-side TTL sweep) only drops the pin."""
        owner_wid = cref.owner_worker_id()
        if owner_wid is None or owner_wid == self.worker_id.binary():
            self.ref_counter.remove_borrower(cref.oid, token)
            return
        async def _go():
            try:
                conn = await self._owner_conn_async(tuple(cref.owner_addr()))
                if claim:
                    await conn.call("ref_borrow", {
                        "action": "add", "oid": cref.oid.binary(),
                        "borrower": self.worker_id.binary()})
                await conn.notify("ref_borrow", {
                    "action": "remove", "oid": cref.oid.binary(),
                    "borrower": token})
            except (ConnectionError, OSError, rpc.ConnectionLost):
                pass
        self.io.spawn(_go())

    def fail_task(self, spec: TaskSpec, error: BaseException, holds: List[ObjectRef]):
        doomed = list(spec.return_ids())
        if spec.num_returns == -1:
            # dynamic generator: yielded oids aren't in return_ids(); any of
            # them awaiting reconstruction must receive the error too or
            # their getters hang forever
            with self._refs_lock:
                doomed += [oid for oid in self._recovery_inflight
                           if oid.task_id() == spec.task_id]
        for oid in doomed:
            with self._refs_lock:
                self._recovery_inflight.discard(oid)
            # force=True: a reconstruction re-run's failure must overwrite the
            # stale ready IN_PLASMA entry, or blocked getters never see it.
            self.memory_store.put(oid, None, error=error, force=True)
        # The executing worker is gone, so it can't emit its own FAILED event.
        self.emit_task_event(spec, "FAILED", error=repr(error))
        self.release_holds(spec, holds)

    def release_holds(self, spec: TaskSpec, holds: List[ObjectRef]):
        for ref in holds:
            self.ref_counter.remove_submitted(ref.oid)
        holds.clear()

    # ============================================================ execution
    async def _execute_loop(self):
        """Dispatch in arrival order.  Actor tasks: concurrency bounded by
        max_concurrency (reference: actor_scheduling_queue.h).  Normal tasks:
        bounded by the lease pipeline depth (see __init__); actor CREATION
        still runs inline so the actor exists before its first method call."""
        held = None
        while True:
            if held is not None:
                item, held = held, None
            else:
                item = await self._exec_queue.get()
            spec, reply_fut = item
            if self._actor_sem is None and spec.task_type == TaskType.ACTOR_TASK:
                # Plain sync actor (no concurrency): run every consecutive
                # queued sync method in ONE executor hop.  The loop->actor-
                # thread->loop round trip per call (~hundreds of us on a
                # shared core) was the throughput cap for sync actors; the
                # chunk completes in one tick so its result notifies coalesce
                # into one frame too.
                method = None
                if self.actor_instance is not None:
                    method = getattr(
                        self.actor_instance, spec.actor_method_name, None)
                if method is not None and not asyncio.iscoroutinefunction(method):
                    chunk = [(spec, reply_fut, method)]
                    while len(chunk) < 256:
                        try:
                            nspec, nfut = self._exec_queue.get_nowait()
                        except asyncio.QueueEmpty:
                            break
                        nmethod = None
                        if nspec.task_type == TaskType.ACTOR_TASK:
                            nmethod = getattr(
                                self.actor_instance, nspec.actor_method_name,
                                None)
                        if nmethod is not None and \
                                not asyncio.iscoroutinefunction(nmethod):
                            chunk.append((nspec, nfut, nmethod))
                        else:
                            held = (nspec, nfut)
                            break
                    await self._run_chunk(chunk)
                    continue
            if self._actor_sem is not None:
                await self._actor_sem.acquire()
                asyncio.get_event_loop().create_task(self._run_one(spec, reply_fut, release=True))
            elif spec.task_type == TaskType.NORMAL_TASK and \
                    self._task_sem is not None:
                if spec.runtime_env:
                    # env application mutates process-global state
                    # (os.environ, cwd, sys.path): run EXCLUSIVELY by
                    # draining every executor permit first
                    permits = self._task_permits
                    for _ in range(permits):
                        await self._task_sem.acquire()
                    try:
                        await self._run_one(spec, reply_fut, release=False)
                    finally:
                        for _ in range(permits):
                            self._task_sem.release()
                else:
                    await self._task_sem.acquire()
                    # Chunk the burst: every consecutive queued env-free
                    # normal task shares ONE permit/thread/executor hop and
                    # completes on one tick (so result notifies coalesce).
                    # A blocking task stalls only its chunk-mates — still
                    # strictly more concurrent than the reference's
                    # one-task-at-a-time worker; the remaining permits keep
                    # serving later chunks in parallel.
                    chunk = [(spec, reply_fut)]
                    while len(chunk) < 64:
                        try:
                            nspec, nfut = self._exec_queue.get_nowait()
                        except asyncio.QueueEmpty:
                            break
                        if nspec.task_type == TaskType.NORMAL_TASK and \
                                not nspec.runtime_env:
                            chunk.append((nspec, nfut))
                        else:
                            held = (nspec, nfut)
                            break
                    asyncio.get_event_loop().create_task(
                        self._run_normal_chunk(chunk))
            else:
                await self._run_one(spec, reply_fut, release=False)

    def _complete_chunk_item(self, spec: TaskSpec, fut, result: dict) -> None:
        """Per-task completion for chunked execution (runs on the IO loop;
        the done-buffer coalesces same-tick completions into one frame)."""
        if result.get("status") == "ok":
            self.emit_task_event(spec, "FINISHED")
        elif RayConfig.task_events_enabled:
            err_repr = None
            if result.get("error"):
                try:
                    err_repr = repr(pickle.loads(result["error"]))
                except Exception:  # an unpicklable user error must not kill
                    err_repr = "<error not unpicklable>"  # the loop
            self.emit_task_event(spec, "FAILED", error=err_repr)
        if not fut.done():
            fut.set_result(result)

    def _run_spec_chunk_sync(self, chunk, invoke) -> None:
        """Body shared by actor/normal chunked execution: runs on ONE
        executor thread; each task's completion is delivered to the loop as
        it finishes, so a slow task never delays the results of the tasks
        that ran before it."""
        loop = self.io.loop
        for item in chunk:
            spec, fut = item[0], item[1]
            started = time.time()
            # Emitted from the executor thread at actual start (deque.append
            # is thread-safe) so a hung task is visible as RUNNING in the
            # state API, not stuck at SUBMITTED.
            self.emit_task_event(spec, "RUNNING", ts=started)
            try:
                result = invoke(item)
            except BaseException as e:  # never kill the chunk
                result = {"status": "error", "error": _dumps_ctrl(
                    RayTaskError.from_exception(spec.name, e))}
            loop.call_soon_threadsafe(
                self._complete_chunk_item, spec, fut, result)

    async def _run_chunk(self, chunk) -> None:
        """Execute consecutive sync actor methods in one executor call."""
        loop = asyncio.get_event_loop()
        await loop.run_in_executor(
            self.executor_pool, self._run_spec_chunk_sync, chunk,
            lambda item: self._invoke_sync(item[0], item[2]))

    # A normal-task chunk whose current item runs longer than this has its
    # not-yet-started tail stolen onto another thread, so a task that blocks
    # (e.g. on a nested get, or waiting for a signal sent by a chunk-mate
    # queued behind it) can never wedge the tasks packed after it.
    _CHUNK_STALL_STEAL_S = 0.1

    async def _run_normal_chunk(self, chunk) -> None:
        """Run consecutive env-free normal tasks on one executor thread,
        holding one pipeline permit for the whole chunk."""
        loop = asyncio.get_event_loop()
        run = {"items": chunk, "next": 0, "cur_start": None, "done": False}
        lock = threading.Lock()

        def deliver(spec, fut, result):
            # absorb a stray async cancellation raise landing exactly here:
            # the completion must reach the loop or the caller hangs
            while True:
                try:
                    loop.call_soon_threadsafe(
                        self._complete_chunk_item, spec, fut, result)
                    return
                except TaskCancelledError:
                    continue

        def body():
            while True:
                try:
                    with lock:
                        if run["next"] >= len(run["items"]):
                            return
                        item = run["items"][run["next"]]
                        run["next"] += 1
                        run["cur_start"] = time.monotonic()
                except TaskCancelledError:
                    continue  # stray cancel raise between items: no item held
                spec, fut = item
                result = None
                try:
                    # thread-safe deque append: RUNNING is visible while the
                    # task executes, not backdated at completion
                    self.emit_task_event(spec, "RUNNING")
                    result = self._invoke_normal_sync(spec)
                except BaseException as e:  # never kill the chunk — incl. a
                    # cancellation raise delivered outside the invoke proper
                    result = {"status": "error",
                              "cancelled": isinstance(e, TaskCancelledError),
                              "error": _dumps_ctrl(
                                  RayTaskError.from_exception(spec.name, e)
                                  if not isinstance(e, TaskCancelledError)
                                  else e)}
                finally:
                    if result is None:  # belt: a raise past both handlers
                        result = {"status": "error", "error": _dumps_ctrl(
                            RaySystemError("task result lost to a stray "
                                           "cancellation race"))}
                    deliver(spec, fut, result)

        def watchdog():
            if run["done"]:
                return
            steal = None
            with lock:
                cs = run["cur_start"]
                if cs is not None and \
                        time.monotonic() - cs > self._CHUNK_STALL_STEAL_S and \
                        run["next"] < len(run["items"]):
                    steal = run["items"][run["next"]:]
                    run["items"] = run["items"][:run["next"]]
            if steal:
                loop.create_task(self._respawn_chunk(steal))
                return  # nothing left to guard
            loop.call_later(self._CHUNK_STALL_STEAL_S, watchdog)

        loop.call_later(self._CHUNK_STALL_STEAL_S, watchdog)
        try:
            await loop.run_in_executor(self.executor_pool, body)
        finally:
            run["done"] = True
            if self._task_sem is not None:
                self._task_sem.release()

    async def _respawn_chunk(self, chunk) -> None:
        """Continue a stolen chunk tail under its own permit/thread."""
        await self._task_sem.acquire()
        await self._run_normal_chunk(chunk)

    async def _run_one(self, spec: TaskSpec, reply_fut: asyncio.Future,
                       release: bool = False, release_task: bool = False):
        self.emit_task_event(spec, "RUNNING")
        try:
            result = await self._execute_spec(spec)
        except BaseException as e:  # never kill the loop
            result = {"status": "error", "error": _dumps_ctrl(
                RayTaskError.from_exception(spec.name, e))}
        finally:
            if release and self._actor_sem is not None:
                self._actor_sem.release()
            if release_task and self._task_sem is not None:
                self._task_sem.release()
        if result.get("status") == "ok":
            self.emit_task_event(spec, "FINISHED")
        elif RayConfig.task_events_enabled:
            err_repr = None
            if result.get("error"):
                try:
                    err_repr = repr(pickle.loads(result["error"]))
                except Exception:  # an unpicklable user error must not kill
                    err_repr = "<error not unpicklable>"  # the dispatch loop
            self.emit_task_event(spec, "FAILED", error=err_repr)
        if not reply_fut.done():
            reply_fut.set_result(result)

    async def rpc_push_task(self, conn, payload):
        """Execute a task pushed by a submitter or the GCS (actor creation).
        (reference: CoreWorker::HandlePushTask core_worker.cc:3484)"""
        spec: TaskSpec = pickle.loads(payload)
        loop = asyncio.get_event_loop()
        reply_fut = loop.create_future()
        await self._exec_queue.put((spec, reply_fut))
        return await reply_fut

    async def rpc_push_task_batch(self, conn, payload):
        """One-way batched task push: N specs in one frame; each completion
        flows back as a coalesced ``tasks_done`` notify on the same
        connection.  This is the hot submission path — the request/response
        ``push_task`` costs two frames and an asyncio task per call, which
        caps a pure-Python control plane far below the reference's C++ core
        (reference: batched lease pipelining in NormalTaskSubmitter,
        transport/normal_task_submitter.h:75)."""
        specs: List[TaskSpec] = pickle.loads(payload)
        loop = asyncio.get_event_loop()
        for spec in specs:
            reply_fut = loop.create_future()
            reply_fut.add_done_callback(
                lambda f, s=spec: self._buffer_done(conn, s, f))
            await self._exec_queue.put((spec, reply_fut))

    def _buffer_done(self, conn, spec: TaskSpec, fut) -> None:
        try:
            result = dict(fut.result())
        except BaseException as e:  # never lose a completion
            result = {"status": "error", "error": _dumps_ctrl(
                RayTaskError.from_exception(spec.name, e))}
        result["task_id"] = spec.task_id.binary()
        buf = self._done_buf.get(conn)
        if buf is None:
            self._done_buf[conn] = [result]
            asyncio.get_event_loop().call_soon(self._flush_done, conn)
        else:
            buf.append(result)

    def _flush_done(self, conn) -> None:
        items = self._done_buf.pop(conn, None)
        if not items or conn.closed:
            return

        async def _send():
            try:
                await conn.notify("tasks_done", items)
            except (ConnectionError, rpc.ConnectionLost):
                pass  # caller died; its inflight map dies with it

        asyncio.get_event_loop().create_task(_send())

    async def rpc_tasks_done(self, conn, items):
        """Submitter side of the batched path: route each completed item to
        the callback registered at send time."""
        tset = self._conn_tasks.get(conn)
        for item in items:
            tkey = item["task_id"]
            if tset is not None:
                tset.discard(tkey)
            cb = self._completion_router.pop(tkey, None)
            if cb is not None:
                cb(item)

    def _on_worker_conn_lost(self, conn) -> None:
        """A pooled worker connection died: deliver a synthetic 'lost' item
        to every normal task that was inflight on it (runs on the IO loop)."""
        for tkey in self._conn_tasks.pop(conn, ()):
            cb = self._completion_router.pop(tkey, None)
            if cb is not None:
                cb({"task_id": tkey, "status": "lost"})

    def _load_function(self, spec: TaskSpec):
        if spec.function_blob is not None:
            # Cache by blob bytes: a submitter pickles its function once, so
            # repeated tasks carry an identical blob — un-pickling it per
            # task cost ~0.3ms/call on noop storms.  Bounded: a driver
            # minting fresh closures per submission must not grow a
            # long-lived worker without limit.
            fn = self._fn_cache.get(spec.function_blob)
            if fn is None:
                fn = cloudpickle.loads(spec.function_blob)
                if len(self._fn_cache) >= 512:
                    self._fn_cache.clear()
                self._fn_cache[spec.function_blob] = fn
            return fn
        key = spec.function_key
        fn = self._fn_cache.get(key)
        if fn is None:
            blob = self.io.run(self.gcs_conn.call("kv_get", {"ns": "fn", "key": key}))
            if blob is None:
                raise RaySystemError(f"function {key} missing from GCS function table")
            fn = cloudpickle.loads(blob)
            self._fn_cache[key] = fn
        return fn

    def _resolve_args(self, spec: TaskSpec) -> Tuple[list, dict]:
        vals = []
        for a in spec.args:
            if isinstance(a, InlineArg):
                vals.append(self.ctx.deserialize(
                    SerializedObject(a.inband, [memoryview(b) for b in a.buffers])))
            else:
                ref = ObjectRef(a.object_id, a.owner_addr, a.owner_worker_id)
                vals.append(self._resolve_one(ref))
        n_kw = len(spec.kwargs_keys)
        if n_kw:
            pos, kw_vals = vals[:-n_kw], vals[-n_kw:]
            return pos, dict(zip(spec.kwargs_keys, kw_vals))
        return vals, {}

    async def _execute_spec(self, spec: TaskSpec) -> dict:
        loop = asyncio.get_event_loop()
        if spec.task_type == TaskType.ACTOR_CREATION_TASK:
            # dedicated single thread from __init__ onward: a reused task
            # worker's depth-wide pool would run successive (serialized)
            # actor methods on DIFFERENT threads, breaking thread-affine
            # state like sqlite handles (async actors re-widen later)
            old_pool = self.executor_pool
            self.executor_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="rtpu-actor-exec")
            if old_pool is not None:
                # Don't leak the depth-wide task pool's idle threads for the
                # actor's lifetime; non-blocking so an in-flight normal task
                # can still drain.
                old_pool.shutdown(wait=False)
            return await loop.run_in_executor(self.executor_pool, self._create_actor_sync, spec)
        if spec.task_type == TaskType.ACTOR_TASK:
            if spec.actor_method_name == "__ray_tpu_channel_loop__":
                # compiled-DAG takeover (reference: compiled_dag_node actor
                # loop): this task holds the actor and serves its node's
                # shm channels until teardown closes them
                return await loop.run_in_executor(
                    self.executor_pool, self._run_channel_loop, spec)
            method = getattr(self.actor_instance, spec.actor_method_name, None)
            if self.actor_instance is None or method is None:
                err = RayActorError(spec.actor_id,
                                    f"actor has no method {spec.actor_method_name!r}"
                                    if self.actor_instance is not None else "actor not initialized")
                return {"status": "error", "error": _dumps_ctrl(err)}
            if asyncio.iscoroutinefunction(method):
                return await self._invoke_async(spec, method)
            return await loop.run_in_executor(
                self.executor_pool, self._invoke_sync, spec, method)
        # Function load included in the executor hop: on a cache miss it does
        # a blocking kv_get, which would deadlock if run on the IO loop.
        return await loop.run_in_executor(
            self.executor_pool, self._invoke_normal_sync, spec)

    def _run_channel_loop(self, spec: TaskSpec) -> dict:
        """Serve one compiled-DAG node: read input channels, run the bound
        method, write every out-edge — no runtime involvement per message
        (reference: CompiledDAG's actor execution loop,
        dag/compiled_dag_node.py:480)."""
        from ray_tpu_torch.dag.compiled import DagError
        from ray_tpu_torch.experimental.channel import ChannelClosed, open_channel

        opened: list = []
        outs: list = []
        try:
            args, _ = self._resolve_args(spec)
            cfg = args[0]
            # one loop serves ALL of this actor's compiled nodes, in the
            # topological order the compiler recorded
            node_cfgs = cfg["nodes"] if "nodes" in cfg else [cfg]
            plans = []
            for nc in node_cfgs:
                srcs: list = []
                for kind, v in nc["args"]:
                    if kind == "ch":
                        ch = open_channel(v, "r")
                        opened.append(ch)
                        srcs.append(ch)
                    else:
                        srcs.append((v,))  # constant, pre-wrapped
                node_outs = [open_channel(n, "w") for n in nc["out"]]
                opened.extend(node_outs)
                outs.extend(node_outs)
                plans.append((getattr(self.actor_instance, nc["method"]),
                              srcs, nc.get("kwargs") or {}, node_outs))
            closed = False
            while not closed:
                for method, srcs, kwargs, node_outs in plans:
                    vals = []
                    err = None
                    for src in srcs:
                        if isinstance(src, tuple):
                            vals.append(src[0])
                            continue
                        try:
                            item = src.read()
                        except ChannelClosed:
                            closed = True
                            break
                        if isinstance(item, DagError) and err is None:
                            err = item  # pass the upstream failure through
                        vals.append(item)
                    if closed:
                        break
                    if err is not None:
                        res = err
                    else:
                        try:
                            res = method(*vals, **kwargs)
                        except BaseException as e:
                            res = DagError(e)
                    # one serialize per message, however many out edges; the
                    # frame scatter-gathers into each channel with pickle-5
                    # OOB buffers (no flatten)
                    ser = self.ctx.serialize(res)
                    for o in node_outs:
                        o.write_serialized(ser)
            return self._pack_returns(spec, None)
        except BaseException as e:
            return {"status": "error", "error": _dumps_ctrl(
                RayTaskError.from_exception(spec.name, e))}
        finally:
            # ALWAYS propagate EOF downstream — an error path that skipped
            # close_write would leave downstream loops and the driver
            # blocked forever
            for o in outs:
                try:
                    o.close_write()
                except Exception:
                    pass
            for ch in opened:
                try:
                    ch.close()
                except Exception:
                    pass

    def _invoke_normal_sync(self, spec: TaskSpec) -> dict:
        from ray_tpu_torch import runtime_env as renv

        tkey = spec.task_id.binary()
        if tkey in self._cancelled_exec:
            # cancelled while queued on this worker: never starts
            self._cancelled_exec.discard(tkey)
            return {"status": "error", "cancelled": True,
                    "error": _dumps_ctrl(TaskCancelledError(
                        f"task {spec.name} was cancelled before it started"))}
        self._running_threads[tkey] = threading.get_ident()
        try:
            # Env applied around BOTH function load and invocation: cloudpickle
            # resolves by-reference functions at load time, so working_dir /
            # py_modules must already be on sys.path there.
            with renv.applied(spec.runtime_env):
                try:
                    fn = self._load_function(spec)
                except BaseException as e:
                    return {"status": "error", "error": _dumps_ctrl(
                        RayTaskError.from_exception(spec.name, e))}
                return self._invoke_sync(spec, fn)
        except TaskCancelledError as e:
            return {"status": "error", "cancelled": True,
                    "error": _dumps_ctrl(e)}
        except BaseException as e:  # env setup itself failed
            return {"status": "error",
                    "error": _dumps_ctrl(RayTaskError.from_exception(spec.name, e))}
        finally:
            self._running_threads.pop(tkey, None)
            self._cancelled_exec.discard(tkey)

    def _create_actor_sync(self, spec: TaskSpec) -> dict:
        try:
            from ray_tpu_torch import runtime_env as renv

            # Dedicated worker: the env holds for the actor's whole life.
            renv.apply_permanent(spec.runtime_env)
            cls = self._load_function(spec)
            args, kwargs = self._resolve_args(spec)
        except BaseException as e:
            return {"status": "error",
                    "error": _dumps_ctrl(RayTaskError.from_exception(spec.name, e))}
        self.task_ctx.task_id = spec.task_id
        self.task_ctx.job_id = spec.job_id
        self.task_ctx.actor_id = spec.actor_creation_id
        trace_token = _trace_ctx.set((spec.trace_id, spec.span_id))
        try:
            self.actor_instance = cls(*args, **kwargs)
        except BaseException as e:
            return {"status": "error",
                    "error": _dumps_ctrl(RayTaskError.from_exception(spec.name, e))}
        finally:
            # always restore: a failed constructor must not leave the
            # creation span as this executor thread's ambient context
            _trace_ctx.reset(trace_token)
        self.actor_id = spec.actor_creation_id
        self.job_id = spec.job_id
        if spec.max_concurrency > 1:
            from ray_tpu_torch._private import race_detector

            if race_detector.enabled():
                # sanitizer: catch unsynchronized concurrent writes to
                # actor state under threaded execution (SURVEY §5.2)
                self.actor_instance = race_detector.wrap_instance(
                    self.actor_instance)
                self._race_guard = race_detector._MethodGuard
        if spec.max_concurrency > 1 or _has_async_methods(type(self.actor_instance)):
            # Async actors default to high concurrency (reference: actor.py —
            # async actors get max_concurrency=1000 unless set explicitly).
            conc = spec.max_concurrency if spec.max_concurrency > 1 else 1000
            self._actor_sem = asyncio.Semaphore(conc)
            old_pool = self.executor_pool
            self.executor_pool = ThreadPoolExecutor(
                max_workers=conc, thread_name_prefix="rtpu-actor")
            if old_pool is not None:
                old_pool.shutdown(wait=False)
        return {"status": "ok", "returns": []}

    def _invoke_sync(self, spec: TaskSpec, fn) -> dict:
        tkey = spec.task_id.binary()
        if tkey in self._cancelled_exec:
            # cancelled while queued on this worker (sync actor methods
            # included): never starts
            self._cancelled_exec.discard(tkey)
            return {"status": "error", "cancelled": True,
                    "error": _dumps_ctrl(TaskCancelledError(
                        f"task {spec.name} was cancelled before it started"))}
        self.task_ctx.task_id = spec.task_id
        self.task_ctx.job_id = spec.job_id
        self.task_ctx.task_name = spec.name
        self.task_ctx.attempt_number = spec.attempt_number
        self._track_task_start(spec, threading.get_ident())
        if flight_recorder.RECORDING:
            flight_recorder.record(
                "task.start", f"{spec.name}#a{spec.attempt_number}")
        trace_token = _trace_ctx.set((spec.trace_id, spec.span_id))
        if self.job_id.int_value() == 0:
            self.job_id = spec.job_id
        try:
            # Runtime env is already active here: applied by _invoke_normal_sync
            # (leased task workers, save/restore) or permanently at actor
            # creation (dedicated workers).
            t0 = time.time()
            args, kwargs = self._resolve_args(spec)
            if fault_injection.ENABLED and fault_injection.hit(
                    "worker.pre_exec", detail=spec.name) == "kill":
                fault_injection.kill_self()
            if self._race_guard is not None and self.actor_instance is not None:
                with self._race_guard(self.actor_instance,
                                      spec.actor_method_name or spec.name):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            if fault_injection.ENABLED and fault_injection.hit(
                    "worker.post_exec", detail=spec.name) == "kill":
                fault_injection.kill_self()
            t1 = time.time()
            result = self._pack_returns(spec, out)
            t2 = time.time()
            # executor phase stamps: (exec_start_ts, done_ts, result_put_s);
            # the caller folds them against its own submit/ship/recv stamps
            result["phases"] = (t0, t2, t2 - t1)
            return result
        except TaskCancelledError:
            raise  # surfaces as a cancelled (non-retriable) completion
        except BaseException as e:
            return {"status": "error",
                    "error": _dumps_ctrl(RayTaskError.from_exception(spec.name, e))}
        finally:
            self.task_ctx.task_id = None
            self._track_task_end(spec)
            if flight_recorder.RECORDING:
                flight_recorder.record("task.end", spec.name)
            _trace_ctx.reset(trace_token)

    async def _invoke_async(self, spec: TaskSpec, method) -> dict:
        trace_token = _trace_ctx.set((spec.trace_id, spec.span_id))
        tkey = spec.task_id.binary()
        if tkey in self._cancelled_exec:
            self._cancelled_exec.discard(tkey)
            _trace_ctx.reset(trace_token)
            return {"status": "error", "cancelled": True,
                    "error": _dumps_ctrl(TaskCancelledError(
                        f"task {spec.name} was cancelled before it started"))}
        # thread=None: async tasks share the IO loop thread, so stack
        # attribution is via the running-task list, not a thread id
        self._track_task_start(spec, None)
        try:
            loop = asyncio.get_event_loop()
            t0 = time.time()
            args, kwargs = await loop.run_in_executor(None, self._resolve_args, spec)
            # async actor tasks are cancellable (reference: asyncio-actor
            # cancellation): register so rpc_cancel_task can .cancel() us
            self._running_async[tkey] = asyncio.current_task()
            if tkey in self._cancelled_exec:
                # cancel landed while _resolve_args ran (pre-registration
                # window): honor it before starting the method
                self._running_async.pop(tkey, None)
                self._cancelled_exec.discard(tkey)
                return {"status": "error", "cancelled": True,
                        "error": _dumps_ctrl(TaskCancelledError(
                            f"task {spec.name} was cancelled"))}
            try:
                out = await method(*args, **kwargs)
            except asyncio.CancelledError:
                cur = asyncio.current_task()
                if cur is not None and hasattr(cur, "uncancel"):
                    cur.uncancel()  # absorb: the loop task must survive
                return {"status": "error", "cancelled": True,
                        "error": _dumps_ctrl(TaskCancelledError(
                            f"actor task {spec.name} was cancelled"))}
            finally:
                self._running_async.pop(tkey, None)
                self._cancelled_exec.discard(tkey)
            # _pack_returns can block on plasma.put (large returns) — must not
            # run on the IO loop it would be waiting on.
            t1 = time.time()
            result = await loop.run_in_executor(
                None, self._pack_returns, spec, out)
            t2 = time.time()
            result["phases"] = (t0, t2, t2 - t1)
            return result
        except BaseException as e:
            return {"status": "error",
                    "error": _dumps_ctrl(RayTaskError.from_exception(spec.name, e))}
        finally:
            self._track_task_end(spec)
            _trace_ctx.reset(trace_token)

    def _pack_returns(self, spec: TaskSpec, out) -> dict:
        if spec.num_returns == 0:
            return {"status": "ok", "returns": []}
        if spec.num_returns == -1:
            return self._pack_dynamic_returns(spec, out)
        if spec.num_returns == 1:
            outs = [out]
        else:
            outs = list(out)
            if len(outs) != spec.num_returns:
                raise ValueError(
                    f"task {spec.name} declared num_returns={spec.num_returns} "
                    f"but returned {len(outs)} values")
        returns = []
        for oid, value in zip(spec.return_ids(), outs):
            ser = self.ctx.serialize(value)
            contained = []
            for cref in ser.contained_refs:
                # Pin returned refs under a synthetic borrower (the task id)
                # until the caller registers its own holds in complete_task —
                # otherwise the owner can free the inner object in the window
                # between this reply and the caller's borrow registration
                # (reference: reference_count.h borrower protocol for refs
                # nested in task returns).
                contained.append((cref.oid.binary(), cref.owner_addr(),
                                  cref.owner_worker_id()))
                self._pin_returned_ref(cref, spec.task_id.binary())
            returns.append(self._pack_one_return(oid, ser, contained))
        return {"status": "ok", "returns": returns}

    def _pack_one_return(self, oid: ObjectID, ser, contained,
                         force_plasma: bool = False) -> tuple:
        """One return entry in the completion wire format (shared by fixed
        and dynamic packing)."""
        if force_plasma or \
                ser.total_bytes() > RayConfig.max_direct_call_object_size:
            self.plasma.put_serialized(oid, ser)
            return (oid.binary(), "plasma", ser.total_bytes(), contained)
        bufs, copied = freeze_buffers(ser.buffers)
        if copied:
            self._m_put_copies.inc(copied)
        return (oid.binary(), "val", ser.inband, bufs, contained)

    def _pack_dynamic_returns(self, spec: TaskSpec, out) -> dict:
        """num_returns='dynamic': drain the generator; each yielded item
        becomes its own caller-owned object (indices 1..N), and the primary
        return (index 0) is the list of their (oid, owner) descriptors the
        ObjectRefGenerator materializes driver-side (reference:
        num_returns='dynamic' — refs available when the task completes).

        ``spec.stream_returns`` (num_returns='streaming') forces every item
        into plasma at yield time regardless of size: the item is visible to
        the caller's speculative refs the moment it is sealed, which is what
        lets ObjectRefGenerator.stream() consume a long-running generator
        WHILE it is still producing."""
        returns = []
        metas = []
        put_in_plasma = []
        stream = bool(getattr(spec, "stream_returns", False))
        try:
            for i, value in enumerate(out):
                oid = ObjectID.from_task(spec.task_id, i + 1)
                ser = self.ctx.serialize(value)
                if ser.contained_refs:
                    raise ValueError(
                        "ObjectRefs nested inside dynamically yielded "
                        "values are not supported yet")
                entry = self._pack_one_return(oid, ser, (),
                                              force_plasma=stream)
                if entry[1] == "plasma":
                    put_in_plasma.append(oid)
                returns.append(entry)
                metas.append((oid.binary(), tuple(spec.owner_addr),
                              spec.owner_worker_id))
        except BaseException:
            # mid-generation failure: already-written plasma copies would
            # otherwise leak until job end (the owner never learns of them)
            for oid in put_in_plasma:
                try:
                    self.plasma.free([oid])
                except Exception:
                    pass
            raise
        primary = spec.return_ids()[0]
        pser = self.ctx.serialize(metas)
        pbufs, pcopied = freeze_buffers(pser.buffers)
        if pcopied:
            self._m_put_copies.inc(pcopied)
        returns.append((primary.binary(), "val", pser.inband, pbufs, ()))
        return {"status": "ok", "returns": returns}

    def _pin_returned_ref(self, cref, token: bytes) -> None:
        owner_wid = cref.owner_worker_id()
        # Unregistered descriptor only: holding the live ObjectRef here would
        # keep a local ref (and thus the object) alive for the whole TTL.
        self._return_pins.append(
            (time.monotonic(),
             ObjectRef(cref.oid, cref.owner_addr(), owner_wid,
                       _register=False),
             token))
        if owner_wid is None or owner_wid == self.worker_id.binary():
            self.ref_counter.add_borrower(cref.oid, token)
            return
        # We are only a borrower of the returned ref: register the token with
        # the true owner while our own borrow still protects the object.
        try:
            self._owner_conn(tuple(cref.owner_addr())).call_sync(
                "ref_borrow", {"action": "add", "oid": cref.oid.binary(),
                               "borrower": token},
                timeout=RayConfig.gcs_rpc_timeout_s)
        except (rpc.ConnectionLost, ConnectionError, asyncio.TimeoutError):
            pass  # owner gone: the ref is doomed regardless


def _has_async_methods(cls) -> bool:
    return any(asyncio.iscoroutinefunction(getattr(cls, n, None)) for n in dir(cls)
               if not n.startswith("__"))


def self_addr_key(addr) -> Tuple[str, int]:
    return tuple(addr)


# ============================================================== submitters
class NormalTaskSubmitter:
    """Lease-based task submission with worker reuse and spillback
    (reference: transport/normal_task_submitter.h:75)."""

    def __init__(self, cw: CoreWorker):
        self.cw = cw
        self.classes: Dict[tuple, dict] = {}
        self._pg_node_cache: Dict[bytes, Tuple[float, dict]] = {}
        # Staged submissions: `.remote()` appends here from the caller's
        # thread; one IO-loop wakeup drains the whole burst (mirrors
        # ActorTaskSubmitter.enqueue).
        self._stage: deque = deque()
        self._stage_lock = threading.Lock()
        self._stage_scheduled = False
        # Lease cache: dispatches served by an already-held (warm) lease vs
        # leases requested from the nodelet — the measure of how often the
        # hot path skips the per-task lease round trip.
        from ray_tpu_torch._private.metrics import Counter

        self._m_lease_cache = Counter(
            "lease_cache_hits",
            "task dispatches onto an already-held worker lease")
        self._m_lease_requests = Counter(
            "lease_requests", "worker-lease requests sent to a nodelet")

    # ------------------------------------------------------- staged enqueue
    def enqueue(self, spec: TaskSpec, holds) -> None:
        """Called from any thread.  At most one IO-loop wakeup per burst."""
        with self._stage_lock:
            self._stage.append((spec, holds))
            if self._stage_scheduled:
                return
            self._stage_scheduled = True
        self.cw.io.loop.call_soon_threadsafe(self._start_stage_drain)

    def _start_stage_drain(self) -> None:
        asyncio.get_event_loop().create_task(self._drain_stage())

    def _has_pending_deps(self, spec: TaskSpec) -> bool:
        ms = self.cw.memory_store
        my_id = self.cw.worker_id.binary()
        for a in spec.args:
            if isinstance(a, RefArg) and a.owner_worker_id == my_id and \
                    ms.known(a.object_id) and not ms.contains(a.object_id):
                return True
        return False

    async def _drain_stage(self) -> None:
        loop = asyncio.get_event_loop()
        while True:
            with self._stage_lock:
                items = list(self._stage)
                self._stage.clear()
                if not items:
                    self._stage_scheduled = False
                    return
            touched: Dict[tuple, dict] = {}
            for spec, holds in items:
                if self._has_pending_deps(spec):
                    # The dep may be produced by a task staged BEHIND this
                    # one (or pumped only below): waiting inline would
                    # deadlock the drainer — and with it every later
                    # submission in the process.
                    loop.create_task(self.submit(spec, holds))
                    continue
                try:
                    await self._resolve_local_deps(spec)
                except BaseException as e:
                    self.cw.fail_task(spec, RaySystemError(
                        f"dependency resolution failed: {e!r}"), holds)
                    continue
                key = spec.scheduling_class()
                st = self._class(key)
                st["pending"].append((spec, holds))
                touched[key] = st
            for key, st in touched.items():
                await self._pump(key, st)

    def _class(self, key) -> dict:
        st = self.classes.get(key)
        if st is None:
            st = self.classes[key] = {
                "pending": deque(), "idle": [], "inflight": 0, "busy": 0,
                # outstanding lease-request token -> nodelet conn, so a
                # drained queue can cancel them (otherwise the nodelet keeps
                # spawning workers for demand that no longer exists)
                "tokens": {},
            }
        return st

    async def submit(self, spec: TaskSpec, holds: List[ObjectRef]):
        try:
            await self._resolve_local_deps(spec)
        except BaseException as e:
            self.cw.fail_task(spec, RaySystemError(f"dependency resolution failed: {e!r}"), holds)
            return
        key = spec.scheduling_class()
        st = self._class(key)
        st["pending"].append((spec, holds))
        await self._pump(key, st)

    async def _resolve_local_deps(self, spec: TaskSpec):
        """Wait for owned pending deps; inline those that resolved small
        (reference: LocalDependencyResolver)."""
        loop = asyncio.get_event_loop()
        for i, a in enumerate(spec.args):
            if not isinstance(a, RefArg):
                continue
            if a.owner_worker_id != self.cw.worker_id.binary():
                continue
            ms = self.cw.memory_store
            if not ms.known(a.object_id):
                continue
            if not ms.contains(a.object_id):
                fut = loop.create_future()
                already = ms.add_ready_callback(
                    a.object_id,
                    lambda: loop.call_soon_threadsafe(
                        lambda: fut.done() or fut.set_result(True)))
                if not already:
                    await fut
            ok, value, err = ms.get_if_ready(a.object_id)
            if err is not None:
                raise err
            if isinstance(value, SerializedObject) and not value.contained_refs:
                bufs, copied = freeze_buffers(value.buffers)
                if copied:
                    self.cw._m_put_copies.inc(copied)
                spec.args[i] = InlineArg(value.inband, bufs)

    async def _pump(self, key, st):
        # Pipelined dispatch: a lease accepts up to lease_pipeline_depth
        # in-flight tasks (the worker's exec queue serializes them), so
        # submission overhead overlaps execution instead of paying a full
        # round trip per task (reference: NormalTaskSubmitter pipelining on
        # leased-worker connections).
        depth = RayConfig.lease_pipeline_depth
        while st["pending"] and st["idle"]:
            # cancel marker check at the dispatch choke point: covers tasks
            # that were dep-blocked (invisible to _cancel_async's queue
            # scans) when the user cancelled them
            spec0 = st["pending"][0][0]
            if spec0.task_id.binary() in self.cw._cancelled_tasks:
                spec, holds = st["pending"].popleft()
                self.cw._cancelled_tasks.discard(spec.task_id.binary())
                self.cw.fail_task(spec, TaskCancelledError(
                    f"task {spec.name} was cancelled"), holds)
                continue
            lease = st["idle"].pop()
            if lease.get("returned"):
                continue  # raced with _return_idle: worker no longer ours
            spec, holds = st["pending"].popleft()
            lease["inflight"] = lease.get("inflight", 0) + 1
            if lease["inflight"] < depth:
                # spare capacity: keep dispatchable.  LIFO on purpose: PACK a
                # lease up to depth before touching the next one — fewer hot
                # worker processes beats even spreading (saturated leases drop
                # out of idle, so overflow spills to the next worker anyway)
                st["idle"].append(lease)
            self._queue_push(key, st, spec, holds, lease)
        # Lease-request parallelism beyond the host's cores only buys process
        # churn: every granted lease is a worker process contending for the
        # same CPUs (the config cap still bounds big hosts).
        max_pending = min(
            RayConfig.max_pending_lease_requests_per_scheduling_category,
            max(2, os.cpu_count() or 4))
        # Credit the pipeline capacity of leases we already hold: demand that
        # fits on existing workers must not spawn new ones (process churn
        # costs more than it buys, especially on small hosts).
        spare = sum(max(depth - l.get("inflight", 0), 0)
                    for l in st["idle"] if not l.get("returned"))
        effective = max(len(st["pending"]) - spare, 0)
        want = min(effective, max_pending) - st["inflight"]
        for _ in range(max(want, 0)):
            st["inflight"] += 1
            self._m_lease_requests.inc()
            asyncio.get_event_loop().create_task(self._request_lease(key, st))
        if not st["pending"]:
            self._cancel_outstanding_leases(st)
            if not st["busy"]:
                # Lease cache: don't return the workers the moment the queue
                # drains — the next `.remote()` burst (sync-call loops drain
                # after EVERY task) reuses the warm lease with zero nodelet
                # round trips.  The idle timer (or a nodelet reclaim hint
                # when someone queues on the held resources) frees them.
                self._schedule_idle_return(key, st)

    def _schedule_idle_return(self, key, st) -> None:
        """Arm (or re-arm) the cached-lease expiry for a drained class."""
        st["drained_at"] = time.monotonic()
        if st.get("idle_timer") or self.cw._shut:
            return
        st["idle_timer"] = True
        try:
            asyncio.get_event_loop().create_task(
                self._idle_return_timer(key, st))
        except RuntimeError:  # loop tearing down: leases die with the conn
            st["idle_timer"] = False

    async def _idle_return_timer(self, key, st) -> None:
        try:
            while True:
                drained = st.get("drained_at")
                if drained is None:
                    return  # new work arrived: the cache is earning its keep
                wait = drained + RayConfig.lease_cache_idle_s - time.monotonic()
                if wait > 0:
                    await asyncio.sleep(wait)
                    continue
                if not st["pending"] and not st["busy"]:
                    await self._return_idle(st)
                    st["drained_at"] = None
                return
        finally:
            st["idle_timer"] = False
            # re-arm if the class drained again while we were returning
            if st.get("drained_at") is not None and not st["pending"] \
                    and not st["busy"] and st["idle"] \
                    and not st.get("idle_timer"):
                self._schedule_idle_return(key, st)

    async def return_cached_leases(self) -> None:
        """Nodelet reclaim hint: something is queued behind resources our
        cached idle leases hold — hand every drained class's leases back
        now instead of waiting out the idle timer."""
        for key, st in list(self.classes.items()):
            if not st["pending"] and not st["busy"]:
                st["drained_at"] = None
                await self._return_idle(st)

    def _cancel_outstanding_leases(self, st) -> None:
        """Queue drained: tell nodelets to drop our still-queued lease
        requests (reference: CancelWorkerLease on queue drain)."""
        by_conn: Dict[object, list] = {}
        for token, conn in st["tokens"].items():
            by_conn.setdefault(conn, []).append(token)
        for conn, tokens in by_conn.items():
            async def _fire(conn=conn, tokens=tokens):
                try:
                    await conn.call("cancel_lease_requests", {"tokens": tokens})
                except (ConnectionError, asyncio.TimeoutError, rpc.ConnectionLost):
                    pass
            asyncio.get_event_loop().create_task(_fire())

    async def _return_idle(self, st):
        # Pipelining keeps a lease in "idle" while it still has tasks in
        # flight (spare capacity).  Returning such a lease would mark the
        # worker idle at the nodelet MID-TASK — it could then be leased to an
        # actor and two programs would share one process.  Only truly-empty
        # leases go back.
        # Partition synchronously BEFORE any await: leases re-added by a
        # concurrent _push_one during the awaits must not be double-returned,
        # and a returned lease must never re-enter circulation (the
        # "returned" flag is checked by _pump and _push_one).
        busy_leases = [l for l in st["idle"] if l.get("inflight", 0) > 0]
        to_return = [l for l in st["idle"]
                     if l.get("inflight", 0) == 0 and not l.get("returned")]
        st["idle"] = busy_leases
        for lease in to_return:
            lease["returned"] = True
        for lease in to_return:
            try:
                await lease["nodelet_conn"].call("return_worker", {"lease_id": lease["lease_id"]})
            except (ConnectionError, asyncio.TimeoutError):
                pass

    async def _lease_target(self, spec: TaskSpec) -> rpc.Connection:
        s = spec.scheduling_strategy
        if s.kind == "placement_group" and s.placement_group_id is not None:
            node = await self._bundle_node(s.placement_group_id, s.placement_group_bundle_index)
            if node is not None:
                return await self._nodelet_conn(tuple(node["addr"]))
        elif s.kind == "node_affinity" and s.node_id is not None:
            view = await self.cw.gcs_conn.call("get_cluster_view", None)
            for n in view:
                if n["node_id"] == s.node_id and n["alive"]:
                    return await self._nodelet_conn(tuple(n["addr"]))
            if not s.soft:
                raise RaySystemError("node affinity target is not alive")
        return self.cw.nodelet_conn

    async def _bundle_node(self, pg_id, index) -> Optional[dict]:
        info = await self.cw.gcs_conn.call("get_placement_group", {"pg_id": pg_id.binary()})
        if info is None or info["state"] != "CREATED":
            # Wait for the PG to be ready (tasks targeting a PG queue on it).
            await self.cw.gcs_conn.call("wait_placement_group_ready",
                                        {"pg_id": pg_id.binary(), "timeout": 60})
            info = await self.cw.gcs_conn.call("get_placement_group", {"pg_id": pg_id.binary()})
            if info is None:
                return None
        nodes = info["bundle_nodes"]
        if index < 0:
            # any-bundle: spread across the PG's nodes; the chosen nodelet
            # resolves to whichever of its local bundles has capacity.
            cands = sorted({n for n in nodes if n is not None})
            if not cands:
                return None
            nodes = [random.choice(cands)]
            idx = 0
        else:
            idx = index
        if idx >= len(nodes) or nodes[idx] is None:
            return None
        view = await self.cw.gcs_conn.call("get_cluster_view", None)
        for n in view:
            if n["node_id"] == nodes[idx]:
                return n
        return None

    async def _nodelet_conn(self, addr) -> rpc.Connection:
        conn = self.cw._nodelet_conns.get(tuple(addr))
        if conn is None or conn.closed:
            conn = await rpc.connect(*addr, name=f"->nodelet-{addr[1]}")
            # node-death crash consistency: cached idle leases pointing at
            # a dead nodelet must leave circulation the moment the conn
            # drops, or the next burst pushes tasks into a black hole
            conn._on_close = self._on_nodelet_conn_lost
            self.cw._nodelet_conns[tuple(addr)] = conn
        return conn

    def _on_nodelet_conn_lost(self, conn) -> None:
        """Runs on the IO loop when a remote nodelet's connection drops
        (node death / nodelet crash).  Invalidate every cached lease granted
        by that nodelet: mark them returned (so _pump and _push_one skip
        them) and re-pump each affected class so queued work re-leases on a
        surviving node."""
        inc = incidents.open_incident(
            "lease_cache", kind="nodelet_conn_lost", detail=conn.name)
        inc.stamp("detect")
        dropped = 0
        for addr, c in list(self.cw._nodelet_conns.items()):
            if c is conn:
                self.cw._nodelet_conns.pop(addr, None)
        for key, st in list(self.classes.items()):
            dead = [l for l in st["idle"] if l.get("nodelet_conn") is conn]
            if not dead:
                continue
            dropped += len(dead)
            for lease in dead:
                lease["returned"] = True
            st["idle"] = [l for l in st["idle"]
                          if l.get("nodelet_conn") is not conn]
            logger.info("dropped %d cached lease(s) from dead nodelet %s",
                        len(dead), conn.name)
            self._schedule_pump(key, st)
        # quarantine = cache purged; pumps re-lease on surviving nodes
        inc.stamp("quarantine")
        inc.detail = f"{conn.name}|dropped={dropped}"
        inc.close()

    async def _request_lease(self, key, st):
        import uuid

        outcome = "done"  # "done" | "granted" | "retry"
        token = uuid.uuid4().hex
        try:
            if not st["pending"]:
                return
            spec, _ = st["pending"][0]
            s = spec.scheduling_strategy
            bundle = None
            if s.kind == "placement_group" and s.placement_group_id is not None:
                # index -1 passes through: the nodelet resolves it to any local
                # bundle with capacity (reference: bundle_index=-1 semantics).
                bundle = (s.placement_group_id.binary(),
                          s.placement_group_bundle_index)
            conn = await self._lease_target(spec)
            from ray_tpu_torch import runtime_env as renv_mod

            ekey = renv_mod.env_key(spec.runtime_env)
            msg = {"resources": spec.resources,
                   "strategy": {"kind": s.kind, "node_id": s.node_id,
                                "soft": s.soft,
                                "label_selector": s.label_selector},
                   "bundle": bundle, "spillback_count": 0, "token": token,
                   "env_key": ekey,
                   "runtime_env": spec.runtime_env if ekey else None}
            spill_hops = 0
            while True:
                if spill_hops >= 8:
                    # pathological ping-pong: restart the chain from the
                    # preferred target instead of silently dropping the task
                    outcome = "retry"
                    return
                st["tokens"][token] = conn
                resp = await conn.call("request_worker_lease", msg, timeout=None)
                if resp["type"] == "cancelled":
                    # a task submitted during the cancel round-trip may be
                    # waiting on this slot — re-pump or it never gets a lease
                    outcome = "cancelled"
                    return
                st["tokens"].pop(token, None)
                if resp["type"] == "granted":
                    worker_conn = await self._worker_conn(tuple(resp["worker_addr"]))
                    lease = {"lease_id": resp["lease_id"], "worker_conn": worker_conn,
                             "worker_addr": tuple(resp["worker_addr"]),
                             "worker_id": resp["worker_id"], "nodelet_conn": conn}
                    st["idle"].append(lease)
                    outcome = "granted"
                    return
                if resp["type"] == "spillback":
                    conn = await self._nodelet_conn(tuple(resp["node_addr"]))
                    msg["spillback_count"] += 1
                    spill_hops += 1
                    continue
                if resp["type"] == "retry":
                    # No node fits TODAY: the demand is on the autoscaler's
                    # desk; keep the task pending and re-evaluate the cluster
                    # after a beat (reference: infeasible tasks stay queued —
                    # a node type may yet be launched for them).
                    await asyncio.sleep(resp.get("delay", 1.0))
                    msg["spillback_count"] = 0
                    conn = await self._lease_target(spec)
                    continue
                # terminal: infeasible resources or runtime-env setup failure
                if resp["type"] == "env_failed":
                    err: Exception = RuntimeEnvSetupError(
                        resp.get("reason", "runtime env setup failed"))
                else:
                    err = RaySystemError(
                        f"cannot schedule task: {resp.get('reason', 'infeasible resources')}")
                while st["pending"]:
                    sp, holds = st["pending"].popleft()
                    self.cw.fail_task(sp, err, holds)
                return
        except (ConnectionError, asyncio.TimeoutError) as e:
            if not self.cw._shut:
                logger.warning("lease request failed (will retry): %r", e)
                outcome = "retry"
        finally:
            st["tokens"].pop(token, None)
            st["inflight"] -= 1
            if outcome != "done":
                # "granted": pump to dispatch onto the new lease.
                # "retry"/"cancelled": without a re-pump, this class's pending
                # tasks would never get another lease request.
                async def _followup():
                    if outcome == "retry":
                        await asyncio.sleep(0.2)
                    await self._pump(key, st)
                asyncio.get_event_loop().create_task(_followup())

    async def _worker_conn(self, addr) -> rpc.Connection:
        conn = self.cw._worker_conns.get(tuple(addr))
        if conn is None or conn.closed:
            conn = await rpc.connect(*addr, name=f"->worker-{addr[1]}",
                                     handlers=self.cw._rpc_handlers)
            conn._on_close = self.cw._on_worker_conn_lost
            self.cw._worker_conns[tuple(addr)] = conn
            if conn.closed:
                # dropped in the attach window: the callback never re-fires
                self.cw._on_worker_conn_lost(conn)
        return conn

    # Batched dispatch: specs dispatched to the same lease within one loop
    # tick ride ONE push_task_batch frame; completions come back as coalesced
    # tasks_done notifies (see CoreWorker.rpc_push_task_batch).  The previous
    # call-per-task design cost two frames plus an asyncio task per task,
    # which capped async task throughput at ~11% of the reference baseline.
    def _queue_push(self, key, st, spec: TaskSpec, holds, lease) -> None:
        st["busy"] += 1
        st["drained_at"] = None  # the lease cache is live again
        self._m_lease_cache.inc()
        buf = lease.get("outbuf")
        if buf is None:
            lease["outbuf"] = [(spec, holds)]
            asyncio.get_event_loop().create_task(
                self._flush_push(key, st, lease))
        else:
            buf.append((spec, holds))

    async def _flush_push(self, key, st, lease) -> None:
        items = lease.pop("outbuf", None)
        if not items:
            return
        conn = lease["worker_conn"]
        if conn.closed:
            for spec, holds in items:
                self._normal_done(key, st, lease, spec, holds,
                                  {"status": "lost"})
            return
        ship = time.time()
        for spec, holds in items:
            tkey = spec.task_id.binary()
            if spec.phase_ts is not None:
                spec.phase_ts["ship"] = ship
            self.cw._completion_router[tkey] = (
                lambda item, s=spec, h=holds:
                self._normal_done(key, st, lease, s, h, item))
            self.cw._conn_tasks.setdefault(conn, set()).add(tkey)
        try:
            # protocol 5: InlineArg buffers are PickleBuffers (zero-copy at
            # build time); they serialize in-band here, one copy total.
            await conn.notify("push_task_batch",
                              _dumps_ctrl([s for s, _ in items]))
        except (rpc.ConnectionLost, ConnectionError):
            # the close callback (or this sweep, if it already ran) delivers
            # synthetic 'lost' items for everything registered above
            self.cw._on_worker_conn_lost(conn)

    def _normal_done(self, key, st, lease, spec: TaskSpec, holds,
                     item: dict) -> None:
        """Completion for one batched normal task (runs on the IO loop)."""
        worker_ok = True
        # a resolved task consumes its cancel marker (win or lose): the sets
        # must not grow forever under cancel-heavy workloads
        tkey = spec.task_id.binary()
        was_cancelled = tkey in self.cw._cancelled_tasks
        self.cw._cancelled_tasks.discard(tkey)
        if item["status"] == "ok":
            lost_at = getattr(spec, "_lost_at", None)
            if lost_at is not None:
                spec._lost_at = None
                # one-phase incident backdated to the loss: the retry's
                # landing IS the restored service (emits recovery_seconds)
                incidents.open_incident(
                    "task_retry", kind="worker_died", detail=spec.name,
                    started_mono=lost_at).close()
            self.cw._observe_phases(spec, item)
            self.cw.complete_task(spec, item["returns"], holds)
        elif item["status"] == "error":
            retriable = False
            if spec.retry_exceptions and spec.attempt_number < spec.max_retries \
                    and not item.get("cancelled"):
                # an explicitly cancelled task never retries (reference:
                # ray.cancel cancelled tasks are not retried)
                retriable = True
            if retriable:
                spec.attempt_number += 1
                spec.span_id = _fast_unique(8).hex()  # span per attempt
                # fresh phase clock: the retry's stage/dispatch must not be
                # measured from the ORIGINAL submission's stamps
                spec.phase_ts = {"submit": time.time(), "ser": 0.0}
                self.cw.emit_task_event(spec, "SUBMITTED")
                st["pending"].append((spec, holds))
            else:
                self.cw.complete_task(
                    spec, [(oid.binary(), "error", item["error"])
                           for oid in spec.return_ids()], holds)
        else:  # "lost": the worker connection died mid-task
            worker_ok = False
            # a deliberate memory-monitor kill (nodelet warned us first)
            # retries for free: pressure must not exhaust max_retries
            pressure = lease.get("worker_id") in self.cw._pressure_killed
            if was_cancelled:
                # force-cancel killed the worker: cancelled, never retried
                self.cw.fail_task(spec, TaskCancelledError(
                    f"task {spec.name} was cancelled (force)"), holds)
            elif pressure or spec.attempt_number < spec.max_retries:
                if not pressure:
                    spec.attempt_number += 1
                spec.span_id = _fast_unique(8).hex()  # span per attempt
                spec.phase_ts = {"submit": time.time(), "ser": 0.0}
                if getattr(spec, "_lost_at", None) is None:
                    spec._lost_at = time.monotonic()
                logger.info("retrying task %s (attempt %d) after worker failure",
                            spec.name, spec.attempt_number)
                self.cw.emit_task_event(spec, "SUBMITTED")
                self._requeue_after_backoff(key, st, spec, holds)
            else:
                self.cw.fail_task(spec, WorkerCrashedError(
                    f"worker died while running task {spec.name}"), holds)
        st["busy"] -= 1
        lease["inflight"] = max(lease.get("inflight", 1) - 1, 0)
        if worker_ok and not lease.get("returned") \
                and not any(l is lease for l in st["idle"]):
            st["idle"].append(lease)
        elif not worker_ok and any(l is lease for l in st["idle"]):
            st["idle"] = [l for l in st["idle"] if l is not lease]
        self._schedule_pump(key, st)

    def _requeue_after_backoff(self, key, st, spec: TaskSpec, holds) -> None:
        """Re-enqueue a task whose worker/node died, after an exponential
        backoff with jitter (runs on the IO loop).  Immediate resubmission
        turns one sick node into a retry storm: every attempt lands while
        the node is still shedding the dead worker's leases/extents and
        burns through max_retries before recovery (the standing
        memory-monitor flake was exactly this).  App-error retries skip the
        delay -- their worker is healthy."""
        base = RayConfig.task_retry_backoff_s
        if base <= 0:
            st["pending"].append((spec, holds))
            self._schedule_pump(key, st)
            return
        delay = min(base * (2 ** max(spec.attempt_number - 1, 0)),
                    RayConfig.task_retry_backoff_max_s)
        delay *= 0.75 + random.random() * 0.5  # +/-25% jitter desyncs herds

        def _fire():
            st["pending"].append((spec, holds))
            self._schedule_pump(key, st)

        asyncio.get_event_loop().call_later(delay, _fire)

    def _schedule_pump(self, key, st) -> None:
        """Coalesce pump wakeups: one per burst of completions, not one per
        task."""
        if st.get("pump_scheduled"):
            return
        st["pump_scheduled"] = True

        async def _p():
            st["pump_scheduled"] = False
            await self._pump(key, st)

        asyncio.get_event_loop().create_task(_p())


class ActorTaskSubmitter:
    """Direct actor-task submission over one persistent connection
    (reference: transport/actor_task_submitter.h:73).  Ordering: one TCP stream +
    in-order dispatch on the actor side replaces explicit sequence numbers for
    the common path; retries after restart re-enter the queue in order.

    Submission is BATCHED: ``.remote()`` (any thread) appends the spec to a
    queue and wakes the IO loop at most once per burst; the drain coroutine
    ships every queued spec in one ``push_task_batch`` frame, and completions
    return as coalesced one-way ``tasks_done`` notifies routed through
    ``CoreWorker._completion_router``.  This amortizes the two costs that
    dominated the per-call design — the cross-thread wakeup per ``.remote()``
    and the two frames + asyncio task per call — which held async actor
    throughput to ~20% of the reference's C++ core."""

    def __init__(self, cw: CoreWorker, actor_id: ActorID):
        self.cw = cw
        self.actor_id = actor_id
        self.conn: Optional[rpc.Connection] = None
        self.state = "PENDING"
        self.death_cause = ""
        self.creation_holds: List[ObjectRef] = []
        self._connect_lock = asyncio.Lock()
        self._subscribed = False
        self._inflight: Dict[bytes, Tuple[TaskSpec, list]] = {}
        # (spec, holds) waiting for the next drain; guarded by _queue_lock
        # (appended from the caller's thread, drained on the IO loop).
        self._queue: deque = deque()
        self._queue_lock = threading.Lock()
        self._drain_scheduled = False

    # ------------------------------------------------------- enqueue / drain
    def enqueue(self, spec: TaskSpec, holds) -> None:
        """Called from any thread.  At most one IO-loop wakeup per burst."""
        with self._queue_lock:
            self._queue.append((spec, holds))
            if self._drain_scheduled:
                return
            self._drain_scheduled = True
        self.cw.io.loop.call_soon_threadsafe(self._start_drain)

    def _start_drain(self) -> None:
        asyncio.get_event_loop().create_task(self._drain())

    async def _drain(self) -> None:
        while True:
            with self._queue_lock:
                items = list(self._queue)
                self._queue.clear()
                if not items:
                    self._drain_scheduled = False
                    return
            try:
                await self._ensure_connected()
            except (RayActorError, ActorDiedError) as e:
                for spec, holds in items:
                    self.cw.fail_task(spec, e, holds)
                continue
            except (rpc.ConnectionLost, ConnectionError):
                # connection dropped in the attach window: requeue in order
                # and retry (ensure_connected paces the loop via the GCS
                # wait_alive round-trip)
                with self._queue_lock:
                    self._queue.extendleft(reversed(items))
                continue
            shipped = []
            for spec, holds in items:
                tkey = spec.task_id.binary()
                if tkey in self.cw._cancelled_tasks:
                    # cancelled while this batch waited for the actor to
                    # come alive (the _drain window)
                    self.cw._cancelled_tasks.discard(tkey)
                    self.cw.fail_task(spec, TaskCancelledError(
                        f"task {spec.name} was cancelled"), holds)
                    continue
                self._inflight[tkey] = (spec, holds)
                self.cw._completion_router[tkey] = (
                    lambda item, s=spec, h=holds: self._complete(s, h, item))
                shipped.append((spec, holds))
            if not shipped:
                continue
            ship = time.time()
            for spec, _ in shipped:
                if spec.phase_ts is not None:
                    spec.phase_ts["ship"] = ship
            conn = self.conn
            try:
                await conn.notify(
                    "push_task_batch",
                    _dumps_ctrl([spec for spec, _ in shipped]))
            except (rpc.ConnectionLost, ConnectionError):
                # the close callback retries/fails every inflight (incl. this
                # batch); nothing more to do here
                self._on_conn_lost(conn)

    def _complete(self, spec: TaskSpec, holds, item: dict) -> None:
        tkey = spec.task_id.binary()
        self.cw._cancelled_tasks.discard(tkey)  # consume any stale marker
        if self._inflight.pop(tkey, None) is None:
            return  # already failed via death notification
        if item["status"] == "ok":
            self.cw._observe_phases(spec, item)
            self.cw.complete_task(spec, item["returns"], holds)
        else:
            self.cw.complete_task(
                spec, [(oid.binary(), "error", item["error"])
                       for oid in spec.return_ids()], holds)

    # ------------------------------------------------------------- failures
    def _on_conn_lost(self, conn) -> None:
        """Runs on the IO loop when the actor connection drops.  Retry
        eligible inflight tasks through the reconnect path (which waits for
        the restart); fail the rest."""
        if self.conn is not None and conn is not self.conn:
            return  # stale: a newer connection is already active
        # self.conn may already be None (RESTARTING pubsub beat the close
        # event); the inflight sweep below must still run or those tasks
        # would hang forever.
        self.conn = None
        retried = False
        for tkey in list(self._inflight):
            spec, holds = self._inflight.pop(tkey)
            self.cw._completion_router.pop(tkey, None)
            if spec.max_task_retries != 0 and \
                    spec.attempt_number < max(spec.max_task_retries, 0):
                spec.attempt_number += 1
                spec.span_id = _fast_unique(8).hex()  # span per attempt
                spec.phase_ts = {"submit": time.time(), "ser": 0.0}
                with self._queue_lock:
                    self._queue.append((spec, holds))
                retried = True
            else:
                self.cw.fail_task(spec, ActorDiedError(
                    self.actor_id,
                    f"actor {self.actor_id.hex()[:8]} died while running {spec.name}"),
                    holds)
        if retried:
            with self._queue_lock:
                if self._drain_scheduled:
                    retried = False
                else:
                    self._drain_scheduled = True
            if retried:
                # backoff before re-driving the reconnect: a gang of handles
                # hammering get_actor_info the instant an actor dies slows
                # the very restart they are waiting for
                base = RayConfig.task_retry_backoff_s
                if base <= 0:
                    self._start_drain()
                else:
                    delay = min(base, RayConfig.task_retry_backoff_max_s) \
                        * (0.75 + random.random() * 0.5)
                    asyncio.get_event_loop().call_later(
                        delay, self._start_drain)

    def _on_actor_update(self, info):
        self.state = info["state"]
        if info["state"] == "DEAD":
            self.death_cause = info.get("death_cause", "")
            err = ActorDiedError(self.actor_id, _actor_death_msg(self.actor_id, self.death_cause))
            for task_key in list(self._inflight):
                spec, holds = self._inflight.pop(task_key)
                self.cw._completion_router.pop(task_key, None)
                self.cw.fail_task(spec, err, holds)
            with self._queue_lock:
                queued = list(self._queue)
                self._queue.clear()
            for spec, holds in queued:
                self.cw.fail_task(spec, err, holds)
            self.conn = None
        elif info["state"] in ("RESTARTING",):
            self.conn = None

    async def _ensure_connected(self):
        async with self._connect_lock:
            if not self._subscribed:
                self._subscribed = True
                self.cw._subscriptions.setdefault(
                    f"actor:{self.actor_id.hex()}", []).append(self._on_actor_update)
                await self.cw.gcs_conn.call(
                    "subscribe", {"channel": f"actor:{self.actor_id.hex()}"})
            if self.conn is not None and not self.conn.closed:
                return
            deadline = time.monotonic() + RayConfig.gcs_rpc_timeout_s * 2
            while True:
                info = await self.cw.gcs_conn.call("get_actor_info", {
                    "actor_id": self.actor_id.binary(), "wait_alive": True,
                    "timeout": 10.0}, timeout=None)
                if info is None:
                    raise RayActorError(self.actor_id, "actor not found")
                self.state = info["state"]
                if info["state"] == "DEAD":
                    raise ActorDiedError(
                        self.actor_id, _actor_death_msg(self.actor_id, info.get("death_cause", "")))
                if info["state"] == "ALIVE" and info["addr"]:
                    conn = await rpc.connect(
                        *info["addr"], name=f"->actor-{self.actor_id.hex()[:6]}",
                        handlers=self.cw._rpc_handlers)
                    conn._on_close = self._on_conn_lost
                    self.conn = conn
                    if conn.closed:
                        # dropped in the attach window: the callback never
                        # re-fires for an already-closed connection
                        self._on_conn_lost(conn)
                        raise rpc.ConnectionLost("actor connection dropped")
                    return
                if time.monotonic() > deadline:
                    raise RayActorError(self.actor_id, "timed out waiting for actor to start")


def _actor_death_msg(actor_id: ActorID, cause: str) -> str:
    return f"actor {actor_id.hex()[:8]} is dead: {cause or 'unknown cause'}"
