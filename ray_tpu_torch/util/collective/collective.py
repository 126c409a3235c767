"""Port of ``ray_tpu/util/collective/collective.py``.

Eager cross-process collectives (the gloo-equivalent backend).

API mirrors the reference (reference: python/ray/util/collective/collective.py —
init_collective_group :120, allreduce :258, declare_collective_group, etc.).
Rendezvous rides the GCS KV (the reference uses a named store actor, reference:
util/collective/util.py NCCLUniqueIDStore); data moves directly between member
processes over the runtime RPC with pickle-5 zero-copy buffers.

Data path (the fast-collectives stack, ROADMAP item 3):

- **Chunked, pipelined ring** — each ring step's payload is split into
  ``collective_chunk_bytes`` wire chunks; sends are fire-and-forget frames
  riding the RPC layer's coalesced batch (`notify_coalesced_threadsafe`), so
  send, recv, and reduce overlap instead of alternating one blocking
  ``call_sync`` per hop.  A slice is forwarded the moment it is reduced —
  the 2(N-1)-step allreduce streams.  ``collective_pipeline=False`` restores
  the legacy serial blocking-send ring for interleaved A/B benchmarking.
  When sender and receiver share a node, bulk chunks ride a per-group
  shared-memory arena (``shm_channel.py``) and only a tiny descriptor
  crosses the RPC — the receiver reduces straight out of the mapped
  segment, zero-copy (``collective_shm_min_bytes`` gates, 0 disables).
- **Wire quantization** — opt-in ``quant="int8"`` ships block-scaled int8
  (per-``collective_quant_block`` fp32 scales alongside) and
  dequantizes -> reduces -> requantizes at each hop (EQuARX,
  arXiv:2506.17615).  Measured per-op error lands in the
  ``collective_quant_error`` gauge; the analytic bound is
  ``sum over quantization stages of (block scale / 2)``.
- **Topology selection** (``topology.py``) — flat ring vs hierarchical
  two-level (intra-node leader reduce, inter-node ring over leaders,
  intra-node broadcast), auto-picked from message size and the node
  placement registered in the KV rendezvous ("The Big Send-off",
  arXiv:2504.18658).
- **Quorum reduce** — ``allreduce(..., quorum=K)`` returns once K ranks
  contribute; late contributions are parked in the inbox and folded into
  the next quorum op as an additive correction ("Efficient AllReduce with
  Stragglers", arXiv:2505.23523), surfaced via the existing progress
  stamps plus the ``collective_quorum_late_ranks`` gauge.
"""

from __future__ import annotations

import asyncio
import os
import queue
import socket
import sys
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ray_tpu_torch._private import fault_injection, flight_recorder, incidents, rpc
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.config import RayConfig
from ray_tpu_torch.exceptions import (
    CollectiveError,
    CollectiveTimeout,
    CollectiveWorkerDied,
)
from ray_tpu_torch.util.collective import shm_channel as shm_ch
from ray_tpu_torch.util.collective import topology as topo_mod
from ray_tpu_torch.util.collective.quantization import (
    dequantize_blockwise,
    is_quantized,
    quantize_blockwise,
    wire_bytes,
)

_groups: Dict[str, "Group"] = {}
_lock = threading.Lock()

QUANT_MODES = (None, "int8")

# Tag layout.  Within one op (one seq), every message is keyed
# (seq, src, tag); tags namespace the phases so chunked/hierarchical/quorum
# traffic never collides.  Wire-chunk index rides the low bits
# (tag = base + step * _TAG_STRIDE + chunk_idx); p2p send/recv keeps its
# own seq=-1 namespace.
_TAG_STRIDE = 1 << 16
_TAG_RS = 0              # ring reduce-scatter steps
_TAG_AG = 1 << 28        # ring allgather steps
_TAG_GATHER = 2 << 28    # hierarchical: member -> node leader contribution
_TAG_BCAST = 3 << 28     # hierarchical / broadcast fan-out
_TAG_QUORUM = 4 << 28    # quorum: contribution to root
_TAG_QRESULT = 5 << 28   # quorum: root's result broadcast


def _check_quant(quant: Optional[str]) -> None:
    if quant not in QUANT_MODES:
        raise ValueError(f"unsupported quant {quant!r}; expected one of "
                         f"{QUANT_MODES}")


class AsyncCollectiveHandle:
    """Completion handle for one asynchronously launched collective op.

    The op itself runs on the group's single background comm thread, which
    drains a FIFO queue — so as long as every rank enqueues the same ops in
    the same order, cross-rank seq alignment is preserved exactly as in the
    blocking API.  After completion the handle carries the op's result,
    its wire bytes (this rank's share) and the seconds the op spent
    executing on the comm thread (``op_seconds``), which callers use for
    overlap accounting."""

    def __init__(self, op_name: str = "allreduce"):
        self.op_name = op_name
        self._done = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self.wire_bytes = 0
        self.op_seconds = 0.0

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout_s: Optional[float] = None):
        """Block until the op completes and return its result (or re-raise
        its failure).  ``timeout_s`` bounds the wait — it covers queueing
        delay too, so a backed-up comm thread surfaces as CollectiveTimeout
        here rather than a silent hang."""
        if timeout_s is None:
            timeout_s = RayConfig.collective_default_timeout_s
        if not self._done.wait(timeout_s):
            raise CollectiveTimeout(
                f"async {self.op_name}: not complete after {timeout_s}s "
                f"(op still queued or executing on the comm thread)")
        if self._exc is not None:
            raise self._exc
        return self._result


def wait_all(handles: Sequence[AsyncCollectiveHandle],
             timeout_s: Optional[float] = None) -> list:
    """Wait on a batch of async handles under ONE shared deadline and
    return their results in order.  The first failure propagates; the
    shared deadline means N slow buckets cost one timeout budget, not N."""
    if timeout_s is None:
        timeout_s = RayConfig.collective_default_timeout_s
    deadline = time.monotonic() + timeout_s
    out = []
    for h in handles:
        out.append(h.wait(timeout_s=max(0.001, deadline - time.monotonic())))
    return out


class Group:
    def __init__(self, name: str, world_size: int, rank: int, gen: int = 0):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.core = worker_mod.require_core()
        self.seq = 0
        # Generation counter, bumped by rebuild().  Gen > 0 incarnations
        # live under a distinct KV prefix AND handler name, so frames still
        # in flight from a dead incarnation land on a missing handler and
        # drop instead of corrupting the re-formed group.
        self._gen = gen
        # key -> FIFO of payloads.  A queue (not a single slot) so two p2p
        # sends with the same (src, tag) before the receiver consumes the
        # first don't overwrite each other (round-1 advisor bug); message
        # order per key is preserved by the single TCP connection + in-order
        # handler dispatch.
        self._inbox: Dict[tuple, deque] = {}
        self._inbox_cv = threading.Condition()
        self._member_addrs: Dict[int, tuple] = {}
        self._member_nodes: Dict[int, str] = {}
        # Ranks a liveness probe declared dead: every further send/recv
        # involving them short-circuits to CollectiveWorkerDied instead of
        # re-discovering the death one timeout at a time.
        self._dead_ranks: set = set()
        self._last_probe: Dict[int, float] = {}
        self._handler_name = self._handler_basename()
        self.core.server.handlers[self._handler_name] = self._on_message
        # Test hook: artificial delay of the handler ACK (data delivery is
        # NOT delayed).  Models a peer whose reply path lags — the pipelined
        # data plane must not care; the legacy blocking-send ring stalls a
        # full delay per hop (regression-tested).
        self._ack_delay_s = 0.0
        # Quorum bookkeeping (root rank only): contributions that missed
        # their round, folded into the next quorum op as a correction.
        self._quorum_pending: List[tuple] = []
        self.last_quorum_late: List[int] = []
        self.last_quant_error = 0.0
        self._op_bytes = 0
        self._op_qerr = 0.0
        # Incident bookkeeping: the op start the current failure interrupted
        # (backdates the detect phase) + the open incident + the last closed
        # record (the recovery bench reads its per-phase timeline from here).
        self._op_started_at = 0.0
        self._incident: Optional[incidents.Incident] = None
        self.last_incident: Optional[dict] = None
        # Same-host shm chunk channel (lazy: first eligible bulk send).
        self._shm_tx: Optional[shm_ch.TxArena] = None
        self._shm_rx = shm_ch.RxCache()
        # Async op plumbing: ONE background comm thread per group drains a
        # FIFO queue, so concurrently launched ops stay serialized in enqueue
        # order and cross-rank seq alignment is preserved (lazy start).
        self._comm_q: Optional[queue.Queue] = None
        self._comm_thread: Optional[threading.Thread] = None
        # Per-rank liveness: each op start stamps (seq, op, ts) into the KV
        # rendezvous AND a local gauge, so a peer stuck waiting can name the
        # rank whose progress lags (straggler diagnosis; reference:
        # "Efficient AllReduce with Stragglers", arXiv:2505.23523).
        from ray_tpu_torch._private import metrics as M

        self._m_seq = M.Gauge(
            "collective_op_seq",
            "last collective op sequence started, per group and rank")
        self._m_bytes = M.Counter(
            "collective_bytes_total",
            "wire bytes sent by host-side collectives (payload + quant "
            "scales), per group and op")
        self._m_qerr = M.Gauge(
            "collective_quant_error",
            "accumulated measured max elementwise quantization error of "
            "this rank's last quantized collective op")
        self._m_late = M.Gauge(
            "collective_quorum_late_ranks",
            "ranks outside the quorum in the last quorum-reduce round "
            "(root rank's view)")
        self._register()
        self._stamp_progress("init", 0)

    # ------------------------------------------------------------ rendezvous
    def _kv(self, op, **kw):
        return self.core.io.run(self.core.gcs_conn.call(op, kw))

    def _handler_basename(self) -> str:
        return f"col_{self.name}" if self._gen == 0 \
            else f"col_{self.name}@g{self._gen}"

    @property
    def _prefix(self) -> str:
        """KV key prefix for this incarnation.  Gen 0 keeps the historical
        layout; rebuilt generations get their own namespace (NOT nested
        under ``collective/<name>/`` — a stale-generation key must never
        count toward a later rendezvous's membership tally)."""
        return f"collective/{self.name}" if self._gen == 0 \
            else f"collective/{self.name}@g{self._gen}"

    def _register(self, timeout_s: Optional[float] = None):
        import pickle

        key = f"{self._prefix}/{self.rank}"
        node = getattr(self.core, "_node_id_hex", None) \
            or f"host-{self.core.addr[0]}"
        rec = pickle.dumps(  # lint: disable=no-flatten (rendezvous record)
            {"addr": tuple(self.core.addr), "node": node})
        self._kv("kv_put", ns="collective", key=key, value=rec, overwrite=True)
        deadline = time.monotonic() + (
            RayConfig.collective_rendezvous_timeout_s
            if timeout_s is None else timeout_s)
        while True:
            keys = self._kv("kv_keys", ns="collective", prefix=f"{self._prefix}/")
            if len(keys) >= self.world_size:
                break
            if time.monotonic() > deadline:
                raise CollectiveError(
                    f"collective group {self.name!r}: only {len(keys)}/"
                    f"{self.world_size} members after rendezvous timeout")
            time.sleep(0.05)
        vals = self._kv("kv_multi_get", ns="collective",
                        keys=[f"{self._prefix}/{r}" for r in range(self.world_size)])
        for r in range(self.world_size):
            loaded = pickle.loads(vals[f"{self._prefix}/{r}"])
            if isinstance(loaded, dict):
                self._member_addrs[r] = tuple(loaded["addr"])
                self._member_nodes[r] = loaded.get("node") or f"rank-{r}"
            else:  # pre-topology record: bare addr tuple
                self._member_addrs[r] = tuple(loaded)
                self._member_nodes[r] = f"rank-{r}"

    def _conn(self, rank: int):
        return self.core._owner_conn(self._member_addrs[rank])

    # ------------------------------------------------------------- messaging
    async def _on_message(self, conn, msg):
        key = (msg["seq"], msg["src"], msg.get("tag", 0))
        with self._inbox_cv:
            self._inbox.setdefault(key, deque()).append(msg["data"])
            self._inbox_cv.notify_all()
        if self._ack_delay_s > 0.0:
            await asyncio.sleep(self._ack_delay_s)
        return True

    def _deadline(self, timeout_s: Optional[float]) -> float:
        if timeout_s is None:
            timeout_s = RayConfig.collective_default_timeout_s
        return time.monotonic() + timeout_s

    def _pipelined(self) -> bool:
        return bool(RayConfig.collective_pipeline)

    def _send_to(self, rank: int, data, seq: int, tag: int = 0,
                 deadline: Optional[float] = None):
        """Legacy blocking send (one round trip per payload): p2p ``send``
        and the ``collective_pipeline=False`` serial ring use it."""
        timeout = RayConfig.collective_op_timeout_s if deadline is None \
            else max(deadline - time.monotonic(), 0.001)
        try:
            self._conn(rank).call_sync(
                self._handler_name,
                {"seq": seq, "src": self.rank, "tag": tag, "data": data},
                timeout=timeout)
        except (rpc.ConnectionLost, ConnectionError) as e:
            self._dead_ranks.add(rank)
            self._note_dead("send", rank)
            raise CollectiveWorkerDied(
                f"collective group {self.name!r}: blocking send to rank "
                f"{rank} failed ({e!r}) — peer link severed; recover with "
                f"Group.rebuild()",
                group=self.name, op="send", rank=rank) from e

    def _post_send(self, rank: int, data, seq: int, tag: int = 0):
        """Fire-and-forget pipelined send.  Per-connection ordering is
        preserved (single TCP stream + in-order batch dispatch); a lost
        link surfaces as the *receiver's* CollectiveTimeout naming us."""
        try:
            self._conn(rank).notify_coalesced_threadsafe(
                self._handler_name,
                {"seq": seq, "src": self.rank, "tag": tag, "data": data})
        except (rpc.ConnectionLost, ConnectionError, OSError) as e:
            self._dead_ranks.add(rank)
            self._note_dead("send", rank)
            raise CollectiveWorkerDied(
                f"collective group {self.name!r}: send to rank {rank} "
                f"failed ({e!r}) — peer link severed; recover with "
                f"Group.rebuild()",
                group=self.name, op="send", rank=rank) from e

    def _send_payload(self, rank: int, payload, seq: int, tag: int,
                      deadline: Optional[float], pipelined: bool,
                      shm_ok: bool = True):
        if rank in self._dead_ranks:
            # a probe already declared this peer dead: don't queue frames
            # into a severed link (or re-burn a blocking-send timeout)
            raise self._dead_error("send", rank)
        detached = False
        if shm_ch.is_desc(payload) and self._member_nodes.get(rank) != \
                self._member_nodes.get(self.rank):
            # Cross-node relay: the descriptor names a POSIX segment that
            # only exists on the origin node — a remote receiver would
            # FileNotFoundError on attach (or map a stale same-name
            # segment).  Materialize an inline copy before it leaves the
            # node; same-node relays still forward the descriptor verbatim.
            payload = self._shm_resolve(payload, copy=True)
            detached = True
        self._op_bytes += _payload_bytes(payload)
        if pipelined:
            wire = self._shm_wire(rank, payload, seq, tag, shm_ok)
            if wire is payload and not detached \
                    and isinstance(wire, np.ndarray) \
                    and wire.nbytes >= rpc._OOB_THRESHOLD:
                # Inline arrays at/above the RPC out-of-band threshold are
                # held as zero-copy views until the IO loop writes the
                # frame; the allgather phase overwrites exactly the slices
                # reduce-scatter sent, and callers may mutate their tensor
                # the moment the op returns — either corrupts a frame
                # still queued behind transport backpressure.  Detach a
                # copy.  (Smaller payloads were fully pickled inband at
                # post time; quant records and descriptors are already
                # frame-stable.)
                wire = np.array(wire)
            self._post_send(rank, wire, seq, tag)
        else:
            self._send_to(rank, payload, seq, tag, deadline=deadline)

    def _shm_wire(self, rank: int, payload, seq: int, tag: int,
                  shm_ok: bool):
        """Swap a bulk payload for a shm-arena descriptor when the
        destination shares our node.  ``shm_ok=False`` marks sends whose
        consumption is not completion-synchronized (plain broadcast
        fan-out, quorum traffic) — those stay inline; see shm_channel.py.
        Descriptors being relayed to a SAME-node destination pass through
        verbatim (the receiver attaches the ORIGIN arena by name);
        cross-node relays were already resolved to inline copies in
        :meth:`_send_payload`."""
        min_bytes = RayConfig.collective_shm_min_bytes
        if not shm_ok or min_bytes <= 0 or shm_ch.is_desc(payload) \
                or self._member_nodes.get(rank) != \
                self._member_nodes.get(self.rank):
            return payload
        if self._shm_tx is None:
            self._shm_tx = shm_ch.TxArena(
                f"rtcol-{os.getpid()}-{self.rank}-{uuid.uuid4().hex[:8]}")
        desc = self._shm_tx.place(payload, seq, tag, min_bytes)
        return desc if desc is not None else payload

    def _shm_resolve(self, payload, copy: bool = False):
        """Materialize a shm descriptor (no-op for inline payloads).
        ``copy=True`` detaches results that leave the op (the zero-copy
        view aliases arena memory the sender reuses two placing ops
        later)."""
        if not shm_ch.is_desc(payload):
            return payload
        out = self._shm_rx.resolve(payload)
        if copy:
            if isinstance(out, np.ndarray):
                out = out.copy()
            elif is_quantized(out):
                # record arrays are zero-copy views over the arena too
                out = dict(out, d=np.array(out["d"]), s=np.array(out["s"]))
        return out

    def _recv_from(self, rank: int, seq: int, tag: int = 0,
                   deadline: Optional[float] = None, op: str = "recv",
                   raw: bool = False):
        key = (seq, rank, tag)
        if deadline is None:
            deadline = time.monotonic() + RayConfig.collective_op_timeout_s
        grace = RayConfig.collective_liveness_grace_s
        started = time.monotonic()
        while True:
            with self._inbox_cv:
                q = self._inbox.get(key)
                if q:
                    data = q.popleft()
                    if not q:
                        del self._inbox[key]
                    # raw=True hands back a possible shm descriptor
                    # unresolved so relays can forward it without
                    # re-placing the bytes
                    return data if raw else self._shm_resolve(data)
                remaining = deadline - time.monotonic()
                if remaining > 0:
                    self._inbox_cv.wait(min(remaining, 1.0))
            if remaining <= 0:
                # timed out: diagnose OUTSIDE the condition lock — naming
                # the lagging rank costs a KV read and must not block
                # inbox delivery
                raise self._timeout_error(op, rank)
            if grace > 0 and time.monotonic() - started >= grace:
                # still empty-handed past the grace window: decide
                # dead-vs-straggler (also outside the lock — the probe
                # does a KV read and a socket connect)
                self._probe_liveness(rank, op)

    def _recv_any(self, seq: int, tag: int, ranks: Sequence[int],
                  deadline: float, op: str = "recv"):
        """Wait for a message from ANY of ``ranks`` (quorum gather: arrival
        order decides membership).  Returns (rank, payload)."""
        keys = {r: (seq, r, tag) for r in ranks}
        grace = RayConfig.collective_liveness_grace_s
        started = time.monotonic()
        while True:
            with self._inbox_cv:
                for r, key in keys.items():
                    q = self._inbox.get(key)
                    if q:
                        data = q.popleft()
                        if not q:
                            del self._inbox[key]
                        return r, self._shm_resolve(data)
                remaining = deadline - time.monotonic()
                if remaining > 0:
                    self._inbox_cv.wait(min(remaining, 1.0))
            if remaining <= 0:
                raise self._timeout_error(op, min(ranks))
            if grace > 0 and time.monotonic() - started >= grace:
                # an any-wait tolerates individual deaths (that is the
                # point of quorum reduce): only when EVERY candidate is
                # dead can no message ever arrive
                dead = [r for r in ranks
                        if not self._probe_liveness(r, op, raise_dead=False)]
                if len(dead) == len(list(ranks)):
                    raise self._dead_error(op, dead[0])

    def _try_pop(self, seq: int, rank: int, tag: int):
        """Non-blocking inbox pop (quorum late-contribution drain)."""
        key = (seq, rank, tag)
        with self._inbox_cv:
            q = self._inbox.get(key)
            if not q:
                return None
            data = q.popleft()
            if not q:
                del self._inbox[key]
        return self._shm_resolve(data)

    # ------------------------------------------------------ progress / hangs
    def _stamp_progress(self, op: str, seq: int) -> None:
        """Publish this rank's (seq, op) heartbeat: gauge locally (rides the
        worker metrics push) + fire-and-forget KV write (what a stuck peer
        reads to name us as lagging).  Never blocks the op."""
        import pickle

        self._m_seq.set(seq, {"group": self.name, "rank": str(self.rank)})
        try:
            self.core.io.spawn(self.core.gcs_conn.notify("kv_put", {
                "ns": "collective",
                "key": f"{self._prefix}/progress/{self.rank}",
                "value": pickle.dumps(  # lint: disable=no-flatten (progress record)
                    {"seq": seq, "op": op, "ts": time.time()}),
                "overwrite": True,
            }))
        except Exception:
            pass  # diagnosis plumbing must never fail the collective

    def progress(self) -> Dict[int, dict]:
        """Every member's last stamped (seq, op, ts), from the KV
        rendezvous; ranks that never stamped are absent."""
        import pickle

        vals = self._kv(
            "kv_multi_get", ns="collective",
            keys=[f"{self._prefix}/progress/{r}"
                  for r in range(self.world_size)])
        out: Dict[int, dict] = {}
        for r in range(self.world_size):
            blob = vals.get(f"{self._prefix}/progress/{r}")
            if blob is not None:
                out[r] = pickle.loads(blob)
        return out

    def _timeout_error(self, op: str, waiting_on: int) -> CollectiveTimeout:
        try:
            prog = self.progress()
        except Exception:
            prog = {}
        lagging = [r for r in range(self.world_size)
                   if r != self.rank
                   and prog.get(r, {}).get("seq", -1) < self.seq]
        detail = ", ".join(
            f"rank {r} last at seq {prog[r]['seq']} ({prog[r]['op']})"
            if r in prog else f"rank {r} never stamped progress"
            for r in lagging) or f"rank {waiting_on} (no progress data)"
        return CollectiveTimeout(
            f"collective {op!r} in group {self.name!r} (rank {self.rank}, "
            f"seq {self.seq}) timed out waiting for rank {waiting_on}; "
            f"lagging: {detail}",
            group=self.name, op=op,
            lagging_ranks=lagging or [waiting_on])

    # -------------------------------------------------- liveness / rank death
    def _probe_liveness(self, rank: int, op: str,
                        raise_dead: bool = True) -> bool:
        """Decide dead-vs-straggler for a rank we are stuck waiting on.
        Runs OUTSIDE the inbox lock.  Evidence, in order:

        1. a progress stamp fresher than the grace window → alive (fast
           path; piggybacks on the KV heartbeat every op start writes);
        2. a TCP connect to the rank's server address: accepted or timed
           out → alive (a straggler's host is up even when its Python is
           wedged); refused/unreachable → DEAD.

        A dead rank raises CollectiveWorkerDied naming it — in seconds,
        not after the full op timeout — or returns False for
        ``raise_dead=False`` callers (the quorum any-wait, which tolerates
        individual deaths).  Returns True when the rank is alive or the
        probe is rate-limited.

        Confirmed deaths are PUBLISHED to the KV (``<prefix>/dead/<rank>``):
        in a ring only the dead rank's downstream neighbor starves on it
        directly — every other rank is stuck waiting on a live peer that
        already raised and moved on, and would otherwise burn the full op
        timeout.  The shared dead-set makes all survivors converge on the
        same CollectiveWorkerDied within one probe interval."""
        if rank in self._dead_ranks:
            if raise_dead:
                raise self._dead_error(op, rank)
            return False
        now = time.monotonic()
        if now - self._last_probe.get(rank, 0.0) < \
                RayConfig.collective_liveness_interval_s:
            return True  # probed recently; it was not dead then
        self._last_probe[rank] = now
        # deaths a peer already proved: a full collective cannot complete
        # with ANY member gone, so raise on those even when the rank WE
        # wait on is alive (raise_dead=False callers care only about their
        # own candidate set and keep per-rank semantics)
        published = self._kv_dead()
        if published:
            self._dead_ranks.update(published)
            if raise_dead:
                raise self._dead_error(
                    op, rank if rank in published else min(published))
            return rank not in published
        try:
            stamp = self.progress().get(rank)
        except Exception:
            stamp = None  # KV unreachable: fall through to the TCP probe
        if stamp is not None and time.time() - stamp.get("ts", 0.0) < \
                max(RayConfig.collective_liveness_grace_s,
                    RayConfig.collective_liveness_interval_s):
            return True
        if self._probe_addr(self._member_addrs.get(rank)):
            return True
        self._dead_ranks.add(rank)
        self._publish_dead(rank)
        if raise_dead:
            raise self._dead_error(op, rank)
        return False

    def _kv_dead(self) -> set:
        """Ranks any member has proven dead this generation (KV-shared)."""
        try:
            keys = self._kv("kv_keys", ns="collective",
                            prefix=f"{self._prefix}/dead/")
        except Exception:
            return set()
        out = set()
        for k in keys:
            try:
                out.add(int(k.rsplit("/", 1)[1]))
            except ValueError:
                pass
        out.discard(self.rank)
        return out

    def _publish_dead(self, rank: int) -> None:
        try:
            self._kv("kv_put", ns="collective",
                     key=f"{self._prefix}/dead/{rank}", value=b"1",
                     overwrite=True)
        except Exception:
            pass  # peers will re-prove the death with their own probes

    @staticmethod
    def _probe_addr(addr, timeout: float = 1.0) -> bool:
        """True if something is listening at ``addr`` — or merely slow (a
        straggler must never be declared dead, so a connect TIMEOUT counts
        as alive).  False only on a definitive refusal/unreachable."""
        if addr is None:
            return False
        try:
            socket.create_connection(tuple(addr), timeout=timeout).close()
            return True
        except socket.timeout:
            return True
        except OSError:
            return False

    def _note_dead(self, op: str, rank: int) -> None:
        """Every path that declares a peer dead funnels through here so
        exactly one incident opens per failure, detect-stamped at the
        moment of detection."""
        if self._incident is None:
            # backdate to the interrupted op's start: the detect phase then
            # measures the real dead-peer detection latency, not zero
            self._incident = incidents.open_incident(
                "collective", kind="CollectiveWorkerDied",
                detail=f"{self.name}|op={op}|seq={self.seq}",
                victim=f"rank{rank}",
                started_mono=self._op_started_at or None)
            self._incident.stamp("detect")
        if flight_recorder.RECORDING:
            flight_recorder.record(
                "col.dead", f"{self.name}|{op}|rank{rank}")

    def _dead_error(self, op: str, rank: int) -> CollectiveWorkerDied:
        self._note_dead(op, rank)
        return CollectiveWorkerDied(
            f"collective {op!r} in group {self.name!r} (rank {self.rank}, "
            f"seq {self.seq}): rank {rank} DIED mid-collective (progress "
            f"stamp stale and {self._member_addrs.get(rank)} refuses "
            f"connections) — recover with Group.rebuild() after restarting "
            f"or excluding it",
            group=self.name, op=op, rank=rank)

    # ----------------------------------------------------- per-op accounting
    def _begin_op(self, op: str) -> int:
        seq = self._next_seq(op)
        self._op_bytes = 0
        self._op_qerr = 0.0
        self._op_started_at = time.monotonic()
        if flight_recorder.RECORDING:
            flight_recorder.record(
                "col.op", f"{self.name}|{op}|seq={seq}")
        return seq

    def _finish_op(self, op: str, quant: Optional[str]) -> None:
        if flight_recorder.RECORDING:
            flight_recorder.record(
                "col.op_end",
                f"{self.name}|{op}|seq={self.seq}|bytes={self._op_bytes}")
        if self._op_bytes:
            self._m_bytes.inc(self._op_bytes,
                              {"group": self.name, "op": op})
        if quant is not None:
            self.last_quant_error = self._op_qerr
            self._m_qerr.set(self._op_qerr, {"group": self.name, "op": op})

    def _maybe_quant(self, arr: np.ndarray, quant: Optional[str]):
        if quant is None:
            return np.ascontiguousarray(arr)
        rec, err = quantize_blockwise(arr)
        self._op_qerr += err
        return rec

    @staticmethod
    def _maybe_dequant(payload) -> np.ndarray:
        if is_quantized(payload):
            return dequantize_blockwise(payload)
        return np.asarray(payload)

    @staticmethod
    def _dequant_to_input(rec) -> np.ndarray:
        """Dequantize a wire record back to the SENDER's dtype (gather
        results hand back what each rank contributed, not a float32
        reduce accumulator; integer inputs round-to-nearest instead of
        truncating)."""
        out = dequantize_blockwise(rec)
        dt = np.dtype(rec["dtype"])
        if not np.issubdtype(dt, np.floating):
            np.rint(out, out=out)
        return out.astype(dt)

    # ------------------------------------------------------------ primitives
    # Ring topology (bandwidth-optimal, like NCCL's host rings): allreduce =
    # ring reduce-scatter + ring allgather, 2(N-1) steps moving ~2x the
    # payload total per rank regardless of world size.  Both phases stream:
    # wire chunks are sent fire-and-forget the moment they are reduced
    # (reduce-scatter) or received (allgather relays forward verbatim, so
    # quantized payloads pick up NO extra error in the gather phase).

    @staticmethod
    def _reduce_into(seg: np.ndarray, incoming: np.ndarray, op: str) -> None:
        if op in ("sum", "mean"):
            np.add(seg, incoming, out=seg, casting="unsafe")
        elif op == "max":
            np.maximum(seg, incoming, out=seg, casting="unsafe")
        elif op == "min":
            np.minimum(seg, incoming, out=seg, casting="unsafe")
        else:
            raise ValueError(f"unsupported op {op!r}")

    @staticmethod
    def _acc_dtype(dtype: np.dtype, quant: Optional[str],
                   op: str = "sum") -> np.dtype:
        """Wire/accumulation dtype: float inputs reduce in their own
        precision (halves wire bytes vs the v2 always-float64 path); int
        sums promote to float64 so long reductions can't overflow (max/min
        stay exact in the input dtype); quantized ops accumulate in
        float32 (the dequant precision)."""
        if quant is not None:
            return np.dtype(np.float32)
        if np.issubdtype(dtype, np.floating) or op in ("max", "min"):
            return np.dtype(dtype)
        return np.dtype(np.float64)

    def _wire_bounds(self, size: int, itemsize: int,
                     pipelined: bool) -> List[tuple]:
        """Split a flat chunk of ``size`` elements into wire slices."""
        chunk_bytes = RayConfig.collective_chunk_bytes
        if not pipelined or chunk_bytes <= 0 or size == 0:
            return [(0, size)]
        per = max(chunk_bytes // max(itemsize, 1), 1)
        # tag space holds _TAG_STRIDE chunk indices per step
        per = max(per, -(-size // (_TAG_STRIDE - 1)))
        return [(s, min(s + per, size)) for s in range(0, size, per)]

    def _rs_flat(self, flats: List[np.ndarray], op: str, seq: int,
                 ring: List[int], shift: int, deadline: float,
                 op_name: str, quant: Optional[str], pipelined: bool) -> None:
        """Streaming ring reduce-scatter over position-indexed flat chunks
        (mutated in place).  After N-1 steps, chunk[(pos + 1 + shift) % N]
        holds the full reduction (shift=-1 leaves position p with shard p).
        The slice reduced at step s is exactly the slice sent at step s+1,
        so each wire chunk is forwarded the moment its reduce completes."""
        n = len(ring)
        if n == 1:
            return
        pos = ring.index(self.rank)
        right = ring[(pos + 1) % n]
        left = ring[(pos - 1) % n]
        first = flats[(pos + shift) % n]
        for w, (s, e) in enumerate(self._wire_bounds(
                first.size, first.itemsize, pipelined)):
            self._send_payload(right, self._maybe_quant(first[s:e], quant),
                               seq, _TAG_RS + w, deadline, pipelined)
        if fault_injection.ENABLED and fault_injection.hit(
                "collective.step", detail=f"rank{self.rank}") == "kill":
            # mid-collective rank death: our first ring step is already on
            # the wire, so peers' recvs from us starve — their liveness
            # probes must convert that into CollectiveWorkerDied
            fault_injection.kill_self()
        for step in range(n - 1):
            fl = flats[(pos - step - 1 + shift) % n]
            for w, (s, e) in enumerate(self._wire_bounds(
                    fl.size, fl.itemsize, pipelined)):
                incoming = self._maybe_dequant(self._recv_from(
                    left, seq, _TAG_RS + step * _TAG_STRIDE + w,
                    deadline=deadline, op=op_name))
                seg = fl[s:e]
                self._reduce_into(seg, incoming.reshape(-1), op)
                if step + 1 < n - 1:
                    self._send_payload(
                        right, self._maybe_quant(seg, quant), seq,
                        _TAG_RS + (step + 1) * _TAG_STRIDE + w,
                        deadline, pipelined)

    def _ag_flat(self, flats: List[np.ndarray], owned_idx: int, seq: int,
                 ring: List[int], deadline: float, op_name: str,
                 quant: Optional[str], pipelined: bool) -> None:
        """Streaming ring allgather over position-indexed flat chunks: each
        position starts owning chunk[owned_idx]; N-1 rotations fill all.
        Received wire chunks are relayed VERBATIM (quantized payloads are
        not re-quantized — the gather phase adds zero extra error)."""
        n = len(ring)
        if n == 1:
            return
        pos = ring.index(self.rank)
        right = ring[(pos + 1) % n]
        left = ring[(pos - 1) % n]
        own = flats[owned_idx]
        for w, (s, e) in enumerate(self._wire_bounds(
                own.size, own.itemsize, pipelined)):
            self._send_payload(right, self._maybe_quant(own[s:e], quant),
                               seq, _TAG_AG + w, deadline, pipelined)
        for step in range(n - 1):
            recv_i = (owned_idx - step - 1) % n
            fl = flats[recv_i]
            for w, (s, e) in enumerate(self._wire_bounds(
                    fl.size, fl.itemsize, pipelined)):
                pay = self._recv_from(
                    left, seq, _TAG_AG + step * _TAG_STRIDE + w,
                    deadline=deadline, op=op_name, raw=True)
                if step + 1 < n - 1:
                    self._send_payload(
                        right, pay, seq,
                        _TAG_AG + (step + 1) * _TAG_STRIDE + w,
                        deadline, pipelined)
                fl[s:e] = self._maybe_dequant(
                    self._shm_resolve(pay)).reshape(-1)

    def _ring_allreduce_core(self, arr: np.ndarray, op: str, seq: int,
                             ring: List[int], deadline: float,
                             op_name: str, quant: Optional[str]) -> np.ndarray:
        """Reduce-scatter + allgather over ``ring``; returns the reduced
        array in accumulation dtype, WITHOUT the mean division (callers
        divide by the semantic world size — hierarchical rings reduce
        pre-summed node contributions over only the leader ranks)."""
        n = len(ring)
        acc_dtype = self._acc_dtype(arr.dtype, quant, op)
        full = arr.astype(acc_dtype).ravel()
        if n == 1:
            return full.reshape(arr.shape)
        pos = ring.index(self.rank)
        flats = np.array_split(full, n)  # views over one owned buffer
        pipelined = self._pipelined()
        self._rs_flat(flats, op, seq, ring, 0, deadline, op_name, quant,
                      pipelined)
        owned = (pos + 1) % n
        self._ag_flat(flats, owned, seq, ring, deadline, op_name, quant,
                      pipelined)
        return full.reshape(arr.shape)

    # -------------------------------------------------- hierarchical two-level
    def _hier_allreduce(self, arr: np.ndarray, op: str, seq: int,
                        plan: "topo_mod.Plan", deadline: float,
                        op_name: str, quant: Optional[str]) -> np.ndarray:
        """Intra-node leader reduce -> inter-node ring over leaders ->
        intra-node broadcast.  Cross-node traffic moves once per NODE
        instead of once per rank (The Big Send-off, arXiv:2504.18658)."""
        pipelined = self._pipelined()
        ring_op = "sum" if op == "mean" else op
        if not plan.is_leader:
            self._send_payload(
                plan.leader, self._maybe_quant(np.ascontiguousarray(arr),
                                               quant),
                seq, _TAG_GATHER, deadline, pipelined)
            res = self._maybe_dequant(self._recv_from(
                plan.leader, seq, _TAG_BCAST, deadline=deadline, op=op_name))
            return res.reshape(arr.shape)
        acc = arr.astype(self._acc_dtype(arr.dtype, quant, op))
        acc_flat = acc.ravel()
        for m in plan.members:
            inc = self._maybe_dequant(self._recv_from(
                m, seq, _TAG_GATHER, deadline=deadline, op=op_name))
            self._reduce_into(acc_flat, inc.reshape(-1), ring_op)
        if len(plan.leaders) > 1:
            acc = self._ring_allreduce_core(acc, ring_op, seq, plan.leaders,
                                            deadline, op_name, quant)
        if plan.members:
            pay = self._maybe_quant(np.ascontiguousarray(acc), quant)
            for m in plan.members:
                self._send_payload(m, pay, seq, _TAG_BCAST, deadline,
                                   pipelined)
        return acc

    # --------------------------------------------------------- quorum reduce
    def _quorum_allreduce(self, arr: np.ndarray, op: str, seq: int,
                          quorum: int, deadline: float, op_name: str,
                          quant: Optional[str]) -> np.ndarray:
        """Root-coordinated straggler-tolerant reduce: root folds the first
        ``quorum`` contributions (arrival order) plus any parked late
        contributions from earlier rounds, then broadcasts one consistent
        result to every rank — including the stragglers, whose own late
        payloads park in root's inbox and fold into the NEXT quorum op.
        Over consecutive rounds the cumulative result equals full
        participation once stragglers catch up (arXiv:2505.23523)."""
        if op not in ("sum", "mean"):
            raise ValueError(
                f"quorum reduce supports op='sum'/'mean' (late contributions "
                f"fold in as additive corrections), not {op!r}")
        if not 1 <= quorum <= self.world_size:
            raise ValueError(f"quorum {quorum} out of range for world_size "
                             f"{self.world_size}")
        n = self.world_size
        if n == 1:
            out = arr.astype(np.float64)
            return (out / n if op == "mean" else out).astype(
                arr.dtype).reshape(arr.shape)
        root = 0
        pipelined = self._pipelined()
        if self.rank != root:
            # shm_ok=False: a contribution outside the quorum parks in
            # root's inbox across rounds — far past the arena's two-op
            # reuse window
            self._send_payload(
                root, self._maybe_quant(np.ascontiguousarray(arr), quant),
                seq, _TAG_QUORUM, deadline, pipelined, shm_ok=False)
            res = self._maybe_dequant(self._recv_from(
                root, seq, _TAG_QRESULT, deadline=deadline,
                op=op_name)).astype(np.float64)
            if op == "mean":
                res = res / n
            return res.astype(arr.dtype).reshape(arr.shape)
        acc = arr.astype(np.float64).ravel().copy()
        # fold parked late contributions from previous rounds first
        still_pending = []
        for oseq, r in self._quorum_pending:
            pay = self._try_pop(oseq, r, _TAG_QUORUM)
            if pay is None:
                still_pending.append((oseq, r))
            else:
                np.add(acc, self._maybe_dequant(pay).reshape(-1).astype(
                    np.float64), out=acc)
        self._quorum_pending = still_pending
        got = {root}
        others = [r for r in range(n) if r != root]
        while len(got) < quorum:
            r, pay = self._recv_any(
                seq, _TAG_QUORUM, [r for r in others if r not in got],
                deadline, op=op_name)
            np.add(acc, self._maybe_dequant(pay).reshape(-1).astype(
                np.float64), out=acc)
            got.add(r)
        # opportunistic drain: contributions that arrived while we gathered
        # the quorum join this round instead of parking
        for r in others:
            if r not in got:
                pay = self._try_pop(seq, r, _TAG_QUORUM)
                if pay is not None:
                    np.add(acc, self._maybe_dequant(pay).reshape(-1).astype(
                        np.float64), out=acc)
                    got.add(r)
        late = sorted(set(range(n)) - got)
        self._quorum_pending.extend((seq, r) for r in late)
        self.last_quorum_late = late
        self._m_late.set(len(late), {"group": self.name})
        result = acc.reshape(arr.shape)
        pay = self._maybe_quant(result.astype(np.float32), quant) \
            if quant is not None else result
        for r in others:
            # shm_ok=False: a straggler may consume this result rounds
            # later, after the root's op counter moved on
            self._send_payload(r, pay, seq, _TAG_QRESULT, deadline,
                               pipelined, shm_ok=False)
        if op == "mean":
            result = result / n
        return result.astype(arr.dtype)

    # ------------------------------------------------------------ public ops
    def allreduce(self, array, op: str = "sum",
                  timeout_s: Optional[float] = None,
                  quant: Optional[str] = None,
                  topology: Optional[str] = None,
                  quorum: Optional[int] = None,
                  _op_name: str = "allreduce"):
        _check_quant(quant)
        seq = self._begin_op(_op_name)
        deadline = self._deadline(timeout_s)
        arr = np.asarray(array)
        try:
            if quorum is not None:
                return self._quorum_allreduce(arr, op, seq, quorum, deadline,
                                              _op_name, quant)
            n = self.world_size
            if n == 1:
                return arr.copy()  # incl. mean: averaging one rank is identity
            plan = topo_mod.plan(self.rank, n, self._member_nodes,
                                 arr.nbytes, topology)
            if plan.kind == "hier":
                out = self._hier_allreduce(arr, op, seq, plan, deadline,
                                           _op_name, quant)
            else:
                out = self._ring_allreduce_core(
                    arr, "sum" if op == "mean" else op, seq,
                    list(range(n)), deadline, _op_name, quant)
            out = np.asarray(out, dtype=np.float64) if op == "mean" else out
            if op == "mean":
                out = out / n
            return np.asarray(out).astype(arr.dtype).reshape(arr.shape)
        finally:
            self._finish_op(_op_name, quant)

    # ------------------------------------------------------------ async ops
    def _comm_loop(self) -> None:
        while True:
            item = self._comm_q.get()
            if item is None:
                return
            fn, handle = item
            t0 = time.monotonic()
            try:
                handle._result = fn()
                # comm thread is the only executor of this group's async
                # ops, so _op_bytes still holds THIS op's tally here.
                handle.wire_bytes = self._op_bytes
            except BaseException as e:  # surfaced at handle.wait()
                handle._exc = e
            handle.op_seconds = time.monotonic() - t0
            handle._done.set()

    def _comm_submit(self, fn, op_name: str) -> AsyncCollectiveHandle:
        if self._comm_thread is None or not self._comm_thread.is_alive():
            self._comm_q = queue.Queue()
            self._comm_thread = threading.Thread(
                target=self._comm_loop, daemon=True,
                name=f"col-comm-{self.name}")
            self._comm_thread.start()
        handle = AsyncCollectiveHandle(op_name=op_name)
        self._comm_q.put((fn, handle))
        return handle

    def allreduce_async(self, array, op: str = "sum",
                        timeout_s: Optional[float] = None,
                        quant: Optional[str] = None,
                        quorum: Optional[int] = None) -> AsyncCollectiveHandle:
        """Launch an allreduce on the comm thread and return immediately.

        The caller overlaps compute with the transfer and collects the
        result via ``handle.wait(timeout_s)`` / module-level
        :func:`wait_all`.  All of a group's async ops (and any blocking ops
        issued through :meth:`allreduce_async` + immediate wait) share the
        one comm thread, so every rank observing the same launch order
        keeps the same wire seq order — the invariant the blocking API gets
        for free."""
        _check_quant(quant)
        arr = np.asarray(array)
        return self._comm_submit(
            lambda: self.allreduce(arr, op, timeout_s=timeout_s,
                                   quant=quant, quorum=quorum),
            "allreduce")

    def allgather(self, array, timeout_s: Optional[float] = None,
                  quant: Optional[str] = None) -> List[np.ndarray]:
        """Gather every rank's array.  With ``quant="int8"`` each entry —
        this rank's own included — is the owner's single
        quantize→dequantize round trip cast back to the owner's dtype, so
        every rank sees the identical list (the own entry is NOT kept
        exact: that would make results asymmetric across ranks)."""
        _check_quant(quant)
        seq = self._begin_op("allgather")
        deadline = self._deadline(timeout_s)
        arr = np.asarray(array)
        n = self.world_size
        try:
            if n == 1:
                return [self._dequant_to_input(self._maybe_quant(
                    np.ascontiguousarray(arr), quant))
                    if quant is not None else arr.copy()]
            # per-rank payloads may differ in shape: rotate whole payloads
            # (quantized once at the owner, relayed verbatim — one quant
            # stage of error total)
            pipelined = self._pipelined()
            right = (self.rank + 1) % n
            left = (self.rank - 1) % n
            items: List[Any] = [None] * n
            pay = self._maybe_quant(np.ascontiguousarray(arr), quant)
            items[self.rank] = self._dequant_to_input(pay) \
                if quant is not None else arr
            self._send_payload(right, pay, seq, _TAG_AG, deadline, pipelined)
            for step in range(n - 1):
                recv_i = (self.rank - step - 1) % n
                incoming = self._recv_from(
                    left, seq, _TAG_AG + step * _TAG_STRIDE,
                    deadline=deadline, op="allgather", raw=True)
                if step + 1 < n - 1:
                    self._send_payload(
                        right, incoming, seq,
                        _TAG_AG + (step + 1) * _TAG_STRIDE,
                        deadline, pipelined)
                # copy=True: the result leaves the op, so it must not
                # alias arena memory the sender will reuse
                data = self._shm_resolve(incoming, copy=True)
                items[recv_i] = self._dequant_to_input(data) \
                    if is_quantized(data) else np.asarray(data)
            return [np.asarray(c) for c in items]
        finally:
            self._finish_op("allgather", quant)

    def reducescatter(self, array, op: str = "sum",
                      timeout_s: Optional[float] = None,
                      quant: Optional[str] = None):
        """True ring reduce-scatter: each rank moves ~1x the payload and
        returns only its shard (v1 was allreduce-then-split: no saving)."""
        _check_quant(quant)
        seq = self._begin_op("reducescatter")
        deadline = self._deadline(timeout_s)
        arr = np.asarray(array)
        n = self.world_size
        try:
            if n == 1:
                return arr.copy()
            acc_dtype = self._acc_dtype(arr.dtype, quant, op)
            # split along axis 0, exactly like v1's array_split(allreduce(x),
            # n): a (4, 4) input with n=2 yields (2, 4) shards, not flat
            # slices
            parts = [np.array(p, dtype=acc_dtype) for p in
                     np.array_split(arr, n, axis=0)]
            flats = [p.reshape(-1) for p in parts]
            self._rs_flat(flats, "sum" if op == "mean" else op, seq,
                          list(range(n)), -1, deadline, "reducescatter",
                          quant, self._pipelined())
            mine = parts[self.rank]
            if op == "mean":
                mine = mine / n
            return np.asarray(mine).astype(arr.dtype)
        finally:
            self._finish_op("reducescatter", quant)

    def broadcast(self, array, root: int = 0,
                  timeout_s: Optional[float] = None,
                  quant: Optional[str] = None,
                  topology: Optional[str] = None):
        _check_quant(quant)
        seq = self._begin_op("broadcast")
        deadline = self._deadline(timeout_s)
        n = self.world_size
        try:
            # topology must resolve identically on every rank, and only the
            # root knows the payload size — so broadcast selects on node
            # structure alone (size passed as "large" sentinel)
            plan = topo_mod.plan(self.rank, n, self._member_nodes,
                                 1 << 62, topology)
            pipelined = self._pipelined()
            if plan.kind == "hier" and n > 1:
                return self._hier_broadcast(array, root, seq, plan, deadline,
                                            pipelined, quant)
            if self.rank == root:
                arr = np.asarray(array)
                pay = self._maybe_quant(np.ascontiguousarray(arr), quant)
                for r in range(n):
                    if r != root:
                        # shm_ok=False: a broadcast root completes without
                        # any receiver participation, so nothing stops it
                        # from reusing arena regions receivers still read
                        self._send_payload(r, pay, seq, _TAG_BCAST,
                                           deadline, pipelined,
                                           shm_ok=False)
                return arr
            return self._maybe_dequant(self._recv_from(
                root, seq, _TAG_BCAST, deadline=deadline, op="broadcast"))
        finally:
            self._finish_op("broadcast", quant)

    def _hier_broadcast(self, array, root: int, seq: int,
                        plan: "topo_mod.Plan", deadline: float,
                        pipelined: bool, quant: Optional[str]):
        """Root -> node leaders -> node members; the quantized payload is
        relayed verbatim (one quant stage of error total)."""
        if self.rank == root:
            arr = np.asarray(array)
            pay = self._maybe_quant(np.ascontiguousarray(arr), quant)
            # shm_ok=False throughout: broadcast completion carries no
            # receiver-participation dependency (see flat broadcast)
            for lead in plan.leaders:
                if lead != root:
                    self._send_payload(lead, pay, seq, _TAG_BCAST,
                                       deadline, pipelined, shm_ok=False)
            if plan.is_leader:
                for m in plan.members:
                    if m != root:
                        self._send_payload(m, pay, seq, _TAG_BCAST,
                                           deadline, pipelined,
                                           shm_ok=False)
            return arr
        src = root if plan.is_leader else plan.leader
        pay = self._recv_from(src, seq, _TAG_BCAST, deadline=deadline,
                              op="broadcast")
        if plan.is_leader:
            for m in plan.members:
                if m != root:
                    self._send_payload(m, pay, seq, _TAG_BCAST, deadline,
                                       pipelined, shm_ok=False)
        return self._maybe_dequant(pay)

    def barrier(self, timeout_s: Optional[float] = None):
        self.allreduce(np.zeros((), np.float32), timeout_s=timeout_s,
                       _op_name="barrier")

    def send(self, array, dst_rank: int, tag: int = 0,
             timeout_s: Optional[float] = None):
        # Tagged p2p rides its own seq namespace (negative tags avoid
        # colliding with collective seqs).  Deliberately blocking: p2p
        # callers rely on delivery errors raising here.
        self._send_to(dst_rank, np.asarray(array), -1, tag=tag + 2,
                      deadline=self._deadline(timeout_s))

    def recv(self, src_rank: int, tag: int = 0,
             timeout_s: Optional[float] = None):
        return np.asarray(self._recv_from(
            src_rank, -1, tag=tag + 2,
            deadline=self._deadline(timeout_s), op="recv"))

    def _next_seq(self, op: str = "op") -> int:
        self.seq += 1
        self._stamp_progress(op, self.seq)
        return self.seq

    def _stop_comm_thread(self) -> None:
        if self._comm_thread is not None and self._comm_thread.is_alive():
            self._comm_q.put(None)
            self._comm_thread.join(timeout=5.0)
        self._comm_thread = None
        self._comm_q = None

    def destroy(self):
        if self._incident is not None:
            # destroyed without a rebuild: the failure went unrecovered
            self.last_incident = self._incident.close(ok=False)
            self._incident = None
        self._stop_comm_thread()
        self.core.server.handlers.pop(self._handler_name, None)
        if self._shm_tx is not None:
            self._shm_tx.close()
            self._shm_tx = None
        self._shm_rx.close()
        if self.rank == 0:
            # the "@" prefix sweeps every rebuilt generation's keys (and
            # the gen pointer lives under the base prefix)
            for prefix in (f"collective/{self.name}/",
                           f"collective/{self.name}@"):
                try:
                    self._kv("kv_del", ns="collective", key=prefix,
                             prefix=True)
                except Exception:
                    pass

    # -------------------------------------------------------------- recovery
    def rebuild(self, world_size: Optional[int] = None,
                rank: Optional[int] = None,
                timeout_s: Optional[float] = None) -> "Group":
        """Re-form the group after a member died mid-collective.

        **Shrink** (default, no args): probe every old member address, keep
        the survivors, renumber ranks by old-rank order — this rank's new
        rank is its index among the survivors.  **Replace**: pass the old
        ``world_size`` and this rank's (unchanged) ``rank`` explicitly on
        every survivor, restart the dead rank's process, and have it call
        :func:`rejoin_collective_group` — it reads the new generation from
        the KV and registers under it.

        The rebuilt group lives under a bumped GENERATION: fresh KV prefix
        (``collective/<name>@g<gen>``) and handler name, so frames still in
        flight from the dead incarnation land on a missing handler and are
        dropped instead of corrupting the new one.  All per-op state (seq,
        inbox, quorum parkings, shm arenas) resets — ops on the rebuilt
        group are bitwise-identical to a freshly initialized group of the
        same membership."""
        t0 = time.monotonic()
        # Adopt the incident the failing op opened (detect already stamped);
        # a proactive rebuild with no prior failure opens its own here.
        inc = self._incident
        if inc is None:
            inc = incidents.open_incident(
                "collective", kind="rebuild", detail=self.name,
                started_mono=t0)
        if flight_recorder.RECORDING:
            flight_recorder.record("col.rebuild", self.name)
        if world_size is None or rank is None:
            survivors = [r for r in sorted(self._member_addrs)
                         if r == self.rank
                         or (r not in self._dead_ranks
                             and self._probe_addr(self._member_addrs[r]))]
            world_size = len(survivors) if world_size is None else world_size
            rank = survivors.index(self.rank) if rank is None else rank
        # tear down the dead incarnation
        self._stop_comm_thread()
        old_prefix = self._prefix
        old_world = self.world_size
        self.core.server.handlers.pop(self._handler_name, None)
        with self._inbox_cv:
            self._inbox.clear()
        if self._shm_tx is not None:
            self._shm_tx.close()
            self._shm_tx = None
        self._shm_rx.close()
        self._shm_rx = shm_ch.RxCache()
        self._quorum_pending = []
        self.last_quorum_late = []
        self._dead_ranks.clear()
        self._last_probe.clear()
        self._member_addrs.clear()
        self._member_nodes.clear()
        # survivors proven + dead incarnation fully torn down
        inc.stamp("quarantine")
        # bring up the next generation
        self._gen += 1
        self.world_size = world_size
        self.rank = rank
        self.seq = 0
        self._handler_name = self._handler_basename()
        self.core.server.handlers[self._handler_name] = self._on_message
        try:
            # Sweep the dead incarnation's rendezvous keys.  Without this,
            # every rebuild leaks a `collective/<name>[@g<n>]/...` key set
            # per generation and long-lived groups (the persistent dp
            # gradient groups rebuild in place on rank death) would grow
            # the KV unboundedly.  Every survivor attempts it (idempotent
            # deletes; in replace mode the restarted rank may be rank 0
            # and never see this path).  Two keys classes are deliberately
            # NOT swept with their generation:
            #  - `{old_prefix}/dead/*` — a slow survivor may still be
            #    inside the dying op, and the dead marker is what lets it
            #    detect the death in seconds instead of burning the full
            #    op timeout (and missing this rendezvous).  Markers are
            #    reaped one rebuild LATER, once every survivor has
            #    provably left that generation.
            #  - `collective/<name>/gen` — the rejoin pointer lives under
            #    the gen-0 prefix; prefix-deleting `collective/<name>/`
            #    from a slow survivor would eat the pointer a fast
            #    survivor already re-advertised, stranding a restarted
            #    rank mid-rejoin.  Targeted deletes spare it.
            for r in range(old_world):
                self._kv("kv_del", ns="collective", key=f"{old_prefix}/{r}")
            self._kv("kv_del", ns="collective",
                     key=old_prefix + "/progress/", prefix=True)
            if self._gen >= 2:
                gp = (f"collective/{self.name}" if self._gen == 2
                      else f"collective/{self.name}@g{self._gen - 2}")
                self._kv("kv_del", ns="collective", key=gp + "/dead/",
                         prefix=True)
        except Exception:
            pass
        try:
            # advertise the generation so a restarted rank can rejoin
            self._kv("kv_put", ns="collective",
                     key=f"collective/{self.name}/gen",
                     value=str(self._gen).encode(), overwrite=True)
        except Exception:
            pass
        self._register(timeout_s)
        inc.stamp("rebuild")
        self._stamp_progress("rebuild", 0)
        # close (implicit resume stamp) emits recovery_seconds{collective}
        # plus the per-phase breakdown and the SLO verdict
        self.last_incident = inc.close()
        self._incident = None
        if flight_recorder.RECORDING:
            flight_recorder.record(
                "col.rebuilt", f"{self.name}@g{self._gen}")
        return self


def _payload_bytes(payload) -> int:
    if shm_ch.is_desc(payload):  # relayed descriptor: count the data bytes
        return shm_ch.desc_bytes(payload)
    if is_quantized(payload):
        return wire_bytes(payload)
    try:
        return int(np.asarray(payload).nbytes)
    except Exception:
        return 0


# ================================================================ public API
def _to_host(tensor):
    """A torch tensor crosses the host ring as a numpy array: a CUDA tensor
    is copied to the host at the op's entry (bf16, which numpy lacks, as
    f32), and ``back`` returns a result to the tensor's device and dtype at
    the exit.  Anything else passes as it is."""
    torch = sys.modules.get("torch")
    if torch is None or not isinstance(tensor, torch.Tensor):
        return tensor, lambda out: out
    device, dtype = tensor.device, tensor.dtype
    host = tensor.detach().cpu()
    if dtype == torch.bfloat16:
        host = host.float()

    def back(out):
        return torch.from_numpy(np.array(out)).to(device=device, dtype=dtype)

    return host.numpy(), back


def init_collective_group(world_size: int, rank: int, backend: str = "cpu",
                          group_name: str = "default") -> None:
    """Join a collective group from this process (reference: collective.py:120)."""
    if backend not in ("cpu", "gloo", "xla"):
        raise ValueError(f"unsupported backend {backend!r}; use 'cpu' or 'xla'")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world_size {world_size}")
    with _lock:
        if group_name in _groups:
            raise RuntimeError(f"collective group {group_name!r} already initialized")
        _groups[group_name] = Group(group_name, world_size, rank)


def get_or_init_collective_group(world_size: int, rank: int,
                                 backend: str = "cpu",
                                 group_name: str = "default") -> Group:
    """Idempotent :func:`init_collective_group` that returns the Group.

    Per-step callers (e.g. the dp gradient exchange, which needs the same
    ``train/<name>/stage<k>/dp`` group every training step) must REUSE one
    persistent group: re-initializing each step would leak a fresh set of
    rendezvous keys per step and re-pay the registration round trip.  A
    cached group is returned only when its membership matches; a mismatch
    is a caller bug and raises."""
    if backend not in ("cpu", "gloo", "xla"):
        raise ValueError(f"unsupported backend {backend!r}; use 'cpu' or 'xla'")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world_size {world_size}")
    with _lock:
        g = _groups.get(group_name)
        if g is not None:
            if g.world_size != world_size or g.rank != rank:
                raise RuntimeError(
                    f"collective group {group_name!r} already initialized "
                    f"with world_size={g.world_size}, rank={g.rank}; "
                    f"requested world_size={world_size}, rank={rank}")
            return g
        g = Group(group_name, world_size, rank)
        _groups[group_name] = g
        return g


def rejoin_collective_group(world_size: int, rank: int, backend: str = "cpu",
                            group_name: str = "default") -> None:
    """Join a group that surviving members re-formed with
    :meth:`Group.rebuild` (replace mode).  Polls the KV for the group's
    current generation (written by the survivors' rebuild), then registers
    under it.  The restarted process keeps the dead rank's number; the
    survivors must have passed the full ``world_size`` to ``rebuild`` so
    their rendezvous waits for this rank."""
    if backend not in ("cpu", "gloo", "xla"):
        raise ValueError(f"unsupported backend {backend!r}; use 'cpu' or 'xla'")
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world_size {world_size}")
    core = worker_mod.require_core()
    key = f"collective/{group_name}/gen"
    deadline = time.monotonic() + RayConfig.collective_rendezvous_timeout_s
    while True:
        blob = core.io.run(core.gcs_conn.call(
            "kv_get", {"ns": "collective", "key": key}))
        if blob:
            gen = int(bytes(blob).decode())
            break
        if time.monotonic() > deadline:
            raise CollectiveError(
                f"rejoin_collective_group({group_name!r}): no rebuilt "
                f"generation advertised in the KV after "
                f"{RayConfig.collective_rendezvous_timeout_s}s — did the "
                f"survivors call Group.rebuild()?")
        time.sleep(0.1)
    with _lock:
        # a pre-crash handle in this process (rejoin without restart) is
        # stale: its handler name belongs to the dead generation anyway
        _groups.pop(group_name, None)
        _groups[group_name] = Group(group_name, world_size, rank, gen=gen)


def _group(group_name: str) -> Group:
    g = _groups.get(group_name)
    if g is None:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized in this process")
    return g


def destroy_collective_group(group_name: str = "default") -> None:
    with _lock:
        g = _groups.pop(group_name, None)
    if g is not None:
        g.destroy()


def get_rank(group_name: str = "default") -> int:
    return _group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _group(group_name).world_size


# Every public op takes ``timeout_s`` (default
# RayConfig.collective_default_timeout_s): a gang with one absent rank
# raises CollectiveTimeout naming the laggard instead of hanging forever
# (enforced tree-wide by the `collective-timeout` lint rule).

def allreduce(tensor, group_name: str = "default", op: str = "sum",
              timeout_s: Optional[float] = None,
              quant: Optional[str] = None,
              topology: Optional[str] = None,
              quorum: Optional[int] = None):
    """Allreduce across the group.

    ``quant="int8"`` ships block-scaled int8 on the wire (4x fewer bytes,
    error bounded per hop; see quantization.py).  ``topology`` picks
    ``"ring"``/``"hier"``/``"auto"`` (auto: hierarchical when ranks span
    nodes and the payload clears ``collective_hier_min_bytes``).
    ``quorum=K`` returns once K ranks contribute and folds late
    contributions into the next quorum op (sum/mean only)."""
    tensor, back = _to_host(tensor)
    return back(_group(group_name).allreduce(tensor, op, timeout_s=timeout_s,
                                             quant=quant, topology=topology,
                                             quorum=quorum))


def allgather(tensor, group_name: str = "default",
              timeout_s: Optional[float] = None,
              quant: Optional[str] = None):
    """Gather every rank's tensor into a list indexed by rank.

    With ``quant="int8"`` every entry (including this rank's own) is the
    owner's quantize→dequantize round trip cast back to the owner's
    dtype — all ranks observe the identical list, at one quant stage of
    error per entry."""
    tensor, back = _to_host(tensor)
    return [back(x) for x in _group(group_name).allgather(
        tensor, timeout_s=timeout_s, quant=quant)]


def reducescatter(tensor, group_name: str = "default", op: str = "sum",
                  timeout_s: Optional[float] = None,
                  quant: Optional[str] = None):
    tensor, back = _to_host(tensor)
    return back(_group(group_name).reducescatter(tensor, op,
                                                 timeout_s=timeout_s,
                                                 quant=quant))


def broadcast(tensor, src_rank: int = 0, group_name: str = "default",
              timeout_s: Optional[float] = None,
              quant: Optional[str] = None,
              topology: Optional[str] = None):
    tensor, back = _to_host(tensor)
    return back(_group(group_name).broadcast(tensor, root=src_rank,
                                             timeout_s=timeout_s, quant=quant,
                                             topology=topology))


def send(tensor, dst_rank: int, group_name: str = "default", tag: int = 0,
         timeout_s: Optional[float] = None):
    _group(group_name).send(_to_host(tensor)[0], dst_rank, tag,
                            timeout_s=timeout_s)


def recv(src_rank: int, group_name: str = "default", tag: int = 0,
         timeout_s: Optional[float] = None):
    """Blocking p2p receive.  ``timeout_s`` (default
    RayConfig.collective_default_timeout_s, env
    RAY_TPU_TORCH_COLLECTIVE_DEFAULT_TIMEOUT_S) bounds the wait; on expiry
    CollectiveTimeout names the group, op, and lagging rank(s) instead of
    hanging forever."""
    return _group(group_name).recv(src_rank, tag, timeout_s=timeout_s)


def barrier(group_name: str = "default",
            timeout_s: Optional[float] = None):
    """Full-group barrier.  ``timeout_s`` semantics as in :func:`recv` — a
    gang with one absent rank raises CollectiveTimeout naming that rank."""
    _group(group_name).barrier(timeout_s=timeout_s)


def get_group_progress(group_name: str = "default") -> Dict[int, dict]:
    """Per-rank collective progress {rank: {seq, op, ts}} from the KV
    rendezvous — which rank is behind, without interrupting anyone."""
    return _group(group_name).progress()
