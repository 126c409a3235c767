"""Port of ``ray_tpu/_private/rpc.py``.

Asyncio RPC: bidirectional, multiplexed, zero-copy-friendly message transport.

Counterpart of the reference's gRPC wrapper layer (reference: src/ray/rpc/grpc_server.h,
client_call.h, server_call.h).  Design differences, deliberately TPU/host-native:

- One TCP (or unix-domain) connection per process pair, *bidirectional*: either side
  can issue requests, so pub/sub pushes and actor-task pushes ride the same socket
  instead of long-polling (reference pubsub uses long-poll, pubsub.proto:232).
- Frames carry pickle-5 out-of-band buffers natively: a numpy payload is written
  straight from its memoryview with no intermediate concatenation, and received as a
  view over the read buffer.  This is the host-DRAM data plane that feeds TPU
  infeed; the device-to-device plane is the collective layer, not RPC.
- Handlers are asyncio coroutines registered by method name; per-handler stats are
  recorded when RayConfig.event_stats is on (reference: common/event_stats.h).

Frame layout: [4B header_len][msgpack header][8B inband_len][inband pickle]
              [8B buf_len][buf bytes] * header["nbufs"]
Header: {"t": 0 req | 1 res | 2 err | 3 notify | 4 hello, "id": int,
"m": method} — hello frames carry version negotiation (see the protocol
contract block below).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import os
import pickle
import sys
import threading
import time
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

import msgpack

from ray_tpu_torch._private import fault_injection
from ray_tpu_torch._private.config import RayConfig

logger = logging.getLogger(__name__)

T_REQ, T_RES, T_ERR, T_NOTIFY, T_HELLO = 0, 1, 2, 3, 4

# ------------------------------------------------------- protocol contract
# Wire format (the IDL-lite; reference analogue: the protobuf service
# definitions in src/ray/protobuf — here the schema is this documented
# msgpack frame plus pickled payloads, deliberately codegen-free):
#
#   u32 header_len | msgpack header | u64 inband_len | pickled payload
#   | per-OOB-buffer: u64 len | raw bytes
#
# header: {"t": T_*, "id": int, "m": method, "nbufs": int}
#   T_REQ    request; "m" names an rpc_<m> handler on the peer
#   T_RES    response (same id); payload is the handler's return value
#   T_ERR    response (same id); payload is the raised exception
#   T_NOTIFY fire-and-forget request (id 0, no response)
#   T_HELLO  version/feature negotiation, sent once by the dialing side
#            immediately after connect: {"t": T_HELLO, "v": int,
#            "min": int, "features": [str], "name": str}.  The server
#            answers with its own T_HELLO.  A peer whose "min" exceeds
#            PROTOCOL_VERSION is refused (T_ERR + close).  Peers that
#            never send T_HELLO (older builds) keep working:
#            peer_version stays None and no feature gating applies.
#
# The per-method schema this frame carries (every registered handler, the
# request keys it reads, the reply keys it returns, every static call
# site) is extracted from the tree by the wire-contract lint pass and
# checked in as docs/WIRE_CONTRACT.md + ray_tpu_torch/_lint/wire_contract.json.
# Changing the wire surface without bumping PROTOCOL_VERSION below or
# regenerating the snapshot (`python -m ray_tpu_torch lint --update-contract`)
# is a wire-contract.drift finding anchored on the next line.
PROTOCOL_VERSION = 1
MIN_COMPATIBLE_VERSION = 1
PROTOCOL_FEATURES = ("pickle5-oob", "batched-tasks", "chunked-pull",
                     "task-events", "dag-channels", "rpc-batch")

_OOB_THRESHOLD = 64 * 1024  # RPC-level threshold for out-of-band buffers

# Messages whose encoded payload exceeds this ride their own frame instead
# of the per-tick batch: coalescing exists to amortize syscalls over SMALL
# control messages (seals, releases, ref-count updates), and batching a big
# payload would just add one memcpy in front of the same socket write.
_BATCH_INBAND_MAX = 32 * 1024
# The per-tick batch frame's method name.  Items are (t, id, method, inband)
# tuples; the receiver dispatches them in order inside one task.
_BATCH_METHOD = "__batch__"

Handler = Callable[["Connection", Any], Awaitable[Any]]


class ConnectionLost(ConnectionError):
    pass


class RaySerializationError(RuntimeError):
    """A message payload could not be encoded/decoded; fails one call, not the link."""


def _encode(obj: Any) -> Tuple[bytes, list]:
    buffers: list = []

    def cb(pb: pickle.PickleBuffer) -> bool:
        mv = pb.raw()
        if mv.nbytes < _OOB_THRESHOLD:
            return True
        buffers.append(mv)
        return False

    try:
        inband = pickle.dumps(obj, protocol=5, buffer_callback=cb)
    except Exception:
        # Control-plane payloads are plain data; anything exotic (closures,
        # locally-defined exception classes) falls back to cloudpickle.
        import cloudpickle

        buffers.clear()
        inband = cloudpickle.dumps(obj, protocol=5, buffer_callback=cb)
    return inband, buffers


class Connection:
    """A bidirectional RPC peer over one stream."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        handlers: Dict[str, Handler],
        on_close: Optional[Callable[["Connection"], None]] = None,
        name: str = "",
    ):
        self._reader = reader
        self._writer = writer
        self._handlers = handlers
        self._on_close = on_close
        self.name = name
        self._id_gen = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._dispatch_tasks: set = set()
        # Per-tick coalescing buffer: (t, id, method, inband) items flushed
        # as ONE __batch__ frame by a call_soon callback — N small control
        # messages cost one syscall instead of N (see notify_coalesced /
        # call_pipelined).
        self._obuf: list = []
        self._obuf_scheduled = False
        self._closed = False
        self._loop = asyncio.get_event_loop()
        self._send_lock = asyncio.Lock()
        self._recv_task = self._loop.create_task(self._recv_loop())
        self._handler_stats: Dict[str, list] = {}
        # Arbitrary metadata slot for the server side (e.g. registered worker id).
        self.context: Dict[str, Any] = {}
        # Version negotiation state (None until the peer's T_HELLO arrives;
        # stays None for pre-handshake peers, which remain fully supported).
        self.peer_version: Optional[int] = None
        self.peer_features: frozenset = frozenset()
        self.peer_name: str = ""

    @property
    def closed(self) -> bool:
        return self._closed

    def peername(self):
        try:
            return self._writer.get_extra_info("peername")
        except Exception:
            return None

    # Below this, a chunk is coalesced into one write; above it, handed to
    # the transport as-is (coalescing would memcpy a large payload just to
    # save a syscall).
    _COALESCE_MAX = 64 * 1024

    async def _send_frame(self, header: dict, inband: bytes, buffers: list):
        if fault_injection.ENABLED:
            act = fault_injection.hit("rpc.frame.send",
                                      detail=header.get("m") or "")
            if act == "drop":
                return
            if act == "delay":
                await asyncio.sleep(fault_injection.delay_s())
            elif act == "sever":
                self._writer.close()
                raise ConnectionLost("chaos: link severed")
            elif act == "dup":
                await self._send_frame_raw(header, inband, buffers)
        await self._send_frame_raw(header, inband, buffers)

    async def _send_frame_raw(self, header: dict, inband: bytes,
                              buffers: list):
        header_b = msgpack.packb(header)
        async with self._send_lock:
            # Coalesce the small chunks (length prefixes, header, small
            # inband) into ONE transport write: each StreamWriter.write is an
            # eager socket send, and per-frame syscall count dominates small-
            # RPC cost (measured ~0.15 ms/syscall on 1-vCPU virtio).
            w = self._writer
            pending = bytearray()

            def emit(chunk):
                if len(chunk) < self._COALESCE_MAX:
                    pending.extend(chunk)
                else:
                    if pending:
                        w.write(bytes(pending))
                        pending.clear()
                    w.write(chunk)

            emit(len(header_b).to_bytes(4, "little"))
            emit(header_b)
            emit(len(inband).to_bytes(8, "little"))
            emit(inband)
            for b in buffers:
                emit(b.nbytes.to_bytes(8, "little"))
                emit(b)
            if pending:
                w.write(bytes(pending))
            await w.drain()

    async def call(self, method: str, obj: Any = None, timeout: Optional[float] = None) -> Any:
        if self._closed:
            raise ConnectionLost(f"connection {self.name} is closed")
        inband, buffers = _encode(obj)  # encode before registering: may raise
        req_id = next(self._id_gen)
        fut = self._loop.create_future()
        self._pending[req_id] = fut
        try:
            await self._send_frame({"t": T_REQ, "id": req_id, "m": method, "nbufs": len(buffers)}, inband, buffers)
        except (ConnectionError, OSError) as e:
            self._pending.pop(req_id, None)
            raise ConnectionLost(str(e)) from e
        try:
            if timeout is not None:
                return await asyncio.wait_for(fut, timeout)
            return await fut
        finally:
            self._pending.pop(req_id, None)

    def call_sync(self, method: str, obj: Any = None, timeout: Optional[float] = None) -> Any:
        """Thread-safe blocking call from outside the event loop."""
        fut = asyncio.run_coroutine_threadsafe(self.call(method, obj, timeout), self._loop)
        return fut.result()

    async def notify(self, method: str, obj: Any = None):
        if self._closed:
            raise ConnectionLost(f"connection {self.name} is closed")
        inband, buffers = _encode(obj)
        try:
            await self._send_frame({"t": T_NOTIFY, "id": 0, "m": method, "nbufs": len(buffers)}, inband, buffers)
        except (ConnectionError, OSError) as e:
            raise ConnectionLost(str(e)) from e

    def notify_sync(self, method: str, obj: Any = None, timeout: Optional[float] = 30.0):
        fut = asyncio.run_coroutine_threadsafe(self.notify(method, obj), self._loop)
        return fut.result(timeout)

    # ------------------------------------------------ coalesced control plane
    # Small control frames (seal/release/ref-count/metric/event pushes) were
    # one frame + one syscall + often one round trip EACH; on a shared-core
    # host the per-frame cost dominates the control plane.  The batch layer
    # buffers items for one loop tick and ships them as a single __batch__
    # frame; the receiver dispatches them in order inside one task.

    def notify_coalesced(self, method: str, obj: Any = None) -> None:
        """Fire-and-forget notify riding the per-tick batch frame.  MUST be
        called from the IO-loop thread (use notify_coalesced_threadsafe
        elsewhere).  Large/out-of-band payloads fall back to a plain notify
        frame."""
        if self._closed:
            raise ConnectionLost(f"connection {self.name} is closed")
        inband, buffers = _encode(obj)
        if buffers or len(inband) > _BATCH_INBAND_MAX:
            self._spawn_task(self._notify_quietly(method, inband, buffers))
            return
        self._queue_batch_item(T_NOTIFY, 0, method, inband)

    def notify_coalesced_threadsafe(self, method: str, obj: Any = None) -> None:
        """notify_coalesced from any thread: the payload is encoded on the
        caller's thread (keeping pickling off the IO loop) and the queue
        append hops to the loop."""
        if self._closed:
            raise ConnectionLost(f"connection {self.name} is closed")
        inband, buffers = _encode(obj)
        try:
            if buffers or len(inband) > _BATCH_INBAND_MAX:
                self._loop.call_soon_threadsafe(
                    self._spawn_task,
                    self._notify_quietly(method, inband, buffers))
            else:
                self._loop.call_soon_threadsafe(
                    self._queue_batch_item, T_NOTIFY, 0, method, inband)
        except RuntimeError:
            pass  # loop closed: shutdown path, drop like a lost notify

    async def _notify_quietly(self, method: str, inband: bytes, buffers: list):
        try:
            await self._send_frame(
                {"t": T_NOTIFY, "id": 0, "m": method, "nbufs": len(buffers)},
                inband, buffers)
        except (ConnectionError, OSError):
            pass  # fire-and-forget semantics match notify-on-dead-peer

    async def call_pipelined(self, method: str, obj: Any = None,
                             timeout: Optional[float] = None) -> Any:
        """Like call(), but the request frame rides the per-tick batch, so N
        same-tick requests cost one write.  For small, fast handlers only —
        batched requests are dispatched sequentially on the receiver."""
        if self._closed:
            raise ConnectionLost(f"connection {self.name} is closed")
        inband, buffers = _encode(obj)
        if buffers or len(inband) > _BATCH_INBAND_MAX:
            return await self.call(method, obj, timeout)
        req_id = next(self._id_gen)
        fut = self._loop.create_future()
        self._pending[req_id] = fut
        self._queue_batch_item(T_REQ, req_id, method, inband)
        try:
            if timeout is not None:
                return await asyncio.wait_for(fut, timeout)
            return await fut
        finally:
            self._pending.pop(req_id, None)

    def _queue_batch_item(self, t: int, rid: int, method: str,
                          inband: bytes) -> None:
        if self._closed:
            return  # pending REQ futures are failed by _shutdown
        self._obuf.append((t, rid, method, inband))
        if not self._obuf_scheduled:
            self._obuf_scheduled = True
            self._loop.call_soon(self._flush_obuf)

    def _flush_obuf(self) -> None:
        self._obuf_scheduled = False
        if not self._obuf:
            return
        items, self._obuf = self._obuf, []
        if self._closed:
            return
        self._spawn_task(self._send_batch(items))

    async def _send_batch(self, items: list) -> None:
        inband, buffers = _encode(items)
        try:
            await self._send_frame(
                {"t": T_NOTIFY, "id": 0, "m": _BATCH_METHOD,
                 "nbufs": len(buffers)}, inband, buffers)
        except (ConnectionError, OSError) as e:
            # REQ items' futures are registered in _pending: fail them like
            # a lost connection would (the recv loop may not notice yet).
            for t, rid, _m, _b in items:
                if t == T_REQ:
                    fut = self._pending.pop(rid, None)
                    if fut is not None and not fut.done():
                        fut.set_exception(ConnectionLost(str(e)))

    async def _dispatch_batch(self, items: list) -> None:
        """Receiver side of the batch frame: items run in order, one task."""
        for item in items:
            try:
                t, rid, method, inband = item
                obj = pickle.loads(inband)
            except Exception as decode_err:
                self._handle_decode_error(
                    {"id": item[1] if len(item) > 1 else 0,
                     "m": item[2] if len(item) > 2 else "?"},
                    item[0] if item else T_NOTIFY, decode_err)
                continue
            if t == T_REQ:
                await self._dispatch({"t": t, "id": rid, "m": method}, obj)
            elif t == T_NOTIFY:
                await self._dispatch({"t": t, "id": 0, "m": method}, obj,
                                     needs_reply=False)
            elif t in (T_RES, T_ERR):
                fut = self._pending.pop(rid, None)
                if fut is not None and not fut.done():
                    if t == T_RES:
                        fut.set_result(obj)
                    elif isinstance(obj, BaseException):
                        fut.set_exception(obj)
                    else:
                        fut.set_exception(RaySerializationError(
                            f"malformed error reply: {obj!r}"))

    async def _read_exactly(self, n: int) -> bytes:
        return await self._reader.readexactly(n)

    async def _recv_loop(self):
        try:
            while True:
                hlen = int.from_bytes(await self._read_exactly(4), "little")
                header = msgpack.unpackb(await self._read_exactly(hlen))
                ilen = int.from_bytes(await self._read_exactly(8), "little")
                inband = await self._read_exactly(ilen)
                buffers = []
                for _ in range(header.get("nbufs", 0)):
                    blen = int.from_bytes(await self._read_exactly(8), "little")
                    buffers.append(await self._read_exactly(blen))
                t = header["t"]
                try:
                    obj = pickle.loads(inband, buffers=buffers)
                except Exception as decode_err:
                    # A bad payload fails only this message, not the connection.
                    self._handle_decode_error(header, t, decode_err)
                    continue
                if t == T_HELLO:
                    self._on_hello(header)
                    continue
                if t == T_NOTIFY and header.get("m") == _BATCH_METHOD:
                    # coalesced control frame: dispatch items in order
                    # inside ONE task (an asyncio task per item would
                    # recreate the overhead batching removes)
                    self._spawn_task(self._dispatch_batch(obj))
                elif t == T_REQ:
                    self._spawn_dispatch(header, obj)
                elif t == T_NOTIFY:
                    self._spawn_dispatch(header, obj, needs_reply=False)
                elif t == T_ERR and header.get("m") == "__hello__":
                    # handshake refusal: no pending future carries id 0 —
                    # surface the cause loudly before the peer closes on us
                    logger.error("peer refused connection %s at handshake: "
                                 "%s", self.name, obj)
                    for fut in list(self._pending.values()):
                        if not fut.done():
                            fut.set_exception(
                                obj if isinstance(obj, BaseException)
                                else ConnectionLost(str(obj)))
                    self._pending.clear()
                elif t in (T_RES, T_ERR):
                    fut = self._pending.pop(header["id"], None)
                    if fut is not None and not fut.done():
                        if t == T_RES:
                            fut.set_result(obj)
                        elif isinstance(obj, BaseException):
                            fut.set_exception(obj)
                        else:
                            fut.set_exception(
                                RaySerializationError(f"malformed error reply: {obj!r}")
                            )
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        except asyncio.CancelledError:
            return
        except Exception:
            logger.exception("rpc recv loop error on %s", self.name)
        finally:
            await self._shutdown()

    def _on_hello(self, header: dict) -> None:
        """Record the peer's protocol version/features; answer a dialing
        peer's hello with ours (ack'd, so the exchange terminates)."""
        self.peer_version = header.get("v")
        self.peer_features = frozenset(header.get("features") or ())
        self.peer_name = header.get("name") or ""
        peer_min = header.get("min", header.get("v", 0))
        reason = None
        if peer_min is not None and peer_min > PROTOCOL_VERSION:
            reason = (f"peer needs protocol >= {peer_min}, this build "
                      f"speaks {PROTOCOL_VERSION}")
        elif (self.peer_version or 0) < MIN_COMPATIBLE_VERSION:
            reason = (f"peer speaks protocol {self.peer_version}, this "
                      f"build requires >= {MIN_COMPATIBLE_VERSION}")
        if reason is not None:
            logger.error("refusing connection %s: %s",
                         self.peer_name or self.name, reason)

            async def refuse():
                try:
                    inband, buffers = _encode(ConnectionLost(
                        f"incompatible protocol: {reason}"))
                    await self._send_frame(
                        {"t": T_ERR, "id": 0, "m": "__hello__",
                         "nbufs": len(buffers)}, inband, buffers)
                finally:
                    await self._shutdown()

            self._spawn_task(refuse())
            return
        if not header.get("ack"):
            async def _ack():
                try:
                    await self.send_hello(ack=True)
                except (ConnectionError, OSError):
                    pass  # peer vanished between hello and ack

            self._spawn_task(_ack())

    async def send_hello(self, ack: bool = False) -> None:
        """Raises ConnectionError/OSError if the link is already dead — the
        dialing side's connect() retry loop relies on that; the server-side
        ack path wraps it (a reply to a vanished peer is a no-op)."""
        inband, buffers = _encode(None)
        await self._send_frame(
            {"t": T_HELLO, "v": PROTOCOL_VERSION,
             "min": MIN_COMPATIBLE_VERSION,
             "features": list(PROTOCOL_FEATURES), "name": self.name,
             "ack": ack, "id": 0, "m": "__hello__",
             "nbufs": len(buffers)}, inband, buffers)

    def _handle_decode_error(self, header: dict, t: int, decode_err: Exception):
        names = ("REQ", "RES", "ERR", "NOTIFY", "HELLO")
        err = RaySerializationError(
            f"failed to decode {names[t] if t < len(names) else t} payload "
            f"for method {header.get('m')!r}: {decode_err!r}"
        )
        if t in (T_RES, T_ERR):
            fut = self._pending.pop(header["id"], None)
            if fut is not None and not fut.done():
                fut.set_exception(err)
        elif t == T_REQ:
            async def reply_err():
                try:
                    inband, buffers = _encode(err)
                    await self._send_frame(
                        {"t": T_ERR, "id": header["id"], "m": header.get("m"), "nbufs": len(buffers)},
                        inband,
                        buffers,
                    )
                except (ConnectionError, OSError):
                    pass
            self._spawn_task(reply_err())
        else:
            logger.warning("dropping undecodable notify: %s", err)

    def _spawn_dispatch(self, header: dict, obj: Any, needs_reply: bool = True):
        self._spawn_task(self._dispatch(header, obj, needs_reply=needs_reply))

    def _spawn_task(self, coro):
        # Keep a strong reference: asyncio only holds weak refs to tasks, so an
        # in-flight handler could otherwise be garbage-collected mid-run.
        task = self._loop.create_task(coro)
        self._dispatch_tasks.add(task)
        task.add_done_callback(self._dispatch_tasks.discard)

    async def _dispatch(self, header: dict, obj: Any, needs_reply: bool = True):
        method = header["m"]
        handler = self._handlers.get(method)
        start = time.monotonic() if RayConfig.event_stats else 0.0
        # Run the handler first; a ConnectionError raised *by the handler*
        # (e.g. it forwarded work to a dead peer) is an application error and
        # must still produce a T_ERR reply — only failures sending on *this*
        # connection are swallowed.
        result: Any = None
        error: Optional[BaseException] = None
        try:
            if handler is None:
                raise AttributeError(f"no rpc handler for method {method!r}")
            result = await handler(self, obj)
        except asyncio.CancelledError:
            raise
        except BaseException as e:
            error = e
        try:
            if needs_reply:
                if error is None:
                    inband, buffers = _encode(result)
                    if not buffers and len(inband) <= _BATCH_INBAND_MAX:
                        # small reply: ride the per-tick batch so a burst of
                        # same-tick completions answers in one frame
                        self._queue_batch_item(
                            T_RES, header["id"], method, inband)
                    else:
                        await self._send_frame({"t": T_RES, "id": header["id"], "m": method, "nbufs": len(buffers)}, inband, buffers)
                elif not self._closed:
                    try:
                        inband, buffers = _encode(error)
                    except Exception:
                        inband, buffers = _encode(RuntimeError(f"unpicklable handler error: {error!r}"))
                    await self._send_frame({"t": T_ERR, "id": header["id"], "m": method, "nbufs": len(buffers)}, inband, buffers)
            elif error is not None:
                logger.error("error in notify handler %s: %r", method, error)
        except (ConnectionError, OSError):
            pass
        finally:
            if RayConfig.event_stats:
                dt = time.monotonic() - start
                st = self._handler_stats.setdefault(method, [0, 0.0])
                st[0] += 1
                st[1] += dt

    def handler_stats(self) -> Dict[str, Tuple[int, float]]:
        return {k: (v[0], v[1]) for k, v in self._handler_stats.items()}

    async def _shutdown(self):
        if self._closed:
            return
        self._closed = True
        self._obuf.clear()  # queued REQ items fail via the pending sweep
        for fut in list(self._pending.values()):
            if not fut.done():
                fut.set_exception(ConnectionLost(f"connection {self.name} lost"))
        self._pending.clear()
        # Cancel in-flight inbound handlers: they act on behalf of a peer that
        # can no longer receive the reply.
        for task in list(self._dispatch_tasks):
            task.cancel()
        try:
            self._writer.close()
        except Exception:
            pass
        if self._on_close is not None:
            try:
                self._on_close(self)
            except Exception:
                logger.exception("on_close callback failed")

    async def close(self):
        self._recv_task.cancel()
        await self._shutdown()

    def close_threadsafe(self):
        asyncio.run_coroutine_threadsafe(self.close(), self._loop)


class Server:
    """RPC server: accepts connections, each becomes a bidirectional Connection."""

    def __init__(self, handlers: Dict[str, Handler], name: str = "server"):
        self.handlers = handlers
        self.name = name
        self._server: Optional[asyncio.AbstractServer] = None
        self.connections: set = set()
        self.on_disconnect: Optional[Callable[[Connection], None]] = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
        self._server = await asyncio.start_server(self._accept, host=host, port=port)
        sock = self._server.sockets[0]
        addr = sock.getsockname()
        return addr[0], addr[1]

    async def _accept(self, reader, writer):
        conn = Connection(reader, writer, self.handlers, on_close=self._handle_close, name=f"{self.name}-peer")
        self.connections.add(conn)

    def _handle_close(self, conn: Connection):
        self.connections.discard(conn)
        if self.on_disconnect is not None:
            try:
                self.on_disconnect(conn)
            except Exception:
                logger.exception("on_disconnect failed")

    async def stop(self):
        # Close live connections before wait_closed(): since py3.12 wait_closed
        # blocks until every connection handed out by start_server is closed.
        for conn in list(self.connections):
            await conn.close()
        if self._server is not None:
            self._server.close()
            try:
                await self._server.wait_closed()
            except Exception:
                pass


async def connect(
    host: str,
    port: int,
    handlers: Optional[Dict[str, Handler]] = None,
    name: str = "client",
    retry_timeout_s: float = 10.0,
) -> Connection:
    """Dial a server, retrying while it boots."""
    deadline = time.monotonic() + retry_timeout_s
    delay = 0.05
    while True:
        try:
            reader, writer = await asyncio.open_connection(host, port)
            conn = Connection(reader, writer, handlers or {}, name=name)
            # fire-and-forget version negotiation: the reply sets
            # conn.peer_version whenever the server speaks hello
            await conn.send_hello()
            return conn
        except (ConnectionError, OSError):
            if time.monotonic() >= deadline:
                raise
            await asyncio.sleep(delay)
            delay = min(delay * 2, 1.0)


class EventLoopThread:
    """A dedicated thread running an asyncio loop — the per-process 'io_service'.

    Counterpart of the reference's instrumented asio event loop
    (src/ray/common/asio/).  User/task code stays on the main thread; all RPC IO
    happens here.
    """

    def __init__(self, name: str = "ray-tpu-io",
                 stall_threshold_s: Optional[float] = None):
        self.loop = asyncio.new_event_loop()
        self.name = name
        self._beat = time.monotonic()
        self._stall_logged = 0.0
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()
        if stall_threshold_s is None:
            # env re-read per loop start (set_env retunes live processes);
            # the registered flag carries the typed default
            try:
                env = os.environ.get("RAY_TPU_TORCH_LOOP_STALL_THRESHOLD_S")
                from ray_tpu_torch._private.config import RayConfig

                stall_threshold_s = float(env) if env is not None \
                    else RayConfig.loop_stall_threshold_s
            except ValueError:
                stall_threshold_s = 5.0  # a bad knob must not kill startup
        if stall_threshold_s > 0:
            self._start_stall_detector(stall_threshold_s)

    def _run(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    # ---------------------------------------------------- stall detection
    def _start_stall_detector(self, threshold_s: float) -> None:
        """Watchdog for the 'one slow handler starves every connection'
        class of bug (reference: the instrumented asio event loop's
        event_stats + stall warnings, src/ray/common/asio/).  A heartbeat
        callback stamps the loop's liveness; a daemon thread warns — with
        the loop thread's current stack — whenever the stamp goes stale."""
        import traceback

        def beat():
            self._beat = time.monotonic()
            if not self.loop.is_closed():
                self.loop.call_later(min(threshold_s / 4, 1.0), beat)

        try:
            self.loop.call_soon_threadsafe(beat)
        except RuntimeError:
            return

        def watch():
            while self._thread.is_alive() and not self.loop.is_closed():
                time.sleep(threshold_s / 2)
                stalled = time.monotonic() - self._beat
                if stalled > threshold_s and \
                        time.monotonic() - self._stall_logged > 30.0:
                    self._stall_logged = time.monotonic()
                    frame = sys._current_frames().get(self._thread.ident)
                    where = "".join(traceback.format_stack(frame)) \
                        if frame is not None else "<no frame>"
                    logger.warning(
                        "event loop %r stalled for %.1fs — a handler is "
                        "blocking the IO thread; current stack:\n%s",
                        self.name, stalled, where)

        threading.Thread(target=watch, name=f"{self.name}-stall-watch",
                         daemon=True).start()

    def run(self, coro, timeout: Optional[float] = None):
        """Run a coroutine on the loop, blocking the calling thread."""
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def on_loop_thread(self) -> bool:
        """True when the caller IS the IO-loop thread.  Any blocking call
        (call_sync / run) from the loop thread deadlocks the loop — callers
        use this to downgrade to fire-and-forget."""
        return threading.current_thread() is self._thread

    def spawn(self, coro) -> "asyncio.Future":
        return asyncio.run_coroutine_threadsafe(coro, self.loop)

    def stop(self):
        def _cancel_all():
            for task in asyncio.all_tasks(self.loop):
                task.cancel()
            # Stop on a later callback so cancelled tasks get a chance to run
            # their finally blocks before the loop halts.
            self.loop.call_soon(self.loop.stop)

        # call_soon_threadsafe works whether or not run_forever has started yet;
        # it fails only once the loop is closed.
        try:
            self.loop.call_soon_threadsafe(_cancel_all)
        except RuntimeError:
            pass  # loop already closed
        self._thread.join(timeout=5)
        if not self.loop.is_running() and not self.loop.is_closed():
            self.loop.close()
