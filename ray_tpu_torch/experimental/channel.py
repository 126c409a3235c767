"""Port of ``ray_tpu/experimental/channel.py``.

Pre-arranged shared-memory channels for compiled DAGs.

Counterpart of the reference's mutable-plasma channels (reference:
python/ray/experimental/channel/shared_memory_channel.py,
src/ray/core_worker/experimental_mutable_object_manager.h): a compiled DAG's
edges are fixed at compile time, so each edge gets a persistent
single-producer/single-consumer ring in POSIX shared memory.  Data moves by
one memcpy with NO per-message runtime involvement — no lease, no RPC frame,
no event-loop hop.  The reference's NCCL device channels
(torch_tensor_nccl_channel.py:191) have no single-host TPU analogue; on-chip
tensors cross process boundaries via host shm here, and multi-chip device
transfer rides the collective layer instead.

Like the reference's channel runtime, the hot path is NATIVE where it
matters: when ``ray_tpu_torch._native`` builds (g++, first use), waits block on a
shared futex and payload copies run with the GIL released
(_native/channel.cpp).  Without it, a pure-Python spin/backoff path provides
the same semantics — both sides interoperate through the same ring layout.

Layout (little-endian u64s):
    [0]  head      — messages written (producer-owned)
    [8]  tail      — messages consumed (consumer-owned)
    [16] slot_size
    [24] depth
    [32] futex word (u32; bumped on every publish) + 4B pad
    slots: depth x (u64 length + slot_size payload bytes)

Aligned 8-byte stores are atomic and each counter has exactly one writer, so
the ring needs no lock on x86-64, whose TSO memory model also guarantees the
payload stores are visible before the head publish.  Weakly-ordered ISAs
(ARM64) would need a release/acquire barrier Python cannot express — TPU
hosts are x86-64, so that port is out of scope.
"""

from __future__ import annotations

import ctypes
import pickle
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Optional

from ray_tpu_torch._private.serialization import (SerializedObject,
                                            get_serialization_context)

_HDR = 40
_SLOT_HDR = 8

# Sentinel lengths (no payload).
_LEN_CLOSE = (1 << 64) - 1

# First byte of a SerializedObject channel frame.  A protocol-5 pickle
# always starts with the PROTO opcode (0x80), so a reader can tell the two
# payload kinds apart and stay compatible with raw-pickle producers
# (write_bytes of pickle.dumps output, e.g. compiled-DAG error frames).
# Surfaced in the generated wire contract's frame-type table as DATA_SER
# (docs/WIRE_CONTRACT.md) — the data plane's counterpart to rpc.py's T_*.
_SER_FRAME_MAGIC = 0x93

# Chunk size for scatter-gather TCP sends: large OOB buffers are sliced
# zero-copy, only sub-chunk header/tail pieces get stitched.
_TCP_CHUNK = 256 * 1024


def _loads_payload(payload) -> Any:
    """Decode one channel payload.  SerializedObject frames (magic byte)
    deserialize through the SerializationContext with buffer views aliasing
    ``payload`` — zero further copies; anything else is a raw pickle from a
    legacy ``write_bytes`` producer."""
    if payload and payload[0] == _SER_FRAME_MAGIC:
        ser = SerializedObject.from_buffer(memoryview(payload)[1:])
        return get_serialization_context().deserialize(ser)
    return pickle.loads(payload)


class ChannelClosed(Exception):
    pass


class ChannelFull(Exception):
    pass


def _native_wanted() -> bool:
    """Native futex channels by default on multi-core hosts; measured on a
    single shared core the calibrated sleep-backoff of the Python path
    syncs the two processes faster than futex wake round-trips (434 vs
    988 us ping-pong), so 1-core hosts stay on the fallback.  Override
    with RAY_TPU_TORCH_NATIVE_CHANNEL=1/0."""
    import os

    env = os.environ.get("RAY_TPU_TORCH_NATIVE_CHANNEL")
    if env is None:
        from ray_tpu_torch._private.config import RayConfig

        env = RayConfig.native_channel or None  # '' = auto-select
    if env is not None:
        return env.strip().lower() not in ("0", "false", "no", "off", "")
    return (os.cpu_count() or 1) > 1


def _attach(name: str) -> shared_memory.SharedMemory:
    shm = shared_memory.SharedMemory(name=name)
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # type: ignore[attr-defined]
    except Exception:
        pass
    return shm


class ShmChannel:
    """One SPSC ring.  ``create=True`` allocates (owner unlinks); readers and
    writers attach by name."""

    def __init__(self, name: Optional[str] = None, *, create: bool = False,
                 slot_size: int = 1 << 20, depth: int = 2):
        if create:
            size = _HDR + depth * (_SLOT_HDR + slot_size)
            self._shm = shared_memory.SharedMemory(create=True, size=size)
            # stay registered with the resource tracker: our close() unlinks,
            # which also unregisters (3.12); a crashed driver then still gets
            # tracker cleanup instead of leaking /dev/shm segments
            self._owner = True
            buf = self._shm.buf
            buf[:_HDR] = b"\x00" * _HDR
            buf[16:24] = slot_size.to_bytes(8, "little")
            buf[24:32] = depth.to_bytes(8, "little")
        else:
            assert name is not None
            self._shm = _attach(name)
            self._owner = False
        buf = self._shm.buf
        self.slot_size = int.from_bytes(buf[16:24], "little")
        self.depth = int.from_bytes(buf[24:32], "little")
        self.name = self._shm.name
        self._lib = None
        self._cbuf = None
        if _native_wanted():
            from ray_tpu_torch._native import channel_lib

            self._lib = channel_lib()
        if self._lib is not None:
            self._cbuf = (ctypes.c_char * self._shm.size).from_buffer(
                self._shm.buf)

    # ------------------------------------------------------------ counters
    def _head(self) -> int:
        return int.from_bytes(self._shm.buf[0:8], "little")

    def _tail(self) -> int:
        return int.from_bytes(self._shm.buf[8:16], "little")

    def _bump(self) -> None:
        """Publish notification: bump the shared futex word (native waiters
        re-check on every bump) and FUTEX_WAKE when the lib is loaded.

        The Python read-modify-write here is NOT atomic against a peer's
        native ``fetch_add``; a lost increment is tolerated by design — a
        native waiter that slept through the publish re-polls within 50 ms
        (the C side's re-poll cap in ch_wait, _native/channel.cpp), so the
        worst case is bounded extra latency, never a lost message."""
        buf = self._shm.buf
        word = int.from_bytes(buf[32:36], "little")
        buf[32:36] = ((word + 1) & 0xFFFFFFFF).to_bytes(4, "little")
        if self._lib is not None:
            self._lib.ch_wake(self._cbuf)

    def _set_head(self, v: int) -> None:
        self._shm.buf[0:8] = v.to_bytes(8, "little")
        self._bump()

    def _set_tail(self, v: int) -> None:
        self._shm.buf[8:16] = v.to_bytes(8, "little")
        self._bump()

    def _slot(self, i: int):
        return _HDR + (i % self.depth) * (_SLOT_HDR + self.slot_size)

    @staticmethod
    def _wait(cond, timeout: Optional[float]):
        """Pure-Python hybrid wait: yield-spin briefly, then sleep with
        backoff (used only when the native lib is unavailable)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        spin = 0
        delay = 20e-6
        while not cond():
            if spin < 100:
                spin += 1
                time.sleep(0)  # drop the GIL / yield the core
                continue
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("channel wait timed out")
            time.sleep(delay)
            delay = min(delay * 2, 2e-3)

    # -------------------------------------------------------------- write
    def _native_wait(self, fn, timeout: Optional[float], *args) -> int:
        """Run a native wait, slicing indefinite waits into 0.5 s chunks so
        Python-level signals (KeyboardInterrupt) still fire between calls —
        C never returns to the interpreter mid-wait."""
        if timeout is not None:
            return fn(self._cbuf, float(timeout), *args)
        while True:
            rc = fn(self._cbuf, 0.5, *args)
            if rc != -1:
                return rc

    def wait_writable(self, timeout: Optional[float] = None) -> None:
        """Block until the ring has room.  With a single producer the room
        cannot disappear before the producer's own next write."""
        if self._lib is not None:
            rc = self._native_wait(self._lib.ch_wait_writable, timeout)
            if rc != 0:
                raise TimeoutError("channel wait timed out")
            return
        head = self._head()
        self._wait(lambda: head - self._tail() < self.depth, timeout)

    def write_bytes(self, payload: bytes, timeout: Optional[float] = None) -> None:
        n = len(payload)
        if n > self.slot_size:
            raise ChannelFull(
                f"message of {n} bytes exceeds channel slot size "
                f"{self.slot_size}; recompile with a larger max_buf")
        if self._lib is not None:
            self.wait_writable(timeout)
            rc = self._lib.ch_write(self._cbuf, payload, n, 0.5)
            if rc != 0:  # -2 (oversize) is unreachable: checked above
                raise TimeoutError("channel wait timed out")
            return
        head = self._head()
        self._wait(lambda: head - self._tail() < self.depth, timeout)
        off = self._slot(head)
        buf = self._shm.buf
        buf[off + _SLOT_HDR:off + _SLOT_HDR + n] = payload
        buf[off:off + _SLOT_HDR] = n.to_bytes(8, "little")
        self._set_head(head + 1)

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        self.write_serialized(get_serialization_context().serialize(value),
                              timeout)

    def write_serialized(self, ser, timeout: Optional[float] = None) -> None:
        """Scatter-gather a SerializedObject frame (pickle-5 out-of-band
        buffers) straight into the ring slot: one memcpy per source buffer
        into shared memory, no intermediate pickle flatten.  Works in both
        native and pure-Python modes — the ring layout is shared, and the
        head publish below matches _bump's tolerated-lost-increment futex
        semantics."""
        if not ser.buffers:
            # no OOB buffers: the in-band pickle IS the whole payload, and
            # the raw-pickle wire form (0x80 first byte) is cheaper than a
            # frame for the small-message hot path
            self.write_bytes(ser.inband, timeout)
            return
        n = 1 + ser.total_frame_bytes()
        if n > self.slot_size:
            raise ChannelFull(
                f"message of {n} bytes exceeds channel slot size "
                f"{self.slot_size}; recompile with a larger max_buf")
        self.wait_writable(timeout)
        head = self._head()
        off = self._slot(head)
        buf = self._shm.buf
        buf[off + _SLOT_HDR] = _SER_FRAME_MAGIC
        ser.write_into(buf[off + _SLOT_HDR + 1:off + _SLOT_HDR + n])
        buf[off:off + _SLOT_HDR] = n.to_bytes(8, "little")
        self._set_head(head + 1)

    def close_write(self, timeout: float = 60.0) -> None:
        """Producer EOF: wakes the consumer with a close sentinel.  Waits
        out a full ring (a slow consumer must still drain the buffered
        messages first); only a consumer gone for `timeout` loses the
        sentinel."""
        try:
            self.wait_writable(timeout)
            head = self._head()
            off = self._slot(head)
            self._shm.buf[off:off + _SLOT_HDR] = _LEN_CLOSE.to_bytes(8, "little")
            self._set_head(head + 1)
        except (TimeoutError, ValueError):
            pass

    # --------------------------------------------------------------- read
    def read_bytes(self, timeout: Optional[float] = None) -> bytes:
        if self._lib is not None:
            n = ctypes.c_uint64()
            rc = self._native_wait(self._lib.ch_wait_readable, timeout,
                                   ctypes.byref(n))
            if rc != 0:
                raise TimeoutError("channel wait timed out")
            if n.value == _LEN_CLOSE:
                self._lib.ch_advance_tail(self._cbuf)
                raise ChannelClosed("producer closed the channel")
            out = ctypes.create_string_buffer(n.value)
            rc = self._lib.ch_read(self._cbuf, out, n.value, 0.0,
                                   ctypes.byref(n))
            if rc != 0:  # pragma: no cover - message was already readable
                raise TimeoutError("channel read raced")
            return out.raw[:n.value]
        tail = self._tail()
        self._wait(lambda: self._head() > tail, timeout)
        off = self._slot(tail)
        buf = self._shm.buf
        n = int.from_bytes(buf[off:off + _SLOT_HDR], "little")
        if n == _LEN_CLOSE:
            self._set_tail(tail + 1)
            raise ChannelClosed("producer closed the channel")
        payload = bytes(buf[off + _SLOT_HDR:off + _SLOT_HDR + n])
        self._set_tail(tail + 1)
        return payload

    def read(self, timeout: Optional[float] = None) -> Any:
        """Copy the payload out of the slot ONCE, advance the tail, then
        deserialize with buffer views aliasing that private copy — the slot
        is reused as soon as the tail advances, so deserialized arrays must
        not alias it."""
        if self._lib is not None:
            cn = ctypes.c_uint64()
            rc = self._native_wait(self._lib.ch_wait_readable, timeout,
                                   ctypes.byref(cn))
            if rc != 0:
                raise TimeoutError("channel wait timed out")
            n = cn.value
            if n == _LEN_CLOSE:
                self._lib.ch_advance_tail(self._cbuf)
                raise ChannelClosed("producer closed the channel")
            tail = self._tail()
            off = self._slot(tail)
            payload = bytearray(
                self._shm.buf[off + _SLOT_HDR:off + _SLOT_HDR + n])
            self._lib.ch_advance_tail(self._cbuf)
        else:
            tail = self._tail()
            self._wait(lambda: self._head() > tail, timeout)
            off = self._slot(tail)
            buf = self._shm.buf
            n = int.from_bytes(buf[off:off + _SLOT_HDR], "little")
            if n == _LEN_CLOSE:
                self._set_tail(tail + 1)
                raise ChannelClosed("producer closed the channel")
            payload = bytearray(buf[off + _SLOT_HDR:off + _SLOT_HDR + n])
            self._set_tail(tail + 1)
        return _loads_payload(payload)

    # ----------------------------------------------------------- lifecycle
    def close(self) -> None:
        # the native branch must die with the mapping: a later call passing
        # a NULL base into C would segfault instead of raising
        self._lib = None
        if self._cbuf is not None:
            # drop the exported ctypes view or shm.close() raises BufferError
            try:
                del self._cbuf
            except Exception:
                pass
            self._cbuf = None
        try:
            self._shm.close()
        except BufferError:
            pass
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass

    def __reduce__(self):
        # channels travel by name; the receiving process attaches
        return (type(self), (self.name,))


# ===================================================== cross-host channels

_KV_NS = "_dagchan"


def _kv_call(method: str, msg: dict):
    from ray_tpu_torch._private.worker import require_core

    return require_core().gcs_call_sync(method, msg)


def _node_advertise_host() -> str:
    """The host other nodes can reach this process's NODE at: the nodelet's
    GCS-registered address (the worker's own RPC server binds loopback, so
    ``core.addr`` would advertise 127.0.0.1 and break genuinely-cross-host
    edges).  Cached on the core — one nodelet round-trip per process."""
    try:
        from ray_tpu_torch._private.worker import require_core

        core = require_core()
        host = getattr(core, "_chan_advertise_host", None)
        if host is None:
            info = core.io.run(core.nodelet_conn.call("node_info", None))
            host = info["addr"][0] or "127.0.0.1"
            core._chan_advertise_host = host
        return host
    except Exception:
        import logging

        # a loopback fallback on a multi-host pod makes the remote reader
        # time out against its own loopback — leave a trail to the cause
        logging.getLogger(__name__).warning(
            "could not resolve this node's advertise host; tcp channel "
            "falls back to 127.0.0.1 (cross-host readers will not reach "
            "it)", exc_info=True)
        return "127.0.0.1"


class TcpChannel:
    """One cross-host SPSC edge: length-framed messages over a single TCP
    connection with credit-based depth backpressure.

    The shm ring cannot span hosts; a compiled-DAG edge whose endpoints live
    on different nodes falls back to this channel (reference: the remote-
    reader path of shared_memory_channel.py — there the object store bridges
    nodes; here a dedicated socket does, keeping the no-per-message-runtime
    property).  Rendezvous rides the GCS KV: the writer binds an ephemeral
    port and registers ``name -> (host, port)`` under the ``_dagchan``
    namespace; the reader polls the key and connects.

    Backpressure mirrors the ring's ``depth``: the writer starts with
    ``depth`` credits, each message costs one, and the reader returns one
    1-byte ack per message consumed — so a slow consumer stalls the producer
    after ``depth`` in-flight messages exactly like the shm ring does.

    The default connect/accept budget is 60 s, overridable with
    ``RAY_TPU_TORCH_CHAN_CONNECT_TIMEOUT_S`` (tests shorten it to exercise the
    timeout paths without minute-long waits).
    """

    def __init__(self, name: str, *, role: str, depth: int = 2,
                 advertise_host: Optional[str] = None,
                 connect_timeout: Optional[float] = None):
        import os
        import socket
        import threading

        assert role in ("r", "w")
        self.name = name
        self.role = role
        self.depth = depth
        self.slot_size = 1 << 62  # no framing limit; kept for API parity
        self._sock: Optional[socket.socket] = None
        self._listener: Optional[socket.socket] = None
        self._credits = depth
        if connect_timeout is None:
            # env re-read per construction (tests shorten it mid-process);
            # the registered flag carries the typed default
            env = os.environ.get("RAY_TPU_TORCH_CHAN_CONNECT_TIMEOUT_S")
            if env is not None:
                connect_timeout = float(env)
            else:
                from ray_tpu_torch._private.config import RayConfig

                connect_timeout = RayConfig.chan_connect_timeout_s
        self._connect_timeout = connect_timeout
        # dial/accept may run on a background thread (the compiled DAG's
        # driver dials its output edges at execute time) while a reader
        # thread enters read(): establishing the connection must be
        # single-flight
        self._conn_lock = threading.Lock()
        self._registered = False
        self._closed = False
        if role == "w":
            if advertise_host is None:
                advertise_host = _node_advertise_host()
            ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            ls.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            # Bind ALL interfaces: the advertised host may be a NAT'd /
            # port-mapped address that is not a local interface, and binding
            # it would either fail (EADDRNOTAVAIL) or hide the listener from
            # the route the peer actually uses.  Reachability travels via
            # the KV rendezvous value instead.
            ls.bind(("", 0))
            ls.listen(1)
            self._listener = ls
            port = ls.getsockname()[1]
            adv = advertise_host if advertise_host not in ("", "0.0.0.0") \
                else "127.0.0.1"
            _kv_call("kv_put", {"ns": _KV_NS, "key": name,
                                "value": pickle.dumps((adv, port))})  # lint: disable=no-flatten (rendezvous record)
            self._registered = True

    # ---------------------------------------------------------- connection
    def dial(self) -> None:
        """Establish the connection eagerly (best effort, swallows errors):
        the compiled DAG calls this from a background thread at execute time
        so the producer's accept() never waits on a tardy first get()."""
        try:
            self._ensure_conn(None)
        except Exception:
            pass  # the next read/write retries with a proper error path

    def _ensure_conn(self, timeout: Optional[float]) -> None:
        if self._sock is not None:
            return
        with self._conn_lock:
            if self._sock is None:
                self._connect_locked(timeout)

    def _connect_locked(self, timeout: Optional[float]) -> None:
        import socket

        if self._closed:
            raise ChannelClosed(f"tcp channel {self.name} is closed")
        budget = self._connect_timeout if timeout is None else timeout
        deadline = time.monotonic() + budget
        if self.role == "w":
            self._listener.settimeout(budget)
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                raise TimeoutError(
                    f"tcp channel {self.name}: reader never connected")
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = conn
            return
        # reader: poll the rendezvous key, then connect
        addr = None
        while addr is None:
            blob = _kv_call("kv_get", {"ns": _KV_NS, "key": self.name})
            if blob is not None:
                addr = pickle.loads(blob)
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"tcp channel {self.name}: writer never registered")
            time.sleep(0.02)
        while True:
            try:
                s = socket.create_connection(
                    tuple(addr), timeout=max(deadline - time.monotonic(), 0.1))
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"tcp channel {self.name}: connect to {addr} failed")
                time.sleep(0.05)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = s

    def _recv_exact(self, n: int, timeout: Optional[float]) -> bytes:
        import socket

        self._sock.settimeout(timeout)
        chunks = []
        got = 0
        try:
            while got < n:
                c = self._sock.recv(min(n - got, 1 << 20))
                if not c:
                    raise ChannelClosed(
                        f"tcp channel {self.name}: peer disconnected")
                chunks.append(c)
                got += len(c)
        except socket.timeout:
            if chunks:
                # mid-frame timeout would desync the stream; fail hard
                raise ChannelClosed(
                    f"tcp channel {self.name}: truncated frame")
            raise TimeoutError("channel wait timed out")
        return b"".join(chunks)

    # -------------------------------------------------------------- write
    def _drain_acks(self) -> None:
        """Non-blocking credit replenish."""
        import socket

        self._sock.settimeout(0.0)
        try:
            while True:
                c = self._sock.recv(4096)
                if not c:
                    raise ChannelClosed(
                        f"tcp channel {self.name}: peer disconnected")
                self._credits += len(c)
        except (BlockingIOError, socket.timeout, InterruptedError):
            pass

    def wait_writable(self, timeout: Optional[float] = None) -> None:
        self._ensure_conn(timeout)
        self._drain_acks()
        if self._credits > 0:
            return
        ack = self._recv_exact(1, timeout)  # blocking credit wait
        self._credits += len(ack)
        self._drain_acks()

    def write_bytes(self, payload: bytes, timeout: Optional[float] = None) -> None:
        self.wait_writable(timeout)
        self._sock.settimeout(None)
        self._sock.sendall(len(payload).to_bytes(8, "little") + payload)
        self._credits -= 1

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        self.write_serialized(get_serialization_context().serialize(value),
                              timeout)

    def write_serialized(self, ser, timeout: Optional[float] = None) -> None:
        """Send a SerializedObject frame scatter-gather: large OOB buffers
        go to sendall as zero-copy slices, only sub-chunk header/tail pieces
        are stitched (iter_frame) — no flattened intermediate payload."""
        if not ser.buffers:
            self.write_bytes(ser.inband, timeout)
            return
        self.wait_writable(timeout)
        n = 1 + ser.total_frame_bytes()
        self._sock.settimeout(None)
        self._sock.sendall(n.to_bytes(8, "little")
                           + bytes((_SER_FRAME_MAGIC,)))
        for part in ser.iter_frame(_TCP_CHUNK):
            self._sock.sendall(part)
        self._credits -= 1

    def close_write(self, timeout: float = 60.0) -> None:
        try:
            # A reader that never connected cannot be blocked on data, so
            # the EOF sentinel only matters for a connected peer: bound the
            # accept wait tightly or teardown of a dead downstream would
            # stall `timeout` seconds per unconnected edge.
            self._ensure_conn(timeout if self._sock is not None
                              else min(timeout, 5.0))
            self._sock.settimeout(timeout)
            self._sock.sendall(_LEN_CLOSE.to_bytes(8, "little"))
        except Exception:
            pass

    # --------------------------------------------------------------- read
    def read_bytes(self, timeout: Optional[float] = None) -> bytes:
        self._ensure_conn(timeout)
        head = self._recv_exact(8, timeout)
        n = int.from_bytes(head, "little")
        if n == _LEN_CLOSE:
            raise ChannelClosed("producer closed the channel")
        payload = self._recv_exact(n, None if timeout is None else timeout)
        self._sock.settimeout(None)
        self._sock.sendall(b"\x01")  # return one credit
        return payload

    def read(self, timeout: Optional[float] = None) -> Any:
        """Receive straight into one preallocated buffer (recv_into, no
        join copy) and deserialize with views aliasing it."""
        self._ensure_conn(timeout)
        head = self._recv_exact(8, timeout)
        n = int.from_bytes(head, "little")
        if n == _LEN_CLOSE:
            raise ChannelClosed("producer closed the channel")
        payload = self._recv_into(n, timeout)
        self._sock.settimeout(None)
        self._sock.sendall(b"\x01")  # return one credit
        return _loads_payload(payload)

    def _recv_into(self, n: int, timeout: Optional[float]) -> bytearray:
        import socket

        self._sock.settimeout(timeout)
        out = bytearray(n)
        mv = memoryview(out)
        got = 0
        try:
            while got < n:
                r = self._sock.recv_into(mv[got:], min(n - got, 1 << 20))
                if not r:
                    raise ChannelClosed(
                        f"tcp channel {self.name}: peer disconnected")
                got += r
        except socket.timeout:
            # mid-frame timeout would desync the stream; fail hard
            raise ChannelClosed(
                f"tcp channel {self.name}: truncated frame")
        finally:
            mv.release()
        return out

    # ----------------------------------------------------------- lifecycle
    def close(self) -> None:
        self._closed = True
        for s in (self._sock, self._listener):
            if s is not None:
                try:
                    s.close()
                except Exception:
                    pass
        self._sock = self._listener = None
        if self._registered:
            self._registered = False
            try:
                _kv_call("kv_del", {"ns": _KV_NS, "key": self.name})
            except Exception:
                pass


def open_channel(desc, role: str):
    """Materialize one compiled-DAG edge endpoint from its descriptor.

    ``desc`` is either a bare shm segment name (same-node edge: attach to the
    driver-created ring) or ``("tcp", chan_id, depth)`` for a cross-node edge.
    """
    if isinstance(desc, str):
        return ShmChannel(desc)
    kind = desc[0]
    if kind == "tcp":
        return TcpChannel(desc[1], role=role, depth=desc[2])
    raise ValueError(f"unknown channel descriptor {desc!r}")
