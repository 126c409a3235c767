"""Port of ``ray_tpu/_private/serialization.py``.

Serialization: cloudpickle + pickle-5 out-of-band buffers for zero-copy payloads.

Counterpart of the reference's python/ray/_private/serialization.py + vendored
cloudpickle (python/ray/cloudpickle/) + plasma zero-copy numpy reads.  A value is
serialized to ``SerializedObject(inband, buffers)``: the in-band pickle stream plus a
flat list of large contiguous buffers (numpy arrays, torch tensors' host arrays, bytes) captured
via the protocol-5 ``buffer_callback``.  Buffers are written verbatim into the
shared-memory store and mapped back as memoryviews on read, so a worker-to-worker
transfer of a numpy array copies it at most once (into shm) per node.

ObjectRefs found inside values are recorded so the owner can track borrowers
(reference: reference_count.h:61 borrower protocol; simplified here).
"""

from __future__ import annotations

import io
import pickle
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import cloudpickle

# Values >= this many bytes are moved out-of-band; tiny buffers stay in-band to
# avoid per-buffer bookkeeping overhead.
_OOB_THRESHOLD = 4096


class SerializedObject:
    __slots__ = ("inband", "buffers", "contained_refs")

    def __init__(self, inband: bytes, buffers: List[memoryview], contained_refs=None):
        self.inband = inband
        self.buffers = buffers
        self.contained_refs = contained_refs or []

    def total_bytes(self) -> int:
        return len(self.inband) + sum(b.nbytes for b in self.buffers)

    def total_frame_bytes(self) -> int:
        """Size of the flattened frame (header + segments)."""
        return 12 + len(self.inband) + sum(8 + b.nbytes for b in self.buffers)

    def write_into(self, dest) -> int:
        """Write the flattened frame into a writable buffer (e.g. a mapped
        plasma segment) without materializing an intermediate copy; returns
        bytes written.  Layout: [n_bufs][len inband][inband][len buf][buf]..."""
        mv = memoryview(dest)
        mv[0:4] = len(self.buffers).to_bytes(4, "little")
        mv[4:12] = len(self.inband).to_bytes(8, "little")
        off = 12
        mv[off:off + len(self.inband)] = self.inband
        off += len(self.inband)
        for b in self.buffers:
            mv[off:off + 8] = b.nbytes.to_bytes(8, "little")
            off += 8
            flat = b if b.ndim == 1 and b.format == "B" else b.cast("B")
            mv[off:off + flat.nbytes] = flat
            off += flat.nbytes
        return off

    def to_bytes(self) -> bytes:
        """Flatten to one contiguous frame (small objects / wire fallback)."""
        out = bytearray(self.total_frame_bytes())
        self.write_into(out)
        return bytes(out)

    def iter_frame(self, chunk_bytes: int):
        """Yield the flattened frame as a sequence of chunks, each at most
        ``chunk_bytes``, WITHOUT materializing the whole frame: large
        buffers are sliced in place, only sub-chunk header/length pieces are
        stitched together.  Streaming consumers (a ray:// driver shipping a
        multi-GiB put over RPC) stay at one-chunk peak memory instead of
        2x the payload."""
        assert chunk_bytes > 0
        pending = bytearray()

        def pieces():
            yield len(self.buffers).to_bytes(4, "little")
            yield len(self.inband).to_bytes(8, "little")
            yield self.inband
            for b in self.buffers:
                yield b.nbytes.to_bytes(8, "little")
                flat = b if getattr(b, "ndim", 1) == 1 and \
                    getattr(b, "format", "B") == "B" else b.cast("B")
                yield flat

        for piece in pieces():
            mv = memoryview(piece) if not isinstance(piece, memoryview) \
                else piece
            off = 0
            while off < mv.nbytes:
                take = min(chunk_bytes - len(pending), mv.nbytes - off)
                if not pending and take == chunk_bytes:
                    # full chunk straight out of the source: zero-copy slice
                    yield mv[off:off + take]
                else:
                    pending.extend(mv[off:off + take])
                    if len(pending) == chunk_bytes:
                        # Swap instead of copy: the filled bytearray is
                        # yielded as-is and a fresh one accumulates the next
                        # tail, so each stitched chunk costs exactly the one
                        # extend() copy.
                        out, pending = pending, bytearray()
                        yield memoryview(out)
                off += take
        if pending:
            yield memoryview(pending)

    @classmethod
    def from_buffer(cls, buf) -> "SerializedObject":
        """Parse a flattened frame, keeping buffers as zero-copy memoryviews."""
        mv = memoryview(buf)
        n_bufs = int.from_bytes(mv[:4], "little")
        inband_len = int.from_bytes(mv[4:12], "little")
        off = 12
        inband = bytes(mv[off : off + inband_len])
        off += inband_len
        buffers = []
        for _ in range(n_bufs):
            blen = int.from_bytes(mv[off : off + 8], "little")
            off += 8
            buffers.append(mv[off : off + blen])
            off += blen
        return cls(inband, buffers)


def freeze_buffers(buffers) -> Tuple[List[Any], int]:
    """Prepare OOB buffers for an in-flight frame (inline args, packed
    returns): readonly views pass through zero-copy as ``PickleBuffer``s
    (protocol-5 picklable; the RPC encoder's buffer_callback ships them
    out-of-band, so they never flatten); writable views are copied,
    because the owner can mutate the backing array between submission and
    the asynchronous wire write.  Returns (buffers, n_copied) so callers
    can count residual copies."""
    out: List[Any] = []
    copied = 0
    for b in buffers:
        mv = b if isinstance(b, memoryview) else memoryview(b)
        if mv.readonly:
            out.append(pickle.PickleBuffer(mv))
        else:
            out.append(bytes(mv))
            copied += 1
    return out, copied


class SerializationContext:
    """Per-process serializer with a custom-reducer registry.

    Reference: python/ray/util/serialization.py register_serializer and
    _private/serialization.py SerializationContext.
    """

    def __init__(self):
        self._custom: Dict[type, Tuple[Callable, Callable]] = {}
        self._lock = threading.Lock()
        self._torch_registered = False
        self._pickler_cls = None

    def register_serializer(self, cls: type, serializer: Callable, deserializer: Callable):
        with self._lock:
            self._custom[cls] = (serializer, deserializer)

    def deregister_serializer(self, cls: type):
        with self._lock:
            self._custom.pop(cls, None)

    def _make_pickler(self, file, buffer_callback):
        # Cache the Pickler subclass: creating a class per serialize() call
        # costs more than the pickling itself for small hot-path messages
        # (compiled-DAG channel frames).  The closure captures the _custom
        # dict by reference, so later register_serializer calls are seen.
        cls = self._pickler_cls
        if cls is None:
            custom = self._custom

            class _Pickler(cloudpickle.Pickler):
                def reducer_override(self, obj):  # noqa: N802
                    entry = custom.get(type(obj))
                    if entry is None:
                        for base in type(obj).__mro__[1:]:
                            entry = custom.get(base)
                            if entry is not None:
                                break
                    if entry is not None:
                        serializer, deserializer = entry
                        return (_apply_deserializer,
                                (deserializer, serializer(obj)))
                    # Chain to cloudpickle's own reducer_override (it handles
                    # functions/classes by value) rather than disabling it.
                    return super().reducer_override(obj)

            cls = self._pickler_cls = _Pickler

        return cls(file, protocol=5, buffer_callback=buffer_callback)

    def serialize(self, value: Any) -> SerializedObject:
        # Fast path: scalar-ish builtins cannot contain ObjectRefs, OOB
        # buffers, or custom-reduced objects — plain pickle, no cloudpickle
        # Pickler construction (this is the compiled-DAG per-message path).
        t = type(value)
        if t in _FAST_TYPES and t not in self._custom:
            return SerializedObject(  # scalars: no buffers exist to flatten
                pickle.dumps(value, protocol=5), [])  # lint: disable=no-flatten
        if not self._torch_registered:
            import sys

            if "torch" in sys.modules:
                self._torch_registered = True
                maybe_register_torch(self)
        buffers: List[memoryview] = []
        contained_refs: List[Any] = []

        def buffer_callback(pickle_buffer: pickle.PickleBuffer) -> bool:
            mv = pickle_buffer.raw()
            if mv.nbytes < _OOB_THRESHOLD:
                return True  # keep in-band
            buffers.append(mv)
            return False

        _CONTAINED_REFS_TLS.stack.append(contained_refs)
        try:
            f = io.BytesIO()
            pickler = self._make_pickler(f, buffer_callback)
            pickler.dump(value)
            inband = f.getvalue()
        finally:
            _CONTAINED_REFS_TLS.stack.pop()
        return SerializedObject(inband, buffers, contained_refs)

    def deserialize(self, serialized: SerializedObject) -> Any:
        return pickle.loads(serialized.inband, buffers=serialized.buffers)


_FAST_TYPES = (int, float, bool, type(None), str)


def _apply_deserializer(deserializer, payload):
    return deserializer(payload)


class _ContainedRefsTLS(threading.local):
    def __init__(self):
        self.stack: List[List[Any]] = []


_CONTAINED_REFS_TLS = _ContainedRefsTLS()


def record_contained_ref(ref) -> None:
    """Called from ObjectRef.__reduce__ while a serialize() is in flight."""
    if _CONTAINED_REFS_TLS.stack:
        _CONTAINED_REFS_TLS.stack[-1].append(ref)


_default_context: Optional[SerializationContext] = None
_default_lock = threading.Lock()


def get_serialization_context() -> SerializationContext:
    global _default_context
    ctx = _default_context
    if ctx is None:
        with _default_lock:
            ctx = _default_context
            if ctx is None:
                ctx = _default_context = SerializationContext()
    return ctx


def maybe_register_torch(ctx: Optional[SerializationContext] = None) -> None:
    """Register the torch.Tensor host-copy serializer.

    Registered only once ``torch`` is imported, so a process that never
    touches torch never pays its import.  The serializer hands pickle a
    C-contiguous host array, which pickle-5 takes out of band: a CPU
    tensor's is a view of its memory (a copy only when the tensor is not
    contiguous), a CUDA tensor's a copy to the host, as ``jax.device_get``
    is for the JAX package.  A dtype numpy lacks (bfloat16, the float8
    types) travels as the integer view of the same width, its dtype beside
    it.  The deserializer returns a CPU tensor of the same dtype and
    shape, in memory of its own (one copy out of the frame): nothing lands
    on a device on its own.  Subclasses
    (``nn.Parameter``) travel as plain tensors.
    """
    import sys

    if "torch" not in sys.modules:
        return
    ctx = ctx or get_serialization_context()
    import torch

    ctx.register_serializer(torch.Tensor, _ser_torch, _deser_torch)


# numpy has no dtype for these: each travels as the integer of its width
_TORCH_VIEW_DTYPES = {"bfloat16": "int16", "float8_e4m3fn": "int8",
                      "float8_e4m3fnuz": "int8", "float8_e5m2": "int8",
                      "float8_e5m2fnuz": "int8", "float8_e8m0fnu": "int8"}


def _ser_torch(t):
    import torch

    if hasattr(t, "device_mesh"):
        raise TypeError("a DTensor does not travel whole: send its "
                        "full_tensor() or its to_local() shard")
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = torch.Tensor.as_subclass(t.contiguous(), torch.Tensor)
    name = str(t.dtype).rsplit(".", 1)[1]
    view = _TORCH_VIEW_DTYPES.get(name)
    arr = (t.view(getattr(torch, view)) if view else t).numpy()
    return arr, name, view is not None


def _deser_torch(payload):
    import torch

    arr, name, viewed = payload
    if not arr.flags.owndata:
        # a view of the frame (the object store's shared memory for a large
        # tensor): torch gets memory of its own, so that writing to the
        # tensor cannot change the stored object
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return t.view(getattr(torch, name)) if viewed else t
