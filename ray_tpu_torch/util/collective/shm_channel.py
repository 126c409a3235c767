"""Port of ``ray_tpu/util/collective/shm_channel.py``.

Same-host shared-memory chunk channel for the pipelined data plane.

The fire-and-forget ring moves bulk chunk bytes through a per-group POSIX
shared-memory arena when sender and receiver share a node: the sender
memcpys a chunk's buffers into its arena and ships only a tiny descriptor
through the coalesced RPC batch frame; the receiver maps the arena once
(by name, cached) and reduces straight out of it — zero receive-side
copies.  On a shared-core host this removes the dominant per-byte costs
of the TCP loopback path (socket write, ``readexactly``, unpickle) while
keeping the control plane's ordering and timeout semantics: descriptors
ride exactly the frames the data otherwise would.

Safety model — why no per-chunk acknowledgement is needed.  The arena is
split into two halves addressed by the parity of a *placing-op* counter
(ops in which this arena placed at least one chunk).  Every placing op is
"completion-synchronized": a rank can only complete a ring / hierarchical
op after every participant has STARTED it (its result depends on data
from each of them), and a rank only starts op k+1 after finishing op k —
so by the time the sender begins its (k+2)-nd placing op and reuses the
half of op k, every peer has finished op k and consumed its chunks.
Relayed descriptors inherit the guarantee: relays are consumed within the
same op they were placed in, and a descriptor never leaves its node — the
collective layer resolves it to an inline copy before any cross-node send
(a remote host could not attach the segment by name).  Ops WITHOUT that
completion dependency —
plain broadcast fan-out (the root completes without any peer
participation) and quorum contributions / results (the root completes
without the stragglers; contributions may park across rounds) — must not
ride the arena; the collective layer sends them inline (``shm_ok=False``).

A timed-out collective already leaves the group in a failed state; a
peer that keeps consuming after a timeout may observe reused regions,
which is acceptable because the op it would complete has already raised
on the waiting side.
"""

from __future__ import annotations

import pickle
import uuid
from multiprocessing import shared_memory
from typing import Dict, List, Optional, Tuple

# Wire-descriptor marker key; the collective layer sniffs this to resolve
# (and to relay descriptors verbatim instead of re-placing them).
SHM_KEY = "__shmch__"

_ALIGN = 64
# Buffers smaller than this stay inband in the descriptor's pickle — the
# arena round trip only pays off for bulk payloads.
_MIN_BUF = 4096


def _round_up(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def is_desc(payload) -> bool:
    return isinstance(payload, dict) and payload.get(SHM_KEY) == 1


def desc_bytes(desc: Dict) -> int:
    """Payload bytes a descriptor references in its arena."""
    return sum(n for _, n in desc["bufs"])


def _attach(name: str) -> shared_memory.SharedMemory:
    # object_store's attach helper already handles resource-tracker
    # unregistration and tolerant close (the segment owner may unlink
    # while we still hold a mapping — mappings survive unlink).
    from ray_tpu_torch._private.object_store import _attach_shm

    return _attach_shm(name)


class TxArena:
    """Sender side: a double-buffered bump allocator over one shm segment.

    ``place()`` pickles the payload with protocol-5 out-of-band buffers,
    memcpys the buffers into the current parity half, and returns a small
    descriptor (or None when the payload is too small / not eligible, in
    which case the caller sends it inline).  Growth allocates a larger
    segment; the old one is kept linked for two more placing ops so peers
    that haven't attached yet still can, then unlinked.
    """

    def __init__(self, tag: str):
        self._tag = tag
        self._gen = 0
        self._shm: Optional[shared_memory.SharedMemory] = None
        self._cap = 0
        self._seq: Optional[int] = None
        self._k = 0          # placing-op counter: parity picks the half
        self._bump = 0       # bytes used in the current half
        self._retired: List[Tuple[int, shared_memory.SharedMemory]] = []
        # Reuse cache: fan-out sends of one payload object within one op
        # (hier leader broadcast) place once and share the descriptor.
        self._last: Optional[tuple] = None

    # -------------------------------------------------------------- segments
    def _new_segment(self, need: int) -> None:
        cap = max(2 * _round_up(need), 2 * self._cap, 8 * 1024 * 1024)
        if self._shm is not None:
            # keep the old segment attachable for two more placing ops
            self._retired.append((self._k + 2, self._shm))
        self._gen += 1
        self._shm = shared_memory.SharedMemory(
            create=True, size=cap, name=f"{self._tag}-{self._gen}")
        # First-touch every page now (same idea as the object store's
        # pre-faulted slabs): a fresh mapping costs tens of ms of page
        # faults on first write, which would land inside the first op
        # through the new segment.
        buf = self._shm.buf
        zero = b"\0" * (1 << 20)
        for off in range(0, cap, 1 << 20):
            n = min(1 << 20, cap - off)
            buf[off:off + n] = zero[:n]
        self._cap = cap
        self._bump = 0

    def _drop_retired(self) -> None:
        keep = []
        for unlink_at, shm in self._retired:
            if self._k >= unlink_at:
                for fn in (shm.close, shm.unlink):
                    try:
                        fn()
                    except Exception:
                        pass
            else:
                keep.append((unlink_at, shm))
        self._retired = keep

    # ----------------------------------------------------------------- place
    def place(self, payload, seq: int, tag: int, min_bytes: int):
        """Return a wire descriptor for ``payload`` or None (send inline)."""
        last = self._last
        if last is not None and last[0] == seq and last[1] == tag \
                and last[2] is payload:
            return last[3]
        bufs: List[memoryview] = []

        def cb(pb: pickle.PickleBuffer) -> bool:
            try:
                mv = pb.raw()
            except Exception:
                return True  # non-contiguous: keep it inband
            if mv.nbytes < _MIN_BUF:
                return True
            bufs.append(mv.cast("B"))
            return False

        try:
            ib = pickle.dumps(payload, protocol=5, buffer_callback=cb)
        except Exception:
            return None
        total = sum(mv.nbytes for mv in bufs)
        if not bufs or total < min_bytes:
            return None
        aligned = sum(_round_up(mv.nbytes) for mv in bufs)
        if seq != self._seq:
            self._seq = seq
            self._k += 1
            self._bump = 0
            self._drop_retired()
        if self._shm is None or self._bump + aligned > self._cap // 2:
            self._new_segment(self._bump + aligned)
        base = (self._k % 2) * (self._cap // 2)
        offs = []
        buf = self._shm.buf
        for mv in bufs:
            off = base + self._bump
            buf[off:off + mv.nbytes] = mv
            offs.append((off, mv.nbytes))
            self._bump += _round_up(mv.nbytes)
        desc = {SHM_KEY: 1, "seg": self._shm.name, "ib": ib, "bufs": offs}
        self._last = (seq, tag, payload, desc)
        return desc

    def close(self) -> None:
        self._last = None
        segs = [shm for _, shm in self._retired]
        if self._shm is not None:
            segs.append(self._shm)
        self._retired, self._shm, self._cap = [], None, 0
        for shm in segs:
            for fn in (shm.close, shm.unlink):
                try:
                    fn()
                except Exception:
                    pass


class RxCache:
    """Receiver side: attach arenas by name once, resolve descriptors to
    payloads with zero-copy buffer views (numpy reconstructs arrays
    wrapping the mapped memory directly)."""

    def __init__(self):
        self._att: Dict[str, shared_memory.SharedMemory] = {}

    def resolve(self, desc: Dict):
        shm = self._att.get(desc["seg"])
        if shm is None:
            shm = _attach(desc["seg"])
            self._att[desc["seg"]] = shm
        views = [shm.buf[o:o + n] for o, n in desc["bufs"]]
        return pickle.loads(desc["ib"], buffers=views)

    def close(self) -> None:
        att, self._att = self._att, {}
        for shm in att.values():
            try:
                shm.close()
            except Exception:
                pass
