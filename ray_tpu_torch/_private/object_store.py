"""Port of ``ray_tpu/_private/object_store.py``.

Shared-memory object store: the plasma equivalent.

Counterpart of the reference's plasma store (reference: src/ray/object_manager/plasma/
store.h:55, object_lifecycle_manager.h:101, eviction_policy.h, plasma_allocator.cc) and
the client side (src/ray/core_worker/store_provider/plasma_store_provider.h:88).

Design, TPU-host-native rather than a translation:

- One store per node, hosted inside the nodelet (raylet-equivalent) process.  Objects
  live in POSIX shared memory (``/dev/shm`` via ``multiprocessing.shared_memory``),
  one segment per object.  The reference instead dlmalloc's one big mmap arena and
  passes fds (plasma/fling.cc); per-object segments let clients attach by *name* over
  the normal RPC channel — no fd-passing — at the cost of one ``memfd`` per object,
  which is fine at the object counts a training cluster sees and removes the whole
  allocator (XLA owns device memory; host shm is a staging area).
- Zero-copy reads: clients map the segment and deserialize with pickle-5 buffers
  pointing straight into it (numpy arrays alias shm).  The mapping outlives deletion:
  POSIX keeps unlinked segments alive until the last mapping closes, which is exactly
  the pin-until-last-view semantics plasma implements with refcounts.
- Eviction & spilling: sealed, unpinned objects are spilled to disk (primary copies)
  or evicted (remote copies) in LRU order when a create needs room (reference:
  eviction_policy.h + local_object_manager.h:41 spill path, simplified into one
  component).  Restore happens transparently inside ``get``.
- Admission: creates larger than free capacity + evictable bytes raise
  ``ObjectStoreFullError`` after retrying, like the CreateRequestQueue
  (plasma/create_request_queue.h).

Server-side methods are synchronous and only called from the nodelet's event loop
(single-threaded, like the reference store's single io_context thread).
"""

from __future__ import annotations

import asyncio
import collections
import logging
import os
import pickle
import threading
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private import fault_injection
from ray_tpu_torch._private.config import RayConfig
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.exceptions import ObjectStoreFullError

logger = logging.getLogger(__name__)


def _attach_shm(name: str) -> shared_memory.SharedMemory:
    """Attach to an existing segment without registering with resource_tracker.

    The tracker would try to unlink segments owned by the store when *this*
    process exits; only the store unlinks.
    """
    shm = shared_memory.SharedMemory(name=name)
    try:
        resource_tracker.unregister(shm._name, "shared_memory")  # type: ignore[attr-defined]
    except Exception:
        pass
    orig_close = shm.close

    def _close_tolerant():
        try:
            orig_close()
        except BufferError:
            # A zero-copy numpy view still aliases the mapping (interpreter
            # shutdown / GC); the segment is store-owned, leaking the mapping
            # until process exit matches plasma's pin semantics.
            pass

    shm.close = _close_tolerant
    return shm


class _Entry:
    __slots__ = (
        "oid", "shm", "size", "alloc", "sealed", "pins", "last_access",
        "is_primary", "spilled_path", "ever_viewed", "slab", "offset",
    )

    def __init__(self, oid: ObjectID, shm: Optional[shared_memory.SharedMemory], size: int, is_primary: bool,
                 alloc: Optional[int] = None):
        self.oid = oid
        self.shm = shm
        self.size = size
        self.alloc = alloc if alloc is not None else size  # segment bytes
        self.sealed = False
        self.pins = 0  # outstanding client pins; only 0-pin objects evict
        self.last_access = time.monotonic()
        self.is_primary = is_primary  # created locally by owner (vs pulled copy)
        self.spilled_path: Optional[str] = None
        # True once ANY reader (client mapping or server-side view) may have
        # aliased the segment.  Such segments must be unlinked, never pooled:
        # a lingering zero-copy view must keep seeing the old bytes (plasma's
        # pin-until-last-view contract).
        self.ever_viewed = False
        # Arena-backed entries: the payload lives at slab[offset:offset+size]
        # of a shared slab instead of its own segment (shm stays None).
        self.slab: Optional[str] = None
        self.offset: int = 0


# Extent alignment inside arena slabs: page granularity keeps every object
# frame page-aligned (clean zero-copy numpy views) at <4% overhead for the
# >=100 KiB objects plasma holds.
_EXTENT_ALIGN = 4096


def _align(n: int) -> int:
    return (n + _EXTENT_ALIGN - 1) & ~(_EXTENT_ALIGN - 1)


def _is_slab_name(name: str) -> bool:
    """Slab segment names end in an 'a'-prefixed sequence component (see
    PlasmaStore._slab_name); per-object segments use a bare number."""
    return name.rsplit("_", 1)[-1].startswith("a")


class _Slab:
    """One pre-faulted arena segment with a sorted, coalesced free list.

    The reference's plasma store dlmalloc's a single pre-mapped arena so a
    put never pays first-touch page faults (plasma_allocator.cc); these
    slabs are the same idea sized to stay poolable: pages are touched once
    at slab creation, and every later extent allocation writes at memcpy
    speed."""

    __slots__ = ("name", "shm", "size", "free")

    def __init__(self, name: str, shm: shared_memory.SharedMemory, size: int):
        self.name = name
        self.shm = shm
        self.size = size
        self.free: List[List[int]] = [[0, size]]  # sorted [off, len] runs

    def free_bytes(self) -> int:
        return sum(ln for _off, ln in self.free)

    def alloc(self, size: int) -> Optional[int]:
        """First-fit extent allocation; returns offset or None."""
        size = _align(size)
        for i, (off, ln) in enumerate(self.free):
            if ln >= size:
                if ln == size:
                    self.free.pop(i)
                else:
                    self.free[i] = [off + size, ln - size]
                return off
        return None

    def release(self, off: int, size: int) -> None:
        """Return [off, off+size) to the free list, merging neighbors."""
        size = _align(size)
        import bisect

        i = bisect.bisect_left(self.free, [off, 0])
        self.free.insert(i, [off, size])
        # merge with successor then predecessor
        if i + 1 < len(self.free) and \
                self.free[i][0] + self.free[i][1] == self.free[i + 1][0]:
            self.free[i][1] += self.free[i + 1][1]
            self.free.pop(i + 1)
        if i > 0 and self.free[i - 1][0] + self.free[i - 1][1] == \
                self.free[i][0]:
            self.free[i - 1][1] += self.free[i][1]
            self.free.pop(i)


class PlasmaStore:
    """Node-local shared-memory store. All methods run on the nodelet loop."""

    def __init__(self, capacity_bytes: int, spill_dir: Optional[str] = None, node_id_hex: str = ""):
        self.capacity = capacity_bytes
        self.used = 0
        self.objects: Dict[ObjectID, _Entry] = {}
        self.spill_dir = spill_dir
        self.node_id_hex = node_id_hex
        self._seq = 0
        # Callbacks wired by the nodelet: object sealed / deleted locally
        # (feeds the GCS object directory, reference: ownership_based_object_directory.h).
        self.on_sealed = None
        self.on_deleted = None
        self.num_spilled = 0
        self.bytes_spilled = 0
        # Segment pool: freed never-viewed segments keyed by allocation
        # bucket, kept MAPPED so their pages stay physically allocated.  A
        # fresh 64 MiB segment costs ~90 ms of first-touch page faults on
        # write; a pooled one writes at memcpy speed.  This is the per-object
        #-segment equivalent of the reference's one-arena dlmalloc design
        # (plasma/plasma_allocator.cc), where pages are faulted once per
        # store lifetime.
        self._seg_pool: Dict[int, List[shared_memory.SharedMemory]] = {}
        self._pool_bytes = 0
        self._pool_cap = min(256 * 1024 * 1024, capacity_bytes // 4)
        # Arena: pre-faulted slabs carved into extents.  Slab bytes count
        # against capacity at creation (they are committed memory); live
        # objects, leased extents, and free runs all live inside them.
        self.slabs: Dict[str, _Slab] = {}
        # deleted-but-still-pinned arena entries: the extent is reusable
        # only after the last reader releases (a shared slab has no POSIX
        # unlink safety net — reuse under a live zero-copy view corrupts it)
        self._zombies: Dict[ObjectID, _Entry] = {}

    # Segments below this aren't pooled: their first-touch cost is trivial
    # and page-rounding would distort small-capacity accounting.
    _POOL_MIN_SEGMENT = 1024 * 1024

    @classmethod
    def _bucket(cls, size: int) -> int:
        """Round poolable allocations to whole pages; repeated puts of
        same-shaped payloads (the common steady-state) then land in matching
        buckets."""
        if size < cls._POOL_MIN_SEGMENT:
            return max(size, 1)
        return (size + 4095) & ~4095

    def _pool_take(self, bucket: int) -> Optional[shared_memory.SharedMemory]:
        pool = self._seg_pool.get(bucket)
        if pool:
            self._pool_bytes -= bucket
            return pool.pop()
        return None

    def _pool_reclaim(self, need: int) -> None:
        """Unlink pooled segments (largest first) to free real memory."""
        freed = 0
        for bucket in sorted(self._seg_pool, reverse=True):
            pool = self._seg_pool[bucket]
            while pool and freed < need:
                shm = pool.pop()
                self._pool_bytes -= bucket
                freed += bucket
                try:
                    shm.unlink()
                except FileNotFoundError:
                    pass
                shm.close()
            if freed >= need:
                break

    # -- helpers -------------------------------------------------------------
    def _segment_name(self) -> str:
        self._seq += 1
        return f"rtpu_{self.node_id_hex[:8]}_{os.getpid()}_{self._seq}"

    def _slab_name(self) -> str:
        self._seq += 1
        return f"rtpu_{self.node_id_hex[:8]}_{os.getpid()}_a{self._seq}"

    # ------------------------------------------------------------- arena
    def _new_slab(self, min_bytes: int) -> Optional[_Slab]:
        """Create a pre-faulted slab of at least min_bytes (rounded up to
        the configured slab size); returns None when capacity can't fit it
        even after eviction."""
        size = max(_align(min_bytes), RayConfig.arena_slab_bytes)
        if not self._ensure_room(size):
            # a smaller slab may still fit when the request itself is small
            if size > _align(min_bytes):
                size = _align(min_bytes)
                if not self._ensure_room(size):
                    return None
            else:
                return None
        shm = shared_memory.SharedMemory(
            name=self._slab_name(), create=True, size=size)
        # First-touch every page NOW, off the put hot path: a fresh 64 MiB
        # mapping costs tens of ms of page faults on first write; a
        # pre-faulted slab takes puts at memcpy speed for its whole life.
        buf = shm.buf
        zero = b"\0" * (1 << 20)
        for off in range(0, size, 1 << 20):
            n = min(1 << 20, size - off)
            buf[off:off + n] = zero[:n]
        slab = _Slab(shm.name, shm, size)
        self.slabs[shm.name] = slab
        self.used += size
        return slab

    def _arena_find(self, size: int) -> Optional[Tuple[str, int]]:
        """First-fit extent from existing slabs (no eviction, no new slab)."""
        for slab in self.slabs.values():
            off = slab.alloc(size)
            if off is not None:
                return slab.name, off
        return None

    def _arena_victims(self) -> List[_Entry]:
        return sorted((e for e in self.objects.values()
                       if e.sealed and e.pins == 0 and e.slab is not None),
                      key=lambda e: e.last_access)

    def lease_extents(self, nbytes: int, contig: int) -> List[Tuple[str, int, int]]:
        """Grant extents totaling ~nbytes, the first at least ``contig``
        contiguous bytes.  Evicts LRU arena objects, then creates a new
        slab, before giving up with ObjectStoreFullError.  Only the contig
        minimum forces eviction; the top-up is opportunistic."""
        contig = _align(max(contig, 1))
        if contig > self.capacity:
            raise ObjectStoreFullError(
                f"extent of {contig} bytes exceeds store capacity "
                f"{self.capacity}")
        got = self._arena_find(contig)
        if got is None:
            # Grow the arena while capacity is plentiful — eviction/spill is
            # strictly worse than committing free capacity to another
            # pre-faulted slab.  Fully-free slabs that survive to this point
            # are the WRONG SIZE for contig (else _arena_find would have
            # used them): reclaim them before deciding capacity is short —
            # a pile of stale 64 MiB slabs must not force spilling a live
            # 256 MiB object (observed: workload shifting put sizes).
            slab_need = max(_align(contig), RayConfig.arena_slab_bytes)
            need = self.used + self._pool_bytes + slab_need - self.capacity
            if need > 0:
                self._reclaim_arena(need)
            if self.used + self._pool_bytes + slab_need <= self.capacity or \
                    self.used + self._pool_bytes + _align(contig) <= self.capacity:
                slab = self._new_slab(contig)
                if slab is not None:
                    got = (slab.name, slab.alloc(contig))
        if got is None:
            # Capacity-bound: evict LRU arena objects until a contiguous
            # extent frees up.
            for victim in self._arena_victims():
                if victim.is_primary:
                    if not self.spill_dir:
                        continue  # sole copy: never dropped to make room
                    self._spill(victim)
                else:
                    self._drop_entry_storage(victim)
                    if not victim.spilled_path:
                        del self.objects[victim.oid]
                        if self.on_deleted:
                            self.on_deleted(victim.oid)
                got = self._arena_find(contig)
                if got is not None:
                    break
        if got is None:
            # Last resort: a fresh slab carved out of whatever _ensure_room
            # can still reclaim (segment pool, legacy evictions).
            slab = self._new_slab(contig)
            if slab is not None:
                got = (slab.name, slab.alloc(contig))
        if got is None or got[1] is None:
            raise ObjectStoreFullError(
                f"store full: need a {contig}-byte extent, used "
                f"{self.used}/{self.capacity}, arena free "
                f"{self.arena_free_bytes()}")
        extents = [(got[0], got[1], contig)]
        granted = contig
        want = _align(max(nbytes, contig))
        while granted < want and len(extents) < 8:
            more = self._arena_find(min(_align(want - granted), contig))
            if more is None:
                # Top-up stays strictly opportunistic: free extents in
                # existing slabs only.  Creating slabs here was measured
                # SLOWER on a put storm — each new slab pays a full
                # pre-fault zeroing pass, which costs more than the lease
                # RPC it saves (and at the capacity line the grow path
                # starts unlinking/recreating pre-faulted slabs, churning).
                break
            take = min(_align(want - granted), contig)
            extents.append((more[0], more[1], take))
            granted += take
        return extents

    def free_extent(self, slab_name: str, off: int, length: int) -> None:
        slab = self.slabs.get(slab_name)
        if slab is None:
            return
        slab.release(off, length)

    def seal_extent(self, oid: ObjectID, slab_name: str, off: int,
                    size: int, alen: int, is_primary: bool = True) -> bool:
        """Register + seal an object a client wrote into its leased extent —
        the fused put/seal (no create round trip, no separate seal).
        Returns False (and frees the extent) on a duplicate oid."""
        if slab_name not in self.slabs:
            logger.warning("seal for unknown slab %s (oid %s)", slab_name,
                           oid.hex()[:16])
            return False
        if oid in self.objects:
            self.free_extent(slab_name, off, alen)
            return False
        e = _Entry(oid, None, size, is_primary, alloc=_align(alen))
        e.slab = slab_name
        e.offset = off
        e.sealed = True
        self.objects[oid] = e
        if self.on_sealed:
            self.on_sealed(oid, size)
        return True

    def arena_free_bytes(self) -> int:
        return sum(s.free_bytes() for s in self.slabs.values())

    def _reclaim_arena(self, need: int) -> int:
        """Unlink fully-free slabs to give bytes back to `used` capacity."""
        freed = 0
        for name in list(self.slabs):
            if freed >= need:
                break
            slab = self.slabs[name]
            if slab.free_bytes() == slab.size:
                del self.slabs[name]
                self.used -= slab.size
                freed += slab.size
                try:
                    slab.shm.unlink()
                except FileNotFoundError:
                    pass
                try:
                    slab.shm.close()
                except BufferError:
                    pass  # a transient server-side view; pages die with it
        return freed

    def _drop_entry_storage(self, e: _Entry) -> None:
        """Release an entry's backing bytes (arena extent or segment)."""
        if e.slab is not None:
            self.free_extent(e.slab, e.offset, e.alloc)
            e.slab = None
        else:
            self._drop_shm(e)

    def _evictable(self) -> List[_Entry]:
        return [
            e for e in self.objects.values()
            if e.sealed and e.pins == 0
            and (e.shm is not None or e.slab is not None)
        ]

    def _ensure_room(self, size: int) -> bool:
        if self.used + self._pool_bytes + size <= self.capacity:
            return True
        # Pooled (free but still-mapped) segments are the cheapest room,
        # then fully-free arena slabs (same idea at slab granularity).
        need = self.used + self._pool_bytes + size - self.capacity
        self._pool_reclaim(need)
        self._reclaim_arena(self.used + self._pool_bytes + size - self.capacity)
        if self.used + self._pool_bytes + size <= self.capacity:
            return True
        victims = sorted(self._evictable(), key=lambda e: e.last_access)
        for e in victims:
            if self.used + self._pool_bytes + size <= self.capacity:
                break
            if e.is_primary:
                if self.spill_dir:
                    self._spill(e)
                # No spill dir: a primary copy is the ONLY copy — never delete
                # it to make room; the create fails instead.
            else:
                # pool_ok=False: this eviction exists to FREE memory — moving
                # the segment into the pool would make no progress and spill
                # further victims for nothing.
                if e.slab is not None:
                    self._drop_entry_storage(e)
                else:
                    self._drop_shm(e, pool_ok=False)
                if not e.spilled_path:
                    del self.objects[e.oid]
                    if self.on_deleted:
                        self.on_deleted(e.oid)
            # evicted arena extents only become reclaimable capacity once
            # their slab is fully free — sweep as we go
            self._reclaim_arena(
                self.used + self._pool_bytes + size - self.capacity)
        self._pool_reclaim(self.used + self._pool_bytes + size - self.capacity)
        return self.used + self._pool_bytes + size <= self.capacity

    def _spill(self, e: _Entry) -> None:
        os.makedirs(self.spill_dir, exist_ok=True)
        path = os.path.join(self.spill_dir, e.oid.hex())
        if e.slab is not None:
            src = self.slabs[e.slab].shm.buf[e.offset:e.offset + e.size]
        else:
            src = e.shm.buf[: e.size]
        with open(path, "wb") as f:
            f.write(src)
        del src
        e.spilled_path = path
        self.num_spilled += 1
        self.bytes_spilled += e.size
        # spilling exists to free memory: bypass the pool
        if e.slab is not None:
            self._drop_entry_storage(e)
        else:
            self._drop_shm(e, pool_ok=False)

    def _restore(self, e: _Entry) -> None:
        # Arena first: a restored extent lands in pre-faulted pages (and a
        # restored object may well be read again soon).
        got = self._arena_find(_align(e.size))
        if got is not None:
            slab_name, off = got
            with open(e.spilled_path, "rb") as f:
                f.readinto(self.slabs[slab_name].shm.buf[off:off + e.size])
            e.slab = slab_name
            e.offset = off
            e.alloc = _align(e.size)
            e.ever_viewed = False
            return
        alloc = self._bucket(e.size)
        shm = self._pool_take(alloc)
        if shm is None:
            if not self._ensure_room(alloc):
                raise ObjectStoreFullError(
                    f"cannot restore {e.oid}: store full ({self.used}/{self.capacity})"
                )
            shm = shared_memory.SharedMemory(
                name=self._segment_name(), create=True, size=alloc)
        with open(e.spilled_path, "rb") as f:
            f.readinto(shm.buf)
        e.shm = shm
        e.alloc = alloc
        e.ever_viewed = False
        self.used += alloc

    def _drop_shm(self, e: _Entry, pool_ok: bool = True) -> None:
        if e.shm is not None:
            self.used -= e.alloc
            if pool_ok and not e.ever_viewed and \
                    e.alloc >= self._POOL_MIN_SEGMENT and \
                    self._pool_bytes + e.alloc <= self._pool_cap:
                # Never aliased by a reader: safe to recycle with pages hot.
                self._seg_pool.setdefault(e.alloc, []).append(e.shm)
                self._pool_bytes += e.alloc
            else:
                try:
                    e.shm.unlink()
                except FileNotFoundError:
                    pass
                try:
                    e.shm.close()
                except BufferError:
                    # A transient server-side view (push/spill in flight)
                    # still aliases the buffer; the segment is unlinked so
                    # the pages are reclaimed when the mapping dies with the
                    # view.
                    pass
            e.shm = None

    # -- API -----------------------------------------------------------------
    def create(self, oid: ObjectID, size: int, is_primary: bool = True) -> str:
        """Allocate a segment for oid; returns the shm name for the client to map."""
        if oid in self.objects:
            e = self.objects[oid]
            if e.sealed:
                raise FileExistsError(f"object {oid} already sealed")
            # Re-create (e.g. failed writer): drop the half-written segment.
            self._drop_shm(e)
            del self.objects[oid]
        if size > self.capacity:
            raise ObjectStoreFullError(
                f"object of {size} bytes exceeds store capacity {self.capacity}"
            )
        alloc = self._bucket(size)
        shm = self._pool_take(alloc)
        if shm is None:
            if not self._ensure_room(alloc):
                raise ObjectStoreFullError(
                    f"store full: need {size}, used {self.used}/{self.capacity}, "
                    f"evictable {sum(x.size for x in self._evictable())}"
                )
            shm = shared_memory.SharedMemory(
                name=self._segment_name(), create=True, size=alloc)
        e = _Entry(oid, shm, size, is_primary, alloc=alloc)
        self.objects[oid] = e
        self.used += alloc
        return shm.name

    def seal(self, oid: ObjectID) -> None:
        e = self.objects[oid]
        e.sealed = True
        e.last_access = time.monotonic()
        if self.on_sealed:
            self.on_sealed(oid, e.size)

    def abort(self, oid: ObjectID) -> None:
        """Drop an unsealed (half-written) entry, e.g. a failed chunked pull."""
        e = self.objects.get(oid)
        if e is not None and not e.sealed:
            self._drop_shm(e)
            del self.objects[oid]

    def write_buffer(self, oid: ObjectID):
        """Writable view of an unsealed entry (chunked transfer landing pad)."""
        e = self.objects[oid]
        assert not e.sealed, f"object {oid} already sealed"
        e.ever_viewed = True  # returned view may outlive the entry
        return e.shm.buf

    def write_and_seal(self, oid: ObjectID, data: memoryview, is_primary: bool = True) -> None:
        """Server-side path used by object transfer (pull) and spill restore."""
        if self.contains(oid):
            return
        name = self.create(oid, data.nbytes, is_primary=is_primary)
        e = self.objects[oid]
        e.shm.buf[: data.nbytes] = data
        del name
        self.seal(oid)

    def contains(self, oid: ObjectID) -> bool:
        e = self.objects.get(oid)
        return e is not None and e.sealed

    @staticmethod
    def _resident(e: _Entry) -> bool:
        return e.shm is not None or e.slab is not None

    def get_local(self, oid: ObjectID, pin: bool = True) -> Optional[Tuple[str, int, int]]:
        """Return (shm_name, size, offset) for a sealed local object,
        restoring from spill.  Arena objects resolve to their slab segment +
        offset; per-object segments report offset 0.  Pins the object so it
        survives until the client releases it."""
        e = self.objects.get(oid)
        if e is None or not e.sealed:
            return None
        if not self._resident(e) and e.spilled_path:
            self._restore(e)
        e.last_access = time.monotonic()
        e.ever_viewed = True  # client maps by name: segment can't be pooled
        if pin:
            e.pins += 1
        if e.slab is not None:
            return (e.slab, e.size, e.offset)
        return (e.shm.name, e.size, 0)

    def read_bytes(self, oid: ObjectID) -> Optional[memoryview]:
        """Server-side view of the object payload (for node-to-node push)."""
        e = self.objects.get(oid)
        if e is None or not e.sealed:
            return None
        if not self._resident(e) and e.spilled_path:
            self._restore(e)
        e.last_access = time.monotonic()
        if e.slab is not None:
            return self.slabs[e.slab].shm.buf[e.offset:e.offset + e.size]
        e.ever_viewed = True  # returned view may outlive the entry
        return e.shm.buf[: e.size]

    def release(self, oid: ObjectID) -> None:
        e = self.objects.get(oid)
        if e is not None:
            if e.pins > 0:
                e.pins -= 1
            return
        z = self._zombies.get(oid)
        if z is not None:
            z.pins -= 1
            if z.pins <= 0:
                # last reader of a deleted arena object: extent reusable now
                del self._zombies[oid]
                self._drop_entry_storage(z)

    def delete(self, oid: ObjectID) -> None:
        e = self.objects.pop(oid, None)
        if e is None:
            return
        if e.slab is not None and e.pins > 0:
            # a reader still maps the slab: extent reuse under its zero-copy
            # view would corrupt it (per-object segments get this for free
            # from POSIX unlink; shared slabs must defer explicitly)
            self._zombies[oid] = e
        else:
            self._drop_entry_storage(e)
        if e.spilled_path:
            try:
                os.remove(e.spilled_path)
            except OSError:
                pass
        if self.on_deleted:
            self.on_deleted(oid)

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "used": self.used,
            "pooled": self._pool_bytes,
            "num_objects": len(self.objects),
            "num_spilled": self.num_spilled,
            "bytes_spilled": self.bytes_spilled,
            "arena_slabs": len(self.slabs),
            "arena_bytes": sum(s.size for s in self.slabs.values()),
            "arena_free": self.arena_free_bytes(),
            "zombie_extents": len(self._zombies),
        }

    def shutdown(self) -> None:
        for oid in list(self.objects):
            self.delete(oid)
        for oid in list(self._zombies):
            z = self._zombies.pop(oid)
            z.pins = 0
            self._drop_entry_storage(z)
        self._reclaim_arena(sum(s.size for s in self.slabs.values()))
        for slab in list(self.slabs.values()):  # extents still leased: force
            try:
                slab.shm.unlink()
            except FileNotFoundError:
                pass
            try:
                slab.shm.close()
            except BufferError:
                pass
            self.used -= slab.size
        self.slabs.clear()
        self._pool_reclaim(self._pool_bytes)


class PlasmaClient:
    """Client-side zero-copy access, used by CoreWorker.

    Methods are synchronous and called from the user thread; RPC metadata rides the
    worker's IO loop, the data path is direct shm mapping (reference:
    plasma_store_provider.h:88; zero-copy get semantics of plasma).

    The put hot path is round-trip-free in steady state: the client leases
    slab extents in bulk (one ``plasma_lease_extents`` RPC amortized over
    many puts), bump-allocates object frames inside them, and seals with a
    coalesced fire-and-forget notification — no ``plasma_create`` /
    ``plasma_seal`` round trips and no cold-page zeroing (slabs are
    pre-faulted server-side).
    """

    # Write-mapping cache budget: segment names recur when the store's pool
    # recycles a segment; re-attaching costs a full round of soft page
    # faults, so keeping the mapping makes repeated large puts run at
    # memcpy speed.  Names are never reused for a different segment (the
    # store's name sequence is monotonic), so a cached mapping is always
    # the right inode.  (Legacy path: arena puts write into slab mappings.)
    _WRITE_CACHE_BYTES = 256 * 1024 * 1024
    # A mapping of a segment the server has since unlinked can never hit
    # again (the name is gone forever) but still pins its pages outside the
    # store's accounting — drop any entry idle this long so stale mappings
    # are bounded in time, not only by budget pressure.
    _WRITE_CACHE_IDLE_S = 30.0

    def __init__(self, io, conn):
        # io: EventLoopThread, conn: Connection to the local nodelet
        self._io = io
        self._conn = conn
        # name -> [shm, in_use_count, last_used]; true LRU order (hits AND
        # releases refresh recency).  Guarded by _write_lock: puts run
        # concurrently on executor threads, and eviction must never close a
        # mapping another thread is mid-write on (in_use > 0).
        self._write_cache: "collections.OrderedDict[str, list]" = \
            collections.OrderedDict()
        self._write_cache_bytes = 0
        self._write_lock = threading.Lock()
        # Read-side mapping cache: one mapping per segment NAME (slabs are
        # shared by many objects and stay mapped; per-object segments close
        # when their object releases cleanly).
        self._maps: Dict[str, shared_memory.SharedMemory] = {}
        self._maps_lock = threading.Lock()
        # oid -> mapped segment name while we hold a server-side pin
        self._pins: Dict[ObjectID, str] = {}
        # oid -> memoryview slices handed to deserialization; a release may
        # only drop the server pin once every slice is releasable (an arena
        # extent must never be reused under a live zero-copy numpy view)
        self._views: Dict[ObjectID, list] = {}
        self._deferred_release: Set[ObjectID] = set()
        self._view_lock = threading.Lock()
        # Leased extent pool: [slab_name, off, len] carved by puts.
        self._extents: List[list] = []
        self._extent_lock = threading.Lock()
        self._extents_last_used = time.monotonic()
        self._extent_returns: List[Tuple[str, int, int]] = []
        # Adaptive prefetch: refills arriving back-to-back (a put storm)
        # double the next lease request, so the steady-state storm goes
        # RPC-free; the boost decays once the storm subsides.
        self._lease_boost = 1
        self._last_refill = 0.0
        # release coalescing: oids buffered here flush as ONE notify item
        self._release_buf: List[bytes] = []
        self._release_lock = threading.Lock()
        self._closed = False
        self._flush_task = io.spawn(self._flush_loop())

    # ------------------------------------------------------------ arena puts
    def put(self, oid: ObjectID, flat: memoryview | bytes) -> None:
        """Write + seal one object from an already-flat frame."""
        nbytes = flat.nbytes if isinstance(flat, memoryview) else len(flat)
        if not RayConfig.arena_enabled:
            return self._put_legacy(oid, flat, nbytes)
        slab, off = self._alloc_extent(nbytes)
        shm = self._map(slab)
        shm.buf[off:off + nbytes] = flat
        self._queue_seal(oid, slab, off, nbytes)

    def put_serialized(self, oid: ObjectID, ser) -> None:
        """Write + seal, streaming a SerializedObject's segments straight
        into the leased extent — no intermediate flat copy and, in steady
        state, no RPC round trip (bump-allocate + memcpy + coalesced seal
        notify)."""
        nbytes = ser.total_frame_bytes()
        if not RayConfig.arena_enabled:
            return self._put_serialized_legacy(oid, ser, nbytes)
        slab, off = self._alloc_extent(nbytes)
        shm = self._map(slab)
        ser.write_into(shm.buf[off:off + nbytes])
        self._queue_seal(oid, slab, off, nbytes)

    def _queue_seal(self, oid: ObjectID, slab: str, off: int,
                    nbytes: int) -> None:
        """Fire-and-forget fused seal: rides the per-tick coalesced batch
        frame.  A get racing ahead of the seal parks on the store's waiters
        and resolves when the seal lands (same-connection FIFO bounds the
        window to one tick)."""
        if fault_injection.ENABLED and fault_injection.hit(
                "plasma.seal", detail=oid.hex()) == "torn":
            # torn seal: the bytes were memcpy'd into the leased extent but
            # the store never learns the oid -- models a client SIGKILLed
            # in the window between write and seal notify
            return
        self._conn.notify_coalesced_threadsafe(
            "plasma_seal_extent",
            {"oid": oid.binary(), "slab": slab, "off": off,
             "size": nbytes, "alen": _align(nbytes)})

    def _alloc_extent(self, nbytes: int) -> Tuple[str, int]:
        """Carve an extent for one object from the local lease pool,
        refilling over RPC (with piggybacked extent returns) when dry."""
        alen = _align(nbytes)
        got = self._carve(alen)
        if got is not None:
            return got
        now = time.monotonic()
        if now - self._last_refill < 1.0:
            self._lease_boost = min(self._lease_boost * 2, 8)
        else:
            self._lease_boost = 1
        self._last_refill = now
        deadline = time.monotonic() + 30.0
        while True:
            with self._extent_lock:
                returns = self._extent_returns
                self._extent_returns = []
            msg = {"bytes": alen + max(alen * self._lease_boost,
                                       RayConfig.extent_lease_bytes),
                   "contig": alen,
                   "returns": [list(r) for r in returns]}
            try:
                resp = self._conn.call_sync("plasma_lease_extents", msg)
                break
            except ObjectStoreFullError:
                if time.monotonic() > deadline:
                    raise
                # hand back everything we hold before retrying: our own idle
                # lease may be the capacity the store is missing
                self.return_idle_extents(force=True)
                time.sleep(RayConfig.object_store_full_delay_ms / 1000.0)
        with self._extent_lock:
            self._extents.extend([list(e) for e in resp["extents"]])
        got = self._carve(alen)
        assert got is not None, "lease grant lost between refill and carve"
        return got

    def _carve(self, alen: int) -> Optional[Tuple[str, int]]:
        with self._extent_lock:
            for i, ext in enumerate(self._extents):
                if ext[2] >= alen:
                    slab, off = ext[0], ext[1]
                    ext[1] += alen
                    ext[2] -= alen
                    if ext[2] <= 0:
                        self._extents.pop(i)
                    self._extents_last_used = time.monotonic()
                    return slab, off
        return None

    def return_idle_extents(self, force: bool = False) -> None:
        """Queue unused leased extents for return to the store.  Without
        ``force`` only extents idle past extent_lease_idle_s go back (the
        pool exists to keep steady-state puts RPC-free)."""
        now = time.monotonic()
        with self._extent_lock:
            if not force and \
                    now - self._extents_last_used < RayConfig.extent_lease_idle_s:
                return
            returns, self._extents = self._extents, []
            self._extent_returns.extend(
                (e[0], e[1], e[2]) for e in returns if e[2] > 0)
            pending = list(self._extent_returns)
            self._extent_returns = [] if pending else self._extent_returns
        if pending and not self._conn.closed:
            try:
                self._conn.notify_coalesced_threadsafe(
                    "plasma_return_extents",
                    {"extents": [list(p) for p in pending]})
            except ConnectionError:
                pass

    # ---------------------------------------------------------- legacy puts
    def _put_legacy(self, oid: ObjectID, flat, nbytes: int) -> None:
        got = self._create(oid, nbytes)
        if got is None:
            return
        name, shm, cached = got
        try:
            shm.buf[:nbytes] = flat
        finally:
            if cached:
                self._release_write(name)
            else:
                shm.close()
        self._conn.call_sync("plasma_seal", {"oid": oid.binary()})

    def _put_serialized_legacy(self, oid: ObjectID, ser, nbytes: int) -> None:
        got = self._create(oid, nbytes)
        if got is None:
            return
        name, shm, cached = got
        try:
            ser.write_into(shm.buf)
        finally:
            if cached:
                self._release_write(name)
            else:
                shm.close()
        self._conn.call_sync("plasma_seal", {"oid": oid.binary()})

    def _map_for_write(self, name: str) -> Tuple[shared_memory.SharedMemory, bool]:
        """Returns (mapping, cached).  Cached mappings must be released via
        _release_write (not closed); uncached ones are the caller's to
        close."""
        now = time.monotonic()
        with self._write_lock:
            # time-bounded pruning of idle mappings (see _WRITE_CACHE_IDLE_S)
            for k in [k for k, v in self._write_cache.items()
                      if v[1] == 0 and now - v[2] > self._WRITE_CACHE_IDLE_S]:
                old = self._write_cache.pop(k)
                self._write_cache_bytes -= old[0].size
                old[0].close()
            ent = self._write_cache.get(name)
            if ent is not None:
                ent[1] += 1
                ent[2] = now
                self._write_cache.move_to_end(name)
                return ent[0], True
        shm = _attach_shm(name)
        size = shm.size
        if size > self._WRITE_CACHE_BYTES:
            return shm, False
        with self._write_lock:
            if name in self._write_cache:  # raced with another thread
                ent = self._write_cache[name]
                ent[1] += 1
                ent[2] = now
                self._write_cache.move_to_end(name)
                to_close = shm
            else:
                self._evict_write_cache_locked(size)
                self._write_cache[name] = [shm, 1, now]
                self._write_cache_bytes += size
                return shm, True
        to_close.close()
        return ent[0], True

    def _evict_write_cache_locked(self, incoming: int) -> None:
        """Evict idle mappings in true LRU order until ``incoming`` fits.
        Busy entries (a concurrent put mid-write) are skipped in place; if
        everything is busy the cache briefly runs over budget."""
        if self._write_cache_bytes + incoming <= self._WRITE_CACHE_BYTES:
            return
        for victim in [k for k, v in self._write_cache.items() if v[1] == 0]:
            if self._write_cache_bytes + incoming <= self._WRITE_CACHE_BYTES:
                return
            old = self._write_cache.pop(victim)
            self._write_cache_bytes -= old[0].size
            old[0].close()

    def _release_write(self, name: str) -> None:
        with self._write_lock:
            ent = self._write_cache.get(name)
            if ent is not None:
                ent[1] = max(ent[1] - 1, 0)
                ent[2] = time.monotonic()
                # releases refresh recency too: a mapping written N times in
                # a row must not be the first evicted because its initial
                # insertion happens to be oldest
                self._write_cache.move_to_end(name)

    def _create(self, oid: ObjectID, nbytes: int):
        """Allocate a segment, waiting out transient store-full; returns the
        mapped shm or None if the object already exists."""
        deadline = time.monotonic() + 30.0
        while True:
            try:
                resp = self._conn.call_sync("plasma_create", {"oid": oid.binary(), "size": nbytes})
                break
            except ObjectStoreFullError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(RayConfig.object_store_full_delay_ms / 1000.0)
        if resp.get("exists"):
            return None
        name = resp["name"]
        shm, cached = self._map_for_write(name)
        return name, shm, cached

    # ------------------------------------------------------------------ gets
    def _map(self, name: str) -> shared_memory.SharedMemory:
        with self._maps_lock:
            shm = self._maps.get(name)
            if shm is None:
                shm = _attach_shm(name)
                self._maps[name] = shm
            return shm

    def get_mapped(self, oid: ObjectID, timeout: Optional[float] = None) -> Optional[memoryview]:
        """Map a sealed object; returns a memoryview over shm or None on timeout.

        The nodelet blocks server-side until the object is local (pulling from
        remote nodes if needed), so no client-side polling.
        """
        resp = self._conn.call_sync(
            "plasma_get", {"oid": oid.binary(), "timeout": timeout}, timeout=None
        )
        if resp is None:
            return None
        name, size, off = resp
        if oid in self._pins:
            # Already pinned once by us; drop the extra server-side pin.
            self._queue_release(oid)
        else:
            self._pins[oid] = name
        shm = self._map(name)
        return shm.buf[off:off + size]

    def wrap_views(self, oid: ObjectID, buffers: list) -> list:
        """Wrap the zero-copy buffer slices deserialization will alias in
        refcount-probeable handles and track them: release() only drops the
        server-side pin (and with it the arena extent) once no live view
        remains.  A bare memoryview can't detect downstream aliasing — the
        buffer-protocol chain re-exports from the underlying mapping, so
        probing mv.release() misses a numpy array built on a slice.  A
        numpy wrapper CAN: every consumer's base chain holds a reference to
        it, so its refcount returning to baseline proves the views died."""
        if not buffers:
            return buffers
        import numpy as _np

        wrappers = [_np.frombuffer(b, dtype=_np.uint8) for b in buffers]
        with self._view_lock:
            self._views.setdefault(oid, []).extend(wrappers)
        return wrappers

    def contains(self, oid: ObjectID) -> bool:
        return self._conn.call_sync("plasma_contains", {"oid": oid.binary()})

    @staticmethod
    def _views_releasable(views: list) -> bool:
        """True once no deserialized value still aliases the mapped bytes:
        each wrapper's refcount is back to baseline (the tracked list entry
        + the loop binding + getrefcount's argument)."""
        import sys

        return all(sys.getrefcount(w) <= 3 for w in views)

    def release(self, oid: ObjectID) -> None:
        """Drop our hold on a mapped object.  The server-side pin is only
        released when no deserialized value still aliases the mapping —
        plasma's pin-until-last-view contract, enforced client-side because
        shared slabs have no per-object unlink safety net.  Never blocks:
        the actual release rides the coalesced notify batch."""
        with self._view_lock:
            views = self._views.pop(oid, None)
            if views is not None and not self._views_releasable(views):
                # still aliased: park it; the flush loop re-probes until the
                # views die, then the pin drops
                self._views[oid] = views
                self._deferred_release.add(oid)
                return
            self._deferred_release.discard(oid)
        name = self._pins.pop(oid, None)
        if name is None:
            return
        if not self._conn.closed:
            self._queue_release(oid)
        if not _is_slab_name(name) and name not in self._pins.values():
            # per-object segment: drop the mapping with the last release
            with self._maps_lock:
                shm = self._maps.pop(name, None)
            if shm is not None:
                try:
                    shm.close()
                except BufferError:
                    pass  # inband bytes() copies can't alias, but be safe

    def _retry_deferred_releases(self) -> None:
        with self._view_lock:
            retry = [oid for oid in self._deferred_release
                     if self._views_releasable(self._views.get(oid, []))]
        for oid in retry:
            self.release(oid)

    def _queue_release(self, oid: ObjectID) -> None:
        with self._release_lock:
            self._release_buf.append(oid.binary())
            if len(self._release_buf) > 1:
                return  # a flush is already scheduled for this burst
        try:
            self._io.loop.call_soon_threadsafe(self._flush_releases)
        except RuntimeError:
            pass  # loop closed: shutdown path

    def _flush_releases(self) -> None:
        with self._release_lock:
            oids, self._release_buf = self._release_buf, []
        if not oids or self._conn.closed:
            return
        try:
            self._conn.notify_coalesced("plasma_release", {"oids": oids})
        except ConnectionError:
            pass

    async def _flush_loop(self):
        """Housekeeping tick: re-probe deferred releases (views may have
        died), return long-idle leased extents."""
        while not self._closed:
            await asyncio.sleep(1.0)
            try:
                self._retry_deferred_releases()
                self.return_idle_extents()
            except Exception:
                logger.exception("plasma client flush tick failed")

    def free(self, oids: List[ObjectID]) -> None:
        try:
            self._conn.call_sync("plasma_delete", {"oids": [o.binary() for o in oids]})
        except ConnectionError:
            pass

    def free_async(self, oids: List[ObjectID]) -> None:
        """Coalesced fire-and-forget local delete — the owner's fast path
        for out-of-scope objects (the GCS broadcast still sweeps remote
        copies; local capacity frees without waiting on that hop)."""
        try:
            self._conn.notify_coalesced_threadsafe(
                "plasma_delete", {"oids": [o.binary() for o in oids]})
        except ConnectionError:
            pass

    def close(self) -> None:
        """Flush pending control traffic (worker teardown must not leak
        pins/extents server-side: the store's conn cleanup would get them,
        but an orderly flush keeps accounting exact when the conn outlives
        us)."""
        self._closed = True
        try:
            self._flush_task.cancel()
        except Exception:
            pass
        self.return_idle_extents(force=True)
        with self._release_lock:
            oids, self._release_buf = self._release_buf, []
        if oids and not self._conn.closed:
            try:
                self._conn.notify_sync("plasma_release", {"oids": oids},
                                       timeout=2.0)
            except Exception:
                pass


class RemotePlasmaClient:
    """RPC-only plasma access for drivers on a DIFFERENT machine than their
    nodelet (reference role: Ray Client, util/client/ — a remote REPL drives
    the cluster without local shared memory).  Same surface as PlasmaClient;
    the data path is the chunked fetch RPC instead of shm mapping, and puts
    ship bytes inline for the nodelet to write into its store."""

    def __init__(self, io, conn):
        self._io = io
        self._conn = conn

    def put(self, oid: ObjectID, flat) -> None:
        self._put_bytes(oid, flat)

    def put_serialized(self, oid: ObjectID, ser) -> None:
        """Stream the frame per chunk straight from the SerializedObject's
        segments — no flattened intermediate copy, so a large ray:// put
        peaks at one chunk of extra memory instead of 2x the payload."""
        total = ser.total_frame_bytes()
        chunk = RayConfig.fetch_chunk_bytes
        if total <= chunk:
            # One scatter-gather write into a single frame buffer; the RPC
            # layer then ships it out-of-band (PickleBuffer) — exactly one
            # copy on this side instead of the old to_bytes() + bytes()
            # double cast.
            flat = bytearray(total)
            ser.write_into(flat)
            self._put_bytes(oid, memoryview(flat))
            return
        deadline = time.monotonic() + 30.0
        while True:
            try:
                resp = self._conn.call_sync("plasma_put_begin",
                                            {"oid": oid.binary(),
                                             "size": total})
                break
            except ObjectStoreFullError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(RayConfig.object_store_full_delay_ms / 1000.0)
        if resp.get("exists"):
            return
        try:
            off = 0
            for part in ser.iter_frame(chunk):
                # PickleBuffer rides the RPC pickle-5 out-of-band path: the
                # chunk is written to the socket segment-wise, never
                # flattened into an intermediate bytes.  call_sync blocks
                # until the reply, so the source view stays live for the
                # whole write.
                self._conn.call_sync("plasma_put_chunk",
                                     {"oid": oid.binary(), "offset": off,
                                      "data": pickle.PickleBuffer(part)})
                off += part.nbytes
            self._conn.call_sync("plasma_seal", {"oid": oid.binary()})
        except BaseException:
            try:
                self._conn.call_sync("plasma_put_abort",
                                     {"oid": oid.binary()})
            except Exception:
                pass
            raise

    def wrap_views(self, oid: ObjectID, buffers: list) -> list:
        return buffers  # gets are RPC copies: nothing aliases shared memory

    def _put_bytes(self, oid: ObjectID, data) -> None:
        """Small puts ride one frame; large ones stream in chunks so a
        multi-GiB ray.put from a ray:// driver never balloons either end's
        memory with a monolithic message (gets were already chunked)."""
        data = data if isinstance(data, memoryview) else memoryview(data)
        chunk = RayConfig.fetch_chunk_bytes
        deadline = time.monotonic() + 30.0
        while True:
            try:
                if data.nbytes <= chunk:
                    self._conn.call_sync("plasma_put_bytes",
                                         {"oid": oid.binary(),
                                          "data": pickle.PickleBuffer(data)})
                    return
                resp = self._conn.call_sync("plasma_put_begin",
                                            {"oid": oid.binary(),
                                             "size": data.nbytes})
                if resp.get("exists"):
                    return
                break
            except ObjectStoreFullError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(RayConfig.object_store_full_delay_ms / 1000.0)
        try:
            off = 0
            while off < data.nbytes:
                part = data[off:off + chunk]
                self._conn.call_sync("plasma_put_chunk",
                                     {"oid": oid.binary(), "offset": off,
                                      "data": pickle.PickleBuffer(part)})
                off += part.nbytes
            self._conn.call_sync("plasma_seal", {"oid": oid.binary()})
        except BaseException:
            try:
                self._conn.call_sync("plasma_put_abort",
                                     {"oid": oid.binary()})
            except Exception:
                pass
            raise

    def get_mapped(self, oid: ObjectID, timeout=None):
        """Wait server-side (plasma_get pins), then stream chunks over RPC."""
        resp = self._conn.call_sync(
            "plasma_get", {"oid": oid.binary(), "timeout": timeout},
            timeout=None)
        if resp is None:
            return None
        _name, size, _off = resp
        try:
            out = bytearray(size)
            off = 0
            chunk = RayConfig.fetch_chunk_bytes
            while off < size:
                r = self._conn.call_sync(
                    "fetch_object_chunk",
                    {"oid": oid.binary(), "off": off,
                     "len": min(chunk, size - off)})
                if r is None:
                    return None  # evicted mid-fetch; caller retries/recovers
                out[off:off + len(r["data"])] = r["data"]
                off += len(r["data"])
            return memoryview(out)
        finally:
            try:
                self._conn.call_sync("plasma_release",
                                     {"oids": [oid.binary()]})
            except ConnectionError:
                pass

    def contains(self, oid: ObjectID) -> bool:
        return self._conn.call_sync("plasma_contains", {"oid": oid.binary()})

    def release(self, oid: ObjectID) -> None:
        pass  # no local mapping to drop; the pin is released in get_mapped

    def free(self, oids) -> None:
        try:
            self._conn.call_sync(
                "plasma_delete", {"oids": [o.binary() for o in oids]})
        except ConnectionError:
            pass

    def free_async(self, oids) -> None:
        try:
            self._conn.notify_coalesced_threadsafe(
                "plasma_delete", {"oids": [o.binary() for o in oids]})
        except ConnectionError:
            pass

    def return_idle_extents(self, force: bool = False) -> None:
        pass  # no extent leases over the remote data path

    def close(self) -> None:
        pass


def register_store_handlers(handlers: dict, store: PlasmaStore, waiters: dict,
                            on_miss=None, on_full=None) -> None:
    """Wire plasma_* RPC methods into a nodelet server handler table.

    ``waiters`` maps ObjectID -> list of asyncio futures resolved when the object
    becomes local; the nodelet's pull manager also resolves these.  ``on_miss(oid)``
    is called (on the loop) when a get targets a non-local object — the nodelet's
    pull manager uses it to start fetching from a remote node (reference:
    pull_manager.h:52).  ``on_full()`` is called when an extent lease hits
    store-full — the nodelet broadcasts an extent-reclaim hint so other
    clients hand back idle leases before the requester's retry.
    """

    def _wake_waiters(oid):
        for fut in waiters.pop(oid, []):
            if not fut.done():
                fut.set_result(True)

    def _consume_leased(conn, slab: str, off: int, alen: int) -> None:
        """Remove a sealed sub-range from this connection's leased set."""
        leased = conn.context.get("plasma_extents")
        if not leased:
            return
        runs = leased.get(slab)
        if not runs:
            return
        end = off + alen
        for i, run in enumerate(runs):
            r_off, r_len = run
            if r_off <= off and end <= r_off + r_len:
                pieces = []
                if off > r_off:
                    pieces.append([r_off, off - r_off])
                if end < r_off + r_len:
                    pieces.append([end, r_off + r_len - end])
                runs[i:i + 1] = pieces
                if not runs:
                    del leased[slab]
                return

    async def plasma_lease_extents(conn, msg):
        """Bulk extent lease: the put fast path's only RPC.  Piggybacks
        extent returns so a client's retry-after-full hands capacity back in
        the same frame."""
        for slab, off, ln in msg.get("returns") or ():
            _consume_leased(conn, slab, off, ln)
            store.free_extent(slab, off, ln)
        try:
            extents = store.lease_extents(msg["bytes"], msg["contig"])
        except ObjectStoreFullError:
            if on_full is not None:
                on_full()
            raise
        leased = conn.context.setdefault("plasma_extents", {})
        for slab, off, ln in extents:
            leased.setdefault(slab, []).append([off, ln])
        return {"extents": [list(e) for e in extents]}

    async def plasma_return_extents(conn, msg):
        for slab, off, ln in msg.get("extents") or ():
            _consume_leased(conn, slab, off, ln)
            store.free_extent(slab, off, ln)
        return True

    async def plasma_seal_extent(conn, msg):
        """Fused put/seal: register the object the client already wrote into
        its leased extent (fire-and-forget; rides the coalesced batch)."""
        oid = ObjectID(msg["oid"])
        _consume_leased(conn, msg["slab"], msg["off"], msg["alen"])
        store.seal_extent(oid, msg["slab"], msg["off"], msg["size"],
                          msg["alen"])
        _wake_waiters(oid)
        return True

    async def plasma_create(conn, msg):
        oid = ObjectID(msg["oid"])
        if store.contains(oid):
            return {"exists": True}
        name = store.create(oid, msg["size"])
        conn.context.setdefault("plasma_creating", set()).add(oid)
        return {"name": name, "exists": False}

    async def plasma_seal(conn, msg):
        oid = ObjectID(msg["oid"])
        store.seal(oid)
        conn.context.get("plasma_creating", set()).discard(oid)
        _wake_waiters(oid)
        return True

    def _track_pin(conn, oid):
        pins = conn.context.setdefault("plasma_pins", {})
        pins[oid] = pins.get(oid, 0) + 1

    async def plasma_get(conn, msg):
        oid = ObjectID(msg["oid"])
        timeout = msg.get("timeout")
        entry = store.get_local(oid)
        if entry is not None:
            _track_pin(conn, oid)
            return entry
        fut = asyncio.get_event_loop().create_future()
        waiters.setdefault(oid, []).append(fut)
        if on_miss is not None:
            on_miss(oid)
        try:
            await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            lst = waiters.get(oid)
            if lst is not None:
                try:
                    lst.remove(fut)
                except ValueError:
                    pass
                if not lst:
                    del waiters[oid]
            return None
        entry = store.get_local(oid)
        if entry is not None:
            _track_pin(conn, oid)
        return entry

    async def plasma_put_bytes(conn, msg):
        """Client-mode put: the driver ships bytes; this node materializes
        the object in its store (reference: Ray Client proxying ray.put)."""
        oid = ObjectID(msg["oid"])
        # write through the store's own mapping (a raw SharedMemory attach
        # here would double-register with the resource tracker)
        store.write_and_seal(oid, memoryview(msg["data"]))
        for fut in waiters.pop(oid, []):
            if not fut.done():
                fut.set_result(True)
        return True

    async def plasma_put_begin(conn, msg):
        """Chunked client-mode put: allocate the landing entry (reference:
        chunked object transfer, object_manager.proto — a multi-GiB put must
        not ride one RPC frame on either end)."""
        oid = ObjectID(msg["oid"])
        if store.contains(oid):
            return {"exists": True}
        store.create(oid, msg["size"])
        # tracked like plasma_create: a driver dying mid-put must not leak
        # the unsealed entry (cleanup_client_connection sweeps this set)
        conn.context.setdefault("plasma_creating", set()).add(oid)
        return {"exists": False}

    async def plasma_put_chunk(conn, msg):
        oid = ObjectID(msg["oid"])
        off = msg["offset"]
        data = msg["data"]
        store.write_buffer(oid)[off:off + len(data)] = data

    async def plasma_put_abort(conn, msg):
        oid = ObjectID(msg["oid"])
        store.abort(oid)
        conn.context.get("plasma_creating", set()).discard(oid)
        return True

    async def plasma_contains(conn, msg):
        return store.contains(ObjectID(msg["oid"]))

    async def plasma_wait(conn, msg):
        """Block until the object is sealed locally (or timeout) WITHOUT
        pinning or mapping it — the event source behind ray.wait's
        plasma-resident arm.  A bare contains-poll costs a full
        wait_poll_interval_ms of latency per streamed item; parking on the
        store's seal waiters delivers the wakeup the moment the producer
        seals."""
        oid = ObjectID(msg["oid"])
        if store.contains(oid):
            return True
        fut = asyncio.get_event_loop().create_future()
        waiters.setdefault(oid, []).append(fut)
        try:
            await asyncio.wait_for(fut, msg.get("timeout"))
        except asyncio.TimeoutError:
            lst = waiters.get(oid)
            if lst is not None:
                try:
                    lst.remove(fut)
                except ValueError:
                    pass
                if not lst:
                    del waiters[oid]
            return False
        return store.contains(oid)

    async def plasma_release(conn, msg):
        # coalesced {"oids": [...]} releases; singular {"oid"} kept for
        # protocol-v1 peers that predate the list form (no current caller
        # sends it — see docs/WIRE_CONTRACT.md)
        oid_bins = msg.get("oids")
        if oid_bins is None:
            oid_bins = [msg["oid"]]
        pins = conn.context.get("plasma_pins", {})
        for b in oid_bins:
            oid = ObjectID(b)
            store.release(oid)
            if pins.get(oid, 0) > 1:
                pins[oid] -= 1
            else:
                pins.pop(oid, None)
        return True

    async def plasma_delete(conn, msg):
        for b in msg["oids"]:
            store.delete(ObjectID(b))
        return True

    async def plasma_stats(conn, msg):
        return store.stats()

    handlers.update(
        plasma_put_bytes=plasma_put_bytes,
        plasma_put_begin=plasma_put_begin,
        plasma_put_chunk=plasma_put_chunk,
        plasma_put_abort=plasma_put_abort,
        plasma_create=plasma_create,
        plasma_seal=plasma_seal,
        plasma_lease_extents=plasma_lease_extents,
        plasma_return_extents=plasma_return_extents,
        plasma_seal_extent=plasma_seal_extent,
        plasma_get=plasma_get,
        plasma_contains=plasma_contains,
        plasma_wait=plasma_wait,
        plasma_release=plasma_release,
        plasma_delete=plasma_delete,
        plasma_stats=plasma_stats,
    )


def cleanup_client_connection(store: PlasmaStore, conn,
                              waiters: Optional[dict] = None) -> None:
    """Release a dead client's pins, half-written creates, and leased-but-
    unsealed extents (reference: plasma store disconnect cleanup,
    plasma/store.cc DisconnectClient)."""
    for oid, n in conn.context.pop("plasma_pins", {}).items():
        for _ in range(n):
            store.release(oid)
    for oid in conn.context.pop("plasma_creating", set()):
        e = store.objects.get(oid)
        if e is not None and not e.sealed:
            store.delete(oid)
            # Crash consistency: gets parked on an object its creator never
            # sealed must not burn their full timeout -- the primary copy
            # died with the client.  Waking the future makes plasma_get
            # re-check the store, find nothing, and return a miss that the
            # owner-side recovery/retry path handles immediately.
            if waiters is not None:
                for fut in waiters.pop(oid, []):
                    if not fut.done():
                        fut.set_result(False)
    for slab, runs in conn.context.pop("plasma_extents", {}).items():
        # leased-but-unsealed extents return to the free list: a SIGKILLed
        # client's runs are re-leasable by the next client immediately
        for off, ln in runs:
            store.free_extent(slab, off, ln)
