"""Port of ``ray_tpu/_private/reference_count.py``.

Distributed reference counting: ownership-based GC.

Counterpart of the reference's ``ReferenceCounter`` (reference:
src/ray/core_worker/reference_count.h:61) with the same ownership model, condensed:

- Every object has exactly one *owner* — the worker whose task created it or that
  called ``put``.  The owner tracks: local Python refs, submitted-task uses (the
  object is an argument of an in-flight task), and *borrowers* (other workers that
  hold a deserialized copy of the ref).
- When all three hit zero the object is out of scope: the owner frees the value
  (memory store) and broadcasts plasma deletion via the GCS object directory.
- Borrowers notify the owner on first deserialization (add_borrow) and when their
  local count hits zero (remove_borrow).  Chained borrows re-anchor to the owner —
  every holder talks straight to the owner, a simplification of the reference's
  hierarchical borrower lists (reference WaitForRefRemoved protocol).
- Lineage pinning: while an object may need reconstruction, its creating TaskSpec
  is retained by the owner's task manager; the ref counter reports out-of-scope
  events so lineage can be released (reference: task_manager.h:215).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Set, Tuple

from ray_tpu_torch._private.ids import ObjectID


class _Ref:
    __slots__ = ("local", "submitted", "borrowers", "owned", "owner_addr", "owner_worker_id", "freed")

    def __init__(self, owned: bool):
        self.local = 0
        self.submitted = 0
        self.borrowers: Set[bytes] = set()
        self.owned = owned
        self.owner_addr: Optional[Tuple[str, int]] = None
        self.owner_worker_id: Optional[bytes] = None
        self.freed = False


class ReferenceCounter:
    """Per-worker reference table. Thread-safe."""

    def __init__(self, worker_id: bytes, on_out_of_scope: Callable[[ObjectID], None],
                 notify_owner: Callable[[Tuple[str, int], str, ObjectID], None]):
        self._worker_id = worker_id
        self._lock = threading.Lock()
        self._refs: Dict[ObjectID, _Ref] = {}
        # on_out_of_scope(oid): owner-side free (delete value + plasma copies).
        self._on_out_of_scope = on_out_of_scope
        # notify_owner(owner_addr, "add"|"remove", oid): borrower-side notify.
        self._notify_owner = notify_owner

    # -- owner side ----------------------------------------------------------
    def add_owned(self, oid: ObjectID, initial_local: int = 1) -> None:
        with self._lock:
            r = self._refs.get(oid)
            if r is None:
                r = self._refs[oid] = _Ref(owned=True)
            r.owned = True
            r.local += initial_local

    def add_borrower(self, oid: ObjectID, borrower_id: bytes) -> None:
        with self._lock:
            r = self._refs.get(oid)
            if r is None:
                r = self._refs[oid] = _Ref(owned=True)
            r.borrowers.add(borrower_id)

    def remove_borrower(self, oid: ObjectID, borrower_id: bytes) -> None:
        cb = None
        with self._lock:
            r = self._refs.get(oid)
            if r is None:
                return
            r.borrowers.discard(borrower_id)
            cb = self._maybe_out_of_scope_locked(oid, r)
        if cb:
            cb()

    # -- borrower / local side ------------------------------------------------
    def add_local(self, oid: ObjectID, owner_addr=None, owner_worker_id=None) -> None:
        notify = False
        with self._lock:
            r = self._refs.get(oid)
            if r is None:
                r = self._refs[oid] = _Ref(owned=False)
                r.owner_addr = owner_addr
                r.owner_worker_id = owner_worker_id
                # First sight of a borrowed ref in this process: tell the owner.
                notify = owner_addr is not None and owner_worker_id != self._worker_id
            r.local += 1
        if notify:
            self._notify_owner(owner_addr, "add", oid)

    def remove_local(self, oid: ObjectID) -> bool:
        """Drop one local hold.  Returns True while the ref is still
        tracked afterwards — callers previously paid a second lock
        acquisition (``has``) per release to learn this."""
        cb = None
        notify_addr = None
        with self._lock:
            r = self._refs.get(oid)
            if r is None:
                return False
            r.local -= 1
            if r.local <= 0 and r.submitted <= 0:
                if r.owned:
                    cb = self._maybe_out_of_scope_locked(oid, r)
                else:
                    notify_addr = r.owner_addr
                    del self._refs[oid]
            present = oid in self._refs
        if cb:
            cb()
        if notify_addr is not None:
            self._notify_owner(notify_addr, "remove", oid)
        return present

    def add_submitted(self, oid: ObjectID) -> None:
        with self._lock:
            r = self._refs.get(oid)
            if r is None:
                r = self._refs[oid] = _Ref(owned=False)
            r.submitted += 1

    def remove_submitted(self, oid: ObjectID) -> None:
        cb = None
        notify_addr = None
        with self._lock:
            r = self._refs.get(oid)
            if r is None:
                return
            r.submitted -= 1
            if r.local <= 0 and r.submitted <= 0:
                if r.owned:
                    cb = self._maybe_out_of_scope_locked(oid, r)
                else:
                    notify_addr = r.owner_addr
                    del self._refs[oid]
        if cb:
            cb()
        if notify_addr is not None:
            self._notify_owner(notify_addr, "remove", oid)

    # -- internals ------------------------------------------------------------
    def _maybe_out_of_scope_locked(self, oid: ObjectID, r: _Ref):
        if r.owned and not r.freed and r.local <= 0 and r.submitted <= 0 and not r.borrowers:
            r.freed = True
            del self._refs[oid]
            return lambda: self._on_out_of_scope(oid)
        return None

    def owned_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._refs.values() if r.owned)

    def has(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._refs

    def debug(self, oid: ObjectID) -> Optional[dict]:
        with self._lock:
            r = self._refs.get(oid)
            if r is None:
                return None
            return {
                "local": r.local, "submitted": r.submitted,
                "borrowers": len(r.borrowers), "owned": r.owned,
            }
