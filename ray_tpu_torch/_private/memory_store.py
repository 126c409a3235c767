"""Port of ``ray_tpu/_private/memory_store.py``.

In-process memory store: futures for task returns + small owned objects.

Counterpart of the reference's ``CoreWorkerMemoryStore`` (reference:
src/ray/core_worker/store_provider/memory_store/memory_store.h:43).  Every object a
worker owns that is small enough to bypass plasma lives here; pending task returns
are registered as unresolved entries that ``ray.get`` blocks on.  Thread-safe:
written from the IO loop (task replies arriving over RPC), read from the user
thread (``ray.get``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.ids import ObjectID

# Sentinel meaning "the value lives in plasma; go through the plasma provider".
IN_PLASMA = object()


class _Entry:
    __slots__ = ("value", "ready", "event", "error")

    def __init__(self):
        self.value: Any = None
        self.ready = False
        self.event: Optional[threading.Event] = None
        self.error: Optional[BaseException] = None


class MemoryStore:
    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[ObjectID, _Entry] = {}
        self._waiter_cbs: Dict[ObjectID, List[Callable[[], None]]] = {}

    def register_pending(self, oid: ObjectID) -> None:
        """Declare an object that will be produced later (a task return)."""
        with self._lock:
            self._entries.setdefault(oid, _Entry())

    def put(self, oid: ObjectID, value: Any, error: Optional[BaseException] = None,
            force: bool = False) -> None:
        """force=True overwrites a ready entry — task completions use it so a
        reconstruction re-run's outcome (new value / error) replaces the
        stale pre-loss entry instead of being dropped by idempotency."""
        with self._lock:
            e = self._entries.setdefault(oid, _Entry())
            if e.ready and not force:
                return  # idempotent (retries may double-complete)
            e.value = value
            e.error = error
            e.ready = True
            ev = e.event
            cbs = self._waiter_cbs.pop(oid, [])
        if ev is not None:
            ev.set()
        for cb in cbs:
            cb()

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            e = self._entries.get(oid)
            return e is not None and e.ready

    def known(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._entries

    def get_if_ready(self, oid: ObjectID) -> Tuple[bool, Any, Optional[BaseException]]:
        with self._lock:
            e = self._entries.get(oid)
            if e is None or not e.ready:
                return False, None, None
            return True, e.value, e.error

    def try_get(self, oid: ObjectID) -> Tuple[bool, bool, Any, Optional[BaseException]]:
        """(known, ready, value, error) in ONE lock acquisition — the
        ray.get fast path previously paid three (known -> wait_ready ->
        get_if_ready) per resolved object."""
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                return False, False, None, None
            if not e.ready:
                return True, False, None, None
            return True, True, e.value, e.error

    def wait_ready(self, oid: ObjectID, timeout: Optional[float]) -> bool:
        """Block the calling (user) thread until the object resolves."""
        with self._lock:
            e = self._entries.get(oid)
            if e is None:
                return False
            if e.ready:
                return True
            if e.event is None:
                e.event = threading.Event()
            ev = e.event
        return ev.wait(timeout)

    def add_ready_callback(self, oid: ObjectID, cb: Callable[[], None]) -> bool:
        """Invoke cb (on whichever thread resolves the object) once ready.
        Returns True if already ready (cb NOT invoked)."""
        with self._lock:
            e = self._entries.get(oid)
            if e is not None and e.ready:
                return True
            self._waiter_cbs.setdefault(oid, []).append(cb)
            if e is None:
                self._entries.setdefault(oid, _Entry())
        return False

    def remove_ready_callback(self, oid: ObjectID, cb) -> None:
        """Deregister a callback added by add_ready_callback (long-poll
        timeouts must not accumulate closures on long-pending objects)."""
        with self._lock:
            lst = self._waiter_cbs.get(oid)
            if lst is not None:
                try:
                    lst.remove(cb)
                except ValueError:
                    pass
                if not lst:
                    del self._waiter_cbs[oid]

    def delete(self, oid: ObjectID) -> None:
        with self._lock:
            self._entries.pop(oid, None)
            self._waiter_cbs.pop(oid, None)

    def size(self) -> int:
        with self._lock:
            return len(self._entries)
