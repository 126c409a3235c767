"""Port of ``ray_tpu/_private/object_ref.py``.

ObjectRef: a handle to a (possibly pending) remote value.

Counterpart of the reference's ObjectRef (reference: python/ray/_raylet.pyx
ObjectRef; ownership fields from reference_count.h).  The ref embeds its owner's
address so any process holding it can resolve the value and participate in the
borrower protocol.  ``__del__`` drives distributed GC; ``__reduce__`` records the
ref with the in-flight serialization so the owner learns about borrowers.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.serialization import record_contained_ref


class ObjectRef:
    __slots__ = ("_oid", "_owner_addr", "_owner_worker_id", "_registered", "__weakref__")

    def __init__(self, oid: ObjectID, owner_addr: Optional[Tuple[str, int]] = None,
                 owner_worker_id: Optional[bytes] = None, _register: bool = True):
        self._oid = oid
        self._owner_addr = tuple(owner_addr) if owner_addr else None
        self._owner_worker_id = owner_worker_id
        self._registered = False
        if _register:
            from ray_tpu_torch._private import worker as worker_mod

            cw = worker_mod.global_worker_core()
            if cw is not None:
                cw.register_ref(self)
                self._registered = True

    # -- identity -------------------------------------------------------------
    @property
    def oid(self) -> ObjectID:
        return self._oid

    def binary(self) -> bytes:
        return self._oid.binary()

    def hex(self) -> str:
        return self._oid.hex()

    def owner_addr(self):
        return self._owner_addr

    def owner_worker_id(self):
        return self._owner_worker_id

    def task_id(self):
        return self._oid.task_id()

    def job_id(self):
        return self._oid.job_id()

    def __hash__(self):
        return hash(self._oid)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._oid == self._oid

    def __repr__(self):
        return f"ObjectRef({self._oid.hex()})"

    # -- lifecycle ------------------------------------------------------------
    def __del__(self):
        if self._registered:
            try:
                from ray_tpu_torch._private import worker as worker_mod

                cw = worker_mod.global_worker_core()
                if cw is not None:
                    cw.deregister_ref(self)
            except Exception:
                pass  # interpreter shutdown: imports/loop may be gone

    def __reduce__(self):
        record_contained_ref(self)
        return (
            _reconstruct_ref,
            (self._oid.binary(), self._owner_addr, self._owner_worker_id),
        )

    # -- sugar ----------------------------------------------------------------
    def __await__(self):
        """Await inside async actors / drivers: yields the resolved value."""
        from ray_tpu_torch._private import worker as worker_mod

        return worker_mod.get_async(self).__await__()

    def future(self):
        """A concurrent.futures.Future resolving to the value."""
        from ray_tpu_torch._private import worker as worker_mod

        return worker_mod.global_worker().core.as_future(self)


def _reconstruct_ref(oid_b: bytes, owner_addr, owner_worker_id) -> ObjectRef:
    return ObjectRef(ObjectID(oid_b), owner_addr, owner_worker_id)


class ObjectRefGenerator:
    """Handle for ``num_returns="dynamic"`` tasks (reference:
    ray._raylet.ObjectRefGenerator): iterating yields one ObjectRef per
    value the remote generator produced.  Refs materialize when the task
    COMPLETES (dynamic semantics); iteration therefore blocks on task
    completion, then yields instantly.  If the generator is never
    iterated, the yielded objects live until job end (no eager release).

    ``num_returns="streaming"`` upgrades the handle: item oids are
    deterministic (``ObjectID.from_task(task, i+1)``) and the executor
    forces every yield into plasma at yield time, so :meth:`stream` can
    hand out the i-th ref the moment the producer seals it — while the
    task is still running.  On a plain dynamic handle :meth:`stream`
    degrades gracefully to completion-time iteration (small items may
    ride the completion reply and only become visible then)."""

    def __init__(self, primary_ref: "ObjectRef", streaming: bool = False):
        self._primary = primary_ref
        self._refs = None
        self._streaming = streaming
        # i -> speculative ObjectRef handed out by item_ref().  The cache
        # pins each speculative ref for the life of this handle: once the
        # producer completes, its item oids become OWNED in the submitter's
        # ref counter, and GC of a transient speculative ref would drive the
        # count to zero and free a not-yet-consumed item from plasma.
        self._spec_refs = {}

    def _materialize(self, timeout=None):
        if self._refs is None:
            from ray_tpu_torch._private import worker as worker_mod
            from ray_tpu_torch._private.ids import ObjectID

            metas = worker_mod.get(self._primary, timeout=timeout)
            self._refs = [ObjectRef(ObjectID(ob), addr, wid)
                          for ob, addr, wid in metas]
            # the durable refs above now hold the real items; cached
            # speculative refs (including indexes past the final count)
            # can release their tracking entries
            self._spec_refs.clear()
        return self._refs

    def __iter__(self):
        return iter(self._materialize())

    def __len__(self):
        return len(self._materialize())

    def __getitem__(self, i):
        return self._materialize()[i]

    def completed(self, timeout=None) -> list:
        """Block until the task finishes; returns the ref list."""
        return list(self._materialize(timeout))

    @property
    def streaming(self) -> bool:
        return self._streaming

    def task_done(self) -> bool:
        """True once the producing task finished (its primary return — the
        ref-list meta — is ready).  Non-blocking."""
        if self._refs is not None:
            return True
        from ray_tpu_torch._private import worker as worker_mod

        ready, _ = worker_mod.wait([self._primary], num_returns=1, timeout=0)
        return bool(ready)

    def item_ref(self, i: int) -> "ObjectRef":
        """Speculative ref for the i-th yielded item, derivable BEFORE task
        completion: dynamic item oids are ``from_task(task_id, i+1)`` and
        the items are owned by this caller (the submitter), so the ref can
        be constructed locally.  The ref only becomes waitable once the
        producer creates the item (immediately at yield time for streaming
        handles); an index past the final item count never fires."""
        if self._refs is not None and i < len(self._refs):
            return self._refs[i]
        ref = self._spec_refs.get(i)
        if ref is None:
            oid = ObjectID.from_task(self._primary.oid.task_id(), i + 1)
            ref = ObjectRef(oid, self._primary.owner_addr(),
                            self._primary.owner_worker_id())
            self._spec_refs[i] = ref
        return ref

    def stream(self, timeout_s: Optional[float] = None, start: int = 0):
        """Yield item refs as the producer creates them.

        Each step waits on (speculative item i, primary): whichever lands
        first decides — the item is yielded live, or the completed task's
        materialized ref list finishes the tail (this is also where a
        failed producer's error — e.g. ActorDiedError after a SIGKILL —
        re-raises, so a consumer multiplexing several streams learns of a
        dead producer at its next touch of that stream).  ``timeout_s``
        bounds each individual step, not the whole stream."""
        import time as _time

        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch.exceptions import GetTimeoutError

        i = start
        while True:
            if self._refs is not None:
                while i < len(self._refs):
                    yield self._refs[i]
                    i += 1
                return
            spec = self.item_ref(i)
            deadline = None if timeout_s is None \
                else _time.monotonic() + timeout_s
            while True:
                rem = None if deadline is None \
                    else deadline - _time.monotonic()
                if rem is not None and rem <= 0:
                    raise GetTimeoutError(
                        f"stream item {i} not produced within {timeout_s}s")
                ready, _ = worker_mod.wait([spec, self._primary],
                                           num_returns=1, timeout=rem)
                if any(r is spec for r in ready):
                    yield spec
                    i += 1
                    break
                if ready:  # primary completed (or failed): finish the tail
                    self._materialize()  # raises the task's error if failed
                    break

    def __repr__(self):
        n = len(self._refs) if self._refs is not None else "?"
        return f"ObjectRefGenerator({self._primary!r}, n={n})"
