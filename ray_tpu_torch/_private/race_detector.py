"""Port of ``ray_tpu/_private/race_detector.py``.

Actor-state race detector (opt-in sanitizer).

Counterpart of the reference's sanitizer story (SURVEY §5.2 — the reference
relies on TSAN/ASAN builds of its C++ core).  This framework's shared
mutable state lives in ACTORS, so the TPU-native equivalent is a dynamic
sanitizer for the actor model: with ``RAY_TPU_TORCH_RACE_DETECTOR=1`` (or
``RayConfig.race_detector``), every actor running with
``max_concurrency > 1`` gets its instance wrapped so that

- each executing method registers in an in-flight table, and
- every instance-attribute WRITE checks whether a *different* method
  invocation is concurrently executing on another thread.

An overlapping write is the shape of an unsynchronized actor-state race
(two threads mutating `self` without a lock); the detector records it
(attribute, both method names, thread ids) and logs a warning with the
writing stack.  Reads are not tracked.

LOCK-AWARE: when the wrapped instance carries ``threading.Lock``/``RLock``/
``Condition`` attributes, they are replaced with tracking proxies so the
detector knows which locks the WRITING thread holds.  A concurrent write
made under any of the instance's own locks is recorded with
``kind="guarded"`` (visible, but not warned about — the user's lock
discipline is working); a write with no lock held stays
``kind="possible_race"`` with a warning.  Locks the detector cannot see
(globals, other objects) still report conservatively.

Suppress known-synchronized attributes with :func:`suppress`
("ClassName.attr"), the ``RAY_TPU_TORCH_RACE_DETECTOR_ALLOW`` env var /
``RayConfig.race_detector_allow`` flag (comma-separated), or the shared
``_private/sync_suppressions.KNOWN_SYNCHRONIZED`` list — the same list the
static lock-discipline lint rule reads, so one stated justification covers
both analyses.

Reports are queryable in-process via :func:`get_reports` and surface in
the actor's worker log.
"""

from __future__ import annotations

import logging
import os
import threading
import traceback
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_inflight: Dict[int, Dict[int, str]] = {}   # id(instance) -> {thread_id: method}
_reports: List[Dict[str, Any]] = []
_MAX_REPORTS = 256

# per-thread stack of _TrackedLock proxies currently held (reentrant
# acquires push twice, matching their paired releases)
_held = threading.local()


def enabled() -> bool:
    from ray_tpu_torch._private.config import RayConfig

    # env re-read per actor creation (runtime_env-injected vars must apply
    # live); the registered flag carries the default for config dumps
    env = os.environ.get("RAY_TPU_TORCH_RACE_DETECTOR")
    if env is not None:
        return env.strip().lower() not in ("", "0", "false", "no", "off")
    return bool(RayConfig.race_detector)


_suppressed: set = set()


def suppress(class_attr: str) -> None:
    """Mark ``"ClassName.attr"`` as known-synchronized (user holds a lock)."""
    with _lock:
        _suppressed.add(class_attr)


def _suppressed_set() -> set:
    from ray_tpu_torch._private.config import RayConfig
    from ray_tpu_torch._private.sync_suppressions import KNOWN_SYNCHRONIZED

    env = os.environ.get("RAY_TPU_TORCH_RACE_DETECTOR_ALLOW")
    if env is None:
        env = RayConfig.race_detector_allow
    out = {s.strip() for s in env.split(",") if s.strip()}
    out |= KNOWN_SYNCHRONIZED
    with _lock:
        return out | _suppressed


# ------------------------------------------------------- lock tracking

class _TrackedLock:
    """Transparent proxy over a lock-ish object (Lock/RLock/Condition)
    registering per-thread ownership, so a guarded write can be told apart
    from a naked one."""

    __slots__ = ("_inner",)

    def __init__(self, inner):
        object.__setattr__(self, "_inner", inner)

    def _push(self):
        stack = getattr(_held, "stack", None)
        if stack is None:
            stack = _held.stack = []
        stack.append(id(self))

    def _pop(self):
        stack = getattr(_held, "stack", None)
        if stack:
            try:
                stack.remove(id(self))
            except ValueError:
                pass

    def acquire(self, *args, **kwargs):
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._push()
        return got

    def release(self, *args, **kwargs):
        self._inner.release(*args, **kwargs)
        self._pop()

    def __enter__(self):
        out = self._inner.__enter__()
        self._push()
        return out

    def __exit__(self, *exc):
        self._pop()
        return self._inner.__exit__(*exc)

    def __getattr__(self, name):
        # wait()/notify()/locked()/_is_owned() etc. forward to the real lock
        return getattr(object.__getattribute__(self, "_inner"), name)


def _thread_holds_lock() -> bool:
    return bool(getattr(_held, "stack", None))


def _lock_types() -> tuple:
    return (type(threading.Lock()), type(threading.RLock()),
            threading.Condition)


def _proxy_instance_locks(instance: Any) -> None:
    """Swap the instance's lock attributes for tracking proxies (direct
    ``__dict__`` surgery: runs before/independently of the __setattr__
    override)."""
    d = getattr(instance, "__dict__", None)
    if not isinstance(d, dict):
        return
    types = _lock_types()
    for key, val in list(d.items()):
        if isinstance(val, types):
            d[key] = _TrackedLock(val)


def get_reports(kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """All reports, or only one ``kind`` ("possible_race" / "guarded")."""
    with _lock:
        if kind is None:
            return list(_reports)
        return [r for r in _reports if r.get("kind") == kind]


def clear_reports() -> None:
    with _lock:
        _reports.clear()


class _MethodGuard:
    """Context manager registering one executing method invocation."""

    def __init__(self, instance: Any, method_name: str):
        self._key = id(instance)
        self._method = method_name

    def __enter__(self):
        with _lock:
            _inflight.setdefault(self._key, {})[
                threading.get_ident()] = self._method
        return self

    def __exit__(self, *exc):
        with _lock:
            tbl = _inflight.get(self._key)
            if tbl is not None:
                tbl.pop(threading.get_ident(), None)
                if not tbl:
                    _inflight.pop(self._key, None)
        return False


def _record(instance, attr: str, writer_method: str, others: Dict[int, str]):
    cls_name = type(instance).__name__.replace("(race-checked)", "")
    if f"{cls_name}.{attr}" in _suppressed_set():
        return
    guarded = _thread_holds_lock()
    report = {
        "class": cls_name,
        "attribute": attr,
        "kind": "guarded" if guarded else "possible_race",
        "writer": writer_method,
        "writer_thread": threading.get_ident(),
        "concurrent": dict(others),
        "stack": "".join(traceback.format_stack(limit=8)),
    }
    with _lock:
        if len(_reports) < _MAX_REPORTS:
            _reports.append(report)
    if guarded:
        # the writer held one of the instance's own locks: the user's
        # discipline is working — record for inspection, don't cry wolf
        logger.debug("guarded concurrent write: %s.%s by %r",
                     report["class"], attr, writer_method)
        return
    logger.warning(
        "POSSIBLE RACE: actor %s attribute %r written by %r while %s "
        "executed concurrently on other threads.  If this write is guarded "
        "by your own lock, suppress it: race_detector.suppress(%r) or "
        "RAY_TPU_TORCH_RACE_DETECTOR_ALLOW=%s",
        report["class"], attr, writer_method,
        sorted(set(others.values())),
        f"{cls_name}.{attr}", f"{cls_name}.{attr}")


def wrap_instance(instance: Any) -> Any:
    """Return an instance whose attribute writes are race-checked: a dynamic
    subclass overriding ``__setattr__`` (the original class is untouched —
    other instances stay unwrapped).  The instance's own lock attributes
    become tracking proxies so guarded writes downgrade (see module doc)."""
    cls = type(instance)
    _proxy_instance_locks(instance)

    def __setattr__(self, name, value):  # noqa: N807
        me = threading.get_ident()
        with _lock:
            tbl = dict(_inflight.get(id(self), {}))
        my_method = tbl.pop(me, None)
        if tbl:  # other method invocations are in flight on other threads
            _record(self, name, my_method or "<constructor>", tbl)
        cls.__setattr__(self, name, value)  # original class's semantics

    try:
        sanitized = type(f"{cls.__name__}(race-checked)", (cls,),
                         {"__setattr__": __setattr__})
        instance.__class__ = sanitized
    except TypeError:
        # classes with __slots__/exotic layouts can't be re-classed;
        # sanitize is best-effort by design
        logger.info("race detector cannot wrap %s (incompatible layout)",
                    cls.__name__)
    return instance
