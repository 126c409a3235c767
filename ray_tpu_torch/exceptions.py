"""Port of ``ray_tpu/exceptions.py``.

Public exception hierarchy.

Counterpart of the reference's python/ray/exceptions.py (RayError, RayTaskError,
RayActorError, GetTimeoutError, ObjectLostError, ...) backed by C++ status codes
(reference: src/ray/common/status.h).  Task-side exceptions are captured with a
formatted remote traceback and re-raised owner-side wrapped in ``RayTaskError`` so
the cause chain survives process boundaries.
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayError(Exception):
    """Base class for all framework errors."""


class RaySystemError(RayError):
    """The runtime itself failed (control-plane crash, protocol error)."""


class RayTaskError(RayError):
    """A task raised an exception remotely.

    Carries the remote traceback string; ``as_instanceof_cause`` returns an
    exception that is also an instance of the user's exception type so
    ``except UserError`` works across process boundaries (mirrors reference
    python/ray/exceptions.py RayTaskError.as_instanceof_cause).
    """

    def __init__(
        self,
        function_name: str = "",
        traceback_str: str = "",
        cause: Optional[BaseException] = None,
    ):
        super().__init__(function_name, traceback_str)
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause

    @classmethod
    def from_exception(cls, function_name: str, exc: BaseException) -> "RayTaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        return cls(function_name, tb, exc)

    def as_instanceof_cause(self) -> "RayTaskError":
        cause = self.cause
        if cause is None or isinstance(cause, RayTaskError):
            return self
        cause_cls = type(cause)
        if cause_cls is AssertionError or issubclass(cause_cls, (SystemExit, KeyboardInterrupt)):
            return self

        name = f"RayTaskError({cause_cls.__name__})"
        try:
            class _cls(RayTaskError, cause_cls):  # type: ignore[misc, valid-type]
                def __init__(self, function_name, traceback_str, cause):
                    RayTaskError.__init__(self, function_name, traceback_str, cause)

                def __str__(self):
                    return RayTaskError.__str__(self)

                def __reduce__(self):
                    return (
                        _make_task_error,
                        (cause_cls, self.function_name, self.traceback_str, self.cause),
                    )

            _cls.__name__ = name
            _cls.__qualname__ = name
            return _cls(self.function_name, self.traceback_str, cause)
        except TypeError:
            return self

    def __str__(self):
        return (
            f"{type(self).__name__}: task {self.function_name} failed.\n"
            f"Remote traceback:\n{self.traceback_str}"
        )


def _make_task_error(cause_cls, function_name, traceback_str, cause):
    err = RayTaskError(function_name, traceback_str, cause)
    return err.as_instanceof_cause()


class TaskCancelledError(RayError):
    pass


class RayActorError(RayError):
    """The actor died before or during this call."""

    def __init__(self, actor_id=None, error_msg: str = ""):
        super().__init__(error_msg or f"The actor died unexpectedly: {actor_id}")
        self.actor_id = actor_id


class ActorDiedError(RayActorError):
    pass


class ActorUnavailableError(RayActorError):
    """The actor is temporarily unreachable (restarting or network partition)."""


class GetTimeoutError(RayError, TimeoutError):
    pass


class ObjectStoreFullError(RayError):
    pass


class OutOfMemoryError(RayError):
    pass


class ObjectLostError(RayError):
    def __init__(self, object_id=None, msg: str = ""):
        super().__init__(msg or f"Object {object_id} was lost and could not be recovered.")
        self.object_id = object_id


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    def __init__(self, object_id=None):
        super().__init__(object_id, f"The owner of object {object_id} died; the value is unrecoverable.")


class RuntimeEnvSetupError(RayError):
    pass


class NodeDiedError(RayError):
    pass


class PlacementGroupSchedulingError(RayError):
    pass


class WorkerCrashedError(RayError):
    pass


class RequestShed(RayError):
    """A serve request was rejected by admission control (queue full, queue
    deadline exceeded, or projected time-to-first-token past the deadline).
    Carries the shed ``reason`` and a ``retry_after_s`` hint the HTTP proxy
    turns into ``429`` + ``Retry-After`` (or a terminal SSE error event)."""

    def __init__(self, reason: str = "overload", retry_after_s: float = 1.0,
                 message: str = ""):
        # tolerate junk args: ``as_instanceof_cause`` hybrids re-enter this
        # __init__ through the MRO with (function_name, traceback_str) —
        # the real reason/retry hint live on the pristine ``cause``
        try:
            retry_after_s = float(retry_after_s)
        except (TypeError, ValueError):
            retry_after_s = 1.0
        super().__init__(
            message or f"request shed by admission control ({reason}); "
                       f"retry after {retry_after_s:.1f}s")
        self.reason = reason
        self.retry_after_s = retry_after_s

    def __reduce__(self):
        return (type(self), (self.reason, self.retry_after_s, str(self)))


class CollectiveError(RayError):
    """A collective operation failed (peer death, timeout, shape mismatch)."""


class CollectiveTimeout(CollectiveError):
    """A collective op timed out waiting for peers.  Carries the group, the
    op, and the rank(s) whose per-rank progress (stamped through the KV
    rendezvous) lags the timed-out caller — the straggler diagnosis a bare
    hang can never give."""

    def __init__(self, message: str, group: str = "", op: str = "",
                 lagging_ranks=()):
        super().__init__(message)
        self.group = group
        self.op = op
        self.lagging_ranks = tuple(lagging_ranks)


class CollectiveWorkerDied(CollectiveError):
    """A group member's process died mid-collective.  Distinguished from a
    straggler by a liveness probe (stale progress stamp + refused socket),
    so the caller learns the dead rank in seconds instead of burning the
    full op timeout.  Recover with ``Group.rebuild()`` (shrink over the
    survivors, or replace after restarting the rank)."""

    def __init__(self, message: str, group: str = "", op: str = "",
                 rank: int = -1):
        super().__init__(message)
        self.group = group
        self.op = op
        self.rank = rank


class PipelineStageDied(CollectiveError):
    """A pipeline-parallel stage's gang died mid-schedule.  The blocked
    neighbour's channel wait detects it via the stage liveness probe (stale
    endpoint stamp + dead pid / refused socket) the same way
    ``CollectiveWorkerDied`` does for collective ranks — the caller learns
    WHICH stage is gone in seconds instead of burning the full op timeout.
    Recover by restarting the job from the last per-stage checkpoint
    (``FailureConfig(max_failures=...)`` on the trainer) or fail cleanly."""

    def __init__(self, message: str, stage: int = -1, op: str = "",
                 rank: int = -1):
        super().__init__(message)
        self.stage = stage
        self.op = op
        self.rank = rank
