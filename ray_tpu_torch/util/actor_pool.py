"""Port of ``ray_tpu/util/actor_pool.py``.

ActorPool: fan work out over a fixed set of actors.

Reference: python/ray/util/actor_pool.py (same public surface: submit /
get_next / get_next_unordered / map / map_unordered / has_next /
push / pop_idle).
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle: List[Any] = list(actors)
        if not self._idle:
            raise ValueError("ActorPool needs at least one actor")
        self._future_to_actor = {}
        self._index_to_future = {}
        self._next_task_index = 0
        self._next_return_index = 0

    # ---------------------------------------------------------------- submit
    def submit(self, fn: Callable[[Any, Any], Any], value: Any) -> None:
        """fn(actor, value) -> ObjectRef; runs on the next idle actor."""
        if not self._idle:
            raise ValueError("no idle actors (call get_next first)")
        actor = self._idle.pop()
        ref = fn(actor, value)
        self._future_to_actor[ref] = actor
        self._index_to_future[self._next_task_index] = ref
        self._next_task_index += 1

    def has_next(self) -> bool:
        return bool(self._index_to_future)

    def has_free(self) -> bool:
        return bool(self._idle)

    def get_next(self, timeout: float = None) -> Any:
        """Next result in SUBMISSION order.  On timeout the pool state is
        untouched (the result stays claimable and the actor stays busy), so
        callers may simply retry — reference semantics."""
        from ray_tpu_torch.exceptions import GetTimeoutError

        if not self.has_next():
            raise StopIteration("no pending results")
        idx = self._next_return_index
        ref = self._index_to_future[idx]
        try:
            value = ray_tpu_torch.get(ref, timeout=timeout)
        except GetTimeoutError:
            raise  # state untouched: result stays claimable, actor stays busy
        except BaseException:
            # task FAILED: it is finished, so release the slot and the actor
            del self._index_to_future[idx]
            self._next_return_index += 1
            self._idle.append(self._future_to_actor.pop(ref))
            raise
        del self._index_to_future[idx]
        self._next_return_index += 1
        self._idle.append(self._future_to_actor.pop(ref))
        return value

    def get_next_unordered(self, timeout: float = None) -> Any:
        """Next result in COMPLETION order."""
        if not self.has_next():
            raise StopIteration("no pending results")
        ready, _ = ray_tpu_torch.wait(list(self._future_to_actor), num_returns=1,
                                timeout=timeout)
        if not ready:
            raise TimeoutError("no result within timeout")
        ref = ready[0]
        for idx, f in list(self._index_to_future.items()):
            if f == ref:
                del self._index_to_future[idx]
                break
        try:
            return ray_tpu_torch.get(ref)
        finally:
            self._idle.append(self._future_to_actor.pop(ref))

    # ------------------------------------------------------------------ map
    def map(self, fn: Callable[[Any, Any], Any], values: Iterable[Any]):
        for v in values:
            if not self._idle:
                yield self.get_next()
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, Any], Any],
                      values: Iterable[Any]):
        for v in values:
            if not self._idle:
                yield self.get_next_unordered()
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    # ------------------------------------------------------------ membership
    def push(self, actor: Any) -> None:
        self._idle.append(actor)

    def pop_idle(self) -> Any:
        if not self._idle:
            raise ValueError("no idle actor to pop")
        return self._idle.pop()
