"""Port of ``ray_tpu/util/queue.py``.

Distributed Queue backed by an async actor.

Reference: python/ray/util/queue.py (Queue, Empty, Full — same surface:
put/get with block/timeout, put_nowait/get_nowait, qsize/empty/full,
put_nowait_batch/get_nowait_batch, shutdown).
"""

from __future__ import annotations

import asyncio
from typing import Any, List, Optional

import ray_tpu_torch

try:  # match the reference: reuse the stdlib exception types
    from queue import Empty, Full
except ImportError:  # pragma: no cover
    class Empty(Exception):
        pass

    class Full(Exception):
        pass


@ray_tpu_torch.remote(num_cpus=0)
class _QueueActor:
    def __init__(self, maxsize: int):
        self._q = asyncio.Queue(maxsize=maxsize)

    async def put(self, item, timeout: Optional[float] = None) -> bool:
        try:
            await asyncio.wait_for(self._q.put(item), timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def get(self, timeout: Optional[float] = None):
        try:
            return True, await asyncio.wait_for(self._q.get(), timeout)
        except asyncio.TimeoutError:
            return False, None

    def put_nowait(self, item) -> bool:
        try:
            self._q.put_nowait(item)
            return True
        except asyncio.QueueFull:
            return False

    def get_nowait(self):
        try:
            return True, self._q.get_nowait()
        except asyncio.QueueEmpty:
            return False, None

    def put_nowait_batch(self, items: List[Any]) -> int:
        n = 0
        for it in items:
            try:
                self._q.put_nowait(it)
                n += 1
            except asyncio.QueueFull:
                break
        return n

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        out = []
        for _ in range(num_items):
            try:
                out.append(self._q.get_nowait())
            except asyncio.QueueEmpty:
                break
        return out

    def qsize(self) -> int:
        return self._q.qsize()

    def empty(self) -> bool:
        return self._q.empty()

    def full(self) -> bool:
        return self._q.full()


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        self.maxsize = maxsize
        self.actor = _QueueActor.options(**(actor_options or {})).remote(maxsize)

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None) -> None:
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full
            return
        ok = ray_tpu_torch.get(self.actor.put.remote(item, timeout))
        if not ok:
            raise Full

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        if not block:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty
            return item
        ok, item = ray_tpu_torch.get(self.actor.get.remote(timeout))
        if not ok:
            raise Empty
        return item

    def put_nowait(self, item) -> None:
        self.put(item, block=False)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        n = ray_tpu_torch.get(self.actor.put_nowait_batch.remote(list(items)))
        if n != len(items):
            raise Full(f"only {n}/{len(items)} items fit")

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        return ray_tpu_torch.get(self.actor.get_nowait_batch.remote(num_items))

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def shutdown(self) -> None:
        if self.actor is not None:
            ray_tpu_torch.kill(self.actor)
            self.actor = None
