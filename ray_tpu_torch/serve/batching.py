"""Port of ``ray_tpu/serve/batching.py``.

@serve.batch: transparent request batching inside a replica.

Reference: python/ray/serve/batching.py — calls queue up; when
max_batch_size accumulate or batch_wait_timeout_s elapses, the wrapped
function runs ONCE on the list of requests and each caller gets its element.

TPU note: this is the mechanism that turns single-request traffic into
MXU-shaped batches — a jitted model with a fixed batch dimension runs at a
fraction of peak on batch=1; the batcher amortizes compile shapes by padding
to max_batch_size where the user function chooses to.
"""

from __future__ import annotations

import asyncio
import functools
from typing import Any, Callable, List, Optional


class _Batcher:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self._fn = fn
        self._max = max_batch_size
        self._wait = batch_wait_timeout_s
        self._queue: List = []           # (arg, future)
        self._flush_task: Optional[asyncio.Task] = None

    async def submit(self, instance, arg) -> Any:
        loop = asyncio.get_event_loop()
        fut = loop.create_future()
        self._queue.append((arg, fut))
        if len(self._queue) >= self._max:
            self._flush(instance)
        elif self._flush_task is None:
            self._flush_task = loop.create_task(self._timer(instance))
        return await fut

    async def _timer(self, instance):
        await asyncio.sleep(self._wait)
        self._flush(instance)

    def _flush(self, instance):
        if self._flush_task is not None:
            self._flush_task.cancel()
            self._flush_task = None
        batch, self._queue = self._queue, []
        if not batch:
            return
        args = [a for a, _ in batch]
        futs = [f for _, f in batch]
        asyncio.get_event_loop().create_task(
            self._run(instance, args, futs))

    async def _run(self, instance, args, futs):
        try:
            out = self._fn(instance, args) if instance is not None \
                else self._fn(args)
            if asyncio.iscoroutine(out):
                out = await out
            if len(out) != len(args):
                raise ValueError(
                    f"@serve.batch function returned {len(out)} results "
                    f"for {len(args)} requests")
            for f, o in zip(futs, out):
                _safe_resolve(f, result=o)
        except BaseException as e:
            for f in futs:
                _safe_resolve(f, exception=e)


def _safe_resolve(fut: asyncio.Future, result=None, exception=None) -> None:
    """Resolve one co-batched caller's future without letting a cancelled
    (or otherwise already-settled) future poison its batch-mates: an
    unguarded ``set_result`` raising InvalidStateError inside ``_run``'s
    result loop would divert every remaining future to the exception path,
    failing requests whose results are already in hand."""
    if fut.done():
        return
    try:
        if exception is not None:
            fut.set_exception(exception)
        else:
            fut.set_result(result)
    except asyncio.InvalidStateError:
        pass  # cancelled between the check and the set


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator for a replica method taking a LIST of requests."""

    def deco(fn):
        batcher_attr = f"__serve_batcher_{fn.__name__}"

        @functools.wraps(fn)
        async def wrapper(self, arg):
            b = getattr(self, batcher_attr, None)
            if b is None:
                b = _Batcher(fn, max_batch_size, batch_wait_timeout_s)
                setattr(self, batcher_attr, b)
            return await b.submit(self, arg)

        wrapper._is_serve_batch = True
        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
