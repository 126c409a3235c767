"""Port of ``ray_tpu/serve/_streaming.py``.

Serve response streaming: replica-held generators, client-side pulls.

Reference: Ray Serve's streaming responses (generator deployments +
StreamingResponse over the replica's generator protocol), condensed to this
runtime's primitives: when a deployment callable returns a (sync or async)
generator, the replica drains it into a per-stream buffer and returns a
small picklable ``StreamHeader``; the caller's DeploymentResponse unwraps
that into a ``ResponseStream`` that long-polls ``replica.stream_next`` for
incremental chunks.  The HTTP proxy turns a ResponseStream into a chunked
SSE response, so engine token streams reach HTTP clients token by token
instead of buffering to completion.

Flow control: the replica parks the producing generator once
``MAX_BUFFERED_ITEMS`` results sit unconsumed, so a slow client bounds the
replica-side buffer instead of growing it without limit.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

# replica-side cap on produced-but-unconsumed items per stream
MAX_BUFFERED_ITEMS = 4096
# done streams that were never fully drained are dropped after this long
STREAM_TTL_S = 600.0


class StreamHeader:
    """Picklable marker a replica returns in place of a generator result."""

    __slots__ = ("stream_id",)

    def __init__(self, stream_id: str):
        self.stream_id = stream_id

    def __reduce__(self):
        return (StreamHeader, (self.stream_id,))

    def __repr__(self):
        return f"StreamHeader({self.stream_id})"


class ResponseStream:
    """Client-side iterator over a replica-held stream.  Synchronous
    (blocking pulls) — consume from a thread or iterate directly; every
    pull fetches ALL items produced since the last one, so a fast producer
    costs O(items/batch) round trips, not O(items)."""

    def __init__(self, replica, stream_id: str):
        self._replica = replica
        self.stream_id = stream_id
        self._cursor = 0
        self._done = False

    def next_batch(self, timeout_s: float = 30.0
                   ) -> Tuple[List[Any], bool]:
        """(items_since_last_call, stream_done).  Empty list + False means
        the poll timed out with the stream still open."""
        import ray_tpu_torch

        if self._done:
            return [], True
        ref = self._replica.stream_next.remote(
            self.stream_id, self._cursor, timeout_s)
        out = ray_tpu_torch.get(ref, timeout=timeout_s + 30.0)
        items = out["items"]
        self._cursor += len(items)
        self._done = out["done"]
        if out.get("error") and self._done:
            raise RuntimeError(f"stream failed mid-generation: "
                               f"{out['error']}")
        return items, self._done

    def __iter__(self):
        while True:
            items, done = self.next_batch()
            for item in items:
                yield item
            if done:
                return

    def cancel(self) -> None:
        """Drop the replica-side stream (stops the producing generator at
        its next yield)."""
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(self._replica.stream_cancel.remote(self.stream_id),
                        timeout=10)
        except Exception:
            pass
        self._done = True


class _StreamState:
    """Replica-side buffer for one in-flight stream (IO-loop confined)."""

    __slots__ = ("items", "done", "error", "created", "waiters", "producer",
                 "consumed", "producer_ev")

    def __init__(self):
        self.items: List[Any] = []
        self.done = False
        self.error: Optional[str] = None
        self.created = time.monotonic()
        self.waiters: List[Any] = []  # asyncio.Event per parked consumer
        self.producer = None          # asyncio.Task draining the generator
        self.consumed = 0             # highest cursor a consumer has read to
        self.producer_ev = None       # producer's backpressure event

    def wake(self) -> None:
        for ev in self.waiters:
            ev.set()
        self.waiters.clear()
