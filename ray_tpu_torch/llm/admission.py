"""Port of ``ray_tpu/llm/admission.py``.

Admission control / load shedding for the LLM serving path.

Reference shape: Orca/vLLM deployments put a bounded queue in front of the
engine and shed instead of queueing unboundedly once the fleet saturates —
a request that would wait past its deadline is cheaper to reject at the
door (HTTP 429 + ``Retry-After``) than to admit and time out mid-stream.

``AdmissionController`` is a single-event-loop asyncio object (the serve
replica runs user code on one IO loop, so no locks are needed):

* **Bounded queue**: at most ``max_queue`` requests park behind the
  ``max_inflight`` currently-admitted ones; overflow sheds ``queue_full``.
* **Weighted-fair dequeue** (stride scheduling): each tenant advances a
  pass value by ``1/weight`` per dispatch and the backlogged tenant with
  the smallest pass dequeues next, so a flooding tenant cannot starve a
  light one — with equal weights, dispatch alternates.
* **Queue-wait deadline**: a parked request sheds ``deadline`` once it has
  waited ``queue_deadline_s``.
* **Projected-TTFT shed**: when the measured drain rate says a new arrival
  would wait past the deadline anyway, it sheds ``saturated`` immediately
  instead of parking doomed work.

Shed requests raise :class:`ray_tpu_torch.exceptions.RequestShed`, which the
serve proxy maps to 429/SSE-error (never a hang).
"""

from __future__ import annotations

import asyncio
import time
from collections import deque
from typing import Dict, Optional

from ray_tpu_torch.exceptions import RequestShed

DEFAULT_TENANT = "default"


class _Tenant:
    __slots__ = ("name", "weight", "queue", "pass_")

    def __init__(self, name: str, weight: float):
        self.name = name
        self.weight = max(weight, 1e-6)
        # (future, enqueued_at) in arrival order; the future resolves to
        # the queue wait in seconds when the request is dispatched
        self.queue: deque = deque()
        self.pass_ = 0.0


class AdmissionController:
    """Not thread-safe: confine to one asyncio event loop."""

    def __init__(self, *, max_inflight: int = 256, max_queue: int = 512,
                 queue_deadline_s: float = 30.0,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 default_weight: float = 1.0,
                 clock=time.monotonic):
        if max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if max_queue < 0:
            raise ValueError("max_queue must be >= 0")
        self.max_inflight = max_inflight
        self.max_queue = max_queue
        self.queue_deadline_s = queue_deadline_s
        self._weights = dict(tenant_weights or {})
        self._default_weight = default_weight
        self._clock = clock
        self._tenants: Dict[str, _Tenant] = {}
        self._inflight = 0
        self._queued = 0
        self._vtime = 0.0  # pass of the most recent dispatch
        # drain-rate EWMA (releases/s) feeds the projected-wait shed
        self._drain_rate = 0.0
        self._last_release: Optional[float] = None
        self.admitted = 0
        self.shed: Dict[str, int] = {}

    # ---------------------------------------------------------- accounting
    @property
    def inflight(self) -> int:
        return self._inflight

    @property
    def queued(self) -> int:
        return self._queued

    def projected_wait_s(self) -> float:
        """Expected queue wait for a new arrival at the current drain rate
        (0 when there is a free slot or no rate signal yet)."""
        if self._queued == 0 and self._inflight < self.max_inflight:
            return 0.0
        if self._drain_rate <= 0:
            return 0.0
        return (self._queued + 1) / self._drain_rate

    def stats(self) -> Dict[str, object]:
        return {
            "inflight": self._inflight,
            "queued": self._queued,
            "admitted": self.admitted,
            "shed": dict(self.shed),
            "projected_wait_s": self.projected_wait_s(),
            "drain_rate": self._drain_rate,
        }

    # ------------------------------------------------------------- intake
    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            t = _Tenant(name, self._weights.get(name, self._default_weight))
            self._tenants[name] = t
        return t

    def _shed(self, reason: str, retry_after_s: float) -> RequestShed:
        self.shed[reason] = self.shed.get(reason, 0) + 1
        from ray_tpu_torch._private import flight_recorder

        if flight_recorder.RECORDING:
            flight_recorder.record("admission.shed", reason)
        return RequestShed(reason, max(retry_after_s, 0.1))

    async def admit(self, tenant: str = DEFAULT_TENANT) -> float:
        """Wait for an engine slot; returns the queue wait in seconds.
        Raises :class:`RequestShed` instead of waiting forever."""
        tenant = tenant or DEFAULT_TENANT
        if self._queued == 0 and self._inflight < self.max_inflight:
            self._inflight += 1
            self.admitted += 1
            return 0.0
        if self._queued >= self.max_queue:
            raise self._shed("queue_full", self.queue_deadline_s / 2)
        projected = self.projected_wait_s()
        if projected > self.queue_deadline_s:
            # admitting would only let it time out in the queue: shed now
            # with an honest hint of when capacity should exist
            raise self._shed("saturated",
                            min(projected - self.queue_deadline_s + 1.0,
                                30.0))
        t = self._tenant(tenant)
        if not t.queue:
            # re-activating tenant joins at the current virtual time: an
            # idle tenant must not bank credit and then monopolize
            t.pass_ = max(t.pass_, self._vtime)
        fut = asyncio.get_event_loop().create_future()
        enqueued = self._clock()
        t.queue.append((fut, enqueued))
        self._queued += 1
        try:
            return await asyncio.wait_for(fut, self.queue_deadline_s)
        except asyncio.TimeoutError:
            # wait_for cancelled the future; drop our entry if still parked
            try:
                t.queue.remove((fut, enqueued))
                self._queued -= 1
            except ValueError:
                pass
            raise self._shed("deadline", self.queue_deadline_s / 2) \
                from None

    def release(self) -> None:
        """One admitted request finished (stream drained, errored, or
        aborted); frees its slot and dispatches parked waiters."""
        if self._inflight > 0:
            self._inflight -= 1
        now = self._clock()
        if self._last_release is not None:
            dt = now - self._last_release
            if dt > 0:
                inst = 1.0 / dt
                self._drain_rate = inst if self._drain_rate <= 0 \
                    else 0.8 * self._drain_rate + 0.2 * inst
        self._last_release = now
        self._dispatch()

    # ----------------------------------------------------------- dispatch
    def _dispatch(self) -> None:
        while self._inflight < self.max_inflight and self._queued > 0:
            t = min((x for x in self._tenants.values() if x.queue),
                    key=lambda x: x.pass_, default=None)
            if t is None:
                # bookkeeping drift (cancelled waiters): recount
                self._queued = sum(len(x.queue)
                                   for x in self._tenants.values())
                if self._queued == 0:
                    return
                continue
            fut, enqueued = t.queue.popleft()
            self._queued -= 1
            if fut.done():
                continue  # timed out / cancelled while parked
            t.pass_ += 1.0 / t.weight
            self._vtime = t.pass_
            self._inflight += 1
            self.admitted += 1
            fut.set_result(self._clock() - enqueued)
