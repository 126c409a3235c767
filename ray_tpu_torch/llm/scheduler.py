"""Iteration-level (continuous) batching scheduler.

The port's own copy of ``ray_tpu/llm/scheduler.py`` (pure Python, no model
math): the same planning against the port's ``PagedKVCache``.

Reference: Orca's iteration-level scheduling (the idea vLLM's scheduler
implements): the unit of scheduling is ONE model step, not one request.
Between decode steps the scheduler admits waiting requests FCFS under a
per-step token budget, so new arrivals join the running batch at the next
iteration instead of waiting for the batch to drain; when the paged cache
runs out, the newest running request is preempted — its pages are freed and
it re-enters the waiting queue for recompute-on-resume (prefill over
prompt + tokens generated so far, which reproduces identical state).

Structuring prefill and decode as distinct stages that one step can mix
follows the MPMD-stage decomposition (arXiv 2412.14374); the scheduler is
deliberately free of model math so the engine can later pin the two stages
to different meshes.

Two serving fast paths layer on top of the same plan loop:

* **Chunked prefill** (``prefill_chunk_tokens > 0``): a long prompt is fed
  through prefill in chunks of at most that many tokens, one chunk per
  step, interleaved with running decodes — decodes are planned first so a
  10k-token prompt costs each in-flight stream one chunk of extra latency
  per token instead of one full prefill.  A mid-prefill request is RUNNING
  with ``num_computed < total_len - 1``; the plan's continuation pass
  advances it before any new admission.
* **Prefix caching** (cache built with ``enable_prefix_cache=True``): on
  admission the scheduler forks the request's page table from the longest
  trie match (``fork_from_prefix``) and starts prefill at the match point,
  so a shared system prompt is computed once, not per request.
"""

from __future__ import annotations

import bisect
import itertools
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ray_tpu_torch.llm.kv_cache import CacheExhausted, PagedKVCache

# request lifecycle
WAITING = "WAITING"
RUNNING = "RUNNING"
FINISHED = "FINISHED"
FAILED = "FAILED"
ABORTED = "ABORTED"

_arrival_counter = itertools.count()


@dataclass(frozen=True)
class SamplingParams:
    max_tokens: int = 16
    temperature: float = 0.0   # 0 -> greedy
    top_k: int = 0             # 0 -> full vocab
    seed: int = 0
    stop: Tuple[int, ...] = ()
    adapter: str = ""          # multiplexed adapter id ("" = base model)

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")


class Request:
    """One generation request; ``rid`` doubles as the cache seq id."""

    def __init__(self, rid: str, prompt: Sequence[int],
                 params: SamplingParams):
        self.rid = rid
        self.prompt = list(prompt)
        self.params = params
        self.outputs: List[int] = []
        # tokens already resident in the KV cache; reset to 0 on preemption
        # (recompute-on-resume)
        self.num_computed = 0
        self.state = WAITING
        self.arrival = next(_arrival_counter)
        self.submitted_at = time.perf_counter()
        self.first_token_at: Optional[float] = None
        self.last_token_at: Optional[float] = None
        self.max_itl = 0.0  # widest inter-token gap observed (bench reads)
        self.finish_reason: Optional[str] = None
        self.error: Optional[str] = None
        self.preemptions = 0
        # critical-path bookkeeping (TTFT decomposition): admission queue
        # wait stamped by the server at submit, prefill chunk execution
        # intervals stamped by the engine, preemption times stamped here
        self.admission_wait_s = 0.0
        self.prefill_intervals: List[Tuple[float, float]] = []
        self.preempt_ts: List[float] = []

    @property
    def all_tokens(self) -> List[int]:
        return self.prompt + self.outputs

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.outputs)

    def __repr__(self):
        return (f"Request({self.rid}, {self.state}, "
                f"prompt={len(self.prompt)}, out={len(self.outputs)})")


@dataclass
class StepPlan:
    """What one engine step executes.  ``prefills``: (request, tokens,
    start_position) chunks to run through the prefill path; ``decodes``:
    running requests advancing one token; ``preempted``: requests evicted
    this step (already moved back to waiting); ``failed``: requests the
    scheduler could never place."""

    prefills: List[Tuple[Request, List[int], int]] = field(
        default_factory=list)
    decodes: List[Request] = field(default_factory=list)
    preempted: List[Request] = field(default_factory=list)
    failed: List[Request] = field(default_factory=list)

    def __bool__(self):
        return bool(self.prefills or self.decodes or self.preempted
                    or self.failed)


class Scheduler:
    def __init__(self, cache: PagedKVCache, *,
                 max_batch_tokens: int = 128, max_running: int = 64,
                 prefill_chunk_tokens: int = 0):
        if max_batch_tokens < 1:
            raise ValueError("max_batch_tokens must be >= 1")
        if prefill_chunk_tokens < 0:
            raise ValueError("prefill_chunk_tokens must be >= 0")
        self.cache = cache
        self.max_batch_tokens = max_batch_tokens
        self.max_running = max_running
        # 0 disables chunking: a prompt prefills whole, and strict FCFS
        # blocks admission while the head doesn't fit the step budget
        self.prefill_chunk_tokens = prefill_chunk_tokens
        self.waiting: List[Request] = []   # kept sorted by arrival (FCFS)
        self.running: List[Request] = []   # kept in arrival order
        self.preemptions = 0
        self.prefilled_tokens = 0   # prompt tokens actually sent to prefill
        self.prefix_hit_tokens = 0  # tokens adopted from the prefix cache

    # ------------------------------------------------------------ intake
    def add(self, req: Request) -> None:
        bisect.insort(self.waiting, req, key=lambda r: r.arrival)

    def remove(self, req: Request) -> None:
        """Drop a request from whichever queue holds it; frees its pages."""
        if req in self.waiting:
            self.waiting.remove(req)
        if req in self.running:
            self.running.remove(req)
        self.cache.free(req.rid)

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -------------------------------------------------------------- plan
    def plan(self) -> StepPlan:
        """Build one iteration: decode every running sequence (preempting
        newest-first on page exhaustion), continue any in-flight chunked
        prefills, then admit waiting requests FCFS into the leftover token
        budget (adopting cached prefix pages first when prefix caching is
        on)."""
        out = StepPlan()
        budget = self.max_batch_tokens

        # 1. decode pass — arrival order so older requests keep priority;
        # scheduled first so a long prefill never stalls in-flight ITL
        for req in list(self.running):
            if req.state is not RUNNING \
                    or req.total_len - req.num_computed != 1:
                continue  # preempted earlier this loop, or mid-prefill
            if budget <= 0:
                break
            # a decode step writes K/V at position total_len-1, growing the
            # committed cache length to total_len
            if self._reserve_with_preemption(req, req.total_len, out):
                out.decodes.append(req)
                budget -= 1

        # 2. prefill continuations — RUNNING requests mid chunked prefill
        for req in list(self.running):
            if req.state is not RUNNING:
                continue
            remaining = req.total_len - req.num_computed
            if remaining <= 1:
                continue  # decoding (handled above)
            if budget <= 0:
                break
            chunk = self._chunk_len(remaining, budget)
            end = req.num_computed + chunk
            if self._reserve_with_preemption(req, end, out):
                out.prefills.append(
                    (req, req.all_tokens[req.num_computed:end],
                     req.num_computed))
                self.prefilled_tokens += chunk
                budget -= chunk

        # 3. FCFS admission between decode steps
        while self.waiting and budget > 0 \
                and len(self.running) < self.max_running:
            req = self.waiting[0]
            remaining = req.total_len - req.num_computed
            if self.prefill_chunk_tokens <= 0 and remaining > budget:
                # head-of-line stays (strict FCFS): a later shorter request
                # must not starve it; with chunking on, the head admits a
                # chunk instead of blocking
                break
            need_total = self.cache.pages_for(req.total_len + 1)
            if need_total > self.cache.num_pages:
                self._fail(req, out,
                           f"request needs {need_total} pages; cache has "
                           f"{self.cache.num_pages}")
                continue
            adopted = 0
            if self.cache.config.enable_prefix_cache \
                    and not self.cache.has_seq(req.rid):
                adopted = self.cache.fork_from_prefix(
                    req.rid, req.all_tokens)
                if adopted:
                    req.num_computed = adopted
                    remaining = req.total_len - adopted
            chunk = self._chunk_len(remaining, budget)
            end = req.num_computed + chunk
            try:
                self.cache.reserve(req.rid, end)
            except CacheExhausted:
                if adopted:
                    # don't hold adopted pages while parked in waiting;
                    # the trie keeps them cached for the retry
                    self.cache.free(req.rid)
                    req.num_computed = 0
                if self.cache.used_pages == 0 and not self.running:
                    # whole cache is free and it still doesn't fit — it
                    # never will
                    self._fail(req, out, "request does not fit in an "
                               "empty KV cache")
                    continue
                break
            self.waiting.pop(0)
            req.state = RUNNING
            self.running.append(req)
            out.prefills.append(
                (req, req.all_tokens[req.num_computed:end],
                 req.num_computed))
            self.prefilled_tokens += chunk
            self.prefix_hit_tokens += adopted
            budget -= chunk
        return out

    def _chunk_len(self, remaining: int, budget: int) -> int:
        chunk = min(remaining, budget)
        if self.prefill_chunk_tokens > 0:
            chunk = min(chunk, self.prefill_chunk_tokens)
        return chunk

    def _fail(self, req: Request, out: StepPlan, reason: str) -> None:
        self.waiting.remove(req)
        self.cache.free(req.rid)
        req.state = FAILED
        req.error = reason
        req.finish_reason = "error"
        out.failed.append(req)

    def _reserve_with_preemption(self, req: Request, new_len: int,
                                 out: StepPlan) -> bool:
        """Reserve pages for ``req`` up to ``new_len``, preempting the
        newest-arrival running request (possibly ``req`` itself, last) until
        the reservation fits.  Returns False when ``req`` was the victim."""
        while True:
            try:
                self.cache.reserve(req.rid, new_len)
                return True
            except CacheExhausted:
                victims = [r for r in self.running
                           if r.state is RUNNING and r is not req]
                victim = max(victims, key=lambda r: r.arrival) \
                    if victims else req
                self._preempt(victim, out)
                if victim is req:
                    return False

    def _preempt(self, req: Request, out: StepPlan) -> None:
        """Evict: free pages, requeue for recompute-on-resume.  The request
        keeps its generated tokens; on re-admission the prefill covers
        prompt + outputs so the resumed state is bit-identical.  Any work
        already planned for the victim this step is scrubbed — its pages
        are gone."""
        self.cache.free(req.rid)
        self.running.remove(req)
        req.num_computed = 0
        req.state = WAITING
        req.preemptions += 1
        req.preempt_ts.append(time.perf_counter())
        self.preemptions += 1
        self.add(req)
        out.preempted.append(req)
        out.decodes[:] = [r for r in out.decodes if r is not req]
        out.prefills[:] = [p for p in out.prefills if p[0] is not req]

    # --------------------------------------------------------- completion
    def finish(self, req: Request, reason: str) -> None:
        """Mark finished and release pages (called by the engine when
        max_tokens or a stop token lands)."""
        if req in self.running:
            self.running.remove(req)
        if req in self.waiting:
            self.waiting.remove(req)
        self.cache.free(req.rid)
        req.state = FINISHED
        req.finish_reason = reason
