"""InferenceEngine: continuous-batching LLM engine over the paged KV cache.

Port of ``ray_tpu/llm/engine.py`` (``encode_text``, ``decode_tokens``,
``EngineCore``, ``InferenceEngine``).  `EngineCore` owns the model runner,
paged cache and iteration scheduler and is driven by `step()` — inline, or
from the actor's background thread — on the device given as ``device=``
(the CUDA card unless ``"cpu"`` is passed).  Its model math runs the port's
``GPT2Runner``, whose attention is the hand-written flash kernel.
`InferenceEngine` is the actor wrapper of the port's runtime: `submit()`
enqueues a request, `next_output()` long-polls incremental tokens (the serve
layer's token streams pull through it), `stream()` is a generator method
usable with ``num_returns='dynamic'``, and `generate()` blocks for the full
output.  Each request's TTFT decomposition is stamped on the task-event
stream as a critical-path annotation (``_emit_cpath``).

Thread model: one stepping thread mutates the cache/runner; submit/poll
methods touch only the scheduler queues and per-request output buffers
under ``_lock`` (condition-notified, so pollers wake per emitted token).
"""

from __future__ import annotations

import hashlib
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.llm._metrics import llm_metrics
from ray_tpu_torch.llm.kv_cache import CacheConfig, PagedKVCache
from ray_tpu_torch.llm.model_runner import GPT2Runner
from ray_tpu_torch.llm.scheduler import (
    ABORTED,
    FAILED,
    FINISHED,
    Request,
    SamplingParams,
    Scheduler,
)
from ray_tpu_torch.models.gpt2 import GPT2Config

# ------------------------------------------------------------- tokenizer
# Byte-level codec for text prompts (vocab >= 256): token i < 256 is byte i.
# Real deployments plug a trained tokenizer; the byte path keeps the HTTP
# surface usable with the tiny test vocab.

def encode_text(text: str, vocab_size: int) -> List[int]:
    toks = list(text.encode("utf-8"))
    bad = [t for t in toks if t >= vocab_size]
    if bad:
        raise ValueError(f"byte tokenizer needs vocab >= 256; got "
                         f"{vocab_size}")
    return toks


def decode_tokens(tokens: Sequence[int]) -> str:
    return bytes(t for t in tokens if 0 <= t < 256).decode(
        "utf-8", errors="replace")


def _default_config():
    return GPT2Config.tiny()


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


class EngineCore:
    """Scheduler + runner + cache + metrics, stepped by one thread."""

    def __init__(self, model_config=None, *, engine_name: str = "engine",
                 seed: int = 0, num_pages: int = 64, page_size: int = 16,
                 max_batch_tokens: int = 128, max_running: int = 64,
                 device=None, step_delay_s: float = 0.0,
                 prefill_chunk_tokens: int = 0,
                 enable_prefix_cache: bool = False,
                 runner: Optional[GPT2Runner] = None):
        self.name = engine_name
        self.config = model_config if model_config is not None \
            else _default_config()
        self.device = resolve_device(device)
        if runner is not None:
            self.runner = runner
        else:
            self.runner = GPT2Runner.init_random(self.config, seed,
                                                 device=self.device)
        self.cache = PagedKVCache(CacheConfig(
            num_layers=self.config.n_layer,
            num_heads=self.config.n_head,
            head_dim=self.config.n_embd // self.config.n_head,
            num_pages=num_pages, page_size=page_size,
            enable_prefix_cache=enable_prefix_cache), device=self.device)
        self.scheduler = Scheduler(self.cache,
                                   max_batch_tokens=max_batch_tokens,
                                   max_running=max_running,
                                   prefill_chunk_tokens=prefill_chunk_tokens)
        # artificial per-step floor: simulates a heavier model so tests can
        # hold a batch under load long enough to observe overlap/preemption
        self.step_delay_s = step_delay_s
        self._lock = threading.RLock()
        self._work_cv = threading.Condition(self._lock)
        self._out_cv = threading.Condition(self._lock)
        self._requests: Dict[str, Request] = {}
        self._max_retained = 4096
        self._adapters: Dict[str, np.ndarray] = {}
        self._metrics = llm_metrics()
        self._labels = {"engine": engine_name}
        # stats the e2e tests assert on
        self.max_decode_batch = 0
        self.steps = 0
        self.total_generated = 0
        self._first_token_wall: Optional[float] = None
        self._last_token_wall: Optional[float] = None
        # counter high-water marks already pushed to metrics (counters take
        # increments; the scheduler/cache keep running totals)
        self._prefix_hits_pushed = 0
        self._prefilled_pushed = 0

    # -------------------------------------------------------------- intake
    def submit(self, prompt: Union[str, Sequence[int]],
               params: Union[SamplingParams, dict, None] = None,
               admission_wait_s: float = 0.0) -> str:
        if isinstance(params, dict):
            params = SamplingParams(**params)
        params = params or SamplingParams()
        if isinstance(prompt, str):
            prompt = encode_text(prompt, self.config.vocab_size)
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if any(t < 0 or t >= self.config.vocab_size for t in prompt):
            raise ValueError(f"prompt token out of vocab "
                            f"(vocab_size={self.config.vocab_size})")
        if len(prompt) >= self.config.n_positions:
            raise ValueError(
                f"prompt length {len(prompt)} >= n_positions "
                f"{self.config.n_positions}")
        # the position embedding bounds total length
        max_tokens = min(params.max_tokens,
                         self.config.n_positions - len(prompt))
        if max_tokens != params.max_tokens:
            import dataclasses

            params = dataclasses.replace(params, max_tokens=max_tokens)
        if params.adapter:
            self.ensure_adapter(params.adapter)
        rid = uuid.uuid4().hex[:12]
        req = Request(rid, prompt, params)
        # admission-control queue wait (stamped by the serve deployment):
        # the TTFT decomposition's first bucket — it happened BEFORE
        # submitted_at, so extend the request's measured window back
        req.admission_wait_s = max(float(admission_wait_s), 0.0)
        req.submitted_at -= req.admission_wait_s
        with self._lock:
            if len(self._requests) > self._max_retained:
                # bounded retention: evict the oldest terminal requests so a
                # long-lived engine can't grow its result table forever
                terminal = sorted(
                    (r for r in self._requests.values()
                     if r.state in (FINISHED, FAILED, ABORTED)),
                    key=lambda r: r.arrival)
                for old in terminal[:len(self._requests)
                                    - self._max_retained]:
                    del self._requests[old.rid]
            self._requests[rid] = req
            self.scheduler.add(req)
            self._metrics["requests"].inc(1, self._labels)
            self._metrics["prompt_tokens"].inc(len(prompt), self._labels)
            self._work_cv.notify_all()
        return rid

    def abort(self, rid: str) -> bool:
        """Mark aborted; the stepping thread reaps queues/pages at its next
        iteration (freeing the cache here could race an in-flight prefill/
        decode touching the same sequence's pages)."""
        with self._lock:
            req = self._requests.get(rid)
            if req is None or req.state in (FINISHED, FAILED, ABORTED):
                return False
            req.state = ABORTED
            req.finish_reason = "aborted"
            self._out_cv.notify_all()
            self._work_cv.notify_all()
            return True

    # ------------------------------------------------------------ adapters
    def ensure_adapter(self, adapter_id: str) -> None:
        """Register a multiplexed adapter: a deterministic per-id logit bias
        (stands in for LoRA deltas — enough to route, cache and observe
        adapter effects end to end).  Idempotent."""
        with self._lock:
            if adapter_id in self._adapters:
                return
            seed = int.from_bytes(
                hashlib.sha256(adapter_id.encode()).digest()[:8], "big")
            rng = np.random.default_rng(seed)
            self._adapters[adapter_id] = rng.normal(
                0.0, 10.0, self.config.vocab_size).astype(np.float32)

    def loaded_adapters(self) -> List[str]:
        with self._lock:
            return sorted(self._adapters)

    # ------------------------------------------------------------- stepping
    def step(self) -> bool:
        """Run one engine iteration (some prefill chunks + one decode token
        for every running sequence).  Returns False when there was nothing
        to do."""
        with self._lock:
            # reap aborts first: no model math is in flight here, so
            # freeing their pages cannot race the runner
            for req in [r for r in (self.scheduler.waiting
                                    + self.scheduler.running)
                        if r.state is ABORTED]:
                self.scheduler.remove(req)
            plan = self.scheduler.plan()
            if not plan:
                return False
            for req in plan.preempted:
                self._metrics["preemptions"].inc(1, self._labels)
            for req in plan.failed:
                self._out_cv.notify_all()
        # model math outside the lock: only this thread touches the cache
        for req, tokens, start in plan.prefills:
            t0 = time.perf_counter()
            logits = self.runner.prefill(req.rid, tokens, start, self.cache)
            # chunk execution interval for the TTFT decomposition — only
            # the stepping thread writes it, so no lock needed
            req.prefill_intervals.append((t0, time.perf_counter()))
            req.num_computed = start + len(tokens)
            if self.cache.config.enable_prefix_cache:
                # index the now-committed full prompt pages so later
                # requests sharing this prefix can adopt them
                self.cache.insert_prefix(
                    req.rid,
                    req.prompt[:min(req.num_computed, len(req.prompt))])
            if req.num_computed == req.total_len:
                # chunk reached the end of the sequence: the last
                # position's logits produce the next token.  Intermediate
                # chunks of a long prompt just advance num_computed.
                self._emit(req, self._sample(req, logits))
        if plan.decodes:
            # all_tokens[-1] (not outputs[-1]): after a chunked prefill
            # stopping one short of the prompt end, the "decode" that
            # produces the first output token feeds the final prompt token
            items = [(r.rid, r.all_tokens[-1], r.total_len - 1)
                     for r in plan.decodes]
            drafts = self.runner.propose_tokens(items, self.cache)
            logits = self.runner.verify_tokens(items, drafts, self.cache)
            with self._lock:
                self._metrics["decode_batch"].observe(len(items),
                                                      self._labels)
                self.max_decode_batch = max(self.max_decode_batch,
                                            len(items))
            for req, row in zip(plan.decodes, logits):
                req.num_computed += 1
                self._emit(req, self._sample(req, row))
        with self._lock:
            self.steps += 1
            self._update_gauges()
        if self.step_delay_s > 0:
            time.sleep(self.step_delay_s)
        return True

    def _update_gauges(self) -> None:
        self._metrics["kv_util"].set(self.cache.utilization(), self._labels)
        self._metrics["queue_depth"].set(self.scheduler.num_waiting,
                                         self._labels)
        self._metrics["running"].set(self.scheduler.num_running,
                                     self._labels)
        self._metrics["prefix_pages"].set(self.cache.trie_pages,
                                          self._labels)
        hits = self.scheduler.prefix_hit_tokens
        if hits > self._prefix_hits_pushed:
            self._metrics["prefix_hit_tokens"].inc(
                hits - self._prefix_hits_pushed, self._labels)
            self._prefix_hits_pushed = hits
        filled = self.scheduler.prefilled_tokens
        if filled > self._prefilled_pushed:
            self._metrics["prefill_tokens"].inc(
                filled - self._prefilled_pushed, self._labels)
            self._prefilled_pushed = filled
        if self._first_token_wall is not None \
                and self._last_token_wall is not None:
            span = self._last_token_wall - self._first_token_wall
            # cumulative rate since the first token: stays meaningfully
            # non-zero after the run instead of decaying to 0 like a
            # sliding window would
            rate = self.total_generated / span if span > 0 \
                else float(self.total_generated)
            self._metrics["tokens_per_second"].set(rate, self._labels)

    def _sample(self, req: Request, logits: np.ndarray) -> int:
        logits = np.asarray(logits, np.float64)
        p = req.params
        if p.adapter:
            logits = logits + self._adapters[p.adapter]
        if p.temperature <= 0:
            return int(np.argmax(logits))
        if p.top_k > 0 and p.top_k < logits.shape[0]:
            kth = np.partition(logits, -p.top_k)[-p.top_k]
            logits = np.where(logits >= kth, logits, -np.inf)
        probs = _softmax(logits / p.temperature)
        # keyed by (seed, token index) so a preempted-and-recomputed request
        # replays the identical sample stream
        rng = np.random.default_rng([p.seed, len(req.outputs)])
        return int(rng.choice(logits.shape[0], p=probs))

    def _emit(self, req: Request, token: int) -> None:
        now = time.perf_counter()
        with self._lock:
            if req.state in (ABORTED, FAILED):
                return
            req.outputs.append(token)
            self.total_generated += 1
            wall = time.time()
            self._last_token_wall = wall
            if self._first_token_wall is None:
                self._first_token_wall = wall
            if req.first_token_at is None:
                req.first_token_at = now
                self._metrics["ttft"].observe(now - req.submitted_at,
                                              self._labels)
                self._emit_cpath(req)
            elif req.last_token_at is not None:
                gap = now - req.last_token_at
                req.max_itl = max(req.max_itl, gap)
                self._metrics["itl"].observe(gap, self._labels)
            req.last_token_at = now
            self._metrics["tokens"].inc(1, self._labels)
            if len(req.outputs) >= req.params.max_tokens:
                self.scheduler.finish(req, "length")
            elif req.params.stop and token in req.params.stop:
                self.scheduler.finish(req, "stop")
            self._out_cv.notify_all()

    def ttft_decomposition(self, rid: str) -> Dict[str, Any]:
        """Where the request's time-to-first-token went: admission queue ->
        scheduler queue (incl. post-preemption re-waits, shown separately)
        -> prefill chunk execution.  The prefill intervals and preemption
        gaps are disjoint sub-intervals of [submitted_at, first_token_at],
        so the buckets sum to the measured TTFT exactly by construction."""
        with self._lock:
            req = self._requests.get(rid)
            if req is None:
                raise KeyError(f"unknown request {rid!r}")
            if req.first_token_at is None:
                raise ValueError(f"request {rid!r} has no first token yet")
            return self._decompose(req)

    def _decompose(self, req: Request) -> Dict[str, Any]:
        first = req.first_token_at
        total = first - req.submitted_at
        admission = min(req.admission_wait_s, total)
        chunks = [(s, min(e, first)) for s, e in req.prefill_intervals
                  if s < first]
        prefill_exec = sum(e - s for s, e in chunks)
        # a preemption throws away computed state: the gap from eviction to
        # the next prefill start is re-queue wait caused by the preemption
        preempt_wait = 0.0
        for pt in req.preempt_ts:
            if pt >= first:
                continue
            restarts = [s for s, _e in chunks if s > pt]
            preempt_wait += (min(restarts) if restarts else first) - pt
        queue = max(total - admission - prefill_exec - preempt_wait, 0.0)
        return {
            "request_id": req.rid,
            "ttft_s": round(total, 6),
            "admission_wait_s": round(admission, 6),
            "queue_s": round(queue, 6),
            "prefill_exec_s": round(prefill_exec, 6),
            "preempt_wait_s": round(preempt_wait, 6),
            "chunks": len(chunks),
            "preemptions": req.preemptions,
        }

    def _emit_cpath(self, req: Request) -> None:
        """Stamp the finished TTFT decomposition on the task-event stream
        (CPATH annotation) so the critical-path view reads it
        cluster-wide.  No-op without a core worker (the inline engines)."""
        try:
            from ray_tpu_torch._private.config import RayConfig
            from ray_tpu_torch._private.worker import global_worker_core

            core = global_worker_core()
            if core is None or not RayConfig.task_events_enabled:
                return
            decomp = self._decompose(req)
            core.emit_raw_event({
                "task_id": f"cpath-llm-{req.rid}",
                "attempt": 0,
                "name": f"llm_request:{req.rid}",
                "state": "CPATH",
                "ts": time.time(),
                "job_id": core.job_id.hex(),
                "type": "ANNOTATION",
                "node_id": core._node_id_hex,
                "worker_id": core._worker_id_hex,
                "cpath": {
                    "kind": "llm_request",
                    "rid": req.rid,
                    "engine": self.name,
                    "ttft_s": decomp["ttft_s"],
                    "decomposition": decomp,
                },
            }, terminal=True)
        except Exception:
            pass  # observability must never fail token emission

    # --------------------------------------------------------------- read
    def next_output(self, rid: str, cursor: int = 0,
                    timeout_s: float = 30.0) -> Dict[str, Any]:
        """Block until the request has tokens beyond ``cursor`` (or is
        done); returns the new tokens and terminal state."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            req = self._requests.get(rid)
            if req is None:
                raise KeyError(f"unknown request {rid!r}")
            while True:
                done = req.state in (FINISHED, FAILED, ABORTED)
                if len(req.outputs) > cursor or done:
                    return {
                        "tokens": [int(t) for t in req.outputs[cursor:]],
                        "finished": done,
                        "finish_reason": req.finish_reason,
                        "error": req.error,
                    }
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {"tokens": [], "finished": False,
                            "finish_reason": None, "error": None}
                self._out_cv.wait(remaining)

    def result(self, rid: str) -> Dict[str, Any]:
        with self._lock:
            req = self._requests.get(rid)
            if req is None:
                raise KeyError(f"unknown request {rid!r}")
            return {
                "request_id": rid,
                "tokens": [int(t) for t in req.outputs],
                "text": decode_tokens(req.outputs),
                "state": req.state,
                "finish_reason": req.finish_reason,
                "error": req.error,
                "preemptions": req.preemptions,
                "ttft": (req.first_token_at - req.submitted_at
                         if req.first_token_at is not None else None),
                "max_itl": req.max_itl,
            }

    def has_work(self) -> bool:
        with self._lock:
            return self.scheduler.has_work()

    def wait_for_work(self, timeout_s: float) -> None:
        with self._lock:
            if not self.scheduler.has_work():
                self._work_cv.wait(timeout_s)

    def run_until_done(self, rids: Sequence[str],
                       max_steps: int = 100_000) -> None:
        """Inline loop (no thread): step until every rid is terminal."""
        for _ in range(max_steps):
            with self._lock:
                if all(self._requests[r].state in (FINISHED, FAILED, ABORTED)
                       for r in rids):
                    return
            if not self.step():
                with self._lock:
                    if all(self._requests[r].state in
                           (FINISHED, FAILED, ABORTED) for r in rids):
                        return
                raise RuntimeError("engine stalled with work outstanding")
        raise RuntimeError(f"requests not done after {max_steps} steps")

    def generate(self, prompt, params=None) -> Dict[str, Any]:
        """Submit + inline-step to completion (no thread required)."""
        rid = self.submit(prompt, params)
        self.run_until_done([rid])
        return self.result(rid)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "engine": self.name,
                "waiting": self.scheduler.num_waiting,
                "running": self.scheduler.num_running,
                "steps": self.steps,
                "total_generated": self.total_generated,
                "max_decode_batch": self.max_decode_batch,
                "preemptions": self.scheduler.preemptions,
                "kv_pages_total": self.cache.num_pages,
                "kv_pages_free": self.cache.free_pages,
                "kv_page_utilization": self.cache.utilization(),
                "kv_peak_pages_used": self.cache.peak_pages_used,
                "prefilled_tokens": self.scheduler.prefilled_tokens,
                "prefix_hit_tokens": self.scheduler.prefix_hit_tokens,
                "prefix_cache_pages": self.cache.trie_pages,
                "adapters": sorted(self._adapters),
            }


def _process_facts(core: EngineCore) -> Dict[str, Any]:
    """What the engine's process runs on and has done: its device and the
    card's PCI address, the runner's attention calls and the attention
    kernels' launches (``fused:<name>`` for a kernel whose job another did
    inside it), the kernel libraries it compiled itself, and the top-level
    packages it has loaded."""
    import sys

    from ray_tpu_torch._native import build
    from ray_tpu_torch.ops.attention import FUSED_LAUNCHES, KERNEL_LAUNCHES
    from ray_tpu_torch.train.torch_config import _pci_bus_id

    device = core.device
    return {
        "device": str(device),
        "pci_bus_id": (_pci_bus_id(device.index) if device.type == "cuda"
                       else None),
        "attention_calls": core.runner.attention_calls,
        "kernel_launches": {
            **KERNEL_LAUNCHES,
            **{"fused:" + k: n for k, n in FUSED_LAUNCHES.items()}},
        "kernels_built": list(build.compiled),
        "packages": sorted({m.split(".")[0] for m in list(sys.modules)}),
    }


@ray_tpu_torch.remote(num_cpus=0, max_concurrency=32)
class InferenceEngine:
    """The engine as an actor: one background stepping thread, concurrent
    blocking pollers on the actor's executor threads (max_concurrency>1)."""

    def __init__(self, model_config=None, **core_kwargs):
        core_kwargs.setdefault("engine_name", "engine")
        self._core = EngineCore(model_config, **core_kwargs)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"llm-engine-{self._core.name}")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                if not self._core.step():
                    self._core.wait_for_work(0.05)
            except Exception:
                import logging

                logging.getLogger(__name__).exception(
                    "llm engine step failed")
                time.sleep(0.1)

    # ------------------------------------------------------------ surface
    def ping(self) -> bool:
        return True

    def submit(self, prompt, params=None,
               admission_wait_s: float = 0.0) -> str:
        return self._core.submit(prompt, params,
                                 admission_wait_s=admission_wait_s)

    def ttft_decomposition(self, rid: str) -> Dict[str, Any]:
        return self._core.ttft_decomposition(rid)

    def next_output(self, rid: str, cursor: int = 0,
                    timeout_s: float = 30.0) -> Dict[str, Any]:
        return self._core.next_output(rid, cursor, timeout_s)

    def result(self, rid: str) -> Dict[str, Any]:
        return self._core.result(rid)

    def generate(self, prompt, params=None,
                 timeout_s: float = 120.0) -> Dict[str, Any]:
        """Submit and block until terminal (the loop thread steps)."""
        rid = self._core.submit(prompt, params)
        cursor = 0
        deadline = time.monotonic() + timeout_s
        while True:
            out = self._core.next_output(
                rid, cursor, min(5.0, max(0.0, deadline - time.monotonic())))
            cursor += len(out["tokens"])
            if out["finished"]:
                return self._core.result(rid)
            if time.monotonic() > deadline:
                raise TimeoutError(f"generate({rid}) exceeded {timeout_s}s")

    def stream(self, prompt, params=None):
        """Generator method: yields token ids as they are produced.  Use
        with ``num_returns='dynamic'`` to get one ObjectRef per token
        through the dynamic-generator machinery, or consume through the
        serve streaming path."""
        rid = self._core.submit(prompt, params)
        cursor = 0
        while True:
            out = self._core.next_output(rid, cursor, 30.0)
            for t in out["tokens"]:
                yield t
            cursor += len(out["tokens"])
            if out["finished"]:
                if out["error"]:
                    raise RuntimeError(out["error"])
                return

    def abort(self, rid: str) -> bool:
        return self._core.abort(rid)

    def load_adapter(self, adapter_id: str) -> bool:
        self._core.ensure_adapter(adapter_id)
        return True

    def loaded_adapters(self) -> List[str]:
        return self._core.loaded_adapters()

    def stats(self) -> Dict[str, Any]:
        """The engine's stats, and under ``"process"`` the facts of the
        process it runs in (``_process_facts``)."""
        return {**self._core.stats(),
                "process": _process_facts(self._core)}

    def shutdown(self) -> bool:
        self._stop.set()
        return True
