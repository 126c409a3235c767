"""Port of ``ray_tpu/_private/serve_load_bench.py``.

Serving-at-scale bench: SSE load harness + prefix/chunking A/Bs.

Three rows for bench.py's ``serve_load`` section (gate
``RAY_TPU_TORCH_BENCH_SERVE=0``):

* ``prefix_ab`` — in-process EngineCore A/B on a shared-system-prompt,
  multi-turn mix (16 requests): prefilled-token reduction from the radix
  prefix cache, with bit-identical outputs asserted against the cache-off
  arm.
* ``chunked_prefill_ab`` — one 4k-token prompt admitted while 8 streams
  decode, chunked vs unchunked on the same interleaved schedule: max
  observed ITL across the live streams, per arm.
* ``sse_load`` — hundreds of concurrent SSE streams (default 256; env
  ``RAY_TPU_TORCH_BENCH_SERVE_STREAMS``) against a 2-replica `llm_deployment`
  through the real HTTP proxy: TTFT/ITL percentiles, goodput (completed
  tokens/s), shed count, half-stream count (must be 0), prefix-hit rate.

The SSE part owns a serve app inside the caller's runtime; bench.py runs
this module in a subprocess with its own ``ray_tpu_torch.init``.

Every engine runs on the card unless ``device="cpu"`` is passed;
``model_config`` replaces the tiny default (the chunked arm sets
``n_positions = long_len + 256`` on it).  On the card the SSE replicas'
engines share it, each asking ``1 / num_replicas`` of it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import time
from typing import Dict, List

# ----------------------------------------------------------------- utils


def _pct(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    s = sorted(values)
    i = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return s[i]


def _latency_row(values: List[float]) -> Dict[str, float]:
    return {
        "p50_ms": round(_pct(values, 0.50) * 1e3, 3),
        "p95_ms": round(_pct(values, 0.95) * 1e3, 3),
        "p99_ms": round(_pct(values, 0.99) * 1e3, 3),
    }


# ----------------------------------------------------- prefix caching A/B


def _prefix_workload():
    """Shared-system-prompt, multi-turn mix: 8 conversations whose first
    turn is a 32-token system prompt (50% of the prompt) + a 32-token
    unique user turn; each conversation then issues a follow-up that
    resends the whole first exchange plus 16 new tokens — the radix-cache
    sweet spot (16 requests total)."""
    system = [7 + (i % 40) for i in range(32)]
    turns = []
    for c in range(8):
        user = [60 + c * 3 + (i % 50) for i in range(32)]
        turns.append(system + user)
    return turns


def _run_prefix_arm(enable: bool, device=None,
                    model_config=None) -> Dict[str, object]:
    from ray_tpu_torch.llm import EngineCore

    # sequential generate() staggers admissions naturally: each request
    # completes (and populates the trie) before the next one admits
    core = EngineCore(model_config, seed=0, num_pages=512, page_size=8,
                      device=device,
                      max_batch_tokens=128,
                      engine_name="bench-prefix",
                      enable_prefix_cache=enable)
    first = [core.generate(p, {"max_tokens": 8}) for p in _prefix_workload()]
    second = []
    for conv, res in zip(_prefix_workload(), first):
        followup = conv + res["tokens"] + [200 + (i % 30) for i in range(16)]
        second.append(core.generate(followup, {"max_tokens": 8}))
    core.cache.check_leaks()
    return {
        "outputs": [r["tokens"] for r in first + second],
        "prefilled_tokens": core.scheduler.prefilled_tokens,
        "prefix_hit_tokens": core.scheduler.prefix_hit_tokens,
    }


def run_prefix_ab(device=None, model_config=None) -> Dict[str, object]:
    off = _run_prefix_arm(False, device, model_config)
    on = _run_prefix_arm(True, device, model_config)
    assert on["outputs"] == off["outputs"], \
        "prefix cache changed sampled outputs"
    ratio = off["prefilled_tokens"] / max(on["prefilled_tokens"], 1)
    return {
        "requests": 16,
        "prefilled_tokens_off": off["prefilled_tokens"],
        "prefilled_tokens_on": on["prefilled_tokens"],
        "prefill_reduction_x": round(ratio, 2),
        "prefix_hit_tokens": on["prefix_hit_tokens"],
        "outputs_identical": True,
    }


# ---------------------------------------------------- chunked prefill A/B


def _run_chunked_arm(chunk: int, long_len: int, device=None,
                     model_config=None) -> Dict[str, float]:
    from ray_tpu_torch.llm import EngineCore
    from ray_tpu_torch.models.gpt2 import GPT2Config

    cfg = dataclasses.replace(
        model_config or GPT2Config(vocab_size=512, n_embd=64, n_layer=2,
                                   n_head=4),
        n_positions=long_len + 256)
    core = EngineCore(cfg, seed=0, num_pages=(long_len + 512) // 16 + 64,
                      device=device,
                      page_size=16,
                      max_batch_tokens=max(long_len + 64, 64),
                      engine_name="bench-chunk",
                      prefill_chunk_tokens=chunk)
    rids = [core.submit([3 + i] * 8, {"max_tokens": 48})
            for i in range(8)]
    # let the 8 streams reach steady-state decode, then drop the long
    # prompt into the running batch
    for _ in range(6):
        core.step()
    long_rid = core.submit([5 + (i % 400) for i in range(long_len)],
                           {"max_tokens": 4})
    core.run_until_done(rids + [long_rid])
    itls = [core.result(r)["max_itl"] for r in rids]
    return {"max_itl_s": max(itls)}


def run_chunked_ab(long_len: int = 4096, device=None,
                   model_config=None) -> Dict[str, object]:
    unchunked = _run_chunked_arm(0, long_len, device, model_config)
    chunked = _run_chunked_arm(256, long_len, device, model_config)
    return {
        "long_prompt_tokens": long_len,
        "decode_streams": 8,
        "prefill_chunk_tokens": 256,
        "max_itl_unchunked_ms": round(unchunked["max_itl_s"] * 1e3, 2),
        "max_itl_chunked_ms": round(chunked["max_itl_s"] * 1e3, 2),
        "itl_ratio": round(chunked["max_itl_s"]
                           / max(unchunked["max_itl_s"], 1e-9), 3),
    }


# ------------------------------------------------------- SSE load harness


async def _drive_stream(session, url: str, prompt: List[int], tenant: str,
                        max_tokens: int, rec: Dict[str, object]) -> None:
    t0 = time.perf_counter()
    last = None
    try:
        async with session.post(
                url, json={"prompt_ids": prompt, "max_tokens": max_tokens,
                           "stream": True, "tenant": tenant},
                headers={"Accept": "text/event-stream"}) as resp:
            if resp.status == 429:
                rec["shed"] = True
                await resp.read()
                return
            async for raw in resp.content:
                line = raw.strip()
                if not line.startswith(b"data:"):
                    if line.startswith(b"event: error"):
                        rec["error"] = True
                    continue
                payload = line[len(b"data:"):].strip()
                if payload == b"[DONE]":
                    rec["done"] = True
                    return
                event = json.loads(payload)
                if event.get("done"):
                    continue
                now = time.perf_counter()
                if last is None:
                    rec["ttft"] = now - t0
                else:
                    rec["itls"].append(now - last)
                last = now
                rec["tokens"] += 1
    except Exception as e:
        rec["error"] = True
        rec["exc"] = repr(e)


async def _drive_load(port: int, num_streams: int,
                      max_tokens: int) -> List[Dict[str, object]]:
    import aiohttp

    url = f"http://127.0.0.1:{port}/llm"
    system = [7 + (i % 40) for i in range(32)]
    records: List[Dict[str, object]] = []
    conn = aiohttp.TCPConnector(limit=num_streams + 16)
    timeout = aiohttp.ClientTimeout(total=240)
    async with aiohttp.ClientSession(connector=conn,
                                     timeout=timeout) as session:
        tasks = []
        for i in range(num_streams):
            # shared-system-prompt mix: half the streams extend the common
            # system prompt, half are fully unique; two tenants
            if i % 2 == 0:
                prompt = system + [60 + (i % 100)] * 8
            else:
                prompt = [(11 + 5 * i + j) % 500 + 1 for j in range(24)]
            rec = {"shed": False, "done": False, "error": False,
                   "tokens": 0, "ttft": None, "itls": []}
            records.append(rec)
            tasks.append(_drive_stream(session, url, prompt,
                                       f"tenant-{i % 2}", max_tokens, rec))
        await asyncio.gather(*tasks)
    return records


def run_sse_load(num_streams: int = 256, num_replicas: int = 2,
                 max_tokens: int = 8,
                 metrics_wait_s: float = 30.0, device=None,
                 model_config=None) -> Dict[str, object]:
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import llm_deployment
    from ray_tpu_torch.util import state

    engine_kwargs = dict(num_pages=256, page_size=8, max_batch_tokens=256,
                         max_running=32, seed=0,
                         engine_name="bench-serve",
                         enable_prefix_cache=True,
                         prefill_chunk_tokens=64, device=device,
                         model_config=model_config)
    if str(device or "cuda") != "cpu":
        engine_kwargs["num_gpus"] = 1 / num_replicas
    app = llm_deployment(engine_kwargs=engine_kwargs,
                         num_replicas=num_replicas,
                         max_ongoing_requests=max(num_streams, 64),
                         admission_kwargs=dict(max_inflight=64,
                                               max_queue=num_streams,
                                               queue_deadline_s=120.0))
    serve.run(app, name="llm-load", route_prefix="/llm")
    port = serve.start(http_port=0)
    try:
        t0 = time.perf_counter()
        records = asyncio.new_event_loop().run_until_complete(
            _drive_load(port, num_streams, max_tokens))
        wall = time.perf_counter() - t0

        completed = [r for r in records if r["done"]]
        shed = [r for r in records if r["shed"]
                or (r["error"] and r["tokens"] == 0)]
        half = [r for r in records
                if r["tokens"] > 0 and not r["done"]]
        ttfts = [r["ttft"] for r in completed if r["ttft"] is not None]
        itls = [g for r in completed for g in r["itls"]]
        tokens = sum(r["tokens"] for r in completed)

        # per-engine metric fold (both replicas push under one engine
        # label); the push is periodic, so poll briefly for it to land
        view: Dict[str, float] = {}
        deadline = time.monotonic() + metrics_wait_s
        while time.monotonic() < deadline:
            view = state.summarize_llm().get("bench-serve", {})
            if view.get("requests", 0) >= len(completed):
                break
            time.sleep(1.0)
        return {
            "streams": num_streams,
            "replicas": num_replicas,
            "completed": len(completed),
            "shed": len(shed),
            "half_streams": len(half),
            "wall_s": round(wall, 2),
            "goodput_tokens_per_s": round(tokens / max(wall, 1e-9), 1),
            "ttft": _latency_row(ttfts),
            "itl": _latency_row(itls),
            "prefix_hit_rate": round(view.get("prefix_hit_rate", 0.0), 3),
            "prefix_hit_tokens": view.get("prefix_hit_tokens", 0.0),
            "sheds_by_engine_metric": view.get("shed", 0.0),
        }
    finally:
        serve.delete("llm-load")


# --------------------------------------------------------------- section


def run_serve_load_bench(device=None,
                         model_config=None) -> Dict[str, object]:
    from ray_tpu_torch._private.config import RayConfig

    streams = RayConfig.bench_serve_streams
    out: Dict[str, object] = {}
    out["prefix_ab"] = run_prefix_ab(device, model_config)
    out["chunked_prefill_ab"] = run_chunked_ab(device=device,
                                               model_config=model_config)
    out["sse_load"] = run_sse_load(num_streams=streams, device=device,
                                   model_config=model_config)
    return out
