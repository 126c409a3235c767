#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ray_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit, CUDA/torch versions; TF32 off
     so that f32 comparisons are f32;
  2. build: every kernel in ray_tpu_torch/csrc, one nvcc each, in parallel;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the serving path gives it (and the JAX suite's cases), with
     times beside the plain version, one library call and the card's bound;
  4. model: full-width GPT-2-small logits, flash against reference
     attention, then the serving runner's prefill against the model;
  5. serving (the main path): EngineCore at GPT-2-small width serves 8
     greedy requests with chunked prefill; every kernel launch counter is
     set to 0 just before and read just after, and must be > 0;
  6. the kernels line, then the card line, then the result line.

Needs a CUDA card: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# published dense peaks (NVIDIA data sheets): memory B/s, bf16 tensor-core
# FLOP/s, f32 (non-tensor) FLOP/s
_PEAKS = {
    "H100 PCIe": (2.0e12, 756e12, 51e12),
    "H100 NVL": (3.9e12, 835e12, 60e12),
    "H100": (3.35e12, 989e12, 67e12),  # SXM5 ("H100 80GB HBM3")
}
F32_TOL = (2e-3, 2e-3)    # atol, rtol: the JAX suite's bar (tests/test_ops.py)
BF16_TOL = (2e-2, 2e-2)   # bf16 output: one rounding is 2^-8 relative


def _peaks(name: str):
    for key, val in _PEAKS.items():
        if key in name:
            return val
    raise RuntimeError(f"no published peaks for {name!r}")


def _time_ms(fn, iters: int = 20) -> float:
    """Wall time per call on the card's stream (CUDA events over ``iters``
    back-to-back calls): includes the host's launch cost when that is the
    longer of the two."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int = 20) -> float:
    """Device time per call: the summed time of every kernel ``fn`` runs on
    the card, traced by torch.profiler (CUPTI), over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler traced no device time")
    return us / 1e3 / iters


def _check_close(name, got, want, tol):
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside "
                             f"atol={atol} rtol={rtol}; max err "
                             f"{err.max().item():.3e}")
    return err.max().item() if err.numel() else 0.0


# ------------------------------------------------------------- phase 3
ATTN_CASES = [
    # name, dtype, B, H, Sq, Sk, D, causal, q_offset, k_offset
    ("gpt2_prefill_bf16", torch.bfloat16, 1, 12, 512, 512, 64, True, 0, 0),
    ("gpt2_prefill_f32", torch.float32, 1, 12, 512, 512, 64, True, 0, 0),
    ("chunked_prefill_f32", torch.float32, 1, 12, 128, 512, 64, True, 384, 0),
    ("serve_chunk_f32", torch.float32, 1, 12, 256, 512, 64, True, 256, 0),
    ("decode_b8_f32", torch.float32, 8, 12, 1, 1000, 64, True, 999, 0),
    ("serve_decode_f32", torch.float32, 1, 12, 1, 600, 64, True, 599, 0),
    ("unaligned_noncausal_f32", torch.float32, 2, 12, 200, 200, 64, False,
     0, 0),
    ("d128_causal_bf16", torch.bfloat16, 1, 8, 1024, 1024, 128, True, 0, 0),
    ("fully_masked_f32", torch.float32, 1, 12, 64, 64, 64, True, 0, 1000),
]
# the serving path's own shapes: a 256-token prefill chunk and a decode step
MAIN_PATH_CASE = "serve_chunk_f32"


def _visible_pairs(Sq, Sk, causal, q_offset, k_offset) -> int:
    if not causal:
        return Sq * Sk
    q = np.arange(Sq) + q_offset - k_offset
    return int(np.clip(q + 1, 0, Sk).sum())


def attention_cases(card):
    from ray_tpu_torch.ops.attention import (
        flash_attention_fwd,
        flash_attention_fwd_plain,
    )

    bw, bf16_peak, f32_peak = _peaks(card)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for (name, dtype, B, H, Sq, Sk, D, causal, qo, ko) in ATTN_CASES:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)

        q, k, v = randn(B, H, Sq, D), randn(B, H, Sk, D), randn(B, H, Sk, D)
        kw = dict(causal=causal, q_offset=qo, k_offset=ko)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_attention_fwd_plain(q, k, v, **kw)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        err = _check_close(name, o, o_ref, tol)
        live = lse_ref > -1e29
        _check_close(name + " lse", lse[live], lse_ref[live], F32_TOL)
        if name == "fully_masked_f32":
            if not (bool((o == 0).all()) and bool((lse == -1e30).all())):
                raise AssertionError("fully masked rows must give o == 0 "
                                     "and lse == -1e30")
        elif not bool(live.all()):
            raise AssertionError(f"{name}: unexpected fully masked rows")

        mask = None
        if causal:
            mask = (torch.arange(Sq, device="cuda")[:, None] + qo
                    >= torch.arange(Sk, device="cuda")[None, :] + ko)
        fns = {
            "": lambda: flash_attention_fwd(q, k, v, **kw),
            "plain_": lambda: flash_attention_fwd_plain(q, k, v, **kw),
            "library_": lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask),
        }
        times = {}
        for key, fn in fns.items():
            times[key + "ms"] = _device_ms(fn)
            times[key + "call_ms"] = _time_ms(fn)
        ms, plain_ms, library_ms = (times["ms"], times["plain_ms"],
                                    times["library_ms"])

        esize = q.element_size()
        nbytes = (2 * B * H * Sq * D + 2 * B * H * Sk * D) * esize \
            + 4 * B * H * Sq
        flops = 4 * D * B * H * _visible_pairs(Sq, Sk, causal, qo, ko)
        peak = f32_peak if dtype == torch.float32 else bf16_peak
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        rows.append({
            "case": name, "shape": [B, H, Sq, Sk, D],
            "dtype": str(dtype).replace("torch.", ""), "causal": causal,
            "q_offset": qo, "k_offset": ko, "max_abs_err": err,
            "tol": list(tol), **times, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
        print(f"[kernel] flash_fwd {name}: max_abs_err={err:.3e} "
              f"(atol={tol[0]}, rtol={tol[1]}) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={rows[-1]['bound_ms']:.5f} "
              f"({rows[-1]['bound_by']}); per call on the stream: kernel "
              f"{times['call_ms']:.4f} plain {times['plain_call_ms']:.4f} "
              f"library {times['library_call_ms']:.4f}", flush=True)
    return rows


# ------------------------------------------------------------- phase 4
def model_forward(params):
    from ray_tpu_torch.llm import GPT2Runner, PagedKVCache
    from ray_tpu_torch.llm.kv_cache import CacheConfig
    from ray_tpu_torch.models import GPT2Config, GPT2LMModel, params_from_flax

    cfg = GPT2Config(dtype=torch.float32)
    state = params_from_flax(params)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 512))).cuda()
    logits = {}
    for impl in ("flash", "reference"):
        model = GPT2LMModel(GPT2Config(dtype=torch.float32,
                                       attention_impl=impl), device="cuda")
        model.load_state_dict(state)
        with torch.no_grad():
            logits[impl] = model(ids)[0]
        del model
    tol = (1e-4, 1e-3)  # tests/test_llm.py:154
    err = _check_close("GPT2LMModel flash vs reference", logits["flash"],
                       logits["reference"], tol)
    print(f"[model] GPT-2-small (1, 512) f32 logits flash vs reference: "
          f"max_abs_err={err:.3e} (atol={tol[0]}, rtol={tol[1]})",
          flush=True)

    runner = GPT2Runner(cfg, params, device="cuda")
    cache = PagedKVCache(CacheConfig(
        num_layers=cfg.n_layer, num_heads=cfg.n_head,
        head_dim=cfg.n_embd // cfg.n_head, num_pages=32, page_size=16),
        device="cuda")
    cache.reserve("s", 512)
    mine = torch.from_numpy(runner.prefill(
        "s", ids[0].tolist(), 0, cache, return_all=True)).cuda()
    err = _check_close("GPT2Runner.prefill vs GPT2LMModel", mine,
                       logits["flash"], tol)
    print(f"[model] GPT2Runner.prefill(return_all) vs GPT2LMModel: "
          f"max_abs_err={err:.3e} (atol={tol[0]}, rtol={tol[1]})",
          flush=True)


# ------------------------------------------------------------- phase 5
def serve(card_label):
    from ray_tpu_torch.llm import EngineCore, SamplingParams
    from ray_tpu_torch.models import GPT2Config
    from ray_tpu_torch.ops.attention import KERNEL_LAUNCHES

    cfg = GPT2Config.small()
    rng = np.random.default_rng(7)
    lengths = np.concatenate([[32, 600], rng.integers(32, 601, size=6)])
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in lengths]
    params = SamplingParams(max_tokens=32)

    def run(trace=False):
        core = EngineCore(cfg, device="cuda", seed=0, page_size=16,
                          num_pages=512, max_batch_tokens=512,
                          prefill_chunk_tokens=256, engine_name="smoke")
        torch.cuda.synchronize()
        for key in KERNEL_LAUNCHES:
            KERNEL_LAUNCHES[key] = 0
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        rids = [core.submit(p, params) for p in prompts]
        core.run_until_done(rids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            kernels = {e.key: e.self_device_time_total / 1e6
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA}
            busy = sum(kernels.values())
            flash = sum(t for k, t in kernels.items() if "flash_fwd" in k)
            top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
            print(f"[serve] traced run: wall_s={wall:.4f} device_busy_s="
                  f"{busy:.4f} (idle share {1 - busy / wall:.4f}) "
                  f"flash_fwd_s={flash:.4f}; top kernels: "
                  + "; ".join(f"{k[:60]} {t:.4f}s" for k, t in top),
                  flush=True)
        launches = dict(KERNEL_LAUNCHES)
        results = [core.result(r) for r in rids]
        for res in results:
            if res["state"] != "FINISHED" or len(res["tokens"]) != 32:
                raise AssertionError(f"request did not finish with 32 "
                                     f"tokens: {res}")
        core.cache.check_leaks()
        return core, wall, launches, results

    core, wall, launches, results = run()
    calls = core.runner.attention_calls
    if not (launches["flash_fwd"] > 0 and launches["flash_fwd"] == calls
            and calls % cfg.n_layer == 0):
        raise AssertionError(f"flash_fwd launches {launches} != attention "
                             f"calls {calls} (n_layer {cfg.n_layer})")
    for key, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {key} was not launched by the "
                                 f"serving path")
    _, _, _, again = run(trace=True)
    if [r["tokens"] for r in results] != [r["tokens"] for r in again]:
        raise AssertionError("a second identical run gave other tokens")
    gen = sum(len(r["tokens"]) for r in results)
    ttft = sorted(r["ttft"] for r in results)
    print(f"[serve] GPT-2-small, 8 requests, prompts {sorted(lengths.tolist())}"
          f", 32 tokens each, chunked prefill 256: steps={core.steps} "
          f"wall_s={wall:.4f} tokens_per_s={gen / wall:.2f} "
          f"ttft_median_s={ttft[len(ttft) // 2]:.4f} "
          f"ttft_max_s={ttft[-1]:.4f} flash_fwd_launches="
          f"{launches['flash_fwd']} (= {cfg.n_layer} layers x "
          f"{calls // cfg.n_layer} sequence passes) on {card_label}",
          flush=True)
    print("[serve] deterministic: second run gave identical tokens; "
          "cache leak check passed", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch._native import build
    from ray_tpu_torch.llm import random_flax_params
    from ray_tpu_torch.models import GPT2Config

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    print(f"[device] {card}; torch {torch.__version__}; CUDA "
          f"{torch.version.cuda}; python {sys.version.split()[0]}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # 3. kernels against their plain versions
    rows = attention_cases(card)

    # 4. model at full width
    model_forward(random_flax_params(GPT2Config.small(), seed=0))

    # 5. the main path
    launches = serve(f"{card} ({smi})")

    # 6. kernels line, card line, result line
    main_row = next(r for r in rows if r["case"] == MAIN_PATH_CASE)
    kernel = {
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:66",
        "launches": launches["flash_fwd"],
        **{key: main_row[key] for key in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "shape": main_row["case"], "pass": True, "cases": rows,
    }
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
