#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ray_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit, CUDA/torch versions; TF32 off
     so that f32 comparisons are f32;
  2. build: every kernel in ray_tpu_torch/csrc, one nvcc each, in parallel,
     with each kernel's registers and spills from ptxas; then the SASS of
     the bf16 tensor-core kernel must hold wgmma (HGMMA) and TMA loads
     (UTMALDG), counted with cuobjdump;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the serving path gives it (and the JAX suite's cases), with
     the plan it chose (variant, KV splits), times beside the plain version,
     one library call and the card's bound; then the split-KV combine
     kernel against its plain version at the serving decode's partials;
  4. model: full-width GPT-2-small logits, flash against reference
     attention, in f32 and at the model's default bf16; then the serving
     runner's prefill against the model;
  5. serving (the main path): EngineCore at GPT-2-small width serves 8
     greedy requests with chunked prefill; every kernel launch counter is
     set to 0 just before and read just after, and must be > 0 (flash_fwd
     once per attention call, flash_fwd_combine for the split launches);
  6. the kernels line, then the card line, then the result line.

Needs a CUDA card: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
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


def _device_ms(fn, iters: int = 20, part=None):
    """Device time per call: the summed time of every kernel ``fn`` runs on
    the card, traced by torch.profiler (CUPTI), over ``iters`` calls.  With
    ``part``, also the share of the kernels whose name holds ``part``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # CUPTI now and then hands back an empty trace; the work is the same
    # each time, so trace it again (at most three times)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in events)
        if us > 0:
            break
    else:
        raise RuntimeError("the profiler traced no device time")
    if part is None:
        return us / 1e3 / iters
    sub = sum(e.self_device_time_total for e in events if part in e.key)
    return us / 1e3 / iters, sub / 1e3 / iters


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
    ("serve_decode_bf16", torch.bfloat16, 1, 12, 1, 600, 64, True, 599, 0),
    # q/k/v as strided views of one (1, 512, 3*768) tensor, GPT2LMModel's
    # layout: TMA on strided input
    ("gpt2_fused_qkv_bf16", torch.bfloat16, 1, 12, 512, 512, 64, True, 0, 0),
    # the other variants and epilogues: one split (the grid fills the card),
    # ragged non-causal tiles on the tensor cores, a 5-row decode, and K/V
    # whose base and row stride are not 16-byte multiples (copied first)
    ("gpt2_prefill_b4_bf16", torch.bfloat16, 4, 12, 512, 512, 64, True, 0, 0),
    ("unaligned_noncausal_bf16", torch.bfloat16, 2, 12, 200, 200, 64, False,
     0, 0),
    ("decode_b16_bf16", torch.bfloat16, 16, 12, 1, 1000, 64, True, 999, 0),
    ("spec_decode_f32", torch.float32, 1, 12, 5, 600, 64, True, 595, 0),
    ("misaligned_kv_f32", torch.float32, 1, 12, 128, 300, 64, True, 172, 0),
]
FUSED_QKV_CASES = {"gpt2_fused_qkv_bf16"}
MISALIGNED_CASES = {"misaligned_kv_f32"}
# the serving path's own shapes: a 256-token prefill chunk and a decode step
MAIN_PATH_CASE = "serve_chunk_f32"


def _visible_pairs(Sq, Sk, causal, q_offset, k_offset) -> int:
    if not causal:
        return Sq * Sk
    q = np.arange(Sq) + q_offset - k_offset
    return int(np.clip(q + 1, 0, Sk).sum())


def attention_cases(card):
    from ray_tpu_torch.ops import attention as tattn
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

        if name in FUSED_QKV_CASES:
            qkv = randn(B, Sq, 3 * H * D)
            q, k, v = (t.reshape(B, Sq, H, D).transpose(1, 2)
                       for t in qkv.split(H * D, dim=-1))
        elif name in MISALIGNED_CASES:
            q = randn(B, H, Sq, D)
            k, v = (randn(B, H, Sk, D + 1)[..., 1:] for _ in range(2))
        else:
            q, k, v = (randn(B, H, Sq, D), randn(B, H, Sk, D),
                       randn(B, H, Sk, D))
        kw = dict(causal=causal, q_offset=qo, k_offset=ko)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        plan = dict(tattn.LAST_PLAN)
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
        if name in MISALIGNED_CASES and plan["copied"] != ["k", "v"]:
            raise AssertionError(f"{name}: misaligned K/V were not copied "
                                 f"({plan})")

        mask = None
        if causal:
            mask = (torch.arange(Sq, device="cuda")[:, None] + qo
                    >= torch.arange(Sk, device="cuda")[None, :] + ko)
        # the library call refuses K/V rows that are not 16-byte aligned:
        # it is timed on aligned copies there
        lk, lv = ((k.contiguous(), v.contiguous())
                  if name in MISALIGNED_CASES else (k, v))
        fns = {
            "": lambda: flash_attention_fwd(q, k, v, **kw),
            "plain_": lambda: flash_attention_fwd_plain(q, k, v, **kw),
            "library_": lambda: F.scaled_dot_product_attention(
                q, lk, lv, attn_mask=mask),
        }
        times = {}
        for key, fn in fns.items():
            if key:
                times[key + "ms"] = _device_ms(fn)
            else:
                times["ms"], times["combine_ms"] = _device_ms(
                    fn, part="flash_fwd_combine")
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
            "q_offset": qo, "k_offset": ko, "plan": plan, "max_abs_err": err,
            "tol": list(tol), **times, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        })
        print(f"[kernel] flash_fwd {name}: plan variant={plan['variant']} "
              f"splits={plan['num_splits']} grid={plan['grid']} "
              f"copied={plan['copied']}; max_abs_err={err:.3e} "
              f"(atol={tol[0]}, rtol={tol[1]}) ms={ms:.4f} "
              f"(combine {times['combine_ms']:.4f}) "
              f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"bound_ms={rows[-1]['bound_ms']:.5f} "
              f"({rows[-1]['bound_by']}); per call on the stream: kernel "
              f"{times['call_ms']:.4f} plain {times['plain_call_ms']:.4f} "
              f"library {times['library_call_ms']:.4f}", flush=True)
    return rows


# the serving decode's split-KV partials: 12 heads, 10 splits, one row
COMBINE_CASE = ("serve_decode_f32", torch.float32, 1, 12, 1, 600, 64, 599)


def combine_case(card):
    """The combine kernel against ``merge_partials_plain`` on the partials
    that the serving decode produces, at the shapes the main path gives
    it."""
    from ray_tpu_torch.ops.attention import (
        KERNEL_BLOCK_K,
        flash_attention_fwd_split_plain,
        flash_fwd_combine,
        merge_partials_plain,
        split_plan,
    )

    name, dtype, B, H, Sq, Sk, D, qo = COMBINE_CASE
    bw = _peaks(card)[0]
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(B, H, s, D, generator=gen, device="cuda")
               for s in (Sq, Sk, Sk))
    splits = split_plan(B, H, Sq, Sk, True, qo, 0, 16, KERNEL_BLOCK_K,
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count).num_splits
    part = flash_attention_fwd_split_plain(q, k, v, causal=True, q_offset=qo,
                                           num_splits=splits)
    part = tuple(t.contiguous() for t in part)
    o, lse = flash_fwd_combine(*part, dtype=dtype)
    torch.cuda.synchronize()
    o_ref, lse_ref = merge_partials_plain(*part, dtype=dtype)
    err = _check_close("flash_fwd_combine", o, o_ref, F32_TOL)
    _check_close("flash_fwd_combine lse", lse, lse_ref, F32_TOL)
    ms = _device_ms(lambda: flash_fwd_combine(*part, dtype=dtype))
    plain_ms = _device_ms(lambda: merge_partials_plain(*part, dtype=dtype))
    nbytes = sum(t.numel() * 4 for t in part) + o.numel() * o.element_size() \
        + lse.numel() * 4
    bound_ms = nbytes / bw * 1e3
    print(f"[kernel] flash_fwd_combine {name} partials (B*H={B * H}, "
          f"splits={splits}, Sq={Sq}, D={D}): max_abs_err={err:.3e} "
          f"(atol={F32_TOL[0]}, rtol={F32_TOL[1]}) ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} (bytes)",
          flush=True)
    return {"case": name, "splits": splits, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None}


# ------------------------------------------------------------- phase 2
def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cands = ["/usr/local/cuda/bin/cuobjdump"]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(os.path.join(os.path.dirname(spec.origin), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    for cand in cands:
        if os.path.isfile(cand):
            return cand
    raise RuntimeError("cuobjdump not found: cannot read the kernels' SASS")


def sass_check(lib_path) -> dict:
    """Counts of HGMMA (wgmma) and UTMALDG (TMA load) instructions in each
    kernel of the library; fails unless the bf16 tensor-core kernels have
    both."""
    out = subprocess.run([_cuobjdump(), "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
        elif fn is not None:
            for op in ("HGMMA", "UTMALDG"):
                counts[fn][op] += op in line
    tc = {f: c for f, c in counts.items() if "flash_fwd_wgmma" in f}
    for f, c in sorted(counts.items()):
        print(f"[build] SASS {f}: HGMMA={c['HGMMA']} UTMALDG={c['UTMALDG']}")
    if not tc or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0
                     for c in tc.values()):
        raise AssertionError(f"the bf16 tensor-core kernel lacks wgmma or "
                             f"TMA loads in its SASS: {tc}")
    return tc


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

    # The model's default dtype, bf16: every GEMM and the attention round to
    # bf16, so flash and reference attention differ by bf16 rounding, not by
    # a fixed bar.  The bar: against the f32 logits, the flash model may be
    # at most 1.5x as far as the bf16 model with reference attention (whose
    # attention also rounds its softmax weights to bf16), i.e. the kernel
    # adds no error of its own beyond bf16's.
    bf16 = {}
    for impl in ("flash", "reference"):
        model = GPT2LMModel(GPT2Config(attention_impl=impl), device="cuda")
        model.load_state_dict(state)
        with torch.no_grad():
            bf16[impl] = model(ids)[0].float()
        del model
    d_flash = (bf16["flash"] - logits["reference"]).abs().max().item()
    d_ref = (bf16["reference"] - logits["reference"]).abs().max().item()
    d_pair = (bf16["flash"] - bf16["reference"]).abs().max().item()
    if not (torch.isfinite(bf16["flash"]).all() and d_flash <= 1.5 * d_ref):
        raise AssertionError(f"bf16 GPT2LMModel: flash is {d_flash:.3e} "
                             f"from the f32 logits, reference attention "
                             f"{d_ref:.3e} (bar 1.5x)")
    print(f"[model] GPT-2-small (1, 512) bf16 logits: flash vs f32 "
          f"max_abs_err={d_flash:.3e}, bf16 reference attention vs f32 "
          f"{d_ref:.3e} (bar: flash <= 1.5x that); flash vs reference in "
          f"bf16 {d_pair:.3e}", flush=True)

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
def serving_workload():
    """The serving run's model and traffic: GPT-2-small, 8 greedy requests
    of 32 tokens, prompts of 32, 600 and six seeded lengths; and an engine
    for it (chunked prefill of 256)."""
    from ray_tpu_torch.llm import EngineCore, SamplingParams
    from ray_tpu_torch.models import GPT2Config

    cfg = GPT2Config.small()
    rng = np.random.default_rng(7)
    lengths = np.concatenate([[32, 600], rng.integers(32, 601, size=6)])
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in lengths]

    def engine():
        return EngineCore(cfg, device="cuda", seed=0, page_size=16,
                          num_pages=512, max_batch_tokens=512,
                          prefill_chunk_tokens=256, engine_name="smoke")
    return cfg, lengths, prompts, SamplingParams(max_tokens=32), engine


def serve(card_label):
    from ray_tpu_torch.ops.attention import KERNEL_LAUNCHES

    cfg, lengths, prompts, params, engine = serving_workload()

    def run(trace=False):
        core = engine()
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
    if not 0 < launches["flash_fwd_combine"] <= calls:
        raise AssertionError(f"flash_fwd_combine launches {launches}: the "
                             f"split-KV path did not run on the main path")
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
          f"{calls // cfg.n_layer} sequence passes), flash_fwd_combine_"
          f"launches={launches['flash_fwd_combine']} on {card_label}",
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
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    sass_check(libs["flash_fwd"])

    # 3. kernels against their plain versions
    rows = attention_cases(card)
    combine_row = combine_case(card)

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
    combine = {
        "name": "flash_fwd_combine", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:126",
        "launches": launches["flash_fwd_combine"],
        **{key: combine_row[key] for key in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "shape": combine_row["case"], "splits": combine_row["splits"],
        "pass": True,
    }
    print(json.dumps({"kernels": [kernel, combine]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
