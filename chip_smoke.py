#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ray_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit, CUDA/torch versions; TF32 off
     so that f32 comparisons are f32;
  2. build: every kernel source in ray_tpu_torch/csrc (flash_fwd.cu,
     flash_bwd.cu), one nvcc each, in parallel, with each kernel's registers
     and spills from ptxas; then the SASS of the bf16 tensor-core kernel
     must hold wgmma (HGMMA) and TMA loads (UTMALDG), counted with cuobjdump;
  3. forward kernels: each against its plain PyTorch version on the card at
     the shapes the serving path gives it (and the JAX suite's cases), with
     the plan it chose (variant, KV splits), times beside the plain version,
     one library call and the card's bound; then the split-KV combine
     kernel against its plain version at the serving decode's partials;
  3b. backward kernels (delta, dK/dV, dQ) against flash_attention_bwd_plain
     on the forward kernel's o and lse, at the training path's shape and six
     more cases: each result repeated bit for bit, device time in total and
     per kernel, the plain version, the backward of
     scaled_dot_product_attention as the library yardstick, and the bound;
  4. model: full-width GPT-2-small logits, flash against reference
     attention, in f32 and at the model's default bf16; then the serving
     runner's prefill against the model;
  5. serving (a main path): EngineCore at GPT-2-small width serves 8
     greedy requests with chunked prefill; every kernel launch counter is
     set to 0 just before and read just after, and the forward kernels must
     have run (flash_fwd once per attention call, flash_fwd_combine for the
     split launches);
  6. training (a main path): ShardedPretrainer takes 10 steps of
     GPT-2-small (bf16, flash, no remat) at batch 16 x 1024 on one seeded
     batch; losses finite and falling; every counter set to 0 just before
     and read just after (flash_fwd and each backward kernel 12 per step,
     no combine); step time, tokens/s, peak memory, MFU, a traced step;
     then loss parity against reference attention in bf16 (3 steps at
     batch 4) and in f32 (one step, loss and gradient norm);
  7. the kernels line, then the card line, then the result line.

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
    ``part``, also the share of the kernels whose name holds ``part`` (a
    name, or a tuple of names for a dict of shares)."""
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

    def share(name):
        return sum(e.self_device_time_total for e in events
                   if name in e.key) / 1e3 / iters
    if isinstance(part, tuple):
        return us / 1e3 / iters, {name: share(name) for name in part}
    return us / 1e3 / iters, share(part)


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


# ------------------------------------------------------------ phase 3b
BWD_CASES = [
    # name, dtype, B, H, Sq, Sk, D, causal, q_offset, k_offset
    ("train_bf16", torch.bfloat16, 16, 12, 1024, 1024, 64, True, 0, 0),
    ("train_f32", torch.float32, 4, 12, 1024, 1024, 64, True, 0, 0),
    ("unaligned_noncausal_f32", torch.float32, 2, 12, 200, 200, 64, False,
     0, 0),
    ("chunk_offset_f32", torch.float32, 1, 12, 128, 512, 64, True, 384, 0),
    ("d128_causal_bf16", torch.bfloat16, 1, 8, 1024, 1024, 128, True, 0, 0),
    ("fully_masked_f32", torch.float32, 1, 12, 64, 64, 64, True, 0, 1000),
    # q/k/v as views of one (B, S, 3E) tensor and g as the (B, H, S, D)
    # view of a (B, S, H, D) tensor: GPT2LMModel's training layout
    ("fused_qkv_bf16", torch.bfloat16, 4, 12, 1024, 1024, 64, True, 0, 0),
]
BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
# the training path's own shape
TRAIN_CASE = "train_bf16"


def _bwd_bounds(B, H, Sq, Sk, D, esize, pairs, peak, bw):
    """Least device time (ms, and what bounds it) of the whole backward and
    of each kernel's function: every input read once, every output written
    once; 2*D flops per visible pair for each of S, dP, dV, dK and dQ that
    the function needs (the two-kernel design's recomputed S and dP are not
    counted)."""
    q_bytes, k_bytes = B * H * Sq * D * esize, B * H * Sk * D * esize
    row_bytes = 4 * B * H * Sq  # lse or delta
    work = {  # bytes, flops
        "op": (3 * q_bytes + 2 * k_bytes + row_bytes + q_bytes + 2 * k_bytes,
               10 * D * pairs),
        "flash_bwd_delta": (2 * q_bytes + row_bytes, 2 * D * B * H * Sq),
        "flash_bwd_dkdv": (2 * q_bytes + 2 * k_bytes + 2 * row_bytes
                           + 2 * k_bytes, 8 * D * pairs),
        "flash_bwd_dq": (2 * q_bytes + 2 * k_bytes + 2 * row_bytes + q_bytes,
                         6 * D * pairs),
    }
    out = {}
    for key, (nbytes, flops) in work.items():
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        out[key] = (max(t_bytes, t_ops),
                    "bytes" if t_bytes >= t_ops else "operations")
    return out


def backward_cases(card):
    """The three backward kernels against ``flash_attention_bwd_plain``
    (and the delta kernel against ``flash_bwd_delta_plain``) on the forward
    kernel's o and lse."""
    from ray_tpu_torch.ops import attention as tattn
    from ray_tpu_torch.ops.attention import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_bwd_delta,
        flash_bwd_delta_plain,
    )

    bw, bf16_peak, f32_peak = _peaks(card)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    for (name, dtype, B, H, Sq, Sk, D, causal, qo, ko) in BWD_CASES:
        def randn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)

        if name == "fused_qkv_bf16":
            qkv = randn(B, Sq, 3 * H * D)
            q, k, v = (t.reshape(B, Sq, H, D).transpose(1, 2)
                       for t in qkv.split(H * D, dim=-1))
            g = randn(B, Sq, H, D).transpose(1, 2)
        else:
            q, k, v = (randn(B, H, Sq, D), randn(B, H, Sk, D),
                       randn(B, H, Sk, D))
            g = randn(B, H, Sq, D)
        kw = dict(causal=causal, q_offset=qo, k_offset=ko)
        o, lse = flash_attention_fwd(q, k, v, **kw)
        got = flash_attention_bwd(q, k, v, o, lse, g, **kw)
        delta = flash_bwd_delta(o, g)
        torch.cuda.synchronize()
        plan = dict(tattn.LAST_BWD_PLAN)
        again = flash_attention_bwd(q, k, v, o, lse, g, **kw)
        delta_again = flash_bwd_delta(o, g)
        torch.cuda.synchronize()
        if not (all(torch.equal(a, b) for a, b in zip(got, again))
                and torch.equal(delta, delta_again)):
            raise AssertionError(f"{name}: a second call gave other bits")
        want = flash_attention_bwd_plain(q, k, v, o, lse, g, **kw)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        errs = {key: _check_close(f"{name} {key}", a, b, tol)
                for key, a, b in zip(("dq", "dk", "dv"), got, want)}
        errs["delta"] = _check_close(f"{name} delta", delta,
                                     flash_bwd_delta_plain(o, g), F32_TOL)
        if name == "fully_masked_f32":
            if not all(bool((t == 0).all()) for t in got):
                raise AssertionError("fully masked rows must give dq, dk, "
                                     "dv == 0")
        if plan["copied"]:
            raise AssertionError(f"{name}: the backward copied "
                                 f"{plan['copied']}; strided inputs with a "
                                 f"contiguous head dim go in as they are")

        # the library yardstick: the backward of scaled_dot_product_attention
        # with the same mask, on inputs that require grad
        lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
        if causal and qo == ko == 0 and Sq == Sk:
            lib_out = F.scaled_dot_product_attention(lq, lk, lv,
                                                     is_causal=True)
        else:
            mask = None
            if causal:
                mask = (torch.arange(Sq, device="cuda")[:, None] + qo
                        >= torch.arange(Sk, device="cuda")[None, :] + ko)
            lib_out = F.scaled_dot_product_attention(lq, lk, lv,
                                                     attn_mask=mask)
        fns = {
            "": lambda: flash_attention_bwd(q, k, v, o, lse, g, **kw),
            "plain_": lambda: flash_attention_bwd_plain(q, k, v, o, lse, g,
                                                        **kw),
            "library_": lambda: torch.autograd.grad(
                lib_out, (lq, lk, lv), g, retain_graph=True),
            "delta_plain_": lambda: flash_bwd_delta_plain(o, g),
        }
        times = {}
        for key, fn in fns.items():
            if key:
                times[key + "ms"] = _device_ms(fn, iters=5 if key ==
                                               "plain_" else 20)
            else:
                times["ms"], times["kernel_ms"] = _device_ms(
                    fn, part=BWD_KERNELS)
        pairs = B * H * _visible_pairs(Sq, Sk, causal, qo, ko)
        peak = f32_peak if dtype == torch.float32 else bf16_peak
        bounds = _bwd_bounds(B, H, Sq, Sk, D, q.element_size(), pairs, peak,
                             bw)
        rows.append({
            "case": name, "shape": [B, H, Sq, Sk, D],
            "dtype": str(dtype).replace("torch.", ""), "causal": causal,
            "q_offset": qo, "k_offset": ko, "plan": plan,
            "max_abs_err": errs, "tol": list(tol), **times,
            "bound_ms": bounds["op"][0], "bound_by": bounds["op"][1],
            "kernel_bounds": {k: list(v) for k, v in bounds.items()
                              if k != "op"},
        })
        kms = times["kernel_ms"]
        print(f"[kernel] flash_bwd {name}: grids dkdv={plan['grid_dkdv']} "
              f"dq={plan['grid_dq']} copied={plan['copied']}; max_abs_err "
              + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
              + f" (atol={tol[0]}, rtol={tol[1]}); repeat bitwise; "
              f"ms={times['ms']:.4f} (delta {kms['flash_bwd_delta']:.4f}, "
              f"dkdv {kms['flash_bwd_dkdv']:.4f}, dq "
              f"{kms['flash_bwd_dq']:.4f}) plain_ms={times['plain_ms']:.4f} "
              f"library_ms={times['library_ms']:.4f} bound_ms="
              f"{bounds['op'][0]:.5f} ({bounds['op'][1]}); per kernel bound "
              + " ".join(f"{k[10:]} {v[0]:.5f} ({v[1]})"
                         for k, v in bounds.items() if k != "op"),
              flush=True)
    return rows


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
    if any(launches[key] for key in BWD_KERNELS):
        raise AssertionError(f"the serving path launched backward kernels: "
                             f"{launches}")
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


# ------------------------------------------------------------- phase 6
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 1024, 10
PARITY_BATCH, PARITY_STEPS = 4, 3
# bf16 parity bar, relative on the loss: half a bf16 ulp (2^-9).  Flash and
# reference attention both run every GEMM in bf16 and round their outputs
# to bf16; the loss is a mean over 4096 tokens of an f32 log-softmax, so
# the two runs may differ by bf16 rounding inside attention, which averages
# out over the tokens, but an error of the kernels' own (a wrong mask, a
# wrong row, a lost scale) moves a loss near ln(50257) by far more
BF16_LOSS_RTOL = 2.0 ** -9
F32_LOSS_RTOL, F32_NORM_RTOL = 1e-5, 1e-4


def _train_batch(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (batch, TRAIN_SEQ))
            for k in ("input_ids", "targets")}


def train(card, card_label):
    """The training path: ShardedPretrainer on GPT-2-small (bf16, flash,
    no remat), as bench.py runs it on one device."""
    import dataclasses

    from ray_tpu_torch.models import GPT2Config, ShardedPretrainer
    from ray_tpu_torch.ops.attention import KERNEL_LAUNCHES

    cfg = GPT2Config(remat=False)
    trainer = ShardedPretrainer(cfg)
    batch = _train_batch(cfg, TRAIN_BATCH, 0)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[key] = 0
    losses, t_start = [], None
    for i in range(TRAIN_STEPS):
        if i == 2:  # steps 0 and 1 warm cuBLAS and the allocator
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        losses.append(trainer.step(batch))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t_start) / (TRAIN_STEPS - 2)
    launches = dict(KERNEL_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [t.item() for t in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    calls = cfg.n_layer * TRAIN_STEPS
    want = {"flash_fwd": calls, "flash_fwd_combine": 0,
            **{key: calls for key in BWD_KERNELS}}
    if launches != want:
        raise AssertionError(f"training launches {launches}, expected "
                             f"{want}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bf16_peak = _peaks(card)[1]
    mfu = 6 * n_params * tokens / step_s / bf16_peak
    D = cfg.n_embd // cfg.n_head
    attn_flops = (cfg.n_layer * TRAIN_BATCH * cfg.n_head * 14 * D
                  * _visible_pairs(TRAIN_SEQ, TRAIN_SEQ, True, 0, 0))
    print(f"[train] GPT-2-small ({n_params} params, bf16, flash, remat off)"
          f", batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps: "
          f"losses {[round(x, 4) for x in losses]}; step_ms="
          f"{step_s * 1e3:.3f} tokens_per_s={tokens / step_s:.1f} "
          f"peak_memory_gb={peak_gb:.3f} mfu={mfu:.4f} (6*N FLOPs a token "
          f"over {bf16_peak / 1e12:.0f} TFLOP/s, attention left out); "
          f"attention FLOPs a step {attn_flops / 1e9:.2f} G (4*D forward + "
          f"10*D backward a visible pair, = "
          f"{attn_flops / step_s / bf16_peak:.4f} of peak on its own); "
          f"launches {launches} on {card_label}", flush=True)

    # one traced step: where the device time goes
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    busy = sum(kernels.values())
    if busy <= 0:
        raise RuntimeError("the profiler traced no device time in the step")
    bwd = {k: t for k, t in kernels.items() if "flash_bwd" in k}
    fwd = sum(t for k, t in kernels.items() if "flash_fwd" in k)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
    trace = {"wall_ms": wall * 1e3, "busy_ms": busy,
             "idle_share": 1 - busy / (wall * 1e3),
             "flash_bwd_ms": sum(bwd.values()),
             "flash_bwd_share": sum(bwd.values()) / busy,
             "flash_fwd_ms": fwd,
             "top": [[k[:80], t] for k, t in top]}
    print(f"[train] traced step: wall_ms={trace['wall_ms']:.3f} "
          f"device_busy_ms={busy:.3f} (idle share {trace['idle_share']:.4f})"
          f"; flash backward kernels {trace['flash_bwd_ms']:.3f} ms "
          f"({trace['flash_bwd_share']:.4f} of busy: "
          + ", ".join(f"{k[:40]} {t:.3f}" for k, t in bwd.items())
          + f"), flash_fwd {fwd:.3f} ms; top kernels: "
          + "; ".join(f"{k[:70]} {t:.3f} ms" for k, t in top), flush=True)
    del trainer

    # parity against reference attention from the same init and batches
    batches = [_train_batch(cfg, PARITY_BATCH, 1 + i)
               for i in range(PARITY_STEPS)]
    par = {}
    for impl in ("flash", "reference"):
        t = ShardedPretrainer(dataclasses.replace(cfg, attention_impl=impl))
        par[impl] = [t.step(b).item() for b in batches]
        del t
    rel = max(abs(a - b) / abs(b) for a, b in zip(par["flash"],
                                                   par["reference"]))
    if rel > BF16_LOSS_RTOL:
        raise AssertionError(f"bf16 losses flash {par['flash']} vs "
                             f"reference {par['reference']}: rel {rel:.3e} "
                             f"> {BF16_LOSS_RTOL:.3e}")
    print(f"[train] bf16 parity, batch {PARITY_BATCH}, {PARITY_STEPS} steps:"
          f" flash {par['flash']} reference {par['reference']}, max rel "
          f"{rel:.3e} (bar {BF16_LOSS_RTOL:.3e})", flush=True)
    f32 = {}
    for impl in ("flash", "reference"):
        t = ShardedPretrainer(dataclasses.replace(
            cfg, attention_impl=impl, dtype=torch.float32))
        loss = t.step(batches[0]).item()
        f32[impl] = (loss, t.opt.last_grad_norm.item())
        del t
    (lf, nf), (lr_, nr) = f32["flash"], f32["reference"]
    if not (abs(lf - lr_) <= F32_LOSS_RTOL * abs(lr_)
            and abs(nf - nr) <= F32_NORM_RTOL * abs(nr)):
        raise AssertionError(f"f32 step flash (loss {lf}, grad norm {nf}) "
                             f"vs reference ({lr_}, {nr})")
    print(f"[train] f32 parity, one step at batch {PARITY_BATCH}, TF32 off: "
          f"loss flash {lf:.8f} reference {lr_:.8f} (rel "
          f"{abs(lf - lr_) / abs(lr_):.3e}, bar {F32_LOSS_RTOL}); grad norm "
          f"flash {nf:.8f} reference {nr:.8f} (rel "
          f"{abs(nf - nr) / abs(nr):.3e}, bar {F32_NORM_RTOL})", flush=True)
    return launches, {"step_ms": step_s * 1e3,
                      "tokens_per_s": tokens / step_s,
                      "peak_memory_gb": peak_gb, "mfu": mfu,
                      "attention_gflop_per_step": attn_flops / 1e9,
                      "losses": losses, "trace": trace,
                      "parity_bf16": par, "parity_f32": f32}


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
    # 3b. the backward kernels
    bwd_rows = backward_cases(card)

    # 4. model at full width
    model_forward(random_flax_params(GPT2Config.small(), seed=0))

    # 5. and 6. the main paths, each with its counters set to 0 just before
    serve_launches = serve(f"{card} ({smi})")
    train_launches, training = train(card, f"{card} ({smi})")

    # 7. kernels line, card line, result line
    def launches(key):
        return {"launches": serve_launches[key] + train_launches[key],
                "launches_by_path": {"serve": serve_launches[key],
                                     "train": train_launches[key]}}

    main_row = next(r for r in rows if r["case"] == MAIN_PATH_CASE)
    kernel = {
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:66", **launches("flash_fwd"),
        **{key: main_row[key] for key in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "shape": main_row["case"], "pass": True, "cases": rows,
    }
    combine = {
        "name": "flash_fwd_combine", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:126",
        **launches("flash_fwd_combine"),
        **{key: combine_row[key] for key in
           ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
        "shape": combine_row["case"], "splits": combine_row["splits"],
        "pass": True,
    }
    train_row = next(r for r in bwd_rows if r["case"] == TRAIN_CASE)
    errs = train_row["max_abs_err"]
    backward = []
    for name, err in (("flash_bwd_delta", errs["delta"]),
                      ("flash_bwd_dkdv", max(errs["dk"], errs["dv"])),
                      ("flash_bwd_dq", errs["dq"])):
        bound, bound_by = train_row["kernel_bounds"][name]
        delta = name == "flash_bwd_delta"
        backward.append({
            "name": name, "route": "cuda",
            "source": "ray_tpu_torch/csrc/flash_bwd.cu",
            "replaces": "ray_tpu/ops/attention.py:189", **launches(name),
            "max_abs_err": err, "ms": train_row["kernel_ms"][name],
            # the plain version of delta on its own; dK/dV and dQ have one
            # plain version together, flash_attention_bwd_plain
            "plain_ms": train_row["delta_plain_ms" if delta else "plain_ms"],
            "bound_ms": bound, "bound_by": bound_by,
            # dq, dk, dv together: the backward of scaled_dot_product_attention
            "library_ms": None if delta else train_row["library_ms"],
            "shape": TRAIN_CASE, "pass": True,
        })
    # the whole backward op, and every case of phase 3b, on the last entry
    backward[-1].update(op_ms=train_row["ms"],
                        op_bound_ms=train_row["bound_ms"], cases=bwd_rows)
    print("[train] result " + json.dumps(training), flush=True)
    print(json.dumps({"kernels": [kernel, combine, *backward]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
