#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ray_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: the card's name and power limit, CUDA/torch versions; TF32 off
     so that f32 comparisons are f32;
  2. build: every kernel source in ray_tpu_torch/csrc (flash_fwd.cu,
     flash_bwd.cu), one nvcc each, in parallel, with each kernel's registers
     and spills from ptxas (a D = 64 tensor-core backward kernel must not
     spill); then the SASS of every bf16 tensor-core kernel (the forward,
     dK/dV and dQ) must hold wgmma (HGMMA) and TMA loads (UTMALDG), counted
     with cuobjdump;
  3. forward kernels: each against its plain PyTorch version on the card at
     the shapes the serving path gives it (and the JAX suite's cases), with
     the plan it chose (variant, KV splits), and at phase 6f's
     microbatches (GPT2LMModel's fused q/k/v layout at batch 4 and 2 in
     bf16, batch 1 in f32), times beside the plain version,
     one library call and the card's bound; no case launches the combine
     kernel, and every case with KV splits (merged by the launch's last
     CTAs) gives o and lse bit for bit equal to the standalone combine
     kernel's on the very partials that launch merged, and to a repeat;
     then the standalone combine kernel against its plain version at the
     serving decode's partials;
  3b. backward kernels (dQ, which also writes delta, then dK/dV) against
     flash_attention_bwd_plain on the forward kernel's o and lse, at the
     training path's shape and thirteen more cases (phase 6f's
     microbatches among them): the variant each took
     (tensor cores for bf16 at D 64 and 128), nothing copied, each result
     repeated bit for bit, the delta dQ wrote bit for bit the standalone
     delta kernel's, no delta launch; at the training shape, at D = 128
     and at phase 6f's pp = 4 microbatch the kernels' error against the f32 backward of f32 upcasts at most
     1.5x that of autograd through bf16 mha_reference; device time in total
     and per kernel (the standalone delta kernel on its own), the plain
     version, the backward of scaled_dot_product_attention as the library
     yardstick, and the bound;
  4. model: full-width GPT-2-small logits, flash against reference
     attention, in f32 and at the model's default bf16; then the serving
     runner's prefill against the model;
  5. serving (a main path): EngineCore at GPT-2-small width serves 8
     greedy requests with chunked prefill; every kernel launch counter is
     set to 0 just before and read just after, and the forward kernels must
     have run (flash_fwd once per attention call, split launches merging in
     the kernel, flash_fwd_combine never);
  6. training (a main path): ShardedPretrainer takes 10 steps of
     GPT-2-small (bf16, flash, no remat) at batch 16 x 1024 on one seeded
     batch; losses finite and falling; every counter set to 0 just before
     and read just after (flash_fwd, dK/dV and dQ 12 per step, delta in
     every dQ launch, no combine or delta launch); step time, tokens/s,
     peak memory, MFU, a traced step;
     then loss parity against reference attention in bf16 (3 steps at
     batch 4) and in f32 (one step, loss and gradient norm);
  6e. MoE training (a main path; runs after phase 6): ShardedPretrainer
     takes 10 steps of GPT-2-small with routed experts in every second
     block (the JAX package's defaults: 8 experts, top-2, capacity factor
     1.25; bf16, flash, no remat) at batch 16 x 1024 on one seeded batch;
     the checks and counters of phase 6, step time, tokens/s, peak memory,
     MFU over the active parameters, a traced step; a checkpoint saved and
     restored into a fresh trainer, whose next loss must equal the
     uninterrupted trainer's bit for bit; parity against reference
     attention as in phase 6, with the count of routing choices that
     differ between the two runs;
  6b. Llama training (a main path): ShardedPretrainer(LlamaConfig(),
     MeshConfig()) takes 10 steps at the default config (12 layers, 768
     wide, 12 heads, 4 KV heads, SwiGLU 2048, vocab 32000, bf16, flash,
     remat "full") at batch 8 x 2048; the same checks, with flash_fwd 24
     launches a step (12 forward, 12 recomputed) and dK/dV and dQ 12; bf16
     parity against reference attention over 3 steps at batch 2 and the
     f32 step (loss 1e-5, gradient norm 1e-4 relative); the lm_head GEMMs
     timed alone at Llama's vocab (32000) and GPT-2's (50257); a traced
     step (idle share, top kernels) and a second one with the host side
     traced, for the device time of each op that launched kernels;
  6c. the mesh (a main path): torch.cuda.device_count() on its own line;
     phase 6's run again through the DTensor path on a one-rank NCCL mesh
     (losses within phase 6's bf16 bar of phase 6's, launches as phase 6,
     step time beside phase 6's, a traced step's idle share); where the
     machine has the cards, NCCL ranks take phase 6's f32 step under dp=2,
     tp=2, sp=2 and pp=2 (two cards; sp through ring attention, pp
     through PipelinedPretrainer) and tp=2 x fsdp=2, sp=2 x tp=2 and
     pp=2 x tp=2 (four cards), and phase 6e's under ep=2 (two cards) and
     ep=2 x tp=2 (four), each rank within 1e-5 (loss) and 1e-4 (gradient
     norm) relative of the one-card step (a pipeline's replicated
     parameters bitwise equal on every rank), and phase 6's bf16 run under
     sp=2 and under pp=2 (two cards: losses within phase 6's bf16 bar,
     step time beside phase 6's); a line for each case that did not run.
     ``python3 chip_smoke.py --multi-card [AXIS]`` builds the kernels and
     runs only the one-card f32 steps and bf16 run and these cases (with
     AXIS, only those with more than one rank on it);
     ``python3 chip_smoke.py --gloo-gang`` runs these cases' f32 steps on
     a gloo gang of CPU processes at tiny widths instead (no kernel): the
     machine's torch on their DTensor path where the cards are missing;
  6d. ring attention on one card (a main path: NCCL puts no two ranks on
     one card, so one process runs every ring position's steps, the
     functions ``ring_attention`` runs on each rank): GPT-2-small's and
     Llama's training shapes in bf16 at sp 2 and 4, an f32 case and a
     bf16 case at D 32 (the CUDA-core kernels) at sp 4, forward and
     backward against whole-sequence flash; f32 within
     1e-5 (o) and 1e-4 (dq, dk, dv) of it relative to its largest
     element, bf16 at most 2x as far as whole-sequence bf16 flash from the
     f32 result of f32 upcasts; every counter set to 0 just before and
     read just after (flash_fwd, dQ and dK/dV sp(sp+1)/2 each, no combine
     or delta launch); the device time summed over the positions beside
     whole-sequence flash's;
  6f. the pipeline on one card (a main path: one process runs every pp
     position's ticks, the step functions ``pipeline_apply`` runs on each
     rank): PipelinedPretrainer without a process group trains
     GPT-2-small (bf16, flash, no remat) 10 steps at phase 6's batch from
     phase 6's parameters at pp 2 (M 4) and pp 4 (M 8); losses finite,
     falling and within phase 6's bf16 bar of phase 6's; every counter set
     to 0 just before and read just after (flash_fwd, dQ and dK/dV
     n_layer x M a step, K x M a step at each position, no combine or
     delta launch); step time beside phase 6's (the cost of microbatching
     in one process, not a pipeline speed), peak memory, a traced step's
     idle share; the f32 step at batch 4 (M 4) within 1e-5 (loss) and
     1e-4 (gradient norm) of phase 6's;
  6g. the runtime (a main path): ray_tpu_torch.init() (the node must
     advertise as much "GPU" as torch sees cards); phase 6's initial f32
     parameters put in the object store once, as CPU tensors; TorchTrainer
     with one GPU worker actor runs phase 6's bf16 run from them
     (train.report every step): losses within phase 6's bf16 bar of phase
     6's (and whether bit for bit), the worker's counters set to 0 just
     before its steps and read just after (flash_fwd, dQ and dK/dV 120
     each, no combine or delta launch), step ms from the worker's clock
     beside phase 6's, the worker's card and PCI bus id, no jax or
     ray_tpu module and no kernel build in the worker; then the same run
     under FailureConfig(max_failures=1) failing on purpose after its
     step-5 checkpoint (ShardedPretrainer.save_checkpoint), which must
     resume at step 5 and end on the first run's last loss bit for bit.
     TorchTrainer's multi-card cases, trainer-dp2 (two cards) and
     trainer-tp2-fsdp2 (four), bring up NCCL themselves and take phase 6's
     f32 step, each rank within 1e-5 (loss) and 1e-4 (norm) of the
     one-card step on a card of its own; they run in phase 6c where the
     cards are, with ``--multi-card`` (``--multi-card trainer``: only
     they), and on CPU worker actors (gloo) with ``--gloo-gang``;
  7. the kernels line, then the card line, then the result line.

Needs a CUDA card: without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import importlib.util
import json
import os
import queue
import re
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


def _device_ms(fn, iters: int = 20, part=None, launches: int = 0):
    """Device time per call: the summed time of every kernel ``fn`` runs on
    the card, traced by torch.profiler (CUPTI), over ``iters`` calls.  With
    ``part``, also the share of the kernels whose name holds ``part`` (a
    name, or a tuple of names for a dict of shares).  With ``launches``,
    the number of those kernels' launches a call: a trace that holds fewer
    (CUPTI dropped records) is taken again, and after three such traces
    both numbers are None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    names = part if isinstance(part, tuple) else (part,) if part else ()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # CUPTI now and then hands back an empty trace, or one without some of
    # the launches; the work is the same each time, so trace it again (at
    # most three times)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in events)
        traced = sum(e.count for e in events
                     if any(name in e.key for name in names))
        if us > 0 and traced >= launches * iters:
            break
    else:
        if launches:
            print(f"[timing] the profiler traced {traced} of "
                  f"{launches * iters} launches three times: not measured",
                  flush=True)
            return None, None
        if part is not None:
            raise RuntimeError("the profiler traced no device time")
        # the whole call's time on the card's stream stands in for the sum
        # of its kernels' times
        ms = _time_ms(fn, iters)
        print(f"[timing] the profiler traced no device time three times; "
              f"CUDA events give {ms:.5f} ms a call", flush=True)
        return ms
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
    # LlamaLMModel's training shape at its default config (phase 6b)
    ("llama_train_bf16", torch.bfloat16, 8, 12, 2048, 2048, 64, True, 0, 0),
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
    # phase 6f's microbatches in GPT2LMModel's layout: pp = 2 (M = 4) and
    # pp = 4 (M = 8) at batch 16 in bf16, and its f32 step (batch 4, M = 4)
    ("pipeline_pp2_fused_qkv_bf16", torch.bfloat16, 4, 12, 1024, 1024, 64,
     True, 0, 0),
    ("pipeline_pp4_fused_qkv_bf16", torch.bfloat16, 2, 12, 1024, 1024, 64,
     True, 0, 0),
    ("pipeline_fused_qkv_f32", torch.float32, 1, 12, 1024, 1024, 64, True,
     0, 0),
]
FUSED_QKV_CASES = {"gpt2_fused_qkv_bf16", "pipeline_pp2_fused_qkv_bf16",
                   "pipeline_pp4_fused_qkv_bf16", "pipeline_fused_qkv_f32"}
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
        if plan["num_splits"] > 1:
            _fused_matches_combine(name, q, k, v, kw, o, lse, plan)

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
                times["ms"], combine_ms = _device_ms(
                    fn, part="flash_fwd_combine")
                if combine_ms:
                    raise AssertionError(f"{name}: the forward launched the "
                                         f"combine kernel")
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
              f"(atol={tol[0]}, rtol={tol[1]})"
              + (" merged in-kernel, bitwise the combine kernel's"
                 if plan["num_splits"] > 1 else "")
              + f"; ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{library_ms:.4f} bound_ms={rows[-1]['bound_ms']:.5f} "
              f"({rows[-1]['bound_by']}); per call on the stream: kernel "
              f"{times['call_ms']:.4f} plain {times['plain_call_ms']:.4f} "
              f"library {times['library_call_ms']:.4f}", flush=True)
    return rows


def _fused_matches_combine(name, q, k, v, kw, o, lse, plan):
    """A split launch's o and lse, merged by its last CTAs, against the
    standalone combine kernel run on the very partials that launch merged:
    bit for bit; and against the case's first launch (``o``, ``lse``): a
    repeat gives the same bits."""
    from ray_tpu_torch.ops import attention as tattn

    o1, lse1, part = tattn._flash_fwd_cuda(
        q, k, v, kw["causal"], float(q.shape[-1] ** -0.5), kw["q_offset"],
        kw["k_offset"], partials=True)
    if tattn.LAST_PLAN != plan or part is None:
        raise AssertionError(f"{name}: the helper took another plan: "
                             f"{tattn.LAST_PLAN} against {plan}")
    o2, lse2 = tattn.flash_fwd_combine(*part, dtype=q.dtype)
    torch.cuda.synchronize()
    if not (torch.equal(o1, o2) and torch.equal(lse1, lse2)):
        raise AssertionError(
            f"{name}: the in-kernel merge differs from the combine kernel on "
            f"the same partials: o {(o1.float() - o2.float()).abs().max()}, "
            f"lse {(lse1 - lse2).abs().max()}")
    if not (torch.equal(o1, o) and torch.equal(lse1, lse)):
        raise AssertionError(f"{name}: a second split launch gave other bits")


# the serving decode's split-KV partials: 12 heads, 10 splits, one row
COMBINE_CASE = ("serve_decode_f32", torch.float32, 1, 12, 1, 600, 64, 599)


def combine_case(card):
    """The standalone combine kernel against ``merge_partials_plain`` on
    the partials that the serving decode produces, at the shapes the main
    path gives it; then the split forward launch that merges in its last
    CTAs, on the same q, k, v: its o against ``merge_partials_plain`` on
    the partials it merged (the fused merge's error) and its time."""
    from ray_tpu_torch.ops import attention as tattn
    from ray_tpu_torch.ops.attention import (
        KERNEL_BLOCK_K,
        flash_attention_fwd,
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

    # the same merge in the split launch's last CTAs (bit for bit the
    # combine kernel's: phase 3's split cases), against the plain merge of
    # the partials that launch wrote
    kw = dict(causal=True, q_offset=qo, k_offset=0)
    o_f, lse_f, kpart = tattn._flash_fwd_cuda(q, k, v, True, D ** -0.5, qo, 0,
                                              partials=True)
    if tattn.LAST_PLAN["num_splits"] != splits:
        raise AssertionError(f"the forward took {tattn.LAST_PLAN}, not "
                             f"{splits} splits")
    o_ref, lse_ref = merge_partials_plain(*kpart, dtype=dtype)
    fused_err = _check_close("in-kernel merge", o_f, o_ref, F32_TOL)
    _check_close("in-kernel merge lse", lse_f, lse_ref, F32_TOL)
    fused_ms = _device_ms(lambda: flash_attention_fwd(q, k, v, **kw))
    print(f"[kernel] flash_fwd_combine {name} partials (B*H={B * H}, "
          f"splits={splits}, Sq={Sq}, D={D}): max_abs_err={err:.3e} "
          f"(atol={F32_TOL[0]}, rtol={F32_TOL[1]}) ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f} bound_ms={bound_ms:.6f} (bytes); merged "
          f"in the split launch: max_abs_err={fused_err:.3e} against the "
          f"plain merge of its partials, split launch ms={fused_ms:.5f}",
          flush=True)
    return {"case": name, "splits": splits, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "fused_max_abs_err": fused_err,
            "fused_launch_ms": fused_ms}


# ------------------------------------------------------------ phase 3b
BWD_CASES = [
    # name, dtype, B, H, Sq, Sk, D, causal, q_offset, k_offset
    ("train_bf16", torch.bfloat16, 16, 12, 1024, 1024, 64, True, 0, 0),
    ("train_f32", torch.float32, 4, 12, 1024, 1024, 64, True, 0, 0),
    ("llama_train_bf16", torch.bfloat16, 8, 12, 2048, 2048, 64, True, 0, 0),
    ("unaligned_noncausal_f32", torch.float32, 2, 12, 200, 200, 64, False,
     0, 0),
    ("chunk_offset_f32", torch.float32, 1, 12, 128, 512, 64, True, 384, 0),
    ("d128_causal_bf16", torch.bfloat16, 1, 8, 1024, 1024, 128, True, 0, 0),
    ("fully_masked_f32", torch.float32, 1, 12, 64, 64, 64, True, 0, 1000),
    # q/k/v as views of one (B, S, 3E) tensor and g as the (B, H, S, D)
    # view of a (B, S, H, D) tensor: GPT2LMModel's training layout
    ("fused_qkv_bf16", torch.bfloat16, 4, 12, 1024, 1024, 64, True, 0, 0),
    # the tensor-core kernels' ragged edges, offsets and dead rows
    ("unaligned_noncausal_bf16", torch.bfloat16, 2, 12, 200, 200, 64, False,
     0, 0),
    ("chunk_offset_bf16", torch.bfloat16, 1, 12, 128, 512, 64, True, 384, 0),
    ("fully_masked_bf16", torch.bfloat16, 1, 12, 64, 64, 64, True, 0, 1000),
    # bf16 on the CUDA-core kernels (D 32)
    ("d32_causal_bf16", torch.bfloat16, 2, 12, 512, 512, 32, True, 0, 0),
    # phase 6f's microbatches at pp = 4 (M = 8) in bf16 and its f32 step
    # (batch 4, M = 4), in the training layout; pp = 2's is fused_qkv_bf16
    ("pipeline_pp4_fused_qkv_bf16", torch.bfloat16, 2, 12, 1024, 1024, 64,
     True, 0, 0),
    ("pipeline_fused_qkv_f32", torch.float32, 1, 12, 1024, 1024, 64, True,
     0, 0),
]
BWD_FUSED_QKV_CASES = {"fused_qkv_bf16", "pipeline_pp4_fused_qkv_bf16",
                       "pipeline_fused_qkv_f32"}
BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq")
# the training path's own shape
TRAIN_CASE = "train_bf16"
# cases held to the bf16 accuracy bar (_bf16_accuracy)
ACCURACY_CASES = {"train_bf16", "llama_train_bf16", "d128_causal_bf16",
                  "pipeline_pp4_fused_qkv_bf16"}


def _bwd_bounds(B, H, Sq, Sk, D, esize, pairs, peak, bw):
    """Least device time (ms, and what bounds it) of the whole backward and
    of each kernel's function: every input read once, every output written
    once; 2*D flops per visible pair for each of S, dP, dV, dK and dQ that
    the function needs (the two-kernel design's recomputed S and dP are not
    counted).  dQ computes delta too: it reads o and writes delta, and
    dK/dV reads delta; the standalone delta kernel's own bound is beside."""
    q_bytes, k_bytes = B * H * Sq * D * esize, B * H * Sk * D * esize
    row_bytes = 4 * B * H * Sq  # lse or delta
    work = {  # bytes, flops
        "op": (3 * q_bytes + 2 * k_bytes + row_bytes + q_bytes + 2 * k_bytes,
               10 * D * pairs),
        "flash_bwd_delta": (2 * q_bytes + row_bytes, 2 * D * B * H * Sq),
        "flash_bwd_dkdv": (2 * q_bytes + 2 * k_bytes + 2 * row_bytes
                           + 2 * k_bytes, 8 * D * pairs),
        "flash_bwd_dq": (3 * q_bytes + 2 * k_bytes + 2 * row_bytes + q_bytes,
                         6 * D * pairs + 2 * D * B * H * Sq),
    }
    out = {}
    for key, (nbytes, flops) in work.items():
        t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
        out[key] = (max(t_bytes, t_ops),
                    "bytes" if t_bytes >= t_ops else "operations")
    return out


def _bf16_accuracy(name, q, k, v, o, lse, g, got, kw):
    """Max error of the kernels' (dq, dk, dv) against the f32 backward of
    f32 upcasts of the same inputs (o and lse included), beside that of
    autograd through bf16 ``mha_reference``.  The kernels round P and dS to
    bf16 before three of their products; the bar, phase 4's for the
    forward, is that they add no error beyond bf16's: at most 1.5x the
    reference's, gradient by gradient."""
    from ray_tpu_torch.ops.attention import (
        flash_attention_bwd_plain,
        mha_reference,
    )

    exact = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                      o.float(), lse, g.float(), **kw)
    lq, lk, lv = (t.detach().requires_grad_() for t in (q, k, v))
    ref = torch.autograd.grad(mha_reference(lq, lk, lv, **kw), (lq, lk, lv),
                              g)
    out = {}
    for key, a, r, x in zip(("dq", "dk", "dv"), got, ref, exact):
        out[key] = ((a.float() - x).abs().max().item(),
                    (r.float() - x).abs().max().item())
        if not out[key][0] <= 1.5 * out[key][1]:
            raise AssertionError(f"{name} {key}: the kernels are "
                                 f"{out[key][0]:.3e} from the f32 backward, "
                                 f"bf16 mha_reference's autograd "
                                 f"{out[key][1]:.3e} (bar 1.5x)")
    return out


def backward_cases(card):
    """The backward's two launches (dQ with delta, then dK/dV) against
    ``flash_attention_bwd_plain``, and the delta dQ wrote against the
    standalone delta kernel (bit for bit) and ``flash_bwd_delta_plain``, on
    the forward kernel's o and lse."""
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

        if name in BWD_FUSED_QKV_CASES:
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
        torch.cuda.synchronize()
        plan = dict(tattn.LAST_BWD_PLAN)
        *again, delta = tattn._flash_bwd_cuda(
            q, k, v, o, lse, g, causal, float(D ** -0.5), qo, ko,
            return_delta=True)
        alone = flash_bwd_delta(o, g)
        alone_again = flash_bwd_delta(o, g)
        torch.cuda.synchronize()
        if not (all(torch.equal(a, b) for a, b in zip(got, again))
                and torch.equal(alone, alone_again)):
            raise AssertionError(f"{name}: a second call gave other bits")
        if not torch.equal(delta, alone):
            raise AssertionError(
                f"{name}: the delta dQ wrote differs from the delta kernel's "
                f"by {(delta - alone).abs().max().item():.3e}")
        want = flash_attention_bwd_plain(q, k, v, o, lse, g, **kw)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        errs = {key: _check_close(f"{name} {key}", a, b, tol)
                for key, a, b in zip(("dq", "dk", "dv"), got, want)}
        errs["delta"] = _check_close(f"{name} delta", delta,
                                     flash_bwd_delta_plain(o, g), F32_TOL)
        if name.startswith("fully_masked"):
            if not all(bool((t == 0).all()) for t in got):
                raise AssertionError("fully masked rows must give dq, dk, "
                                     "dv == 0")
        if plan["copied"]:
            raise AssertionError(f"{name}: the backward copied "
                                 f"{plan['copied']}; strided inputs with a "
                                 f"contiguous head dim go in as they are")
        variant = ("wgmma" if dtype == torch.bfloat16 and D in (64, 128)
                   else "simt")
        if plan["variant"] != variant:
            raise AssertionError(f"{name}: the backward took the "
                                 f"{plan['variant']} kernels, not {variant}")
        accuracy = (_bf16_accuracy(name, q, k, v, o, lse, g, got, kw)
                    if name in ACCURACY_CASES else None)

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
            "delta_kernel_": lambda: flash_bwd_delta(o, g),
        }
        times = {}
        for key, fn in fns.items():
            if key:
                times[key + "ms"] = _device_ms(fn, iters=5 if key ==
                                               "plain_" else 20)
            else:
                times["ms"], times["kernel_ms"] = _device_ms(
                    fn, part=BWD_KERNELS)
        kms = times["kernel_ms"]
        if kms["flash_bwd_delta"]:
            raise AssertionError(f"{name}: the backward launched the delta "
                                 f"kernel")
        # the delta kernel's time is its standalone launch's
        kms["flash_bwd_delta"] = times["delta_kernel_ms"]
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
            "ms_over_bound": times["ms"] / bounds["op"][0],
            "kernel_bounds": {k: list(v) for k, v in bounds.items()
                              if k != "op"},
            "kernel_ms_over_bound": {k: kms[k] / bounds[k][0]
                                     for k in BWD_KERNELS},
            "bf16_accuracy": accuracy,
        })
        acc_text = "" if accuracy is None else (
            "; accuracy vs the f32 backward, kernels / bf16 mha_reference "
            "autograd: " + " ".join(f"{k} {a:.3e}/{r:.3e}"
                                    for k, (a, r) in accuracy.items())
            + " (bar 1.5x)")
        print(f"[kernel] flash_bwd {name}: variant={plan['variant']} grids "
              f"dkdv={plan['grid_dkdv']} dq={plan['grid_dq']} copied="
              f"{plan['copied']}; max_abs_err "
              + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
              + f" (atol={tol[0]}, rtol={tol[1]}); repeat bitwise, delta "
              f"from dQ bitwise the delta kernel's{acc_text}; "
              f"ms={times['ms']:.5f} (dq with delta "
              f"{kms['flash_bwd_dq']:.5f}, dkdv {kms['flash_bwd_dkdv']:.5f}; "
              f"the delta kernel alone {kms['flash_bwd_delta']:.5f}) "
              f"plain_ms={times['plain_ms']:.4f} "
              f"library_ms={times['library_ms']:.5f} bound_ms="
              f"{bounds['op'][0]:.5f} ({bounds['op'][1]}), ms/bound "
              f"{rows[-1]['ms_over_bound']:.2f}; per kernel bound "
              + " ".join(f"{k[10:]} {v[0]:.5f} ({v[1]}, ms/bound "
                         f"{rows[-1]['kernel_ms_over_bound'][k]:.2f})"
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


def _kernel_name(mangled: str) -> str:
    """``flash_bwd_dq_wgmma<64>`` or ``flash_fwd_simt<bf16,32>`` for the
    mangled name of one of the port's (template) kernels."""
    m = re.search(r"\d(flash_[a-z_]*[a-z])I(.*?)Ev", mangled)
    if m is None:
        return mangled
    args = ["bf16" if "nv_bfloat16" in a else "f32" if a == "f" else a[2:]
            for a in re.findall(r"13__nv_bfloat16|Li\d+|^f", m.group(2))]
    return f"{m.group(1)}<{','.join(args)}>"


# the bf16 tensor-core kernels: each must hold wgmma and TMA loads, two
# instances (D 64 and 128) of each
TC_KERNELS = ("flash_fwd_wgmma", "flash_bwd_dkdv_wgmma",
              "flash_bwd_dq_wgmma")


def sass_check(libs) -> dict:
    """Counts of HGMMA (wgmma) and UTMALDG (TMA load) instructions in each
    kernel of the libraries; fails unless every bf16 tensor-core kernel has
    both."""
    counts = {}
    for lib_path in libs.values():
        out = subprocess.run([_cuobjdump(), "-sass", str(lib_path)],
                             capture_output=True, text=True,
                             check=True).stdout
        fn = None
        for line in out.splitlines():
            if "Function :" in line:
                fn = _kernel_name(line.split("Function :", 1)[1].strip())
                counts[fn] = {"HGMMA": 0, "UTMALDG": 0}
            elif fn is not None:
                for op in ("HGMMA", "UTMALDG"):
                    counts[fn][op] += op in line
    for f, c in sorted(counts.items()):
        print(f"[build] SASS {f}: HGMMA={c['HGMMA']} UTMALDG={c['UTMALDG']}")
    tc = {f: c for f, c in counts.items() if f.split("<")[0] in TC_KERNELS}
    if (sorted(f.split("<")[0] for f in tc) != sorted(TC_KERNELS * 2)
            or any(c["HGMMA"] == 0 or c["UTMALDG"] == 0
                   for c in tc.values())):
        raise AssertionError(f"a bf16 tensor-core kernel is missing or "
                             f"lacks wgmma or TMA loads in its SASS: {tc}")
    return tc


def ptxas_report(logs) -> dict:
    """Registers and spilled bytes of every kernel, from the ptxas reports
    of the build; fails if a D = 64 tensor-core backward kernel (the
    training path's) spills."""
    report, fn = {}, None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"(?:Function properties for |Compiling entry "
                          r"function ')([^' ]+)", line)
            if m:
                fn = _kernel_name(m.group(1))
                report.setdefault(fn, {})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn is not None:
                report[fn]["spill_stores"] = int(m.group(1))
                report[fn]["spill_loads"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None:
                report[fn]["registers"] = int(m.group(1))
    for f, r in sorted(report.items()):
        print(f"[build] ptxas {f}: registers={r.get('registers')} "
              f"spill_stores={r.get('spill_stores')} "
              f"spill_loads={r.get('spill_loads')}")
    train = [f for f in report if f in ("flash_bwd_dkdv_wgmma<64>",
                                        "flash_bwd_dq_wgmma<64>")]
    if len(train) != 2 or any(report[f].get("spill_stores", 1)
                              or report[f].get("spill_loads", 1)
                              for f in train):
        raise AssertionError(f"the D = 64 tensor-core backward kernels must "
                             f"be reported without spills: "
                             f"{ {f: report[f] for f in train} }")
    return report


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


def _zero_counts():
    from ray_tpu_torch.ops.attention import FUSED_LAUNCHES, KERNEL_LAUNCHES

    for counts in (KERNEL_LAUNCHES, FUSED_LAUNCHES):
        for key in counts:
            counts[key] = 0


def _read_counts() -> dict:
    """Every kernel's launches, and as ``fused:<name>`` the launches of
    another kernel that did that kernel's job inside it."""
    from ray_tpu_torch.ops.attention import FUSED_LAUNCHES, KERNEL_LAUNCHES

    return {**KERNEL_LAUNCHES,
            **{"fused:" + k: n for k, n in FUSED_LAUNCHES.items()}}


def serve(card_label):
    cfg, lengths, prompts, params, engine = serving_workload()

    def run(trace=False):
        core = engine()
        torch.cuda.synchronize()
        _zero_counts()
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
        launches = _read_counts()
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
    if launches["flash_fwd_combine"] or not (
            0 < launches["fused:flash_fwd_combine"] <= calls):
        raise AssertionError(f"launches {launches}: the split-KV path did "
                             f"not run merged in the kernel on the main path")
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
          f"{calls // cfg.n_layer} sequence passes), split launches "
          f"merged in-kernel={launches['fused:flash_fwd_combine']}, "
          f"flash_fwd_combine_launches={launches['flash_fwd_combine']} on "
          f"{card_label}",
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

    cfg = GPT2Config(remat=False)
    trainer = ShardedPretrainer(cfg)
    batch = _train_batch(cfg, TRAIN_BATCH, 0)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, t_start = [], None
    for i in range(TRAIN_STEPS):
        if i == 2:  # steps 0 and 1 warm cuBLAS and the allocator
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        losses.append(trainer.step(batch))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t_start) / (TRAIN_STEPS - 2)
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [t.item() for t in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    calls = cfg.n_layer * TRAIN_STEPS
    # every dQ launch computes delta; no launch splits the KV axis
    want = {"flash_fwd": calls, "flash_fwd_combine": 0, "flash_bwd_delta": 0,
            "flash_bwd_dkdv": calls, "flash_bwd_dq": calls,
            "fused:flash_fwd_combine": 0, "fused:flash_bwd_delta": calls}
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


# ------------------------------------------------------------ phase 6b
def _trace_step(step, by_op: bool = False):
    """One call of ``step`` traced by torch.profiler: (wall ms, device busy
    ms, device ms of each kernel, and with ``by_op`` the device ms each
    CPU-side op launched itself)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if by_op else [])
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels, ops = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = e.self_device_time_total / 1e3
        elif e.self_device_time_total > 0:
            ops[e.key] = e.self_device_time_total / 1e3
    busy = sum(kernels.values())
    if busy <= 0:
        raise RuntimeError("the profiler traced no device time in the step")
    return wall, busy, kernels, ops


LLAMA_BATCH, LLAMA_SEQ, LLAMA_PARITY_BATCH = 8, 2048, 2


def _llama_batch(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (batch, LLAMA_SEQ))
            for k in ("input_ids", "targets")}


def lm_head_gemms(vocab: int, tokens: int, width: int = 768) -> dict:
    """Device ms of the lm_head's three bf16 GEMMs of a training step
    (logits, the input's gradient, the weight's gradient) at ``vocab``
    and ``tokens``, each with the share of cuBLAS kernels named
    ``align1`` (taken when a dim is not a multiple of 8)."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    x, w, g = randn(tokens, width), randn(vocab, width), randn(tokens, vocab)
    out = {}
    for name, fn in (("logits", lambda: F.linear(x, w)),
                     ("grad_input", lambda: g @ w),
                     ("grad_weight", lambda: g.t() @ x)):
        out[name], out[name + "_align1"] = _device_ms(fn, part="align1")
    out["total"] = out["logits"] + out["grad_input"] + out["grad_weight"]
    return out


def train_llama(card, card_label):
    """The Llama training path: ShardedPretrainer on LlamaConfig() (bf16,
    flash, remat "full") on one card."""
    import dataclasses

    from ray_tpu_torch.models import LlamaConfig, ShardedPretrainer
    from ray_tpu_torch.parallel import MeshConfig

    cfg = LlamaConfig()
    trainer = ShardedPretrainer(cfg, MeshConfig())
    batch = _llama_batch(cfg, LLAMA_BATCH, 0)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, t_start = [], None
    for i in range(TRAIN_STEPS):
        if i == 2:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        losses.append(trainer.step(batch))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t_start) / (TRAIN_STEPS - 2)
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [t.item() for t in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"Llama losses not finite and falling: "
                             f"{losses}")
    calls = cfg.n_layer * TRAIN_STEPS
    # remat "full": each layer's forward runs again in the backward
    want = {"flash_fwd": 2 * calls, "flash_fwd_combine": 0,
            "flash_bwd_delta": 0, "flash_bwd_dkdv": calls,
            "flash_bwd_dq": calls, "fused:flash_fwd_combine": 0,
            "fused:flash_bwd_delta": calls}
    if launches != want:
        raise AssertionError(f"Llama training launches {launches}, "
                             f"expected {want}")
    tokens = LLAMA_BATCH * LLAMA_SEQ
    bf16_peak = _peaks(card)[1]
    mfu = 6 * n_params * tokens / step_s / bf16_peak
    print(f"[train_llama] LlamaConfig() ({n_params} params, {cfg.n_layer} "
          f"layers, d_model {cfg.d_model}, {cfg.n_head} heads, "
          f"{cfg.n_kv_head} KV heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, bf16, flash, remat {cfg.remat_policy}), batch "
          f"{LLAMA_BATCH} x {LLAMA_SEQ}, {TRAIN_STEPS} steps: losses "
          f"{[round(x, 4) for x in losses]}; step_ms={step_s * 1e3:.3f} "
          f"tokens_per_s={tokens / step_s:.1f} peak_memory_gb={peak_gb:.3f} "
          f"mfu={mfu:.4f} (6*N FLOPs a token over "
          f"{bf16_peak / 1e12:.0f} TFLOP/s); launches {launches} on "
          f"{card_label}", flush=True)

    wall, busy, kernels, _ = _trace_step(lambda: trainer.step(batch))
    flash = {name: sum(t for k, t in kernels.items() if name in k)
             for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    # which ops launched the device time, from a second traced step (the
    # CPU side of the trace slows the host, so the idle share is the
    # first trace's)
    _, _, _, ops = _trace_step(lambda: trainer.step(batch), by_op=True)
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    trace = {"wall_ms": wall, "busy_ms": busy,
             "idle_share": 1 - busy / wall, "flash_ms": flash,
             "top": [[k[:80], t] for k, t in top],
             "top_ops": [[k[:80], t] for k, t in top_ops]}
    print(f"[train_llama] traced step: wall_ms={trace['wall_ms']:.3f} "
          f"device_busy_ms={busy:.3f} (idle share {trace['idle_share']:.4f})"
          f"; flash kernels " + ", ".join(f"{k} {t:.3f} ms"
                                          for k, t in flash.items())
          + "; top kernels: "
          + "; ".join(f"{k[:70]} {t:.3f} ms" for k, t in top), flush=True)
    print("[train_llama] device ms a step by the op that launched it: "
          + "; ".join(f"{k[:60]} {t:.3f}" for k, t in top_ops), flush=True)
    del trainer

    # the lm_head GEMMs alone: Llama's vocab (a multiple of 8) against
    # GPT-2's 50257 (phase 6), at the same 16384 tokens a step
    heads = {"llama_32000": lm_head_gemms(cfg.vocab_size, tokens),
             "gpt2_50257": lm_head_gemms(50257, TRAIN_BATCH * TRAIN_SEQ)}
    for key, h in heads.items():
        print(f"[train_llama] lm_head GEMMs {key} ({tokens} tokens x 768): "
              + " ".join(f"{k}={v:.4f}" for k, v in h.items())
              + " ms (device; *_align1: the align1 kernels' share)",
              flush=True)

    batches = [_llama_batch(cfg, LLAMA_PARITY_BATCH, 1 + i)
               for i in range(PARITY_STEPS)]
    par = {}
    for impl in ("flash", "reference"):
        t = ShardedPretrainer(dataclasses.replace(cfg, attention_impl=impl),
                              MeshConfig())
        par[impl] = [t.step(b).item() for b in batches]
        del t
    rel = max(abs(a - b) / abs(b) for a, b in zip(par["flash"],
                                                   par["reference"]))
    if rel > BF16_LOSS_RTOL:
        raise AssertionError(f"Llama bf16 losses flash {par['flash']} vs "
                             f"reference {par['reference']}: rel {rel:.3e} "
                             f"> {BF16_LOSS_RTOL:.3e}")
    print(f"[train_llama] bf16 parity, batch {LLAMA_PARITY_BATCH}, "
          f"{PARITY_STEPS} steps: flash {par['flash']} reference "
          f"{par['reference']}, max rel {rel:.3e} (bar {BF16_LOSS_RTOL:.3e})",
          flush=True)
    f32 = {}
    for impl in ("flash", "reference"):
        t = ShardedPretrainer(dataclasses.replace(
            cfg, attention_impl=impl, dtype=torch.float32), MeshConfig())
        loss = t.step(batches[0]).item()
        f32[impl] = (loss, t.opt.last_grad_norm.item())
        del t
    (lf, nf), (lr_, nr) = f32["flash"], f32["reference"]
    if not (abs(lf - lr_) <= F32_LOSS_RTOL * abs(lr_)
            and abs(nf - nr) <= F32_NORM_RTOL * abs(nr)):
        raise AssertionError(f"Llama f32 step flash (loss {lf}, grad norm "
                             f"{nf}) vs reference ({lr_}, {nr})")
    print(f"[train_llama] f32 parity, one step at batch "
          f"{LLAMA_PARITY_BATCH}, TF32 off: loss flash {lf:.8f} reference "
          f"{lr_:.8f} (rel {abs(lf - lr_) / abs(lr_):.3e}, bar "
          f"{F32_LOSS_RTOL}); grad norm flash {nf:.8f} reference {nr:.8f} "
          f"(rel {abs(nf - nr) / abs(nr):.3e}, bar {F32_NORM_RTOL})",
          flush=True)
    return launches, {"step_ms": step_s * 1e3,
                      "tokens_per_s": tokens / step_s,
                      "peak_memory_gb": peak_gb, "mfu": mfu,
                      "n_params": n_params, "losses": losses,
                      "trace": trace, "lm_head_gemms": heads,
                      "parity_bf16": par, "parity_f32": f32}


# ------------------------------------------------------------ phase 6d
RING_CASES = [
    # name, dtype, B, H, S, D, sp: GPT-2-small's and Llama's training
    # shapes (phases 6 and 6b), and an f32 case for the exact bar
    ("gpt2_train_bf16_sp2", torch.bfloat16, 16, 12, 1024, 64, 2),
    ("gpt2_train_bf16_sp4", torch.bfloat16, 16, 12, 1024, 64, 4),
    ("llama_train_bf16_sp2", torch.bfloat16, 8, 12, 2048, 64, 2),
    ("llama_train_bf16_sp4", torch.bfloat16, 8, 12, 2048, 64, 4),
    ("train_f32_sp4", torch.float32, 4, 12, 1024, 64, 4),
    # bf16 at D 32, on the CUDA-core kernels, which round only their
    # outputs: where the partials' extra rounding shows most
    ("d32_bf16_sp4", torch.bfloat16, 8, 12, 1024, 32, 4),
]
# f32, relative to the largest element of the whole-sequence result: o,
# then dq, dk and dv.  The merges add a few f32 roundings to the kernels'
# exact f32 arithmetic.
RING_F32_BARS = (1e-5, 1e-4)
# bf16: the ring rounds each chunk's o, dq, dk and dv to bf16 before its
# f32 merge or sum, once more than whole-sequence flash; against the f32
# result of f32 upcasts it may be at most this many times as far as flash
# in bf16
RING_BF16_FACTOR = 2.0
RING_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")


def _ms_text(times, key) -> str:
    dev, kern = times[key + "_ms"], times[key + "_kernel_ms"]
    return ("not measured" if dev is None else f"{dev:.4f} ({kern:.4f})") \
        + f" / {times[key + '_stream_ms']:.4f}"


def ring_one_card(card_label):
    """Ring attention's steps on one card: for each ring position r and
    step i, in the ring's order, the same ``_ring_fwd_step`` (chunk
    attention on the flash forward kernel, ``_online_merge``) and
    ``_ring_bwd_step`` (the flash backward kernels with the merged o and
    lse) that ``ring_attention`` runs on rank r, through
    ``ring_attention_fwd_unrolled`` / ``_bwd_unrolled``; against
    whole-sequence flash (``flash_attention_fwd`` / ``_bwd``) on the same
    inputs.  Every counter is set to 0 just before the ring's forward and
    backward and read just after: flash_fwd, dQ and dK/dV sp(sp+1)/2 each a
    case (the steps causality hides launch nothing), no combine or delta
    launch."""
    from ray_tpu_torch.ops.attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        ring_attention_bwd_unrolled,
        ring_attention_fwd_unrolled,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, total = [], None
    for name, dtype, B, H, S, D, sp in RING_CASES:
        q, k, v, g = (torch.randn(B, H, S, D, generator=gen, device="cuda")
                      .to(dtype) for _ in range(4))
        o_ref, lse_ref = flash_attention_fwd(q, k, v)
        d_ref = flash_attention_bwd(q, k, v, o_ref, lse_ref, g)
        torch.cuda.synchronize()
        _zero_counts()
        o, lse = ring_attention_fwd_unrolled(q, k, v, sp=sp)
        grads = ring_attention_bwd_unrolled(q, k, v, o, lse, g, sp=sp)
        torch.cuda.synchronize()
        launches = _read_counts()
        steps = sp * (sp + 1) // 2
        want = {key: 0 for key in launches}
        want.update({key: steps for key in RING_KERNELS})
        want["fused:flash_bwd_delta"] = steps
        if launches != want:
            raise AssertionError(f"{name}: ring launches {launches}, "
                                 f"expected {want}")
        total = launches if total is None else {
            key: total[key] + n for key, n in launches.items()}
        got = {"o": o, "dq": grads[0], "dk": grads[1], "dv": grads[2]}
        if dtype == torch.float32:
            ref = {"o": o_ref, "dq": d_ref[0], "dk": d_ref[1],
                   "dv": d_ref[2]}
            errs = {key: ((got[key] - ref[key]).abs().max()
                          / ref[key].abs().max()).item() for key in got}
            bars = {key: RING_F32_BARS[key != "o"] for key in got}
            bad = {key: e for key, e in errs.items() if not e <= bars[key]}
            accuracy = {"rel_err": errs, "bars": bars}
        else:
            # the f32 result of f32 upcasts, on the f32 kernels
            q32, k32, v32, g32 = (t.float() for t in (q, k, v, g))
            o32, lse32 = flash_attention_fwd(q32, k32, v32)
            exact = dict(zip(("o", "dq", "dk", "dv"), (o32, *(
                flash_attention_bwd(q32, k32, v32, o32, lse32, g32)))))
            flash = {"o": o_ref, "dq": d_ref[0], "dk": d_ref[1],
                     "dv": d_ref[2]}
            errs = {key: ((got[key].float() - exact[key]).abs().max().item(),
                          (flash[key].float() - exact[key]).abs().max()
                          .item()) for key in got}
            bad = {key: e for key, e in errs.items()
                   if not e[0] <= RING_BF16_FACTOR * e[1]}
            accuracy = {"ring_vs_flash_err": errs,
                        "factor": RING_BF16_FACTOR}
            del q32, k32, v32, g32, o32, lse32, exact
        if bad or not all(bool(torch.isfinite(t).all())
                          for t in got.values()):
            raise AssertionError(f"{name}: the ring misses its bar: {bad} "
                                 f"({accuracy})")
        # device time from the trace (every kernel the call runs, and the
        # flash kernels' share), its launches checked; and the time a call
        # takes on the stream (CUDA events), which also holds the host's
        # gaps between the one-process schedule's many small launches
        times = {}
        for key, n, fn in (
                ("ring_fwd", steps, lambda: ring_attention_fwd_unrolled(
                    q, k, v, sp=sp)),
                ("ring_bwd", 2 * steps, lambda: ring_attention_bwd_unrolled(
                    q, k, v, o, lse, g, sp=sp)),
                ("flash_fwd", 1, lambda: flash_attention_fwd(q, k, v)),
                ("flash_bwd", 2, lambda: flash_attention_bwd(
                    q, k, v, o_ref, lse_ref, g))):
            times[key + "_ms"], share = _device_ms(
                fn, iters=10, part=RING_KERNELS, launches=n)
            times[key + "_kernel_ms"] = (None if share is None
                                         else sum(share.values()))
            times[key + "_stream_ms"] = _time_ms(fn, iters=10)
        rows.append({"case": name, "shape": [B, H, S, D], "sp": sp,
                     "dtype": str(dtype).replace("torch.", ""),
                     "launches": launches, **accuracy, **times})
        print(f"[ring] {name} (B={B}, H={H}, S={S}, D={D}, sp={sp}, "
              f"causal): launches flash_fwd/dq/dkdv "
              f"{launches['flash_fwd']}/{launches['flash_bwd_dq']}/"
              f"{launches['flash_bwd_dkdv']} (sp(sp+1)/2 = {steps}), "
              f"combine {launches['flash_fwd_combine']}, delta "
              f"{launches['flash_bwd_delta']}; "
              + (" ".join(f"{k} rel {e:.3e} (bar {bars[k]})"
                          for k, e in errs.items())
                 if dtype == torch.float32 else
                 " ".join(f"{k} {a:.3e}/{b:.3e}" for k, (a, b) in
                          errs.items())
                 + f" (ring/flash error against the f32 result of f32 "
                 f"upcasts, bar {RING_BF16_FACTOR}x)")
              + "; ms summed over every position, device (the flash "
              "kernels' share) / on the stream: ring forward "
              + _ms_text(times, "ring_fwd") + " against whole-sequence "
              "flash " + _ms_text(times, "flash_fwd") + ", ring backward "
              + _ms_text(times, "ring_bwd") + " against "
              + _ms_text(times, "flash_bwd") + f" on {card_label}",
              flush=True)
        del q, k, v, g, o, lse, grads, got, o_ref, lse_ref, d_ref
    return total, rows


# ------------------------------------------------------------ phase 6e
def moe_config(**over):
    """GPT-2-small with the JAX package's MoE defaults in every second
    block (8 experts, top-2, capacity factor 1.25: six MoE layers), no
    remat: phase 6's model with routed experts."""
    from ray_tpu_torch.models import GPT2Config

    return GPT2Config(moe_every=2, remat=False, **over)


# the widths of tests/test_torch_parallel.py's gang, for the multi-card
# meshes on a CPU gloo gang (--gloo-gang)
GLOO_WIDTHS = dict(vocab_size=512, n_embd=64, n_layer=2, n_head=4)


def f32_config(family: str, device: str = "cuda"):
    """The f32 config of a multi-card case's model: phase 6's (``"gpt"``)
    or phase 6e's (``"gpt-moe"``), at GLOO_WIDTHS on the CPU."""
    import dataclasses

    from ray_tpu_torch.models import GPT2Config

    cfg = (moe_config(dtype=torch.float32) if family == "gpt-moe"
           else GPT2Config(remat=False, dtype=torch.float32))
    return cfg if device == "cuda" else dataclasses.replace(cfg,
                                                            **GLOO_WIDTHS)


def _active_params(model) -> int:
    """The parameters a token uses: every dense one, and per MoE layer the
    router and top_k / n_experts of the expert weights."""
    cfg = model.config
    return int(sum(p.numel() * (cfg.moe_top_k / cfg.n_experts
                                if name.endswith(("w_in", "w_out")) else 1)
                   for name, p in model.named_parameters()))


def _record_routing(model):
    """Hooks on every MoE block of ``model`` that append, at each call,
    each token's top-k experts by its router logits (on the CPU) to a
    list: (the list, the hooks' handles)."""
    from ray_tpu_torch.models.moe import MoEMlpBlock

    choices = []

    def hook(block, args):
        with torch.no_grad():
            logits = F.linear(args[0].float(), block.router.weight)
            choices.append(logits.topk(block.config.top_k).indices.cpu())
    return choices, [m.register_forward_pre_hook(hook)
                     for m in model.modules() if isinstance(m, MoEMlpBlock)]


def _routing_differs(a, b) -> str:
    """How many (token, round) expert choices differ between two routing
    logs of the same batches: a near-tie of the router (other roundings
    upstream) moves one token, a fault many."""
    n = sum(int((x != y).sum()) for x, y in zip(a, b))
    total = sum(x.numel() for x in a)
    return f"{n} of {total}"


def train_moe(card, card_label):
    """The MoE training path: ShardedPretrainer on GPT-2-small with routed
    experts (bf16, flash, no remat) at phase 6's batch, then a checkpoint
    round trip and parity against reference attention."""
    import dataclasses
    import tempfile

    from ray_tpu_torch.models import ShardedPretrainer

    cfg = moe_config()
    trainer = ShardedPretrainer(cfg)
    batch = _train_batch(cfg, TRAIN_BATCH, 0)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    n_active = _active_params(trainer.model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    losses, t_start = [], None
    for i in range(TRAIN_STEPS):
        if i == 2:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        losses.append(trainer.step(batch))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t_start) / (TRAIN_STEPS - 2)
    launches = _read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [t.item() for t in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE training losses not finite and falling: "
                             f"{losses}")
    calls = cfg.n_layer * TRAIN_STEPS
    want = {"flash_fwd": calls, "flash_fwd_combine": 0, "flash_bwd_delta": 0,
            "flash_bwd_dkdv": calls, "flash_bwd_dq": calls,
            "fused:flash_fwd_combine": 0, "fused:flash_bwd_delta": calls}
    if launches != want:
        raise AssertionError(f"MoE training launches {launches}, expected "
                             f"{want}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bf16_peak = _peaks(card)[1]
    mfu = 6 * n_active * tokens / step_s / bf16_peak
    n_moe = sum(hasattr(b, "moe_mlp") for b in trainer.model.h)
    print(f"[train_moe] GPT-2-small with MoE every {cfg.moe_every} blocks "
          f"({n_moe} MoE layers, {cfg.n_experts} experts, top-"
          f"{cfg.moe_top_k}, capacity factor {cfg.moe_capacity_factor}; "
          f"{n_params} params, {n_active} active; bf16, flash, remat off), "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} steps: losses "
          f"{[round(x, 4) for x in losses]}; step_ms={step_s * 1e3:.3f} "
          f"tokens_per_s={tokens / step_s:.1f} peak_memory_gb={peak_gb:.3f} "
          f"mfu={mfu:.4f} (6*N_active FLOPs a token over "
          f"{bf16_peak / 1e12:.0f} TFLOP/s, N_active = the dense parameters "
          f"+ per MoE layer the router and top_k/n_experts of the expert "
          f"weights; attention left out); launches {launches} on "
          f"{card_label}", flush=True)

    wall, busy, kernels, _ = _trace_step(lambda: trainer.step(batch))
    flash = {name: sum(t for k, t in kernels.items() if name in k)
             for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    _, _, _, ops = _trace_step(lambda: trainer.step(batch), by_op=True)
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    trace = {"wall_ms": wall, "busy_ms": busy,
             "idle_share": 1 - busy / wall, "flash_ms": flash,
             "top": [[k[:80], t] for k, t in top],
             "top_ops": [[k[:80], t] for k, t in top_ops]}
    print(f"[train_moe] traced step: wall_ms={wall:.3f} device_busy_ms="
          f"{busy:.3f} (idle share {trace['idle_share']:.4f}); flash kernels "
          + ", ".join(f"{k} {t:.3f} ms" for k, t in flash.items())
          + "; top kernels: "
          + "; ".join(f"{k[:70]} {t:.3f} ms" for k, t in top), flush=True)
    print("[train_moe] device ms a step by the op that launched it: "
          + "; ".join(f"{k[:60]} {t:.3f}" for k, t in top_ops), flush=True)

    # a checkpoint, then the next step from it in a fresh trainer
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        trainer.save_checkpoint(os.path.join(tmp, "ckpt"))
        save_s = time.perf_counter() - t0
        ckpt_gb = sum(os.path.getsize(os.path.join(root, f))
                      for root, _, files in os.walk(tmp)
                      for f in files) / 1e9
        want_loss = trainer.step(batch).item()
        del trainer
        fresh = ShardedPretrainer(cfg)
        t0 = time.perf_counter()
        fresh.restore_checkpoint(os.path.join(tmp, "ckpt"))
        restore_s = time.perf_counter() - t0
        got_loss = fresh.step(batch).item()
        del fresh
    if got_loss != want_loss:
        raise AssertionError(f"the restored trainer's step gave loss "
                             f"{got_loss!r}, the uninterrupted one "
                             f"{want_loss!r}")
    print(f"[train_moe] checkpoint ({ckpt_gb:.3f} GB, saved in {save_s:.2f} "
          f"s, restored in {restore_s:.2f} s): the restored trainer's next "
          f"loss {got_loss!r} equals the uninterrupted trainer's bit for bit",
          flush=True)

    # parity against reference attention from the same init and batches
    batches = [_train_batch(cfg, PARITY_BATCH, 1 + i)
               for i in range(PARITY_STEPS)]
    par, routes = {}, {}
    for impl in ("flash", "reference"):
        t = ShardedPretrainer(dataclasses.replace(cfg, attention_impl=impl))
        routes[impl], hooks = _record_routing(t.model)
        par[impl] = [t.step(b).item() for b in batches]
        for h in hooks:
            h.remove()
        del t
    differ = _routing_differs(routes["flash"], routes["reference"])
    rel = max(abs(a - b) / abs(b) for a, b in zip(par["flash"],
                                                   par["reference"]))
    if rel > BF16_LOSS_RTOL:
        raise AssertionError(f"MoE bf16 losses flash {par['flash']} vs "
                             f"reference {par['reference']}: rel {rel:.3e} "
                             f"> {BF16_LOSS_RTOL:.3e}; routing choices that "
                             f"differ: {differ}")
    print(f"[train_moe] bf16 parity, batch {PARITY_BATCH}, {PARITY_STEPS} "
          f"steps: flash {par['flash']} reference {par['reference']}, max "
          f"rel {rel:.3e} (bar {BF16_LOSS_RTOL:.3e}); routing choices that "
          f"differ {differ}", flush=True)
    f32, routes = {}, {}
    for impl in ("flash", "reference"):
        t = ShardedPretrainer(dataclasses.replace(
            cfg, attention_impl=impl, dtype=torch.float32))
        routes[impl], hooks = _record_routing(t.model)
        loss = t.step(batches[0]).item()
        for h in hooks:
            h.remove()
        f32[impl] = (loss, t.opt.last_grad_norm.item())
        del t
    differ = _routing_differs(routes["flash"], routes["reference"])
    (lf, nf), (lr_, nr) = f32["flash"], f32["reference"]
    if not (abs(lf - lr_) <= F32_LOSS_RTOL * abs(lr_)
            and abs(nf - nr) <= F32_NORM_RTOL * abs(nr)):
        raise AssertionError(f"MoE f32 step flash (loss {lf}, grad norm "
                             f"{nf}) vs reference ({lr_}, {nr}); routing "
                             f"choices that differ: {differ}")
    print(f"[train_moe] f32 parity, one step at batch {PARITY_BATCH}, TF32 "
          f"off: loss flash {lf:.8f} reference {lr_:.8f} (rel "
          f"{abs(lf - lr_) / abs(lr_):.3e}, bar {F32_LOSS_RTOL}); grad norm "
          f"flash {nf:.8f} reference {nr:.8f} (rel "
          f"{abs(nf - nr) / abs(nr):.3e}, bar {F32_NORM_RTOL}); routing "
          f"choices that differ {differ}", flush=True)
    return launches, {"step_ms": step_s * 1e3,
                      "tokens_per_s": tokens / step_s,
                      "peak_memory_gb": peak_gb, "mfu": mfu,
                      "n_params": n_params, "n_active": n_active,
                      "losses": losses, "trace": trace,
                      "checkpoint": {"gb": ckpt_gb, "save_s": save_s,
                                     "restore_s": restore_s,
                                     "loss": got_loss},
                      "parity_bf16": par, "parity_f32": f32}


# ------------------------------------------------------------ phase 6f
# pp of the one-card pipeline runs, M = 2 * pp (the default) each
PIPELINE_PP = (2, 4)
# the f32 step's microbatches at PARITY_BATCH rows: one row each
PIPELINE_F32_MICRO = 4


class _Mark(torch.autograd.Function):
    """The identity, whose backward calls ``fn``: marks where a stage's
    backward starts (at its output) and where it ends (at its input)."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.fn()
        return g, None


def _count_by_position(trainer) -> list:
    """Wrap ``trainer``'s stage function so that each position's launches
    of the flash kernels, in its forward ticks and its backward ticks, add
    into that position's entry of the list returned."""
    counts = [dict.fromkeys(RING_KERNELS, 0) for _ in trainer.stages]
    run = trainer._stage_fn

    def add(r, before):
        now = _read_counts()
        for key in RING_KERNELS:
            counts[r][key] += now[key] - before[key]

    def counted(blocks, h):
        r = next(i for i, b in enumerate(trainer.stages) if b is blocks)
        mark = {}
        h = _Mark.apply(h, lambda: add(r, mark))
        before = _read_counts()
        y = run(blocks, h)
        add(r, before)
        return _Mark.apply(y, lambda: mark.update(_read_counts()))
    trainer._stage_fn = counted
    return counts


def train_pipeline(card, card_label, ref) -> dict:
    """The pipeline on one card: PipelinedPretrainer without a process
    group runs every pp position's ticks (``pipeline_apply_unrolled``, the
    step functions ``pipeline_apply`` runs on each rank) on GPT-2-small
    (bf16, flash, no remat) at phase 6's batch, from phase 6's parameters,
    at pp 2 and 4; then the f32 step against phase 6's.  ``ref`` is phase
    6's record.  Returns ({path: launches}, record)."""
    import dataclasses

    from ray_tpu_torch.models import GPT2Config, PipelinedPretrainer
    from ray_tpu_torch.parallel import MeshConfig

    cfg = GPT2Config(remat=False)
    batch = _train_batch(cfg, TRAIN_BATCH, 0)
    paths, rows = {}, []
    for pp in PIPELINE_PP:
        trainer = PipelinedPretrainer(cfg, MeshConfig(pp=pp))
        if not (trainer.pp_group is None and all(
                p.device.type == "cuda"
                for p in trainer.model.parameters())):
            raise AssertionError("the one-card pipeline is not in one "
                                 "process on the card")
        M, K = trainer.n_micro, cfg.n_layer // pp
        per_position = _count_by_position(trainer)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        losses, t_start = [], None
        for i in range(TRAIN_STEPS):
            if i == 2:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
            losses.append(trainer.step(batch))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t_start) / (TRAIN_STEPS - 2)
        launches = _read_counts()
        by_position = [dict(c) for c in per_position]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [t.item() for t in losses]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"pp={pp} losses not finite and falling: "
                                 f"{losses}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
        if rel > BF16_LOSS_RTOL:
            raise AssertionError(f"pp={pp} losses {losses} against phase "
                                 f"6's {ref['losses']}: rel {rel:.3e} > "
                                 f"{BF16_LOSS_RTOL:.3e}")
        # every stage's blocks once a microbatch: nothing on a bubble tick
        calls = cfg.n_layer * M * TRAIN_STEPS
        want = {key: 0 for key in launches}
        want.update({key: calls for key in RING_KERNELS})
        want["fused:flash_bwd_delta"] = calls
        if launches != want:
            raise AssertionError(f"pp={pp} launches {launches}, expected "
                                 f"{want}")
        per = K * M * TRAIN_STEPS
        if by_position != [dict.fromkeys(RING_KERNELS, per)] * pp:
            raise AssertionError(f"pp={pp} launches by position "
                                 f"{by_position}, expected {per} each")
        wall, busy, _, _ = _trace_step(lambda: trainer.step(batch))
        del trainer
        tokens = TRAIN_BATCH * TRAIN_SEQ
        print(f"[pipeline] GPT-2-small, pp={pp} in one process on one card "
              f"(every position's ticks in turn: the cost of {M} "
              f"microbatches and the schedule's host work, not a pipeline "
              f"speed), M={M}, batch {TRAIN_BATCH} x {TRAIN_SEQ}, "
              f"{TRAIN_STEPS} steps: losses {[round(x, 4) for x in losses]}"
              f" (max rel {rel:.3e} to phase 6's, bar "
              f"{BF16_LOSS_RTOL:.3e}); step_ms={step_s * 1e3:.3f} against "
              f"phase 6's {ref['step_ms']:.3f}; tokens_per_s="
              f"{tokens / step_s:.1f}; peak_memory_gb={peak_gb:.3f} "
              f"(phase 6: {ref['peak_memory_gb']:.3f}); traced step "
              f"wall_ms={wall:.3f} device_busy_ms={busy:.3f} (idle share "
              f"{1 - busy / wall:.4f}); launches {launches} (n_layer x M = "
              f"{cfg.n_layer * M} a step each), by position "
              f"{by_position} (K x M = {K * M} a step each); the replicated "
              f"parameters are one copy here, shared by the positions (the "
              f"multi-card pp cases hold each rank's copy bitwise equal) on "
              f"{card_label}", flush=True)

        t = PipelinedPretrainer(dataclasses.replace(cfg, dtype=torch.float32),
                                MeshConfig(pp=pp),
                                n_microbatches=PIPELINE_F32_MICRO)
        loss = t.step(_train_batch(cfg, PARITY_BATCH, 1)).item()
        norm = t.opt.last_grad_norm.item()
        del t
        loss1, norm1 = ref["parity_f32"]["flash"]
        if not (abs(loss - loss1) <= F32_LOSS_RTOL * abs(loss1)
                and abs(norm - norm1) <= F32_NORM_RTOL * abs(norm1)):
            raise AssertionError(f"pp={pp} f32 step (loss {loss}, grad norm "
                                 f"{norm}) against phase 6's ({loss1}, "
                                 f"{norm1})")
        print(f"[pipeline] pp={pp} f32 step at batch {PARITY_BATCH}, M="
              f"{PIPELINE_F32_MICRO}, TF32 off: loss {loss:.8f} against "
              f"phase 6's {loss1:.8f} (rel "
              f"{abs(loss - loss1) / abs(loss1):.3e}, bar {F32_LOSS_RTOL}); "
              f"grad norm {norm:.8f} against "
              f"{norm1:.8f} (rel {abs(norm - norm1) / abs(norm1):.3e}, bar "
              f"{F32_NORM_RTOL})", flush=True)
        paths[f"pipeline_pp{pp}"] = launches
        rows.append({"pp": pp, "n_microbatches": M,
                     "step_ms": step_s * 1e3,
                     "plain_step_ms": ref["step_ms"],
                     "tokens_per_s": tokens / step_s,
                     "peak_memory_gb": peak_gb, "losses": losses,
                     "launches_by_position": by_position,
                     "trace": {"wall_ms": wall, "busy_ms": busy,
                               "idle_share": 1 - busy / wall},
                     "f32": [loss, norm]})
    return paths, rows


# ------------------------------------------------------------ phase 6c
MESH_TIMEOUT_S = 300
# (ranks, mesh, model): each runs where the machine has that many cards;
# "gpt" is phase 6's model, "gpt-moe" phase 6e's
# (a mesh with pp > 1 trains through PipelinedPretrainer)
MULTI_CARD_CASES = ((2, {"dp": 2}, "gpt"), (2, {"dp": 1, "tp": 2}, "gpt"),
                    (2, {"dp": 1, "sp": 2}, "gpt"),
                    (2, {"dp": 1, "ep": 2}, "gpt-moe"),
                    (2, {"dp": 1, "pp": 2}, "gpt"),
                    (4, {"dp": 1, "fsdp": 2, "tp": 2}, "gpt"),
                    (4, {"dp": 1, "sp": 2, "tp": 2}, "gpt"),
                    (4, {"dp": 1, "ep": 2, "tp": 2}, "gpt-moe"),
                    (4, {"dp": 1, "pp": 2, "tp": 2}, "gpt"))
# phase 6's bf16 run under a sequence split and under a pipeline, where two
# cards exist
BF16_CASES = ((2, {"dp": 1, "sp": 2}), (2, {"dp": 1, "pp": 2}))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_rank(rank, world, port, mesh_kw, results, bf16_run=False,
               family="gpt", device="cuda"):
    """One NCCL rank of a multi-card case: the f32 step (batch
    PARITY_BATCH, the first parity batch) of phase 6's model, or of phase
    6e's (``family="gpt-moe"``), under ``mesh_kw``; with ``bf16_run``,
    phase 6's bf16 run (10 steps at batch TRAIN_BATCH x TRAIN_SEQ) instead,
    its losses and the ms a step of steps 3-10.  With ``device="cpu"``, a
    gloo rank on the CPU at GLOO_WIDTHS instead.  A mesh with pp > 1 trains
    through PipelinedPretrainer, and its f32 step also reports a digest of
    each replicated parameter after the step."""
    import hashlib

    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tpu_torch.models import (
        GPT2Config,
        PipelinedPretrainer,
        ShardedPretrainer,
    )
    from ray_tpu_torch.ops import attention as tattn
    from ray_tpu_torch.parallel import MeshConfig

    trainer_cls = (PipelinedPretrainer if mesh_kw.get("pp", 1) > 1
                   else ShardedPretrainer)

    if device == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        if bf16_run:
            cfg = GPT2Config(remat=False)
            trainer = trainer_cls(cfg, MeshConfig(**mesh_kw))
            batch = _train_batch(cfg, TRAIN_BATCH, 0)
            losses, t_start = [], None
            for i in range(TRAIN_STEPS):
                if i == 2:
                    torch.cuda.synchronize()
                    t_start = time.perf_counter()
                losses.append(trainer.step(batch))
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t_start) * 1e3 / (
                TRAIN_STEPS - 2)
            results.put((rank, [t.item() for t in losses], step_ms))
            return
        cfg = f32_config(family, device)
        trainer = trainer_cls(cfg, MeshConfig(**mesh_kw), device=device)
        # an error in the backward names the forward op it came from
        with torch.autograd.detect_anomaly(check_nan=False):
            loss = trainer.step(_train_batch(cfg, PARITY_BATCH, 1)).item()
        # what the kernels' alignment checks copied from the local shards
        copied = {"fwd": (tattn.LAST_PLAN or {}).get("copied"),
                  "bwd": (tattn.LAST_BWD_PLAN or {}).get("copied")}
        outer = None
        if trainer_cls is PipelinedPretrainer:
            outer = {}
            for name, p in trainer.model.named_parameters():
                if not name.startswith("h."):
                    whole = p.full_tensor() if tattn._is_dtensor(p) else p
                    outer[name] = hashlib.sha256(
                        whole.detach().cpu().numpy().tobytes()).hexdigest()
        results.put((rank, loss, trainer.opt.last_grad_norm.item(), copied,
                     outer))
    finally:
        dist.destroy_process_group()


def _gang(world, mesh_kw, bf16_run=False, family="gpt", device="cuda"):
    """What each of ``world`` NCCL ranks, one a card, put on the queue
    under ``mesh_kw`` (``_mesh_rank``), in rank order.  The gang is
    killed, and the phase fails, after MESH_TIMEOUT_S."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_mesh_rank, args=(r, world, port, mesh_kw,
                                                  results, bf16_run, family,
                                                  device))
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = [], time.monotonic() + MESH_TIMEOUT_S
    try:
        while len(got) < world and time.monotonic() < deadline:
            try:
                got.append(results.get(timeout=5))
            except queue.Empty:  # check that the ranks are alive
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if len(got) != world or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"multi-card case {mesh_kw}: ranks gave "
                             f"{got}, exit codes "
                             f"{[p.exitcode for p in procs]}")
    return sorted(got)


def _multi_card(world, mesh_kw, family, ref, device="cuda"):
    """``family``'s f32 step under ``mesh_kw``; each rank's loss and
    gradient norm against the one-card step ``ref``."""
    got = _gang(world, mesh_kw, family=family, device=device)
    (loss1, norm1) = ref
    for rank, loss, norm, _, _ in got:
        if not (abs(loss - loss1) <= F32_LOSS_RTOL * abs(loss1)
                and abs(norm - norm1) <= F32_NORM_RTOL * abs(norm1)):
            raise AssertionError(f"multi-card {family} {mesh_kw} rank "
                                 f"{rank}: loss "
                                 f"{loss} grad norm {norm} against the one-"
                                 f"card step's {loss1}, {norm1}")
    # a pipeline's replicated parameters: bitwise equal on every rank
    if any(g[4] != got[0][4] for g in got):
        raise AssertionError(f"multi-card {family} {mesh_kw}: the "
                             f"replicated parameters differ between ranks")
    return [g[:4] for g in got]


def multi_card(n_cards, ref_f32, ref_bf16, axis=None) -> dict:
    """Every case of MULTI_CARD_CASES that ``n_cards`` cards can hold (with
    ``axis``, those with more than one rank on it),
    against the one-card f32 step of its model, ``ref_f32[family]`` (loss,
    gradient norm); then
    phase 6's bf16 run under each of BF16_CASES against ``ref_bf16`` (its
    losses and step ms on one card); a line for each case that did not
    run.
    Every case runs; the phase fails at the end if any did."""
    multi, failed = {}, []
    cases = [c for c in MULTI_CARD_CASES
             if axis is None or c[1].get(axis, 1) > 1]
    bf16_cases = [c for c in BF16_CASES
                  if axis is None or c[1].get(axis, 1) > 1]
    for world, mesh_kw, family in cases:
        if world > n_cards:
            print(f"[mesh] {n_cards} card(s): the {world}-card case "
                  f"{family} {mesh_kw} did not run", flush=True)
            continue
        try:
            got = _multi_card(world, mesh_kw, family, ref_f32[family])
        except AssertionError as err:
            failed.append(str(err))
            print(f"[mesh] {world} NCCL ranks, {family} {mesh_kw}: FAILED: "
                  f"{err}", flush=True)
            continue
        multi[f"{family} {json.dumps(mesh_kw)}"] = got
        print(f"[mesh] {world} NCCL ranks, {family} {mesh_kw}, f32 step at "
              f"batch {PARITY_BATCH}: (rank, loss, grad norm, inputs the "
              f"kernels copied) {got} against the one-card step's "
              f"{ref_f32[family]} (bars {F32_LOSS_RTOL}, {F32_NORM_RTOL})",
              flush=True)
    for world, mesh_kw in bf16_cases:
        if world > n_cards:
            print(f"[mesh] {n_cards} card(s): phase 6's bf16 run under "
                  f"{mesh_kw} did not run", flush=True)
            continue
        ref_losses, ref_step_ms = ref_bf16
        try:
            got = _gang(world, mesh_kw, bf16_run=True)
            for rank, losses, _ in got:
                rel = max(abs(a - b) / abs(b)
                          for a, b in zip(losses, ref_losses))
                if rel > BF16_LOSS_RTOL:
                    raise AssertionError(
                        f"bf16 run under {mesh_kw} rank {rank}: losses "
                        f"{losses} against one card's {ref_losses}: rel "
                        f"{rel:.3e} > {BF16_LOSS_RTOL:.3e}")
        except AssertionError as err:
            failed.append(str(err))
            print(f"[mesh] bf16 run under {mesh_kw}: FAILED: {err}",
                  flush=True)
        else:
            multi["bf16 " + json.dumps(mesh_kw)] = got
            print(f"[mesh] {world} NCCL ranks, {mesh_kw}, phase 6's bf16 "
                  f"run, batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} "
                  f"steps: (rank, losses, step_ms) {got} against one card's "
                  f"losses {ref_losses} (bar {BF16_LOSS_RTOL:.3e}) and "
                  f"step_ms {ref_step_ms:.3f}", flush=True)
    if axis in (None, "trainer"):
        got, bad = trainer_cases(n_cards, ref_f32["gpt"])
        multi.update(got)
        failed += bad
    if failed:
        raise AssertionError("multi-card cases failed: " + "; ".join(failed))
    return multi


def multi_card_only(card_label, axis=None) -> int:
    """``chip_smoke.py --multi-card [AXIS]``: phase 6's and phase 6e's f32
    flash steps and phase 6's bf16 run on card 0, then the multi-card cases
    against them (with ``axis``, only those with more than one rank on
    it), and nothing else (the kernels are built first).  Needs two cards
    or more."""
    from ray_tpu_torch.models import GPT2Config, ShardedPretrainer

    n_cards = torch.cuda.device_count()
    print(f"[mesh] torch.cuda.device_count()={n_cards}", flush=True)
    if n_cards < 2:
        raise RuntimeError("--multi-card needs two cards or more")
    ref = {}
    for family, cfg in (("gpt", GPT2Config(remat=False, dtype=torch.float32)),
                        ("gpt-moe", moe_config(dtype=torch.float32))):
        trainer = ShardedPretrainer(cfg)
        loss = trainer.step(_train_batch(cfg, PARITY_BATCH, 1)).item()
        ref[family] = (loss, trainer.opt.last_grad_norm.item())
        del trainer
        print(f"[mesh] one-card {family} f32 step at batch {PARITY_BATCH}, "
              f"TF32 off: loss {ref[family][0]:.8f} grad norm "
              f"{ref[family][1]:.8f} on {card_label}", flush=True)
    trainer = ShardedPretrainer(GPT2Config(remat=False))
    batch = _train_batch(trainer.config, TRAIN_BATCH, 0)
    losses, t_start = [], None
    for i in range(TRAIN_STEPS):
        if i == 2:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        losses.append(trainer.step(batch))
    torch.cuda.synchronize()
    ref_bf16 = ([t.item() for t in losses],
                (time.perf_counter() - t_start) * 1e3 / (TRAIN_STEPS - 2))
    del trainer
    print(f"[mesh] one-card bf16 run: losses {ref_bf16[0]} step_ms "
          f"{ref_bf16[1]:.3f} on {card_label}", flush=True)
    print("[mesh] result " + json.dumps(
        {"device_count": n_cards, "one_card_f32": ref,
         "one_card_bf16": ref_bf16,
         "multi_card": multi_card(n_cards, ref, ref_bf16, axis)}),
        flush=True)
    _runtime_stop()
    return 0


def gloo_gang_only() -> int:
    """``chip_smoke.py --gloo-gang``: the f32 step of every case of
    MULTI_CARD_CASES on a gloo gang of CPU processes at GLOO_WIDTHS, each
    rank against one CPU process's step: this machine's torch on the
    multi-card meshes' DTensor path without the cards (NCCL needs a card a
    rank); no kernel runs.  Every case runs; fails at the end if any
    did."""
    from ray_tpu_torch.models import ShardedPretrainer

    print(f"[gloo] torch {torch.__version__}: the multi-card cases at "
          f"{GLOO_WIDTHS} on the CPU", flush=True)
    failed = []
    for world, mesh_kw, family in MULTI_CARD_CASES:
        # a boundary: each case runs and reports, whatever the one before
        # it raised (a tree without MoE raises at the config)
        try:
            cfg = f32_config(family, "cpu")
            one = ShardedPretrainer(cfg, device="cpu")
            loss = one.step(_train_batch(cfg, PARITY_BATCH, 1)).item()
            ref = (loss, one.opt.last_grad_norm.item())
            got = _multi_card(world, mesh_kw, family, ref, device="cpu")
        except Exception as err:
            failed.append(f"{family} {mesh_kw}: {err!r}")
            print(f"[gloo] {world} ranks, {family} {mesh_kw}: FAILED: "
                  f"{err!r}", flush=True)
            continue
        print(f"[gloo] {world} ranks, {family} {mesh_kw}, f32 step at "
              f"batch {PARITY_BATCH}: (rank, loss, grad norm) "
              f"{[g[:3] for g in got]} against one process's {ref} (bars "
              f"{F32_LOSS_RTOL}, {F32_NORM_RTOL})", flush=True)
    # TorchTrainer's cases: CPU worker actors of the port's runtime, gloo
    cfg = f32_config("gpt", "cpu")
    one = ShardedPretrainer(cfg, device="cpu")
    loss = one.step(_train_batch(cfg, PARITY_BATCH, 1)).item()
    _, bad = trainer_cases(0, (loss, one.opt.last_grad_norm.item()), "cpu")
    failed += bad
    _runtime_stop()
    if failed:
        raise AssertionError("gloo cases failed: " + "; ".join(failed))
    return 0


def mesh_train(card, card_label, ref_losses, ref_step_ms, ref_f32):
    """Phase 6's training run through the DTensor path on a one-rank NCCL
    mesh; then, on two cards or more, the multi-card cases (``ref_f32``:
    the one-card f32 step of each model)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.models import GPT2Config, ShardedPretrainer
    from ray_tpu_torch.ops import attention as tattn
    from ray_tpu_torch.parallel import MeshConfig

    n_cards = torch.cuda.device_count()
    print(f"[mesh] torch.cuda.device_count()={n_cards}", flush=True)
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        cfg = GPT2Config(remat=False)
        trainer = ShardedPretrainer(cfg, MeshConfig())
        if trainer.mesh is None or not all(
                isinstance(p, DTensor) for p in trainer.model.parameters()):
            raise AssertionError("the one-rank mesh did not take the "
                                 "DTensor path")
        batch = _train_batch(cfg, TRAIN_BATCH, 0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        losses, t_start = [], None
        for i in range(TRAIN_STEPS):
            if i == 2:
                torch.cuda.synchronize()
                t_start = time.perf_counter()
            losses.append(trainer.step(batch))
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t_start) / (TRAIN_STEPS - 2)
        launches = _read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [t.item() for t in losses]
        # what the kernels' alignment checks copied from the local shards
        copied = {"fwd": (tattn.LAST_PLAN or {}).get("copied"),
                  "bwd": (tattn.LAST_BWD_PLAN or {}).get("copied")}
        wall, busy, _, _ = _trace_step(lambda: trainer.step(batch))
        del trainer
    finally:
        dist.destroy_process_group()
    calls = cfg.n_layer * TRAIN_STEPS
    want = {"flash_fwd": calls, "flash_fwd_combine": 0, "flash_bwd_delta": 0,
            "flash_bwd_dkdv": calls, "flash_bwd_dq": calls,
            "fused:flash_fwd_combine": 0, "fused:flash_bwd_delta": calls}
    if launches != want:
        raise AssertionError(f"mesh launches {launches}, expected {want}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    if rel > BF16_LOSS_RTOL:
        raise AssertionError(f"one-rank mesh losses {losses} against phase "
                             f"6's {ref_losses}: rel {rel:.3e} > "
                             f"{BF16_LOSS_RTOL:.3e}")
    print(f"[mesh] GPT-2-small on a one-rank NCCL mesh (DTensor "
          f"parameters), batch {TRAIN_BATCH} x {TRAIN_SEQ}, {TRAIN_STEPS} "
          f"steps: losses {[round(x, 4) for x in losses]} (max rel "
          f"{rel:.3e} to phase 6's, bar {BF16_LOSS_RTOL:.3e}); step_ms="
          f"{step_s * 1e3:.3f} against phase 6's plain {ref_step_ms:.3f}; "
          f"peak_memory_gb={peak_gb:.3f}; traced step wall_ms={wall:.3f} "
          f"device_busy_ms={busy:.3f} (idle share {1 - busy / wall:.4f}); "
          f"inputs the kernels copied {copied}; launches {launches} on "
          f"{card_label}", flush=True)
    multi = multi_card(n_cards, ref_f32, (ref_losses, ref_step_ms))
    return launches, {"step_ms": step_s * 1e3, "plain_step_ms": ref_step_ms,
                      "peak_memory_gb": peak_gb, "losses": losses,
                      "trace": {"wall_ms": wall, "busy_ms": busy,
                                "idle_share": 1 - busy / wall},
                      "copied": copied, "device_count": n_cards,
                      "multi_card": multi}


# ------------------------------------------------------------ phase 6g
RUNTIME_FAIL_AFTER = 5  # the second run fails after its step-5 checkpoint
# TorchTrainer's multi-card cases: (ranks, the mesh), phase 6's f32 step
TRAINER_CASES = {"trainer-dp2": (2, {"dp": 2}),
                 "trainer-tp2-fsdp2": (4, {"dp": 1, "fsdp": 2, "tp": 2})}


def _runtime_loop(config):
    """Phase 6's bf16 run inside a train worker actor of the port's runtime:
    ShardedPretrainer on the worker's own card (its default device), from
    the parameters the driver put in the object store, ``train.report``
    each step.  With ``config["fail"]``, a checkpoint after step
    RUNTIME_FAIL_AFTER and, on the first attempt, a failure after it; a
    resumed attempt restores the checkpoint and takes the steps left."""
    # from the driver's fit() to here: the gang's placement, the worker's
    # start and torch.distributed's setup (one host, one wall clock)
    start_s = time.time() - config["t_fit"]
    import shutil
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch._native import build
    from ray_tpu_torch.models import GPT2Config, ShardedPretrainer
    from ray_tpu_torch.train.torch_config import _pci_bus_id

    cfg = GPT2Config(remat=False)
    t0 = time.perf_counter()
    params = ray_tpu_torch.get(config["params"])
    get_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # torch's lazy imports at a process's first optimizer (torch._dynamo),
    # timed apart from the build
    torch.optim.AdamW([torch.zeros(1, device="cuda", requires_grad=True)])
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer = ShardedPretrainer(cfg, params=params)
    init_s = time.perf_counter() - t0
    del params
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            trainer.restore_checkpoint(os.path.join(d, "trainer"))
            with open(os.path.join(d, "step")) as f:
                start = int(f.read()) + 1
    batch = _train_batch(cfg, TRAIN_BATCH, 0)
    torch.cuda.synchronize()
    _zero_counts()
    walls, computes = [], []
    for i in range(start, TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = trainer.step(batch).item()
        computes.append(time.perf_counter() - t0)
        checkpoint = None
        if config["fail"] and i + 1 == RUNTIME_FAIL_AFTER:
            d = tempfile.mkdtemp()
            trainer.save_checkpoint(os.path.join(d, "trainer"))
            with open(os.path.join(d, "step"), "w") as f:
                f.write(str(i))
            checkpoint = train.Checkpoint.from_directory(d)
        metrics = {"step": i, "loss": loss, "resumed_from": start}
        if i + 1 == TRAIN_STEPS:
            metrics.update(
                launches=_read_counts(), init_s=init_s, get_s=get_s,
                start_s=start_s, warm_s=warm_s,
                device=str(trainer.device),
                card=torch.cuda.get_device_name(),
                pci_bus_id=_pci_bus_id(torch.cuda.current_device()),
                builds=list(build.compiled),
                foreign=[m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu")],
                compute_ms=[t * 1e3 for t in computes],
                wall_ms=[t * 1e3 for t in walls])
        train.report(metrics, checkpoint=checkpoint)
        if checkpoint is not None:
            shutil.rmtree(d)
        walls.append(time.perf_counter() - t0)
        if config["fail"] and ckpt is None and i + 1 == RUNTIME_FAIL_AFTER:
            raise RuntimeError("failure on purpose after the step-"
                               f"{RUNTIME_FAIL_AFTER} checkpoint")


def runtime_train(card_label, ref):
    """Phase 6g: phase 6's bf16 run through ``TorchTrainer`` on a worker
    actor of the port's runtime, against phase 6's ``ref`` (its losses and
    step ms); then the same run failing on purpose after its step-5
    checkpoint under ``FailureConfig(max_failures=1)``, which must resume
    and end on the first run's last loss bit for bit."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch.models.pretrain import init_params
    from ray_tpu_torch.train import (
        FailureConfig,
        RunConfig,
        ScalingConfig,
        TorchTrainer,
    )

    t0 = t_phase = time.perf_counter()
    rt.init(ignore_reinit_error=True)
    resources = rt.cluster_resources()
    n_cards = torch.cuda.device_count()
    print(f"[runtime] ray_tpu_torch.init() in {time.perf_counter() - t0:.3f}"
          f" s; the node advertises {resources}", flush=True)
    if resources.get("GPU", 0) != n_cards:
        raise AssertionError(f"the node advertises {resources.get('GPU')} "
                             f"GPU, torch sees {n_cards} cards")
    # phase 6's initial parameters, as ShardedPretrainer draws them, on the
    # CPU, put once
    from ray_tpu_torch.models import GPT2Config

    t0 = time.perf_counter()
    model, _ = init_params(GPT2Config(remat=False), device="cpu")
    params = {k: v.detach() for k, v in model.state_dict().items()}
    draw_s = time.perf_counter() - t0
    nbytes = sum(v.numel() * v.element_size() for v in params.values())
    t0 = time.perf_counter()
    params_ref = rt.put(params)
    put_s = time.perf_counter() - t0
    del model, params
    torch.cuda.empty_cache()
    storage = tempfile.mkdtemp(prefix="smoke_runtime_")
    runs = {}
    try:
        for name, fail in (("plain", False), ("resumed", True)):
            trainer = TorchTrainer(
                _runtime_loop,
                train_loop_config={"params": params_ref, "fail": fail,
                                   "t_fit": time.time()},
                scaling_config=ScalingConfig(num_workers=1),
                run_config=RunConfig(
                    name=f"smoke-{name}", storage_path=storage,
                    failure_config=FailureConfig(max_failures=int(fail))))
            t0 = time.perf_counter()
            result = trainer.fit()
            runs[name] = (result, time.perf_counter() - t0)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    result, fit_s = runs["plain"]
    hist = result.metrics_history
    last = result.metrics
    losses = [m["loss"] for m in hist]
    if [m["step"] for m in hist] != list(range(TRAIN_STEPS)) or \
            not all(np.isfinite(losses)):
        raise AssertionError(f"runtime run reported {hist}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    if rel > BF16_LOSS_RTOL:
        raise AssertionError(f"runtime losses {losses} against phase 6's "
                             f"{ref['losses']}: rel {rel:.3e} > "
                             f"{BF16_LOSS_RTOL:.3e}")
    calls = GPT2Config().n_layer * TRAIN_STEPS
    want = {"flash_fwd": calls, "flash_fwd_combine": 0, "flash_bwd_delta": 0,
            "flash_bwd_dkdv": calls, "flash_bwd_dq": calls,
            "fused:flash_fwd_combine": 0, "fused:flash_bwd_delta": calls}
    if last["launches"] != want:
        raise AssertionError(f"the worker's launches {last['launches']}, "
                             f"expected {want}")
    if last["foreign"] or last["builds"] or last["device"] != "cuda:0":
        raise AssertionError(
            f"the worker loaded {last['foreign']}, built {last['builds']} "
            f"and trained on {last['device']}")
    resumed, resumed_s = runs["resumed"]
    rhist = resumed.metrics_history
    if resumed.metrics["resumed_from"] != RUNTIME_FAIL_AFTER or \
            [m["step"] for m in rhist] != list(range(RUNTIME_FAIL_AFTER,
                                                     TRAIN_STEPS)):
        raise AssertionError(f"the retried run reported {rhist}")
    if rhist[-1]["loss"] != losses[-1]:
        raise AssertionError(f"resumed run's last loss {rhist[-1]['loss']!r}"
                             f" != the uninterrupted run's {losses[-1]!r}")
    # steps 3-10 as phase 6 times them, the step alone (host clock around
    # a step ending in the loss's .item()); and steps 3-9 with the report's
    # round trip to the driver (the last report cannot carry its own)
    compute_ms = float(np.mean(last["compute_ms"][2:]))
    wall_ms = float(np.mean(last["wall_ms"][2:]))
    bit_equal = losses == ref["losses"]
    print(f"[runtime] TorchTrainer, 1 GPU worker actor ({last['card']}, "
          f"PCI {last['pci_bus_id']}, default device {last['device']}), "
          f"phase 6's bf16 run: losses {[round(x, 4) for x in losses]}, "
          f"max rel {rel:.3e} to phase 6's (bar {BF16_LOSS_RTOL:.3e}; bit "
          f"equal: {bit_equal}); step_ms={compute_ms:.3f} (steps 3-10, the "
          f"step alone) {wall_ms:.3f} (steps 3-9 with the report) against "
          f"phase 6's "
          f"{ref['step_ms']:.3f}; fit {fit_s:.3f} s (the "
          f"worker's loop began {last['start_s']:.3f} s after fit() was "
          f"called, torch's first optimizer took {last['warm_s']:.3f} s, "
          f"its ShardedPretrainer built in {last['init_s']:.3f} s); "
          f"parameters {nbytes / 1e6:.1f} MB drawn on the CPU in "
          f"{draw_s:.3f} s, put in {put_s:.3f} s, got by the worker in "
          f"{last['get_s']:.3f} s; worker launches {last['launches']}; "
          f"kernel builds in the worker {len(last['builds'])}; jax or "
          f"ray_tpu modules in the worker {last['foreign']} on {card_label}",
          flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"[runtime] FailureConfig(max_failures=1), failure after the "
          f"step-{RUNTIME_FAIL_AFTER} checkpoint: resumed at step "
          f"{resumed.metrics['resumed_from']}, last loss "
          f"{rhist[-1]['loss']!r} == the uninterrupted run's "
          f"{losses[-1]!r}; fit with the retry {resumed_s:.3f} s; the "
          f"phase {phase_s:.3f} s", flush=True)
    return last["launches"], {
        "losses": losses, "bit_equal_to_phase_6": bit_equal,
        "max_rel_to_phase_6": rel, "step_ms": compute_ms,
        "step_with_report_ms": wall_ms, "phase_6_step_ms": ref["step_ms"],
        "fit_s": fit_s, "init_s": last["init_s"], "put_s": put_s,
        "start_s": last["start_s"], "warm_s": last["warm_s"],
        "draw_s": draw_s,
        "get_s": last["get_s"],
        "param_bytes": nbytes, "card": last["card"],
        "pci_bus_id": last["pci_bus_id"], "builds": last["builds"],
        "resumed_last_loss": rhist[-1]["loss"], "resumed_fit_s": resumed_s,
        "phase_s": phase_s,
        "resources": resources}


def _trainer_case_loop(config):
    """One rank of a TorchTrainer multi-card case: phase 6's f32 step
    (batch PARITY_BATCH, the first parity batch) under ``config["mesh"]``;
    rank 0 reports every rank's (rank, loss, gradient norm, card)."""
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import ShardedPretrainer
    from ray_tpu_torch.parallel import MeshConfig
    from ray_tpu_torch.train.torch_config import _pci_bus_id

    device = config["device"]
    if device == "cuda":
        # f32 GEMMs without TF32, as in the driver (the model has no
        # convolution); not through torch.backends, whose module subclasses
        # do not pickle with this function
        torch.set_float32_matmul_precision("highest")
    else:
        torch.set_num_threads(1)
    cfg = f32_config("gpt", device)
    trainer = ShardedPretrainer(cfg, MeshConfig(**config["mesh"]),
                                device=device)
    loss = trainer.step(_train_batch(cfg, PARITY_BATCH, 1)).item()
    card = (_pci_bus_id(torch.cuda.current_device())
            if device == "cuda" else None)
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, (dist.get_rank(), loss,
                                  trainer.opt.last_grad_norm.item(), card))
    train.report({"rows": rows, "backend": dist.get_backend()})


def trainer_case(world, mesh_kw, ref, device="cuda"):
    """A TorchTrainer multi-card case: ``world`` worker actors (a card
    each, NCCL; or CPU workers, gloo) take phase 6's f32 step under
    ``mesh_kw``; each rank against ``ref`` (loss, gradient norm), and on the
    cards a card of its own for each rank."""
    import tempfile

    import ray_tpu_torch
    from ray_tpu_torch.train import (
        RunConfig,
        ScalingConfig,
        TorchTrainer,
    )

    ray_tpu_torch.init(ignore_reinit_error=True)
    storage = tempfile.mkdtemp(prefix="smoke_trainer_")
    trainer = TorchTrainer(
        _trainer_case_loop,
        train_loop_config={"mesh": mesh_kw, "device": device},
        scaling_config=ScalingConfig(num_workers=world,
                                     use_gpu=device == "cuda"),
        run_config=RunConfig(name=f"smoke-trainer-{world}",
                             storage_path=storage))
    try:
        result = trainer.fit()
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    rows = result.metrics["rows"]
    loss1, norm1 = ref
    for rank, loss, norm, _ in rows:
        if not (abs(loss - loss1) <= F32_LOSS_RTOL * abs(loss1)
                and abs(norm - norm1) <= F32_NORM_RTOL * abs(norm1)):
            raise AssertionError(f"TorchTrainer {mesh_kw} rank {rank}: loss "
                                 f"{loss} grad norm {norm} against "
                                 f"{loss1}, {norm1}")
    if device == "cuda" and len({r[3] for r in rows}) != world:
        raise AssertionError(f"TorchTrainer {mesh_kw}: ranks share a card: "
                             f"{rows}")
    return rows, result.metrics["backend"]


def trainer_cases(n_cards, ref, device="cuda"):
    """Every case of TRAINER_CASES that ``n_cards`` cards hold (all of them
    on the CPU), against the one-card (one-process) f32 step ``ref``; the
    names of the failed ones."""
    out, failed = {}, []
    for case, (world, mesh_kw) in TRAINER_CASES.items():
        if device == "cuda" and world > n_cards:
            print(f"[mesh] {n_cards} card(s): {case} did not run",
                  flush=True)
            continue
        try:
            rows, backend = trainer_case(world, mesh_kw, ref, device)
        except Exception as err:
            failed.append(f"{case}: {err!r}")
            print(f"[mesh] {case} {mesh_kw}: FAILED: {err!r}", flush=True)
            continue
        out[case] = rows
        print(f"[mesh] {case}: TorchTrainer, {world} worker actors "
              f"({backend}), {mesh_kw}, f32 step at batch {PARITY_BATCH}: "
              f"(rank, loss, grad norm, card) {rows} against {ref} (bars "
              f"{F32_LOSS_RTOL}, {F32_NORM_RTOL})", flush=True)
    return out, failed


def _runtime_stop():
    """Shut the port's runtime down (its GCS, nodelet and workers) if this
    process started it."""
    rt = sys.modules.get("ray_tpu_torch")
    if rt is not None and rt.is_initialized():
        rt.shutdown()


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

    if sys.argv[1:] == ["--gloo-gang"]:
        rc = gloo_gang_only()
        print(smi)
        return rc

    # 2. build
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    ptxas = ptxas_report(build.build_logs)
    sass_check(libs)

    label = f"{card} ({smi})"
    if sys.argv[1:2] == ["--multi-card"] and len(sys.argv) <= 3:
        rc = multi_card_only(label, *sys.argv[2:])
        print(smi)
        return rc

    # 3. kernels against their plain versions
    rows = attention_cases(card)
    combine_row = combine_case(card)
    # 3b. the backward kernels
    bwd_rows = backward_cases(card)

    # 4. model at full width
    model_forward(random_flax_params(GPT2Config.small(), seed=0))

    # 5. and 6. the main paths, each with its counters set to 0 just before
    paths = {"serve": serve(label)}
    paths["train"], training = train(card, label)
    paths["train_moe"], training_moe = train_moe(card, label)
    paths["train_llama"], training_llama = train_llama(card, label)
    paths["mesh"], mesh = mesh_train(
        card, label, training["losses"], training["step_ms"],
        {"gpt": training["parity_f32"]["flash"],
         "gpt-moe": training_moe["parity_f32"]["flash"]})
    # 6d. ring attention's steps, each ring position in turn
    paths["ring"], ring = ring_one_card(label)
    # 6f. the pipeline's ticks, each pp position in turn
    pipeline_paths, pipeline = train_pipeline(card, label, training)
    paths.update(pipeline_paths)
    # 6g. phase 6's run through TorchTrainer on a worker actor of the
    # port's runtime (the worker zeroes and reads its counters)
    paths["runtime"], runtime = runtime_train(label, training)
    _runtime_stop()

    # 7. kernels line, card line, result line
    def launches(key):
        return {"launches": sum(p[key] for p in paths.values()),
                "launches_by_path": {k: p[key] for k, p in paths.items()}}

    def fused(key, into, err):
        """A kernel whose job another kernel does on the main paths: which
        one, its launches that did it, and the error of the job done
        there."""
        fkey = "fused:" + key
        return {"fused_into": into,
                "fused_launches_by_path": {k: p[fkey]
                                           for k, p in paths.items()},
                "fused_max_abs_err": err}

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
        **fused("flash_fwd_combine", "flash_fwd",
                combine_row["fused_max_abs_err"]),
        "fused_launch_ms": combine_row["fused_launch_ms"], "pass": True,
    }
    train_row = next(r for r in bwd_rows if r["case"] == TRAIN_CASE)
    errs = train_row["max_abs_err"]
    backward = []
    for name, err in (("flash_bwd_delta", errs["delta"]),
                      ("flash_bwd_dkdv", max(errs["dk"], errs["dv"])),
                      ("flash_bwd_dq", errs["dq"])):
        bound, bound_by = train_row["kernel_bounds"][name]
        delta = name == "flash_bwd_delta"
        # delta's error is that of the delta dQ wrote, bit for bit the
        # standalone kernel's (phase 3b)
        extra = fused(name, "flash_bwd_dq", err) if delta else {
            "variant": train_row["plan"]["variant"],
            "ptxas": ptxas.get(f"{name}_{train_row['plan']['variant']}<64>")}
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
            "shape": TRAIN_CASE, "pass": True, **extra,
        })
    # the whole backward op, and every case of phase 3b, on the last entry
    backward[-1].update(op_ms=train_row["ms"],
                        op_bound_ms=train_row["bound_ms"], cases=bwd_rows)
    print("[train] result " + json.dumps(training), flush=True)
    print("[train_moe] result " + json.dumps(training_moe), flush=True)
    print("[train_llama] result " + json.dumps(training_llama), flush=True)
    print("[mesh] result " + json.dumps(mesh), flush=True)
    print("[ring] result " + json.dumps(ring), flush=True)
    print("[pipeline] result " + json.dumps(pipeline), flush=True)
    print("[runtime] result " + json.dumps(runtime), flush=True)
    print(json.dumps({"kernels": [kernel, combine, *backward]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
