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
     serving decode's partials (and 6j's 600-token and 6k's 4096-token
     unchunked f32 prefills among the cases);
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
  5s. serving through Serve (a main path): ray_tpu_torch.init() (the node
     must advertise a GPU), serve.run(llm_deployment(...)) with phase 5's
     engine settings and one replica, whose InferenceEngine actor owns the
     card; phase 5's 8 requests at once through the handle, streamed, a
     thread each, twice: every request ends with its 32 tokens, identical
     to phase 5's (where one differs, the in-process model's top-two logit
     gap at the first differing token must be under 1e-4), no page leaked;
     the engine's process reads every counter 0 before the first round and
     after it flash_fwd once per attention call, split launches merged in
     the kernel, no combine or backward launch; it runs on cuda:0 (its
     PCI bus id printed), loaded no jax or ray_tpu module and built no
     kernel; tokens/s, TTFT median and max and the mean inter-token gap of
     each round beside phase 5's, the engine actor's start; where aiohttp
     is installed, one request over HTTP SSE (serve.start) against the
     handle's tokens; serve.shutdown() and ray_tpu_torch.shutdown() leave
     no process of the session;
  6j. the cluster surface (two main paths, right after 5s, each part on a
     runtime of its own in a temporary RAY_TPU_TORCH_TMPDIR): (a) `python
     -m ray_tpu_torch start --head --num-cpus 2` (the node counts its
     cards itself), `status` showing GPU n/n for the n cards torch sees,
     a toy wheel built in the temporary directory, and a job submitted
     through JobSubmissionClient whose script runs one num_gpus=1 task in
     a pip env (toydep==1.0, offline through --no-index --find-links): the
     task builds GPT-2-small from seed 0 on its card and answers phase 5's
     first two prompts, 32 greedy tokens each, which must be phase 5's;
     the job SUCCEEDED, toydep 1.0 from the venv, flash_fwd launched once
     per attention call in the task, no combine or backward launch;
     `stop` leaves no process of the session; the head's start, the
     venv's build, the job's wall time and the task's tokens/s; (b) a
     head with GPU 0, a StandardAutoscaler over GPUNodeProvider on
     FakeGpuCloud with one h100-1 node type ({CPU: 1, GPU: 1}): a pending
     num_gpus=1 task makes it launch one host, the task sees card 0 alone
     and prefills phase 5's second prompt through flash_fwd, its last
     logits within 1e-4 / 1e-3 of plain attention's (GPT2LMModel with
     reference attention, on the card) and of phase 5's engine's (phase 3
     holds the kernel at this 600-token prefill); once idle past its
     3 s timeout the host is terminated and its nodelet gone; the
     scale-up (submit to the task's start) and reap times;
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
  6t. Data -> Train -> Tune (a main path, after 6g on its runtime): (a)
     the driver writes phase 6's batch as int32 (2, 1024) rows, one .npy
     shard a batch, 10 shards (ray_tpu_torch.data's write_numpy);
     read_numpy -> map_batches (int64 input_ids and targets) ->
     TorchTrainer(datasets=) with one GPU worker, which takes 6g's
     parameters from the object store and each step's batch from
     get_dataset_shard("train").iter_torch_batches(device=its card):
     losses within phase 6's bf16 bar of 6g's (and whether bit for bit),
     120 launches of flash_fwd, dQ and dK/dV, no combine or delta launch,
     the worker on cuda:0 with no jax, optax or ray_tpu module, the split
     coordinator with neither CUDA nor those modules (by its own report),
     the read and map tasks refusing to run in a process where CUDA is up
     or those modules are loaded; step ms beside 6g's, ingest (the
     iterator's next, host clock) median and max, the fit's seconds; (b)
     a Tuner over that trainer at gpus_per_worker=0.5, a grid of two
     learning rates (phase 6's and 1e-3), max_concurrent_trials=2: two
     results, no errors, both workers on card 0 with overlapping step
     windows (each waits for the other after its first batch), the trial
     at phase 6's rate ending on (a)'s last loss,
     get_best_result() the lower last loss, 120 launches of each kernel a
     trial, tuner_state.json written; each trial's step ms and the
     sweep's seconds; (c) one MARWIL update (beta 1, 1024 rows of recorded
     CartPole steps, minibatch 128) on the card against the CPU from the
     same parameters, TF32 off: every minibatch's losses and the
     parameters within 1e-5, the norm within 1e-6, relative;
  6m. the MPMD pipeline (after 6t, on its runtime): TorchTrainer(
     gpt2_pipeline_loop, pipeline_stages=2, num_microbatches=4) trains
     GPT-2-small (bf16, flash, no remat) 10 steps at phase 6's batch on
     two stage worker actors sharing card 0, against the loop at one
     stage; losses finite, falling and within phase 6's bf16 bar of one
     stage's; each worker's counters (flash_fwd, dQ and dK/dV 6 x 4 a
     step), its card, peak memory, frames by link, the native channel;
     no new caching-allocator segment in step 1 on any stage (each
     stage reaches its steady memory in step 0); then the f32 step two
     stages against one, and 6o (b);
  6r. RL (after 6m, on a runtime of its own): (a) PPOConfig at
     tests/test_rllib.py:75-97's config with one learner actor on the card
     must reach a return of 350 within 200,000 env steps, the learner
     reporting cuda:0, its runners never starting CUDA and no runner or
     learner loading jax, optax or ray_tpu (iterations, env steps/s, an
     iteration's median split into the update's time by CUDA events and
     a runner's fragment); (b) one TorchLearner update on the card against
     the same update on the CPU (same parameters, that batch, the same
     permutations, TF32 off): GAE within 1e-5, the first minibatch's
     gradient 1e-5 (norm), the stats 1e-4, relative, and five
     PodracerLearner V-trace updates on the card against the CPU's, the
     stats 1e-4; (c) IMPALA's relaunch path (tests/test_rllib.py:160-189's
     config at seeds 0, 1 and 2, side by side, learners in the driver on
     the card): at least one run must reach 350 within 400,000 env steps
     (one async run misses it by chance), then Sebulba: an
     inference pool and two learners sharing card 0 at
     num_gpus_per_learner=0.5 for three iterations, the replicas bitwise
     equal after a flush, zero local forwards, the pool batching two
     runners; (d) llm_policy_pool with phase 5s's GPT-2-small engine and
     the prefix cache answers four runner threads for four steps each
     (the episode so far, greedy, 8 tokens): tokens against phase 5's
     engine in this process, flash_fwd launches in the engine's process
     equal to its attention calls, no backward launch, no page leaked,
     prefix-cache hits at every step after the first; the driver's
     counters, zeroed before (a), read 0 after (c); one runner's env
     steps/s at one torch thread and at torch's default; (e) DQN at
     tests/test_rllib.py:236-244's config (CartPole-v1, the runner in the
     driver, seed 1), the update on cuda:0, must reach 350 within 640,000
     env steps (iterations, env steps, the update's median by CUDA events,
     a fragment's host ms; a QEnvRunner actor never starts CUDA; the
     driver loads no jax, optax or ray_tpu), then one _dqn_update (13
     minibatches of 128) on the card against the CPU from the trained
     parameters and a batch of its buffer, TF32 off: losses and parameters
     within 1e-5 relative, the target bit for bit the parameters before
     it (tau 0); (f) SAC at tests/test_rllib.py:377-389's config
     (Pendulum-v1, seed 0) for 45 iterations, the update on cuda:0: at
     least 20,000 env steps, the greedy evaluate(5) at least -400, alpha
     under 0.9 (the update's median; an SACEnvRunner actor never starts
     CUDA), then 4 minibatches of 256 of _sac_update on the card against
     the CPU with the same parameters, batch and noise: the first
     minibatch's losses within 1e-5, the parameters, target_q and alpha
     within 1e-4, relative; the driver's counters, zeroed before (e),
     read 0 after (f);
  6o. observability of the card's paths, each on the runtime of the path it
     reads, on [obs-6o] lines: (a) at the end of 5s, util.state.
     summarize_llm() holds the engine's 16 requests and their tokens; for
     each streamed request, state.critical_path(request_id=...) whose
     buckets sum to its TTFT within 5 %, printed beside the TTFT the driver
     measured; ``python -m ray_tpu_torch.dashboard --address ...`` as a
     process of its own answers /api/llm and /api/critical_path with the
     state API's numbers, and reports (on a signal) no CUDA and no jax or
     ray_tpu module; (b) after 6m's two-stage fit, state.critical_path(
     step=5) from the stages' stamps: the critical stage's bucket mass its
     wall within 5e-6 s, its bubble fraction within 0.15
     of its BubbleClock, on every step 1-9 the busiest stage (by the
     path's exec bucket) the last one, holding lm_head and the loss, and
     the critical stage (the longest stamped wall, which follows which
     stage began the step first) printed by step; (c) 6g's first fit
     inside util.tracing.trace_span:
     state.critical_path(trace_id=...) holds the worker's session_start
     and is no longer than the fit's wall, and export_otlp writes the
     trace with its on_critical_path spans;
  6k. the bench harnesses (after 6r, on a runtime of their own, [bench-6k]
     lines): (a) serve_load_bench at GPT-2-small in f32: prefix_ab's two
     arms in this process, their outputs identical (where they differ,
     the top-two logit gap at the first differing token must be under
     1e-4) and their prefill counts those of the same arms on the CPU;
     chunked_prefill_ab's 4096-token prompt dropped into 8 decoding
     streams, unchunked against chunks of 256 (GPT-2-small's widths, the
     harness's vocabulary of 512), its two max inter-token latencies;
     sse_load's 256 streams of 8 tokens over two llm_deployment replicas
     whose engines share card 0 (num_gpus 0.5 each), through the HTTP
     proxy: 256 completed, none shed, no half-stream, TTFT and ITL
     percentiles and goodput; this process's counters set to 0 before
     prefix_ab and read after chunked_prefill_ab, and each engine's
     process read (flash_fwd once per attention call, no combine or
     backward launch, no build), both engines on cuda:0; (c) the host
     harnesses at the sizes each line prints (ray_perf at 0.25 s an axis,
     collective_bench at 16 MiB and world 4, recovery_bench whole,
     rl_bench at one round and its Sebulba row with the learner on the
     card, ray_perf last: it pins its thread to a core), in a process and
     on a runtime of their own, beside (a) and (b); (b) pipeline_bench at
     GPT-2-small's widths and depth in bf16 (no remat), batch 8 x 32:
     run_pipeline_bench at M 1, 4 and 8 (one stage against two over
     ShmChannels on threads, every stage on the card) with each M's
     critical path reconciled with its BubbleClock (buckets summing to
     the path), and run_train_3d_bench's (1, 1, 2) and (2, 1, 1) cells
     and its int8 cell; flash_fwd, dQ and dK/dV once per attention call
     of the steps the rows ran, no combine or delta launch; every row
     printed, and the phase's time;
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


# a timing takes ``iters`` calls, or fewer (at least 3) where that many
# would take longer than this: the plain versions' host loops take up to
# a third of a second a call
TIMING_BUDGET_S = 0.25


def _warm_iters(fn, iters: int) -> int:
    """Three warm-up calls of ``fn``, then how many calls to time."""
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    call_s = (time.perf_counter() - t0) / 3
    return max(3, min(iters, int(TIMING_BUDGET_S / max(call_s, 1e-9))))


def _time_ms(fn, iters: int = 20) -> float:
    """Wall time per call on the card's stream (CUDA events over ``iters``
    back-to-back calls, fewer for a slow ``fn``: ``_warm_iters``):
    includes the host's launch cost when that is the longer of the two."""
    iters = _warm_iters(fn, iters)
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
    the card, traced by torch.profiler (CUPTI), over ``iters`` calls (fewer
    for a slow ``fn``: ``_warm_iters``).  With
    ``part``, also the share of the kernels whose name holds ``part`` (a
    name, or a tuple of names for a dict of shares).  With ``launches``,
    the number of those kernels' launches a call: a trace that holds fewer
    (CUPTI dropped records) is taken again, and after three such traces
    both numbers are None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    names = part if isinstance(part, tuple) else (part,) if part else ()
    iters = _warm_iters(fn, iters)
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
    # phase 6j's autoscaled host: one unchunked prefill of phase 5's
    # 600-token prompt (its KV splits merged in the launch)
    ("serve_prefill600_f32", torch.float32, 1, 12, 600, 600, 64, True, 0, 0),
    # phase 6k's chunked_prefill_ab: its unchunked arm's prefill of the
    # 4096-token prompt
    ("serve_prefill4096_f32", torch.float32, 1, 12, 4096, 4096, 64, True,
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
LOGITS_TOL = (1e-4, 1e-3)  # tests/test_llm.py:154


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
    tol = LOGITS_TOL
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
        # each request's mean gap between its tokens, on the engine's clock
        gaps = [(core._requests[r].last_token_at
                 - core._requests[r].first_token_at) / (len(res["tokens"]) - 1)
                for r, res in zip(rids, results)]
        return core, wall, launches, results, float(np.mean(gaps))

    core, wall, launches, results, itl = run()
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
    _, _, _, again, _ = run(trace=True)
    if [r["tokens"] for r in results] != [r["tokens"] for r in again]:
        raise AssertionError("a second identical run gave other tokens")
    gen = sum(len(r["tokens"]) for r in results)
    ttft = sorted(r["ttft"] for r in results)
    print(f"[serve] GPT-2-small, 8 requests, prompts {sorted(lengths.tolist())}"
          f", 32 tokens each, chunked prefill 256: steps={core.steps} "
          f"wall_s={wall:.4f} tokens_per_s={gen / wall:.2f} "
          f"ttft_median_s={ttft[len(ttft) // 2]:.4f} "
          f"ttft_max_s={ttft[-1]:.4f} itl_mean_s={itl:.5f} "
          f"flash_fwd_launches="
          f"{launches['flash_fwd']} (= {cfg.n_layer} layers x "
          f"{calls // cfg.n_layer} sequence passes), split launches "
          f"merged in-kernel={launches['fused:flash_fwd_combine']}, "
          f"flash_fwd_combine_launches={launches['flash_fwd_combine']} on "
          f"{card_label}",
          flush=True)
    print("[serve] deterministic: second run gave identical tokens; "
          "cache leak check passed", flush=True)
    return launches, {
        "core": core, "tokens": [r["tokens"] for r in results],
        "wall_s": wall, "tokens_per_s": gen / wall,
        "ttft_median_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "itl_mean_s": itl}


# ------------------------------------------------------------ phase 5s
# the logits bar of phase 4: where greedy tokens differ, the top two logits
# of the in-process model must be nearer than this (a near tie)
NEAR_TIE = 1e-4


def _prefill_logits(core, ids) -> np.ndarray:
    """The next-token logits of ``core``'s model after ``ids``, from a
    prefill in a cache of its own."""
    from ray_tpu_torch.llm import CacheConfig, PagedKVCache

    cfg = core.config
    size = core.cache.config.page_size
    cache = PagedKVCache(CacheConfig(
        num_layers=cfg.n_layer, num_heads=cfg.n_head,
        head_dim=cfg.n_embd // cfg.n_head,
        num_pages=-(-len(ids) // size), page_size=size), device=core.device)
    cache.reserve("gap", len(ids))
    return np.asarray(core.runner.prefill("gap", ids, 0, cache), np.float64)


def _top2_gap(core, ids) -> float:
    """The gap between the two largest next-token logits of ``core``'s
    model after ``ids``."""
    top = np.sort(_prefill_logits(core, ids))[-2:]
    return float(top[1] - top[0])


def _port_processes(session_dir: str) -> list:
    """The processes of the port runtime's session ``session_dir`` (GCS,
    nodelet, workers), by their command lines."""
    found = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                args = f.read().decode(errors="replace")
        except OSError:
            continue
        if "ray_tpu_torch._private." in args and session_dir in args:
            found.append((int(pid), args.replace("\0", " ").strip()))
    return found


def _wait_gone(session_dir, what) -> None:
    """Fail unless every process of the port's session ``session_dir`` is
    gone within 30 s."""
    deadline = time.monotonic() + 30
    while (left := _port_processes(session_dir)) and \
            time.monotonic() < deadline:
        time.sleep(0.2)
    if left:
        raise AssertionError(f"port processes left after {what}: {left}")


def _stream_round(handle, prompts, n_tokens):
    """Every request sent at once through ``handle``, streamed, each stream
    read by a thread of its own: the tokens, the round's wall time, TTFT
    and mean inter-token gap from the arrival of each event on this
    process's clock, and each request's id (its last event's) and TTFT
    (``requests``)."""
    import threading

    events = [None] * len(prompts)
    errors = []
    barrier = threading.Barrier(len(prompts) + 1)

    def consume(i):
        try:
            barrier.wait(60)
            sent = time.perf_counter()
            stream = handle.remote({"prompt_ids": prompts[i],
                                    "max_tokens": n_tokens,
                                    "stream": True}).result(120)
            events[i] = (sent, [(time.perf_counter(), e) for e in stream])
        except Exception as err:
            errors.append((i, repr(err)))

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    barrier.wait(60)
    t0 = time.perf_counter()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"streams failed: {errors}")
    tokens, ttft, gaps, requests = [], [], [], []
    for sent, evs in events:
        if not evs[-1][1].get("done") or \
                evs[-1][1]["finish_reason"] != "length":
            raise AssertionError(f"a stream did not end done: {evs[-1]}")
        tokens.append([e["token"] for _, e in evs[:-1]])
        stamps = [t for t, _ in evs[:-1]]
        ttft.append(stamps[0] - sent)
        gaps.append((stamps[-1] - stamps[0]) / (len(stamps) - 1))
        requests.append((evs[-1][1]["request_id"], ttft[-1]))
    if [len(t) for t in tokens] != [n_tokens] * len(prompts):
        raise AssertionError(f"token counts {[len(t) for t in tokens]}")
    ttft.sort()
    return tokens, {
        "tokens_per_s": sum(map(len, tokens)) / wall, "wall_s": wall,
        "ttft_median_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
        "itl_mean_s": float(np.mean(gaps)), "requests": requests}


def serve_deployment(card_label, ref):
    """Phase 5s: phase 5's model and traffic through Serve: the port's
    runtime, ``llm_deployment`` with one replica whose engine actor owns the
    card, the 8 requests at once through the handle, streamed, a thread
    each; the tokens against phase 5's (``ref``), the launches in the
    engine's process, the process itself, and tokens/s and TTFT beside
    phase 5's."""
    import http.client

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve as rt_serve
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.llm import llm_deployment

    cfg, lengths, prompts, params, _ = serving_workload()
    n_tokens = params.max_tokens
    t_phase = time.perf_counter()
    rt.init()
    session_dir = worker_mod.global_worker().node.session_dir
    gpus = rt.cluster_resources().get("GPU", 0)
    if gpus < 1:
        raise AssertionError(f"the node advertises {gpus} GPU")
    engine_kwargs = dict(model_config=cfg, device="cuda", seed=0,
                         page_size=16, num_pages=512, max_batch_tokens=512,
                         prefill_chunk_tokens=256, engine_name="smoke-serve")
    try:
        t0 = time.perf_counter()
        handle = rt_serve.run(llm_deployment(engine_kwargs=engine_kwargs),
                              name="smoke-llm", route_prefix="/llm")
        stats = handle.options(method_name="engine_stats").remote() \
            .result(120)
        # the replica answers once its engine actor is up on the card
        start_s = time.perf_counter() - t0
        before = stats["process"]["kernel_launches"]
        if any(before.values()):
            raise AssertionError(f"the engine launched kernels before the "
                                 f"requests: {before}")
        # the first round finds the engine's process cold (its first GEMMs
        # and kernel loads): its launches are counted; the second is timed
        tokens, cold = _stream_round(handle, prompts, n_tokens)
        stats = handle.options(method_name="engine_stats").remote() \
            .result(60)
        proc = stats["process"]
        launches = proc["kernel_launches"]
        calls = proc["attention_calls"]
        if stats["kv_pages_free"] != stats["kv_pages_total"]:
            raise AssertionError(f"the engine leaked pages: {stats}")
        if not (launches["flash_fwd"] > 0 and launches["flash_fwd"] == calls
                and calls % cfg.n_layer == 0):
            raise AssertionError(f"engine flash_fwd launches {launches} != "
                                 f"attention calls {calls}")
        if launches["flash_fwd_combine"] or \
                not launches["fused:flash_fwd_combine"]:
            raise AssertionError(f"engine launches {launches}: the split-KV "
                                 f"path did not run merged in the kernel")
        if any(launches[key] for key in BWD_KERNELS):
            raise AssertionError(f"the engine launched backward kernels: "
                                 f"{launches}")
        foreign = [m for m in proc["packages"]
                   if m in ("jax", "jaxlib", "flax", "optax", "ray_tpu")]
        if proc["device"] != "cuda:0" or foreign or proc["kernels_built"]:
            raise AssertionError(
                f"the engine ran on {proc['device']}, loaded {foreign} and "
                f"built {proc['kernels_built']}")
        again, warm = _stream_round(handle, prompts, n_tokens)
        stats = handle.options(method_name="engine_stats").remote() \
            .result(60)
        if again != tokens or stats["kv_pages_free"] != \
                stats["kv_pages_total"]:
            raise AssertionError(f"a second round through Serve gave other "
                                 f"tokens or leaked pages: {stats}")
        # greedy tokens against phase 5's in-process run: batch composition
        # follows arrival here, so a near tie may break the other way
        same = 0
        for i, (got, want) in enumerate(zip(tokens, ref["tokens"])):
            if got == want:
                same += 1
                continue
            pos = next(j for j, (a, b) in enumerate(zip(got, want))
                       if a != b)
            gap = _top2_gap(ref["core"], prompts[i] + want[:pos])
            print(f"[serve-5s] request {i} (prompt {lengths[i]}) differs "
                  f"from phase 5's at token {pos}: {got[pos]} against "
                  f"{want[pos]}; top-two logit gap there {gap:.3e} (bar "
                  f"{NEAR_TIE:.0e})", flush=True)
            if gap >= NEAR_TIE:
                raise AssertionError(f"request {i} differs at token {pos} "
                                     f"with a logit gap of {gap:.3e}")
        # 6o (a): the state API, the critical path and the dashboard read
        # this path's requests
        observed = observe_serving(
            engine_kwargs["engine_name"],
            [cold.pop("requests"), warm.pop("requests")], n_tokens,
            card_label)
        http_line = "HTTP SSE left out: aiohttp is not installed here"
        if importlib.util.find_spec("aiohttp") is not None:
            port = rt_serve.start(http_port=0)
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conn.request("POST", "/llm", body=json.dumps(
                {"prompt_ids": prompts[0], "max_tokens": n_tokens}),
                headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            sse = []
            while True:
                line = resp.fp.readline()
                if not line or line.strip() == b"data: [DONE]":
                    break
                if line.startswith(b"data:"):
                    sse.append(json.loads(line[len(b"data:"):]))
            conn.close()
            sse_tokens = [e["token"] for e in sse if "token" in e]
            if sse_tokens != tokens[0]:
                raise AssertionError(f"HTTP SSE tokens {sse_tokens} against "
                                     f"the handle's {tokens[0]}")
            http_line = (f"HTTP SSE: request 0 over serve.start(http_port=0)"
                         f" gave the handle's {len(sse_tokens)} tokens")
    finally:
        rt_serve.shutdown()
        rt.shutdown()
    _wait_gone(session_dir, "shutdown")
    gen = sum(len(t) for t in tokens)
    per_token_ms = (warm["wall_s"] - ref["wall_s"]) / gen * 1e3

    def text(f):
        return (f"wall_s={f['wall_s']:.4f} tokens_per_s="
                f"{f['tokens_per_s']:.2f} ttft_median_s="
                f"{f['ttft_median_s']:.4f} ttft_max_s={f['ttft_max_s']:.4f} "
                f"itl_mean_s={f['itl_mean_s']:.5f}")
    print(f"[serve-5s] llm_deployment, 1 replica, engine actor on "
          f"{proc['device']} (PCI {proc['pci_bus_id']}) started in "
          f"{start_s:.3f} s; 8 streamed requests of {n_tokens} tokens, "
          f"twice: the engine's first round {text(cold)}; the second "
          f"{text(warm)}; phase 5 in process {text(ref)}; the deployment's "
          f"cost per token (second round) {per_token_ms:.3f} ms on "
          f"{card_label}", flush=True)
    print(f"[serve-5s] tokens identical to phase 5's for {same} of "
          f"{len(prompts)} requests; engine launches {launches} (attention "
          f"calls {calls}); kernel builds in the engine "
          f"{len(proc['kernels_built'])}; jax or ray_tpu modules there "
          f"{foreign}; pages free {stats['kv_pages_free']} of "
          f"{stats['kv_pages_total']}; no port process left", flush=True)
    print(f"[serve-5s] {http_line}", flush=True)
    return launches, {
        "first_round": cold, "second_round": warm, "start_s": start_s,
        "per_token_ms": per_token_ms, "identical": same,
        "pci_bus_id": proc["pci_bus_id"], "observed": observed,
        "phase_s": time.perf_counter() - t_phase}


# ------------------------------------------------------------ phase 6j
CLUSTER_PROMPTS = 2  # the job answers phase 5's first two prompts
CLUSTER_PREFILL = 1  # the autoscaled node prefills phase 5's second one
# the autoscaler's idle timeout, and its launch grace as
# tests/test_autoscaler.py:166 sets it (a host younger than the grace is
# not reaped)
CLUSTER_IDLE_S = 3.0
CLUSTER_GRACE_S = 5.0
CLUSTER_TIMEOUT_S = 300

# A user's job: a driver script that connects to the running cluster and
# runs one task on a card in a pip env (the submitted job's own env applies
# env_vars and working_dir; a pip env is a task's or an actor's).  The task
# builds phase 5's engine and counts launches with this script's helpers
# (the repository is on PYTHONPATH).
JOB_SCRIPT = '''import json
import os
import sys
import time

import ray_tpu_torch

ray_tpu_torch.init()  # the cluster's address: RAY_TPU_TORCH_ADDRESS


@ray_tpu_torch.remote(num_gpus=1, runtime_env={"pip": ["toydep==1.0"]})
def generate(prompts, max_tokens):
    started_at = time.time()
    import toydep
    import torch

    from chip_smoke import _read_counts, _zero_counts, serving_workload
    from ray_tpu_torch.llm import SamplingParams

    core = serving_workload()[4]()
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    rids = [core.submit(p, SamplingParams(max_tokens=max_tokens))
            for p in prompts]
    core.run_until_done(rids)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = _read_counts()
    core.cache.check_leaks()
    return {"toydep": toydep.__version__, "python": sys.executable,
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "device": str(core.device), "launches": launches,
            "attention_calls": core.runner.attention_calls,
            "states": [core.result(r)["state"] for r in rids],
            "tokens": [[int(x) for x in core.result(r)["tokens"]]
                       for r in rids],
            "generate_s": generate_s, "started_at": started_at}


with open(sys.argv[1]) as f:
    job = json.load(f)
submitted_at = time.time()
out = ray_tpu_torch.get(generate.remote(job["prompts"], job["max_tokens"]),
                        timeout=job["timeout"])
out["submitted_at"] = submitted_at
print("TASK " + json.dumps(out), flush=True)
ray_tpu_torch.shutdown()
'''


def _toy_wheel(dirpath, name, version) -> str:
    """A pure-Python wheel of ``name`` ``version`` in ``dirpath`` (for an
    offline pip env: ``--no-index --find-links``)."""
    import base64
    import csv
    import hashlib
    import io
    import zipfile

    os.makedirs(dirpath, exist_ok=True)
    whl = os.path.join(dirpath, f"{name}-{version}-py3-none-any.whl")
    info = f"{name}-{version}.dist-info"
    files = {f"{name}/__init__.py": f'__version__ = "{version}"\n',
             f"{info}/METADATA": f"Metadata-Version: 2.1\nName: {name}\n"
                                 f"Version: {version}\n",
             f"{info}/WHEEL": "Wheel-Version: 1.0\nGenerator: chip-smoke\n"
                              "Root-Is-Purelib: true\nTag: py3-none-any\n"}
    buf = io.StringIO()
    record = csv.writer(buf)
    with zipfile.ZipFile(whl, "w") as z:
        for path, content in files.items():
            data = content.encode()
            z.writestr(path, data)
            digest = base64.urlsafe_b64encode(
                hashlib.sha256(data).digest()).rstrip(b"=").decode()
            record.writerow((path, f"sha256={digest}", str(len(data))))
        record.writerow((f"{info}/RECORD", "", ""))
        z.writestr(f"{info}/RECORD", buf.getvalue())
    return whl


def _cli(env, *args) -> str:
    """``python -m ray_tpu_torch ARGS`` as a process of its own; its
    output, or an AssertionError with it."""
    out = subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    if out.returncode != 0:
        raise AssertionError(f"ray_tpu_torch {' '.join(args)} exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    return out.stdout


def _check_serving_launches(where, launches, calls) -> None:
    if not (launches["flash_fwd"] > 0 and launches["flash_fwd"] == calls):
        raise AssertionError(f"{where}: flash_fwd launches {launches} != "
                             f"attention calls {calls}")
    if launches["flash_fwd_combine"] or any(launches[k] for k in BWD_KERNELS):
        raise AssertionError(f"{where}: combine or backward launches "
                             f"{launches}")


def cluster_job(card_label, ref, tmp) -> tuple:
    """6j (a): the CLI starts a head (it counts the card itself), ``status``
    shows its GPU, a job submitted through JobSubmissionClient runs one
    num_gpus=1 task in a pip env built from a wheel in ``tmp``: GPT-2-small
    answers phase 5's first two prompts on the card; then ``stop``."""
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    cfg, lengths, prompts, params, _ = serving_workload()
    wheels = os.path.join(tmp, "wheels")
    _toy_wheel(wheels, "toydep", "1.0")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, RAY_TPU_TORCH_TMPDIR=tmp,
               RAY_TPU_TORCH_RUNTIME_ENV_PIP_NO_INDEX="1",
               RAY_TPU_TORCH_RUNTIME_ENV_PIP_FIND_LINKS=wheels,
               PYTHONPATH=os.pathsep.join(
                   p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    _cli(env, "start", "--head", "--num-cpus", "2")
    head_s = time.perf_counter() - t0
    with open(os.path.join(tmp, "current_cluster")) as f:
        rec = json.load(f)
    try:
        status = _cli(env, "status")
        cards = torch.cuda.device_count()
        if f"GPU: {cards:g}/{cards:g}" not in status:
            raise AssertionError(f"status shows no GPU {cards}/{cards}: "
                                 f"{status}")
        job = os.path.join(tmp, "job.json")
        with open(job, "w") as f:
            json.dump({"prompts": prompts[:CLUSTER_PROMPTS],
                       "max_tokens": params.max_tokens,
                       "timeout": CLUSTER_TIMEOUT_S}, f)
        script = os.path.join(tmp, "job_script.py")
        with open(script, "w") as f:
            f.write(JOB_SCRIPT)
        client = JobSubmissionClient(rec["address"])
        try:
            t0 = time.perf_counter()
            sid = client.submit_job(
                entrypoint=f"{sys.executable} {script} {job}",
                metadata={"phase": "6j"})
            state = client.wait_until_finished(sid, timeout=CLUSTER_TIMEOUT_S)
            job_s = time.perf_counter() - t0
            logs = client.get_job_logs(sid)
        finally:
            client.close()
    finally:
        _cli(env, "stop")
    _wait_gone(rec["session_dir"], "stop")
    line = next((ln for ln in logs.splitlines() if ln.startswith("TASK ")),
                None)
    if state != JobStatus.SUCCEEDED or line is None:
        raise AssertionError(f"job {sid} {state}: {logs[-3000:]}")
    out = json.loads(line[len("TASK "):])
    env_dir = os.path.dirname(os.path.dirname(out["python"]))
    if out["toydep"] != "1.0" or "runtime_envs/pip/" not in out["python"] \
            or out["device"] != "cuda:0" or \
            out["cuda_visible_devices"] is None:
        raise AssertionError(f"the job's task: {out}")
    venv_s = os.path.getmtime(os.path.join(env_dir, "READY")) - \
        os.path.getmtime(os.path.join(env_dir, "pyvenv.cfg"))
    _check_serving_launches("the job's task", out["launches"],
                            out["attention_calls"])
    tokens = out["tokens"]
    if set(out["states"]) != {"FINISHED"}:
        raise AssertionError(f"the job's requests ended {out['states']}")
    for i, (got, want) in enumerate(zip(tokens, ref["tokens"])):
        if got != want:
            pos = next((j for j, (a, b) in enumerate(zip(got, want))
                        if a != b), len(want))
            raise AssertionError(
                f"the job's request {i} differs from phase 5's at token "
                f"{pos}: {got} against {want}; phase 5's top-two logit gap "
                f"there {_top2_gap(ref['core'], prompts[i] + want[:pos])}")
    gen = sum(len(t) for t in tokens)
    res = {"head_start_s": head_s, "venv_build_s": venv_s, "job_s": job_s,
           "task_start_s": out["started_at"] - out["submitted_at"],
           "generate_s": out["generate_s"],
           "tokens_per_s": gen / out["generate_s"],
           "cuda_visible_devices": out["cuda_visible_devices"]}
    print(f"[cluster-6j] (a) python -m ray_tpu_torch start --head up in "
          f"{head_s:.3f} s, status: GPU {cards}/{cards}; a job through "
          f"JobSubmissionClient, one num_gpus=1 task in a pip env "
          f"(toydep 1.0, the venv built in {venv_s:.3f} s): GPT-2-small on "
          f"{out['device']} (CUDA_VISIBLE_DEVICES="
          f"{out['cuda_visible_devices']}) answered phase 5's first "
          f"{CLUSTER_PROMPTS} prompts, {gen} tokens identical to phase 5's, "
          f"in {out['generate_s']:.4f} s ({res['tokens_per_s']:.2f} "
          f"tokens/s); the task started {res['task_start_s']:.3f} s after "
          f"the job's driver submitted it; SUCCEEDED {job_s:.3f} s after "
          f"submit; flash_fwd launches {out['launches']['flash_fwd']} = "
          f"attention calls {out['attention_calls']}; stop left no process "
          f"of the session on {card_label}", flush=True)
    return out["launches"], res


def _cluster_prefill(ids):
    """The autoscaled host's task: GPT-2-small from seed 0 on the card its
    lease gave it, one prefill of ``ids`` through flash_fwd."""
    started_at = time.time()
    from ray_tpu_torch.llm import EngineCore
    from ray_tpu_torch.models import GPT2Config

    core = EngineCore(GPT2Config.small(), device="cuda", seed=0,
                      page_size=16, num_pages=64, engine_name="autoscaled")
    torch.cuda.synchronize()
    _zero_counts()
    logits = _prefill_logits(core, ids)
    return {"logits": logits, "launches": _read_counts(),
            "attention_calls": core.runner.attention_calls,
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "cards": torch.cuda.device_count(), "device": str(core.device),
            "started_at": started_at}


def _plain_prefill_logits(ids) -> torch.Tensor:
    """The next-token logits after ``ids`` of seed 0's GPT-2-small in f32
    on the card with plain attention (GPT2LMModel with
    attention_impl="reference"): no hand-written kernel in it."""
    from ray_tpu_torch.llm import random_flax_params
    from ray_tpu_torch.models import GPT2Config, GPT2LMModel, params_from_flax

    model = GPT2LMModel(GPT2Config(dtype=torch.float32,
                                   attention_impl="reference"), device="cuda")
    model.load_state_dict(params_from_flax(
        random_flax_params(GPT2Config.small(), seed=0)))
    with torch.no_grad():
        logits = model(torch.tensor([ids], device="cuda"))[0, -1]
    return logits.double().cpu()


def cluster_autoscale(card_label, ref) -> tuple:
    """6j (b): a head that counts no card, and a StandardAutoscaler over
    GPUNodeProvider on FakeGpuCloud with one h100-1 node type: a pending
    num_gpus=1 task makes it launch a host, whose nodelet sees card 0; the
    task prefills phase 5's prompt there, held against plain attention's
    logits and phase 5's engine's; the idle host is reaped, its nodelet
    gone."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.autoscaler import (AutoscalingConfig, NodeTypeConfig,
                                          StandardAutoscaler)
    from ray_tpu_torch.autoscaler.gpu_provider import (FakeGpuCloud,
                                                       GPUNodeProvider)

    _, _, prompts, _, _ = serving_workload()
    ids = prompts[CLUSTER_PREFILL]
    plain = _plain_prefill_logits(ids)
    want = torch.from_numpy(_prefill_logits(ref["core"], ids))
    rt.init(num_cpus=2, num_gpus=0)
    node = worker_mod.global_worker().node
    core = worker_mod.require_core()

    def gcs_call(method, msg):
        return core.io.run(core.gcs_conn.call(method, msg))

    api = FakeGpuCloud(gcs_addr=list(node.gcs_addr),
                       session_dir=node.session_dir)
    provider = GPUNodeProvider({}, "smoke", api=api)
    scaler = StandardAutoscaler(AutoscalingConfig(
        node_types={"gpu-h100-1": NodeTypeConfig(
            resources={"CPU": 1.0, "GPU": 1.0}, max_workers=1,
            node_config={"gpu_node_type": "h100-1"})},
        max_workers=1, idle_timeout_s=CLUSTER_IDLE_S,
        update_interval_s=0.5), provider, gcs_call)
    scaler.launch_grace_s = CLUSTER_GRACE_S
    try:
        head_gpus = rt.cluster_resources().get("GPU", 0)
        if head_gpus:
            raise AssertionError(f"the head counts {head_gpus} GPU")
        scaler.start()
        t0 = time.time()
        out = rt.get(rt.remote(num_gpus=1)(_cluster_prefill).remote(ids),
                     timeout=CLUSTER_TIMEOUT_S)
        done = time.time()
        hosts = provider.non_terminated_nodes({})
        if len(hosts) != 1 or scaler.launched["gpu-h100-1"] != 1:
            raise AssertionError(f"hosts {hosts}, launched "
                                 f"{scaler.launched}")
        group = provider.node_tags(hosts[0])["gpu-group"]
        nodelet = api._groups[group]["hosts"][0].nodelet_proc
        # reaped: the autoscaler's termination done and the nodelet exited
        while (not scaler.terminated or nodelet.poll() is None) and \
                time.time() < done + CLUSTER_TIMEOUT_S:
            time.sleep(0.1)
        reap_s = time.time() - done
        if provider.non_terminated_nodes({}) or scaler.terminated != 1 or \
                nodelet.poll() is None or api.group_state(group) != "DELETED":
            raise AssertionError(f"the idle host was not reaped: terminated "
                                 f"{scaler.terminated}, its nodelet "
                                 f"{nodelet.poll()}")
    finally:
        scaler.stop()
        provider.shutdown()
        rt.shutdown()
    _wait_gone(node.session_dir, "shutdown")
    if out["cuda_visible_devices"] != "0" or out["cards"] != 1 or \
            out["device"] != "cuda:0":
        raise AssertionError(f"the autoscaled host's task saw "
                             f"{out['cuda_visible_devices']}, "
                             f"{out['cards']} cards, {out['device']}")
    _check_serving_launches("the autoscaled host's task", out["launches"],
                            out["attention_calls"])
    got = torch.tensor(out["logits"])
    err = _check_close("the autoscaled host's logits against plain "
                       "attention's", got, plain, LOGITS_TOL)
    engine_err = _check_close("the autoscaled host's logits against phase "
                              "5's engine's", got, want, LOGITS_TOL)
    res = {"scale_up_s": out["started_at"] - t0, "reap_s": reap_s,
           "max_abs_err": err, "engine_max_abs_err": engine_err,
           "bit_equal": bool(np.array_equal(out["logits"], want.numpy()))}
    print(f"[cluster-6j] (b) a head with GPU 0, StandardAutoscaler over "
          f"GPUNodeProvider(FakeGpuCloud), node type h100-1: the pending "
          f"num_gpus=1 task ran on the launched host "
          f"{res['scale_up_s']:.3f} s after it was submitted, on "
          f"{out['device']} (CUDA_VISIBLE_DEVICES="
          f"{out['cuda_visible_devices']}, {out['cards']} card); the "
          f"prefill of phase 5's prompt {CLUSTER_PREFILL} ({len(ids)} "
          f"tokens): last logits max_abs_err={err:.3e} to plain "
          f"attention's (GPT2LMModel, reference) and {engine_err:.3e} to "
          f"phase 5's engine's (atol {LOGITS_TOL[0]}, rtol {LOGITS_TOL[1]}; "
          f"bit for bit {res['bit_equal']}), flash_fwd launches "
          f"{out['launches']['flash_fwd']}; the idle host reaped "
          f"{reap_s:.3f} s after the task ended (idle timeout "
          f"{CLUSTER_IDLE_S} s), its nodelet gone, no process of the "
          f"session left on {card_label}", flush=True)
    return out["launches"], res


def cluster_tooling(card_label, ref) -> tuple:
    """Phase 6j: the cluster surface, each part on a runtime of its own in
    a temporary RAY_TPU_TORCH_TMPDIR: (a) the CLI and a submitted job, (b)
    the autoscaler growing a GPU host."""
    import tempfile

    t_phase = time.perf_counter()
    out = {}
    tmp = tempfile.mkdtemp(prefix="cluster-6j-")
    saved = os.environ.get("RAY_TPU_TORCH_TMPDIR")
    os.environ["RAY_TPU_TORCH_TMPDIR"] = tmp
    try:
        job, out["job"] = cluster_job(card_label, ref, tmp)
        autoscaled, out["autoscaler"] = cluster_autoscale(card_label, ref)
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_TORCH_TMPDIR")
        else:
            os.environ["RAY_TPU_TORCH_TMPDIR"] = saved
        shutil.rmtree(tmp, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[cluster-6j] the phase {out['phase_s']:.3f} s on {card_label}",
          flush=True)
    return job, autoscaled, out


# ------------------------------------------------------------- phase 6o
OBS_FOREIGN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")
# the bars of tests/test_critical_path.py: a request's buckets sum to its
# TTFT within 5 % (:245); a step's bucket mass is its critical stage's wall
# within 5e-6 s (:203), its bubble fraction within 0.15 of that stage's
# BubbleClock (:207)
OBS_TTFT_RTOL, OBS_MASS_ATOL, OBS_BUBBLE_ATOL = 0.05, 5e-6, 0.15
# (b) reads this step of 6m's two-stage fit (steps 0-9: one after the
# first), and prints the others' critical stages beside it
OBS_STEP = 5
# what PERF.md predicted before the phase first ran on the card
OBS_PREDICTION = (
    "(a) 16 requests and 512 tokens in summarize_llm; every request's "
    "buckets sum to its TTFT exactly (rounding); the engine's TTFT 2-15 ms "
    "under the driver's (the handle, the replica and the next_output "
    "poll), within 5 % in the warm round and not in the cold one; the "
    "dashboard process up in 2-5 s with no CUDA, JAX or ray_tpu; (b) stage "
    "1 critical, bucket mass exact, bubble fraction within 0.01 of its "
    "BubbleClock; (c) session_start and session_get_next on the fit's path, "
    "the path its wall within 1 ms; 6o 5-15 s in all")
# the dashboard process's facts, on SIGUSR2, from a sitecustomize that
# python loads at its start (so the command stays ``python -m
# ray_tpu_torch.dashboard``)
_DASH_FACTS = '''import json, os, signal, sys


def _facts(signum, frame):
    torch = sys.modules.get("torch")
    path = os.environ["SMOKE_DASH_FACTS"]
    with open(path + ".tmp", "w") as fh:
        json.dump({"pid": os.getpid(),
                   "packages": sorted({m.split(".")[0]
                                       for m in list(sys.modules)}),
                   "cuda_initialized": bool(
                       torch is not None and torch.cuda.is_initialized())},
                  fh)
    os.replace(path + ".tmp", path)


signal.signal(signal.SIGUSR2, _facts)
'''


def _poll(fn, what, timeout=60.0):
    """``fn()`` until it returns something true (a ``ValueError``, as
    ``critical_path`` raises before its rows land, counts as not yet);
    raises naming ``what`` at the deadline."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            last = fn()
        except ValueError as err:
            last = err
        else:
            if last:
                return last
        time.sleep(0.5)
    raise AssertionError(f"{what} never arrived within {timeout} s: "
                         f"{last!r}")


def _dashboard_process(tmp):
    """``python -m ray_tpu_torch.dashboard --address <the GCS> --port 0``
    against this driver's runtime: (the process, its port, its start s)."""
    from ray_tpu_torch._private.worker import require_core

    host, port = require_core()._gcs_addr
    with open(os.path.join(tmp, "sitecustomize.py"), "w") as fh:
        fh.write(_DASH_FACTS)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, SMOKE_DASH_FACTS=os.path.join(tmp, "facts.json"),
               PYTHONPATH=os.pathsep.join(
                   [tmp, here] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.dashboard", "--address",
         f"{host}:{port}", "--port", "0"], cwd=here, env=env,
        stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline()
    if not line.startswith("DASHBOARD_PORT "):
        proc.kill()
        raise AssertionError(f"the dashboard printed {line!r}")
    return proc, int(line.split()[1]), time.perf_counter() - t0


def _dashboard_facts(proc, tmp) -> dict:
    """What the dashboard process has loaded, and whether CUDA is up in
    it, by its own report."""
    import signal

    path = os.path.join(tmp, "facts.json")
    proc.send_signal(signal.SIGUSR2)
    _poll(lambda: os.path.exists(path), "the dashboard's facts", 30)
    with open(path) as fh:
        return json.load(fh)


def _http_json(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as resp:
        return json.loads(resp.read())


def observe_serving(engine, rounds, n_tokens, card_label) -> dict:
    """6o (a), on 5s's runtime after its two rounds: the state API's LLM
    view holds the engine's requests and tokens; each streamed request's
    critical path sums to its TTFT, which stands beside the driver's; the
    dashboard, a process of its own, answers ``/api/llm`` and
    ``/api/critical_path`` with the same numbers and starts no CUDA."""
    import tempfile

    from ray_tpu_torch.util import state

    print(f"[obs-6o] prediction (PERF.md §6): {OBS_PREDICTION}", flush=True)
    t0 = time.perf_counter()
    requests = [r for rnd in rounds for r in rnd]
    n_req = len(requests)

    def llm_view():
        row = state.summarize_llm().get(engine, {})
        return row if row.get("requests") == n_req and \
            row.get("generated_tokens") == n_req * n_tokens else None

    # the engine's series reach the nodelet on a push interval
    llm = _poll(llm_view, f"the LLM view of {n_req} requests")
    paths, lines, ttft_rel = {}, [], []
    for i, (rid, driver_ttft) in enumerate(requests):
        out = _poll(lambda: state.critical_path(request_id=rid),
                    f"request {rid}'s critical path")
        mass = sum(out["buckets"].values())
        if abs(mass - out["ttft_s"]) > OBS_TTFT_RTOL * out["ttft_s"]:
            raise AssertionError(f"request {rid}: buckets {out['buckets']} "
                                 f"sum to {mass}, TTFT {out['ttft_s']}")
        gap = driver_ttft - out["ttft_s"]
        ttft_rel.append(abs(gap) / driver_ttft)
        paths[rid] = out
        lines.append(f"r{i // len(rounds[0])}.{i % len(rounds[0])} "
                     f"ttft_s={out['ttft_s']:.6f} driver={driver_ttft:.6f} "
                     f"gap={gap * 1e3:.3f}ms rel={ttft_rel[-1]:.4f} "
                     f"buckets_sum={mass:.6f} queue="
                     f"{out['buckets']['queue']:.6f} exec="
                     f"{out['buckets']['exec']:.6f} admission="
                     f"{out['buckets']['admission-wait']:.6f}")
    tmp = tempfile.mkdtemp(prefix="smoke_dash_")
    proc, port, start_s = _dashboard_process(tmp)
    try:
        dash_llm = _http_json(port, "/api/llm").get(engine, {})
        if (dash_llm.get("requests"), dash_llm.get("generated_tokens")) != \
                (llm["requests"], llm["generated_tokens"]):
            raise AssertionError(f"/api/llm {dash_llm} against the state "
                                 f"API's {llm}")
        for rid, out in paths.items():
            got = _http_json(port, f"/api/critical_path?request_id={rid}")
            if (got["ttft_s"], got["buckets"]) != (out["ttft_s"],
                                                   out["buckets"]):
                raise AssertionError(f"/api/critical_path for {rid}: {got}"
                                     f" against the state API's {out}")
        facts = _dashboard_facts(proc, tmp)
    finally:
        proc.kill()
        proc.wait(30)
        shutil.rmtree(tmp, ignore_errors=True)
    foreign = [m for m in facts["packages"] if m in OBS_FOREIGN]
    if facts["cuda_initialized"] or foreign:
        raise AssertionError(f"the dashboard process started CUDA "
                             f"({facts['cuda_initialized']}) or loaded "
                             f"{foreign}")
    rounds_rel = [ttft_rel[:len(rounds[0])], ttft_rel[len(rounds[0]):]]
    out = {"requests": n_req, "generated_tokens": llm["generated_tokens"],
           "ttft_rel_to_driver_max": [max(r) for r in rounds_rel],
           "ttft_rel_to_driver_median": [float(np.median(r))
                                         for r in rounds_rel],
           "dashboard_start_s": start_s,
           "dashboard_torch_loaded": "torch" in facts["packages"],
           "s": time.perf_counter() - t0}
    for line in lines:
        print(f"[obs-6o] (a) {line}", flush=True)
    print(f"[obs-6o] (a) summarize_llm()[{engine!r}]: requests "
          f"{llm['requests']:.0f}, generated tokens "
          f"{llm['generated_tokens']:.0f} (5s streamed {n_req} x {n_tokens});"
          f" every request's buckets sum to its TTFT (bar "
          f"{OBS_TTFT_RTOL:.0%}); the engine's TTFT against the driver's, "
          f"largest rel gap {out['ttft_rel_to_driver_max']} (cold, warm), "
          f"median {out['ttft_rel_to_driver_median']}; `python -m "
          f"ray_tpu_torch.dashboard` up in {start_s:.3f} s, /api/llm and "
          f"/api/critical_path equal to the state API's for {n_req} "
          f"requests, CUDA not initialised there, jax or ray_tpu modules "
          f"{foreign}; {out['s']:.3f} s on {card_label}", flush=True)
    return out


def observe_mpmd(experiment, card_label) -> dict:
    """6o (b), on 6m's runtime after its two-stage fit: the step's critical
    path from the stages' stamps, reconciled with the critical stage's
    BubbleClock; the last stage (``lm_head`` and the loss) the busiest.
    The critical stage is the one whose stamped wall is the longest
    (``critical_path.train_step``, the JAX package's rule); both stages'
    walls span the whole step, so which one that is follows which stage
    began the step first, and is printed for every step, not held."""
    from ray_tpu_torch._private import critical_path as cp
    from ray_tpu_torch.util import state

    t0 = time.perf_counter()

    def step(k):
        out = state.critical_path(step=k, experiment=experiment)
        return out if len(out["stages"]) == MPMD_STAGES else None

    out = _poll(lambda: step(OBS_STEP), f"step {OBS_STEP}'s stamps")
    mass = sum(out["buckets"].values())
    clock = out["bubble_clock"]
    bubble_gap = abs(out["bubble_fraction"] - clock["bubble_fraction"])
    steps = {k: _poll(lambda: step(k), f"step {k}'s stamps")
             for k in range(1, TRAIN_STEPS)}
    others = {k: o["critical_stage"] for k, o in steps.items()}

    def busiest(o):
        return max(o["stages"], key=lambda st: st["buckets"]["exec"])[
            "stage"]
    busy = {k: busiest(o) for k, o in steps.items()}
    print(f"[obs-6o] (b) {cp.render_tree(out)}".replace(
        "\n", "\n[obs-6o] (b) "), flush=True)
    print(f"[obs-6o] (b) state.critical_path(step={OBS_STEP}, "
          f"experiment={experiment!r}): critical stage "
          f"{out['critical_stage']} (steps 1-{TRAIN_STEPS - 1}: {others}), "
          f"path {out['path_s']:.6f} s, bucket mass {mass:.6f} s (bar "
          f"{OBS_MASS_ATOL:.0e} s), its BubbleClock step wall "
          f"{clock['step_wall_s']} s; bubble fraction "
          f"{out['bubble_fraction']:.6f} against the clock's "
          f"{clock['bubble_fraction']} (bar {OBS_BUBBLE_ATOL}) on "
          f"{card_label}", flush=True)
    print(f"[obs-6o] (b) the busiest stage (exec bucket) by step: {busy}",
          flush=True)
    if set(busy.values()) != {MPMD_STAGES - 1}:
        raise AssertionError(f"the busiest stage by step is {busy}, not the "
                             f"last (lm_head and the loss)")
    if abs(mass - out["path_s"]) > OBS_MASS_ATOL or \
            bubble_gap >= OBS_BUBBLE_ATOL:
        raise AssertionError(f"step {OBS_STEP}: bucket mass {mass} against "
                             f"the wall {out['path_s']}, bubble fraction "
                             f"{out['bubble_fraction']} against {clock}")
    return {"step": OBS_STEP, "critical_stage": out["critical_stage"],
            "critical_by_step": others, "busiest_by_step": busy,
            "path_s": out["path_s"],
            "buckets": out["buckets"],
            "bubble_fraction": out["bubble_fraction"],
            "bubble_clock": clock, "s": time.perf_counter() - t0}


def observe_fit(trace_id, fit_s, card_label) -> dict:
    """6o (c), on 6g's runtime: the critical path of the trace around its
    first fit holds the worker's training-loop call and is no longer than
    the fit; ``export_otlp`` writes the trace with its on-path spans."""
    import tempfile

    from ray_tpu_torch._private import critical_path as cp
    from ray_tpu_torch.util import state
    from ray_tpu_torch.util.tracing import export_otlp

    t0 = time.perf_counter()

    def on_path():
        out = state.critical_path(trace_id=trace_id)
        names = {n["name"].rsplit(".", 1)[-1] for n in out["nodes"]
                 if n["span_id"] in out["on_path_span_ids"]}
        return out if "session_start" in names else None

    out = _poll(on_path, "the fit's training-loop call on its path")
    mass = sum(out["buckets"].values())
    # the trace's clock is time.time(), the fit's perf_counter: 2 ms apart
    # at most
    if out["path_s"] > fit_s + 2e-3 or abs(mass - out["path_s"]) > \
            OBS_MASS_ATOL:
        raise AssertionError(f"the fit's path {out['path_s']} s (buckets "
                             f"{mass}) against its wall {fit_s} s")
    fd, path = tempfile.mkstemp(prefix="smoke_otlp_", suffix=".json")
    os.close(fd)
    try:
        n_spans = export_otlp(path, trace_id=trace_id)
        with open(path) as fh:
            spans = json.load(fh)["resourceSpans"][0]["scopeSpans"][0][
                "spans"]
    finally:
        os.unlink(path)
    tagged = [s["name"] for s in spans if any(
        a["key"] == "ray_tpu_torch.on_critical_path"
        for a in s["attributes"])]
    if not tagged or n_spans != len(spans):
        raise AssertionError(f"export_otlp wrote {n_spans} spans, "
                             f"{len(spans)} read back, on the path {tagged}")
    print(f"[obs-6o] (c) {cp.render_tree(out)}".replace(
        "\n", "\n[obs-6o] (c) "), flush=True)
    print(f"[obs-6o] (c) the trace around 6g's first fit: path "
          f"{out['path_s']:.6f} s of the fit's {fit_s:.6f} s, "
          f"{len(out['on_path_span_ids'])} spans on it; export_otlp wrote "
          f"{n_spans} spans, {len(tagged)} tagged on_critical_path "
          f"{sorted(set(tagged))} on {card_label}", flush=True)
    return {"path_s": out["path_s"], "fit_s": fit_s,
            "buckets": out["buckets"], "spans": n_spans,
            "on_path_spans": len(tagged), "s": time.perf_counter() - t0}


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
    from ray_tpu_torch._native import build
    from ray_tpu_torch.models import ShardedPretrainer

    build.build_channel()  # the MPMD cases' workers load it
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
    # the MPMD cases: stage actors on the CPU, two replicas over the ring
    _, bad = mpmd_cases(0, "cpu")
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
    from ray_tpu_torch.util.tracing import trace_span

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
            if fail:
                result = trainer.fit()
            else:
                # 6o (c): the first fit inside a span of its own
                with trace_span("smoke-6g-fit") as span:
                    result = trainer.fit()
                trace_id = span.trace_id
            runs[name] = (result, time.perf_counter() - t0)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    observed = observe_fit(trace_id, runs["plain"][1], card_label)
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
    # the parameters stay in the object store for phase 6t
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
        "observed": observed, "phase_s": phase_s,
        "resources": resources}, params_ref


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


# ------------------------------------------------------------ phase 6t
# Data -> Train -> Tune: phase 6's batch as TRAIN_STEPS .npy shards of one
# batch each, read back through ray_tpu_torch.data into TorchTrainer
# (datasets=), then a Tuner running two such trainers side by side on card 0
TUNE_LRS = (3e-4, 1e-3)  # phase 6's rate (ShardedPretrainer's), and 3x it
TUNE_GPUS_PER_WORKER = 0.5
DATA_FOREIGN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")
# (c): MARWIL's update on the card against the CPU's, f32 with TF32 off, at
# tests/test_rllib.py:316-345's batch
MARWIL_BATCH, MARWIL_MINIBATCH, MARWIL_EPISODES = 1024, 128, 30
MARWIL_LOSS_RTOL, MARWIL_PARAM_RTOL, MARWIL_NORM_RTOL = 1e-5, 1e-5, 1e-6
# what PERF.md predicted before the phase first ran on the card
DATA_TUNE_PREDICTION = (
    "(a) losses bit for bit 6g's, 120 launches of each kernel, step ms "
    "within 2% of 6g's, ingest median 1-5 ms (under 5% of a step) and max "
    "2-15 s (the first batch: the pipeline's cold start), fit 25-40 s; (b) "
    "both trials on card 0 overlapping, the 3e-4 trial bit for bit (a)'s "
    "last loss, the 1e-3 trial the best, each trial's step 1.7-2.1x (a)'s "
    "(two processes time-slicing one card), the sweep 40-70 s; (c) losses "
    "and parameters within 1e-6, the norm within 1e-7; the phase 70-110 s")


def _no_cuda_here(what: str) -> None:
    """Raise in a data task's process (``what``) where CUDA is up or a
    foreign module is loaded: only the train worker touches the card."""
    torch_mod = sys.modules.get("torch")
    if torch_mod is not None and torch_mod.cuda.is_initialized():
        raise RuntimeError(f"CUDA is up in {what}'s process (pid "
                           f"{os.getpid()})")
    foreign = [m for m in sys.modules if m.split(".")[0] in DATA_FOREIGN]
    if foreign:
        raise RuntimeError(f"{what}'s process loaded {foreign}")


def _widen_shard(batch):
    """``map_batches``' function: a shard's int32 (rows, 2, S) rows as
    int64 ``input_ids`` and ``targets``."""
    _no_cuda_here("a map task")
    rows = batch["data"]
    return {"input_ids": rows[:, 0].astype(np.int64),
            "targets": rows[:, 1].astype(np.int64)}


def _shards_dataset(path: str):
    """``read_numpy(path).map_batches(_widen_shard)``, read_numpy's own
    reader (``read_datasource(NumpyDatasource(path))``) with each read
    task first checking its process (``_no_cuda_here``)."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.data.datasource import NumpyDatasource

    class CheckedNumpyDatasource(NumpyDatasource):
        def read_file(self, file):
            _no_cuda_here("a read task")
            return NumpyDatasource.read_file(self, file)

    return rd.read_datasource(CheckedNumpyDatasource(path)).map_batches(
        _widen_shard, batch_format="numpy")


def _wait_for_peers(barrier) -> float:
    """Each of ``barrier = (directory, n)``'s workers announces itself
    there and waits for all ``n``, so that trials sharing the card step at
    once; returns the seconds waited (0 without a barrier)."""
    if barrier is None:
        return 0.0
    path, n = barrier
    open(os.path.join(path, str(os.getpid())), "w").close()
    t0, deadline = time.perf_counter(), time.monotonic() + 180
    while len(os.listdir(path)) < n:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{len(os.listdir(path))} of {n} workers "
                               f"reached the barrier in 180 s")
        time.sleep(0.01)
    return time.perf_counter() - t0


def _data_loop(config):
    """Phase 6's bf16 run in a train worker, each step's batch pulled from
    the trainer's dataset shard (``iter_torch_batches`` onto the worker's
    card), from the parameters 6g put in the object store, at
    ``config["lr"]``, its first step after ``config["barrier"]``'s peers
    are ready.  At the last step: the worker's counters, its card and the
    coordinator's process."""
    start_s = time.time() - config["t_fit"]
    import ray_tpu_torch
    from ray_tpu_torch import train
    from ray_tpu_torch._native import build
    from ray_tpu_torch.models import GPT2Config, ShardedPretrainer
    from ray_tpu_torch.train.torch_config import _pci_bus_id

    cfg = GPT2Config(remat=False)
    params = ray_tpu_torch.get(config["params"])
    # torch's lazy imports at a process's first optimizer, as in 6g
    torch.optim.AdamW([torch.zeros(1, device="cuda", requires_grad=True)])
    trainer = ShardedPretrainer(cfg, lr=config["lr"], params=params)
    del params
    shard = train.get_dataset_shard("train")
    batches = iter(shard.iter_torch_batches(
        batch_size=TRAIN_BATCH, drop_last=True, device=trainer.device))
    torch.cuda.synchronize()
    _zero_counts()
    ingest, computes, window = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batch = next(batches)
        ingest.append(time.perf_counter() - t0)
        if i == 0:
            waited_s = _wait_for_peers(config["barrier"])
            window.append(time.time())
        t0 = time.perf_counter()
        loss = trainer.step(batch).item()
        computes.append(time.perf_counter() - t0)
        metrics = {"step": i, "loss": loss}
        if i + 1 == TRAIN_STEPS:
            window.append(time.time())
            left = sum(1 for _ in batches)  # the shard holds TRAIN_STEPS
            metrics.update(
                launches=_read_counts(), window=window, left=left,
                start_s=start_s, waited_s=waited_s, pid=os.getpid(),
                device=str(trainer.device),
                dtypes=[str(batch[k].dtype) for k in sorted(batch)],
                pci_bus_id=_pci_bus_id(torch.cuda.current_device()),
                builds=list(build.compiled),
                foreign=[m for m in sys.modules
                         if m.split(".")[0] in DATA_FOREIGN],
                coordinator=ray_tpu_torch.get(
                    shard._coord.process_facts.remote(), timeout=60),
                ingest_ms=[t * 1e3 for t in ingest],
                compute_ms=[t * 1e3 for t in computes])
        train.report(metrics)


def _data_run_checks(name, last, hist, want_launches) -> list:
    """What one run of ``_data_loop`` must show: every step reported,
    finite losses, the shard used up exactly, the kernels' launches, the
    worker on card 0 with no foreign module and no build, and a
    coordinator with neither CUDA nor a foreign module."""
    faults = []
    losses = [m["loss"] for m in hist]
    if [m["step"] for m in hist] != list(range(TRAIN_STEPS)) or \
            not all(np.isfinite(losses)):
        faults.append(f"{name}: reported {[m['step'] for m in hist]}, "
                      f"losses {losses}")
    if last["left"]:
        faults.append(f"{name}: {last['left']} batches left in the shard")
    if last["launches"] != want_launches:
        faults.append(f"{name}: the worker's launches {last['launches']}, "
                      f"expected {want_launches}")
    if last["device"] != "cuda:0" or last["foreign"] or last["builds"] or \
            last["dtypes"] != ["torch.int64", "torch.int64"]:
        faults.append(f"{name}: the worker trained on {last['device']} "
                      f"from {last['dtypes']}, loaded {last['foreign']}, "
                      f"built {last['builds']}")
    coord = last["coordinator"]
    coord_foreign = [m for m in coord["packages"] if m in DATA_FOREIGN]
    if coord["cuda_initialized"] or coord_foreign:
        faults.append(f"{name}: the split coordinator (pid "
                      f"{coord['pid']}) has CUDA up: "
                      f"{coord['cuda_initialized']}, loaded {coord_foreign}")
    return faults


def _marwil_card_vs_cpu() -> dict:
    """(c) One ``_marwil_update`` on the card against the same update on
    the CPU: the same initial parameters, the same batch of recorded
    CartPole steps (the heuristic policy's, built in memory: the JSON
    writer needs pandas), in the same minibatches."""
    from ray_tpu_torch.rllib.core.learner import make_optimizer
    from ray_tpu_torch.rllib.core.rl_module import DiscretePolicyModule
    from ray_tpu_torch.rllib.offline import _marwil_update, rollout_rows

    rows, returns = rollout_rows("CartPole-v1", MARWIL_EPISODES, seed=3)
    idx = np.random.default_rng(1).integers(0, len(rows), MARWIL_BATCH)
    batch = {
        "obs": torch.tensor([rows[i]["obs"] for i in idx],
                            dtype=torch.float32),
        "action": torch.tensor([rows[i]["action"] for i in idx]),
        "return_to_go": torch.tensor([rows[i]["return_to_go"] for i in idx],
                                     dtype=torch.float32)}
    host = DiscretePolicyModule(4, 2, generator=torch.Generator()
                                .manual_seed(1))
    card = DiscretePolicyModule(4, 2).to("cuda")
    card.load_state(host.state())
    out = {}
    for name, mod, dev in (("cpu", host, "cpu"), ("card", card, "cuda")):
        params = [p for _, p in mod.named_params()]
        events = [torch.cuda.Event(enable_timing=True) for _ in "se"]
        events[0].record()
        norm, pi, vf = _marwil_update(
            mod, params, make_optimizer(params, 1e-3),
            torch.tensor(1.0, device=dev),
            {k: v.to(dev) for k, v in batch.items()}, beta=1.0,
            vf_coef=1.0, minibatch=MARWIL_MINIBATCH, grad_clip=10.0)
        events[1].record()
        torch.cuda.synchronize()
        out[name] = (norm.item(), pi.cpu(), vf.cpu(), mod.state(),
                     events[0].elapsed_time(events[1]))
    norm_h, pi_h, vf_h, state_h, _ = out["cpu"]
    norm_c, pi_c, vf_c, state_c, card_ms = out["card"]
    loss_err = max(float(((pi_c - pi_h).abs() / pi_h.abs()).max()),
                   float(((vf_c - vf_h).abs() / vf_h.abs()).max()))
    param_err = max(float((state_c[k] - v).norm() / v.norm())
                    for k, v in state_h.items() if v.norm() > 0)
    norm_err = _rel(norm_c, norm_h)
    print(f"[data-tune] (c) MARWIL (beta 1) on the card against the CPU, "
          f"{MARWIL_BATCH} rows of {len(rows)} recorded steps "
          f"({MARWIL_EPISODES} episodes, behavior return "
          f"{float(np.mean(returns)):.1f}), {len(pi_h)} minibatches of "
          f"{MARWIL_MINIBATCH}, TF32 off: every minibatch's policy and "
          f"value losses max rel {loss_err:.3e} (bar {MARWIL_LOSS_RTOL}), "
          f"parameters largest rel norm {param_err:.3e} (bar "
          f"{MARWIL_PARAM_RTOL}), norm rel {norm_err:.3e} (bar "
          f"{MARWIL_NORM_RTOL}); the update {card_ms:.3f} ms on the card",
          flush=True)
    if loss_err > MARWIL_LOSS_RTOL or param_err > MARWIL_PARAM_RTOL or \
            norm_err > MARWIL_NORM_RTOL:
        raise AssertionError(f"MARWIL's update on the card is not the "
                             f"CPU's: losses {loss_err}, parameters "
                             f"{param_err}, norm {norm_err}")
    return {"loss_rel": loss_err, "param_rel_norm": param_err,
            "norm_rel": norm_err, "update_ms": card_ms,
            "pi_losses": pi_c.tolist(), "vf_losses": vf_c.tolist()}


def data_tune_train(card_label, runtime, params_ref) -> tuple:
    """Phase 6t, on 6g's runtime: (a) phase 6's bf16 run through
    ``TorchTrainer(datasets=)`` from ``read_numpy`` shards, against 6g's
    ``runtime`` result; (b) a ``Tuner`` over that trainer, two learning
    rates side by side on card 0; (c) MARWIL's update on the card against
    the CPU's.  Every part runs, and the phase fails at the end if any
    failed.  Returns the launches of (a) and of (b)'s two trials."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rd
    from ray_tpu_torch import tune
    from ray_tpu_torch.models import GPT2Config
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.torch_config import _pci_bus_id

    t_phase = time.perf_counter()
    print(f"[data-tune] prediction (PERF.md §6): {DATA_TUNE_PREDICTION}",
          flush=True)
    cfg = GPT2Config(remat=False)
    calls = cfg.n_layer * TRAIN_STEPS
    want = {"flash_fwd": calls, "flash_fwd_combine": 0, "flash_bwd_delta": 0,
            "flash_bwd_dkdv": calls, "flash_bwd_dq": calls,
            "fused:flash_fwd_combine": 0, "fused:flash_bwd_delta": calls}
    out, failed = {}, []
    launches = {"data": None, "tune": None}
    storage = tempfile.mkdtemp(prefix="smoke_data_tune_")
    try:
        # the driver writes phase 6's batch as int32 (2, S) rows, one .npy
        # shard a batch
        b = _train_batch(cfg, TRAIN_BATCH, 0)
        rows = np.stack([b["input_ids"], b["targets"]], 1).astype(np.int32)
        shards = os.path.join(storage, "shards")
        t0 = time.perf_counter()
        rd.from_numpy([rows] * TRAIN_STEPS).write_numpy(shards)
        write_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(shards, f))
                     for f in os.listdir(shards))
        ds = _shards_dataset(shards)
        loop_config = {"params": params_ref, "lr": TUNE_LRS[0],
                       "barrier": None}

        # (a) Data into TorchTrainer
        a = None
        try:
            trainer = TorchTrainer(
                _data_loop,
                train_loop_config={**loop_config, "t_fit": time.time()},
                datasets={"train": ds},
                scaling_config=ScalingConfig(num_workers=1),
                run_config=RunConfig(name="smoke-data",
                                     storage_path=storage))
            t0 = time.perf_counter()
            result = trainer.fit()
            fit_s = time.perf_counter() - t0
            hist, last = result.metrics_history, result.metrics
            a = [m["loss"] for m in hist]
            faults = _data_run_checks("(a)", last, hist, want)
            rel = max(abs(x - y) / abs(y) for x, y in
                      zip(a, runtime["losses"]))
            if rel > BF16_LOSS_RTOL:
                faults.append(f"(a): losses {a} against 6g's "
                              f"{runtime['losses']}: rel {rel:.3e}")
            launches["data"] = last["launches"]
            step_ms = float(np.mean(last["compute_ms"][2:]))
            ingest = last["ingest_ms"]
            out["data"] = {
                "losses": a, "bit_equal_to_6g": a == runtime["losses"],
                "max_rel_to_6g": rel, "step_ms": step_ms,
                "6g_step_ms": runtime["step_ms"],
                "ingest_median_ms": float(np.median(ingest)),
                "ingest_max_ms": float(np.max(ingest)),
                "ingest_ms": ingest,
                "ingest_share": float(np.median(ingest)) / step_ms,
                "fit_s": fit_s, "start_s": last["start_s"],
                "write_s": write_s, "shard_bytes": nbytes}
            print(f"[data-tune] (a) read_numpy's reader ({TRAIN_STEPS} shards, "
                  f"{nbytes / 1e6:.3f} MB, written in {write_s:.3f} s) -> "
                  f"map_batches -> TorchTrainer(datasets=), 1 GPU worker "
                  f"({last['device']}, PCI {last['pci_bus_id']}): losses "
                  f"{[round(x, 4) for x in a]}, bit equal to 6g's: "
                  f"{a == runtime['losses']} (max rel {rel:.3e}, bar "
                  f"{BF16_LOSS_RTOL:.3e}); step_ms={step_ms:.3f} (steps "
                  f"3-10, the worker's clock) against 6g's "
                  f"{runtime['step_ms']:.3f}; ingest (the iterator's next, "
                  f"host) median {np.median(ingest):.3f} ms max "
                  f"{np.max(ingest):.3f} ms; fit {fit_s:.3f} s; worker "
                  f"launches {last['launches']}; the coordinator (pid "
                  f"{last['coordinator']['pid']}) with CUDA up: "
                  f"{last['coordinator']['cuda_initialized']}; faults "
                  f"{faults} on {card_label}", flush=True)
            failed += faults
        except Exception as err:
            failed.append(f"(a): {err!r}")
            print(f"[data-tune] (a): FAILED: {err!r}", flush=True)

        # (b) a Tuner over that trainer: two rates side by side on card 0
        try:
            barrier = os.path.join(storage, "barrier")
            os.makedirs(barrier)
            trainer = TorchTrainer(
                _data_loop,
                train_loop_config={**loop_config, "t_fit": time.time(),
                                   "barrier": (barrier, len(TUNE_LRS))},
                datasets={"train": ds},
                scaling_config=ScalingConfig(
                    num_workers=1, gpus_per_worker=TUNE_GPUS_PER_WORKER))
            tuner = tune.Tuner(
                trainer, param_space={"lr": tune.grid_search(
                    list(TUNE_LRS))},
                tune_config=tune.TuneConfig(metric="loss", mode="min",
                                            max_concurrent_trials=2),
                run_config=RunConfig(name="smoke-tune",
                                     storage_path=storage))
            t0 = time.perf_counter()
            grid = tuner.fit()
            sweep_s = time.perf_counter() - t0
            faults = [f"(b): trial errors {grid.errors}"] \
                if grid.errors or len(grid) != 2 else []
            trials = {r.metrics["config"]["lr"]: r for r in grid}
            lasts = {lr: r.metrics for lr, r in trials.items()}
            for lr, r in trials.items():
                faults += _data_run_checks(f"(b) lr {lr}", lasts[lr],
                                           r.metrics_history, want)
            windows = [m["window"] for m in lasts.values()]
            overlap = max(w[0] for w in windows) < min(w[1] for w in windows)
            card0 = _pci_bus_id(0)
            buses = {m["pci_bus_id"] for m in lasts.values()}
            if not overlap or buses != {card0}:
                faults.append(f"(b): step windows {windows} (overlap "
                              f"{overlap}) on cards {buses}, card 0 is "
                              f"{card0}")
            ref = lasts[TUNE_LRS[0]]["loss"]
            rel = abs(ref - a[-1]) / abs(a[-1]) if a else float("inf")
            if rel > BF16_LOSS_RTOL:
                faults.append(f"(b): the trial at {TUNE_LRS[0]} ended on "
                              f"{ref!r}, (a) on {a[-1] if a else None!r}")
            best = grid.get_best_result()
            if best.metrics["loss"] != min(m["loss"]
                                           for m in lasts.values()):
                faults.append(f"(b): best {best.metrics['config']} is not "
                              f"the lowest last loss {lasts}")
            state = os.path.join(storage, "smoke-tune", "tuner_state.json")
            if not os.path.exists(state):
                faults.append(f"(b): no {state}")
            launches["tune"] = {k: sum(m["launches"][k]
                                       for m in lasts.values())
                                for k in want}
            step = {lr: float(np.mean(m["compute_ms"][2:]))
                    for lr, m in lasts.items()}
            out["tune"] = {
                "last_loss": {str(lr): m["loss"] for lr, m in lasts.items()},
                "losses": {str(lr): [h["loss"] for h in r.metrics_history]
                           for lr, r in trials.items()},
                "bit_equal_to_a": bool(a) and ref == a[-1],
                "rel_to_a": rel, "best_lr": best.metrics["config"]["lr"],
                "step_ms": {str(k): v for k, v in step.items()},
                "windows": windows, "overlap": overlap,
                "pci_bus_ids": sorted(buses), "sweep_s": sweep_s,
                "waited_s": {str(lr): m["waited_s"]
                             for lr, m in lasts.items()},
                "ingest_median_ms": {
                    str(lr): float(np.median(m["ingest_ms"]))
                    for lr, m in lasts.items()}}
            print(f"[data-tune] (b) Tuner over TorchTrainer(datasets=, "
                  f"gpus_per_worker={TUNE_GPUS_PER_WORKER}), lr grid "
                  f"{list(TUNE_LRS)}, max_concurrent_trials=2: last losses "
                  f"{out['tune']['last_loss']}; the trial at "
                  f"{TUNE_LRS[0]} ends on (a)'s last loss bit for bit: "
                  f"{out['tune']['bit_equal_to_a']} (rel {rel:.3e}); best "
                  f"lr {best.metrics['config']['lr']}; step windows "
                  f"overlap: {overlap}, cards {sorted(buses)}; step_ms "
                  f"{ {k: round(v, 3) for k, v in step.items()} } (two "
                  f"processes time-slicing one card) against (a)'s "
                  f"{out.get('data', {}).get('step_ms', float('nan')):.3f}"
                  f"; each waited {out['tune']['waited_s']} s for the "
                  f"other; the sweep {sweep_s:.3f} s; launches (both trials) "
                  f"{launches['tune']}; tuner_state.json written: "
                  f"{os.path.exists(state)}; faults {faults}", flush=True)
            failed += faults
        except Exception as err:
            failed.append(f"(b): {err!r}")
            print(f"[data-tune] (b): FAILED: {err!r}", flush=True)
    finally:
        shutil.rmtree(storage, ignore_errors=True)

    # (c) MARWIL's update on the card against the CPU's
    try:
        out["marwil"] = _marwil_card_vs_cpu()
    except Exception as err:
        failed.append(f"(c): {err!r}")
        print(f"[data-tune] (c): FAILED: {err!r}", flush=True)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[data-tune] the phase {out['phase_s']:.3f} s on {card_label}",
          flush=True)
    if failed:
        raise AssertionError("phase 6t failed: " + "; ".join(failed))
    return launches["data"], launches["tune"], out


# ------------------------------------------------------------ phase 6m
# the MPMD pipeline: TorchTrainer(pipeline_stages=2) over stage actors
MPMD_STAGES, MPMD_MICRO = 2, 4
# the loop's lr: its warmup-cosine schedule ramps over 100 steps, so a
# peak of 1e-2 gives 1e-4 x step, enough for the loss on the loop's fresh
# seeded batch of each step to fall over 10 steps
MPMD_LR = 1e-2
MPMD_TIMEOUT_S = 600


def _mpmd_config(job, dtype="bfloat16", batch=TRAIN_BATCH,
                 steps=TRAIN_STEPS, device=None, widths=None, lr=MPMD_LR):
    """``gpt2_pipeline_loop``'s config: GPT-2-small (flash, no remat) in
    ``dtype``, ``batch`` x TRAIN_SEQ rows a step for ``steps`` steps (at
    ``widths`` and 32 positions instead on the CPU)."""
    from ray_tpu_torch.models import GPT2Config

    gpt = GPT2Config()
    model = {"vocab_size": gpt.vocab_size, "n_positions": gpt.n_positions,
             "n_embd": gpt.n_embd, "n_layer": gpt.n_layer,
             "n_head": gpt.n_head, "remat": False, "dtype": dtype}
    seq = TRAIN_SEQ
    if widths is not None:
        model.update(widths, n_positions=32)
        seq = 32
    return {"steps": steps, "batch_size": batch, "seq_len": seq,
            "lr": lr, "seed": 0, "timeout_s": MPMD_TIMEOUT_S,
            "job": job, "device": device, "model": model}


def _mpmd_loop(config):
    """``gpt2_pipeline_loop`` in a stage worker, with its counters set to 0
    just before the executor's first step and, on the last step's report,
    what that worker saw: its launches, its card, peak memory, the
    caching allocator's new segments (``cudaMalloc`` calls) in each step,
    the tensor bytes of the frames it sent on each link, whether each
    link's channel runs on the native library, the modules it loaded and
    the kernels it built.  The trainer keeps rank 0's reports only, so
    each worker also writes every report it made to
    ``stage<k>-r<replica>.json`` under ``config["smoke_dir"]`` (one
    host)."""
    from ray_tpu_torch import train
    from ray_tpu_torch._native import build
    from ray_tpu_torch.train.pipeline import gpt2_pipeline_loop, schedule
    from ray_tpu_torch.train.torch_config import _pci_bus_id

    executor = schedule.StageExecutor
    first_step, seen = executor.train_step, {}
    report = train.report
    cuda = config.get("device") in (None, "cuda")

    def segments() -> int:
        return torch.cuda.memory_stats().get("segment.all.allocated", 0)

    def counted_step(self, batch):
        if self.step_idx == 0:
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                seen["segments"] = [segments()]
            _zero_counts()
            seen["ex"] = self
        out = first_step(self, batch)
        if cuda:
            seen["segments"].append(segments())
        return out

    def reporting(metrics, checkpoint=None):
        ex = seen.get("ex")
        if ex is not None and metrics.get("step") == config["steps"] - 1:
            if cuda:
                torch.cuda.synchronize()
            metrics = dict(
                metrics, launches=_read_counts(), device=str(ex.device),
                frame_bytes=dict(ex.frame_bytes),
                native={k: getattr(link._ch, "_lib", None) is not None
                        for k, link in ex.links.items()},
                builds=list(build.compiled),
                foreign=[m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu")])
            if cuda:
                metrics.update(
                    card=torch.cuda.get_device_name(),
                    pci_bus_id=_pci_bus_id(torch.cuda.current_device()),
                    peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                    new_segments=np.diff(seen["segments"]).tolist())
        if "loss" in metrics:
            seen.setdefault("reports", []).append(metrics)
            if metrics["step"] == config["steps"] - 1:
                name = f"stage{metrics['stage']}-r{metrics['replica']}.json"
                with open(os.path.join(config["smoke_dir"], name), "w") as f:
                    json.dump(seen["reports"], f)
        return report(metrics, checkpoint=checkpoint)

    executor.train_step, train.report = counted_step, reporting
    try:
        gpt2_pipeline_loop(config)
    finally:
        executor.train_step, train.report = first_step, report


def _mpmd_fit(config, n_stages, workers, gpus_per_worker, name, dp=1):
    """One TorchTrainer fit of ``_mpmd_loop``; (each stage's reports of
    replica 0, in step order, by stage; the fit's seconds)."""
    import tempfile

    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    storage = tempfile.mkdtemp(prefix="smoke_mpmd_")
    config = dict(config, smoke_dir=storage)
    trainer = TorchTrainer(
        _mpmd_loop, train_loop_config=config,
        scaling_config=ScalingConfig(
            num_workers=workers, use_gpu=gpus_per_worker > 0,
            gpus_per_worker=gpus_per_worker or 1.0),
        run_config=RunConfig(name=name, storage_path=storage),
        pipeline_stages=n_stages, num_microbatches=MPMD_MICRO,
        mesh=(dp, 1) if dp > 1 else None)
    t0 = time.perf_counter()
    try:
        trainer.fit()
        fit_s = time.perf_counter() - t0
        hist = {}
        for stage in range(n_stages):
            with open(os.path.join(storage, f"stage{stage}-r0.json")) as f:
                hist[stage] = json.load(f)
    finally:
        shutil.rmtree(storage, ignore_errors=True)
    for stage, ms in hist.items():
        if [m["step"] for m in ms] != list(range(config["steps"])):
            raise AssertionError(f"{name} stage {stage} reported {ms}")
    return hist, fit_s


def _stage_line(stage, ms, launches_want) -> dict:
    """A stage's numbers from its history, checked: its launches, no new
    allocator segment in step 1 (the stage reached its steady memory in
    step 0), its links on the native channel, no jax or ray_tpu module, no
    build."""
    last = ms[-1]
    if launches_want is not None and last["launches"] != launches_want:
        raise AssertionError(f"stage {stage}'s launches {last['launches']},"
                             f" expected {launches_want}")
    segments = last.get("new_segments")
    if segments is not None and segments[1]:
        raise AssertionError(f"stage {stage} took new allocator segments "
                             f"in step 1: {segments} by step")
    if not all(last["native"].values()) or last["foreign"] or \
            last["builds"]:
        raise AssertionError(
            f"stage {stage}: native channel {last['native']}, loaded "
            f"{last['foreign']}, built {last['builds']}")
    keys = ("step_wall_s", "busy_s", "xfer_s", "bubble_s", "bubble_fraction",
            "comm_s", "dp_wire_bytes")
    # steps 3-10, as phase 6 times its steps
    mean = {k: float(np.mean([m[k] for m in ms[2:]])) for k in keys}
    return {"stage": stage, **mean,
            **{k: last.get(k) for k in ("launches", "device", "card",
                                         "pci_bus_id", "peak_memory_gb",
                                         "new_segments", "frame_bytes",
                                         "native", "foreign", "builds")}}


def _mpmd_f32_step(device="cuda", widths=None) -> dict:
    """One f32 step at batch PARITY_BATCH (M 4) of the loop's first batch,
    two stages (each StageExecutor in a thread of this process, over a
    pair of ShmChannel links) against one; (loss, grad norm) of each."""
    import dataclasses
    import threading

    from ray_tpu_torch.experimental.channel import ShmChannel
    from ray_tpu_torch.models import GPT2Config
    from ray_tpu_torch.train.pipeline import (
        GPT2StageModule,
        StageExecutor,
        StageLink,
    )
    from ray_tpu_torch.train.pipeline.loop import frame_slot_bytes

    cfg = GPT2Config(remat=False, dtype=torch.float32)
    seq = TRAIN_SEQ
    if widths is not None:
        cfg, seq = dataclasses.replace(cfg, **widths, n_positions=32), 32
    rng = np.random.default_rng(0)  # the loop's step 0 of seed 0
    batch = {k: rng.integers(0, cfg.vocab_size, (PARITY_BATCH, seq),
                             dtype=np.int32)
             for k in ("input_ids", "targets")}
    full = GPT2StageModule(cfg, 0, 1, device="cpu").init_params(0)
    kw = dict(n_micro=MPMD_MICRO, lr=MPMD_LR, total_steps=101, params=full)
    one = StageExecutor(GPT2StageModule(cfg, 0, 1, device=device), **kw)
    out1 = one.train_step(batch)
    del one
    slot = frame_slot_bytes(PARITY_BATCH // MPMD_MICRO, seq, cfg.n_embd, 4)
    act = ShmChannel(create=True, slot_size=slot, depth=6)
    grad = ShmChannel(create=True, slot_size=slot, depth=6)
    links = ({"act_out": StageLink(act, peer_stage=1, role="w"),
              "grad_in": StageLink(ShmChannel(grad.name), peer_stage=1,
                                   role="r")},
             {"act_in": StageLink(ShmChannel(act.name), peer_stage=0,
                                  role="r"),
              "grad_out": StageLink(grad, peer_stage=0, role="w")})
    execs = [StageExecutor(GPT2StageModule(cfg, s, 2, device=device),
                           links=links[s], **kw) for s in range(2)]
    errs = []

    def second():
        try:
            execs[1].train_step(batch)
        except Exception as e:  # raised below
            errs.append(e)

    thread = threading.Thread(target=second)
    thread.start()
    out2 = execs[0].train_step(batch)
    thread.join(300)
    for ex in execs:
        ex.close()
    if errs:
        raise errs[0]
    got = {"one": (out1["loss"], out1["grad_norm"]),
           "two": (out2["loss"], out2["grad_norm"])}
    (l1, n1), (l2, n2) = got["one"], got["two"]
    if not (abs(l2 - l1) <= F32_LOSS_RTOL * abs(l1)
            and abs(n2 - n1) <= F32_NORM_RTOL * abs(n1)):
        raise AssertionError(f"f32 step, two stages against one: {got} "
                             f"(bars {F32_LOSS_RTOL}, {F32_NORM_RTOL})")
    return got


def mpmd_train(card_label) -> tuple:
    """Phase 6m: GPT-2-small's bf16 run through TorchTrainer(
    gpt2_pipeline_loop, pipeline_stages=2, num_microbatches=4) on two stage
    worker actors sharing card 0 (gpus_per_worker=0.5), against the same
    loop at pipeline_stages=1 on one worker; then the f32 step two stages
    against one.  Ends with ray_tpu_torch.shutdown(), which must leave no
    process of the session."""
    import ray_tpu_torch as rt
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.models import GPT2Config
    from ray_tpu_torch.train.pipeline import theoretical_bubble_fraction

    t_phase = time.perf_counter()
    rt.init(ignore_reinit_error=True)
    session_dir = worker_mod.global_worker().node.session_dir
    try:
        n_layer = GPT2Config().n_layer
        calls = (n_layer // MPMD_STAGES) * MPMD_MICRO * TRAIN_STEPS
        want = {"flash_fwd": calls, "flash_fwd_combine": 0,
                "flash_bwd_delta": 0, "flash_bwd_dkdv": calls,
                "flash_bwd_dq": calls, "fused:flash_fwd_combine": 0,
                "fused:flash_bwd_delta": calls}
        hist2, fit2_s = _mpmd_fit(_mpmd_config("smoke-mpmd2"), MPMD_STAGES,
                                  MPMD_STAGES, 0.5, "smoke-mpmd2")
        stages = [_stage_line(s, hist2[s], want) for s in range(MPMD_STAGES)]
        buses = {s["pci_bus_id"] for s in stages}
        if {s["device"] for s in stages} != {"cuda:0"} or len(buses) != 1:
            raise AssertionError(f"the stage workers are not on one card: "
                                 f"{[(s['device'], s['pci_bus_id']) for s in stages]}")
        losses2 = [m["loss"] for m in hist2[0]]
        if not all(np.isfinite(losses2)) or not losses2[-1] < losses2[0]:
            raise AssertionError(f"two-stage losses not finite and falling: "
                                 f"{losses2}")
        # 6o (b): the step's critical path from the stages' stamps
        observed = observe_mpmd("smoke-mpmd2", card_label)
        hist1, fit1_s = _mpmd_fit(_mpmd_config("smoke-mpmd1"), 1, 1, 0.5,
                                  "smoke-mpmd1")
        one = _stage_line(0, hist1[0], {
            k: v * MPMD_STAGES for k, v in want.items()})
        losses1 = [m["loss"] for m in hist1[0]]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses2, losses1))
        if rel > BF16_LOSS_RTOL:
            raise AssertionError(f"two-stage losses {losses2} against one "
                                 f"stage's {losses1}: rel {rel:.3e} > "
                                 f"{BF16_LOSS_RTOL:.3e}")
        f32 = _mpmd_f32_step()
    finally:
        rt.shutdown()
    _wait_gone(session_dir, "shutdown")
    theory = theoretical_bubble_fraction(MPMD_STAGES, MPMD_MICRO)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for s in stages:
        print(f"[mpmd] stage {s['stage']} of {MPMD_STAGES} (M {MPMD_MICRO}) "
              f"on {s['device']} (PCI {s['pci_bus_id']}), steps 3-10: "
              f"step_wall_s={s['step_wall_s']:.4f} busy_s={s['busy_s']:.4f} "
              f"xfer_s={s['xfer_s']:.4f} bubble_s={s['bubble_s']:.4f} "
              f"bubble_fraction={s['bubble_fraction']:.4f} (1F1B's "
              f"theoretical {theory:.4f}; both stages share one card, so "
              f"this is not a pipeline's bubble); peak_memory_gb="
              f"{s['peak_memory_gb']:.3f}; new allocator segments by step "
              f"{s['new_segments']}; tensor bytes a frame by link "
              f"{s['frame_bytes']}; native channel by link {s['native']}; "
              f"jax or ray_tpu modules {s['foreign']}; kernel builds "
              f"{s['builds']}; launches {s['launches']}", flush=True)
    print(f"[mpmd] TorchTrainer(pipeline_stages={MPMD_STAGES}, "
          f"num_microbatches={MPMD_MICRO}), 2 stage actors at "
          f"gpus_per_worker=0.5, GPT-2-small bf16 batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, lr {MPMD_LR}: losses "
          f"{[round(x, 4) for x in losses2]}, max rel {rel:.3e} to one "
          f"stage's (bar {BF16_LOSS_RTOL:.3e}); tokens_per_s="
          f"{tokens / stages[0]['step_wall_s']:.1f} (stage 0's step wall); "
          f"one stage: step_wall_s={one['step_wall_s']:.4f} "
          f"busy_s={one['busy_s']:.4f} peak_memory_gb="
          f"{one['peak_memory_gb']:.3f} new allocator segments by step "
          f"{one['new_segments']}; fits {fit2_s:.3f} s and "
          f"{fit1_s:.3f} s; f32 step at batch {PARITY_BATCH}, two stages "
          f"against one (loss, grad norm): {f32} (bars {F32_LOSS_RTOL}, "
          f"{F32_NORM_RTOL}); no port process left; the phase "
          f"{time.perf_counter() - t_phase:.3f} s on {card_label}",
          flush=True)
    launches = {k: sum(s["launches"][k] for s in stages)
                for k in stages[0]["launches"]}
    return launches, {
        "stages": stages, "one_stage": one, "losses": losses2,
        "one_stage_losses": losses1, "max_rel_to_one_stage": rel,
        "theoretical_bubble_fraction": theory, "f32_step": f32,
        "fit_s": fit2_s, "one_stage_fit_s": fit1_s, "observed": observed,
        "phase_s": time.perf_counter() - t_phase}


# the multi-card MPMD cases (``--multi-card mpmd`` on the cards, their
# CPU counterparts with ``--gloo-gang``): a stage a card, and two
# replicas of the two-stage pipeline syncing over the host ring
MPMD_CASES = {"mpmd-pp2": (2, 1), "mpmd-dp2-pp2": (4, 2)}
# the f32 dp case at the lr of tests/test_pipeline_3d.py's: AdamW turns
# the f32 reassociation of the replicas' split batch in gradient elements
# near 0 into whole steps of the lr, which 1e-2 would carry past 1e-4
MPMD_DP_BATCH, MPMD_DP_LR = 8, 1e-3


def mpmd_cases(n_cards, device="cuda") -> tuple:
    """``mpmd-pp2``: phase 6m's bf16 run with each stage on a card of its
    own, against one stage, within the bf16 bar; ``mpmd-dp2-pp2``: two
    replicas of it in f32 at batch MPMD_DP_BATCH, each on half the batch,
    syncing gradients over ``util/collective``'s host ring, against one
    stage on the whole batch, losses within 1e-4.  On the CPU (``device=
    "cpu"``) the same on CPU worker actors at GLOO_WIDTHS.  Every case runs;
    (results, failed)."""
    import ray_tpu_torch as rt

    rt.init(ignore_reinit_error=True)
    cuda = device == "cuda"
    widths = None if cuda else GLOO_WIDTHS
    gpus = 1.0 if cuda else 0
    out, failed = {}, []
    steps = TRAIN_STEPS if cuda else 3
    base = {}
    for dtype, batch, lr in (("bfloat16", TRAIN_BATCH, MPMD_LR),
                             ("float32", MPMD_DP_BATCH, MPMD_DP_LR)):
        cfg = _mpmd_config(f"smoke-mpmd-base-{dtype}", dtype, batch, steps,
                           device, widths, lr)
        hist, _ = _mpmd_fit(cfg, 1, 1, gpus, f"smoke-mpmd-base-{dtype}")
        base[dtype] = [m["loss"] for m in hist[0]]
    for case, (world, dp) in MPMD_CASES.items():
        if cuda and world > n_cards:
            print(f"[mpmd] {n_cards} card(s): {case} did not run",
                  flush=True)
            continue
        dtype, batch, lr = (("float32", MPMD_DP_BATCH, MPMD_DP_LR)
                            if dp > 1 else ("bfloat16", TRAIN_BATCH, MPMD_LR))
        try:
            cfg = _mpmd_config(f"smoke-{case}", dtype, batch, steps, device,
                               widths, lr)
            hist, fit_s = _mpmd_fit(cfg, MPMD_STAGES, world, gpus,
                                    f"smoke-{case}", dp=dp)
            stages = [_stage_line(s, hist[s], None)
                      for s in range(MPMD_STAGES)]
            losses = [m["loss"] for m in hist[0]]
            if dp > 1:
                err = max(abs(a - b) for a, b in zip(losses, base[dtype]))
                bar_text = f"max abs {err:.3e} (bar 1e-4)"
                ok = err <= 1e-4
            else:
                err = max(abs(a - b) / abs(b)
                          for a, b in zip(losses, base[dtype]))
                bar_text = f"max rel {err:.3e} (bar {BF16_LOSS_RTOL:.3e})"
                ok = err <= BF16_LOSS_RTOL
            if cuda and len({s["pci_bus_id"] for s in stages}) != \
                    MPMD_STAGES:
                raise AssertionError(f"{case}: the stages share a card: "
                                     f"{stages}")
            if not ok:
                raise AssertionError(f"{case}: losses {losses} against one "
                                     f"stage's {base[dtype]}: {bar_text}")
        except Exception as err:
            failed.append(f"{case}: {err!r}")
            print(f"[mpmd] {case}: FAILED: {err!r}", flush=True)
            continue
        out[case] = {"losses": losses, "one_stage_losses": base[dtype],
                     "stages": stages, "fit_s": fit_s}
        print(f"[mpmd] {case}: TorchTrainer, {world} worker actors "
              f"({device}), pipeline_stages={MPMD_STAGES}, dp={dp}, "
              f"{dtype} batch {batch}: losses {losses} against one stage's "
              f"{base[dtype]}: {bar_text}; by stage (PCI bus, step_wall_s, "
              f"busy_s, bubble_s): "
              f"{[(s['pci_bus_id'], round(s['step_wall_s'], 4), round(s['busy_s'], 4), round(s['bubble_s'], 4)) for s in stages]}",
              flush=True)
    return out, failed


def mpmd_only(card_label) -> int:
    """``chip_smoke.py --multi-card mpmd``: only the multi-card MPMD
    cases (the kernels are built first).  Needs two cards or more."""
    n_cards = torch.cuda.device_count()
    print(f"[mpmd] torch.cuda.device_count()={n_cards}", flush=True)
    if n_cards < 2:
        raise RuntimeError("--multi-card mpmd needs two cards or more")
    out, failed = mpmd_cases(n_cards)
    _runtime_stop()
    print("[mpmd] result " + json.dumps(out), flush=True)
    if failed:
        raise AssertionError("MPMD cases failed: " + "; ".join(failed))
    return 0


# ------------------------------------------------------------ phase 6r
# RL: PPO and IMPALA on CartPole with their learners on the card, the
# Sebulba gang sharing it, and a GPT-2-small policy answering runners
# through Serve (tests/test_rllib.py:75-97 and :160-189's configs)
RL_PPO_STEPS = 200_000
RL_IMPALA_STEPS = 400_000
# (c): the relaunch path's runs, one a seed, side by side
RL_IMPALA_SEEDS = (0, 1, 2)
RL_RETURN = 350.0
RL_FOREIGN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")
# the LLM policy pool: runner threads, steps an episode, tokens a step
RL_POOL_RUNNERS, RL_POOL_STEPS, RL_POOL_TOKENS = 4, 4, 8
# (b): the card's update against the CPU's, f32 with TF32 off
RL_GRAD_RTOL, RL_STATS_RTOL, RL_GAE_RTOL = 1e-5, 1e-4, 1e-5
# (b) for IMPALA: V-trace updates of the card's learner against the CPU's
RL_VTRACE_UPDATES = 5
# what PERF.md predicted before the phase first ran on the card
RL_PREDICTION = (
    "PPO 350 at 80k-160k env steps, 5,000-12,000 env steps/s, update "
    "median 40-120 ms; the card against the CPU: GAE 1e-6, gradient 1e-6, "
    "stats 1e-5; IMPALA 350 at 150k-350k env steps, 15,000-30,000 env "
    "steps/s; Sebulba bitwise, 0 local forwards, occupancy 2; the pool's "
    "engine up in 25-35 s, a decision 0.10-0.25 s at the median, 100-300 "
    "tokens/s, 16 of 16 prompts' tokens equal; the phase 90-150 s")


def _rl_foreign(facts) -> list:
    return [m for m in facts["packages"] if m in RL_FOREIGN]


def _ppo_config(device=None):
    from ray_tpu_torch.rllib import PPOConfig

    config = (PPOConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=16,
                           rollout_fragment_length=64)
              .training(vf_clip_param=100.0, lr=1e-3, entropy_coeff=0.01)
              .learners(num_learners=1)
              .debugging(seed=0))
    if device is not None:
        config.learners(device=device)
    return config


def _check_runners(debug, label):
    """Every runner process: CUDA never up, no JAX-package module."""
    for d in debug:
        if d["cuda_initialized"] or _rl_foreign(d):
            raise AssertionError(f"{label}: a runner started CUDA or "
                                 f"loaded {_rl_foreign(d)}: {d}")


def rl_ppo(card_label) -> dict:
    """(a) PPO at the reference's tuned example, its learner actor on the
    card: 350 within RL_PPO_STEPS env steps."""
    import ray_tpu_torch as rt

    algo = _ppo_config().build()
    try:
        t0 = time.perf_counter()
        best, result, iters, walls = -np.inf, None, 0, []
        while True:
            t1 = time.perf_counter()
            result = algo.train()
            walls.append(time.perf_counter() - t1)
            iters += 1
            best = max(best, result["episode_return_mean"])
            if result["episode_return_mean"] >= RL_RETURN or \
                    result["num_env_steps_sampled_lifetime"] >= RL_PPO_STEPS:
                break
        wall = time.perf_counter() - t0
        steps = result["num_env_steps_sampled_lifetime"]
        learner = algo.learner_group.actors[0]
        facts = rt.get(learner.process_facts.remote(), timeout=60)
        update_ms = rt.get(learner.update_times.remote(), timeout=60)
        debug = rt.get([r.get_debug.remote() for r in algo._runner_actors],
                       timeout=60)
    finally:
        algo.stop()
    if result["episode_return_mean"] < RL_RETURN:
        raise AssertionError(f"PPO did not reach {RL_RETURN} within {steps} "
                             f"env steps (best {best})")
    if facts["device"] != "cuda:0" or _rl_foreign(facts):
        raise AssertionError(f"the PPO learner ran on {facts['device']} and "
                             f"loaded {_rl_foreign(facts)}")
    _check_runners(debug, "PPO")
    # a fragment's host time in each runner, its weights' load included
    sample_ms = 1e3 * max(d["sample_s"] / d["fragments"] for d in debug)
    out = {"iterations": iters, "env_steps": steps,
           "return_mean": result["episode_return_mean"], "wall_s": wall,
           "env_steps_per_s": steps / wall,
           "iteration_ms_median": 1e3 * float(np.median(walls)),
           "update_ms_median": float(np.median(update_ms)),
           "update_ms_min": float(np.min(update_ms)),
           "runner_sample_ms": sample_ms,
           "runner_threads": [d["torch_threads"] for d in debug]}
    print(f"[rl] (a) PPO CartPole-v1, 2 runner actors x 16 envs x 64 steps, "
          f"learner actor on {facts['device']}: return "
          f"{out['return_mean']:.2f} >= {RL_RETURN} after {iters} "
          f"iterations, {steps} env steps (bar {RL_PPO_STEPS}), "
          f"{out['env_steps_per_s']:.1f} env steps/s; an iteration "
          f"{out['iteration_ms_median']:.3f} ms at the median: the update "
          f"{out['update_ms_median']:.3f} ms (CUDA events, min "
          f"{out['update_ms_min']:.3f}), a runner's fragment "
          f"{sample_ms:.3f} ms (host), the rest the weights' and the "
          f"batch's trips and the actor calls; runners: CUDA never "
          f"initialised, "
          f"torch threads {out['runner_threads']}, no jax/ray_tpu module "
          f"on {card_label}", flush=True)
    return out


def _rel(a, b) -> float:
    return float(abs(a - b) / max(abs(b), 1e-30))


def rl_learner_parity() -> dict:
    """(b) One TorchLearner update on the card against the same update on
    the CPU: the same initial parameters, (a)'s batch from two local
    runners, the same permutations."""
    from ray_tpu_torch.rllib.algorithms.algorithm import build_module_spec
    from ray_tpu_torch.rllib.core.learner import TorchLearner
    from ray_tpu_torch.rllib.env.env_runner import EnvRunner

    config = _ppo_config()
    spec = build_module_spec(config)
    card = TorchLearner(spec, config.training_params, seed=0)
    host = TorchLearner(spec, config.training_params, seed=0, device="cpu")
    weights = host.get_weights()
    frags = []
    for i in range(2):
        runner = EnvRunner("CartPole-v1", 16, 64, spec, seed=1000 * (i + 1))
        runner.set_weights(weights)
        frags.append(runner.sample())
    batch = {k: np.concatenate([f[k] for f in frags], axis=1)
             for k in frags[0]}
    perms = host.draw_permutations(batch["rewards"].size)
    adv_c, grad_c = card.gae_and_grads(batch, perms[0, 0])
    adv_h, grad_h = host.gae_and_grads(batch, perms[0, 0])
    gae_err = float((adv_c.cpu() - adv_h).abs().max() / adv_h.abs().max())
    grad_err = float((grad_c.cpu() - grad_h).norm() / grad_h.norm())
    stats_c = card.update(batch, perms=perms)
    stats_h = host.update(batch, perms=perms)
    stats_err = {k: _rel(stats_c[k], stats_h[k]) for k in stats_h}
    param_err = max(float((card.get_weights()[k] - v).norm() / v.norm())
                    for k, v in host.get_weights().items() if v.norm() > 0)
    print(f"[rl] (b) TorchLearner on the card against the CPU, batch "
          f"{batch['rewards'].shape}, {tuple(perms.shape)} permutations, "
          f"TF32 off: GAE advantages max rel {gae_err:.3e} (bar "
          f"{RL_GAE_RTOL}); first minibatch gradient rel norm "
          f"{grad_err:.3e} (bar {RL_GRAD_RTOL}); stats rel "
          f"{ {k: float(f'{v:.3e}') for k, v in stats_err.items()} } (bar "
          f"{RL_STATS_RTOL}); parameters after the update, largest rel "
          f"norm {param_err:.3e}", flush=True)
    if gae_err > RL_GAE_RTOL or grad_err > RL_GRAD_RTOL or \
            max(stats_err.values()) > RL_STATS_RTOL:
        raise AssertionError(f"the card's update is not the CPU's: GAE "
                             f"{gae_err}, gradient {grad_err}, stats "
                             f"{stats_err}")
    return {"gae_rel": gae_err, "grad_rel_norm": grad_err,
            "stats_rel": stats_err, "param_rel_norm": param_err,
            "vtrace": _vtrace_learner_parity()}


def _vtrace_learner_parity() -> dict:
    """(b) for IMPALA: RL_VTRACE_UPDATES PodracerLearner updates on the
    card against the same updates on the CPU, each on a fragment that a
    local runner sampled with the CPU learner's weights."""
    from ray_tpu_torch.rllib import IMPALAConfig
    from ray_tpu_torch.rllib.algorithms.algorithm import build_module_spec
    from ray_tpu_torch.rllib.env.env_runner import EnvRunner
    from ray_tpu_torch.rllib.podracer import PodracerLearner

    config = IMPALAConfig().environment("CartPole-v1").env_runners(
        num_envs_per_env_runner=16, rollout_fragment_length=64).training(
        lr=7e-4, entropy_coeff=0.01)
    spec = build_module_spec(config)
    card = PodracerLearner(spec, config.training_params, seed=0)
    host = PodracerLearner(spec, config.training_params, seed=0,
                           device="cpu")
    runner = EnvRunner("CartPole-v1", 16, 64, spec, seed=1000)
    stats_err = 0.0
    for _ in range(RL_VTRACE_UPDATES):
        runner.set_weights(host.get_weights())
        fragment = runner.sample()
        stats_c, stats_h = card.update(fragment), host.update(fragment)
        stats_err = max(stats_err, *(_rel(stats_c[k], stats_h[k])
                                     for k in stats_h))
    param_err = max(float((card.get_weights()[k] - v).norm() / v.norm())
                    for k, v in host.get_weights().items() if v.norm() > 0)
    print(f"[rl] (b) PodracerLearner on {card.device} against the CPU, "
          f"{RL_VTRACE_UPDATES} V-trace updates on (64, 16) fragments, TF32 "
          f"off: stats largest rel {stats_err:.3e} (bar {RL_STATS_RTOL}); "
          f"parameters after them, largest rel norm {param_err:.3e}",
          flush=True)
    if stats_err > RL_STATS_RTOL:
        raise AssertionError(f"the card's V-trace update is not the CPU's: "
                             f"stats {stats_err}")
    return {"stats_rel": stats_err, "param_rel_norm": param_err}


def _impala_relaunch_runs(card_label, seeds=RL_IMPALA_SEEDS,
                          device=None) -> dict:
    """(c)'s relaunch path: tests/test_rllib.py:160-189's config at each
    of ``seeds``, the runs side by side (the driver takes one ``train()``
    of each in turn), every learner in the driver on the card (or on
    ``device``; rl_impala_runs.py repeats this).  An async run's return
    depends on the order its fragments land in, so one run meets the bar
    or misses it by chance; rl_impala asks that at least one of the runs
    reach RL_RETURN within RL_IMPALA_STEPS."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import IMPALAConfig

    runs = [{"seed": seed, "iterations": 0, "best_return": -np.inf,
             "env_steps": 0, "reached_at": None, "wall_s": None}
            for seed in seeds]
    algos, devices, debug = [], [], []
    try:
        for seed in seeds:
            algos.append(
                IMPALAConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=2, num_envs_per_env_runner=16,
                             rollout_fragment_length=64)
                .training(lr=7e-4, entropy_coeff=0.01)
                .podracer(async_stream=False)
                .learners(device=device).debugging(seed=seed).build())
        t0 = time.perf_counter()
        while any(r["wall_s"] is None for r in runs):
            for algo, run in zip(algos, runs):
                if run["wall_s"] is not None:
                    continue
                result = algo.train()
                run["iterations"] += 1
                run["env_steps"] = result["num_env_steps_sampled_lifetime"]
                run["best_return"] = max(run["best_return"],
                                         result["episode_return_mean"])
                if run["best_return"] >= RL_RETURN:
                    run["reached_at"] = run["env_steps"]
                if run["reached_at"] is not None or \
                        run["env_steps"] >= RL_IMPALA_STEPS:
                    run["wall_s"] = time.perf_counter() - t0
                    run["env_steps_per_s"] = run["env_steps"] / run["wall_s"]
                    # a finished run's runners stop, freeing their cores
                    devices.append(str(algo.learner.device))
                    debug += rt.get([r.get_debug.remote()
                                     for r in algo._runners], timeout=60)
                    algo.stop()
        wall = time.perf_counter() - t0
    finally:
        for algo in algos:
            algo.stop()
    reached = [r for r in runs if r["reached_at"] is not None]
    print(f"[rl] (c) IMPALA relaunch path, 2 runner actors x 16 envs x 64 "
          f"steps, learners in the driver on {devices}, seeds "
          f"{list(seeds)} side by side in {wall:.3f} s: "
          + "; ".join(f"seed {r['seed']} best return "
                      f"{r['best_return']:.2f} after {r['iterations']} "
                      f"iterations, {r['env_steps']} env steps, "
                      f"{r['env_steps_per_s']:.1f} env steps/s"
                      for r in runs)
          + f"; {len(reached)} of {len(runs)} reached {RL_RETURN} within "
          f"{RL_IMPALA_STEPS} env steps on {card_label}", flush=True)
    if set(devices) != {device or "cuda:0"}:
        raise AssertionError(f"the IMPALA learners ran on {devices}")
    _check_runners(debug, "IMPALA")
    return {"runs": runs, "wall_s": wall, "reached": len(reached)}


def rl_impala(card_label) -> dict:
    """(c) IMPALA: the relaunch path with its learners on the card, then
    Sebulba streaming: an inference pool, two learners sharing card 0 at
    num_gpus_per_learner=0.5, three iterations."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import IMPALAConfig

    relaunch = _impala_relaunch_runs(card_label)
    if not relaunch["reached"]:
        raise AssertionError(f"no IMPALA run reached {RL_RETURN} within "
                             f"{RL_IMPALA_STEPS} env steps: "
                             f"{relaunch['runs']}")

    config = (IMPALAConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=16,
                           rollout_fragment_length=64)
              .learners(num_learners=2, num_gpus_per_learner=0.5)
              .podracer(inference_mode="pool", fragments_per_call=4,
                        batch_window_s=0.01)
              .debugging(seed=0))
    algo = config.build()
    try:
        t0 = time.perf_counter()
        for _ in range(3):
            result = algo.train()
        wall = time.perf_counter() - t0
        algo.learner.flush()
        gang = algo.learner.learners
        facts = rt.get([ln.process_facts.remote() for ln in gang],
                       timeout=60)
        w0, w1 = (algo.learner.get_weights(r) for r in range(2))
        debug = rt.get([r.get_debug.remote() for r in algo._runners],
                       timeout=60)
        pool = rt.get(algo._pool.get_stats.remote(), timeout=60)
    finally:
        algo.stop()
    same = sorted(w0) == sorted(w1) and all(torch.equal(w0[k], w1[k])
                                            for k in w0)
    if [f["device"] for f in facts] != ["cuda:0", "cuda:0"] or not same:
        raise AssertionError(f"the Sebulba gang: devices "
                             f"{[f['device'] for f in facts]}, replicas "
                             f"bitwise equal {same}")
    if any(d["local_forwards"] for d in debug) or \
            pool["max_batch_occupancy"] < 2:
        raise AssertionError(f"Sebulba: runners' local forwards "
                             f"{[d['local_forwards'] for d in debug]}, pool "
                             f"{pool}")
    _check_runners(debug + [pool["process"]], "Sebulba")
    sebulba = {"env_steps": result["num_env_steps_sampled_lifetime"],
               "policy_version": result["policy_version"], "wall_s": wall,
               "pool_iterations": pool["iterations"],
               "pool_requests": pool["requests"],
               "max_batch_occupancy": pool["max_batch_occupancy"]}
    print(f"[rl] (c) IMPALA Sebulba: inference pool, 2 learners on "
          f"{[f['device'] for f in facts]} at num_gpus_per_learner=0.5, 3 "
          f"iterations: {sebulba['env_steps']} env steps, policy version "
          f"{sebulba['policy_version']}; replicas bitwise equal after "
          f"flush; runners' local forwards "
          f"{[d['local_forwards'] for d in debug]}; pool {pool['requests']} "
          f"requests in {pool['iterations']} forwards, max occupancy "
          f"{pool['max_batch_occupancy']}; on {card_label}", flush=True)
    return {"relaunch": relaunch, "sebulba": sebulba}


def _pool_round(handle, prompts):
    """One step of every runner at once, a thread each: the replies'
    tokens and each decision's latency on this process's clock."""
    import threading

    out = [None] * len(prompts)
    errors = []

    def act(i):
        try:
            t0 = time.perf_counter()
            res = handle.remote({"prompt_ids": prompts[i],
                                 "max_tokens": RL_POOL_TOKENS}).result(120)
            out[i] = (res["tokens"], time.perf_counter() - t0)
        except Exception as err:
            errors.append((i, repr(err)[-800:]))

    threads = [threading.Thread(target=act, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"policy pool requests failed: {errors}")
    return out


def rl_llm_pool(card_label) -> tuple:
    """(d) ``llm_policy_pool`` with phase 5s's GPT-2-small engine kwargs and
    the prefix cache: RL_POOL_RUNNERS runners take RL_POOL_STEPS steps in
    lockstep, each sending the episode so far (the last prompt, its reply
    and a seeded observation string); the tokens against phase 5's
    in-process engine, the launches in the engine's process."""
    from ray_tpu_torch import serve as rt_serve
    from ray_tpu_torch.llm.engine import encode_text
    from ray_tpu_torch.rllib.podracer import llm_policy_pool

    cfg, _, _, _, engine = serving_workload()
    kwargs = dict(model_config=cfg, device="cuda", seed=0, page_size=16,
                  num_pages=512, max_batch_tokens=512,
                  prefill_chunk_tokens=256, engine_name="smoke-rl-pool",
                  enable_prefix_cache=True)
    rng = np.random.default_rng(11)

    def observation():
        x = rng.uniform(-0.2, 0.2, 4)
        return encode_text(" obs " + ",".join(f"{v:+.3f}" for v in x)
                           + " act:", cfg.vocab_size)

    t0 = time.perf_counter()
    handle = llm_policy_pool(kwargs, name="smoke-rl-llm")
    stats = handle.options(method_name="engine_stats").remote().result(120)
    start_s = time.perf_counter() - t0
    before = stats["process"]["kernel_launches"]
    if any(before.values()):
        raise AssertionError(f"the engine launched kernels before the "
                             f"runners: {before}")
    prompts = [encode_text(f"episode {i}:", cfg.vocab_size) + observation()
               for i in range(RL_POOL_RUNNERS)]
    sent, latencies, hits = [], [], []
    t0 = time.perf_counter()
    for step in range(RL_POOL_STEPS):
        replies = _pool_round(handle, prompts)
        sent += [(p, toks) for p, (toks, _) in zip(prompts, replies)]
        latencies += [s for _, s in replies]
        hits.append(handle.options(method_name="engine_stats").remote()
                    .result(60)["prefix_hit_tokens"])
        prompts = [p + toks + observation()
                   for p, (toks, _) in zip(prompts, replies)]
    wall = time.perf_counter() - t0
    stats = handle.options(method_name="engine_stats").remote().result(60)
    rt_serve.delete("smoke-rl-llm")
    proc = stats["process"]
    launches, calls = proc["kernel_launches"], proc["attention_calls"]
    if not (launches["flash_fwd"] > 0 and launches["flash_fwd"] == calls):
        raise AssertionError(f"pool engine flash_fwd launches {launches} != "
                             f"attention calls {calls}")
    if any(launches[key] for key in BWD_KERNELS):
        raise AssertionError(f"the pool engine launched backward kernels: "
                             f"{launches}")
    if stats["kv_pages_free"] + stats["prefix_cache_pages"] != \
            stats["kv_pages_total"]:
        raise AssertionError(f"the pool engine leaked pages: {stats}")
    # every step after the first re-sends its episode: the cache must hit
    grew = [b > a for a, b in zip(hits, hits[1:])]
    if not all(grew):
        raise AssertionError(f"prefix-cache hit tokens by step {hits}")
    if proc["device"] != "cuda:0" or _rl_foreign(proc):
        raise AssertionError(f"the pool engine ran on {proc['device']} and "
                             f"loaded {_rl_foreign(proc)}")
    # the same prompts through phase 5's engine in this process
    core = engine()
    same = 0
    for i, (prompt, got) in enumerate(sent):
        want = core.generate(prompt, {"max_tokens": RL_POOL_TOKENS})["tokens"]
        if got == want:
            same += 1
            continue
        pos = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        gap = _top2_gap(core, prompt + want[:pos])
        print(f"[rl] (d) prompt {i} differs from phase 5's engine at token "
              f"{pos}: {got[pos]} against {want[pos]}; top-two logit gap "
              f"{gap:.3e} (bar {NEAR_TIE:.0e})", flush=True)
        if gap >= NEAR_TIE:
            raise AssertionError(f"prompt {i} differs at token {pos} with a "
                                 f"logit gap of {gap:.3e}")
    del core
    gen = RL_POOL_RUNNERS * RL_POOL_STEPS * RL_POOL_TOKENS
    out = {"start_s": start_s, "wall_s": wall, "tokens_per_s": gen / wall,
           "decision_s_median": float(np.median(latencies)),
           "decision_s_max": float(np.max(latencies)),
           "prefix_hit_tokens_by_step": hits, "identical": same,
           "prompts": len(sent), "longest_prompt": max(len(p) for p, _ in sent),
           "attention_calls": calls, "pci_bus_id": proc["pci_bus_id"]}
    print(f"[rl] (d) llm_policy_pool: GPT-2-small engine actor on "
          f"{proc['device']} (PCI {proc['pci_bus_id']}) started in "
          f"{start_s:.3f} s; {RL_POOL_RUNNERS} runners x {RL_POOL_STEPS} "
          f"steps, greedy {RL_POOL_TOKENS} tokens a step, prompts up to "
          f"{out['longest_prompt']} tokens: decision median "
          f"{out['decision_s_median']:.4f} s (max "
          f"{out['decision_s_max']:.4f}), {out['tokens_per_s']:.2f} tokens/s;"
          f" tokens identical to phase 5's engine for {same} of {len(sent)} "
          f"prompts; engine launches {launches} (attention calls {calls}); "
          f"prefix-cache hit tokens after each step {hits}; pages free "
          f"{stats['kv_pages_free']} + cached {stats['prefix_cache_pages']} "
          f"of {stats['kv_pages_total']} on {card_label}", flush=True)
    return launches, out


def rl_runner_threads() -> dict:
    """A runner's env steps/s at (a)'s shape (16 envs x 64 steps) in this
    process, at one torch thread (what a runner actor sets) and at torch's
    default here."""
    from ray_tpu_torch.rllib.algorithms.algorithm import build_module_spec
    from ray_tpu_torch.rllib.env.env_runner import EnvRunner

    spec = build_module_spec(_ppo_config())
    default = torch.get_num_threads()
    out = {}
    try:
        for threads in (1, default):
            torch.set_num_threads(threads)
            runner = EnvRunner("CartPole-v1", 16, 64, spec, seed=0)
            runner.set_weights(runner.module.state())
            runner.sample()
            t0 = time.perf_counter()
            for _ in range(5):
                runner.sample()
            out[threads] = 5 * 16 * 64 / (time.perf_counter() - t0)
    finally:
        torch.set_num_threads(default)
    print(f"[rl] one runner, 16 envs x 64 steps, env steps/s by torch "
          f"threads: {out} (a runner actor sets 1)", flush=True)
    return {str(k): v for k, v in out.items()}


# (e) DQN and (f) SAC: tests/test_rllib.py:236-244's and :377-389's
# configurations with their updates on the card
RL_DQN_STEPS, RL_DQN_ITERS = 640_000, 5000
RL_SAC_ITERS, RL_SAC_STEPS, RL_SAC_EVAL, RL_SAC_ALPHA = 45, 20_000, -400.0, 0.9
# the card's update against the CPU's, f32 with TF32 off
RL_DQN_RTOL, RL_SAC_LOSS_RTOL, RL_SAC_RTOL = 1e-5, 1e-5, 1e-4
RL_SAC_MINIBATCHES = 4
RL_OFFPOLICY_PREDICTION = (
    "(e) DQN 350 at 150k-300k env steps (the CPU's seed 1: 192,384), "
    "1200-2400 iterations, the update (13 minibatches of 128) 8-20 ms at "
    "the median, a fragment 2-6 ms on the host, 30-70 s; the card against "
    "the CPU 1e-7-1e-6; (f) SAC's update (512 minibatches of 256) 0.8-1.6 "
    "s, eval -100 to -250, alpha 0.02-0.1, 45-90 s; the card against the "
    "CPU, losses 1e-7, after 4 minibatches 1e-6")


def _state_rel(got, want) -> float:
    """The largest rel error of a module state's tensors, each against its
    own largest magnitude."""
    return max(float((got[k].cpu() - v).abs().max()
                     / max(float(v.abs().max()), 1e-30))
               for k, v in want.items())


def _runner_facts(runner_cls, kwargs, sample_args) -> dict:
    """One runner of ``runner_cls`` as an actor: a fragment, then its
    process facts (CUDA never up, no JAX-package module)."""
    import ray_tpu_torch as rt

    actor = rt.remote(runner_cls).options(num_cpus=1).remote(**kwargs)
    try:
        batch = rt.get(actor.sample.remote(*sample_args), timeout=120)
        facts = rt.get(actor.process_facts.remote(), timeout=60)
    finally:
        rt.kill(actor)
    if facts["cuda_initialized"] or _rl_foreign(facts):
        raise AssertionError(f"a {runner_cls.__name__} actor started CUDA or"
                             f" loaded {_rl_foreign(facts)}")
    return {"rows": len(batch["rewards"]), "pid": facts["pid"]}


def _timed_sampler(runner, times):
    """``runner.sample`` recording each fragment's host ms in ``times``."""
    sample = runner.sample

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = sample(*args, **kw)
        times.append(1e3 * (time.perf_counter() - t0))
        return out
    runner.sample = timed


def _dqn_card_vs_cpu(algo) -> dict:
    """One ``_dqn_update`` at the default U and B on the card against the
    CPU, from the trained parameters and a batch of its buffer, tau 0: the
    losses and parameters within RL_DQN_RTOL, the target the parameters
    from before the update bit for bit."""
    import functools

    from ray_tpu_torch.rllib.algorithms.dqn import (_dqn_update,
                                                    batch_to_device,
                                                    dqn_minibatch)
    from ray_tpu_torch.rllib.core.learner import CudaGraphStep, make_optimizer
    from ray_tpu_torch.rllib.core.rl_module import QModule

    p = algo.config.training_params
    state = algo.module.state()
    batch = algo.buffer.gather(algo.buffer.sample_indices(
        p["num_updates_per_iter"], p["train_batch_size"]))
    out = {}
    for dev in ("cuda:0", "cpu"):
        module = QModule(4, 2, dueling=p["dueling"]).to(dev)
        module.load_state(state)
        target = QModule(4, 2, dueling=p["dueling"]).to(dev)
        target.requires_grad_(False)
        target.load_state(state)
        params = [q for _, q in module.named_params()]
        card = dev != "cpu"
        # the path the training took: on the card a CUDA graph a minibatch
        step = functools.partial(
            dqn_minibatch, module, target, params,
            make_optimizer(params, p["lr"], capturable=card),
            double_q=p["double_q"], tau=p["tau"], use_huber=p["use_huber"],
            grad_clip=p["grad_clip"])
        stats = _dqn_update(CudaGraphStep(step) if card else step,
                            batch_to_device(batch, torch.device(dev)))
        out[dev] = ({k: v.cpu() for k, v in stats.items()}, module.state(),
                    target.state())
    (s_c, m_c, t_c), (s_h, m_h, _) = out["cuda:0"], out["cpu"]
    loss_rel = float(((s_c["total_loss"] - s_h["total_loss"]).abs()
                      / s_h["total_loss"].abs()).max())
    param_rel = _state_rel(m_c, m_h)
    target_equal = all(torch.equal(t_c[k], state[k]) for k in state)
    if loss_rel > RL_DQN_RTOL or param_rel > RL_DQN_RTOL or \
            not target_equal:
        raise AssertionError(f"DQN's update on the card against the CPU: "
                             f"losses {loss_rel}, parameters {param_rel}, "
                             f"target unchanged {target_equal}")
    return {"minibatches": int(s_h["total_loss"].numel()),
            "loss_rel": loss_rel, "param_rel": param_rel,
            "target_bit_equal": target_equal}


def rl_dqn(card_label) -> dict:
    """(e) DQN at tests/test_rllib.py:236-244's configuration (CartPole-v1,
    the runner in the driver, seed 1), the update on the card: 350 within
    RL_DQN_STEPS env steps; then one update on the card against the CPU."""
    from ray_tpu_torch.rllib import DQNConfig
    from ray_tpu_torch.rllib.algorithms.dqn import QEnvRunner

    algo = (DQNConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0).debugging(seed=1)).build()
    sample_ms = []
    _timed_sampler(algo._local_runner, sample_ms)
    t0 = time.perf_counter()
    best, result, iters = -np.inf, None, 0
    for _ in range(RL_DQN_ITERS):
        result = algo.train()
        iters += 1
        ret = result["episode_return_mean"]
        if np.isfinite(ret):
            best = max(best, ret)
        if ret >= RL_RETURN:
            break
    wall = time.perf_counter() - t0
    steps = result["num_env_steps_sampled_lifetime"]
    if best < RL_RETURN or steps > RL_DQN_STEPS:
        raise AssertionError(f"DQN did not reach {RL_RETURN} within "
                             f"{RL_DQN_STEPS} env steps: best {best} at "
                             f"{steps}")
    device = str(algo.device)
    runner_dev = {str(q.device) for q in
                  algo._local_runner.module.parameters()}
    driver_foreign = sorted({m.split(".")[0] for m in sys.modules
                             if m.split(".")[0] in RL_FOREIGN})
    if device != "cuda:0" or runner_dev != {"cpu"} or driver_foreign:
        raise AssertionError(f"DQN's update ran on {device}, its runner's "
                             f"Q-network on {runner_dev}; the driver "
                             f"loaded {driver_foreign}")
    update_ms = algo.update_times()
    spec = {"observation_size": 4, "num_actions": 2, "hidden": (64, 64),
            "dueling": True}
    actor = _runner_facts(QEnvRunner, dict(
        env_name="CartPole-v1", num_envs=16, rollout_length=8,
        module_spec=spec, seed=1), (algo.module.state(), 0.05))
    parity = _dqn_card_vs_cpu(algo)
    out = {"iterations": iters, "env_steps": steps, "return_mean":
           result["episode_return_mean"], "wall_s": wall,
           "updates": len(update_ms),
           "update_ms_median": float(np.median(update_ms)),
           "update_ms_min": float(np.min(update_ms)),
           "fragment_ms_median": float(np.median(sample_ms)),
           "learner_device": device, "runner_actor": actor,
           "card_vs_cpu": parity}
    print(f"[rl] (e) DQN CartPole-v1 (tests/test_rllib.py:236, seed 1), "
          f"the runner in the driver (16 envs x 8 steps, its Q-network on "
          f"the CPU), the update on {device}: return "
          f"{out['return_mean']:.2f} >= {RL_RETURN} after {iters} "
          f"iterations, {steps} env steps (bar {RL_DQN_STEPS}), {wall:.3f} "
          f"s; the update {out['update_ms_median']:.3f} ms at the median "
          f"(CUDA events, min {out['update_ms_min']:.3f}, {len(update_ms)} "
          f"updates of 13 x 128), a fragment {out['fragment_ms_median']:.3f}"
          f" ms (host); a QEnvRunner actor: CUDA never initialised, no "
          f"jax/optax/ray_tpu module; one update on the card against the "
          f"CPU ({parity['minibatches']} minibatches, TF32 off): losses rel "
          f"{parity['loss_rel']:.3e}, parameters {parity['param_rel']:.3e} "
          f"(bar {RL_DQN_RTOL}), the target bit for bit the parameters "
          f"before it: {parity['target_bit_equal']} on {card_label}",
          flush=True)
    return out


def _sac_card_vs_cpu(algo) -> dict:
    """RL_SAC_MINIBATCHES minibatches of ``_sac_update`` on the card
    against the CPU, from the trained parameters, a batch of the buffer and
    the same noise: the first minibatch's losses within RL_SAC_LOSS_RTOL,
    then the parameters, ``target_q`` and alpha within RL_SAC_RTOL."""
    import functools

    from ray_tpu_torch.rllib.algorithms.dqn import batch_to_device
    from ray_tpu_torch.rllib.algorithms.sac import (_sac_update, sac_losses,
                                                    sac_minibatch)
    from ray_tpu_torch.rllib.core.learner import CudaGraphStep, make_optimizer
    from ray_tpu_torch.rllib.core.rl_module import (SquashedGaussianModule,
                                                    TwinQModule)

    p = algo.config.training_params
    bs = p["batch_size"]
    batch = algo.buffer.gather(algo.buffer.sample_indices(
        RL_SAC_MINIBATCHES, bs))
    noise = torch.randn((RL_SAC_MINIBATCHES, 2, bs, 1),
                        generator=torch.Generator().manual_seed(5))
    states = (algo.actor.state(), algo.critic.state(),
              algo.target_q.state(), algo.log_alpha.detach().cpu())
    out = {}
    for dev in ("cuda:0", "cpu"):
        actor = SquashedGaussianModule(3, 1, 2.0).to(dev)
        critic = TwinQModule(3, 1).to(dev)
        target = TwinQModule(3, 1).to(dev)
        target.requires_grad_(False)
        for m, st in zip((actor, critic, target), states):
            m.load_state(st)
        log_alpha = torch.nn.Parameter(states[3].clone().to(dev))
        params = ([q for _, q in actor.named_params()]
                  + [q for _, q in critic.named_params()] + [log_alpha])
        mbs = batch_to_device(batch, torch.device(dev))
        eps = noise.to(dev)
        # no autograd here: a parameter's first backward use must be in
        # the update (CudaGraphStep)
        with torch.no_grad():
            _, c_l, a_l, _ = sac_losses(actor, critic, target, log_alpha,
                                        {k: v[0] for k, v in mbs.items()},
                                        eps[0, 0], eps[0, 1],
                                        algo.update_kw["target_entropy"])
        first = torch.stack([c_l, a_l]).cpu()
        card = dev != "cpu"
        # the path the training took: on the card a CUDA graph a minibatch
        step = functools.partial(
            sac_minibatch, actor, critic, target, log_alpha, params,
            make_optimizer(params, p["lr"], capturable=card),
            **algo.update_kw)
        _, _, alpha = _sac_update(CudaGraphStep(step) if card else step,
                                  mbs, eps)
        out[dev] = (first, actor.state(), critic.state(), target.state(),
                    float(alpha))
    card, host = out["cuda:0"], out["cpu"]
    loss_rel = float(((card[0] - host[0]).abs() / host[0].abs()).max())
    rel = {"actor": _state_rel(card[1], host[1]),
           "critic": _state_rel(card[2], host[2]),
           "target_q": _state_rel(card[3], host[3]),
           "alpha": abs(card[4] - host[4]) / abs(host[4])}
    if loss_rel > RL_SAC_LOSS_RTOL or max(rel.values()) > RL_SAC_RTOL:
        raise AssertionError(f"SAC's update on the card against the CPU: "
                             f"first losses {loss_rel}, after "
                             f"{RL_SAC_MINIBATCHES} minibatches {rel}")
    return {"first_loss_rel": loss_rel, **rel}


def rl_sac(card_label) -> dict:
    """(f) SAC at tests/test_rllib.py:377-389's configuration (Pendulum-v1,
    seed 0) for RL_SAC_ITERS iterations, the update on the card: the
    test's bars; then the update on the card against the CPU."""
    from ray_tpu_torch.rllib import SACConfig
    from ray_tpu_torch.rllib.algorithms.sac import SACEnvRunner

    algo = (SACConfig().environment("Pendulum-v1").debugging(seed=0)).build()
    sample_ms = []
    _timed_sampler(algo._local_runner, sample_ms)
    t0 = time.perf_counter()
    for _ in range(RL_SAC_ITERS):
        out = algo.train()
    wall = time.perf_counter() - t0
    ev = algo.evaluate(n_episodes=5)["episode_return_mean"]
    device = str(algo.device)
    update_ms = algo.update_times()
    if out["steps_sampled"] < RL_SAC_STEPS or ev < RL_SAC_EVAL or \
            out["alpha"] >= RL_SAC_ALPHA or device != "cuda:0":
        raise AssertionError(f"SAC on {device}: {out['steps_sampled']} env "
                             f"steps, greedy return {ev}, alpha "
                             f"{out['alpha']}")
    spec = {"observation_size": 3, "action_size": 1, "max_action": 2.0,
            "hidden": (64, 64)}
    actor = _runner_facts(SACEnvRunner, dict(
        env_name="Pendulum-v1", num_envs=8, rollout_length=64,
        module_spec=spec, seed=0), (algo.actor.state(), False))
    parity = _sac_card_vs_cpu(algo)
    res = {"iterations": RL_SAC_ITERS, "env_steps": out["steps_sampled"],
           "eval_return": ev, "alpha": out["alpha"], "wall_s": wall,
           "updates": len(update_ms),
           "update_ms_median": float(np.median(update_ms)),
           "update_ms_min": float(np.min(update_ms)),
           "fragment_ms_median": float(np.median(sample_ms)),
           "learner_device": device, "runner_actor": actor,
           "card_vs_cpu": parity}
    print(f"[rl] (f) SAC Pendulum-v1 (tests/test_rllib.py:377, seed 0), "
          f"the runner in the driver (8 envs x 64 steps, its actor on the "
          f"CPU), the update on {device}: {RL_SAC_ITERS} iterations, "
          f"{out['steps_sampled']} env steps (bar {RL_SAC_STEPS}), greedy "
          f"evaluate(5) {ev:.2f} (bar {RL_SAC_EVAL}), alpha "
          f"{out['alpha']:.4f} (bar < {RL_SAC_ALPHA}), {wall:.3f} s; the "
          f"update {res['update_ms_median']:.3f} ms at the median (CUDA "
          f"events, min {res['update_ms_min']:.3f}, {len(update_ms)} "
          f"updates of 512 x 256), a fragment "
          f"{res['fragment_ms_median']:.3f} ms (host); an SACEnvRunner "
          f"actor: CUDA never initialised, no jax/optax/ray_tpu module; "
          f"{RL_SAC_MINIBATCHES} minibatches of 256 on the card against "
          f"the CPU (same noise, TF32 off): the first losses rel "
          f"{parity['first_loss_rel']:.3e} (bar {RL_SAC_LOSS_RTOL}), then "
          f"actor {parity['actor']:.3e}, critic {parity['critic']:.3e}, "
          f"target_q {parity['target_q']:.3e}, alpha {parity['alpha']:.3e} "
          f"(bar {RL_SAC_RTOL}) on {card_label}", flush=True)
    return res


def rl_train(card_label) -> tuple:
    """Phase 6r: PPO and IMPALA learn CartPole with their learners on the
    card, and the LLM policy pool answers runners through Serve on the
    flash kernel.  On its own runtime, which it shuts down; every part
    runs and the phase fails at the end if any failed."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve as rt_serve
    from ray_tpu_torch._private import worker as worker_mod

    t_phase = time.perf_counter()
    print(f"[rl] prediction (PERF.md §6): {RL_PREDICTION}", flush=True)
    print(f"[rl] prediction for (e) and (f) (PERF.md §6): "
          f"{RL_OFFPOLICY_PREDICTION}", flush=True)
    out, failed = {}, []
    launches = {"rl": None, "rl_offpolicy": None, "rl_llm_pool": None}
    out["runner_threads"] = rl_runner_threads()
    rt.init(ignore_reinit_error=True)
    session_dir = worker_mod.global_worker().node.session_dir
    try:
        # the MLP paths: PPO's, IMPALA's, then DQN's and SAC's learners run
        # no attention
        for path, parts in (
                ("rl", (("ppo", lambda: rl_ppo(card_label)),
                        ("learner_parity", rl_learner_parity),
                        ("impala", lambda: rl_impala(card_label)))),
                ("rl_offpolicy", (("dqn", lambda: rl_dqn(card_label)),
                                  ("sac", lambda: rl_sac(card_label))))):
            _zero_counts()
            for part, fn in parts:
                try:
                    out[part] = fn()
                except Exception as err:
                    failed.append(f"{part}: {err!r}")
                    print(f"[rl] {part}: FAILED: {err!r}", flush=True)
            launches[path] = _read_counts()
        try:
            launches["rl_llm_pool"], out["llm_pool"] = rl_llm_pool(card_label)
        except Exception as err:
            failed.append(f"llm_pool: {err!r}")
            print(f"[rl] llm_pool: FAILED: {err!r}", flush=True)
    finally:
        rt_serve.shutdown()
        rt.shutdown()
    deadline = time.monotonic() + 30
    while (left := _port_processes(session_dir)) and \
            time.monotonic() < deadline:
        time.sleep(0.2)
    if left:
        failed.append(f"port processes left after shutdown: {left}")
    for path in ("rl", "rl_offpolicy"):
        if any(launches[path].values()):
            failed.append(f"the RL learners' path {path} launched attention "
                          f"kernels: {launches[path]}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[rl] the phase {out['phase_s']:.3f} s on {card_label}; no port "
          f"process left: {not left}", flush=True)
    if failed:
        raise AssertionError("phase 6r failed: " + "; ".join(failed))
    return launches, out


# ------------------------------------------------------------ phase 6k
# the harnesses a benchmark of the port runs (ray_tpu_torch/_private/
# *_bench.py and ray_perf.py), on the card: serve_load at GPT-2-small,
# pipeline_bench at GPT-2-small's widths and depth, the host harnesses at
# reduced sizes (each cut printed)
BENCH_LONG_LEN = 4096  # chunked_prefill_ab's prompt, the harness's own
BENCH_STREAMS = 256  # sse_load's streams, the harness's default
BENCH_PERF_S = 0.25  # ray_perf's seconds an axis (the harness's 2.0)
BENCH_COLLECTIVE = (16 * 1024 ** 2, 4)  # its acceptance point alone
BENCH_RL_ROUNDS = 1  # rl_bench's rounds (the harness's 3)
BENCH_PIPE_ROUNDS = 1  # run_pipeline_bench's rounds (the harness's 3)
BENCH_3D_STEPS = 2  # run_train_3d_bench's steps, one timed (the harness's 4)
# what PERF.md predicted before the phase first ran on the card
BENCH_PREDICTION = (
    "prefix_ab: arms identical, prefilled 1216 -> 480 tokens, 736 hit; "
    "chunked_prefill_ab: unchunked max ITL 40-120 ms, chunked 15-50 ms, "
    "ratio 0.2-0.7; sse_load: 256 of 256, 0 shed, 0 half, TTFT p50 1-6 s, "
    "ITL p50 30-150 ms, goodput 150-600 tokens/s; pipeline: two stages "
    "slower than one on one card (measured_speedup 0.5-0.95), "
    "reconciliation within 15 points at every M; the phase 120-200 s")


def _engine_facts() -> list:
    """``stats()["process"]`` of every live InferenceEngine actor, got
    from the actor itself (through a handle made from its id), not through
    the router, which picks a replica."""
    from ray_tpu_torch._private.ids import ActorID
    from ray_tpu_torch.actor import ActorHandle, _AnyMethodMeta
    from ray_tpu_torch.util import state

    import ray_tpu_torch as rt

    out = []
    for a in state.list_actors():
        if a.get("class_name") == "InferenceEngine" and \
                a.get("state") == "ALIVE":
            handle = ActorHandle(ActorID(bytes.fromhex(a["actor_id"])),
                                 _AnyMethodMeta(),
                                 class_name="InferenceEngine")
            out.append(rt.get(handle.stats.remote(), timeout=60)["process"])
    return out


def _prefix_rows(card_cfg):
    """prefix_ab on the card at ``card_cfg`` and on the CPU at the tiny
    config: the arms through the harness's own ``_run_prefix_arm`` and its
    row through ``run_prefix_ab``.  The prompts' lengths and the token
    counts (8 a request, no stop token) fix every prefill count, so the
    CPU's counts are the card's.  Where the card's arms differ, the
    in-process top-two logit gap at the first differing token is printed:
    under NEAR_TIE it is a tie, not a fault."""
    from ray_tpu_torch._private import serve_load_bench as slb
    from ray_tpu_torch.models import GPT2Config

    def row(arms, device, cfg):
        orig = slb._run_prefix_arm
        slb._run_prefix_arm = lambda enable, *a, **k: arms[enable]
        try:
            return slb.run_prefix_ab(device, cfg)
        finally:
            slb._run_prefix_arm = orig

    cpu_arms = {e: slb._run_prefix_arm(e, "cpu", GPT2Config.tiny())
                for e in (False, True)}
    cpu = row(cpu_arms, "cpu", GPT2Config.tiny())
    arms = {e: slb._run_prefix_arm(e, "cuda", card_cfg)
            for e in (False, True)}
    tie = None
    try:
        card = row(arms, "cuda", card_cfg)
    except AssertionError:
        off, on = arms[False]["outputs"], arms[True]["outputs"]
        i = next(i for i, (a, b) in enumerate(zip(off, on)) if a != b)
        pos = next(j for j, (a, b) in enumerate(zip(off[i], on[i]))
                   if a != b)
        prompts = slb._prefix_workload()
        prompt = prompts[i] if i < 8 else (
            prompts[i - 8] + off[i - 8] + [200 + (k % 30) for k in range(16)])
        from ray_tpu_torch.llm import EngineCore

        core = EngineCore(card_cfg, device="cuda", seed=0, num_pages=512,
                          page_size=8, max_batch_tokens=128)
        tie = _top2_gap(core, prompt + off[i][:pos])
        print(f"[bench-6k] (a) prefix_ab: request {i} differs between the "
              f"arms at token {pos}: {off[i][pos]} against {on[i][pos]}; "
              f"top-two logit gap there {tie:.3e} (bar {NEAR_TIE:.0e})",
              flush=True)
        if tie >= NEAR_TIE:
            raise
        card = dict(cpu, outputs_identical=False, top2_gap=tie)
    counts = ("prefilled_tokens_off", "prefilled_tokens_on",
              "prefix_hit_tokens", "prefill_reduction_x")
    if [card[k] for k in counts] != [cpu[k] for k in counts] or \
            [arms[e]["prefilled_tokens"] for e in (False, True)] != \
            [cpu_arms[e]["prefilled_tokens"] for e in (False, True)]:
        raise AssertionError(f"prefix_ab's counts on the card {card} "
                             f"against the CPU's {cpu}")
    return card, cpu


def bench_serve(card_label) -> tuple:
    """6k (a): serve_load_bench's three rows at GPT-2-small in f32, as
    phase 5: prefix_ab and chunked_prefill_ab in this process (its
    counters set to 0 before, read after), then sse_load over two
    llm_deployment replicas sharing card 0 on the runtime (each engine's
    process read)."""
    from ray_tpu_torch._private import serve_load_bench as slb
    from ray_tpu_torch.llm.model_runner import GPT2Runner
    from ray_tpu_torch.models import GPT2Config

    small = GPT2Config.small()
    # every runner made on the card in this process, to read its attention
    # calls: each must have launched flash_fwd once
    runners, init = [], GPT2Runner.__init__

    def recording_init(self, *a, **k):
        init(self, *a, **k)
        if self.device.type == "cuda":
            runners.append(self)
    GPT2Runner.__init__ = recording_init
    try:
        torch.cuda.synchronize()
        _zero_counts()
        prefix, prefix_cpu = _prefix_rows(small)
        # the harness's own vocabulary and positions, GPT-2-small's widths
        chunked = slb.run_chunked_ab(BENCH_LONG_LEN, "cuda",
                                     GPT2Config(vocab_size=512))
        torch.cuda.synchronize()
        local = _read_counts()
    finally:
        GPT2Runner.__init__ = init
    calls = sum(r.attention_calls for r in runners)
    if not (local["flash_fwd"] > 0 and local["flash_fwd"] == calls) or \
            local["flash_fwd_combine"] or \
            any(local[k] for k in BWD_KERNELS):
        raise AssertionError(f"prefix_ab and chunked_prefill_ab in this "
                             f"process launched {local} against "
                             f"{calls} attention calls of "
                             f"{len(runners)} runners on the card")
    print(f"[bench-6k] (a) prefix_ab, GPT-2-small f32 on the card: "
          f"{json.dumps(prefix)}; on the CPU (tiny config, the same "
          f"prompts and lengths): {json.dumps(prefix_cpu)}; the counts "
          f"equal; with chunked_prefill_ab flash_fwd {local['flash_fwd']} "
          f"launches = attention calls of the {len(runners)} runners on "
          f"the card", flush=True)
    print(f"[bench-6k] (a) chunked_prefill_ab, GPT-2-small widths, vocab "
          f"512, {BENCH_LONG_LEN + 256} positions, f32: "
          f"{json.dumps(chunked)} on {card_label}", flush=True)
    sse, engines = None, []
    if importlib.util.find_spec("aiohttp") is None:
        print("[bench-6k] (a) sse_load left out: aiohttp is not installed "
              "here", flush=True)
    else:
        from ray_tpu_torch import serve as rt_serve

        delete = rt_serve.delete

        def read_then_delete(name):
            engines.extend(_engine_facts())
            return delete(name)
        rt_serve.delete = read_then_delete
        try:
            sse = slb.run_sse_load(
                num_streams=BENCH_STREAMS, num_replicas=2, max_tokens=8,
                metrics_wait_s=15.0, device="cuda", model_config=small)
        finally:
            rt_serve.delete = delete
        if (sse["completed"], sse["shed"], sse["half_streams"]) != \
                (BENCH_STREAMS, 0, 0):
            raise AssertionError(f"sse_load: {sse}")
        if len(engines) != 2 or {e["device"] for e in engines} != \
                {"cuda:0"} or len({e["pci_bus_id"] for e in engines}) != 1:
            where = [(e["device"], e["pci_bus_id"]) for e in engines]
            raise AssertionError(f"the two engines are not on card 0: "
                                 f"{where}")
        for e in engines:
            k = e["kernel_launches"]
            if not (k["flash_fwd"] > 0
                    and k["flash_fwd"] == e["attention_calls"]) or \
                    k["flash_fwd_combine"] or \
                    any(k[b] for b in BWD_KERNELS) or e["kernels_built"]:
                raise AssertionError(f"an engine's launches {k} against "
                                     f"its attention calls "
                                     f"{e['attention_calls']}, built "
                                     f"{e['kernels_built']}")
        print(f"[bench-6k] (a) sse_load, {BENCH_STREAMS} streams of 8 "
              f"tokens over 2 llm_deployment replicas at "
              f"num_gpus=0.5 each, GPT-2-small f32: "
              f"{json.dumps(sse)}; engine launches "
              f"{[e['kernel_launches']['flash_fwd'] for e in engines]} = "
              f"attention calls {[e['attention_calls'] for e in engines]}, "
              f"both on {engines[0]['device']} (PCI "
              f"{engines[0]['pci_bus_id']}) of {card_label}", flush=True)
    launches = dict(local)
    for e in engines:
        for k, n in e["kernel_launches"].items():
            launches[k] += n
    return launches, {"prefix_ab": prefix, "prefix_ab_cpu": prefix_cpu,
                      "chunked_prefill_ab": chunked, "sse_load": sse,
                      "engine_launches": [e["kernel_launches"]
                                          for e in engines]}


def bench_pipeline(card_label) -> tuple:
    """6k (b): pipeline_bench at GPT-2-small's widths and depth in bf16
    (phase 6m's dtype, no remat), the harness's batch: run_pipeline_bench's
    three M values and run_train_3d_bench's (1, 1, 2) and (2, 1, 1) cells
    (and the int8 cell it adds), every stage on the card in this process;
    flash_fwd, dQ and dK/dV once per attention call, counted from the
    steps the rows say ran."""
    from ray_tpu_torch._private import pipeline_bench as pb
    from ray_tpu_torch.models import GPT2Config

    cfg = GPT2Config(remat=False, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    _zero_counts()
    pipe = pb.run_pipeline_bench("cuda", cfg, rounds=BENCH_PIPE_ROUNDS)
    grid = pb.run_train_3d_bench("cuda", cfg, configs=((1, 1, 2), (2, 1, 1)),
                                 steps=BENCH_3D_STEPS)
    torch.cuda.synchronize()
    launches = _read_counts()
    # a step runs each layer once per microbatch; every M: the one-stage
    # and the two-stage executors, a warm-up step and rounds x steps each
    steps = 1 + pipe["rounds"] * pipe["steps_per_round"]
    calls = sum(2 * steps * cfg.n_layer * m for m in pipe["micros"])
    calls += sum(c["dp"] * BENCH_3D_STEPS * cfg.n_layer * grid["n_micro"]
                 for c in grid["configs"])
    want = {"flash_fwd": calls, "flash_bwd_dq": calls,
            "flash_bwd_dkdv": calls, "flash_fwd_combine": 0,
            "flash_bwd_delta": 0, "fused:flash_bwd_delta": calls}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"pipeline_bench's launches {got}, expected "
                             f"{want}")
    bad = [c for c in pipe["critical_path"]
           if "error" in c or not c["buckets_sum_to_path"]]
    if bad:
        raise AssertionError(f"the critical path does not reconcile: {bad}")
    for row in pipe["variants"]:
        print(f"[bench-6k] (b) pipeline_bench M={row['n_micro']}: "
              f"{json.dumps(row)}", flush=True)
    for row in pipe["critical_path"]:
        print(f"[bench-6k] (b) critical path M={row['n_micro']}: "
              f"{json.dumps(row)}", flush=True)
    for row in grid["configs"]:
        print(f"[bench-6k] (b) train_3d {json.dumps(row)}", flush=True)
    print(f"[bench-6k] (b) GPT-2-small bf16, batch {pb.BATCH} x {pb.SEQ}, "
          f"run_pipeline_bench at {BENCH_PIPE_ROUNDS} round (the harness's "
          f"3), run_train_3d_bench at {BENCH_3D_STEPS} steps (the "
          f"harness's 4): launches {got} (= {calls} attention calls), int8 wire ratio "
          f"{grid.get('int8_wire_ratio')} on {card_label}", flush=True)
    return launches, {"pipeline": pipe, "train_3d": grid}


def bench_host(card_label) -> dict:
    """6k (c): the host harnesses on the runtime, at the sizes printed;
    the learner of rl_bench in this process on the card.  No hand kernel
    runs: this process's counters read 0 after.  Phase 6k runs it in a
    process of its own, on a runtime of its own
    (``_bench_host_main``), beside (a) and (b)."""
    from ray_tpu_torch._private.collective_bench import run_collective_bench
    from ray_tpu_torch._private.ray_perf import run_microbenchmarks
    from ray_tpu_torch._private.recovery_bench import run_recovery_bench
    from ray_tpu_torch._private.rl_bench import run_rl_bench

    _zero_counts()
    out = {}
    t0 = time.perf_counter()
    nbytes, world = BENCH_COLLECTIVE
    out["collective"] = run_collective_bench(sizes=[nbytes], worlds=[world])
    print(f"[bench-6k] (c) collective_bench at {nbytes >> 20} MiB, world "
          f"{world} only (the harness sweeps 1-256 MiB at worlds 2 and 4), "
          f"{time.perf_counter() - t0:.3f} s: "
          f"{json.dumps(out['collective'])}", flush=True)
    t0 = time.perf_counter()
    out["recovery"] = run_recovery_bench()
    print(f"[bench-6k] (c) recovery_bench whole, "
          f"{time.perf_counter() - t0:.3f} s: "
          f"{json.dumps(out['recovery'])}", flush=True)
    t0 = time.perf_counter()
    out["rl"] = run_rl_bench(BENCH_RL_ROUNDS)
    print(f"[bench-6k] (c) rl_bench at {BENCH_RL_ROUNDS} round (the "
          f"harness's 3) and the Sebulba row, the learner on the card, "
          f"{time.perf_counter() - t0:.3f} s: {json.dumps(out['rl'])}",
          flush=True)
    # last: ray_perf pins this process's thread to one core for its 1:1
    # round trips (bench_rig), which would slow whatever ran after it
    t0 = time.perf_counter()
    out["ray_perf"] = run_microbenchmarks(duration_s=BENCH_PERF_S)
    print(f"[bench-6k] (c) ray_perf at {BENCH_PERF_S} s an axis (the "
          f"harness's 2.0), {time.perf_counter() - t0:.3f} s: "
          f"{json.dumps(out['ray_perf'])}", flush=True)
    if any(_read_counts().values()):
        raise AssertionError(f"the host harnesses launched attention "
                             f"kernels: {_read_counts()}")
    return out


def _bench_host_main(out_path, card_label) -> None:
    """6k (c) in a process of its own, on a runtime of its own, which it
    shuts down; its rows go to ``out_path``."""
    import ray_tpu_torch as rt

    rt.init()
    try:
        out = bench_host(card_label)
    finally:
        rt.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


def bench_harnesses(card_label) -> tuple:
    """Phase 6k: (c) in a process of its own, on a runtime of its
    own (``_bench_host_main``: the host harnesses use the card only for
    rl_bench's small learner), while this process runs (a) on another
    runtime, which it shuts down, then (b); every part runs and the phase
    fails at the end if any failed."""
    import tempfile

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve as rt_serve
    from ray_tpu_torch._private import worker as worker_mod

    t_phase = time.perf_counter()
    print(f"[bench-6k] prediction (PERF.md §6): {BENCH_PREDICTION}",
          flush=True)
    out, failed, times = {}, [], {}
    launches = {"bench_serve": None, "bench_pipeline": None}

    def run(part, fn):
        t0 = time.perf_counter()
        try:
            launches["bench_" + part], out[part] = fn(card_label)
        except Exception as err:
            failed.append(f"{part}: {err!r}")
            print(f"[bench-6k] {part}: FAILED: {err!r}", flush=True)
        times[part] = time.perf_counter() - t0

    here = os.path.dirname(os.path.abspath(__file__))
    fd, host_out = tempfile.mkstemp(prefix="smoke_bench_host_",
                                    suffix=".json")
    os.close(fd)
    env = {k: v for k, v in os.environ.items()
           if k != "RAY_TPU_TORCH_ADDRESS"}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p)
    host = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke."
         f"_bench_host_main({host_out!r}, {card_label!r})"],
        cwd=here, env=env)
    rt.init(ignore_reinit_error=True)
    session_dir = worker_mod.global_worker().node.session_dir
    try:
        run("serve", bench_serve)
    finally:
        rt_serve.shutdown()
        rt.shutdown()
    run("pipeline", bench_pipeline)
    try:
        rc = host.wait(timeout=900)
    except subprocess.TimeoutExpired:
        host.terminate()
        rc = host.wait(timeout=60)
    times["host"] = time.perf_counter() - t_phase
    if rc:
        failed.append(f"host: its process exited {rc}")
    else:
        with open(host_out) as f:
            out["host"] = json.load(f)
    os.unlink(host_out)
    try:
        _wait_gone(session_dir, "shutdown")
    except AssertionError as err:
        failed.append(repr(err))
    out["part_s"], out["phase_s"] = times, time.perf_counter() - t_phase
    print(f"[bench-6k] the phase {out['phase_s']:.3f} s (serve "
          f"{times.get('serve', 0):.3f} then pipeline "
          f"{times.get('pipeline', 0):.3f}, and beside them host "
          f"{times.get('host', 0):.3f}) on {card_label}", flush=True)
    if failed:
        raise AssertionError("phase 6k failed: " + "; ".join(failed))
    return launches, out


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
    # the stage links' native channel (g++), which the workers then load
    channel = build.build_channel()
    print(f"[build] {sorted(libs)} and {channel.name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ptxas = ptxas_report(build.build_logs)
    sass_check(libs)

    label = f"{card} ({smi})"
    if sys.argv[1:] == ["--multi-card", "mpmd"]:
        rc = mpmd_only(label)
        print(smi)
        return rc
    if sys.argv[1:2] == ["--multi-card"] and len(sys.argv) <= 3:
        rc = multi_card_only(label, *sys.argv[2:])
        print(smi)
        return rc

    # each phase's wall time, on a [time] line as it ends
    laps, t_lap = {}, [t0]

    def lap(name):
        now = time.perf_counter()
        laps[name], t_lap[0] = now - t_lap[0], now
        print(f"[time] {name}: {laps[name]:.1f} s", flush=True)

    lap("build")
    # 3. kernels against their plain versions
    rows = attention_cases(card)
    combine_row = combine_case(card)
    lap("3")
    # 3b. the backward kernels
    bwd_rows = backward_cases(card)
    lap("3b")

    # 4. model at full width
    model_forward(random_flax_params(GPT2Config.small(), seed=0))
    lap("4")

    # 5. and 6. the main paths, each with its counters set to 0 just before
    paths = {}
    paths["serve"], serving = serve(label)
    lap("5")
    # 5s. phase 5's traffic through Serve, to an engine actor on the card
    # (the engine's process zeroes nothing: its counts must read 0 before)
    paths["serve_deployment"], serving_5s = serve_deployment(label, serving)
    lap("5s")
    # 6j. the cluster surface: a job submitted through the CLI's cluster
    # and a host the autoscaler launches, each serving on the card (each
    # task zeroes and reads its counters)
    paths["job"], paths["autoscaled"], cluster = cluster_tooling(
        label, serving)
    del serving["core"]
    lap("6j")
    paths["train"], training = train(card, label)
    lap("6")
    paths["train_moe"], training_moe = train_moe(card, label)
    lap("6e")
    paths["train_llama"], training_llama = train_llama(card, label)
    lap("6b")
    paths["mesh"], mesh = mesh_train(
        card, label, training["losses"], training["step_ms"],
        {"gpt": training["parity_f32"]["flash"],
         "gpt-moe": training_moe["parity_f32"]["flash"]})
    lap("6c")
    # 6d. ring attention's steps, each ring position in turn
    paths["ring"], ring = ring_one_card(label)
    lap("6d")
    # 6f. the pipeline's ticks, each pp position in turn
    pipeline_paths, pipeline = train_pipeline(card, label, training)
    paths.update(pipeline_paths)
    lap("6f")
    # 6g. phase 6's run through TorchTrainer on a worker actor of the
    # port's runtime (the worker zeroes and reads its counters)
    paths["runtime"], runtime, params_ref = runtime_train(label, training)
    lap("6g")
    # 6t. Data -> Train -> Tune on the same runtime: phase 6's run fed by a
    # ray_tpu_torch.data pipeline through TorchTrainer(datasets=), then a
    # Tuner's two trials side by side on the card (each worker zeroes and
    # reads its counters), and MARWIL's update on the card
    paths["data"], paths["tune"], data_tune = data_tune_train(
        label, runtime, params_ref)
    del params_ref
    lap("6t")
    # 6m. the MPMD pipeline: two stage actors on the card, on the same
    # runtime, which the phase shuts down (each worker zeroes and reads its
    # counters)
    paths["mpmd"], mpmd = mpmd_train(label)
    lap("6m")
    # 6r. RL: PPO and IMPALA on CartPole with their learners on the card,
    # and the LLM policy pool (its engine actor zeroes nothing: its counts
    # must read 0 before the runners)
    rl_paths, rl = rl_train(label)
    paths.update(rl_paths)
    lap("6r")
    # 6k. the bench harnesses on the card, on a runtime of its own:
    # serve_load's rows at GPT-2-small (this process and each engine's
    # counters) and pipeline_bench's (this process's)
    bench_paths, bench = bench_harnesses(label)
    paths.update(bench_paths)
    _runtime_stop()
    lap("6k")
    print(f"[time] build to 6k: {sum(laps.values()):.1f} s", flush=True)

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
    print("[data-tune] result " + json.dumps(data_tune), flush=True)
    print("[mpmd] result " + json.dumps(mpmd), flush=True)
    print("[rl] result " + json.dumps(rl), flush=True)
    print("[bench-6k] result " + json.dumps(bench), flush=True)
    print("[serve] result " + json.dumps(serving), flush=True)
    print("[serve-5s] result " + json.dumps(serving_5s), flush=True)
    print("[cluster-6j] result " + json.dumps(cluster), flush=True)
    print(json.dumps({"kernels": [kernel, combine, *backward]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
