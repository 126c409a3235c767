"""The training step's spans and the flash calls' work counters, on the CPU.

``util/tracing.device_span`` marks the step (``train.step``), its phases
(``train.forward``, ``train.backward``, ``train.optimizer``) and each flash
forward and backward call (``attention.flash_fwd``, ``attention.flash_bwd``)
in the trace of a recording profiler, and costs no ``record_function`` when
none records; ``ops.attention.KERNEL_WORK`` counts each flash call's FLOPs
and bytes from its shapes, the same with the profiler on and off.

This file imports neither JAX nor the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch.models.gpt2 import GPT2Config
from ray_tpu_torch.models.pretrain import ShardedPretrainer
from ray_tpu_torch.ops import attention
from ray_tpu_torch.util import tracing

ROWS, SEQ = 2, 64
PHASES = ("train.forward", "train.backward", "train.optimizer")


def _config(remat: bool = False) -> GPT2Config:
    return dataclasses.replace(GPT2Config.tiny(), remat=remat)


def _batch(seed: int = 0):
    ids = np.random.default_rng(seed).integers(
        0, GPT2Config.tiny().vocab_size, (ROWS, SEQ + 1))
    return {"input_ids": ids[:, :-1], "targets": ids[:, 1:]}


@pytest.fixture(scope="module")
def trainer():
    return ShardedPretrainer(_config(), device="cpu")


def _traced_spans(trainer):
    """One step under the profiler: its program spans, (name, start, end)
    in ns, the ``ray_tpu_torch.`` prefix taken off."""
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        trainer.step(_batch())
    prefix = tracing.SPAN_PREFIX
    return sorted(
        (ev.name()[len(prefix):], ev.start_ns(),
         ev.start_ns() + ev.duration_ns())
        for ev in prof.kineto_results.events()
        if ev.name().startswith(prefix))


def _work_delta(fn):
    before = tracing.counters()
    fn()
    after = tracing.counters()
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("remat", [False, True])
def test_step_spans_nest_once_a_step(remat):
    tr = ShardedPretrainer(_config(remat), device="cpu")
    tr.step(_batch())
    spans = _traced_spans(tr)
    names = [n for n, _, _ in spans]
    for name in ("train.step",) + PHASES:
        assert names.count(name) == 1, (name, names)
    at = {n: (s, e) for n, s, e in spans if n.startswith("train.")}
    s0, e0 = at["train.step"]
    for name in PHASES:
        assert s0 <= at[name][0] <= at[name][1] <= e0, name
    # the phases run one after another
    assert (at["train.forward"][1] <= at["train.backward"][0]
            and at["train.backward"][1] <= at["train.optimizer"][0])

    def inside(phase, kind):
        s, e = at[phase]
        return sum(1 for n, a, b in spans
                   if n == f"attention.{kind}" and s <= a <= b <= e)

    n_layer = tr.config.n_layer
    assert inside("train.forward", "flash_fwd") == n_layer
    assert inside("train.backward", "flash_bwd") == n_layer
    # recomputation runs each block's forward again inside the backward
    assert inside("train.backward", "flash_fwd") == (n_layer if remat else 0)
    assert names.count("attention.flash_fwd") == n_layer * (1 + remat)
    assert names.count("attention.flash_bwd") == n_layer
    assert inside("train.optimizer", "flash_fwd") == 0


def test_no_profiler_enters_no_record_function(trainer, monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __init__(self, name, *args, **kwargs):
            entered.append(name)
            super().__init__(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    trainer.step(_batch())
    # torch's own optimizer enters record_function whether or not a
    # profiler records; the program's spans do not
    assert [n for n in entered if n.startswith(tracing.SPAN_PREFIX)] == []
    with torch.autograd.profiler.profile(use_kineto=True):
        trainer.step(_batch())
    ours = [n for n in entered if n.startswith(tracing.SPAN_PREFIX)]
    assert len(ours) == 4 + 2 * trainer.config.n_layer


def test_kernel_work_of_a_step(trainer):
    delta = _work_delta(lambda: trainer.step(_batch()))
    # tiny: 2 layers, 4 heads of 16, bf16; 2 rows of 64 tokens, so
    # 64·65/2 = 2080 causal pairs a head and row
    pairs_flops = 4 * ROWS * 4 * 16 * 2080             # 1,064,960
    fwd_bytes = ROWS * 4 * (4 * SEQ * 16 * 2 + SEQ * 4)  # 67,584
    bwd_bytes = ROWS * 4 * (8 * SEQ * 16 * 2 + SEQ * 4)  # 133,120
    assert delta["attention.flash_fwd.calls"] == 2
    assert delta["attention.flash_fwd.flops"] == 2 * 1_064_960 == (
        2 * pairs_flops)
    assert delta["attention.flash_fwd.bytes"] == 2 * 67_584 == 2 * fwd_bytes
    assert delta["attention.flash_bwd.calls"] == 2
    assert delta["attention.flash_bwd.flops"] == 2 * 2 * pairs_flops
    assert delta["attention.flash_bwd.bytes"] == 2 * 133_120 == (
        2 * bwd_bytes)
    # the CPU path launches no kernel
    assert all(v == 0 for k, v in delta.items() if k.endswith("launches"))


def test_counts_same_with_profiler_on_and_off(trainer):
    off = _work_delta(lambda: trainer.step(_batch(1)))

    def traced():
        with torch.autograd.profiler.profile(use_kineto=True):
            trainer.step(_batch(1))

    on = _work_delta(traced)
    assert on == off
    assert off["attention.flash_fwd.calls"] == trainer.config.n_layer


@pytest.mark.parametrize("s_q,s_k,q_offset,k_offset", [
    (24, 24, 0, 0),      # square, diagonal
    (8, 40, 32, 0),      # a suffix of queries over the whole prefix
    (16, 16, 16, 0),     # a ring step below the diagonal: every pair
    (16, 16, 0, 16),     # a ring step above it: none
    (20, 12, 5, 9),      # offsets that cut the mask inside the block
    (9, 30, 3, 0),       # keys past the last query's position
])
def test_causal_call_counts_its_visible_pairs(s_q, s_k, q_offset, k_offset):
    qi = torch.arange(s_q)[:, None] + q_offset
    ki = torch.arange(s_k)[None, :] + k_offset
    pairs = int((qi >= ki).sum())
    assert attention.visible_pairs(s_q, s_k, True, q_offset,
                                   k_offset) == pairs
    assert attention.visible_pairs(s_q, s_k, False, q_offset,
                                   k_offset) == s_q * s_k
    b, h, d = 2, 3, 16
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(b, h, s_q, d, generator=gen)
    k, v = (torch.randn(b, h, s_k, d, generator=gen) for _ in range(2))
    kw = dict(causal=True, q_offset=q_offset, k_offset=k_offset)
    fwd = _work_delta(lambda: attention.flash_attention_fwd(q, k, v, **kw))
    o, lse = attention.flash_attention_fwd(q, k, v, **kw)
    bwd = _work_delta(lambda: attention.flash_attention_bwd(
        q, k, v, o, lse, torch.randn_like(o), **kw))
    assert fwd["attention.flash_fwd.calls"] == 1
    assert fwd["attention.flash_fwd.flops"] == 4 * b * h * d * pairs
    assert fwd["attention.flash_fwd.bytes"] == b * h * (
        (2 * s_q + 2 * s_k) * d * 4 + s_q * 4)
    assert bwd["attention.flash_bwd.flops"] == 8 * b * h * d * pairs
    assert bwd["attention.flash_bwd.bytes"] == b * h * (
        (4 * s_q + 4 * s_k) * d * 4 + s_q * 4)
    assert bwd["attention.flash_fwd.calls"] == 0
