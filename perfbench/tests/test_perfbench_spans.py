"""``harness/spans.py``: the program's spans and counters in a traced
window, on kineto-like events built by hand, and on a real profiler's trace
of a CPU training step."""

from __future__ import annotations

import sys

import pytest

from perfbench.harness.spans import (
    counter_window,
    program_spans,
    read_counters,
)
from perfbench.harness.trace import WINDOW

MAIN, AUTOGRAD = 1, 2


class Ev:
    """One kineto event as torch 2.11 gives it, which does not say its
    kind: a host event (``kind`` ``cpu_op``, ``user_annotation`` or
    ``cuda_runtime``) or a device one (``kernel``)."""

    def __init__(self, name, start_us, dur_us, kind="cpu_op", corr=0,
                 linked=0, thread=MAIN):
        self._n, self._s, self._d = name, start_us, dur_us
        self._kind, self._corr, self._linked = kind, corr, linked
        self._thread = thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s * 1000

    def duration_ns(self):
        return self._d * 1000

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._kind == "kernel" else DeviceType.CPU

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def start_thread_id(self):
        return self._thread


def span(name, start, dur, corr, thread=MAIN):
    return Ev("ray_tpu_torch." + name, start, dur, "user_annotation", corr,
              thread=thread)


def launch(corr, at, kernel_start, kernel_us, thread=MAIN, op=7):
    """A runtime launch at ``at`` and its kernel, sharing ``corr``, both
    linked to the torch op ``op``."""
    return [Ev("cudaLaunchKernel", at, 1, "cuda_runtime", corr, op, thread),
            Ev(f"kernel_{corr}", kernel_start, kernel_us, "kernel", corr, op)]


def window(start=0, dur=1000):
    return Ev(WINDOW, start, dur, "user_annotation", 9999)


def test_a_launch_from_another_thread_counts_in_the_open_span():
    events = [window(),
              span("train.backward", 100, 200, 1),
              # autograd's device thread launches while the main thread
              # sits in train.backward; the kernel runs after it closes
              *launch(501, 150, 290, 40, thread=AUTOGRAD),
              *launch(502, 320, 330, 10, thread=AUTOGRAD)]
    spans = program_spans(events)
    assert spans["train.backward"]["instances"] == 1
    assert spans["train.backward"]["host_s"] == pytest.approx(200e-6)
    assert spans["train.backward"]["device_s"] == pytest.approx(40e-6)


def test_nested_spans_count_inclusively():
    events = [window(),
              span("train.step", 10, 500, 1),
              span("train.forward", 20, 200, 2),
              span("attention.flash_fwd", 50, 20, 3),
              span("attention.flash_fwd", 150, 20, 4),
              *launch(601, 55, 60, 30),      # in flash_fwd, forward, step
              *launch(602, 100, 100, 20),    # in forward and step
              *launch(603, 155, 190, 30),    # in flash_fwd, forward, step
              *launch(604, 400, 410, 50)]    # in step alone
    spans = program_spans(events)
    assert spans["attention.flash_fwd"]["instances"] == 2
    assert spans["attention.flash_fwd"]["device_s"] == pytest.approx(60e-6)
    assert spans["train.forward"]["device_s"] == pytest.approx(80e-6)
    assert spans["train.step"]["device_s"] == pytest.approx(130e-6)


def test_overlapping_operations_count_once():
    # two streams' kernels overlapping in time are one union
    events = [window(), span("train.optimizer", 0, 100, 1),
              *launch(701, 10, 20, 40), *launch(702, 11, 40, 40)]
    assert program_spans(events)["train.optimizer"]["device_s"] == (
        pytest.approx(60e-6))


def test_operations_outside_the_window_are_dropped():
    events = [window(100, 500),
              span("train.step", 50, 700, 1),
              *launch(801, 60, 60, 30),      # before the window
              *launch(802, 200, 580, 40),    # clipped at its end
              *launch(803, 640, 700, 20)]    # after it
    s = program_spans(events)["train.step"]
    assert s["device_s"] == pytest.approx(20e-6)
    assert s["host_s"] == pytest.approx(500e-6)
    # a span wholly outside the window is not reported
    events.append(span("train.forward", 700, 10, 2))
    assert "train.forward" not in program_spans(events)


def test_a_kernel_pairs_with_its_launch_not_with_an_op_of_its_id():
    events = [window(), span("train.forward", 100, 100, 1),
              # a torch op inside the span numbered as the kernel's CUPTI id
              Ev("aten::view", 120, 10, "cpu_op", corr=42),
              # the kernel's launch, linked to op 7, after the span
              Ev("cudaLaunchKernel", 300, 1, "cuda_runtime", 42, 7),
              Ev("gemm", 310, 25, "kernel", corr=42, linked=7),
              # a kernel whose launch is not in the trace counts nowhere
              Ev("orphan", 150, 10, "kernel", corr=902, linked=7),
              *launch(903, 130, 140, 5)]
    assert program_spans(events)["train.forward"]["device_s"] == (
        pytest.approx(5e-6))


def test_an_annotations_device_copy_is_not_an_operation():
    events = [window(), span("train.forward", 100, 100, 1),
              Ev("ray_tpu_torch.train.forward", 105, 90, "kernel", corr=1),
              *launch(1001, 110, 120, 10)]
    assert program_spans(events)["train.forward"]["device_s"] == (
        pytest.approx(10e-6))


def test_no_program_span_reads_nothing():
    events = [window(), *launch(1101, 10, 20, 30)]
    assert program_spans(events) == {}
    # no window, no reading
    assert program_spans([span("train.step", 0, 10, 1)]) == {}


def test_counters_are_the_windows_difference(monkeypatch):
    before = {"attention.flash_fwd.calls": 3, "attention.flash_fwd.flops": 12}
    after = {"attention.flash_fwd.calls": 5, "attention.flash_fwd.flops": 20,
             "attention.flash_bwd.calls": 1}
    assert counter_window(before, after) == {
        "attention.flash_fwd.calls": 2, "attention.flash_fwd.flops": 8,
        "attention.flash_bwd.calls": 1}
    assert counter_window({}, {}) == {}
    got = read_counters()
    assert got["attention.flash_fwd.flops"] >= 0
    assert "attention.flash_bwd.bytes" in got
    # a program without counters(): nothing to read
    monkeypatch.setitem(sys.modules, "ray_tpu_torch.util.tracing", None)
    assert read_counters() == {}


def test_a_cpu_steps_trace():
    """The profiler's own events for one CPU step of the port: every span
    once, no device time (the CPU runs no device operation)."""
    import dataclasses

    import numpy as np
    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.pretrain import ShardedPretrainer

    cfg = dataclasses.replace(GPT2Config.tiny(), remat=False)
    trainer = ShardedPretrainer(cfg, device="cpu")
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 33))
    batch = {"input_ids": ids[:, :-1], "targets": ids[:, 1:]}
    trainer.step(batch)
    before = read_counters()
    with torch.autograd.profiler.profile(use_kineto=True) as prof:
        with torch.autograd.profiler.record_function(WINDOW):
            trainer.step(batch)
    work = counter_window(before, read_counters())
    spans = program_spans(prof.kineto_results.events())
    assert {k: v["instances"] for k, v in spans.items()} == {
        "train.step": 1, "train.forward": 1, "train.backward": 1,
        "train.optimizer": 1, "attention.flash_fwd": cfg.n_layer,
        "attention.flash_bwd": cfg.n_layer}
    assert all(v["device_s"] == 0 and v["host_s"] > 0
               for v in spans.values())
    assert work["attention.flash_fwd.calls"] == cfg.n_layer
    # 4 FLOPs a causal pair (32·33/2 a head and row) and head dimension
    assert work["attention.flash_fwd.flops"] == 4 * 2 * 64 * 528 * 2
