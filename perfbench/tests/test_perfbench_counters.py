"""The FLOP and byte counts of the per-layer readers against shapes
worked by hand."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench.harness.device import PEAKS
from perfbench.harness.trace import TraceSummary

BENCH = Path(__file__).resolve().parents[1]


def reader(name):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_gpt2_large_step_flops():
    mfu = reader("train_mfu")
    cfg = config("gpt2-large")
    # 36 blocks of 12 x 1280^2, and lm_head's 1280 x 50257
    assert mfu.matmul_params(cfg) == 36 * 12 * 1280 ** 2 + 1280 * 50257
    tokens = 16 * 1024
    matmul = 6 * mfu.matmul_params(cfg) * tokens
    assert matmul == pytest.approx(75.9e12, rel=1e-3)
    # 4 * 16 rows * 1280 * (1024 * 1025 / 2 pairs) * 36 layers, forward
    attention = mfu.attention_pair_flops(cfg, 16, 1024)
    assert attention == 4 * 16 * 1280 * 524800 * 36
    assert 3 * attention == pytest.approx(4.64e12, rel=1e-3)
    assert mfu.step_flops(cfg, 16, 1024) == matmul + 3 * attention


def test_train_mfu_reads_the_device_span():
    mfu = reader("train_mfu")
    cfg = config("gpt2-large")
    run = SimpleNamespace(config=cfg, traffic={"compute_dtype": "bfloat16"},
                          peaks=PEAKS, facts={"kind": "train", "steps": 10,
                                              "window_s": 3.3, "rows": 16,
                                              "seq_len": 1024},
                          trace=TraceSummary(3.3, 2.9, {}, span_s=3.0))
    # the device's span, not the host's window
    expected = 100 * 10 * mfu.step_flops(cfg, 16, 1024) / 3.0 / 989e12
    assert mfu.read(run) == pytest.approx(expected)
    run.trace = None
    assert mfu.read(run) is None
    run.trace = TraceSummary(3.3, 0.0, {})
    assert mfu.read(run) is None
    run.trace = TraceSummary(3.3, 2.9, {}, span_s=3.0)
    run.facts["kind"] = "serve"
    assert mfu.read(run) is None


def test_the_span_runs_from_the_first_device_op_to_the_last():
    from perfbench.harness.trace import WINDOW, summarize
    from torch.autograd import DeviceType

    class Ev:
        def __init__(self, name, start_us, dur_us, device):
            self._n, self._s, self._d, self._t = name, start_us, dur_us, device

        def name(self):
            return self._n

        def start_ns(self):
            return self._s * 1000

        def duration_ns(self):
            return self._d * 1000

        def device_type(self):
            return self._t

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    t = summarize([Ev(WINDOW, 0, 1000, cpu), Ev("aten::mm", 5, 50, cpu),
                   Ev("gemm_a", 100, 200, cuda), Ev("gemm_b", 400, 100, cuda),
                   Ev("before", -50, 40, cuda)])
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(300e-6)
    assert t.span_s == pytest.approx(400e-6)
    assert t.device_ops["gemm_a"] == [1, pytest.approx(200e-6)]
    assert "before" not in t.device_ops


def test_flash_training_bound():
    flash = reader("flash_roofline.train")
    cfg = config("gpt2-large")
    # one layer at 16 x 1024, bf16: q, k, v and o of 16 x 1024 x 1280 x 2
    # bytes and the f32 statistics of 16 x 20 x 1024 rows.  Both ways the
    # bytes bound it: the forward's 169.1 MB (50.5 us) against its 43.0
    # GFLOP (43.5 us), the backward's 338.9 MB (101.2 us) against its 86.0
    # GFLOP (86.9 us)
    fwd = 4 * 16 * 1280 * 524800
    tensor, stats = 16 * 1024 * 1280 * 2, 16 * 20 * 1024 * 4
    fwd_s = (4 * tensor + stats) / 3.35e12
    assert fwd_s > fwd / 989e12
    bwd_s = (8 * tensor + stats) / 3.35e12
    assert bwd_s > 2 * fwd / 989e12
    assert flash.layer_bound_s(cfg, 16, 1024, 2, 989e12, 3.35e12) == (
        pytest.approx(fwd_s + bwd_s))
    # no flash kernel in the trace: nothing to read
    run = SimpleNamespace(config=cfg, traffic={"compute_dtype": "bfloat16"},
                          peaks=PEAKS, trace=TraceSummary(1.0, 1.0, {}),
                          facts={"kind": "train", "steps": 1, "rows": 16,
                                 "seq_len": 1024})
    assert flash.read(run) is None
    run.trace = TraceSummary(1.0, 1.0, {
        "void flash_fwd_wgmma<64>": [36, 0.01],
        "void flash_bwd_dq_wgmma<64>": [36, 0.01],
        "nvjet_tst_320x128": [10, 0.5]})
    bound = flash.layer_bound_s(cfg, 16, 1024, 2, 989e12, 3.35e12) * 36
    assert flash.read(run) == pytest.approx(100 * bound / 0.02)


def test_shares_stay_under_the_peak_when_time_is_the_bound():
    """A share read where the device took exactly the least time is 100%."""
    mfu = reader("train_mfu")
    cfg = config("gpt2-large")
    flops = mfu.step_flops(cfg, 16, 1024)
    run = SimpleNamespace(config=cfg, traffic={"compute_dtype": "bfloat16"},
                          peaks=PEAKS,
                          trace=TraceSummary(1.0, flops / 989e12, {},
                                             span_s=flops / 989e12),
                          facts={"kind": "train", "steps": 1, "rows": 16,
                                 "seq_len": 1024, "window_s": 1.0})
    assert mfu.read(run) == pytest.approx(100.0)
