"""Each fault the cell can have, planted under the timed path of a whole
run (the look for a card skipped, the cell cut to CPU size): ``correct``
comes out false.  A sound run beside them comes out true.

Training can have two of the four: a step that returns its state
unchanged, and half of the batch left out with the mean taken over the
rest; what a step produces is that state, and no token, and no cell spans
chips, so none has an exchange to leave out.  Besides, one small leaf left
unmoved (the moving leaf whose reference gradient is the smallest) fails
the worst-leaf gap, although that gap measures a leaf under the median
against the median leaf's norm."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench.harness.execute import execute

TRAIN = "train-gpt2l-b16"


def run(cell):
    return execute(cell, 2 ** 31 + 99, 0.6, False, torch.device("cpu"),
                   time.perf_counter())


def test_sound_run_is_correct(tiny):
    assert run(tiny(TRAIN))["correct"] is True


def _state_unchanged(monkeypatch):
    from ray_tpu_torch.models.pretrain import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self: None)


def _half_batch(monkeypatch):
    from ray_tpu_torch.models.pretrain import ShardedPretrainer

    feed = ShardedPretrainer.shard_batch
    monkeypatch.setattr(
        ShardedPretrainer, "shard_batch",
        lambda self, b: {k: v[:v.shape[0] // 2]
                         for k, v in feed(self, b).items()})


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_training_fault_is_caught(tiny, monkeypatch, fault):
    fault(monkeypatch)
    out = run(tiny(TRAIN))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_a_small_leaf_left_unmoved_is_caught(tiny):
    from perfbench import calibrate

    cell = tiny(TRAIN)
    row = calibrate.leaf_readings(cell, 2 ** 31 + 99, torch.device("cpu"))
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    assert all(row["sound"][k] <= lim for k, lim in limits.items()), row
    assert any(row["faults"]["unmoved"][k] > lim
               for k, lim in limits.items()), row
    # the leaf planted in is the smallest moving one, under the median
    assert row["grad_over_median"][0][1] == row["leaf"]
    assert row["grad_over_median"][0][0] < 1
