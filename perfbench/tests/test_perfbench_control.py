"""The control: the reference put in the program's place one precision
lower than the configuration states (FP8 for the bfloat16 training cell)
has to come out as not correct.

On the card the readings are taken at the cell's own size on three seeds
(``perfbench/calibrate.py``, as the limits were set).  On the CPU, at a
size cut to it, the control has to read at least three times the sound run
on some number."""

from __future__ import annotations

import pytest
import torch

from perfbench import calibrate
from perfbench.harness.spec import load_cell

TRAIN = "train-gpt2l-b16"
SEEDS = (2 ** 31 + 501, 2 ** 31 + 502, 2 ** 31 + 503)


def _over(readings, limits):
    """The compared readings over their limits (a reading without one is
    not compared)."""
    return [k for k, v in readings.items()
            if k in limits and v > limits[k]["limit"]]


def test_training_control_separates_at_cpu_size(tiny):
    row = calibrate.train_readings(tiny(TRAIN), SEEDS[0], torch.device("cpu"))
    sound, control = row["sound"], row["control"]
    assert any(control[k] >= 3 * sound[k] for k in control)


@pytest.mark.card
def test_control_fails_at_the_cells_size(card):
    cell = load_cell(TRAIN)
    for seed in SEEDS:
        row = calibrate.train_readings(cell, seed, card)
        assert not _over(row["sound"], cell.limits), row
        assert _over(row["control"], cell.limits), row
        assert _over(row["half_batch"], cell.limits), row
