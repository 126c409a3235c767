"""Shared pieces of the benchmark's tests: the ``card`` marker, and its
cells cut to a size the CPU runs in seconds."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# GPT-2 at a width the CPU runs in seconds; the harness's code paths are
# the cell's own
TINY_MODEL = {"n_embd": 64, "n_layer": 2, "n_head": 4, "n_positions": 128,
              "n_ctx": 128, "vocab_size": 512}
TINY_TRAIN = {"batch_rows": 4, "seq_len": 64, "batches": 8}
def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return torch.device("cuda", 0)


def cut_to_cpu(cell):
    """``cell`` with its model and traffic cut to CPU size (its limits,
    loop and metrics as they are)."""
    cell.config = {**cell.config, **TINY_MODEL}
    cell.traffic = {**copy.deepcopy(cell.traffic), **TINY_TRAIN}
    return cell


@pytest.fixture
def tiny():
    """``tiny(workload)``: the benchmark's cell ``workload`` cut to CPU
    size."""
    from perfbench.harness.spec import load_cell

    return lambda workload: cut_to_cpu(load_cell(workload))
