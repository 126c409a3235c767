"""The traffic and the weights repeat from their seed, and every seed gets
the same work."""

from __future__ import annotations

import pytest
import torch

from perfbench.harness.seeds import derive
from perfbench.harness.weights import make_weights, shapes
from perfbench.loops.train import batch, make_batches

BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG, -3, 2 ** 70])
def test_training_batches_repeat_from_their_seed(tiny, seed):
    cell = tiny("train-gpt2l-b16")
    tr = cell.traffic
    a = make_batches(cell, seed, torch.device("cpu"))
    assert torch.equal(a, make_batches(cell, seed, torch.device("cpu")))
    assert a.shape == (tr["batches"], tr["batch_rows"], tr["seq_len"] + 1)
    assert 0 <= int(a.min()) and int(a.max()) < cell.config["vocab_size"]


def test_training_batches_differ_by_seed_and_row(tiny):
    cell = tiny("train-gpt2l-b16")
    a = make_batches(cell, BIG, torch.device("cpu"))
    b = make_batches(cell, BIG + 1, torch.device("cpu"))
    assert a.shape == b.shape and not torch.equal(a, b)
    rows = a.reshape(-1, a.shape[-1])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    # a batch's targets are its inputs one on
    one = batch(a, 3)
    assert torch.equal(one["input_ids"][:, 1:], one["targets"][:, :-1])
    assert torch.equal(batch(a, 3 + a.shape[0])["input_ids"],
                       one["input_ids"])


def test_seeds_of_different_purposes_differ():
    assert derive(5, 1) != derive(5, 2)
    assert derive(5, 1) == derive(5, 1)
    assert 0 <= derive(-1, 1) < 2 ** 63 and 0 <= derive(2 ** 80, 2) < 2 ** 63


def test_weights_repeat_from_their_seed_and_follow_gpt2_init():
    cfg = {"n_embd": 64, "n_layer": 2, "n_head": 4, "n_positions": 128,
           "vocab_size": 512, "initializer_range": 0.02}
    a = make_weights(cfg, BIG, torch.device("cpu"))
    b = make_weights(cfg, BIG, torch.device("cpu"))
    c = make_weights(cfg, BIG + 1, torch.device("cpu"))
    assert list(a) == [n for n, _ in shapes(cfg)]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wte.weight"], c["wte.weight"])
    assert a["wte.weight"].std().item() == pytest.approx(0.02, rel=0.05)
    assert a["h.0.mlp.fc_out.weight"].std().item() == pytest.approx(
        0.02 / 2, rel=0.05)
    assert torch.all(a["h.1.ln_2.weight"] == 1)
    assert torch.all(a["h.1.attn.qkv_proj.bias"] == 0)
