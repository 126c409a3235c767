"""A configuration, a traffic mix and a per-layer metric added as files of
their own and entries in ``BENCHMARK.json``: the harness finds and runs
them with no other file edited."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

from perfbench.harness.execute import execute
from perfbench.harness.spec import load_cell

ROOT = Path(__file__).resolve().parents[2]

NEW_METRIC = '''"""``steps_seen.train``: steps in the traced window."""


def read(run):
    if run.facts.get("kind") != "train":
        return None
    return float(run.facts["steps"])
'''


def test_new_files_are_picked_up(tmp_path):
    bench_dir = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    config = json.loads((bench_dir / "configs" / "gpt2-large.json").read_text())
    config.update(name="gpt2-mini", n_embd=64, n_layer=2, n_head=4,
                  n_positions=128, n_ctx=128, vocab_size=512)
    (bench_dir / "configs" / "gpt2-mini.json").write_text(json.dumps(config))
    mix = json.loads((bench_dir / "traffic" / "pretrain-16x1024.json"
                      ).read_text())
    mix.update(batch_rows=2, seq_len=32, batches=4)
    (bench_dir / "traffic" / "pretrain-2x32.json").write_text(json.dumps(mix))
    shutil.copy(bench_dir / "limits" / "train-gpt2l-b16.json",
                bench_dir / "limits" / "train-mini.json")
    (bench_dir / "metrics" / "steps_seen.train.py").write_text(NEW_METRIC)

    bench["configs"].append({"name": "gpt2-mini", "source": "test",
                             "file": "perfbench/configs/gpt2-mini.json",
                             "reduced": config["reduced"], "why": "test"})
    bench["workloads"].append({"name": "train-mini", "config": "gpt2-mini",
                               "traffic": "pretrain-2x32", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append("train-mini")
    bench["per_layer"].append({
        "name": "steps_seen.train", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "trainer",
        "moves": "train_tokens_per_s", "workloads": ["train-mini"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell("train-mini", bench_dir=bench_dir)
    assert cell.config["n_embd"] == 64 and cell.traffic["seq_len"] == 32
    assert [m["name"] for m in cell.per_layer] == ["steps_seen.train"]
    assert {m["name"] for m in cell.end_to_end} == {"train_tokens_per_s",
                                                    "setup_s"}

    plain = execute(cell, 3, 0.5, False, torch.device("cpu"),
                    time.perf_counter())
    assert plain["correct"] is True
    assert set(plain["metrics"]) == {"train_tokens_per_s", "setup_s"}
    traced = execute(cell, 3, 0.5, True, torch.device("cpu"),
                     time.perf_counter())
    assert traced["metrics"]["steps_seen.train"]["value"] >= 1
    assert list(traced)[-1] == "checks"

