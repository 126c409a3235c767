"""What a run loads: every cell's run loads no JAX and nothing of the JAX
package, and the reference loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys
import types
from pathlib import Path

from perfbench.harness.device import forbidden_loaded

ROOT = Path(__file__).resolve().parents[2]

RUN_A_CELL = """
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
from conftest import cut_to_cpu
from perfbench.harness.execute import execute
from perfbench.harness.spec import load_cell
for name in {cells!r}:
    res = execute(cut_to_cpu(load_cell(name)), 1, 0.3, False,
                  torch.device("cpu"), time.perf_counter())
    assert res["correct"], res
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""

REFERENCE_ALONE = """
import sys
sys.path.insert(0, {root!r})
import perfbench.reference.gpt2
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code: str) -> set:
    cells = [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]
    env_code = code.format(root=str(ROOT), cells=cells,
                           tests=str(ROOT / "perfbench" / "tests"))
    out = subprocess.run([sys.executable, "-c", env_code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_a_cell_loads_no_jax():
    tops = _modules(RUN_A_CELL)
    assert "ray_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "ray_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    tops = _modules(REFERENCE_ALONE)
    assert "torch" in tops
    assert not tops & {"ray_tpu_torch", "ray_tpu", "jax", "jaxlib"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ray_tpu_torch_like",
                        types.ModuleType("ray_tpu_torch_like"))
    assert "ray_tpu_torch_like" not in forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("jaxlib.xla_client"))
    assert "jaxlib" in forbidden_loaded()


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "train-gpt2l-b16",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in out.stderr
