#!/usr/bin/env python3
"""One-card pipeline training of two trees of the port, in turns.

    python3 pipeline_ab.py PARENT_DIR CHANGE_DIR [--pp N] [--rounds N]

Each round runs the parent, the change, the change, the parent (every
second round the change, the parent, the parent, the change), each in a
fresh process that imports ``ray_tpu_torch`` from its own tree and trains
chip_smoke.py phase 6f's model and batch (GPT-2-small, bf16, flash, no
remat, 16 x 1024, from the chip_smoke.py beside this script) through
``PipelinedPretrainer`` without a process group at pp = N (default 4,
M = 2N): two untimed steps (the first builds the kernels), eight timed
steps, then one step traced with torch.profiler for the device's busy
time.  Prints one line per run and the median step time and busy time of
each side.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def _one(root: str, pp: int) -> None:
    # the tree under test supplies ray_tpu_torch; the workload is this
    # script's own (chip_smoke.py beside it), the same for both trees
    sys.path.insert(0, os.path.abspath(root))
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import ray_tpu_torch
    from ray_tpu_torch.models import GPT2Config, PipelinedPretrainer
    from ray_tpu_torch.parallel import MeshConfig

    if not ray_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"ray_tpu_torch came from {ray_tpu_torch.__file__}"
                           f", not from {root}")
    from torch.profiler import ProfilerActivity, profile

    cfg = GPT2Config(remat=False)
    batch = chip_smoke._train_batch(cfg, chip_smoke.TRAIN_BATCH, 0)
    trainer = PipelinedPretrainer(cfg, MeshConfig(pp=pp))
    for _ in range(2):
        trainer.step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        loss = trainer.step(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 8
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.step(batch)
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(json.dumps({"step_ms": step_ms, "device_busy_ms": busy_ms,
                      "loss": loss.item()}), flush=True)


def main() -> int:
    args = sys.argv[1:]
    opts = {"--pp": 4, "--rounds": 1}
    for key in opts:
        if key in args:
            i = args.index(key)
            opts[key] = int(args[i + 1])
            args = args[:i] + args[i + 2:]
    if args and args[0] == "--one":
        _one(args[1], opts["--pp"])
        return 0
    trees = {"parent": os.path.abspath(args[0]),
             "change": os.path.abspath(args[1])}
    runs = {"parent": [], "change": []}
    for r in range(opts["--rounds"]):
        a, b = ("parent", "change") if r % 2 == 0 else ("change", "parent")
        for side in (a, b, b, a):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one",
                 trees[side], "--pp", str(opts["--pp"])],
                capture_output=True, text=True, check=True,
                cwd=trees[side]).stdout
            row = json.loads(out.splitlines()[-1])
            runs[side].append(row)
            print(f"[pipeline_ab] {side}: pp={opts['--pp']} step_ms="
                  f"{row['step_ms']} device_busy_ms={row['device_busy_ms']} "
                  f"loss={row['loss']}", flush=True)
    for side, rows in runs.items():
        print(f"[pipeline_ab] {side} median over {len(rows)} runs: step_ms="
              f"{statistics.median(r['step_ms'] for r in rows)} "
              f"device_busy_ms="
              f"{statistics.median(r['device_busy_ms'] for r in rows)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
