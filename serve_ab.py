#!/usr/bin/env python3
"""Serving run of two trees of the port, in turns, on one card.

    python3 serve_ab.py PARENT_DIR CHANGE_DIR [--rounds N]

Each round runs the parent, the change, the change, the parent (every
second round the change, the parent, the parent, the change), each in a
fresh process that imports ``ray_tpu_torch`` from its own tree and times
three serving runs of chip_smoke.py phase 5's model and traffic (from the
chip_smoke.py beside this script) after one untimed run that builds the
kernels, then traces one more with torch.profiler for the device's busy
time.  Prints one line per run and the median tokens/s, TTFT and busy time
of each side.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def _one(root: str) -> None:
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
    _, _, prompts, params, engine = chip_smoke.serving_workload()
    import ray_tpu_torch

    if not ray_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"ray_tpu_torch came from {ray_tpu_torch.__file__}"
                           f", not from {root}")
    from torch.profiler import ProfilerActivity, profile

    for rep in range(4):
        core = engine()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [core.submit(p, params) for p in prompts]
        core.run_until_done(rids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = [core.result(r) for r in rids]
        ttft = sorted(r["ttft"] for r in res)
        if rep:  # the first run builds the kernels
            print(json.dumps({
                "wall_s": wall,
                "tokens_per_s": sum(len(r["tokens"]) for r in res) / wall,
                "ttft_median_s": ttft[len(ttft) // 2]}), flush=True)
    # one more run under the profiler: the device's busy time
    core = engine()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        core.run_until_done([core.submit(p, params) for p in prompts])
        torch.cuda.synchronize()
    print(json.dumps({"device_busy_s": sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6}),
        flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args and args[0] == "--one":
        _one(args[1])
        return 0
    rounds = 1
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        args = args[:i] + args[i + 2:]
    trees = {"parent": os.path.abspath(args[0]),
             "change": os.path.abspath(args[1])}
    runs = {"parent": [], "change": []}
    busy = {"parent": [], "change": []}
    for r in range(rounds):
        a, b = ("parent", "change") if r % 2 == 0 else ("change", "parent")
        for side in (a, b, b, a):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one",
                 trees[side]], capture_output=True, text=True, check=True,
                cwd=trees[side]).stdout
            for line in out.splitlines():
                row = json.loads(line)
                if "device_busy_s" in row:
                    busy[side].append(row["device_busy_s"])
                    print(f"[serve_ab] {side}: traced run device_busy_s="
                          f"{row['device_busy_s']}", flush=True)
                    continue
                runs[side].append(row)
                print(f"[serve_ab] {side}: wall_s={row['wall_s']} "
                      f"tokens_per_s={row['tokens_per_s']} "
                      f"ttft_median_s={row['ttft_median_s']}", flush=True)
    for side, rows in runs.items():
        print(f"[serve_ab] {side} median over {len(rows)} runs: tokens_per_s="
              f"{statistics.median(r['tokens_per_s'] for r in rows)} "
              f"ttft_median_s="
              f"{statistics.median(r['ttft_median_s'] for r in rows)} "
              f"device_busy_s={statistics.median(busy[side])} (over "
              f"{len(busy[side])} traced runs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
