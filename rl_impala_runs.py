#!/usr/bin/env python3
"""How often IMPALA's relaunch path reaches a return of 350 within 400,000
env steps, run after run, with its learner on the card.

    python3 rl_impala_runs.py [--rounds N] [--seeds 0,1,2] [--device cpu]

Each round is chip_smoke.py phase 6r (c)'s relaunch check, from the
chip_smoke.py beside this script: tests/test_rllib.py:160-189's config at
each seed, the runs side by side in one driver, every learner on the card
unless ``--device cpu``.  ``--seeds 0`` runs one run a round, as the JAX
package's test does.  Prints the check's line for every round, then one
JSON line: each run's seed, env steps to 350 (null if it missed) and best
return, the runs that reached 350 and the rounds in which at least one
did.  Needs a CUDA card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    seeds = tuple(int(s) for s in args.seeds.split(","))

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import ray_tpu_torch as rt

    if args.device is None:
        label = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    else:
        label = args.device
    runs, rounds_reached = [], 0
    rt.init()
    try:
        for _ in range(args.rounds):
            out = smoke._impala_relaunch_runs(label, seeds, args.device)
            rounds_reached += out["reached"] > 0
            runs += out["runs"]
    finally:
        rt.shutdown()
    print(json.dumps({
        "device": label, "seeds": list(seeds), "rounds": args.rounds,
        "rounds_reached": rounds_reached,
        "runs_reached": sum(r["reached_at"] is not None for r in runs),
        "runs": [{"seed": r["seed"], "reached_at": r["reached_at"],
                  "best_return": round(r["best_return"], 2),
                  "env_steps": r["env_steps"]} for r in runs]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
