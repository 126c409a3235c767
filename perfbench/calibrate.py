"""The readings that a training cell's correctness limits are set from.

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--leaves]

For each seed, in one process on the card: the numbers that a sound run of
the program gives against the plain reference, the same numbers for the
control (the reference in the program's place in FP8, one precision lower
than the configuration's bfloat16) and for a step fed half of its batch;
with ``--leaves``, in their place, how the worst-leaf gaps treat the
smallest leaves (``leaf_readings``).  One JSON line a seed; the
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _free():
    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def half_batch(trainer):
    """The fault: each step fed the first half of its batch's rows, the
    loss the mean over them."""
    feed = trainer.shard_batch

    def first_half(batch):
        return {k: v[:v.shape[0] // 2] for k, v in feed(batch).items()}

    trainer.shard_batch = first_half
    return trainer


def scaled_leaf(trainer, leaf: str, factor: float):
    """The fault: ``leaf``'s gradient (a parameter's, or one of the fused
    query/key/value projection's three parts, ``<name>.q`` and so on)
    multiplied by ``factor`` before the optimizer gets it."""
    named = dict(trainer.model.named_parameters())
    name, part = (leaf, None) if leaf in named else leaf.rsplit(".", 1)
    rows = named[name].shape[0] // 3

    def scale(g):
        g = g.clone()
        if part is None:
            return g.mul_(factor)
        i = "qkv".index(part)
        g[i * rows:(i + 1) * rows] *= factor
        return g

    named[name].register_hook(scale)
    return trainer


def train_readings(cell, seed: int, device) -> dict:
    from perfbench.loops import train as T

    pool = T.make_batches(cell, seed, device)
    prog = T.program_readings(T.build_trainer(cell, seed, device), cell,
                              seed, pool, device)
    _free()
    half = T.program_readings(half_batch(T.build_trainer(cell, seed, device)),
                              cell, seed, pool, device)
    _free()
    ref = T.reference_readings(cell, seed, pool, device, "f32")
    _free()
    control = T.reference_readings(cell, seed, pool, device, "fp8")
    _free()
    return {"sound": T.compare(prog, ref), "control": T.compare(control, ref),
            "half_batch": T.compare(half, ref)}


def leaf_readings(cell, seed: int, device) -> dict:
    """How the worst-leaf gaps treat the small leaves: the smallest moving
    leaves' reference norms over the median leaf's, the sound run's gaps
    over each leaf's own norm, and the gaps of two faults planted in the
    moving leaf whose reference gradient is the smallest: its gradient
    doubled, and left unmoved."""
    from perfbench.loops import train as T

    pool = T.make_batches(cell, seed, device)
    ref = T.reference_readings(cell, seed, pool, device, "f32")
    _free()
    prog = T.program_readings(T.build_trainer(cell, seed, device), cell,
                              seed, pool, device)
    _free()
    grads, change = ref["grads"], ref["change"]
    med_g = sorted(grads.values())[len(grads) // 2]
    moving = [k for k, g in grads.items() if g >= T.STILL_LEAF * med_g]
    med_c = sorted(change[k] for k in moving)[len(moving) // 2]
    smallest = min(moving, key=grads.get)
    faults = {}
    for label, factor in (("doubled", 2.0), ("unmoved", 0.0)):
        trainer = scaled_leaf(T.build_trainer(cell, seed, device), smallest,
                              factor)
        faults[label] = T.compare(
            T.program_readings(trainer, cell, seed, pool, device), ref)
        del trainer
        _free()

    def own_norm_gap(p, r):
        return max(abs(p[n] - r[n]) / r[n] for n in moving)

    def lowest(norms, med):
        return sorted((norms[n] / med, n) for n in moving)[:4]

    return {"leaf": smallest,
            "grad_over_median": lowest(grads, med_g),
            "change_over_median": lowest(change, med_c),
            "sound": T.compare(prog, ref),
            "sound_own_norm": {
                "grad_gap": own_norm_gap(prog["grads"], grads),
                "change_gap": own_norm_gap(prog["change"], change)},
            "faults": faults}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--leaves", action="store_true",
                        help="read the smallest leaves and the faults "
                             "planted in one, in place of the control")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    read = leaf_readings if args.leaves else train_readings
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = read(cell, seed, device)
        row.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
        _free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
