"""Training: steps of the port's ``ShardedPretrainer`` back to back.

Set-up builds one trainer from the seed's weights and drives it through its
first steps (``check_steps``), through the window's own call and feed, on
batches whose rows all differ; the window then runs that same trainer.
Once the window has closed and the trainer is freed, the plain reference
follows the same first steps from the same weights and batches, and three
numbers are read, and those with a limit (``limits/<workload>.json``)
compared:

* ``loss_gap``: the largest relative gap of a first step's loss (read by
  ``perfbench/calibrate.py``, not compared);
* ``grad_gap``: the first gradient as AdamW got it (its first moment after
  one step, over 1 - beta1), the worst leaf's gap of norms;
* ``change_gap``: the parameters' change over the first steps, as the
  next step finds them, the worst leaf's gap of norms, leaving out leaves
  whose reference gradient is under a thousandth of the median leaf's.
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional

from perfbench.harness.record import Check, Outcome, gap_of_norms
from perfbench.harness.seeds import TOKENS, derive
from perfbench.harness.trace import note
from perfbench.harness.weights import make_weights, port_config

# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone under Adam, and is left out of ``change_gap``
STILL_LEAF = 1e-3


def model_config(cell):
    import torch

    tr = cell.traffic
    return port_config(cell.config, dtype=getattr(torch, tr["compute_dtype"]),
                       attention_impl=tr["attention_impl"], remat=tr["remat"])


def make_batches(cell, seed: int, device):
    """``batches`` batches of token ids, (n, rows, seq_len + 1), uniform over
    the vocabulary; a batch's ids are its inputs and, one on, its
    targets."""
    import torch

    tr = cell.traffic
    gen = torch.Generator(device=device).manual_seed(derive(seed, TOKENS))
    return torch.randint(0, cell.config["vocab_size"],
                         (tr["batches"], tr["batch_rows"], tr["seq_len"] + 1),
                         generator=gen, device=device)


def batch(pool, i: int) -> Dict:
    ids = pool[i % pool.shape[0]]
    return {"input_ids": ids[:, :-1], "targets": ids[:, 1:]}


def build_trainer(cell, seed: int, device):
    from ray_tpu_torch.models.pretrain import ShardedPretrainer

    opt = cell.traffic["optimizer"]
    weights = make_weights(cell.config, seed, device)
    return ShardedPretrainer(model_config(cell), lr=opt["lr"],
                             total_steps=opt["total_steps"], device=device,
                             params=weights)


def program_readings(trainer, cell, seed: int, pool, device) -> Dict:
    """The trainer's first ``check_steps`` steps: their losses, the first
    gradient as AdamW got it, and the parameters' change."""
    import torch

    from perfbench.reference.gpt2 import leaf_norms

    beta1 = cell.traffic["optimizer"]["betas"][0]
    named = dict(trainer.model.named_parameters())
    losses: List[float] = []
    grads: Dict[str, float] = {}
    for i in range(cell.traffic["check_steps"]):
        losses.append(float(trainer.step(batch(pool, i))))
        if i == 0:
            state = trainer.opt.adamw.state
            grads = leaf_norms({
                k: (state[p]["exp_avg"] / (1 - beta1) if p in state
                    else torch.zeros_like(p)) for k, p in named.items()})
    with torch.no_grad():
        start = make_weights(cell.config, seed, device)
        change = leaf_norms({k: named[k].detach() - start[k] for k in start})
        del start
    return {"losses": losses, "grads": grads, "change": change}


def reference_readings(cell, seed: int, pool, device,
                       precision: str = "f32") -> Dict:
    """The plain reference's first ``check_steps`` steps from the same
    weights and batches, in ``precision``."""
    import torch

    from perfbench.reference import gpt2 as ref

    ref.no_tf32()
    tr = cell.traffic
    start = make_weights(cell.config, seed, device)
    trainer = ref.Trainer(start, cell.config, tr["optimizer"], precision,
                          tr["reference_rows_per_block"])
    losses = []
    for i in range(tr["check_steps"]):
        b = batch(pool, i)
        losses.append(trainer.step(b["input_ids"], b["targets"]))
    with torch.no_grad():
        change = ref.leaf_norms({k: trainer.w[k] - start[k] for k in start})
    return {"losses": losses, "grads": trainer.first_grad_norms,
            "change": change}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    med = sorted(ref["grads"].values())[len(ref["grads"]) // 2]
    moving = [k for k, g in ref["grads"].items() if g >= STILL_LEAF * med]
    return {"loss_gap": loss_gap,
            "grad_gap": gap_of_norms(prog["grads"], ref["grads"]),
            "change_gap": gap_of_norms(prog["change"], ref["change"],
                                       moving)}


def checks(readings: Dict[str, float], limits: Mapping) -> List[Check]:
    """The readings that have a limit: ``loss_gap`` has none (no control
    or fault separates it from sound runs), and is only read."""
    return [Check(name, readings[name], lim["limit"])
            for name, lim in limits.items()]


def run(cell, seed: int, seconds: float, tracer, device,
        setup_started: float) -> Outcome:
    import math

    import torch

    tr = cell.traffic
    tokens_per_step = tr["batch_rows"] * tr["seq_len"]
    trainer = build_trainer(cell, seed, device)
    pool = make_batches(cell, seed, device)
    prog = program_readings(trainer, cell, seed, pool, device)
    at = tr["check_steps"]
    for _ in range(tr["warm_steps"]):
        float(trainer.step(batch(pool, at)))
        at += 1
    setup_s = time.perf_counter() - setup_started

    losses: List[float] = []
    with tracer.window():
        t0 = time.perf_counter()
        pending: Optional[torch.Tensor] = None
        while True:
            loss = trainer.step(batch(pool, at))
            at += 1
            if pending is not None:
                # one step stays queued behind the one waited for
                losses.append(float(pending))
            pending = loss
            if time.perf_counter() - t0 >= seconds:
                break
        losses.append(float(pending))
        window_s = time.perf_counter() - t0
    steps = len(losses)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    del trainer, loss, pending
    if device.type == "cuda":
        torch.cuda.empty_cache()
    note(f"set-up {setup_s:.1f} s, window {window_s:.1f} s, {steps} steps")
    t_ref = time.perf_counter()
    ref = reference_readings(cell, seed, pool, device)
    note(f"reference {time.perf_counter() - t_ref:.1f} s")
    out = Outcome(attempted=steps, failed=0, memory_peak_bytes=peak)
    out.metrics = {"train_tokens_per_s": steps * tokens_per_step / window_s,
                   "setup_s": setup_s}
    out.checks = checks(compare(prog, ref), cell.limits)
    if not all(math.isfinite(x) for x in losses):
        out.faults.append("a loss in the window is not finite")
    out.trace = tracer.summary
    out.facts = {"kind": "train", "steps": steps, "window_s": window_s,
                 "rows": tr["batch_rows"], "seq_len": tr["seq_len"]}
    return out
