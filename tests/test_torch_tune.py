"""The port's Tune (``ray_tpu_torch.tune``) on the CPU, against the JAX
package's.

The 8 cases of ``tests/test_tune.py``, one for one.  Without a runtime:
``generate_variants`` and the TPE searcher's suggestions equal the JAX
package's for the same seeds; ASHA's and PBT's decisions (stop, continue,
the restart config) equal the JAX schedulers' on the same scripted stream
of results.  On one port runtime for the module (``init(num_cpus=4)``, no
GPU): the grid with an injected failure retried, retries exhausted with
``tuner_state.json`` recording them, ASHA cutting a weak trial, PBT
restarting a weak trial from its donor's checkpoint, TPE through the
Tuner, and a Tuner over ``TorchTrainer`` on a CPU worker fed by
``datasets=``: GPT-2 tiny through ``ShardedPretrainer(device="cpu")``,
whose best trial's losses equal a direct ``ShardedPretrainer`` run on the
same batches.

JAX and the JAX package are imported inside the tests only: the workers
that import this module never load them.
"""

import json
import os
import random

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch import tune
from ray_tpu_torch.air.config import FailureConfig, RunConfig
from ray_tpu_torch.tune import TuneConfig, Tuner
from ray_tpu_torch.tune.search import generate_variants

GPT_TINY_BATCHES, GPT_TINY_ROWS, GPT_TINY_SEQ = 3, 4, 64


@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=256 * 1024 ** 2)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _space(t):
    return {"lr": t.grid_search([1e-3, 1e-4]),
            "wd": t.grid_search([0.0, 0.1]), "hidden": 64,
            "drop": t.uniform(0.0, 0.5),
            "nested": {"act": t.choice(["relu", "tanh"]),
                       "lr2": t.loguniform(1e-5, 1e-1),
                       "n": t.randint(1, 9)}}


# ========================================================== no runtime
def test_generate_variants_grid_and_samplers():
    from ray_tpu import tune as jtune
    from ray_tpu.tune.search import generate_variants as jgenerate

    space = _space(tune)
    variants = generate_variants(space, num_samples=1)
    assert len(variants) == 4
    assert {(v["lr"], v["wd"]) for v in variants} == {
        (1e-3, 0.0), (1e-3, 0.1), (1e-4, 0.0), (1e-4, 0.1)}
    assert all(v["hidden"] == 64 for v in variants)
    assert all(0.0 <= v["drop"] <= 0.5 for v in variants)
    assert len(generate_variants(space, num_samples=3)) == 12
    for seed in (0, 1, 7):
        assert generate_variants(space, num_samples=3, seed=seed) == \
            jgenerate(_space(jtune), num_samples=3, seed=seed)


def _objective(cfg):
    return -((cfg["x"] - 0.3) ** 2 + (cfg["y"] + 0.7) ** 2)


def test_tpe_beats_random_search():
    """The JAX case's bar, and every suggestion equal to the JAX
    searcher's on the same seed and the same results."""
    from ray_tpu.tune.search import TPESearcher as JaxTPE
    from ray_tpu.tune.search import uniform as juniform

    from ray_tpu_torch.tune.search import TPESearcher, uniform

    budget = 60

    def run_tpe(cls, unif, seed):
        s = cls(n_initial=10, seed=seed)
        s.setup({"x": unif(-2.0, 2.0), "y": unif(-2.0, 2.0)},
                metric="score", mode="max")
        best, seen = -float("inf"), []
        for _ in range(budget):
            cfg = s.suggest()
            score = _objective(cfg)
            s.on_trial_complete(cfg, score)
            best = max(best, score)
            seen.append(cfg)
        return best, seen

    def run_random(seed):
        space = {"x": uniform(-2.0, 2.0), "y": uniform(-2.0, 2.0)}
        rng = random.Random(seed)
        best = -float("inf")
        for _ in range(budget):
            cfg = {k: v.sample(rng) for k, v in space.items()}
            best = max(best, _objective(cfg))
        return best

    tpe = [run_tpe(TPESearcher, uniform, s) for s in range(5)]
    jax_tpe = [run_tpe(JaxTPE, juniform, s) for s in range(5)]
    assert [seen for _, seen in tpe] == [seen for _, seen in jax_tpe]
    tpe_scores = [best for best, _ in tpe]
    rnd_scores = [run_random(s) for s in range(5)]
    assert sum(tpe_scores) / 5 > sum(rnd_scores) / 5, (tpe_scores,
                                                       rnd_scores)


def _scripted_decisions(sched_mod, trial_cls, sched):
    """Feed ``sched`` one scripted stream of intermediate results from four
    trials and collect every decision, with PBT's restart configs."""
    sched.set_experiment("score", "max")
    trials = [trial_cls(index=i, config={"lr": lr}, name=f"t{i}")
              for i, lr in enumerate((0.01, 10.0, 1.0, 0.1))]
    out = []
    for it in range(1, 17):
        for t in trials:
            m = {"score": t.config["lr"] * it, "training_iteration": it}
            out.append(sched.on_result(t, m))
            if isinstance(sched, sched_mod.PopulationBasedTraining):
                sched.record_checkpoint(t.index, f"ckpt-{t.index}-{it}")
    out.extend(sched.on_trial_complete(t, None) for t in trials)
    return out


@pytest.mark.parametrize("which", ["asha", "pbt"])
def test_scheduler_decisions_match_jax(which):
    """ASHA stops the same trials at the same rungs, and PBT exploits the
    same trials with the same donors, mutations and checkpoints."""
    from ray_tpu.tune import schedulers as jsched
    from ray_tpu.tune.tuner import Trial as JaxTrial

    from ray_tpu_torch.tune import schedulers as sched
    from ray_tpu_torch.tune.tuner import Trial

    def make(mod):
        if which == "asha":
            return mod.ASHAScheduler(max_t=16, grace_period=2,
                                     reduction_factor=2)
        return mod.PopulationBasedTraining(
            perturbation_interval=2, quantile_fraction=0.5,
            hyperparam_mutations={"lr": [5.0, 10.0, 20.0]}, seed=0)

    got = _scripted_decisions(sched, Trial, make(sched))
    want = _scripted_decisions(jsched, JaxTrial, make(jsched))
    assert got == want
    assert sched.STOP in got  # the stream exercises a cut


# ============================================================= runtime
def _flaky_trainable(config):
    """Fails on the first attempt of x==2 only (marker file = attempt
    log)."""
    marker = os.path.join(config["dir"], f"attempt_{config['x']}")
    if config["x"] == 2 and not os.path.exists(marker):
        open(marker, "w").close()
        raise RuntimeError("injected trial failure")
    return {"score": -(config["x"] - 3) ** 2}


def test_tuner_grid_with_injected_failure(runtime, tmp_path):
    tuner = Tuner(
        _flaky_trainable,
        param_space={"x": tune.grid_search([1, 2, 3, 4]),
                     "dir": str(tmp_path)},
        tune_config=TuneConfig(num_samples=1, max_concurrent_trials=2,
                               metric="score", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
    )
    results = tuner.fit()
    assert len(results) == 4
    assert not results.errors
    best = results.get_best_result()
    assert best.metrics["config"]["x"] == 3
    assert best.metrics["score"] == 0
    assert os.path.exists(tmp_path / "attempt_2")


def test_tuner_failure_exhausts_retries(runtime, tmp_path):
    def always_fails(config):
        raise ValueError("hopeless")

    tuner = Tuner(
        always_fails,
        param_space={"x": tune.grid_search([1, 2])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(storage_path=str(tmp_path),
                             failure_config=FailureConfig(max_failures=1)),
    )
    results = tuner.fit()
    assert len(results.errors) == 2
    with pytest.raises(RuntimeError, match="no successful trial"):
        results.get_best_result()
    exp_dir = os.path.join(str(tmp_path), tuner._run_config.name)
    with open(os.path.join(exp_dir, "tuner_state.json")) as f:
        state = json.load(f)
    assert all(t["status"] == "ERROR" and t["num_failures"] == 2
               for t in state["trials"])


def _widen(batch):
    """A stored (rows, 2, S) int32 shard as int64 ``input_ids`` and
    ``targets``."""
    return {"input_ids": batch["data"][:, 0].astype(np.int64),
            "targets": batch["data"][:, 1].astype(np.int64)}


def _gpt_tiny_loop(config):
    """GPT-2 tiny on the CPU worker, each batch from the trainer's
    dataset shard."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import GPT2Config, ShardedPretrainer

    torch.set_num_threads(1)
    trainer = ShardedPretrainer(GPT2Config.tiny(), lr=config["lr"],
                                device="cpu")
    shard = train.get_dataset_shard("train")
    for i, batch in enumerate(shard.iter_torch_batches(
            batch_size=GPT_TINY_ROWS, drop_last=True, device="cpu")):
        train.report({"loss": trainer.step(batch).item(), "step": i})


def _gpt_tiny_shards():
    rng = np.random.default_rng(11)
    vocab = 512
    return [rng.integers(0, vocab, (GPT_TINY_ROWS, 2, GPT_TINY_SEQ))
            .astype(np.int32) for _ in range(GPT_TINY_BATCHES)]


def test_tuner_over_torch_trainer(runtime, tmp_path):
    """``tests/test_tune.py::test_tuner_over_jax_trainer``: Tuner over
    ``TorchTrainer`` on a CPU worker, its batches from ``datasets=``
    (``.npy`` shards through ``read_numpy`` and ``map_batches``).  The best
    trial's losses equal a direct ``ShardedPretrainer`` run on the same
    batches from the same initial parameters."""
    import torch

    from ray_tpu_torch.models import GPT2Config, ShardedPretrainer
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    shards = _gpt_tiny_shards()
    rd.from_numpy(shards).write_numpy(str(tmp_path / "shards"))
    ds = rd.read_numpy(str(tmp_path / "shards")).map_batches(
        _widen, batch_format="numpy")
    trainer = TorchTrainer(
        _gpt_tiny_loop, datasets={"train": ds},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False))
    tuner = Tuner(
        trainer,
        param_space={"lr": tune.grid_search([3e-4, 3e-2])},
        tune_config=TuneConfig(metric="loss", mode="min",
                               max_concurrent_trials=1),
        run_config=RunConfig(storage_path=str(tmp_path / "runs")),
    )
    results = tuner.fit()
    assert len(results) == 2
    assert not results.errors
    best = results.get_best_result()
    last = {r.metrics["config"]["lr"]: r.metrics["loss"] for r in results}
    assert best.metrics["loss"] == min(last.values())
    assert len(best.metrics_history) == GPT_TINY_BATCHES
    assert os.path.exists(os.path.join(
        str(tmp_path / "runs"), tuner._run_config.name, "tuner_state.json"))

    torch.set_num_threads(1)
    direct = ShardedPretrainer(GPT2Config.tiny(),
                               lr=best.metrics["config"]["lr"],
                               device="cpu")
    want = [direct.step(_widen({"data": s})).item() for s in shards]
    assert [m["loss"] for m in best.metrics_history] == want


def test_asha_early_stops_bad_trials(runtime, tmp_path):
    def trainable(config):
        import time as _t

        iters = 0
        for i in range(16):
            iters = i + 1
            _t.sleep(0.25)  # give the controller a pump cycle per iteration
            tune.report({"score": config["quality"] * (i + 1),
                         "iters_done": iters})
        return {"score": config["quality"] * 16, "iters_done": iters}

    tuner = tune.Tuner(
        trainable,
        param_space={"quality": tune.grid_search([2.0, 1.0, 0.2, 0.1])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=2,
            scheduler=tune.ASHAScheduler(max_t=16, grace_period=2,
                                         reduction_factor=2)),
        run_config=RunConfig(storage_path=str(tmp_path), name="asha"),
    )
    grid = tuner.fit()
    best = grid.get_best_result()
    assert best.metrics["config"]["quality"] == 2.0
    stopped_early = [r for r in grid
                     if r.error is None and r.metrics.get("__early_stopped__")]
    assert stopped_early, "ASHA never early-stopped a trial"


def test_pbt_exploits_and_restarts(runtime, tmp_path):
    def trainable(config):
        import time as _t

        start = tune.get_checkpoint()
        base = 100 if start == "warm" else 0
        score = base
        n = 48 if config["lr"] < 1 and base == 0 else 12
        for i in range(n):
            _t.sleep(0.2)
            score = base + config["lr"] * (i + 1)
            tune.report({"score": score}, checkpoint="warm")
        return {"score": score, "lr": config["lr"], "warm": base > 0}

    tuner = tune.Tuner(
        trainable,
        param_space={"lr": tune.grid_search([0.01, 10.0])},
        tune_config=tune.TuneConfig(
            metric="score", mode="max", max_concurrent_trials=2,
            scheduler=tune.PopulationBasedTraining(
                perturbation_interval=2, quantile_fraction=0.5,
                hyperparam_mutations={"lr": [5.0, 10.0, 20.0]}, seed=0)),
        run_config=RunConfig(storage_path=str(tmp_path), name="pbt"),
    )
    grid = tuner.fit()
    results = [r for r in grid if r.error is None]
    assert len(results) == 2
    warm = [r for r in results if r.metrics.get("warm")]
    assert warm, "PBT never restarted a trial from a donor checkpoint"
    assert all(r.metrics["lr"] >= 5.0 for r in warm)


def test_tpe_through_tuner(runtime, tmp_path):
    from ray_tpu_torch.tune.search import TPESearcher, uniform

    def trainable(config):
        return {"score": -((config["x"] - 1.0) ** 2)}

    tuner = tune.Tuner(
        trainable,
        param_space={"x": uniform(-3.0, 3.0)},
        tune_config=tune.TuneConfig(
            num_samples=25, metric="score", mode="max",
            max_concurrent_trials=2,
            search_alg=TPESearcher(n_initial=8, seed=3)),
        run_config=RunConfig(name="tpe", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    best = grid.get_best_result()
    assert best.metrics["score"] > -0.5, best.metrics
    assert len(tuner._tune_config.search_alg._obs) == 25
