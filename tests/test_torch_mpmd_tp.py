"""The port's MPMD stage sharded over tp (``TorchTrainer(pipeline_stages=P,
mesh=(dp, tp))``) on the CPU, against the JAX package's tp stage and the
port's unsharded stage, at tiny widths in f32 over 3 steps.

- without a process group: every stage parameter's spec is the JAX stage's
  ``match_partition_rules(gpt_partition_rules(), params)``, flipped for
  torch's (out, in) layout, and ``pipeline_mesh`` is ``None``;
- a gloo gang of two CPU ranks, spawned once for the module, runs a
  one-stage ``StageExecutor`` over tp=2 at M=2: each rank holds half the
  heads, the losses and gradient norms are within 1e-4 relative of JAX's
  ``StageExecutor`` on a (dp=1, tp=2) mesh of this process's virtual CPU
  devices and within 1e-5 relative of the port's unsharded stage, from the
  same flax parameters and batches, and the gathered parameters within
  1e-5 of the unsharded stage's; a restore re-shards a tree that gathers
  back bit for bit;
- ``TorchTrainer(gpt2_pipeline_loop, pipeline_stages=2, mesh=(1, 2))`` on
  four CPU worker actors: losses within 1e-5 of ``mesh=(1, 1)`` on two
  workers, and its checkpoint restored onto one stage on one card (the
  loop's ``load_full_params``) gathers to the same parameters bit for
  bit; ``mesh=(2, 2)`` (two replicas of a
  one-stage tp gang, a dp group a lane) within 1e-4 of them;
- the layout refusals: ``num_workers != dp * pipeline_stages * tp``, and
  a share of a card when tp > 1.

JAX and the JAX package are imported inside the tests only: the gang's
ranks import this module.
"""

import multiprocessing
import queue
import time
import uuid

import numpy as np
import pytest
import torch

import ray_tpu_torch

STEPS, M, TP = 3, 2, 2
LR = 1e-3
WIDTHS = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2,
              n_head=4)
GANG_TIMEOUT_S = 180


def _cfg():
    from ray_tpu_torch.models.gpt2 import GPT2Config

    return GPT2Config(**WIDTHS, dtype=torch.float32)


def _jax_cfg():
    import jax.numpy as jnp

    from ray_tpu.models.gpt2 import GPT2Config

    return GPT2Config(**WIDTHS, dtype=jnp.float32)


def _batches():
    out = []
    for step in range(STEPS):
        rng = np.random.default_rng(step)
        out.append({k: rng.integers(0, WIDTHS["vocab_size"], (8, 16),
                                    dtype=np.int32)
                    for k in ("input_ids", "targets")})
    return out


def _full_params():
    from ray_tpu_torch.train.pipeline import GPT2StageModule

    return GPT2StageModule(_cfg(), 0, 1, device="cpu").init_params(0)


# ------------------------------------------------- (a) without a group
@pytest.mark.parametrize("n_stages", [1, 2])
def test_stage_specs_are_the_jax_stages_flipped(n_stages):
    from ray_tpu.train.pipeline.partition import GPT2StageModule as JStage

    from ray_tpu_torch.models.convert import flax_paths
    from ray_tpu_torch.train.pipeline import GPT2StageModule, pipeline_mesh
    from ray_tpu_torch.train.pipeline.partition import flatten_params

    assert pipeline_mesh("cpu") is None  # no process group: one card
    full = _full_params()
    tp_sharded = []
    for stage in range(n_stages):
        mod = GPT2StageModule(_cfg(), stage, n_stages, device="cpu")
        jmod = JStage(_jax_cfg(), stage, n_stages)
        host = jmod.select_params(full)
        jspecs = jmod.specs(host)
        flat_host = flatten_params(host)
        paths = flax_paths(mod)
        specs = mod.specs()
        assert sorted(paths.values()) == sorted(flat_host)
        for name, p in mod.named_parameters():
            path = paths[name]
            node = jspecs
            for part in path.split("/"):
                node = node[part]
            want = tuple(node)
            if path.endswith("/kernel") and want:
                # (in, out) there, (out, in) here
                want = (want + (None,) * (2 - len(want)))[::-1]
            assert specs[name] == want, (name, specs[name], want)
            if "tp" in specs[name]:
                tp_sharded.append(name)
    # Megatron's layout over the heads and the MLP, and the vocab
    assert "h.0.attn.qkv_proj.weight" in tp_sharded
    assert "h.0.attn.out_proj.weight" in tp_sharded
    assert "lm_head.weight" in tp_sharded and "wte.weight" in tp_sharded


# ------------------------------------------------- (d) layout refusals
def test_layout_refusals():
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.pipeline import gpt2_pipeline_loop

    ok = TorchTrainer(gpt2_pipeline_loop, pipeline_stages=2, mesh=(1, 2),
                      scaling_config=ScalingConfig(num_workers=4))
    assert ok.backend_config.pipeline_stages == 2
    assert ok.train_loop_config["_pipeline"]["tp"] == 2
    for workers, stages, mesh in ((2, 2, (1, 2)), (8, 2, (1, 2)),
                                  (3, 1, (1, 2)), (4, 2, (2, 2))):
        with pytest.raises(ValueError,
                           match="dp \\* pipeline_stages \\* tp"):
            TorchTrainer(gpt2_pipeline_loop, pipeline_stages=stages,
                         mesh=mesh,
                         scaling_config=ScalingConfig(num_workers=workers))
    # each tp lane its own dp group; at tp 1 the name is the JAX one's
    from ray_tpu.train.pipeline.partition import factor_gang as jfactor

    from ray_tpu_torch.train.pipeline import factor_gang

    names = [factor_gang(r, 8, dp=2, n_stages=2).dp_group_name("j")
             for r in range(8)]
    assert names == ["train/j/stage0/t0/dp", "train/j/stage0/t1/dp",
                     "train/j/stage1/t0/dp", "train/j/stage1/t1/dp"] * 2
    for r in range(4):
        assert factor_gang(r, 4, dp=2, n_stages=2).dp_group_name("j") == \
            jfactor(r, 4, dp=2, n_stages=2).dp_group_name("j")
    # a stage over tp forms a process group: no two ranks on one card
    for stages, workers in ((1, 2), (2, 4)):
        with pytest.raises(ValueError, match="share of a card"):
            TorchTrainer(gpt2_pipeline_loop, pipeline_stages=stages,
                         mesh=(1, 2), scaling_config=ScalingConfig(
                             num_workers=workers, gpus_per_worker=0.5))


# ------------------------------------------------- (b) the gloo gang
def _gang_rank(rank, init_file, payload_file, results):
    """One gloo rank of a tp=2 stage gang: a one-stage StageExecutor over
    the gang's tp mesh, 3 steps from the payload's parameters and
    batches; puts (rank, record) on ``results``."""
    import pickle

    import torch.distributed as dist

    from ray_tpu_torch.train.pipeline import (
        GPT2StageModule,
        StageExecutor,
        pipeline_mesh,
    )
    from ray_tpu_torch.train.pipeline.partition import flatten_params

    torch.set_num_threads(1)
    with open(payload_file, "rb") as f:
        full, batches = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=TP)
    try:
        mesh = pipeline_mesh("cpu")
        module = GPT2StageModule(_cfg(), 0, 1, device="cpu")
        ex = StageExecutor(module, mesh, n_micro=M, lr=LR, total_steps=101,
                           params=full)
        rec = {"mesh": (mesh.mesh_dim_names, mesh.size()),
               "tp_rank": ex.tp_rank,
               # the dim each mesh dim shards, None where it replicates
               "placements": {n: [pl.dim if pl.is_shard() else None
                                  for pl in p.placements]
                              for n, p in module.named_parameters()},
               "local": {n: tuple(p.to_local().shape)
                         for n, p in module.named_parameters()}}
        outs = [ex.train_step(b) for b in batches]
        rec["steps"] = [(o["loss"], o["grad_norm"]) for o in outs]
        rec["tp_ranks"] = [o["tp_rank"] for o in outs]
        rec["params"] = flatten_params(ex.gathered_params())
        # a restore re-shards the tree; gathered, it is the tree
        ex.load_full_params(full)
        back = flatten_params(ex.gathered_params())
        want = flatten_params(full)
        rec["roundtrip"] = set(back) == set(want) and all(
            np.array_equal(back[k], want[k]) for k in want)
        results.put((rank, rec))
    finally:
        dist.destroy_process_group()


def _jax_tp_steps(full, batches):
    """JAX's StageExecutor over a (dp=1, tp=2) mesh of virtual CPU
    devices: (loss, grad norm) of each step."""
    import jax

    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu.train import pipeline as jp

    mesh = build_mesh(MeshConfig(dp=1, tp=TP), devices=jax.devices()[:TP])
    jmod = jp.GPT2StageModule(_jax_cfg(), 0, 1)
    ex = jp.StageExecutor(jmod, mesh, n_micro=M, lr=LR, total_steps=101,
                          params=jmod.select_params(full))
    outs = [ex.train_step(b) for b in batches]
    return np.array([(o["loss"], o["grad_norm"]) for o in outs])


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The two gloo ranks, spawned once (killed, and every case failed,
    after GANG_TIMEOUT_S); meanwhile this process takes JAX's tp=2 steps
    and the port's unsharded stage's.  The parameters go through a file:
    as spawn arguments they would fill the pipe."""
    import pickle

    from ray_tpu_torch.train.pipeline import GPT2StageModule, StageExecutor
    from ray_tpu_torch.train.pipeline.partition import flatten_params

    full, batches = _full_params(), _batches()
    tmp = tmp_path_factory.mktemp("tp_gang")
    init_file, payload_file = tmp / "rendezvous", tmp / "payload.pkl"
    with open(payload_file, "wb") as f:
        pickle.dump((full, batches), f)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_gang_rank,
                         args=(r, str(init_file), str(payload_file),
                               results), daemon=True)
             for r in range(TP)]
    for p in procs:
        p.start()
    deadline, got = time.monotonic() + GANG_TIMEOUT_S, {}
    try:
        one = StageExecutor(GPT2StageModule(_cfg(), 0, 1, device="cpu"),
                            n_micro=M, lr=LR, total_steps=101, params=full)
        outs = [one.train_step(b) for b in batches]
        got["one"] = np.array([(o["loss"], o["grad_norm"]) for o in outs])
        got["one_params"] = flatten_params(one.gathered_params())
        got["jax"] = _jax_tp_steps(full, batches)
        while len(got) < TP + 3 and time.monotonic() < deadline:
            try:
                rank, rec = results.get(timeout=2)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            got[rank] = rec
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if len(got) < TP + 3 or any(p.exitcode != 0 for p in procs):
        pytest.fail(f"the gloo gang gave results from ranks "
                    f"{sorted(r for r in got if isinstance(r, int))}, "
                    f"exit codes {[p.exitcode for p in procs]}")
    return got


def test_tp_stage_matches_jax_and_the_unsharded_stage(gang):
    recs = [gang[r] for r in range(TP)]
    # the loss and the norm are the stage's: every rank reports the same
    assert recs[0]["steps"] == recs[1]["steps"]
    got = np.array(recs[0]["steps"])
    assert len({tuple(s) for s in got}) == STEPS  # the steps moved
    np.testing.assert_allclose(got, gang["jax"], rtol=1e-4)
    np.testing.assert_allclose(got, gang["one"], rtol=1e-5)
    want = gang["one_params"]
    for rec in recs:
        assert set(rec["params"]) == set(want)
        for k in want:
            np.testing.assert_allclose(rec["params"][k], want[k], rtol=0,
                                       atol=1e-5, err_msg=k)


def test_tp_stage_holds_its_share_of_the_heads(gang):
    E, H = WIDTHS["n_embd"], WIDTHS["n_head"]
    recs = [gang[r] for r in range(TP)]
    assert sorted(rec["tp_rank"] for rec in recs) == list(range(TP))
    for rec in recs:
        assert rec["mesh"] == (("tp",), TP)
        assert rec["tp_ranks"] == [rec["tp_rank"]] * STEPS
        pl, local = rec["placements"], rec["local"]
        # column-parallel qkv and fc_in, row-parallel out_proj and fc_out:
        # each rank computes H / tp heads
        assert pl["h.0.attn.qkv_proj.weight"] == [0]
        assert local["h.0.attn.qkv_proj.weight"] == (3 * E // TP, E)
        assert pl["h.1.attn.out_proj.weight"] == [1]
        assert local["h.1.attn.out_proj.weight"] == (E, E // TP)
        assert local["h.0.mlp.fc_in.weight"] == (4 * E // TP, E)
        assert local["lm_head.weight"] == (WIDTHS["vocab_size"] // TP, E)
        assert pl["h.0.ln_1.weight"] == [None]
        assert (3 * E // TP) // (3 * E // H) == H // TP
        assert rec["roundtrip"]


# ------------------------------------------------- (c) through the trainer
@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=256 * 1024 ** 2)
    yield
    ray_tpu_torch.shutdown()


def _one_thread_loop(config):
    """``gpt2_pipeline_loop`` on one torch thread: the fits' four gloo ranks
    share this machine's cores (workers import this module by name)."""
    from ray_tpu_torch.train.pipeline import gpt2_pipeline_loop

    torch.set_num_threads(1)
    gpt2_pipeline_loop(config)


def _loop_cfg(job):
    return {"steps": STEPS, "batch_size": 8, "seq_len": 16, "lr": LR,
            "seed": 0, "timeout_s": 60.0, "job": job, "device": "cpu",
            "model": dict(WIDTHS, dtype="float32")}


def test_trainer_stages_over_tp_match_and_restore_onto_one(
        runtime, tmp_path):
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.pipeline import (
        GPT2StageModule,
        StageExecutor,
        load_pipeline_checkpoint,
    )
    from ray_tpu_torch.train.pipeline.partition import flatten_params

    job = f"pipe-tp-{uuid.uuid4().hex[:8]}"

    def fit(n_stages, tp, name):
        return TorchTrainer(
            _one_thread_loop, train_loop_config=_loop_cfg(f"{job}-{name}"),
            scaling_config=ScalingConfig(num_workers=n_stages * tp,
                                         use_gpu=False),
            run_config=RunConfig(name=name, storage_path=str(tmp_path)),
            pipeline_stages=n_stages, num_microbatches=M,
            mesh=(1, tp)).fit()

    result_tp = fit(2, TP, "pp2-tp2")
    hist = result_tp.metrics_history
    assert [m["step"] for m in hist] == list(range(STEPS))
    assert all(m["stage"] == 0 and m["tp_rank"] == 0 for m in hist)
    result1 = fit(2, 1, "pp2-tp1")
    losses1 = [m["loss"] for m in result1.metrics_history]
    assert [m["loss"] for m in hist] == pytest.approx(losses1, rel=1e-5)

    # two replicas of a one-stage tp gang, each lane syncing its shards
    # over a dp group of its own, on half the batch each
    dp_tp = TorchTrainer(
        _one_thread_loop, train_loop_config=_loop_cfg(f"{job}-dp2-tp2"),
        scaling_config=ScalingConfig(num_workers=4, use_gpu=False),
        run_config=RunConfig(name="dp2-tp2", storage_path=str(tmp_path)),
        num_microbatches=M, mesh=(2, TP)).fit()
    assert [m["loss"] for m in dp_tp.metrics_history] == pytest.approx(
        losses1, abs=1e-4)
    assert all(m["dp_wire_bytes"] > 0 for m in dp_tp.metrics_history)

    # the restore onto one stage on one card, as the loop restores: the
    # merged shards loaded into a one-stage executor gather back bit for
    # bit, and hold the seeded tree's every key
    one = StageExecutor(GPT2StageModule(_cfg(), 0, 1, device="cpu"),
                        n_micro=M, params=_full_params())
    with result_tp.checkpoint.as_directory() as d:
        full_tp, step_tp = load_pipeline_checkpoint(d)
    assert step_tp == STEPS - 1
    one.load_full_params(full_tp)
    f_tp, f_one = flatten_params(full_tp), flatten_params(one.params)
    assert set(f_tp) == set(f_one) == set(flatten_params(_full_params()))
    for k in f_tp:
        np.testing.assert_array_equal(f_one[k], f_tp[k])
