"""ray_tpu_torch.parallel against ray_tpu.parallel on the CPU.

First in this process, with no process group: ``MeshConfig.resolve`` and
its errors, ``mesh_layout`` against the device ids of JAX's ``build_mesh``
(plain, ``dcn_dp`` and ``dcn_pp``), and every parameter's spec against
JAX's ``match_partition_rules`` on the flax tree, flipped for torch's
(out, in) layout.  Then one gang of four gloo ranks on the CPU, spawned
once for the module, trains tiny GPT-2 and tiny Llama under each mesh; each
mesh is its own test: three steps' losses and gradient norms in f32 within
1e-5 relative of the one-process trainer and within 1e-4 of the JAX
trainer, from the same flax initialisation.  A mesh with a sequence split
(sp) trains through ring attention, held against the JAX trainer under the
same mesh (its ring, on JAX's virtual CPU devices).  GPT-2 with MoE
blocks trains with its experts sharded over ep (beside dp, tp and sp), and
sharded checkpoints restore a run's next losses: under the mesh that saved
them, bit for bit, and under another mesh, within 1e-6.
"""

import multiprocessing
import queue
import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu.models import pretrain as jpre
from ray_tpu.models.gpt2 import GPT2Config as JGPT2Config
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import (
    GPT2Config,
    GPT2LMModel,
    LlamaConfig,
    LlamaLMModel,
    ShardedPretrainer,
    flax_paths,
)
from ray_tpu_torch.parallel import MeshConfig, match_partition_rules
from ray_tpu_torch.parallel.mesh import mesh_layout
from ray_tpu_torch.parallel.sharding import (
    gpt_partition_rules,
    llama_partition_rules,
    placements,
)

GPT_TINY = dict(vocab_size=512, n_positions=128, n_embd=64, n_layer=2,
                n_head=4)
LLAMA_TINY = dict(vocab_size=512, n_positions=128, d_model=64, n_layer=2,
                  n_head=4, n_kv_head=2, d_ff=128)
WORLD = 4
STEPS = 3
GANG_TIMEOUT_S = 240
# each mesh covers the gang's four ranks; dp absorbs what the others leave
GANG_CASES = {
    "gpt-dp4": ("gpt", dict(dp=-1)),
    "gpt-dp2-tp2": ("gpt", dict(dp=-1, tp=2)),
    "gpt-dp2-fsdp2": ("gpt", dict(dp=-1, fsdp=2)),
    "gpt-tp2-fsdp2": ("gpt", dict(dp=1, tp=2, fsdp=2)),
    "gpt-tp4": ("gpt", dict(dp=1, tp=4)),
    "llama-tp2-fsdp2": ("llama", dict(dp=1, tp=2, fsdp=2)),
    "gpt-dp2-sp2": ("gpt", dict(dp=-1, sp=2)),
    "gpt-sp4": ("gpt", dict(dp=1, sp=4)),
    "llama-tp2-sp2": ("llama", dict(dp=1, tp=2, sp=2)),
    "gpt-moe-dp2-ep2": ("gpt-moe", dict(dp=-1, ep=2)),
    "gpt-moe-ep2-tp2": ("gpt-moe", dict(dp=1, ep=2, tp=2)),
    "gpt-moe-sp2-ep2": ("gpt-moe", dict(dp=1, sp=2, ep=2)),
    "gpt-moe-fsdp2-ep2": ("gpt-moe", dict(dp=1, fsdp=2, ep=2)),
}
# (family, the mesh that saves after two steps, the meshes that restore
# into a fresh trainer and take the next two steps)
CHECKPOINT_CASES = {
    "gpt-dp2-tp2": ("gpt", dict(dp=-1, tp=2),
                    (dict(dp=-1, tp=2), dict(dp=-1))),
    "gpt-moe-dp2-ep2": ("gpt-moe", dict(dp=-1, ep=2),
                        (dict(dp=-1, ep=2),)),
}
MOE = dict(moe_every=2, n_experts=4, moe_top_k=2)
# the cases whose JAX reference is the JAX trainer under the same mesh
SP_CASES = [c for c, (_, kw) in GANG_CASES.items() if kw.get("sp", 1) > 1]


def _configs(family):
    """(JAX config, port config) of a family: f32, flash attention; Llama
    keeps its default remat "full", GPT-2 runs without remat (phase 6's
    setting)."""
    if family in ("gpt", "gpt-moe"):
        over = MOE if family == "gpt-moe" else {}
        return (JGPT2Config(**GPT_TINY, **over, dtype=jnp.float32,
                            remat=False),
                GPT2Config(**GPT_TINY, **over, dtype=torch.float32,
                           remat=False))
    return (jllama.LlamaConfig(**LLAMA_TINY, dtype=jnp.float32),
            LlamaConfig(**LLAMA_TINY, dtype=torch.float32))


def _batches():
    rng = np.random.default_rng(20)
    return [{k: rng.integers(0, 512, (4, 64))
             for k in ("input_ids", "targets")} for _ in range(STEPS)]


# ------------------------------------------------------------- meshes
@pytest.mark.parametrize("n,kw", [
    (8, dict()), (8, dict(dp=2, tp=2, fsdp=2)), (8, dict(dp=-1, tp=4)),
    (8, dict(dp=2, tp=2, dcn_dp=2)), (8, dict(dp=2, dcn_pp=2, tp=2)),
    (8, dict(fsdp=-1, dp=2)), (1, dict()), (6, dict(dp=-1, tp=4)),
    (8, dict(dp=-1, tp=-1)), (4, dict(dp=2)), (6, dict(dcn_dp=4)),
    (16, dict(dp=2, fsdp=2, tp=2, sp=2)),
])
def test_mesh_config_resolve_matches_jax(n, kw):
    try:
        want = jmesh.MeshConfig(**kw).resolve(n)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            MeshConfig(**kw).resolve(n)
        assert str(got.value) == str(err)
    else:
        assert MeshConfig(**kw).resolve(n) == want
    assert jmesh.AXES == __import__(
        "ray_tpu_torch.parallel.mesh", fromlist=["AXES"]).AXES


@pytest.mark.parametrize("kw", [
    dict(dp=2, tp=2, fsdp=2), dict(dp=-1, tp=2), dict(dp=2, tp=2, dcn_dp=2),
    dict(dp=2, pp=1, dcn_pp=2, tp=2), dict(dp=1, dcn_dp=2, dcn_pp=2, tp=2),
])
def test_mesh_layout_matches_jax_build_mesh(kw):
    """``mesh_layout`` lays the ranks out as JAX's ``build_mesh`` lays out
    the virtual devices: DCN-major merges of dcn_dp/dcn_pp included, and a
    host (``LOCAL_WORLD_SIZE``) standing for a slice."""
    devices = jax.devices()[:8]
    want = np.vectorize(lambda d: d.id)(
        jmesh.build_mesh(jmesh.MeshConfig(**kw), devices=devices).devices)
    np.testing.assert_array_equal(mesh_layout(MeshConfig(**kw), 8), want)
    # hosts of 8 // n_slices ranks give the same slices on this layout
    slices = MeshConfig(**kw).n_slices
    np.testing.assert_array_equal(
        mesh_layout(MeshConfig(**kw), 8, local_world_size=8 // slices), want)
    # the JAX MeshConfig is read through its fields
    np.testing.assert_array_equal(mesh_layout(jmesh.MeshConfig(**kw), 8),
                                  want)


def _jax_specs(model_cls, config, rules):
    params = model_cls(config).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    flat, _ = jsharding._flatten_with_paths(
        jsharding.match_partition_rules(rules, params))
    return dict(jsharding._flatten_with_paths(params)[0]), dict(flat)


@pytest.mark.parametrize("family", ["gpt", "llama", "gpt-moe"])
def test_partition_specs_match_jax_flipped(family):
    if family != "llama":
        over = MOE if family == "gpt-moe" else {}
        jparams, jspecs = _jax_specs(
            __import__("ray_tpu.models.gpt2", fromlist=["x"]).GPT2LMModel,
            JGPT2Config(**GPT_TINY, **over, attention_impl="reference"),
            jsharding.gpt_partition_rules())
        model = GPT2LMModel(GPT2Config(**GPT_TINY, **over), device="cpu")
        specs = match_partition_rules(gpt_partition_rules(), model)
    else:
        jparams, jspecs = _jax_specs(
            jllama.LlamaLMModel,
            jllama.LlamaConfig(**LLAMA_TINY, attention_impl="reference"),
            jsharding.llama_partition_rules())
        model = LlamaLMModel(LlamaConfig(**LLAMA_TINY), device="cpu")
        specs = match_partition_rules(llama_partition_rules(), model)
    paths = flax_paths(model)
    assert sorted(paths.values()) == sorted(jspecs)
    for name, p in model.named_parameters():
        path = paths[name]
        want = tuple(jspecs[path])
        if path.endswith("/kernel"):
            # (in, out) there, (out, in) here
            assert tuple(jparams[path].shape) == tuple(p.shape[::-1]), name
            want = (want + (None,) * (2 - len(want)))[::-1] if want else ()
        else:
            assert tuple(jparams[path].shape) == tuple(p.shape), name
        assert specs[name] == want, (name, specs[name], want)
    # the rules' Megatron layout, read off the torch weights
    assert specs["wte.weight"] == ("tp", "fsdp")
    assert specs["lm_head.weight"] == ("tp", "fsdp")
    if family == "gpt-moe":  # the experts keep the flax layout: no flip
        assert specs["h.1.moe_mlp.w_in"] == ("ep", "fsdp", "tp")
        assert specs["h.1.moe_mlp.w_out"] == ("ep", "tp", "fsdp")
        assert specs["h.1.moe_mlp.router.weight"] == ()
        assert paths["h.1.moe_mlp.router.weight"] == \
            "h_1/moe_mlp/router/kernel"
    if family != "llama":
        assert specs["h.0.attn.qkv_proj.weight"] == ("tp", "fsdp")
        assert specs["h.0.attn.out_proj.weight"] == ("fsdp", "tp")
        assert specs["wpe.weight"] == (None, "fsdp")
        assert specs["h.1.ln_1.weight"] == () == specs["h.0.mlp.fc_in.bias"]
    else:
        assert specs["h.0.attn.wk.weight"] == ("tp", "fsdp")
        assert specs["h.1.mlp.down_proj.weight"] == ("fsdp", "tp")
        assert specs["norm_f.weight"] == ()


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("dp", "fsdp", "tp"))
    assert placements((("dp", "fsdp"), "tp"), mesh) == [
        Shard(0), Shard(0), Shard(1)]
    assert placements(("tp", "fsdp"), mesh) == [Replicate(), Shard(1),
                                                Shard(0)]
    # axes of one rank are not in the mesh: they shard nothing
    assert placements((None, ("sp", "tp")), mesh) == [
        Replicate(), Replicate(), Shard(1)]
    assert placements((), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        placements((("fsdp", "dp"),), mesh)
    with pytest.raises(ValueError, match="twice"):
        placements(("tp", "tp"), mesh)


# --------------------------------------------------------------- gang
def _gang_rank(rank, init_file, payload_file, ckpt_dir, results):
    """One gloo rank: every case of GANG_CASES in turn, each from the same
    flax parameters (``payload_file`` holds them and the batches), then
    every case of CHECKPOINT_CASES (under ``ckpt_dir``); puts (rank,
    {case: record}) on ``results``."""
    import pickle

    import torch.distributed as dist

    from ray_tpu_torch.models import params_from_flax

    torch.set_num_threads(1)
    with open(payload_file, "rb") as f:
        params, batches = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD)
    try:
        out = {}
        for case, (family, mesh_kw) in GANG_CASES.items():
            trainer = ShardedPretrainer(
                _configs(family)[1], MeshConfig(**mesh_kw), lr=0.1,
                device="cpu", total_steps=10, params=params[family])
            host = params_from_flax(params[family])
            names = trainer._dmesh.mesh_dim_names
            # each rank's shards put together give the host value
            whole = all(torch.equal(p.full_tensor(), host[name])
                        for name, p in trainer.model.named_parameters())

            def sharded(axis):
                m = names.index(axis) if axis in names else None
                return [name for name, p in trainer.model.named_parameters()
                        if m is not None and p.placements[m].is_shard()
                        and p.to_local().numel() < p.numel()]
            ids = trainer.shard_batch(batches[0])["input_ids"].to_local()
            steps = []
            for b in batches:
                loss = trainer.step(b).item()
                steps.append((loss, trainer.opt.last_grad_norm.item()))
            out[case] = {"steps": steps, "whole": whole,
                         "tp_sharded": sharded("tp"),
                         "ep_sharded": sharded("ep"),
                         "attention_impl": trainer.config.attention_impl,
                         "local_rows": ids.shape[0],
                         "local_positions": ids.shape[1],
                         "mesh": dict(zip(trainer.mesh.mesh_dim_names,
                                          trainer.mesh.mesh.shape))}
        out["primitives"] = _primitives()
        for case, (family, save_kw, restore_kws) in CHECKPOINT_CASES.items():
            out["checkpoint " + case] = _checkpoint_case(
                _configs(family)[1], params[family], batches, save_kw,
                restore_kws, f"{ckpt_dir}/{case}")
        results.put((rank, out))
    finally:
        dist.destroy_process_group()


def _checkpoint_case(cfg, params, batches, save_kw, restore_kws, path):
    """Two steps under ``save_kw``, a checkpoint, two more steps; then a
    fresh trainer under each of ``restore_kws`` restores the checkpoint
    and takes the same two steps.  (the uninterrupted losses, [the
    restored losses under each mesh])."""
    after = [batches[2], batches[0]]
    trainer = ShardedPretrainer(cfg, MeshConfig(**save_kw), lr=0.1,
                                device="cpu", total_steps=10, params=params)
    for b in batches[:2]:
        trainer.step(b)
    trainer.save_checkpoint(path)
    want = [trainer.step(b).item() for b in after]
    got = []
    for kw in restore_kws:
        fresh = ShardedPretrainer(cfg, MeshConfig(**kw), lr=0.1,
                                  device="cpu", total_steps=10,
                                  params=params)
        fresh.restore_checkpoint(path)
        got.append([fresh.step(b).item() for b in after])
    return want, got


def _primitives():
    """``local_mesh``, ``shard_pytree`` and ``with_sharding_constraint`` on
    this rank of the gang, as a record for the test."""
    from ray_tpu_torch.parallel import (
        build_mesh,
        local_mesh,
        shard_pytree,
        with_sharding_constraint,
    )
    from ray_tpu_torch.parallel.mesh import active_mesh

    host = local_mesh("dp", device="cpu")
    mesh = active_mesh(build_mesh(MeshConfig(dp=2, tp=2), device="cpu"))
    x = torch.arange(48.0).reshape(8, 6)
    # rows over tp, columns over dp
    w = shard_pytree({"w": x}, {"w": ("tp", "dp")}, mesh)["w"]
    dp, tp = mesh.get_coordinate()
    whole = with_sharding_constraint(w, ())
    rows = with_sharding_constraint(w, (("dp", "tp"),))
    return {"local_mesh": (host.mesh_dim_names, host.size()),
            "mesh": mesh.mesh_dim_names,
            "shard": torch.equal(w.to_local(),
                                 x.chunk(2, 0)[tp].chunk(2, 1)[dp]),
            "whole": torch.equal(whole.to_local(), x),
            "rows": torch.equal(rows.to_local(), x.chunk(4, 0)[2 * dp + tp]),
            "placements": [str(p) for p in rows.placements]}


def _jax_trainer(family, mesh_kw=None, world=1):
    return jpre.ShardedPretrainer(_configs(family)[0],
                                  jmesh.MeshConfig(**(mesh_kw or {})),
                                  devices=jax.devices()[:world], lr=0.1,
                                  total_steps=10)


def _jax_steps(jtrainer):
    """(loss, gradient norm) of each step of the JAX trainer over
    ``_batches()``, the norm of the gradient each step applies."""
    grad_norm = jax.jit(lambda p, b, m=jtrainer.model: optax.global_norm(
        jax.grad(lambda q: jpre.loss_fn(m, q, b))(p)))
    out = []
    for b in _batches():
        with jtrainer.mesh:
            norm = float(grad_norm(jtrainer.state[0],
                                   jtrainer.shard_batch(b)))
        out.append((float(jtrainer.step(b)), norm))
    return np.array(out)


@pytest.fixture(scope="module")
def references():
    """Per family: the flax initialisation, and (loss, gradient norm) of
    each step of the JAX trainer and of the port's one-process trainer
    from it."""
    out = {}
    for family in ("gpt", "llama", "gpt-moe"):
        jtrainer = _jax_trainer(family)
        init = jax.tree_util.tree_map(np.array, jtrainer.state[0])
        want = _jax_steps(jtrainer)
        trainer = ShardedPretrainer(_configs(family)[1], lr=0.1,
                                    device="cpu", total_steps=10,
                                    params=init)
        one = [(trainer.step(b).item(), trainer.opt.last_grad_norm.item())
               for b in _batches()]
        out[family] = (init, np.array(one), np.array(want))
    return out


@pytest.fixture(scope="module")
def gang(references, tmp_path_factory):
    """Four gloo ranks, spawned once, run every case; the gang is killed,
    and every case fails, after GANG_TIMEOUT_S.  The parameters go through
    a file: as a spawn argument they would fill the pipe, and each start
    would wait for its child to import this module.  While the ranks run,
    the JAX trainer takes the sp cases under their meshes (its ring needs
    the mesh; its initialisation is the one-device trainer's): under
    ``"jax"``, (loss, gradient norm) of each step by case."""
    import pickle
    import time

    params = {family: ref[0] for family, ref in references.items()}
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tmp_path_factory.mktemp("gang")
    init_file, payload_file = tmp / "rendezvous", tmp / "payload.pkl"
    with open(payload_file, "wb") as f:
        pickle.dump((params, _batches()), f)
    procs = [ctx.Process(target=_gang_rank,
                         args=(r, str(init_file), str(payload_file),
                               str(tmp / "checkpoints"), results),
                         daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline, got = time.monotonic() + GANG_TIMEOUT_S, {}
    try:
        got["jax"] = {case: _jax_steps(_jax_trainer(*GANG_CASES[case],
                                                    WORLD))
                      for case in SP_CASES}
        while len(got) < WORLD + 1 and time.monotonic() < deadline:
            try:
                rank, out = results.get(timeout=2)
            except queue.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                continue
            got[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if len(got) < WORLD + 1 or any(p.exitcode != 0 for p in procs):
        pytest.fail(f"the gloo gang gave results from ranks "
                    f"{sorted(r for r in got if r != 'jax')}, "
                    f"exit codes {[p.exitcode for p in procs]}")
    return got


@pytest.mark.parametrize("case", list(GANG_CASES))
def test_gang_matches_one_process_and_jax(case, gang, references):
    family, mesh_kw = GANG_CASES[case]
    recs = [gang[r][case] for r in range(WORLD)]
    # the loss and the norm are global: every rank reports the same
    assert all(rec["steps"] == recs[0]["steps"] for rec in recs)
    got = np.array(recs[0]["steps"])
    _, one, want = references[family]
    if case in SP_CASES:  # the JAX trainer under the same mesh
        want = gang["jax"][case]
    np.testing.assert_allclose(got, one, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len({tuple(s) for s in got}) == STEPS  # the steps moved
    assert all(rec["whole"] for rec in recs)
    sizes = MeshConfig(**mesh_kw).resolve(WORLD)
    assert recs[0]["mesh"] == {a: sizes[a] for a in recs[0]["mesh"]}
    # the batch's rows over (dp, fsdp), its positions over sp, and the
    # trainer on ring attention where sp splits them
    assert all(rec["local_rows"] == 4 // (sizes["dp"] * sizes["fsdp"])
               and rec["local_positions"] == 64 // sizes["sp"]
               for rec in recs)
    assert all(rec["attention_impl"] == ("ring" if sizes["sp"] > 1
                                         else "flash") for rec in recs)
    if sizes["tp"] > 1:
        assert "lm_head.weight" in recs[0]["tp_sharded"]
        assert any(".attn." in n for n in recs[0]["tp_sharded"])
    else:
        assert recs[0]["tp_sharded"] == []
    # the experts, and only they, over ep
    experts = [f"h.1.moe_mlp.{w}" for w in ("w_in", "w_out")]
    assert recs[0]["ep_sharded"] == (experts if sizes["ep"] > 1 else [])


@pytest.mark.parametrize("case", list(CHECKPOINT_CASES))
def test_gang_checkpoint_restores_the_run(case, gang):
    """A fresh trainer that restores the checkpoint takes the next steps
    of the uninterrupted run: bit for bit under the mesh that saved it,
    within 1e-6 under another (dp=4 from dp=2 x tp=2: other sums)."""
    _, save_kw, restore_kws = CHECKPOINT_CASES[case]
    recs = [gang[r]["checkpoint " + case] for r in range(WORLD)]
    assert all(rec == recs[0] for rec in recs)
    want, got = recs[0]
    for kw, losses in zip(restore_kws, got):
        if kw == save_kw:
            assert losses == want, (kw, losses, want)
        else:
            np.testing.assert_allclose(losses, want, rtol=1e-6)


def test_gang_sharding_primitives(gang):
    """One rank's shard of a host value, a redistribute to whole and to
    rows over (dp, tp), and the host's one-axis mesh, on every rank."""
    for rank in range(WORLD):
        rec = gang[rank]["primitives"]
        assert rec["local_mesh"] == (("dp",), WORLD)
        assert rec["mesh"] == ("dp", "tp")
        assert rec["shard"] and rec["whole"] and rec["rows"], rec
        assert rec["placements"] == ["S(0)", "S(0)"]
