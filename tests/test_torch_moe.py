"""ray_tpu_torch's MoE slice against ray_tpu's on the CPU.

The routing, the MoE block, GPT-2 with MoE blocks (logits, loss with the
aux terms, gradients, under each remat policy), the trainer, the sharded
checkpoints in one process, and the MNIST MLP go through the JAX package
and the port on the same numpy inputs and flax parameters (the port's
flash attention on its plain versions: the tensors lie on the CPU).  The
gloo gang of ``tests/test_torch_parallel.py`` trains the MoE model over
ep and checkpoints across processes.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from ray_tpu.models import moe as jmoe
from ray_tpu.models import pretrain as jpre
from ray_tpu.models.gpt2 import GPT2Config as JConfig
from ray_tpu.models.mlp import MLP as JMLP
from ray_tpu.models.mlp import classification_loss as j_classification_loss
from ray_tpu.parallel.mesh import MeshConfig
from ray_tpu_torch.models import (
    GPT2Config,
    GPT2LMModel,
    ShardedPretrainer,
    init_params,
    loss_fn,
    params_from_flax,
)
from ray_tpu_torch.models.mlp import MLP, classification_loss
from ray_tpu_torch.models.moe import (
    MoEConfig,
    MoEMlpBlock,
    collect_moe_aux_loss,
    compute_routing,
)

TINY_MOE = dict(vocab_size=512, n_positions=128, n_embd=64, n_layer=2,
                n_head=4, moe_every=2, n_experts=4, moe_top_k=2)


def _batch(b=4, s=64, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, vocab, (b, s)),
            "targets": rng.integers(0, vocab, (b, s))}


# ------------------------------------------------------------ routing
@pytest.mark.parametrize("shape", [(2, 16, 4), (3, 32, 4)])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("tight", [False, True])
def test_compute_routing_matches_jax(shape, top_k, tight):
    """The shapes of tests/test_parallel_extras.py's routing tests, ample
    capacity (nothing dropped) and tight (tokens dropped): the same
    logits give the same dispatch exactly, combine and aux within 1e-6."""
    G, S, E = shape
    rng = np.random.default_rng(G * S + top_k)
    logits = rng.normal(size=shape).astype(np.float32)
    capacity = max(S * top_k // (2 * E), 1) if tight else S * top_k
    jd, jc, ja = jmoe.compute_routing(jnp.asarray(logits), E, top_k,
                                      capacity)
    d, c, a = compute_routing(torch.from_numpy(logits), E, top_k, capacity)
    assert d.shape == c.shape == (G, S, E, capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(a.item(), float(ja), rtol=0, atol=1e-6)
    # no (expert, slot) pair holds two tokens
    assert float(d.sum(1).max()) == 1.0
    routed = float(d.sum())
    if tight:
        assert routed < G * S * top_k  # some tokens were dropped
    else:  # each token went to exactly k experts
        assert (d.sum((2, 3)) == top_k).all()
        assert routed == G * S * top_k


def test_routing_ties_take_the_first_expert():
    """Equal logits: argmax's first index, in both packages."""
    logits = np.zeros((1, 4, 4), np.float32)
    jd, _, _ = jmoe.compute_routing(jnp.asarray(logits), 4, 2, 8)
    d, c, _ = compute_routing(torch.from_numpy(logits), 4, 2, 8)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert (d.sum((1, 3))[0] == torch.tensor([4.0, 4.0, 0.0, 0.0])).all()
    # the gate is each choice's probability, not renormalised over k
    np.testing.assert_allclose(c.sum((2, 3)).numpy(), 0.5)


# -------------------------------------------------------------- block
def _jax_block(cfg, x, g):
    """The JAX block's output, aux term and the gradients of
    sum(out * g) + term by its params and x."""
    jcfg = jmoe.MoEConfig(**{**cfg, "dtype": jnp.float32})
    layer = jmoe.MoEMlpBlock(jcfg)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def loss(p, xx):
        out, st = layer.apply({"params": p}, xx, mutable=["intermediates"])
        term = jmoe.collect_moe_aux_loss(st["intermediates"])
        return jnp.sum(out * g) + term, (out, term)

    (_, (out, term)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return np.asarray(out), float(term), tree, grads


def _close_rel(got, want, rel, name):
    """Within ``rel`` of the largest element of ``want``."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=name)


@pytest.mark.parametrize("top_k,capacity_factor", [(1, 1.0), (2, 1.25)])
def test_moe_block_matches_jax(top_k, capacity_factor):
    cfg = dict(n_experts=4, top_k=top_k, capacity_factor=capacity_factor,
               d_model=32, d_ff=64)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 32)).astype(np.float32)
    g = rng.normal(size=(2, 8, 32)).astype(np.float32)
    want, want_term, params, (jgp, jgx) = _jax_block(cfg, x, g)

    block = MoEMlpBlock(MoEConfig(**cfg, dtype=torch.float32))
    block.load_state_dict(params_from_flax({"params": params}))
    xt = torch.from_numpy(x).requires_grad_()
    out, term = block(xt)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(term.item(), want_term, rtol=0, atol=1e-6)
    ((out * torch.from_numpy(g)).sum() + term).backward()
    jgrads = params_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, jgp)})
    _close_rel(xt.grad.numpy(), np.asarray(jgx), 1e-4, "x")
    for name, p in block.named_parameters():
        _close_rel(p.grad.numpy(), jgrads[name].numpy(), 1e-4, name)
    assert set(jgrads) == {"router.weight", "w_in", "w_out"}


def test_moe_partition_rules_match_jax():
    """The MoE rules, as gpt_partition_rules also holds them: the experts'
    leading dim over ep, then fsdp and tp, on the flax layout."""
    from ray_tpu.parallel.sharding import gpt_partition_rules as jgpt_rules
    from ray_tpu_torch.models.moe import moe_partition_rules
    from ray_tpu_torch.parallel.sharding import gpt_partition_rules

    for path, shape in (("h_1/moe_mlp/router/kernel", (64, 4)),
                        ("h_1/moe_mlp/w_in", (4, 64, 256)),
                        ("h_1/moe_mlp/w_out", (4, 256, 64))):
        want = tuple(jmoe.moe_partition_rules().spec_for(path, shape))
        assert tuple(moe_partition_rules().spec_for(path, shape)) == want
        assert tuple(gpt_partition_rules().spec_for(path, shape)) == want
        assert tuple(jgpt_rules().spec_for(path, shape)) == want


def test_collect_moe_aux_loss():
    assert collect_moe_aux_loss([]) == 0
    terms = [torch.tensor(0.25), torch.tensor(1.5)]
    assert collect_moe_aux_loss(terms).item() == 1.75


# -------------------------------------------------------------- model
def _routing_choices_differ(jmodel, params, model, ids) -> int:
    """How many (token, round) expert choices of the MoE layers differ
    between the JAX model and the port on ``ids``: a near-tie of the
    router (the two frameworks round differently) moves a token to another
    expert, a fault moves many."""
    _, state = jmodel.apply({"params": params}, jnp.asarray(ids),
                            capture_intermediates=lambda m, _: (
                                m.name == "router"))
    inter = state["intermediates"]
    jlogits = [np.asarray(inter[f"h_{i}"]["moe_mlp"]["router"]["__call__"][0])
               for i in range(jmodel.config.n_layer)
               if "moe_mlp" in inter.get(f"h_{i}", {})]
    got = []
    hooks = [m.register_forward_pre_hook(
        lambda m, args: got.append(F.linear(
            args[0].float(), m.router.weight).detach().numpy()))
        for m in model.modules() if isinstance(m, MoEMlpBlock)]
    with torch.no_grad():
        model(torch.from_numpy(ids))
    for h in hooks:
        h.remove()
    k = model.config.moe_top_k
    return sum(int((np.argsort(-a, -1, kind="stable")[..., :k]
                    != np.argsort(-b, -1, kind="stable")[..., :k]).sum())
               for a, b in zip(got, jlogits))


def _jax_moe(remat=False, policy="full"):
    cfg = JConfig(**TINY_MOE, dtype=jnp.float32, remat=remat,
                  remat_policy=policy)
    model, params = jpre.init_params(cfg, jax.random.PRNGKey(1))
    return model, jax.tree_util.tree_map(np.asarray, params)


def test_flax_names_map_the_moe_leaves_both_ways():
    """The router's kernel is transposed like every Dense kernel; the
    expert weights keep the flax layout, and flax_paths names them back."""
    from ray_tpu_torch.models import flax_paths

    _, params = _jax_moe()
    state = params_from_flax(params)
    moe = params["h_1"]["moe_mlp"]
    np.testing.assert_array_equal(state["h.1.moe_mlp.router.weight"].numpy(),
                                  moe["router"]["kernel"].T)
    for w in ("w_in", "w_out"):
        np.testing.assert_array_equal(state[f"h.1.moe_mlp.{w}"].numpy(),
                                      moe[w])
    model = GPT2LMModel(GPT2Config(**TINY_MOE), device="cpu")
    assert set(state) == set(model.state_dict())
    paths = flax_paths(model)
    assert paths["h.1.moe_mlp.router.weight"] == "h_1/moe_mlp/router/kernel"
    assert paths["h.1.moe_mlp.w_in"] == "h_1/moe_mlp/w_in"
    assert "h.1.mlp.fc_in.weight" not in paths  # the MoE block has no MLP


def test_moe_gpt2_logits_match_jax():
    jmodel, params = _jax_moe()
    ids = _batch(b=2, s=40, seed=2)["input_ids"]
    want = np.asarray(jax.jit(lambda p, i: jmodel.apply({"params": p}, i))(
        params, jnp.asarray(ids)))
    model = GPT2LMModel(GPT2Config(**TINY_MOE, dtype=torch.float32,
                                   remat=False), device="cpu")
    model.load_state_dict(params_from_flax(params))
    assert [hasattr(b, "moe_mlp") for b in model.h] == [False, True]
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    try:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    except AssertionError as err:
        raise AssertionError(f"{err}\nrouting choices that differ: "
                             f"{_routing_choices_differ(jmodel, params, model, ids)}")


@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "dots")])
def test_moe_gpt2_loss_and_grads_match_jax(remat, policy):
    """loss_fn with every MoE layer's aux term, and its gradients, against
    JAX's loss_fn, with each remat policy on both sides."""
    jmodel, params = _jax_moe(remat, policy)
    batch = _batch(b=2, s=48, seed=5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jpre.loss_fn(jmodel, p, jbatch)))(params)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    # the aux terms are in the loss: without them it is lower
    logits = jax.jit(lambda p: jmodel.apply({"params": p},
                                            jbatch["input_ids"]))(params)
    plain = float(jpre.lm_loss(logits, jbatch["targets"]))
    assert float(jloss) - plain > 1e-3

    cfg = GPT2Config(**TINY_MOE, dtype=torch.float32, remat=remat,
                     remat_policy=policy)
    model, tparams = init_params(cfg, device="cpu")
    model.load_state_dict(params_from_flax(params))
    loss = loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    assert set(want) == set(tparams)
    try:
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
        for name, p in tparams.items():
            _close_rel(p.grad.numpy(), want[name].numpy(), 1e-4, name)
    except AssertionError as err:
        ids = batch["input_ids"]
        raise AssertionError(f"{err}\nrouting choices that differ: "
                             f"{_routing_choices_differ(jmodel, params, model, ids)}")


def test_moe_trainer_losses_match_the_jax_trainer():
    cfg = JConfig(**TINY_MOE, dtype=jnp.float32, remat=False)
    jtrainer = jpre.ShardedPretrainer(cfg, MeshConfig(dp=-1),
                                      devices=jax.devices()[:1], lr=0.1,
                                      total_steps=10)
    init = jax.tree_util.tree_map(np.array, jtrainer.state[0])
    trainer = ShardedPretrainer(
        GPT2Config(**TINY_MOE, dtype=torch.float32, remat=False),
        MeshConfig(dp=-1), lr=0.1, device="cpu", total_steps=10,
        params=init)
    batches = [_batch(b=4, s=64, seed=10 + i) for i in range(5)]
    want = [float(jtrainer.step(b)) for b in batches]
    got = [trainer.step(b).item() for b in batches]
    assert len(set(want)) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert trainer.opt.count == 5


# --------------------------------------------------------- checkpoints
@pytest.mark.parametrize("moe", [False, True])
def test_checkpoint_restores_the_uninterrupted_run(moe, tmp_path):
    """The port of tests/test_parallel_extras.py's checkpoint test in one
    process (plain tensors): save after 2 steps, restore into a fresh
    trainer, and the next 2 losses are the uninterrupted run's, bit for
    bit; a restore of the state saved before any step is the fresh state."""
    over = TINY_MOE if moe else {k: v for k, v in TINY_MOE.items()
                                 if k not in ("moe_every", "n_experts",
                                              "moe_top_k")}
    cfg = GPT2Config(**over, dtype=torch.float32, remat=False)
    batches = [_batch(b=4, s=32, seed=30 + i) for i in range(4)]
    t1 = ShardedPretrainer(cfg, lr=0.1, device="cpu", total_steps=10)
    t1.save_checkpoint(str(tmp_path / "fresh"))
    for b in batches[:2]:
        t1.step(b)
    t1.save_checkpoint(str(tmp_path / "ck"))
    expect = [t1.step(b).item() for b in batches[2:]]

    t2 = ShardedPretrainer(cfg, lr=0.1, device="cpu", total_steps=10)
    t2.restore_checkpoint(str(tmp_path / "ck"))
    assert t2.opt.count == 2
    got = [t2.step(b).item() for b in batches[2:]]
    assert got == expect
    for (name, p), q in zip(t1.model.named_parameters(),
                            t2.model.parameters()):
        assert torch.equal(p, q), name

    t4 = ShardedPretrainer(cfg, lr=0.1, device="cpu", total_steps=10)
    t4.step(batches[0])
    t4.restore_checkpoint(str(tmp_path / "fresh"))
    t5 = ShardedPretrainer(cfg, lr=0.1, device="cpu", total_steps=10)
    assert t4.opt.count == 0
    assert [t4.step(b).item() for b in batches] == [
        t5.step(b).item() for b in batches]


# ---------------------------------------------------------------- MLP
def test_mlp_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 28, 28)).astype(np.float32)
    labels = rng.integers(0, 10, 8)
    jmodel = JMLP()
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    want_loss = float(j_classification_loss(jnp.asarray(want),
                                            jnp.asarray(labels)))
    model = MLP(device="cpu")
    assert tuple(model.features) == (512, 256, 10)
    state = params_from_flax(jax.tree_util.tree_map(np.asarray, variables))
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    loss = classification_loss(got, torch.from_numpy(labels))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-5, atol=1e-5)
