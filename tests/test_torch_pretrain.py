"""ray_tpu_torch's training slice against ray_tpu's on the CPU.

The loss, the schedule, the clip and AdamW, the model's gradients and the
trainer itself go through the JAX package (flash attention: its Pallas
forward in interpret mode and its XLA backward) and the port (the plain
versions of its kernels: the tensors lie on the CPU) on the same numpy
inputs and the same flax parameters.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import pretrain as jpre
from ray_tpu.models.gpt2 import GPT2Config as JConfig
from ray_tpu.models.gpt2 import lm_loss as j_lm_loss
from ray_tpu.parallel.mesh import MeshConfig
from ray_tpu_torch.models import (
    GPT2Config,
    GPT2LMModel,
    ShardedPretrainer,
    init_params,
    lm_loss,
    loss_fn,
    make_optimizer,
    params_from_flax,
    warmup_cosine_decay,
)

TINY = dict(vocab_size=512, n_positions=128, n_embd=64, n_layer=2, n_head=4)


def _batch(b=4, s=64, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, vocab, (b, s)),
            "targets": rng.integers(0, vocab, (b, s))}


def _jax_params(seed=0):
    cfg = JConfig(**TINY, dtype=jnp.float32, remat=False)
    model, params = jpre.init_params(cfg, jax.random.PRNGKey(seed))
    return model, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_jax(masked):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 10, 50)).astype(np.float32) * 3
    targets = rng.integers(0, 50, (3, 10))
    mask = (rng.random((3, 10)) > 0.4).astype(np.float32) if masked else None
    want = j_lm_loss(jnp.asarray(logits), jnp.asarray(targets),
                     None if mask is None else jnp.asarray(mask))
    got = lm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                  None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    if masked:  # an all-zero mask divides by max(sum, 1): loss 0
        zero = lm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                       torch.zeros(3, 10))
        assert zero.item() == 0.0


def test_schedule_matches_optax_at_every_step():
    lr, warmup, total = 0.5, 3, 8
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup,
                                               max(total, warmup + 1))
    for step in range(total + 4):
        np.testing.assert_allclose(warmup_cosine_decay(step, lr, warmup,
                                                       total),
                                   float(sched(step)), rtol=1e-6, atol=1e-8)
    # decay_steps counts the warmup steps: the schedule is 0 at total_steps
    assert warmup_cosine_decay(total, lr, warmup, total) == 0.0


def test_optimizer_and_clip_match_optax_chain():
    rng = np.random.default_rng(2)
    shapes = {"w": (6, 5), "b": (5,), "e": (7, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    # global grad norms both above and below the clip bar of 1.0
    scales = [3.0, 0.2, 1.5, 0.5, 5.0, 0.1, 2.0, 0.7]
    grads = []
    for sc in scales:
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        norm = np.sqrt(sum(float((a ** 2).sum()) for a in g.values()))
        grads.append({k: (a * (sc / norm)).astype(np.float32)
                      for k, a in g.items()})
    lr, warmup, total = 0.3, 3, 8
    tx = jpre.make_optimizer(lr, warmup=warmup, total_steps=total)
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(a.copy()) for k, a in params.items()}
    opt = make_optimizer(list(tp.values()), lr, warmup=warmup,
                         total_steps=total)
    norms = []
    for i, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(a) for k, a in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k].copy())
        opt.step()
        norms.append(opt.last_grad_norm.item())
        for k, t in tp.items():
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
            if i == 0:  # the schedule is 0 at count 0
                np.testing.assert_array_equal(t.numpy(), params[k])
    np.testing.assert_allclose(norms, scales, rtol=1e-5)
    assert min(norms) < 1.0 < max(norms)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_same_loss_and_grads(policy):
    batch = _batch(b=2, s=40, seed=3)
    ids, tgt = (torch.from_numpy(batch[k]) for k in ("input_ids", "targets"))
    out = {}
    for remat in (False, True):
        cfg = GPT2Config(**TINY, dtype=torch.float32, remat=remat,
                         remat_policy=policy)
        model, params = init_params(cfg, seed=4, device="cpu")
        loss = lm_loss(model(ids), tgt)
        loss.backward()
        out[remat] = (loss.item(), {k: p.grad for k, p in params.items()})
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6, abs=1e-6)
    for k, g in out[False][1].items():
        np.testing.assert_allclose(out[True][1][k].numpy(), g.numpy(),
                                   rtol=1e-6, atol=1e-6)
    bad = GPT2LMModel(GPT2Config(**TINY, remat_policy="everything"),
                      device="cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        bad(ids)


def test_model_grads_match_jax_grad():
    batch = _batch(b=2, s=48, seed=5)
    jmodel, jparams = _jax_params(seed=1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jpre.loss_fn(jmodel, p, jbatch))(jparams)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))

    cfg = GPT2Config(**TINY, dtype=torch.float32, remat=False)
    model, params = init_params(cfg, device="cpu")
    model.load_state_dict(params_from_flax(jparams))
    loss = loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    assert set(want) == set(params)
    for name, p in params.items():
        # f32 on both sides; the two frameworks sum in other orders through
        # two blocks, attention's backward and a 512-way softmax, so small
        # gradient entries differ by a few f32 roundings of the large ones
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("moe", [False, True])
def test_init_params_follows_the_flax_initialisers(moe):
    """Every parameter against flax's draw of it: the MoE experts (normal,
    not truncated) among them."""
    over = dict(moe_every=2, n_experts=4) if moe else {}
    jcfg = JConfig(**TINY, **over, dtype=jnp.float32, remat=False)
    _, jparams = jpre.init_params(jcfg, jax.random.PRNGKey(0))
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    cfg = GPT2Config(**TINY, **over, dtype=torch.float32)
    _, params = init_params(cfg, seed=0, device="cpu")
    assert set(params) == set(want)
    for name, p in params.items():
        got, ref = p.detach(), want[name]
        assert got.shape == ref.shape, name
        if float(ref.std()) == 0.0:  # zeros and ones: exact
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
            continue
        std = float(ref.std())
        assert abs(float(got.mean()) - float(ref.mean())) <= 0.1 * std, name
        assert abs(float(got.std()) / std - 1.0) <= 0.1, name
        # a truncated normal stays inside two of its own sigmas
        assert (float(got.abs().max()) <= 1.1 * float(ref.abs().max())), name
        if name.endswith(("w_in", "w_out")):  # the experts' normal is not
            assert float(got.abs().max()) > 3 * std, name


def test_trainer_losses_match_the_jax_trainer():
    cfg = JConfig(**TINY, dtype=jnp.float32, remat=False)
    jtrainer = jpre.ShardedPretrainer(cfg, MeshConfig(dp=-1),
                                      devices=jax.devices()[:1], lr=0.1,
                                      total_steps=10)
    init = jax.tree_util.tree_map(np.array, jtrainer.state[0])
    trainer = ShardedPretrainer(
        GPT2Config(**TINY, dtype=torch.float32, remat=False),
        MeshConfig(dp=-1), lr=0.1, device="cpu", total_steps=10,
        params=init)
    batches = [_batch(b=4, s=64, seed=10 + i) for i in range(5)]
    want = [float(jtrainer.step(b)) for b in batches]
    got = [trainer.step(b) for b in batches]
    assert all(t.dim() == 0 for t in got)
    # lr_t = 0.1 * t / 100: the params move from the second update on
    assert len(set(want)) == len(want)
    np.testing.assert_allclose([t.item() for t in got], want, rtol=1e-4)
    assert trainer.tokens_per_batch(batches[0]) == 4 * 64
    assert trainer.opt.count == 5


def test_trainer_refuses_what_is_not_ported():
    cfg = GPT2Config(**TINY, dtype=torch.float32)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedPretrainer(cfg)
    # without a process group the world is this process: a mesh of two
    # does not resolve, as JAX's MeshConfig.resolve refuses it (a sequence
    # split included: the gang of tests/test_torch_parallel.py trains it)
    for mesh in (MeshConfig(dp=2), MeshConfig(dp=-1, tp=2),
                 MeshConfig(dp=-1, sp=2)):
        with pytest.raises(ValueError, match="covers|divisible") as err:
            ShardedPretrainer(cfg, mesh, device="cpu")
        with pytest.raises(ValueError) as jerr:
            mesh.resolve(1)
        assert str(err.value) == str(jerr.value)
    trainer = ShardedPretrainer(cfg, dataclasses.replace(MeshConfig(),
                                                         dp=1),
                                device="cpu")
    assert trainer.mesh is None  # no process group: plain tensors


def test_trainer_drops_the_mask_as_the_jax_trainer_does():
    """The JAX trainer's shard_batch keeps only the keys of its
    batch_sharding (input_ids, targets), so a batch's mask never reaches
    its loss; the port's does the same."""
    cfg = JConfig(**TINY, dtype=jnp.float32, remat=False)
    jtrainer = jpre.ShardedPretrainer(cfg, MeshConfig(dp=-1),
                                      devices=jax.devices()[:1], lr=0.1,
                                      total_steps=10)
    init = jax.tree_util.tree_map(np.array, jtrainer.state[0])
    trainer = ShardedPretrainer(
        GPT2Config(**TINY, dtype=torch.float32, remat=False),
        MeshConfig(dp=-1), lr=0.1, device="cpu", total_steps=10,
        params=init)
    batch = _batch(b=4, s=64, seed=0)
    mask = np.zeros((4, 64), np.float32)
    mask[:, :8] = 1.0  # keeps the first 8 positions
    assert set(trainer.shard_batch({**batch, "mask": mask})) == {
        "input_ids", "targets"}
    want = float(jtrainer.step({**batch, "mask": mask}))
    got = trainer.step({**batch, "mask": mask}).item()
    np.testing.assert_allclose(want, 6.794787, rtol=1e-4)
    np.testing.assert_allclose(got, 6.794787, rtol=1e-4)
    # the mask, had it reached the loss, would have moved it
    masked = loss_fn(trainer.model, {
        **{k: torch.from_numpy(v) for k, v in batch.items()},
        "mask": torch.from_numpy(mask)}).item()
    assert abs(masked - got) > 1e-2, masked


@pytest.mark.parametrize("moe", [False, True])
def test_remat_dots_saves_no_batched_product(moe):
    """remat_policy="dots" saves what JAX's dots_with_no_batch_dims_saveable
    saves: the unbatched products (mm, addmm) are not run again in the
    backward, the batched ones (bmm: reference attention's (B*H, S, S)
    logits and its output, and the MoE block's four einsums, batched over
    the batch row or the expert) are, as under "full"."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Log(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[func] += 1
            return func(*args, **(kwargs or {}))

    aten = torch.ops.aten
    batch = _batch(b=2, s=40, seed=3)
    ids, tgt = (torch.from_numpy(batch[k]) for k in ("input_ids", "targets"))
    counts = {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = GPT2Config(**TINY, dtype=torch.float32, remat=remat,
                         remat_policy=policy, attention_impl="reference",
                         **(dict(moe_every=2, n_experts=4) if moe else {}))
        model, _ = init_params(cfg, seed=4, device="cpu")
        loss = loss_fn(model, {"input_ids": ids, "targets": tgt})
        with Log() as log:
            loss.backward()
        counts[remat and policy] = log.ops
    plain, full, dots = counts[False], counts["full"], counts["dots"]
    # every bmm of the forward runs again in the dots backward
    assert dots[aten.bmm.default] == full[aten.bmm.default] \
        > plain[aten.bmm.default]
    # the unbatched products come from the forward's saved outputs
    assert full[aten.addmm.default] > 0 == dots[aten.addmm.default]
    assert dots[aten.mm.default] == plain[aten.mm.default]
