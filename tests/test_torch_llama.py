"""ray_tpu_torch.models.llama against ray_tpu.models.llama on the CPU.

RoPE, RMSNorm, grouped-query attention, the whole model's logits and
gradients, the initialisers and five trainer steps go through the JAX
package (flash attention: its Pallas forward in interpret mode and its XLA
backward) and the port (the plain versions of its kernels: the tensors lie
on the CPU) on the same numpy inputs; the flax parameters cross over
through ``llama_params_from_flax``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from ray_tpu.models import llama as jllama
from ray_tpu.models import pretrain as jpre
from ray_tpu.parallel.mesh import MeshConfig
from ray_tpu_torch.models import (
    LlamaConfig,
    LlamaLMModel,
    ShardedPretrainer,
    init_params,
    llama_params_from_flax,
    loss_fn,
)
from ray_tpu_torch.models import llama as tllama

TINY = dict(vocab_size=512, n_positions=128, d_model=64, n_layer=2,
            n_head=4, n_kv_head=2, d_ff=128)
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _ids(b=2, s=40, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, s))


def _jax_params(dtype=jnp.float32, seed=0):
    cfg = jllama.LlamaConfig(**TINY, dtype=dtype, remat=False)
    model, params = jpre.init_params(cfg, jax.random.PRNGKey(seed))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, **over):
    cfg = LlamaConfig(**{**TINY, "dtype": torch.float32, "remat": False,
                         **over})
    model = LlamaLMModel(cfg, device="cpu")
    model.load_state_dict(llama_params_from_flax(params))
    return model


@pytest.mark.parametrize("offset", [0, 100])
def test_rope_matches_jax(offset):
    D = 16
    x = np.random.default_rng(0).normal(size=(2, 3, 8, D)).astype(np.float32)
    pos = np.arange(8) + offset
    jcos, jsin = jllama.rope_frequencies(D, jnp.asarray(pos), 10000.0)
    cos, sin = tllama.rope_frequencies(D, torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    want = jllama.apply_rope(jnp.asarray(x), jcos, jsin)
    got = tllama.apply_rope(torch.from_numpy(x), cos, sin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # bf16 in, bf16 out, rotated in f32 on both sides
    xb = torch.from_numpy(x).bfloat16()
    gotb = tllama.apply_rope(xb, cos, sin)
    wantb = jllama.apply_rope(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                              jcos, jsin)
    assert gotb.dtype == torch.bfloat16
    np.testing.assert_allclose(gotb.float().numpy(),
                               np.asarray(wantb.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


def test_rope_is_a_relative_rotation():
    """The properties tests/test_parallel_extras.py checks of the JAX
    rope, on the port's."""
    D = 16
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 2, 8, D)).astype(np.float32))
    cos, sin = tllama.rope_frequencies(D, torch.arange(8), 10000.0)
    y = tllama.apply_rope(x, cos, sin)
    # a rotation keeps every position's norm; position 0 is the identity
    np.testing.assert_allclose(y.norm(dim=-1).numpy(),
                               x.norm(dim=-1).numpy(), rtol=1e-5)
    np.testing.assert_allclose(y[:, :, 0].numpy(), x[:, :, 0].numpy(),
                               atol=1e-6)
    # shifting both positions by c keeps every cross-position dot
    cos2, sin2 = tllama.rope_frequencies(D, torch.arange(8) + 5, 10000.0)
    q, k = x[:, :, :4], x[:, :, 4:]
    qa, ka = (tllama.apply_rope(t, cos[:4], sin[:4]) for t in (q, k))
    qb, kb = (tllama.apply_rope(t, cos2[:4], sin2[:4]) for t in (q, k))
    dots_a = torch.einsum("bhmd,bhnd->bhmn", qa, ka)
    dots_b = torch.einsum("bhmd,bhnd->bhmn", qb, kb)
    np.testing.assert_allclose(dots_a.numpy(), dots_b.numpy(), rtol=1e-4,
                               atol=1e-5)
    # ...and the dots do depend on the positions
    assert not np.allclose(torch.einsum("bhmd,bhnd->bhmn", qa, kb).numpy(),
                           dots_a.numpy(), rtol=1e-3)


def test_gqa_matches_explicit_head_repetition():
    """Two KV heads serving four query heads give the attention of four
    KV heads whose weights repeat each of the two, consecutively (jnp.repeat,
    not a tiling); and both match the JAX LlamaAttention."""
    cfg = LlamaConfig(vocab_size=64, d_model=32, n_layer=1, n_head=4,
                      n_kv_head=2, d_ff=64, attention_impl="reference",
                      dtype=torch.float32)
    x = np.random.default_rng(1).normal(size=(2, 8, 32)).astype(np.float32)
    jcfg = jllama.LlamaConfig(vocab_size=64, d_model=32, n_layer=1, n_head=4,
                              n_kv_head=2, d_ff=64, dtype=jnp.float32,
                              attention_impl="reference")
    jattn = jllama.LlamaAttention(jcfg)
    variables = jattn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                           jnp.arange(8))
    want = np.asarray(jattn.apply(variables, jnp.asarray(x), jnp.arange(8)))
    p = jax.tree_util.tree_map(np.asarray, variables["params"])

    gqa = tllama.LlamaAttention(cfg)
    mha = tllama.LlamaAttention(dataclasses.replace(cfg, n_kv_head=4))
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            w = torch.from_numpy(p[name]["kernel"].T.copy())
            getattr(gqa, name).weight.copy_(w)
            if name in ("wk", "wv"):  # (KV*D, E) -> each head's rows twice
                w = w.reshape(2, 8, 32).repeat_interleave(2, 0)
                w = w.reshape(32, 32)
            getattr(mha, name).weight.copy_(w)
    cos, sin = tllama.rope_frequencies(8, torch.arange(8), 10000.0)
    with torch.no_grad():
        got = gqa(torch.from_numpy(x), cos, sin).numpy()
        full = mha(torch.from_numpy(x), cos, sin).numpy()
    np.testing.assert_allclose(got, full, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_matches_flax(dtype):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, 5, 64)) * 3).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    jx = jnp.asarray(x, JDTYPE[dtype])
    want = fnn.RMSNorm(epsilon=1e-5, dtype=JDTYPE[dtype]).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jx)
    norm = torch.nn.RMSNorm(64, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        got = tllama._rmsnorm(norm, torch.from_numpy(x).to(dtype), dtype)
    assert got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def _jax_logits(params, ids, dtype, impl):
    jcfg = jllama.LlamaConfig(**TINY, dtype=JDTYPE[dtype], remat=False,
                              attention_impl=impl)
    return np.asarray(jllama.LlamaLMModel(jcfg).apply(
        {"params": params}, jnp.asarray(ids)).astype(jnp.float32))


@pytest.mark.parametrize("impl", ["flash", "reference"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_logits_match_jax(dtype, impl):
    ids = _ids(b=2, s=40, seed=3)
    _, params = _jax_params()
    want = _jax_logits(params, ids, dtype, impl)
    model = _port_model(params, dtype=dtype, attention_impl=impl)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
        return
    # bf16 activations, rounded at other places by the two frameworks (XLA
    # rounds silu's sigmoid and its product apart, torch once).  The
    # logits reach 4.5, where one bf16 ulp is 2^-5: the bar is 2e-2 of
    # their scale, and the port may be no farther from the f32 logits than
    # 1.5x the JAX model in bf16 is
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * scale)
    exact = _jax_logits(params, ids, torch.float32, impl)
    assert (np.abs(got - exact).max()
            <= 1.5 * np.abs(want - exact).max())


def test_grads_match_jax_grad():
    ids, tgt = _ids(b=2, s=48, seed=5), _ids(b=2, s=48, seed=6)
    jmodel, jparams = _jax_params(seed=1)
    jbatch = {"input_ids": jnp.asarray(ids), "targets": jnp.asarray(tgt)}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jpre.loss_fn(jmodel, p, jbatch))(jparams)
    want = llama_params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    model = _port_model(jparams)
    loss = loss_fn(model, {"input_ids": torch.from_numpy(ids),
                           "targets": torch.from_numpy(tgt)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_remat_gives_the_same_loss_and_grads():
    ids, tgt = (torch.from_numpy(_ids(b=2, s=40, seed=s)) for s in (7, 8))
    out = {}
    for remat in (False, True):
        cfg = LlamaConfig(**TINY, dtype=torch.float32, remat=remat)
        model, params = init_params(cfg, seed=4, device="cpu")
        loss = loss_fn(model, {"input_ids": ids, "targets": tgt})
        loss.backward()
        out[remat] = (loss.item(), {k: p.grad for k, p in params.items()})
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    for k, g in out[False][1].items():
        np.testing.assert_allclose(out[True][1][k].numpy(), g.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_init_params_follows_the_flax_initialisers():
    _, jparams = _jax_params(seed=0)
    want = llama_params_from_flax(jparams)
    cfg = LlamaConfig(**TINY, dtype=torch.float32)
    _, params = init_params(cfg, seed=0, device="cpu")
    assert set(params) == set(want)
    for name, p in params.items():
        got, ref = p.detach(), want[name]
        assert got.shape == ref.shape, name
        if float(ref.std()) == 0.0:  # RMSNorm scales: ones, exactly
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
            continue
        std = float(ref.std())
        assert abs(float(got.mean()) - float(ref.mean())) <= 0.1 * std, name
        assert abs(float(got.std()) / std - 1.0) <= 0.1, name
        assert float(got.abs().max()) <= 1.1 * float(ref.abs().max()), name


def test_trainer_losses_match_the_jax_trainer():
    cfg = jllama.LlamaConfig(**TINY, dtype=jnp.float32, remat=False)
    jtrainer = jpre.ShardedPretrainer(cfg, MeshConfig(dp=-1),
                                      devices=jax.devices()[:1], lr=0.1,
                                      total_steps=10)
    init = jax.tree_util.tree_map(np.array, jtrainer.state[0])
    trainer = ShardedPretrainer(
        LlamaConfig(**TINY, dtype=torch.float32, remat=False),
        MeshConfig(dp=-1), lr=0.1, device="cpu", total_steps=10,
        params=init)
    rng = np.random.default_rng(10)
    batches = [{k: rng.integers(0, 512, (4, 64))
                for k in ("input_ids", "targets")} for _ in range(5)]
    want = [float(jtrainer.step(b)) for b in batches]
    got = [trainer.step(b).item() for b in batches]
    assert len(set(want)) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert isinstance(trainer.model, LlamaLMModel)


def test_ring_attention_impl_runs_the_ring(monkeypatch):
    """``attention_impl="ring"`` sends each layer's q, k, v, after RoPE
    and the GQA repeat, to ``ring_attention_sharded`` over ``ring_axis``,
    as the JAX model does.  On plain tensors, with no mesh, both models
    raise; with the ring's steps unrolled over sp = 4 in this process in
    its place, the logits are the JAX model's."""
    from ray_tpu_torch.ops import ring_attention_fwd_unrolled

    ids = _ids(b=2, s=40, seed=7)
    _, params = _jax_params()
    want = _jax_logits(params, ids, torch.float32, "flash")
    jcfg = jllama.LlamaConfig(**TINY, dtype=jnp.float32,
                              attention_impl="ring", remat=False)
    with pytest.raises(ValueError, match="mesh"):
        jllama.LlamaLMModel(jcfg).apply({"params": params}, jnp.asarray(ids))
    model = _port_model(params, attention_impl="ring")
    assert model.config.ring_axis == jcfg.ring_axis == "sp"
    with torch.no_grad(), pytest.raises(ValueError, match="DTensors"):
        model(torch.from_numpy(ids))
    shapes = []

    def unrolled(q, k, v, *, causal, seq_axis):
        shapes.append((seq_axis, tuple(k.shape)))
        return ring_attention_fwd_unrolled(q, k, v, sp=4, causal=causal)[0]

    monkeypatch.setattr(tllama, "ring_attention_sharded", unrolled)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    # every query head has its K/V head
    assert shapes == [("sp", (2, TINY["n_head"], 40, 16))] * TINY["n_layer"]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("over,exc,match", [
    (dict(moe_every=2), NotImplementedError, "A5b"),
    (dict(attention_impl="bogus"), ValueError, "attention_impl"),
    (dict(n_kv_head=3), ValueError, "n_kv_head"),
])
def test_unported_options_raise(over, exc, match):
    with pytest.raises(exc, match=match):
        LlamaConfig(**{**TINY, **over})
