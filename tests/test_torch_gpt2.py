"""ray_tpu_torch.models.gpt2 against ray_tpu.models.gpt2 on the CPU.

The JAX GPT2LMModel is initialised by flax, its param tree converted with
``params_from_flax``, and both models score the same ids.  The JAX side's
flash attention runs its Pallas kernel in interpret mode; the port's runs
the plain version of its flash forward.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models.gpt2 import GPT2Config as JConfig
from ray_tpu.models.gpt2 import GPT2LMModel as JModel
from ray_tpu_torch.models import GPT2Config, GPT2LMModel, params_from_flax

TINY = dict(vocab_size=512, n_positions=128, n_embd=64, n_layer=2, n_head=4)


def _jax_logits_and_params(dtype, ids):
    cfg = JConfig(**TINY, dtype=dtype, attention_impl="flash", remat=False)
    model = JModel(cfg)
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 2), jnp.int32), deterministic=True)
    logits = model.apply(variables, jnp.asarray(ids), deterministic=True)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return np.asarray(logits.astype(jnp.float32)), params


def _port_logits(dtype, params, ids, impl="flash"):
    model = GPT2LMModel(GPT2Config(**TINY, dtype=dtype, attention_impl=impl),
                        device="cpu")
    model.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        return model(torch.from_numpy(ids)).float().numpy()


def _ids(b=2, s=40, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, s))


def test_logits_match_jax_f32():
    ids = _ids()
    want, params = _jax_logits_and_params(jnp.float32, ids)
    got = _port_logits(torch.float32, params, ids)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_reference_attention_matches_flash_f32():
    ids = _ids(b=1, s=70, seed=1)
    _, params = _jax_logits_and_params(jnp.float32, ids)
    np.testing.assert_allclose(
        _port_logits(torch.float32, params, ids, "flash"),
        _port_logits(torch.float32, params, ids, "reference"),
        rtol=1e-3, atol=1e-4)


def test_logits_match_jax_bf16():
    # bf16 activations on both sides, rounded at other places by the two
    # frameworks: logits of this model are O(0.1), and a dozen bf16
    # roundings (2^-8 relative each) along the residual stream stay well
    # inside 2e-2
    ids = _ids(b=1, s=24, seed=2)
    want, params = _jax_logits_and_params(jnp.bfloat16, ids)
    got = _port_logits(torch.bfloat16, params, ids)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_params_from_flax_layout():
    ids = _ids(b=1, s=4)
    _, params = _jax_logits_and_params(jnp.float32, ids)
    state = params_from_flax({"params": params})
    model = GPT2LMModel(GPT2Config(**TINY), device="cpu")
    assert set(state) == set(model.state_dict())
    np.testing.assert_array_equal(
        state["h.1.attn.qkv_proj.weight"].numpy(),
        params["h_1"]["attn"]["qkv_proj"]["kernel"].T)
    assert "lm_head.bias" not in state


def test_ring_attention_impl_runs_the_ring(monkeypatch):
    """``attention_impl="ring"`` (the trainer's choice over sp) sends each
    layer's q, k, v to ``ring_attention_sharded`` over ``ring_axis``, as
    the JAX model does.  On plain tensors, with no mesh, both models raise;
    with the ring's steps unrolled over sp = 2 in this process in its
    place, the logits are the JAX model's."""
    from ray_tpu_torch.models import gpt2 as tgpt2
    from ray_tpu_torch.ops import ring_attention_fwd_unrolled

    ids = _ids(b=2, s=32, seed=4)
    want, params = _jax_logits_and_params(jnp.float32, ids)
    jcfg = JConfig(**TINY, dtype=jnp.float32, attention_impl="ring",
                   remat=False)
    with pytest.raises(ValueError, match="mesh"):
        JModel(jcfg).apply({"params": params}, jnp.asarray(ids),
                           deterministic=True)
    cfg = GPT2Config(**TINY, dtype=torch.float32, attention_impl="ring")
    assert cfg.ring_axis == jcfg.ring_axis == "sp"
    model = GPT2LMModel(cfg, device="cpu")
    model.load_state_dict(params_from_flax(params))
    with torch.no_grad(), pytest.raises(ValueError, match="DTensors"):
        model(torch.from_numpy(ids))
    axes = []

    def unrolled(q, k, v, *, causal, seq_axis):
        axes.append(seq_axis)
        return ring_attention_fwd_unrolled(q, k, v, sp=2, causal=causal)[0]

    monkeypatch.setattr(tgpt2, "ring_attention_sharded", unrolled)
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    assert axes == ["sp"] * TINY["n_layer"]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("over,exc", [
    (dict(moe_every=2), NotImplementedError),
    (dict(attention_impl="bogus"), ValueError),
])
def test_unported_options_raise(over, exc):
    with pytest.raises(exc):
        GPT2Config(**TINY, **over)
