"""ray_tpu_torch.ops.attention against ray_tpu.ops.attention on the CPU.

The same numpy inputs go through the JAX package's flash attention (its
Pallas kernel in interpret mode, as tests/test_ops.py runs it) and the
port's flash forward (its plain version: the tensors lie on the CPU), at the
JAX suite's forward bar of 2e-3.  The CUDA kernel itself is checked against
the plain version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

TOL = dict(atol=2e-3, rtol=2e-3)  # tests/test_ops.py forward bar


def _qkv(b=2, h=2, s=256, d=32, s_k=None, seed=0):
    rng = np.random.default_rng(seed)
    s_k = s if s_k is None else s_k
    return (rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, h, s_k, d)).astype(np.float32),
            rng.standard_normal((b, h, s_k, d)).astype(np.float32))


def _both(q, k, v, **kw):
    want = np.asarray(jattn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got, lse = tattn.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    return got.numpy(), want, lse.numpy()


@pytest.mark.parametrize("name,shape,kw", [
    ("causal", dict(), dict(causal=True, block_q=64, block_k=64)),
    ("noncausal", dict(s=128), dict(causal=False, block_q=64, block_k=64)),
    ("unaligned_causal", dict(s=200), dict(causal=True)),
    ("unaligned_noncausal", dict(s=200), dict(causal=False)),
    ("short_seq", dict(b=1, s=64, d=16), dict(causal=True)),
    ("offsets", dict(s=64), dict(causal=True, q_offset=64, block_q=32,
                                 block_k=32)),
    ("chunk_vs_prefix", dict(b=1, s=48, s_k=112, d=16),
     dict(causal=True, q_offset=64, block_q=32, block_k=32)),
])
def test_flash_fwd_matches_jax_flash(name, shape, kw):
    q, k, v = _qkv(**shape)
    got, want, _ = _both(q, k, v, **kw)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_reference_matches_jax(causal):
    q, k, v = _qkv(s=96, d=16)
    want = np.asarray(jattn.mha_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=5))
    got = tattn.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              q_offset=5).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_lse_matches_jax_logsumexp():
    q, k, v = _qkv(b=1, s=200, d=16)
    _, _, lse = _both(q, k, v, causal=True, q_offset=3)
    scale = q.shape[-1] ** -0.5
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) * scale
    qi = jnp.arange(200)[:, None] + 3
    ki = jnp.arange(200)[None, :]
    want = jax.nn.logsumexp(jnp.where(qi >= ki, logits, -jnp.inf), axis=-1)
    np.testing.assert_allclose(lse, np.asarray(want), **TOL)


def test_fully_masked_rows_give_zero_and_neg_inf_lse():
    # k_offset past every query: no key is visible to any row
    q, k, v = _qkv(b=1, s=64, d=16)
    got, want, lse = _both(q, k, v, causal=True, k_offset=1000)
    np.testing.assert_array_equal(got, 0.0)
    np.testing.assert_array_equal(want, 0.0)
    np.testing.assert_array_equal(lse, np.float32(-1e30))


def test_plain_version_matches_reference_in_bf16():
    # the working type of the model: bf16 in, f32 accumulation, bf16 out
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(b=1, s=130, d=32))
    got, _ = tattn.flash_attention_fwd(q, k, v, causal=True)
    want = tattn.mha_reference(q.float(), k.float(), v.float(), causal=True)
    # bf16 inputs and output: two roundings of 2^-8 relative each
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=2e-2, rtol=2e-2)


def test_flash_attention_raises_under_autograd():
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(b=1, s=16, d=16))
    with pytest.raises(NotImplementedError, match="training slice"):
        tattn.flash_attention(q, k, v)
    with torch.no_grad():
        out = tattn.flash_attention(q, k, v)
    assert out.shape == q.shape


def test_no_card_raises_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: nothing to fall back from")
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch._native import build

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    # a tensor that is not on the CPU never takes the plain version
    q = torch.empty((1, 1, 4, 16), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tattn.flash_attention_fwd(q, q, q)
    # and the kernel build itself refuses without nvcc
    if build.library_path("flash_fwd").exists():
        pytest.skip("a built library is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("flash_fwd")


def test_importing_the_port_builds_nothing():
    import ray_tpu_torch.ops.attention as mod

    assert mod._fn is None or torch.cuda.is_available()
    assert set(tattn.KERNEL_LAUNCHES) == {"flash_fwd"}
