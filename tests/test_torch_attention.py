"""ray_tpu_torch.ops.attention against ray_tpu.ops.attention on the CPU.

The same numpy inputs go through the JAX package's flash attention (its
Pallas kernel in interpret mode, as tests/test_ops.py runs it) and the
port's flash attention (its plain versions: the tensors lie on the CPU), at
the JAX suite's forward bar of 2e-3: the blockwise forward, and the split-KV
forward with its merge, against ``_online_merge``.  The backward: the plain
version against ``_flash_backward`` on the same o and lse at 1e-5 (the same
algorithm in f32), and the port's autograd gradients against ``jax.grad``
at the JAX suite's gradient bar of 5e-3.  The CUDA kernels themselves are
checked against the plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.ops import attention as jattn
from ray_tpu_torch.ops import attention as tattn

TOL = dict(atol=2e-3, rtol=2e-3)  # tests/test_ops.py forward bar
GRAD_TOL = dict(atol=5e-3, rtol=5e-3)  # tests/test_ops.py gradient bar


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


def test_flash_attention_grads_under_autograd():
    # the flash op's gradients (its plain backward) against autograd
    # through the port's own mha_reference
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(b=1, s=80, d=16))
    grads = []
    for fn in (tattn.flash_attention, tattn.mha_reference):
        (fn(q, k, v, causal=True) ** 2).sum().backward()
        grads.append([t.grad.clone() for t in (q, k, v)])
        for t in (q, k, v):
            t.grad = None
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **GRAD_TOL)
    with torch.no_grad():
        out = tattn.flash_attention(q, k, v)
    assert out.shape == q.shape and not out.requires_grad


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
    assert mod._bwd_fns is None or torch.cuda.is_available()
    assert set(tattn.KERNEL_LAUNCHES) == {
        "flash_fwd", "flash_fwd_combine", "flash_bwd_delta",
        "flash_bwd_dkdv", "flash_bwd_dq"}


# ------------------------------------------------------------ split-KV
def _jax_flash_with_lse(q, k, v, **kw):
    """The JAX package's forward, Pallas in interpret mode: (o, lse)."""
    scale = q.shape[-1] ** -0.5
    out, lse = jattn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kw.get("causal", True),
        scale, kw.get("q_offset", 0), kw.get("k_offset", 0), 64, 64,
        interpret=True)
    return np.asarray(out), np.asarray(lse)


def _split_then_merge(q, k, v, num_splits, **kw):
    part = tattn.flash_attention_fwd_split_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        num_splits=num_splits, **kw)
    o, lse = tattn.merge_partials_plain(*part)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("name,shape,kw,splits", [
    ("decode", dict(b=2, h=2, s=1, s_k=300, d=32),
     dict(causal=True, q_offset=299), 5),
    ("chunk_at_offset", dict(b=1, h=2, s=48, s_k=176, d=16),
     dict(causal=True, q_offset=128), 3),
    ("noncausal_ragged_sk", dict(b=1, h=2, s=70, s_k=150, d=16),
     dict(causal=False), 2),
    ("more_splits_than_tiles", dict(b=1, h=2, s=128, d=16),
     dict(causal=True), 4),
])
def test_split_plain_matches_jax_flash(name, shape, kw, splits):
    q, k, v = _qkv(**shape)
    want_o, want_lse = _jax_flash_with_lse(q, k, v, **kw)
    got_o, got_lse = _split_then_merge(q, k, v, splits, **kw)
    np.testing.assert_allclose(got_o, want_o, **TOL)
    np.testing.assert_allclose(got_lse, want_lse, **TOL)


def test_split_plain_fully_masked_rows_in_every_split():
    q, k, v = _qkv(b=1, h=2, s=64, s_k=200, d=16)
    part = tattn.flash_attention_fwd_split_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True,
        k_offset=1000, num_splits=3)
    acc, m, l = (t.numpy() for t in part)
    np.testing.assert_array_equal(m, np.float32(-1e30))
    np.testing.assert_array_equal(l, 0.0)
    np.testing.assert_array_equal(acc, 0.0)
    got_o, got_lse = _split_then_merge(q, k, v, 3, causal=True,
                                       k_offset=1000)
    want_o, want_lse = _jax_flash_with_lse(q, k, v, causal=True,
                                           k_offset=1000)
    np.testing.assert_array_equal(got_o, 0.0)
    np.testing.assert_array_equal(got_lse, np.float32(-1e30))
    np.testing.assert_array_equal(want_o, 0.0)
    np.testing.assert_array_equal(want_lse, np.float32(-1e30))


@pytest.mark.parametrize("splits,dead", [(1, ()), (3, (1,)), (7, (0, 4, 6)),
                                         (4, (0, 1, 2, 3))])
def test_merge_partials_matches_jax_online_merge(splits, dead):
    rng = np.random.default_rng(splits)
    b, h, s_q, d = 2, 3, 5, 16
    m = rng.normal(0.0, 3.0, (b, h, splits, s_q)).astype(np.float32)
    l = rng.uniform(0.5, 4.0, (b, h, splits, s_q)).astype(np.float32)
    acc = rng.standard_normal((b, h, splits, s_q, d)).astype(np.float32)
    for s in dead:  # an empty or fully masked split
        m[:, :, s], l[:, :, s], acc[:, :, s] = -1e30, 0.0, 0.0
    jm, jl, jacc = (jnp.asarray(m[:, :, 0]), jnp.asarray(l[:, :, 0]),
                    jnp.asarray(acc[:, :, 0]))
    for s in range(1, splits):
        jm, jl, jacc = jattn._online_merge(
            jm, jl, jacc, jnp.asarray(m[:, :, s]), jnp.asarray(l[:, :, s]),
            jnp.asarray(acc[:, :, s]))
    # the Pallas kernel's epilogue (attention.py:126-128)
    l_safe = jnp.where(jl == 0.0, 1.0, jl)
    want_o = np.asarray(jacc / l_safe[..., None])
    want_lse = np.asarray(jnp.where(jl == 0.0, -1e30, jm + jnp.log(l_safe)))
    got_o, got_lse = tattn.merge_partials_plain(
        torch.from_numpy(acc), torch.from_numpy(m), torch.from_numpy(l))
    np.testing.assert_allclose(got_o.numpy(), want_o, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5,
                               rtol=1e-5)
    # the wrapper takes the plain version for tensors on the CPU
    wrapped = tattn.flash_fwd_combine(torch.from_numpy(acc),
                                      torch.from_numpy(m),
                                      torch.from_numpy(l))
    np.testing.assert_array_equal(wrapped[0].numpy(), got_o.numpy())


@pytest.mark.parametrize("B,H,Sq,Sk,causal,qo,ko,block_q", [
    (1, 12, 1, 600, True, 599, 0, 16),      # serving decode
    (8, 12, 1, 1000, True, 999, 0, 16),     # batched decode
    (1, 12, 256, 512, True, 256, 0, 64),    # serving prefill chunk
    (1, 12, 512, 512, True, 0, 0, 64),      # GPT-2 prefill
    (2, 12, 200, 200, False, 0, 0, 64),     # non-causal, ragged
    (1, 12, 64, 64, True, 0, 1000, 64),     # nothing visible
    (8, 12, 512, 512, True, 0, 0, 64),      # 768 CTAs: fills the card
])
def test_split_plan_covers_each_visible_tile_once(B, H, Sq, Sk, causal, qo,
                                                  ko, block_q):
    plan = tattn.split_plan(B, H, Sq, Sk, causal, qo, ko, block_q, 64, 132)
    n_q = -(-Sq // block_q)
    assert len(plan.runs) == n_q
    if B * H * n_q >= 132:
        assert plan.num_splits == 1
    for iq, runs in enumerate(plan.runs):
        assert len(runs) == plan.num_splits
        rows = np.arange(iq * block_q, min((iq + 1) * block_q, Sq)) + qo
        keys = np.arange(Sk) + ko
        visible = (keys[None, :] <= rows[:, None]).any(axis=0) if causal \
            else np.ones(Sk, bool)
        n_vis = -(-(int(np.nonzero(visible)[0].max()) + 1) // 64) \
            if visible.any() else 0
        covered = [t for start, count in runs
                   for t in range(start, start + count)]
        # every visible tile exactly once, in order, none past the range
        assert covered == list(range(n_vis))
    assert plan == tattn.split_plan(B, H, Sq, Sk, causal, qo, ko, block_q,
                                    64, 132)


# ------------------------------------------------------------- backward
@pytest.mark.parametrize("name,shape,kw", [
    ("causal", dict(b=1, s=128, d=16), dict(causal=True)),
    ("short_seq", dict(b=1, s=64, d=16), dict(causal=True)),
    ("unaligned", dict(b=1, h=1, s=200, d=16), dict(causal=True)),
    ("noncausal", dict(b=1, s=128, d=16), dict(causal=False)),
    ("q_offset", dict(b=1, s=64, d=16), dict(causal=True, q_offset=64)),
    ("chunk_at_offset", dict(b=1, s=32, s_k=96, d=16),
     dict(causal=True, q_offset=64)),
    ("all_rows_dead", dict(b=1, s=64, d=16), dict(causal=True,
                                                  k_offset=1000)),
])
def test_flash_bwd_plain_matches_jax_flash_backward(name, shape, kw):
    q, k, v = _qkv(**shape)
    g = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    causal, qo, ko = kw["causal"], kw.get("q_offset", 0), kw.get("k_offset",
                                                                    0)
    scale = q.shape[-1] ** -0.5
    o, lse = jattn._flash_forward(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal, scale, qo, ko, 64,
                                  64, interpret=True)
    want = jattn._flash_backward(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), o, lse, jnp.asarray(g),
                                 causal, scale, qo, ko, 64)
    got = tattn.flash_attention_bwd_plain(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, g)),
        causal=causal, sm_scale=scale, q_offset=qo, k_offset=ko, block_k=64)
    for a, b in zip(got, want):
        # the same blockwise algorithm in f32 on both sides
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
    if name == "all_rows_dead":
        for a in got:
            np.testing.assert_array_equal(a.numpy(), 0.0)
    # the wrapper takes the plain version for tensors on the CPU
    wrapped = tattn.flash_attention_bwd(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, g)),
        causal=causal, q_offset=qo, k_offset=ko, block_k=64)
    for a, b in zip(wrapped, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("shape,blocks", [
    # the gradient cases of tests/test_ops.py::TestFlashAttention
    (dict(b=1, h=2, s=128, d=16), dict(block_q=64, block_k=64)),
    (dict(b=1, h=2, s=64, d=16), dict()),
    (dict(b=1, h=1, s=200, d=16), dict()),
])
def test_flash_grads_match_jax_grad(shape, blocks):
    q, k, v = _qkv(**shape)

    def f_jax(q, k, v):
        return jnp.sum(jattn.flash_attention(q, k, v, **blocks) ** 2)

    want = jax.grad(f_jax, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (tattn.flash_attention(tq, tk, tv, **blocks) ** 2).sum().backward()
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **GRAD_TOL)
