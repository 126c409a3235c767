"""ray_tpu_torch.ops.attention against ray_tpu.ops.attention on the CPU.

The same numpy inputs go through the JAX package's flash attention (its
Pallas kernel in interpret mode, as tests/test_ops.py runs it) and the
port's flash attention (its plain versions: the tensors lie on the CPU), at
the JAX suite's forward bar of 2e-3: the blockwise forward, and the split-KV
forward with its merge, against ``_online_merge``.  The backward: the plain
version against ``_flash_backward`` on the same o and lse at 1e-5 (the same
algorithm in f32) and, on bf16 inputs, within one bf16 ulp; the port's
autograd gradients against ``jax.grad`` at the JAX suite's gradient bar of
5e-3; which kernel variant each dtype and head dim takes, and that the
training path's strided layouts reach the TMA kernels uncopied.  The CUDA
kernels themselves are checked against the plain versions on the card by
chip_smoke.py.
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
    # the serving path's split counts (test_split_plan_at_serving_shapes):
    # a decode step over 600 keys, and a 256-row prefill chunk at offset 256
    ("serve_decode", dict(b=1, h=2, s=1, s_k=600, d=64),
     dict(causal=True, q_offset=599), 10),
    ("serve_chunk", dict(b=1, h=2, s=256, s_k=512, d=64),
     dict(causal=True, q_offset=256), 3),
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


@pytest.mark.parametrize("Sq,Sk,qo,block_q,splits", [
    (1, 600, 599, 16, 10),    # decode step of the 600-token prompt
    (256, 512, 256, 64, 3),   # second prefill chunk of 256
])
def test_split_plan_at_serving_shapes(Sq, Sk, qo, block_q, splits):
    # GPT-2-small's 12 heads, one sequence, on the H100's 132 SMs: the split
    # counts test_split_plain_matches_jax_flash checks at two heads
    assert tattn.split_plan(1, 12, Sq, Sk, True, qo, 0, block_q, 64,
                            132).num_splits == splits


@pytest.mark.parametrize("num_sms", [132, 16])
@pytest.mark.parametrize("B,H,Sq,Sk,causal,qo,block_q", [
    (1, 12, 1, 600, True, 599, 16),
    (8, 12, 1, 1000, True, 999, 16),
    (16, 12, 1, 1000, True, 999, 16),
    (1, 12, 5, 600, True, 595, 16),
    (1, 12, 256, 512, True, 256, 64),
    (1, 12, 512, 512, True, 0, 64),
    (1, 1, 2048, 2048, False, 0, 64),
    (3, 5, 70, 150, False, 0, 64),
    (1, 12, 64, 64, True, 0, 64),
])
def test_split_plans_fit_the_merge_counters(B, H, Sq, Sk, causal, qo,
                                            block_q, num_sms):
    # a split launch's last CTAs count on one int32 per (query tile, b*h),
    # from a buffer of num_sms entries: splits only below that many tiles
    plan = tattn.split_plan(B, H, Sq, Sk, causal, qo, 0, block_q, 64,
                            num_sms)
    tiles = B * H * -(-Sq // block_q)
    if plan.num_splits > 1:
        assert tiles < num_sms
    else:
        assert plan.num_splits == 1


# -------------------------------------- the wrappers' launches, with fakes
class _Entry:
    """Stands in for a ctypes entry of the kernel libraries: records the
    arguments of each call in ``calls`` and returns ``rc``."""

    def __init__(self, name, calls):
        self.name, self.calls, self.rc = name, calls, 0

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return self.rc


@pytest.fixture
def fake_kernels(monkeypatch):
    """The CUDA wrappers run on CPU tensors against recording fakes of the
    C entries, a fake stream (77) and 132 SMs; the launch counters start at
    0 and are put back afterwards."""
    import contextlib
    import types

    calls = []
    entries = {name: _Entry(name, calls) for name in (
        "flash_fwd", "flash_fwd_combine", "flash_bwd_delta",
        "flash_bwd_dkdv", "flash_bwd_dq")}
    monkeypatch.setattr(tattn, "_kernel", lambda: (
        entries["flash_fwd"], entries["flash_fwd_combine"]))
    monkeypatch.setattr(tattn, "_bwd_kernels", lambda: {
        k: v for k, v in entries.items() if k.startswith("flash_bwd")})
    monkeypatch.setattr(tattn, "_sm_count", lambda device: 132)
    monkeypatch.setattr(tattn, "_merge_counters", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=77))
    for counts in (tattn.KERNEL_LAUNCHES, tattn.FUSED_LAUNCHES):
        for key in counts:
            monkeypatch.setitem(counts, key, 0)
    return calls, entries


def test_split_forward_is_one_launch_that_merges(fake_kernels):
    calls, entries = fake_kernels
    q, k, v = (torch.from_numpy(a) for a in _qkv(b=1, h=12, s=1, s_k=600,
                                                  d=64))
    o, lse, part = tattn._flash_fwd_cuda(q, k, v, True, 0.125, 599, 0,
                                         partials=True)
    # one C call at 10 splits, no combine launch
    assert [name for name, _ in calls] == ["flash_fwd"]
    args = calls[0][1]
    assert args[12] == 10 and tattn.LAST_PLAN["num_splits"] == 10
    assert tattn.LAST_PLAN["merge"] == "in_kernel"
    # the partials it was handed, in the combine kernel's layout
    assert [t.data_ptr() for t in part] == list(args[5:8])
    assert part[0].shape == (1, 12, 10, 1, 64)
    assert part[1].shape == part[2].shape == (1, 12, 10, 1)
    # one zeroed int32 counter buffer of num_sms entries for (device,
    # stream), at least one counter per (query tile, b*h)
    counters = tattn._merge_counters[(q.device, 77)]
    assert counters.dtype == torch.int32 and counters.numel() == 132
    assert not counters.any()
    assert args[8] == counters.data_ptr() and args[9] == 132
    assert 1 * 12 <= args[9]
    assert tattn.KERNEL_LAUNCHES["flash_fwd"] == 1
    assert tattn.KERNEL_LAUNCHES["flash_fwd_combine"] == 0
    assert tattn.FUSED_LAUNCHES["flash_fwd_combine"] == 1
    # the next split launch on the stream takes the same buffer
    tattn._flash_fwd_cuda(q, k, v, True, 0.125, 599, 0)
    assert calls[1][1][8] == counters.data_ptr()
    # one split: no partials, no counters
    q, k, v = (torch.from_numpy(a) for a in _qkv(b=4, h=12, s=256, d=64))
    tattn._flash_fwd_cuda(q, k, v, True, 0.125, 0, 0)
    assert tattn.LAST_PLAN["num_splits"] == 1
    assert tattn.LAST_PLAN["merge"] is None
    assert calls[2][1][5:10] == (None, None, None, None, 0)
    assert tattn.FUSED_LAUNCHES["flash_fwd_combine"] == 2
    assert [name for name, _ in calls].count("flash_fwd_combine") == 0


def test_failed_split_launch_raises_and_drops_its_counters(fake_kernels):
    calls, entries = fake_kernels
    q, k, v = (torch.from_numpy(a) for a in _qkv(b=1, h=12, s=1, s_k=600,
                                                  d=64))
    entries["flash_fwd"].rc = 700  # cudaErrorIllegalAddress
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tattn._flash_fwd_cuda(q, k, v, True, 0.125, 599, 0)
    # no other kernel stands in, and the counts it may have left are gone
    assert [name for name, _ in calls] == ["flash_fwd"]
    assert tattn._merge_counters == {}
    assert tattn.KERNEL_LAUNCHES["flash_fwd"] == 0
    entries["flash_fwd"].rc = 0
    tattn._flash_fwd_cuda(q, k, v, True, 0.125, 599, 0)
    fresh = tattn._merge_counters[(q.device, 77)]
    assert calls[-1][1][8] == fresh.data_ptr() and not fresh.any()


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "wgmma"),
                                           (torch.float32, "simt")])
def test_backward_launches_dq_with_delta_then_dkdv(fake_kernels, dtype,
                                                   variant):
    calls, _ = fake_kernels
    B, H, S, D = 2, 3, 128, 64
    q, k, v, o = (torch.zeros(B, H, S, D, dtype=dtype) for _ in range(4))
    # g as the (B, H, S, D) view of a (B, S, H, D) tensor: other strides
    # than o's, so the order of the two in the call shows
    g = torch.zeros(B, S, H, D, dtype=dtype).transpose(1, 2)
    lse = torch.zeros(B, H, S)
    *grads, delta = tattn._flash_bwd_cuda(q, k, v, o, lse, g, True, 0.125,
                                          0, 0, return_delta=True)
    assert tattn.LAST_BWD_PLAN["variant"] == variant
    # dQ first, then dK/dV, never the delta kernel
    assert [name for name, _ in calls] == ["flash_bwd_dq", "flash_bwd_dkdv"]
    (_, dq_args), (_, dkdv_args) = calls
    # both get the same arguments: o, and the one delta buffer that dQ
    # writes and dK/dV reads
    assert dq_args == dkdv_args
    assert dq_args[4] == o.data_ptr() and dq_args[3] == g.data_ptr()
    assert dq_args[6] == delta.data_ptr()
    assert delta.shape == (B, H, S) and delta.dtype == torch.float32
    # strides after the 10 pointers and 6 ints: q, k, v, g, o
    strides = dq_args[16:31]
    assert strides[9:12] == (S * H * D, D, H * D)
    assert strides[12:15] == (H * S * D, S * D, D)
    assert [t.data_ptr() for t in grads] == list(dq_args[7:10])
    assert tattn.KERNEL_LAUNCHES["flash_bwd_delta"] == 0
    assert tattn.KERNEL_LAUNCHES["flash_bwd_dq"] == 1
    assert tattn.KERNEL_LAUNCHES["flash_bwd_dkdv"] == 1
    assert tattn.FUSED_LAUNCHES["flash_bwd_delta"] == 1


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
    # bf16 at the head dims of the tensor-core kernels
    ("causal_bf16", dict(b=1, s=128, d=64), dict(causal=True)),
    ("unaligned_noncausal_bf16", dict(b=1, s=72, d=64), dict(causal=False)),
    ("chunk_at_offset_bf16", dict(b=1, h=1, s=32, s_k=96, d=128),
     dict(causal=True, q_offset=64)),
    ("all_rows_dead_bf16", dict(b=1, s=64, d=64), dict(causal=True,
                                                       k_offset=1000)),
])
def test_flash_bwd_plain_matches_jax_flash_backward(name, shape, kw):
    q, k, v = _qkv(**shape)
    g = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)
    bf16 = name.endswith("_bf16")
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    # bf16 cases: the same bf16 values on both sides
    jq, jk, jv, jg = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    causal, qo, ko = kw["causal"], kw.get("q_offset", 0), kw.get("k_offset",
                                                                    0)
    scale = q.shape[-1] ** -0.5
    o, lse = jattn._flash_forward(jq, jk, jv, causal, scale, qo, ko, 64, 64,
                                  interpret=True)
    want = jattn._flash_backward(jq, jk, jv, o, lse, jg, causal, scale, qo,
                                 ko, 64)

    def port_inputs():
        return (torch.from_numpy(np.array(a.astype(jnp.float32))).to(dt)
                for a, dt in ((jq, tdt), (jk, tdt), (jv, tdt), (o, tdt),
                              (lse, torch.float32), (jg, tdt)))
    got = tattn.flash_attention_bwd_plain(
        *port_inputs(), causal=causal, sm_scale=scale, q_offset=qo,
        k_offset=ko, block_k=64)
    for a, b in zip(got, want):
        assert a.dtype == tdt
        b = np.asarray(b.astype(jnp.float32))
        if bf16:
            # both sides compute in f32 and round to bf16 once at the end:
            # at most one bf16 ulp apart (2^-7 relative), plus 1e-5 for
            # the f32 difference of two summation orders near zero
            np.testing.assert_allclose(a.float().numpy(), b, atol=1e-5,
                                       rtol=8e-3)
        else:
            # the same blockwise algorithm in f32 on both sides
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-5)
    if name.startswith("all_rows_dead"):
        for a in got:
            np.testing.assert_array_equal(a.float().numpy(), 0.0)
    # the wrapper takes the plain version for tensors on the CPU
    wrapped = tattn.flash_attention_bwd(
        *port_inputs(), causal=causal, q_offset=qo, k_offset=ko, block_k=64)
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,d,variant", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
])
def test_bwd_variant_by_dtype_and_head_dim(dtype, d, variant):
    # tensor cores for bf16 at D 64/128; exact f32 FMA for the f32 bars
    assert tattn.bwd_variant(dtype, d) == variant


def test_training_layouts_need_no_copy_on_the_tma_path():
    # GPT2LMModel at GPT-2-small width: q, k, v are (B, H, S, D) views of
    # the fused (B, S, 3E) projection, and the output gradient reaches the
    # backward as the (B, H, S, D) view of a (B, S, H, D) tensor
    B, S, H, D = 2, 64, 12, 64
    qkv = torch.zeros(B, S, 3 * H * D, dtype=torch.bfloat16)
    q, k, v = (t.reshape(B, S, H, D).transpose(1, 2)
               for t in qkv.split(H * D, dim=-1))
    g = torch.zeros(B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
    o = torch.zeros(B, H, S, D, dtype=torch.bfloat16)
    for t in (q, k, v, g):
        assert t.data_ptr() % 16 == 0
        assert tattn._kernel_strides(t.shape, t.stride(), 2)[1]
    variant = tattn.bwd_variant(q.dtype, D)
    assert variant == "wgmma"
    inputs, strides, copied = tattn._bwd_inputs(
        variant, (("q", q), ("k", k), ("v", v), ("o", o), ("g", g)))
    assert copied == []
    assert all(a is b for a, b in zip(inputs, (q, k, v, o, g)))
    assert strides[0] == (S * 3 * H * D, D, 3 * H * D)
    assert strides[4] == (S * H * D, D, H * D)
    # a K whose rows are not 16-byte multiples is copied on this path only
    odd = torch.zeros(B, H, S, D + 1, dtype=torch.bfloat16)[..., 1:]
    _, _, copied = tattn._bwd_inputs("wgmma", (("k", odd),))
    assert copied == ["k"]
    _, _, copied = tattn._bwd_inputs("simt", (("k", odd),))
    assert copied == []


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
