"""The port's GAE and V-trace scans (``ray_tpu_torch/ops/{gae,vtrace}.py``)
against the JAX package's and against the plain backward loops of
``tests/test_rllib.py:50-73`` and ``:119-157``.

Inputs are numpy arrays drawn from a seed, at (T,) and (T, K) with
T in {1, 19, 64, 500}, with terminations and truncations (dones).  Bars:
returns at 1e-5 (``tests/test_ops.py:150``), GAE at 1e-4 (``:170-171``),
V-trace at rtol 1e-4 / atol 1e-5 (``tests/test_rllib.py:155-157``).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import (discounted_returns, gae_advantages,
                               gae_from_fragments, vtrace_from_fragments)

LENGTHS = (1, 19, 64, 500)
SHAPES = [(T,) for T in LENGTHS] + [(T, 3) for T in LENGTHS]
RETURNS_TOL = dict(atol=1e-5, rtol=1e-5)
GAE_TOL = dict(atol=1e-4, rtol=1e-4)
VTRACE_TOL = dict(atol=1e-5, rtol=1e-4)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    f = lambda: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    terminated = rng.random(shape) < 0.1
    truncated = (rng.random(shape) < 0.05) & ~terminated
    return {"rewards": f(), "values": f(), "next_values": f(),
            "dones": terminated | truncated,
            "behavior_logp": f() * 0.3, "target_noise": f() * 0.2,
            "bootstrap": f()[-1]}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _loop(c, d):
    """y_t = c_t y_{t+1} + d_t, backwards, in numpy."""
    out = np.zeros_like(d)
    running = np.zeros_like(d[-1])
    for t in reversed(range(len(d))):
        running = d[t] + c[t] * running
        out[t] = running
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_discounted_returns(shape):
    import jax.numpy as jnp

    from ray_tpu.ops.gae import discounted_returns as jax_returns

    x = _inputs(shape, 0)
    gamma = 0.9
    cont = gamma * (1.0 - x["dones"].astype(np.float32))
    got = discounted_returns(_t(x["rewards"]), _t(x["dones"]), gamma)
    np.testing.assert_allclose(got.numpy(), _loop(cont, x["rewards"]),
                               **RETURNS_TOL)
    want = jax_returns(jnp.asarray(x["rewards"]), jnp.asarray(x["dones"]),
                       gamma)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RETURNS_TOL)
    # with a bootstrap value for the state after the last step
    got = discounted_returns(_t(x["rewards"]), _t(x["dones"]), gamma,
                             _t(x["bootstrap"]))
    d = x["rewards"].copy()
    d[-1] += cont[-1] * x["bootstrap"]
    np.testing.assert_allclose(got.numpy(), _loop(cont, d), **RETURNS_TOL)
    want = jax_returns(jnp.asarray(x["rewards"]), jnp.asarray(x["dones"]),
                       gamma, jnp.asarray(x["bootstrap"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RETURNS_TOL)


@pytest.mark.parametrize("bootstrap", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gae_advantages(shape, bootstrap):
    import jax.numpy as jnp

    from ray_tpu.ops.gae import gae_advantages as jax_gae

    x = _inputs(shape, 1)
    gamma, lam = 0.99, 0.95
    boot = x["bootstrap"] if bootstrap else None
    adv, targets = gae_advantages(
        _t(x["rewards"]), _t(x["values"]), _t(x["dones"]), gamma, lam,
        None if boot is None else _t(boot))
    not_done = 1.0 - x["dones"].astype(np.float32)
    last = np.zeros_like(x["values"][-1]) if boot is None else boot
    nv = np.concatenate([x["values"][1:], last[None]], 0)
    deltas = x["rewards"] + gamma * not_done * nv - x["values"]
    expect = _loop(gamma * lam * not_done, deltas)
    np.testing.assert_allclose(adv.numpy(), expect, **GAE_TOL)
    np.testing.assert_allclose(targets.numpy(), expect + x["values"],
                               **GAE_TOL)
    ja, jt = jax_gae(jnp.asarray(x["rewards"]), jnp.asarray(x["values"]),
                     jnp.asarray(x["dones"]), gamma, lam,
                     None if boot is None else jnp.asarray(boot))
    np.testing.assert_allclose(adv.numpy(), np.asarray(ja), **GAE_TOL)
    np.testing.assert_allclose(targets.numpy(), np.asarray(jt), **GAE_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gae_from_fragments(shape):
    from ray_tpu.ops.gae import gae_from_fragments as jax_gae

    x = _inputs(shape, 2)
    gamma, lam = 0.97, 0.9
    adv, targets = gae_from_fragments(
        _t(x["rewards"]), _t(x["values"]), _t(x["next_values"]),
        _t(x["dones"]), gamma, lam)
    deltas = x["rewards"] + gamma * x["next_values"] - x["values"]
    expect = _loop(gamma * lam * (1.0 - x["dones"].astype(np.float32)),
                   deltas)
    np.testing.assert_allclose(adv.numpy(), expect, **GAE_TOL)
    np.testing.assert_allclose(targets.numpy(), expect + x["values"],
                               **GAE_TOL)
    ja, jt = jax_gae(x["rewards"], x["values"], x["next_values"],
                     x["dones"], gamma, lam)
    np.testing.assert_allclose(adv.numpy(), np.asarray(ja), **GAE_TOL)
    np.testing.assert_allclose(targets.numpy(), np.asarray(jt), **GAE_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_vtrace_from_fragments(shape):
    from ray_tpu.ops.vtrace import vtrace_from_fragments as jax_vtrace

    x = _inputs(shape, 3)
    gamma, rho_clip, c_clip = 0.97, 1.0, 1.0
    blogp = x["behavior_logp"]
    tlogp = blogp + x["target_noise"]
    args = (blogp, tlogp, x["rewards"], x["values"], x["next_values"],
            x["dones"])
    vs, pg = vtrace_from_fragments(*map(_t, args), gamma, rho_clip, c_clip)

    rhos = np.exp(tlogp - blogp)
    rho = np.minimum(rhos, rho_clip)
    c = np.minimum(rhos, c_clip)
    not_done = 1.0 - x["dones"].astype(np.float32)
    delta = rho * (x["rewards"] + gamma * x["next_values"] - x["values"])
    vs_ref = x["values"] + _loop(gamma * c * not_done, delta)
    vs_next = np.concatenate([vs_ref[1:], x["next_values"][-1:]], 0)
    vs_next = np.where(x["dones"], x["next_values"], vs_next)
    pg_ref = rho * (x["rewards"] + gamma * vs_next - x["values"])
    np.testing.assert_allclose(vs.numpy(), vs_ref, **VTRACE_TOL)
    np.testing.assert_allclose(pg.numpy(), pg_ref, **VTRACE_TOL)
    jvs, jpg = jax_vtrace(*args, gamma, rho_clip, c_clip)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), **VTRACE_TOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jpg), **VTRACE_TOL)


def test_a_done_stops_the_scan_without_a_division():
    """c_t = 0 at a done: the doubling scan carries no 0/0 (a cumprod
    with a division would) and cuts the sum exactly there."""
    rewards = torch.ones(8)
    dones = torch.zeros(8, dtype=torch.bool)
    dones[3] = True
    got = discounted_returns(rewards, dones, 1.0)
    assert torch.isfinite(got).all()
    assert got.tolist() == [4.0, 3.0, 2.0, 1.0, 4.0, 3.0, 2.0, 1.0]
