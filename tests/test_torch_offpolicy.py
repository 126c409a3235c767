"""The port's DQN and SAC (``ray_tpu_torch/rllib/algorithms/{dqn,sac}.py``)
on the CPU, against the JAX package.

``ReplayBuffer``: the same seed and writes give the JAX buffer's indices
and gathers exactly.  ``QEnvRunner``: from the same parameters
(``params_from_jax``) and seed, at epsilon 1.0 and 0.1, the JAX runner's
batches exactly (rows whose JAX top-two Q values lie within 1e-6 counted
and excepted), and the n-step case of ``tests/test_rllib.py:200``.
``_dqn_update`` against the JAX update (U 3, B 16, hidden (16, 16), tau 0
and 0.01, MSE and Huber): the last minibatch's stats and the parameters
within 1e-5, the target within 1e-6 of the target network's largest
magnitude.  The target network is a
copy: after an update at tau 0 it still holds the parameters from before
it, a hard sync copies the new ones, and the next update leaves it there.
``_sac_update`` against the JAX update, with the noise made by JAX's own
split chain (``sac.py:117``, ``:159``): the first minibatch's losses and
every parameter's gradient within 1e-5, and after 4 minibatches the
parameters, ``target_q`` and alpha within 1e-4, relative; SAC's warmup
batch equal to JAX's.  DQN reaches 350 on CartPole at
``tests/test_rllib.py:236``'s configuration, and SAC learns Pendulum at
``:377``'s (slow, as its JAX counterpart).

"Relative" is the largest absolute difference over the largest magnitude
of the reference tensor.  Each test runs torch on one intra-op thread.  JAX
and the JAX package are imported inside the tests only.
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.rllib.algorithms.dqn import (QEnvRunner, ReplayBuffer,
                                                _dqn_update, batch_to_device,
                                                dqn_minibatch)
from ray_tpu_torch.rllib.algorithms.sac import (SACEnvRunner, _sac_update,
                                                sac_losses, sac_minibatch)
from ray_tpu_torch.rllib.core.learner import make_optimizer
from ray_tpu_torch.rllib.core.rl_module import (QModule,
                                                SquashedGaussianModule,
                                                TwinQModule, params_from_jax)

Q_SPEC = {"observation_size": 4, "num_actions": 2, "hidden": (16, 16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These MLPs are small: one intra-op thread runs their CPU updates
    about twice as fast as torch's default, and leaves the other test
    processes their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
SAC_SPEC = {"observation_size": 3, "action_size": 1, "max_action": 2.0,
            "hidden": (16, 16)}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_state_close(module, jax_tree, tol, whole=False):
    """Each tensor within ``tol`` of its own largest magnitude, or with
    ``whole`` of the network's largest."""
    want = params_from_jax(jax_tree)
    got = module.state()
    assert set(got) == set(want)
    scale = max(float(v.abs().max()) for v in want.values())
    for name in want:
        err = _rel(got[name], want[name])
        if whole:
            err = float((got[name] - want[name]).abs().max()) / scale
        assert err <= tol, (name, err)


def _fill(buf, rng, n_writes, action_shape=()):
    for _ in range(n_writes):
        n = int(rng.integers(1, 9))
        obs = rng.standard_normal((n, 4)).astype(np.float32)
        if action_shape:
            act = rng.uniform(-1, 1, (n,) + action_shape).astype(np.float32)
        else:
            act = rng.integers(0, 2, n).astype(np.int32)
        buf.add_batch(obs, act, rng.standard_normal(n).astype(np.float32),
                      obs + 1, np.full(n, 0.99, np.float32),
                      (rng.random(n) < 0.2).astype(np.float32))


# ============================================================ replay buffer
@pytest.mark.parametrize("action_shape", [(), (2,)])
def test_replay_buffer_matches_jax(action_shape):
    from ray_tpu.rllib.algorithms.dqn import ReplayBuffer as JaxBuffer

    dtype = np.float32 if action_shape else np.int32
    mine = ReplayBuffer(37, 4, seed=5, action_shape=action_shape,
                        action_dtype=dtype)
    ref = JaxBuffer(37, 4, seed=5, action_shape=action_shape,
                    action_dtype=dtype)
    _fill(mine, np.random.default_rng(0), 12, action_shape)
    _fill(ref, np.random.default_rng(0), 12, action_shape)
    assert mine.size == ref.size == 37
    for _ in range(3):
        idx = mine.sample_indices(4, 8)
        np.testing.assert_array_equal(idx, ref.sample_indices(4, 8))
        got, want = mine.gather(idx), ref.gather(idx)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


# ================================================================ QEnvRunner
@pytest.mark.parametrize("epsilon", [1.0, 0.1])
def test_q_env_runner_matches_jax(epsilon):
    import jax
    import jax.numpy as jnp

    from ray_tpu.rllib.algorithms.dqn import QEnvRunner as JaxRunner

    kw = dict(env_name="CartPole-v1", num_envs=4, rollout_length=24,
              module_spec=Q_SPEC, seed=3, n_step=3, gamma=0.9)
    ref = JaxRunner(**kw)
    params = ref.module.init(jax.random.PRNGKey(0))
    mine = QEnvRunner(**kw)
    state = params_from_jax(params)
    for frag in range(3):
        want = ref.sample(params if frag == 0 else None, epsilon)
        got = mine.sample(state if frag == 0 else None, epsilon)
        # rows whose greedy choice is a coin toss at f32 are excepted
        q = np.asarray(ref.module.q_values(params, jnp.asarray(want["obs"])))
        top2 = np.sort(q, -1)[:, -2:]
        keep = (top2[:, 1] - top2[:, 0]) >= 1e-6
        print(f"fragment {frag}: {int((~keep).sum())} near-tie rows of "
              f"{len(keep)}")
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k][keep], want[k][keep])
    assert mine.get_metrics() == ref.get_metrics()


def test_dqn_nstep_semantics():
    """``tests/test_rllib.py:200``'s case on the port's buffer and runner."""
    buf = ReplayBuffer(capacity=8, observation_size=2, seed=0)
    for i in range(12):  # wraps past capacity
        buf.add_batch(np.full((1, 2), i, np.float32), [i], [float(i)],
                      np.full((1, 2), i + 1, np.float32), [0.9], [0.0])
    assert buf.size == 8
    idx = buf.sample_indices(2, 4)
    got = buf.gather(idx)
    assert got["obs"].shape == (2, 4, 2)
    # surviving entries are the last 8 writes
    assert set(np.unique(got["actions"])) <= set(range(4, 12))

    runner = QEnvRunner("CartPole-v1", num_envs=2, rollout_length=40,
                        module_spec={"observation_size": 4, "num_actions": 2},
                        seed=0, n_step=3, gamma=0.9)
    module = QModule(4, 2, generator=torch.Generator().manual_seed(0))
    batch = runner.sample(module.state(), epsilon=1.0)
    # n-step discounts are gamma^len for len in 1..3
    uniq = np.unique(batch["discounts"])
    allowed = np.array([0.9, 0.81, 0.729], np.float32)
    assert all(np.abs(allowed - u).min() < 1e-5 for u in uniq), uniq
    # with a 40-step fragment nothing truncates, so every episode end is
    # a termination: mid-episode emissions must be FULL windows (gamma^3);
    # short windows may only appear in terminal flushes
    short = np.abs(batch["discounts"] - 0.9 ** 3) > 1e-5
    assert (batch["dones"][short] == 1.0).all(), \
        "short n-step window emitted mid-episode"
    assert short.any(), "terminal flushes should emit short windows"
    assert not torch.cuda.is_initialized()


# =============================================================== DQN update
def _q_batches(seed, U=3, B=16):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((U, B, 4)).astype(np.float32)
    return {"obs": obs,
            "actions": rng.integers(0, 2, (U, B)).astype(np.int32),
            "rewards": rng.standard_normal((U, B)).astype(np.float32),
            "next_obs": (obs + 0.1 * rng.standard_normal((U, B, 4))
                         ).astype(np.float32),
            "discounts": rng.choice(np.float32([0.99, 0.9801, 0.970299]),
                                    (U, B)),
            "dones": (rng.random((U, B)) < 0.2).astype(np.float32)}


@pytest.mark.parametrize("tau", [0.0, 0.01])
@pytest.mark.parametrize("use_huber", [False, True])
def test_dqn_update_matches_jax(tau, use_huber):
    import jax
    import optax

    from ray_tpu.rllib.algorithms.dqn import _dqn_update as jax_update
    from ray_tpu.rllib.core.rl_module import QModule as JaxQ

    lr, clip = 1e-3, 40.0
    jmod = JaxQ(**Q_SPEC)
    params = jmod.init(jax.random.PRNGKey(0))
    target = jmod.init(jax.random.PRNGKey(1))
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adam(lr))
    batches = _q_batches(7)
    j_params, j_target, _, j_stats = jax_update(
        jmod, tx, params, target, tx.init(params),
        jax.tree_util.tree_map(jax.numpy.asarray, batches), double_q=True,
        tau=tau, use_huber=use_huber)

    module = QModule(**Q_SPEC)
    module.load_state(params_from_jax(params))
    tmod = QModule(**Q_SPEC)
    tmod.load_state(params_from_jax(target))
    tmod.requires_grad_(False)
    plist = [p for _, p in module.named_params()]
    step = functools.partial(dqn_minibatch, module, tmod, plist,
                             make_optimizer(plist, lr), double_q=True,
                             tau=tau, use_huber=use_huber, grad_clip=clip)
    per_mb = _dqn_update(step, batch_to_device(batches, torch.device("cpu")))
    assert set(per_mb) == set(j_stats)
    for k, v in j_stats.items():
        assert per_mb[k].shape == (3,)
        assert _rel(per_mb[k][-1], v) <= 1e-5, (k, float(per_mb[k][-1]),
                                                float(v))
    _assert_state_close(module, j_params, 1e-5)
    # the target: (1 - tau) of its own values and tau of the parameters,
    # whose error it carries scaled by tau; relative to the network's scale
    _assert_state_close(tmod, j_target, 1e-6, whole=True)


def _state_equal(a, b) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_dqn_target_is_a_copy_not_an_alias():
    """Hard syncs every 256 env steps, one 128-step fragment an iteration:
    the first update leaves the target at the initial parameters, the
    second iteration's sync copies the parameters after its update, and the
    third's update moves the parameters but not the target."""
    from ray_tpu_torch.rllib import DQNConfig

    algo = (DQNConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0).learners(device="cpu")
            .training(learning_starts=0, target_network_update_freq=256,
                      num_updates_per_iter=2, train_batch_size=32)
            .debugging(seed=0)).build()
    before = algo.module.state()
    assert _state_equal(algo.target.state(), before)
    algo.train()
    assert not _state_equal(algo.module.state(), before)
    assert _state_equal(algo.target.state(), before)
    algo.train()  # 256 steps: the sync after this update
    synced = algo.module.state()
    assert _state_equal(algo.target.state(), synced)
    algo.train()
    assert not _state_equal(algo.module.state(), synced)
    assert _state_equal(algo.target.state(), synced)
    assert not any(p.requires_grad for p in algo.target.parameters())


def test_dqn_cartpole_learns_to_350():
    """``tests/test_rllib.py:236``'s configuration with the update on the
    CPU: return >= 350 within 640k env steps."""
    from ray_tpu_torch.rllib import DQNConfig

    cfg = (DQNConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=0)
           .learners(device="cpu")
           .debugging(seed=1))
    algo = cfg.build()
    best = 0.0
    try:
        for _ in range(5000):  # <= 640k env steps
            result = algo.train()
            ret = result["episode_return_mean"]
            if np.isfinite(ret):
                best = max(best, ret)
            if ret >= 350:
                break
        assert best >= 350, (
            f"DQN did not reach 350 within "
            f"{result['num_env_steps_sampled_lifetime']} steps (best {best})")
        assert result["replay_buffer_size"] > 0
        assert algo.update_times() == []  # CUDA events only on the card
    finally:
        algo.stop()
    assert not torch.cuda.is_initialized()


def test_dqn_default_device_is_the_card():
    from ray_tpu_torch.rllib import DQNConfig, SACConfig

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DQNConfig().environment("CartPole-v1").build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SACConfig().environment("Pendulum-v1").build()


# =============================================================== SAC update
def _sac_batches(seed, M, B):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((M, B, 3)).astype(np.float32)
    return {"obs": obs,
            "actions": rng.uniform(-2, 2, (M, B, 1)).astype(np.float32),
            "rewards": rng.standard_normal((M, B)).astype(np.float32),
            "next_obs": (obs + 0.1 * rng.standard_normal((M, B, 3))
                         ).astype(np.float32),
            "discounts": np.full((M, B), 0.99, np.float32),
            "dones": (rng.random((M, B)) < 0.1).astype(np.float32)}


def _jax_noise(key, M, B, A):
    """The noise JAX's ``_sac_update`` draws from ``key``: a key a
    minibatch (``sac.py:159``), split into the next action's and the
    actor's (``:117``), each a standard normal of the action's shape."""
    import jax

    out = []
    for k in jax.random.split(key, M):
        k1, k2 = jax.random.split(k)
        out.append([np.asarray(jax.random.normal(k1, (B, A))),
                    np.asarray(jax.random.normal(k2, (B, A)))])
    return torch.from_numpy(np.asarray(out, np.float32))


def _sac_setup(M, B):
    """JAX's modules and parameters, and the port's modules loaded with
    them: ``(jax, port)`` dicts."""
    import jax

    from ray_tpu.rllib.core.rl_module import \
        SquashedGaussianModule as JaxActor
    from ray_tpu.rllib.core.rl_module import TwinQModule as JaxTwin

    spec = SAC_SPEC
    j_actor = JaxActor(observation_size=3, action_size=1, max_action=2.0,
                       hidden=spec["hidden"])
    j_critic = JaxTwin(observation_size=3, action_size=1,
                       hidden=spec["hidden"])
    ka, kc, kt = jax.random.split(jax.random.PRNGKey(4), 3)
    params = {"actor": j_actor.init(ka), "critic": j_critic.init(kc),
              "log_alpha": jax.numpy.asarray(-0.3)}
    target = j_critic.init(kt)
    actor = SquashedGaussianModule(3, 1, 2.0, spec["hidden"])
    actor.load_state(params_from_jax(params["actor"]))
    critic = TwinQModule(3, 1, spec["hidden"])
    critic.load_state(params_from_jax(params["critic"]))
    tq = TwinQModule(3, 1, spec["hidden"])
    tq.load_state(params_from_jax(target))
    tq.requires_grad_(False)
    log_alpha = torch.nn.Parameter(torch.tensor(-0.3))
    plist = ([p for _, p in actor.named_params()]
             + [p for _, p in critic.named_params()] + [log_alpha])
    return ({"actor": j_actor, "critic": j_critic, "params": params,
             "target": target},
            {"actor": actor, "critic": critic, "target": tq,
             "log_alpha": log_alpha, "params": plist})


def test_sac_first_minibatch_losses_and_gradients_match_jax():
    import jax
    import optax

    from ray_tpu.rllib.algorithms.sac import _sac_update as jax_update

    B = 64
    j, t = _sac_setup(1, B)
    key = jax.random.PRNGKey(11)
    batches = _sac_batches(3, 1, B)
    # a transformation that keeps the gradient as its state and moves
    # nothing: after one minibatch the state IS that minibatch's gradient
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jax.numpy.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(
            jax.numpy.zeros_like, g), g))
    _, _, grads, c_l, a_l, alpha = jax_update(
        j["actor"], j["critic"], keep, j["params"], j["target"],
        keep.init(j["params"]), key,
        jax.tree_util.tree_map(jax.numpy.asarray, batches), tau=0.005,
        target_entropy=-1.0)

    noise = _jax_noise(key, 1, B, 1)
    mb = {k: v[0] for k, v in batch_to_device(
        batches, torch.device("cpu")).items()}
    total, m_c, m_a, m_alpha = sac_losses(
        t["actor"], t["critic"], t["target"], t["log_alpha"], mb,
        noise[0, 0], noise[0, 1], -1.0)
    assert _rel(m_c.detach(), c_l) <= 1e-5
    assert _rel(m_a.detach(), a_l) <= 1e-5
    assert _rel(m_alpha.detach(), alpha) <= 1e-5
    m_grads = dict(zip(
        ["actor/" + n for n in t["actor"].param_names()]
        + ["critic/" + n for n in t["critic"].param_names()]
        + ["log_alpha"],
        torch.autograd.grad(total, t["params"])))
    want = params_from_jax(grads)
    assert set(m_grads) == set(want)
    for name, g in want.items():
        assert _rel(m_grads[name], g) <= 1e-5, (name, _rel(m_grads[name], g))
    # the critics' gradient comes from the critic loss alone: the actor's
    # term saw them stopped
    crit_only = torch.autograd.grad(
        sac_losses(t["actor"], t["critic"], t["target"], t["log_alpha"],
                   mb, noise[0, 0], noise[0, 1], -1.0)[1],
        [p for _, p in t["critic"].named_params()])
    for (name, _), g in zip(t["critic"].named_params(), crit_only):
        assert torch.equal(g, m_grads["critic/" + name]), name


def test_sac_update_matches_jax_after_four_minibatches():
    import jax
    import optax

    from ray_tpu.rllib.algorithms.sac import _sac_update as jax_update

    M, B, lr, tau = 4, 64, 1e-3, 0.005
    j, t = _sac_setup(M, B)
    key = jax.random.PRNGKey(12)
    batches = _sac_batches(5, M, B)
    tx = optax.adam(lr)
    j_params, j_target, _, c_l, a_l, alpha = jax_update(
        j["actor"], j["critic"], tx, j["params"], j["target"],
        tx.init(j["params"]), key,
        jax.tree_util.tree_map(jax.numpy.asarray, batches), tau=tau,
        target_entropy=-1.0)
    step = functools.partial(
        sac_minibatch, t["actor"], t["critic"], t["target"], t["log_alpha"],
        t["params"], make_optimizer(t["params"], lr), tau=tau,
        target_entropy=-1.0)
    m_c, m_a, m_alpha = _sac_update(
        step, batch_to_device(batches, torch.device("cpu")),
        _jax_noise(key, M, B, 1))
    assert _rel(m_c, c_l) <= 1e-4
    assert _rel(m_a, a_l) <= 1e-4
    assert _rel(m_alpha, alpha) <= 1e-4
    _assert_state_close(t["actor"], j_params["actor"], 1e-4)
    _assert_state_close(t["critic"], j_params["critic"], 1e-4)
    _assert_state_close(t["target"], j_target, 1e-4)
    assert _rel(t["log_alpha"].detach(), j_params["log_alpha"]) <= 1e-4


def test_sac_warmup_batch_matches_jax():
    import jax

    from ray_tpu.rllib.algorithms.sac import SACEnvRunner as JaxRunner

    kw = dict(env_name="Pendulum-v1", num_envs=4, rollout_length=16,
              module_spec=SAC_SPEC, seed=5)
    ref = JaxRunner(**kw)
    params = ref.actor.init(jax.random.PRNGKey(0))
    mine = SACEnvRunner(**kw)
    for _ in range(2):
        want = ref.sample(params, random_actions=True)
        got = mine.sample(params_from_jax(params), random_actions=True)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype, k
    assert mine.get_metrics() == ref.get_metrics()
    # the policy's own draws: finite, in range, from the CPU generator
    batch = mine.sample(params_from_jax(params))
    assert np.isfinite(batch["actions"]).all()
    assert np.abs(batch["actions"]).max() <= 2.0
    assert not torch.cuda.is_initialized()


@pytest.mark.slow
def test_sac_pendulum_learns():
    """``tests/test_rllib.py:377``'s configuration with the update on the
    CPU: greedy eval return well above the random-policy floor (~-1200)."""
    from ray_tpu_torch.rllib import SACConfig

    cfg = (SACConfig().environment("Pendulum-v1")
           .learners(device="cpu").debugging(seed=0))
    algo = cfg.build()
    for _ in range(45):
        out = algo.train()
    assert out["steps_sampled"] >= 20_000
    ev = algo.evaluate(n_episodes=5)
    assert ev["episode_return_mean"] >= -400.0, (ev, out)
    # the temperature auto-tuned DOWN from its 1.0 init as the policy
    # sharpened
    assert out["alpha"] < 0.9
