"""The port's RL layer (``ray_tpu_torch/rllib/``) on the CPU, against the
JAX package.

Without a runtime: the four modules' forwards against the JAX modules on
the JAX params (``params_from_jax``) at 1e-5, and their parameter names
against the JAX pytree's paths; one ``TorchLearner`` update (2 epochs, 4
minibatches) against ``_ppo_update`` from the same key's permutations
(params at 1e-5, stats at 1e-4); three ``PodracerLearner`` V-trace updates
against the JAX learner's at 1e-5; an ``EnvRunner`` fragment's logp and
values against the JAX module's on the same observations and actions, and
a ``MultiAgentEnvRunner``'s for each policy, with two iterations of PPO's
multi-agent path.

On one port runtime for the module (``init(num_cpus=4)``, no GPU): the
cases of ``tests/test_rllib.py:100-116`` (a learner actor, 128 steps) and
``tests/test_podracer.py:68-88`` (a driver-local learner bitwise equal to a
one-actor gang), ``:102-133`` (quorum 2 of 3, the replicas bitwise equal
after a flush), ``:225-254`` (Sebulba: zero local forwards, the pool
batching two runners, no CUDA and no JAX in the runners) and ``:257-279``
(the streaming smoke); ``llm_policy_pool`` on a tiny GPT-2 on the CPU,
whose greedy tokens for episode-so-far prompts equal the port's in-process
engine's.  Offline RL (``rllib/offline.py``): one ``_marwil_update`` at
MARWIL's beta 1 and BC's beta 0 against the JAX one from the same
parameters and minibatches (every minibatch's losses and norm, the
parameters, at 1e-5); ``record_dataset``'s rows equal the JAX package's
(recorded by a child process on the JAX runtime); and
``tests/test_rllib.py:316``'s BC and MARWIL learning bars on the CPU.  Nothing falls back: without a GPU, a learner on the default
device raises at once.

JAX and the JAX package are imported inside the tests only: the workers
that import this module never load them.
"""

import os
import threading

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import IMPALAConfig, PPOConfig
from ray_tpu_torch.rllib.core.learner import TorchLearner
from ray_tpu_torch.rllib.core.rl_module import (DiscretePolicyModule,
                                                QModule,
                                                SquashedGaussianModule,
                                                TwinQModule, params_from_jax)
from ray_tpu_torch.rllib.env.env_runner import EnvRunner
from ray_tpu_torch.rllib.podracer import LearnerGang, PodracerLearner

SPEC = {"observation_size": 4, "num_actions": 2, "hidden": (16,)}
TRAIN = {"lr": 5e-4, "gamma": 0.99, "rho_clip": 1.0, "c_clip": 1.0,
         "vf_loss_coeff": 0.5, "entropy_coeff": 0.01, "grad_clip": 40.0}
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
STATS_TOL = dict(rtol=1e-4, atol=1e-4)


def _fragment(rng, T=8, K=4):
    """A synthetic fragment with the keys ``sample()`` emits
    (``tests/test_podracer.py:38-53``)."""
    terminated = rng.random((T, K)) < 0.05
    return {
        "obs": rng.standard_normal(
            (T, K, SPEC["observation_size"])).astype(np.float32),
        "actions": rng.integers(
            0, SPEC["num_actions"], (T, K)).astype(np.int32),
        "logp": np.log(rng.uniform(0.3, 0.7, (T, K))).astype(np.float32),
        "values": rng.standard_normal((T, K)).astype(np.float32),
        "rewards": rng.random((T, K)).astype(np.float32),
        "terminated": terminated,
        "truncated": (rng.random((T, K)) < 0.05) & ~terminated,
        "next_values": rng.standard_normal((T, K)).astype(np.float32),
    }


def _assert_states_close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   err_msg=name, **tol)


def _assert_states_equal(a, b):
    assert sorted(a) == sorted(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name


def _jax_names(params):
    from ray_tpu.rllib.podracer.learner import named_parameters

    return named_parameters(params)


# ================================================================ modules

def test_discrete_policy_module_matches_jax():
    import jax

    from ray_tpu.rllib.core import rl_module as jm

    jmod = jm.DiscretePolicyModule(5, 3, hidden=(16, 8))
    params = jmod.init(jax.random.PRNGKey(0))
    mod = DiscretePolicyModule(5, 3, hidden=(16, 8))
    assert mod.param_names() == _jax_names(params)
    mod.load_state(params_from_jax(params))
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((7, 5)).astype(np.float32)
    actions = rng.integers(0, 3, 7).astype(np.int32)
    t_obs = torch.from_numpy(obs)
    with torch.no_grad():
        np.testing.assert_allclose(mod.logits(t_obs).numpy(),
                                   np.asarray(jmod.logits(params, obs)),
                                   **PARAM_TOL)
        np.testing.assert_allclose(mod.value(t_obs).numpy(),
                                   np.asarray(jmod.value(params, obs)),
                                   **PARAM_TOL)
        logp, ent = mod.logp_entropy(t_obs, torch.from_numpy(actions))
        jlogp, jent = jmod.logp_entropy(params, obs, actions)
        np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp),
                                   **PARAM_TOL)
        np.testing.assert_allclose(ent.numpy(), np.asarray(jent),
                                   **PARAM_TOL)
        assert mod.forward_inference(t_obs).tolist() == \
            np.asarray(jmod.forward_inference(params, obs)).tolist()
        # a sampled action's logp is the module's logp of that action
        acts, lp, v = mod.forward_exploration(
            t_obs, torch.Generator().manual_seed(3))
        np.testing.assert_allclose(
            lp.numpy(), np.asarray(jmod.logp_entropy(
                params, obs, acts.numpy().astype(np.int32))[0]),
            **PARAM_TOL)


@pytest.mark.parametrize("dueling", [True, False])
def test_q_module_matches_jax(dueling):
    import jax

    from ray_tpu.rllib.core import rl_module as jm

    jmod = jm.QModule(6, 4, hidden=(16, 16), dueling=dueling)
    params = jmod.init(jax.random.PRNGKey(1))
    mod = QModule(6, 4, hidden=(16, 16), dueling=dueling)
    assert mod.param_names() == _jax_names(params)
    mod.load_state(params_from_jax(params))
    obs = np.random.default_rng(1).standard_normal((9, 6)).astype(np.float32)
    with torch.no_grad():
        q = mod.q_values(torch.from_numpy(obs))
    np.testing.assert_allclose(q.numpy(), np.asarray(
        jmod.q_values(params, obs)), **PARAM_TOL)


def test_squashed_gaussian_module_matches_jax():
    import jax

    from ray_tpu.rllib.core import rl_module as jm

    jmod = jm.SquashedGaussianModule(3, 2, max_action=2.0, hidden=(16, 16))
    params = jmod.init(jax.random.PRNGKey(2))
    mod = SquashedGaussianModule(3, 2, max_action=2.0, hidden=(16, 16))
    assert mod.param_names() == _jax_names(params)
    mod.load_state(params_from_jax(params))
    obs = np.random.default_rng(2).standard_normal((5, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    # the JAX sample's own noise: jax.random.normal(key, mean.shape)
    eps = np.array(jax.random.normal(key, (5, 2)))
    jact, jlogp = jmod.sample(params, obs, key)
    with torch.no_grad():
        act, logp = mod.sample_with_eps(torch.from_numpy(obs),
                                        torch.from_numpy(eps))
        inf = mod.forward_inference(torch.from_numpy(obs))
    np.testing.assert_allclose(act.numpy(), np.asarray(jact), **PARAM_TOL)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), **PARAM_TOL)
    np.testing.assert_allclose(inf.numpy(), np.asarray(
        jmod.forward_inference(params, obs)), **PARAM_TOL)


def test_twin_q_module_matches_jax():
    import jax

    from ray_tpu.rllib.core import rl_module as jm

    jmod = jm.TwinQModule(3, 2, hidden=(16, 16))
    params = jmod.init(jax.random.PRNGKey(3))
    mod = TwinQModule(3, 2, hidden=(16, 16))
    assert mod.param_names() == _jax_names(params)
    mod.load_state(params_from_jax(params))
    rng = np.random.default_rng(3)
    obs = rng.standard_normal((6, 3)).astype(np.float32)
    act = rng.standard_normal((6, 2)).astype(np.float32)
    with torch.no_grad():
        q1, q2 = mod.q_values(torch.from_numpy(obs), torch.from_numpy(act))
    j1, j2 = jmod.q_values(params, obs, act)
    np.testing.assert_allclose(q1.numpy(), np.asarray(j1), **PARAM_TOL)
    np.testing.assert_allclose(q2.numpy(), np.asarray(j2), **PARAM_TOL)


# =============================================================== learners

def test_ppo_update_matches_jax():
    """One update, 2 epochs of 4 minibatches, on the permutations the JAX
    learner draws from its key (``core/learner.py:124-125``, ``:139``)."""
    import jax

    from ray_tpu.rllib.core.learner import JaxLearner

    cfg = {"lr": 1e-3, "num_epochs": 2, "minibatch_size": 16,
           "vf_clip_param": 100.0, "entropy_coeff": 0.01}
    batch = _fragment(np.random.default_rng(4), T=16, K=4)
    n = batch["rewards"].size
    jl = JaxLearner(SPEC, cfg, seed=0)
    start = params_from_jax(jl.params)
    _, sub = jax.random.split(jl._key)
    perms = np.stack([
        np.asarray(jax.random.permutation(k, n)[:n].reshape(4, 16))
        for k in jax.random.split(sub, 2)])
    jstats = jl.update(batch)

    tl = TorchLearner(SPEC, cfg, seed=0, device="cpu")
    assert tl.draw_permutations(n).shape == perms.shape
    tl.set_weights(start)
    stats = tl.update(batch, perms=torch.from_numpy(perms))
    _assert_states_close(tl.get_weights(), params_from_jax(jl.params),
                         **PARAM_TOL)
    assert sorted(stats) == sorted(jstats)
    for k in jstats:
        np.testing.assert_allclose(stats[k], jstats[k], err_msg=k,
                                   **STATS_TOL)


def test_podracer_learner_update_matches_jax():
    from ray_tpu.rllib.podracer import PodracerLearner as JaxPodracer

    rng = np.random.default_rng(5)
    frags = [_fragment(rng) for _ in range(3)]
    jl = JaxPodracer(SPEC, TRAIN, seed=0)
    pl = PodracerLearner(SPEC, TRAIN, seed=0, device="cpu")
    assert pl.param_names() == jl.param_names()
    pl.set_weights(params_from_jax(jl.get_weights()))
    for f in frags:
        jstats = jl.update(f)
        stats = pl.update(f)
        for k in jstats:
            np.testing.assert_allclose(stats[k], jstats[k], err_msg=k,
                                       **STATS_TOL)
    _assert_states_close(pl.get_weights(),
                         params_from_jax(jl.get_weights()), **PARAM_TOL)


def test_env_runner_fragment_matches_the_jax_module():
    import jax

    from ray_tpu.rllib.core.rl_module import \
        DiscretePolicyModule as JaxModule

    jmod = JaxModule(**SPEC)
    params = jmod.init(jax.random.PRNGKey(6))
    runner = EnvRunner("CartPole-v1", num_envs=4, rollout_length=32,
                       module_spec=SPEC, seed=0)
    runner.set_weights(params_from_jax(params))
    frag = runner.sample()
    assert runner.get_debug()["local_forwards"] == 33
    obs = frag["obs"].reshape(-1, 4)
    logp, _ = jmod.logp_entropy(params, obs, frag["actions"].reshape(-1))
    np.testing.assert_allclose(frag["logp"].reshape(-1), np.asarray(logp),
                               **PARAM_TOL)
    np.testing.assert_allclose(frag["values"].reshape(-1),
                               np.asarray(jmod.value(params, obs)),
                               **PARAM_TOL)
    # the bootstrap: the next step's value, 0 at a termination
    nv = frag["next_values"]
    inside = ~(frag["terminated"] | frag["truncated"])[:-1]
    np.testing.assert_array_equal(nv[:-1][inside], frag["values"][1:][inside])
    assert (nv[frag["terminated"]] == 0).all()


def _two_policies(aid):
    return "left" if aid == "agent_0" else "right"


def test_multi_agent_runner_and_ppo_match_jax_modules():
    """PPO's multi-agent path (``algorithms/ppo.py:78``): each policy's
    columns of a MultiAgentEnvRunner fragment carry the JAX module's logp
    and values; two driver-local iterations update both policies; a
    mapping to an unknown or to no agent raises
    (``tests/test_rllib.py:264-313``)."""
    import jax

    from ray_tpu.rllib.core.rl_module import \
        DiscretePolicyModule as JaxModule
    from ray_tpu_torch.rllib.env.multi_agent import MultiAgentEnvRunner

    jmod = JaxModule(**SPEC)
    params = {pid: jmod.init(jax.random.PRNGKey(i))
              for i, pid in enumerate(("left", "right"))}
    runner = MultiAgentEnvRunner("MultiCartPole", num_envs=3,
                                 rollout_length=16,
                                 policy_specs={"left": SPEC, "right": SPEC},
                                 policy_mapping_fn=_two_policies, seed=0)
    out = runner.sample({pid: params_from_jax(p) for pid, p in
                         params.items()})
    for pid, b in out.items():
        assert b["rewards"].shape == (16, 3)
        obs = b["obs"].reshape(-1, 4)
        logp, _ = jmod.logp_entropy(params[pid], obs,
                                    b["actions"].reshape(-1))
        np.testing.assert_allclose(b["logp"].reshape(-1), np.asarray(logp),
                                   **PARAM_TOL)
        np.testing.assert_allclose(b["values"].reshape(-1), np.asarray(
            jmod.value(params[pid], obs)), **PARAM_TOL)

    config = (PPOConfig().environment("MultiCartPole")
              .env_runners(num_env_runners=0, num_envs_per_env_runner=8,
                           rollout_fragment_length=64)
              .learners(device="cpu")
              .multi_agent(policies=["left", "right"],
                           policy_mapping_fn=_two_policies)
              .debugging(seed=0))
    algo = config.build()
    try:
        for _ in range(2):
            result = algo.train()
        for pid in ("left", "right"):
            assert np.isfinite(result[f"learner/{pid}/total_loss"])
        assert result["num_env_steps_sampled_lifetime"] == 2 * 8 * 64
    finally:
        algo.stop()
    with pytest.raises(ValueError, match="unknown policies"):
        (PPOConfig().environment("MultiCartPole").learners(device="cpu")
         .multi_agent(policies=["only"],
                      policy_mapping_fn=lambda aid: "mystery")).build()
    with pytest.raises(ValueError, match="mapped to no"):
        (PPOConfig().environment("MultiCartPole").learners(device="cpu")
         .multi_agent(policies=["shared", "ghost"],
                      policy_mapping_fn=lambda aid: "shared")).build()


def test_entry_points_raise_without_a_card():
    config = PPOConfig().environment("CartPole-v1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.build()
    with pytest.raises(ValueError, match="num_gpus_per_learner"):
        config.learners(num_gpus_per_learner=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PodracerLearner(SPEC, TRAIN)


# ================================================================ runtime

@pytest.fixture(scope="module")
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0,
                       object_store_memory=256 * 1024 ** 2)
    yield ray_tpu_torch
    from ray_tpu_torch import serve

    serve.shutdown()
    ray_tpu_torch.shutdown()


def test_learner_actor_on_the_default_device_raises_at_once(runtime):
    """No GPU in the cluster: a learner actor on the card raises at once
    instead of waiting for a lease that cannot come."""
    config = (PPOConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=0).learners(num_learners=1))
    with pytest.raises(RuntimeError, match="GPU"):
        config.build()


def test_learner_group_actor_mode(runtime):
    """num_learners=1: the update runs in a learner ACTOR, weights round-trip
    through the object store (``tests/test_rllib.py:100-116``)."""
    config = (PPOConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=0, num_envs_per_env_runner=4,
                           rollout_fragment_length=16)
              .learners(num_learners=1, device="cpu")
              .debugging(seed=0))
    algo = config.build()
    try:
        algo.train()
        r2 = algo.train()
        assert np.isfinite(r2["learner/total_loss"])
        assert r2["num_env_steps_sampled_lifetime"] == 128
        facts = ray_tpu_torch.get(
            algo.learner_group.actors[0].process_facts.remote(), timeout=60)
        assert facts["device"] == "cpu" and not facts["cuda_initialized"]
    finally:
        algo.stop()


def test_learner_parity_driver_vs_one_actor_gang(runtime):
    """A driver-local learner and a world_size=1 gang (no collective group)
    end bitwise equal (``tests/test_podracer.py:68-88``)."""
    rng = np.random.default_rng(0)
    frags = [_fragment(rng) for _ in range(3)]
    local = PodracerLearner(SPEC, TRAIN, seed=0, device="cpu")
    gang = LearnerGang(SPEC, TRAIN, num_learners=1, job="", seed=0,
                       device="cpu")
    try:
        for f in frags:
            local.update(f)
            stats = gang.submit(ray_tpu_torch.put(f))
            assert stats and "total_loss" in stats[0]
        _assert_states_equal(local.get_weights(), gang.get_weights(0))
    finally:
        gang.stop()


def test_quorum_round_returns_without_straggler(runtime):
    """3 learners, quorum=2: a round whose third rank naps returns on the
    first two; after a flush every replica is bitwise equal
    (``tests/test_podracer.py:102-133``)."""
    import time

    rng = np.random.default_rng(1)
    gang = LearnerGang(SPEC, TRAIN, num_learners=3, job="", seed=0,
                       quorum=2, device="cpu")
    try:
        for _ in range(3):  # group rendezvous off the clock
            gang.submit(ray_tpu_torch.put(_fragment(rng)))
        nap_ref = gang.learners[2].nap.remote(5.0)
        t0 = time.monotonic()
        stats = []
        for _ in range(3):
            stats += gang.submit(ray_tpu_torch.put(_fragment(rng)))
        elapsed = time.monotonic() - t0
        assert len(stats) >= 2, "quorum round returned no stats"
        assert elapsed < 4.0, (
            f"quorum=2 round stalled {elapsed:.1f}s behind the straggler")
        assert ray_tpu_torch.get(nap_ref, timeout=60) is True
        gang.flush(timeout_s=120)
        w0, w1, w2 = (gang.get_weights(r) for r in range(3))
        _assert_states_equal(w0, w1)
        _assert_states_equal(w0, w2)
    finally:
        gang.stop()


def test_sebulba_impala_zero_local_forwards(runtime):
    """Runners never run a local forward (actions, logp and bootstrap
    values all come from the pool), the pool batches more than one runner
    an iteration, and no runner starts CUDA or loads JAX
    (``tests/test_podracer.py:225-254``)."""
    config = (IMPALAConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                           rollout_fragment_length=8)
              .learners(device="cpu")
              .podracer(inference_mode="pool", fragments_per_call=4,
                        batch_window_s=0.01)
              .debugging(seed=0))
    algo = config.build()
    try:
        result = None
        for _ in range(3):
            result = algo.train()
        assert result["policy_version"] >= 2
        assert result["num_env_steps_sampled_lifetime"] >= 3 * 8 * 2
        debug = ray_tpu_torch.get(
            [r.get_debug.remote() for r in algo._runners], timeout=120)
        assert all(d["local_forwards"] == 0 for d in debug), debug
        for d in debug:
            assert not d["cuda_initialized"] and d["torch_threads"] == 1
            assert not {"jax", "optax", "ray_tpu"} & set(d["packages"])
        stats = ray_tpu_torch.get(algo._pool.get_stats.remote(), timeout=60)
        assert stats["requests"] > 0
        assert stats["max_batch_occupancy"] >= 2, (
            f"pool never batched two runners together: {stats}")
    finally:
        algo.stop()


def test_streaming_impala_smoke(runtime):
    """The default IMPALA (streaming, local inference): fragments consumed,
    versions advance (``tests/test_podracer.py:257-279``)."""
    config = (IMPALAConfig()
              .environment("CartPole-v1")
              .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                           rollout_fragment_length=8)
              .learners(device="cpu")
              .podracer(fragments_per_call=4)
              .debugging(seed=0))
    algo = config.build()
    try:
        result = None
        for _ in range(5):
            result = algo.train()
        assert result["policy_version"] >= 2
        assert result["num_fragments_consumed"] >= 1
        assert result["num_env_steps_sampled_lifetime"] >= 5 * 8 * 2
        assert "learner/total_loss" in result
    finally:
        algo.stop()


def test_llm_policy_pool_matches_the_in_process_engine(runtime):
    """Two runner threads, two steps each, send the episode so far (the
    last prompt, its reply and a seeded observation); the pool's greedy
    tokens equal the in-process engine's, and the prefix cache hits."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import EngineCore
    from ray_tpu_torch.models import GPT2Config
    from ray_tpu_torch.rllib.podracer import llm_policy_pool

    kwargs = dict(model_config=GPT2Config.tiny(), device="cpu", seed=0,
                  num_pages=64, page_size=8, engine_name="rl-pool-test")
    handle = llm_policy_pool(dict(kwargs, enable_prefix_cache=True),
                             name="rl-llm-test")
    sent = {}
    errors = []

    def runner(i):
        rng = np.random.default_rng(100 + i)
        prompt = rng.integers(1, 200, 12).tolist()
        try:
            for step in range(2):
                out = handle.remote({"prompt_ids": prompt,
                                     "max_tokens": 6}).result(120)
                sent[(i, step)] = (list(prompt), out["tokens"])
                prompt = prompt + out["tokens"] + \
                    rng.integers(1, 200, 4).tolist()
        except Exception as err:  # reported below
            errors.append(repr(err))

    threads = [threading.Thread(target=runner, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
        assert not errors and not any(t.is_alive() for t in threads), errors
        stats = handle.options(method_name="engine_stats").remote() \
            .result(60)
    finally:
        serve.delete("rl-llm-test")
    assert len(sent) == 4
    assert stats["prefix_hit_tokens"] > 0
    # no page leaked: every page is free or held by the prefix trie
    assert stats["kv_pages_free"] + stats["prefix_cache_pages"] == \
        stats["kv_pages_total"]
    core = EngineCore(**kwargs)
    for prompt, tokens in sent.values():
        assert core.generate(prompt, {"max_tokens": 6})["tokens"] == tokens


# ================================================================ offline
MARWIL_BATCH, MARWIL_MINIBATCH = 1024, 128


def _marwil_batch(seed=6):
    """``tests/test_rllib.py:316``'s batch shape: 1024 CartPole-like rows
    with returns-to-go as the heuristic policy's reach them."""
    rng = np.random.default_rng(seed)
    n = MARWIL_BATCH
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "action": rng.integers(0, 2, n).astype(np.int64),
            "return_to_go": (rng.random(n) * 50).astype(np.float32)}


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_marwil_update_matches_jax(beta):
    """One ``_marwil_update`` (MARWIL at beta 1, BC at beta 0) against the
    JAX one from the same parameters on the same minibatches: every
    minibatch's policy and value losses and the moving norm after it, and
    the parameters at the end, at 1e-5.  The JAX scan's per-minibatch
    losses are its body's: the JAX update on one minibatch at a time,
    carrying params, optimizer state and norm, which the whole-batch call
    must end on too."""
    import functools

    import jax
    import optax

    from ray_tpu.rllib.core import rl_module as jm
    from ray_tpu.rllib.offline import _marwil_update as jax_update

    from ray_tpu_torch.rllib.core.learner import make_optimizer
    from ray_tpu_torch.rllib.offline import _marwil_update

    kw = dict(beta=beta, vf_coef=1.0, minibatch=MARWIL_MINIBATCH)
    jmod = jm.DiscretePolicyModule(4, 2, hidden=(64, 64))
    start = jmod.init(jax.random.PRNGKey(1))
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adam(1e-3))
    batch = _marwil_batch()
    # jitted as MARWIL jits it (``offline.py:171-173``)
    update = jax.jit(functools.partial(jax_update, jmod, tx, **kw))
    jparams, jopt, jnorm = start, tx.init(start), jax.numpy.asarray(1.0)
    want = []
    for i in range(MARWIL_BATCH // MARWIL_MINIBATCH):
        mb = {k: v[i * MARWIL_MINIBATCH:(i + 1) * MARWIL_MINIBATCH]
              for k, v in batch.items()}
        jparams, jopt, jnorm, pi, vf = update(jparams, jopt, jnorm, mb)
        want.append((float(pi), float(vf), float(jnorm)))
    whole = update(start, tx.init(start), jax.numpy.asarray(1.0), batch)
    _assert_states_close(params_from_jax(whole[0]),
                         params_from_jax(jparams), **PARAM_TOL)

    mod = DiscretePolicyModule(4, 2, hidden=(64, 64))
    mod.load_state(params_from_jax(start))
    params = [p for _, p in mod.named_params()]
    opt = make_optimizer(params, 1e-3)
    norm = torch.tensor(1.0)
    got = []
    for i in range(MARWIL_BATCH // MARWIL_MINIBATCH):
        mb = {k: torch.from_numpy(v[i * MARWIL_MINIBATCH:
                                    (i + 1) * MARWIL_MINIBATCH])
              for k, v in batch.items()}
        norm, pi, vf = _marwil_update(mod, params, opt, norm, mb,
                                      grad_clip=10.0, **kw)
        got.append((pi.item(), vf.item(), norm.item()))
    np.testing.assert_allclose(np.array(got)[:, :2], np.array(want)[:, :2],
                               rtol=1e-5)
    np.testing.assert_allclose(np.array(got)[:, 2], np.array(want)[:, 2],
                               rtol=1e-6)
    _assert_states_close(mod.state(), params_from_jax(jparams), **PARAM_TOL)

    # the whole batch in one call: the same minibatches in order
    mod2 = DiscretePolicyModule(4, 2, hidden=(64, 64))
    mod2.load_state(params_from_jax(start))
    params2 = [p for _, p in mod2.named_params()]
    norm2, pis, vfs = _marwil_update(
        mod2, params2, make_optimizer(params2, 1e-3), torch.tensor(1.0),
        {k: torch.from_numpy(v) for k, v in batch.items()},
        grad_clip=10.0, **kw)
    assert pis.shape == vfs.shape == (MARWIL_BATCH // MARWIL_MINIBATCH,)
    np.testing.assert_allclose(pis.numpy(), np.array(got)[:, 0], rtol=1e-6)
    np.testing.assert_allclose(norm2.item(), float(whole[2]), rtol=1e-6)
    _assert_states_close(mod2.state(), mod.state(), rtol=0, atol=0)


def _jax_record(path):
    """The JAX package's ``record_dataset`` on its own runtime (a child
    process: the two runtimes never share one)."""
    import json

    import ray_tpu
    from ray_tpu.rllib.offline import record_dataset as jax_record

    ray_tpu.init(num_cpus=2, object_store_memory=128 * 1024 ** 2)
    try:
        stats = jax_record(path, "CartPole-v1", n_episodes=30, seed=3)
    finally:
        ray_tpu.shutdown()
    with open(path + ".stats.json", "w") as f:
        json.dump(stats, f)


def _read_rows(path):
    import json

    rows = []
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name)) as f:
            rows.extend(json.loads(line) for line in f if line.strip())
    return rows


@pytest.fixture(scope="module")
def offline_data(runtime, tmp_path_factory):
    """CartPole episodes recorded by the port's ``record_dataset`` and, in
    a child process started beside it, by the JAX package's."""
    import json
    import signal
    import subprocess
    import sys

    root = tmp_path_factory.mktemp("offline")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, test_torch_rllib as t; "
         "t._jax_record(sys.argv[1])", str(root / "jax")], cwd=here,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)
    from ray_tpu_torch.rllib.offline import record_dataset

    stats = record_dataset(str(root / "port"), "CartPole-v1", n_episodes=30,
                           seed=3)
    try:
        log, _ = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
    assert proc.returncode == 0, log.decode()[-4000:]
    with open(str(root / "jax") + ".stats.json") as f:
        jax_stats = json.load(f)
    return {"path": str(root / "port"), "stats": stats,
            "jax_path": str(root / "jax"), "jax_stats": jax_stats}


def test_record_dataset_matches_jax(offline_data):
    """The port's recorded rows equal the JAX package's, row for row."""
    assert offline_data["stats"] == offline_data["jax_stats"]
    assert offline_data["stats"]["steps"] > 300
    rows = _read_rows(offline_data["path"])
    assert rows == _read_rows(offline_data["jax_path"])
    assert len(rows) == offline_data["stats"]["steps"]


def test_offline_bc_and_marwil_learn_from_dataset(offline_data):
    """``tests/test_rllib.py:316``: BC and MARWIL, learning on the CPU
    from the recorded dataset, reach 60% of the behavior policy's
    return."""
    from ray_tpu_torch.rllib import BCConfig, MARWILConfig

    torch.set_num_threads(1)
    path = offline_data["path"]
    behavior_return = offline_data["stats"]["mean_return"]
    cfg = (BCConfig().environment("CartPole-v1")
           .offline_data(input_path=path)
           .learners(device="cpu").debugging(seed=1)
           .training(train_batch_size=1024, minibatch_size=128, lr=1e-3))
    algo = cfg.build()
    for _ in range(40):
        out = algo.train()
    assert out["policy_loss"] == out["policy_loss"]  # finite
    ev = algo.evaluate(n_episodes=5)
    assert ev["episode_return_mean"] >= 0.6 * behavior_return, (
        ev, behavior_return)

    mcfg = (MARWILConfig().environment("CartPole-v1")
            .offline_data(input_path=path)
            .learners(device="cpu").debugging(seed=1)
            .training(train_batch_size=1024, minibatch_size=128, lr=1e-3,
                      beta=1.0))
    malgo = mcfg.build()
    for _ in range(150):
        mout = malgo.train()
    assert mout["vf_loss"] < 10_000
    mev = malgo.evaluate(n_episodes=5)
    assert mev["episode_return_mean"] >= 0.6 * behavior_return, (
        mev, behavior_return)


def test_offline_learner_raises_without_a_card(offline_data):
    """The learner runs on the card unless ``.learners(device="cpu")``;
    without one it raises."""
    from ray_tpu_torch.rllib import BCConfig

    cfg = (BCConfig().environment("CartPole-v1")
           .offline_data(input_path=offline_data["path"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cfg.build()
