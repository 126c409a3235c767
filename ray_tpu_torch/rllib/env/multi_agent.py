"""Multi-agent env surface: dict-keyed agents, per-agent policy mapping.

Port of ``ray_tpu/rllib/env/multi_agent.py``.  Counterpart of the
reference's MultiAgentEnv (reference: rllib/env/multi_agent_env.py — dict
obs/action spaces keyed by agent id, per-agent reward/terminated dicts with
the ``__all__`` episode flag; policy mapping via
config.multi_agent(policies=..., policy_mapping_fn=...)).

The env + runner are host numpy programs, the runner's modules on the CPU
as ``env_runner.py``'s; each POLICY is a module updated by its own
learner.  The runner routes observations agent→policy with the mapping fn,
and emits one PPO-shaped time-major batch PER POLICY — agents sharing a
policy become extra env columns (K_policy = num_envs × agents_mapped), so
the single-agent learner update is reused unchanged.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


class MultiAgentVectorEnv:
    """Vectorized multi-agent env: K independent copies of an A-agent world.

    Episodes are SHARED per copy (the reference's ``__all__`` semantics):
    when a copy's episode ends, every agent in that copy resets together.
    Per-agent terminated/truncated dicts still differ — an agent that
    personally failed is terminated (no bootstrap), a surviving agent in an
    ending episode is truncated (bootstrap through the cut).
    """

    agents: List[str]
    observation_sizes: Dict[str, int]
    num_actions: Dict[str, int]

    def reset(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, np.ndarray]):
        """actions: {agent: (K,)}; returns (obs, rewards, terminated,
        truncated, info) — each a {agent: (K, ...)} dict; info["final_obs"]
        holds pre-reset observations (valid where an episode ended)."""
        raise NotImplementedError


class MultiCartPole(MultiAgentVectorEnv):
    """A-agent cartpole: each agent balances its own pole, but the EPISODE is
    shared — it ends when any pole falls (or at 500 steps), which gives the
    shared-fate termination structure real multi-agent envs have while the
    physics stays exactly CartPole-v1 (comparable returns)."""

    max_episode_steps = 500

    def __init__(self, num_envs: int, num_agents: int = 2, seed: int = 0):
        from ray_tpu_torch.rllib.env.cartpole import CartPoleVectorEnv

        self.num_envs = num_envs
        self.agents = [f"agent_{i}" for i in range(num_agents)]
        self.observation_sizes = {a: 4 for a in self.agents}
        self.num_actions = {a: 2 for a in self.agents}
        self._pole = {a: CartPoleVectorEnv(num_envs, seed=seed + 131 * i)
                      for i, a in enumerate(self.agents)}
        self.steps = np.zeros(num_envs, np.int32)

    def reset(self) -> Dict[str, np.ndarray]:
        self.steps[:] = 0
        return {a: p.reset() for a, p in self._pole.items()}

    def step(self, actions: Dict[str, np.ndarray]):
        obs, rewards, fell, final = {}, {}, {}, {}
        for a in self.agents:
            pole = self._pole[a]
            # step WITHOUT auto-reset semantics: we manage shared episodes,
            # so suppress the per-pole step counter's own truncation
            pole.steps[:] = 0
            o, r, term, _trunc, info = pole.step(actions[a])
            obs[a] = o
            rewards[a] = r
            fell[a] = term
            final[a] = info["final_obs"]
        self.steps += 1
        any_fell = np.zeros(self.num_envs, bool)
        for a in self.agents:
            any_fell |= fell[a]
        timeout = self.steps >= self.max_episode_steps
        done = any_fell | timeout
        terminated = {a: fell[a] for a in self.agents}
        truncated = {a: done & ~fell[a] for a in self.agents}
        if done.any():
            # shared reset: every agent's copy restarts together.  The
            # sub-env's final_obs is already the pre-reset state for every
            # copy (fallen or not); here only the not-personally-fallen
            # agents of done copies still need their state re-sampled.
            for a in self.agents:
                pole = self._pole[a]
                fresh = pole._sample_state(int(done.sum()))
                pole.state[done] = fresh
                obs[a] = pole.state.copy()
            self.steps[done] = 0
        info = {"final_obs": final, "done": done}
        return obs, rewards, terminated, truncated, info


_MA_REGISTRY: Dict[str, Callable] = {}


def register_multi_agent_env(name: str, creator: Callable) -> None:
    """reference: tune.register_env with a MultiAgentEnv creator."""
    _MA_REGISTRY[name] = creator


def make_multi_agent_env(name: str, num_envs: int,
                         seed: int = 0) -> MultiAgentVectorEnv:
    if name not in _MA_REGISTRY:
        raise ValueError(f"unknown multi-agent env {name!r}; "
                         f"registered: {sorted(_MA_REGISTRY)}")
    return _MA_REGISTRY[name](num_envs=num_envs, seed=seed)


register_multi_agent_env(
    "MultiCartPole",
    lambda num_envs, seed=0: MultiCartPole(num_envs, num_agents=2, seed=seed))


class MultiAgentEnvRunner:
    """Samples PPO-shaped fragments per POLICY from a multi-agent env.

    reference: rllib/env/multi_agent_env_runner.py (sample keyed by module
    id).  Agents mapped to the same policy are concatenated as extra env
    columns, so each policy's batch is the exact (T, K', ...) layout the
    single-agent TorchLearner consumes — per-policy GAE included.
    """

    def __init__(self, env_name: str, num_envs: int, rollout_length: int,
                 policy_specs: Dict[str, Dict],
                 policy_mapping_fn: Callable[[str], str], seed: int = 0):
        from ray_tpu_torch.rllib.core.rl_module import DiscretePolicyModule
        from ray_tpu_torch.rllib.env.env_runner import host_program

        host_program()
        self.env = make_multi_agent_env(env_name, num_envs, seed=seed)
        self.num_envs = num_envs
        self.rollout_length = rollout_length
        self.policy_mapping_fn = policy_mapping_fn
        self.modules = {pid: DiscretePolicyModule(**spec)
                        for pid, spec in policy_specs.items()}
        self._agent_policy = {a: policy_mapping_fn(a)
                              for a in self.env.agents}
        for a, pid in self._agent_policy.items():
            if pid not in self.modules:
                raise ValueError(
                    f"agent {a!r} maps to unknown policy {pid!r}")
        self._gen = torch.Generator().manual_seed(seed)
        self.obs = self.env.reset()
        self._ep_return = np.zeros(num_envs, np.float32)
        self._recent_returns: collections.deque = collections.deque(maxlen=100)
        self._lifetime_steps = 0

    def _value(self, pid: str, obs) -> np.ndarray:
        with torch.no_grad():
            return self.modules[pid].value(torch.from_numpy(
                np.asarray(obs, np.float32))).numpy()

    def sample(self, weights: Optional[Dict[str, object]] = None
               ) -> Dict[str, Dict[str, np.ndarray]]:
        if weights is not None:
            for pid, state in weights.items():
                self.modules[pid].load_state(state)
        T, K = self.rollout_length, self.num_envs
        A = self.env.agents
        per_agent = {a: {
            "obs": np.empty((T, K, self.env.observation_sizes[a]), np.float32),
            "actions": np.empty((T, K), np.int32),
            "logp": np.empty((T, K), np.float32),
            "values": np.empty((T, K), np.float32),
            "rewards": np.empty((T, K), np.float32),
            "terminated": np.empty((T, K), bool),
            "truncated": np.empty((T, K), bool),
            "final_obs": np.empty((T, K, self.env.observation_sizes[a]),
                                  np.float32),
        } for a in A}
        for t in range(T):
            actions = {}
            for a in A:
                pid = self._agent_policy[a]
                with torch.no_grad():
                    acts, logp, values = self.modules[pid] \
                        .forward_exploration(torch.from_numpy(
                            np.asarray(self.obs[a], np.float32)), self._gen)
                actions[a] = acts.numpy()
                per_agent[a]["obs"][t] = self.obs[a]
                per_agent[a]["actions"][t] = actions[a]
                per_agent[a]["logp"][t] = logp.numpy()
                per_agent[a]["values"][t] = values.numpy()
            obs, rewards, terminated, truncated, info = self.env.step(actions)
            for a in A:
                per_agent[a]["rewards"][t] = rewards[a]
                per_agent[a]["terminated"][t] = terminated[a]
                per_agent[a]["truncated"][t] = truncated[a]
                per_agent[a]["final_obs"][t] = info["final_obs"][a]
                self._ep_return += rewards[a] / len(A)
            for i in np.nonzero(info["done"])[0]:
                self._recent_returns.append(float(self._ep_return[i]))
                self._ep_return[i] = 0.0
            self.obs = obs
        self._lifetime_steps += T * K  # env steps, not agent-steps

        # bootstrap per agent column, then group columns by policy
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for a in A:
            pid = self._agent_policy[a]
            b = per_agent[a]
            tail = self._value(pid, self.obs[a])
            nv = np.concatenate([b["values"][1:], tail[None]], axis=0)
            nv[b["terminated"]] = 0.0
            if b["truncated"].any():
                tr = np.nonzero(b["truncated"])
                vf = self._value(
                    pid, b["final_obs"].reshape(T * K, -1)).reshape(T, K)
                nv[tr] = vf[tr]
            b["next_values"] = nv.astype(np.float32)
            del b["final_obs"]
            grp = out.setdefault(pid, {})
            for k, v in b.items():
                grp.setdefault(k, []).append(v)
        return {pid: {k: np.concatenate(vs, axis=1)
                      for k, vs in grp.items()}
                for pid, grp in out.items()}

    def get_metrics(self) -> Dict:
        return {
            "episode_return_mean": (float(np.mean(self._recent_returns))
                                    if self._recent_returns else float("nan")),
            "num_episodes": len(self._recent_returns),
            "num_env_steps_sampled_lifetime": self._lifetime_steps,
        }

    def ping(self) -> bool:
        return True
