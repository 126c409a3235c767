"""EnvRunner: CPU actor that samples fixed-length rollout fragments.

Port of ``ray_tpu/rllib/env/env_runner.py``.  Counterpart of the
reference's SingleAgentEnvRunner (reference:
rllib/env/single_agent_env_runner.py:131 sample; EnvRunnerGroup
rllib/env/env_runner_group.py:71).  Each runner owns K vectorized envs and a
copy of the policy; ``sample()`` returns time-major arrays (T, K, ...) plus
the value bootstrap for each fragment tail, ready for the Learner's GAE
scan.

Rollouts are a host program: the runner's module lives on the CPU by
design (the JAX runner pins itself to the CPU backend, ``:62-64``), and
nothing in it touches CUDA, even where the process can see a card.  Its
draws come from a seeded ``torch.Generator``; in an actor, which holds one
CPU, torch runs one intra-op thread.

Podracer extensions (rllib/podracer/):

- ``run_stream(n)`` is the continuous sample loop: a
  ``num_returns="streaming"`` generator that seals each fragment into
  plasma as it is produced, polling the job's weight mailbox between
  fragments so no weight state ever rides a task argument;
- with an ``inference`` pool handle the runner is a *Sebulba* actor: it
  performs ZERO local forward passes — every action, logp and bootstrap
  value comes from the pool's batched forwards (the runner sends an int64
  seed with each call for the pool's draw), and fragments carry the policy
  version the pool stamped on the responses.
"""

from __future__ import annotations

import collections
import time
from typing import Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.core.rl_module import (DiscretePolicyModule,
                                                process_facts)
from ray_tpu_torch.rllib.env import make_vector_env


def host_program() -> None:
    """A runner or pool actor holds one CPU: one intra-op thread for
    torch's CPU ops in a worker process.  In the driver's own process
    nothing changes."""
    from ray_tpu_torch._private import worker as worker_mod

    core = worker_mod.global_worker_core()
    if core is not None and core.mode == "worker":
        torch.set_num_threads(1)


class EnvRunner:
    def __init__(self, env_name: str, num_envs: int, rollout_length: int,
                 module_spec: Dict, seed: int = 0, job: str = "",
                 runner_idx: int = 0, inference=None):
        host_program()
        self.env = make_vector_env(env_name, num_envs, seed=seed)
        self.num_envs = num_envs
        self.rollout_length = rollout_length
        # the weights come from set_weights or the mailbox
        self.module = DiscretePolicyModule(**module_spec)
        self._has_weights = False
        self._gen = torch.Generator().manual_seed(seed)
        self.obs = self.env.reset()
        self.job = job
        self.runner_idx = runner_idx
        self._pool = inference
        self._version = 0
        self._local_forwards = 0  # Sebulba contract: stays 0 with a pool
        self._mailbox = None
        if job and inference is None:
            from ray_tpu_torch.rllib.podracer.weights import WeightMailbox

            self._mailbox = WeightMailbox(job)
        # episode-return bookkeeping (reference: metrics on the EnvRunner)
        self._ep_return = np.zeros(num_envs, np.float32)
        self._recent_returns: collections.deque = collections.deque(maxlen=100)
        self._lifetime_steps = 0
        # the host time of sample(), weights' load included
        self._sample_s = 0.0
        self._fragments = 0

    def set_weights(self, state, version: int = 0) -> None:
        self.module.load_state(state)
        self._has_weights = True
        self._version = int(version)

    # ------------------------------------------------------------ policy
    def _poll_weights(self) -> None:
        if self._mailbox is not None:
            v, state = self._mailbox.poll()
            if state is not None:
                self.module.load_state(state)
                self._has_weights, self._version = True, v

    def _pool_act(self, obs):
        import ray_tpu_torch

        # the pool draws the actions from an int64 seed of this runner's
        seed = int(torch.randint(0, 2 ** 62, (), generator=self._gen))
        actions, logp, values, version = ray_tpu_torch.get(
            self._pool.act.remote(np.asarray(obs, np.float32), seed),
            timeout=120)
        self._version = int(version)
        return actions, logp, values

    def _values_of(self, obs) -> np.ndarray:
        """Bootstrap values — pooled in Sebulba mode (the runner never
        touches the value net locally either)."""
        if self._pool is not None:
            _, _, values = self._pool_act(obs)
            return np.asarray(values)
        self._local_forwards += 1
        with torch.no_grad():
            return self.module.value(torch.from_numpy(
                np.asarray(obs, np.float32))).numpy()

    def _explore(self, obs):
        self._local_forwards += 1
        with torch.no_grad():
            actions, logp, values = self.module.forward_exploration(
                torch.from_numpy(np.asarray(obs, np.float32)), self._gen)
        return actions.numpy(), logp.numpy(), values.numpy()

    def _chaos_tick(self) -> None:
        from ray_tpu_torch._private import fault_injection

        if fault_injection.ENABLED:
            action = fault_injection.hit(
                "rllib.sample", f"runner{self.runner_idx}")
            if action == "kill":
                fault_injection.kill_self()

    # ------------------------------------------------------------ sample
    def sample(self, weights=None) -> Dict[str, np.ndarray]:
        """One fragment of rollout_length steps across all K envs."""
        t0 = time.perf_counter()
        self._chaos_tick()
        if weights is not None:
            self.module.load_state(weights)
            self._has_weights = True
        elif self._mailbox is not None:
            # every fragment starts with a version check: one cheap KV
            # read; the weight payload only transfers on a version change
            self._poll_weights()
        if self._pool is None:
            assert self._has_weights, "set_weights before sample"
        T, K = self.rollout_length, self.num_envs
        out = {
            "obs": np.empty((T, K, self.env.observation_size), np.float32),
            "actions": np.empty((T, K), np.int32),
            "logp": np.empty((T, K), np.float32),
            "values": np.empty((T, K), np.float32),
            "rewards": np.empty((T, K), np.float32),
            "terminated": np.empty((T, K), bool),
            "truncated": np.empty((T, K), bool),
        }
        final_obs = np.empty((T, K, self.env.observation_size), np.float32)
        for t in range(T):
            if self._pool is not None:
                actions, logp, values = self._pool_act(self.obs)
            else:
                actions, logp, values = self._explore(self.obs)
            actions = np.asarray(actions)
            out["obs"][t] = self.obs
            out["actions"][t] = actions
            out["logp"][t] = np.asarray(logp)
            out["values"][t] = np.asarray(values)
            next_obs, rewards, terminated, truncated, info = \
                self.env.step(actions)
            out["rewards"][t] = rewards
            out["terminated"][t] = terminated
            out["truncated"][t] = truncated
            final_obs[t] = info["final_obs"]

            self._ep_return += rewards
            for i in np.nonzero(terminated | truncated)[0]:
                self._recent_returns.append(float(self._ep_return[i]))
                self._ep_return[i] = 0.0
            self.obs = next_obs
        self._lifetime_steps += T * K
        from ray_tpu_torch.rllib._metrics import rllib_metrics

        rllib_metrics()["env_steps"].inc(
            T * K, {"job": self.job or "default"})

        # next_values[t] = V of the TRUE successor state: values[t+1] inside
        # an episode, V(obs after the fragment) at the tail, 0 at termination,
        # V(pre-reset final obs) at truncation (time-limit bootstrapping —
        # truncation is not failure, the episode just stopped being observed).
        tail_value = self._values_of(self.obs)
        next_values = np.concatenate(
            [out["values"][1:], tail_value[None]], axis=0)
        next_values[out["terminated"]] = 0.0
        if out["truncated"].any():
            # evaluate on the full fixed (T*K, obs) shape and index after,
            # as the JAX runner does for its jit
            tr = np.nonzero(out["truncated"])
            v_final = self._values_of(
                final_obs.reshape(T * K, -1)).reshape(T, K)
            next_values[tr] = v_final[tr]
        out["next_values"] = next_values.astype(np.float32)
        self._sample_s += time.perf_counter() - t0
        self._fragments += 1
        return out

    # ----------------------------------------------------------- streaming
    def run_stream(self, num_fragments: int):
        """Continuous sample loop (declare ``num_returns="streaming"`` at
        the call site / via method meta): each yielded fragment is sealed
        into plasma immediately, and the weight mailbox is polled between
        fragments — the driver never relaunches per fragment and never
        ships weights as arguments."""
        for _ in range(int(num_fragments)):
            batch = self.sample()  # polls the weight mailbox itself
            yield {
                "batch": batch,
                "policy_version": int(self._version),
                "runner_idx": self.runner_idx,
                "episode_return_mean": (
                    float(np.mean(self._recent_returns))
                    if self._recent_returns else float("nan")),
                "num_episodes": len(self._recent_returns),
                "lifetime_steps": self._lifetime_steps,
            }

    run_stream.__ray_method_options__ = {"num_returns": "streaming"}

    def get_metrics(self) -> Dict:
        return {
            "episode_return_mean": (float(np.mean(self._recent_returns))
                                    if self._recent_returns else float("nan")),
            "num_episodes": len(self._recent_returns),
            "num_env_steps_sampled_lifetime": self._lifetime_steps,
        }

    def get_debug(self) -> Dict:
        """The runner's counters, and the facts of its process (``cuda_
        initialized`` must stay False: rollouts never touch the card)."""
        return {"local_forwards": self._local_forwards,
                "policy_version": self._version,
                "lifetime_steps": self._lifetime_steps,
                "fragments": self._fragments, "sample_s": self._sample_s,
                "torch_threads": torch.get_num_threads(),
                **process_facts()}

    def ping(self) -> bool:
        return True
