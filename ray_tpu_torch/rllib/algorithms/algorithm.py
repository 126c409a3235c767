"""Port of ``ray_tpu/rllib/algorithms/algorithm.py``.

Algorithm + AlgorithmConfig: the RL driver loop.

Counterpart of the reference's Algorithm (reference:
rllib/algorithms/algorithm.py:227 — a Tune Trainable whose ``train()`` runs
one ``training_step`` and aggregates metrics; fluent AlgorithmConfig
rllib/algorithms/algorithm_config.py).
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Optional


class AlgorithmConfig:
    """Fluent config (reference: rllib/algorithms/algorithm_config.py).

    cfg = (PPOConfig().environment("CartPole-v1")
           .env_runners(num_env_runners=2).training(lr=3e-4))
    """

    def __init__(self):
        self.env: Optional[str] = None
        self.num_env_runners: int = 0
        self.num_envs_per_env_runner: int = 8
        self.rollout_fragment_length: int = 64
        self.num_learners: int = 0
        self.learner_device: Optional[str] = None
        self.num_gpus_per_learner: float = 1
        self.seed: int = 0
        self.model: Dict[str, Any] = {"hidden": (64, 64)}
        self.training_params: Dict[str, Any] = {}
        # multi-agent (empty = single-agent)
        self.policies: list = []
        self.policy_mapping_fn = lambda agent_id: agent_id

    # ------------------------------------------------------ fluent setters
    def environment(self, env: str) -> "AlgorithmConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    num_envs_per_env_runner: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "AlgorithmConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if num_envs_per_env_runner is not None:
            self.num_envs_per_env_runner = num_envs_per_env_runner
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def learners(self, *, num_learners: Optional[int] = None,
                 device: Optional[str] = None,
                 num_gpus_per_learner: Optional[float] = None
                 ) -> "AlgorithmConfig":
        """``device``: None (the card) or ``"cpu"``.  A learner actor on
        the card asks ``num_gpus_per_learner`` (default 1; a share
        0 < x < 1 is allowed, since a gang folds its gradients over the
        host ring, not in a torch.distributed group)."""
        if num_learners is not None:
            self.num_learners = num_learners
        if device is not None:
            self.learner_device = device
        if num_gpus_per_learner is not None:
            if num_gpus_per_learner <= 0:
                raise ValueError("num_gpus_per_learner must be > 0")
            self.num_gpus_per_learner = num_gpus_per_learner
        return self

    def training(self, **params) -> "AlgorithmConfig":
        self.training_params.update(params)
        return self

    def multi_agent(self, *, policies=None, policy_mapping_fn=None
                    ) -> "AlgorithmConfig":
        """Per-agent policy mapping (reference:
        algorithm_config.py multi_agent() — policies + policy_mapping_fn).
        ``policies`` is an iterable of policy ids; ``policy_mapping_fn``
        maps agent_id -> policy id (default: identity)."""
        if policies is not None:
            self.policies = list(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def build(self) -> "Algorithm":
        if self.env is None:
            raise ValueError("config.environment(env_name) is required")
        return self.algo_class(self)

    @property
    def algo_class(self):
        raise NotImplementedError


def build_module_spec(config: "AlgorithmConfig") -> Dict[str, Any]:
    """Probe the env once and derive the policy-module spec (shared by every
    algorithm; reference: catalog/module-spec derivation)."""
    from ray_tpu_torch.rllib.env import make_vector_env

    probe = make_vector_env(config.env, 1, seed=0)
    return {
        "observation_size": probe.observation_size,
        "num_actions": probe.num_actions,
        "hidden": tuple(config.model.get("hidden", (64, 64))),
    }


def build_runner_actors(config: "AlgorithmConfig", runner_cls,
                        runner_kwargs: Dict[str, Any],
                        index_key: Optional[str] = None) -> list:
    """Spawn a runner actor gang of any runner class (reference:
    EnvRunnerGroup) — one CPU each, per-runner decorrelated seeds.  With
    ``index_key`` each runner also receives its gang index under that
    kwarg (streaming consumers and chaos points address runners by it)."""
    import ray_tpu_torch

    remote_cls = ray_tpu_torch.remote(runner_cls)
    out = []
    for i in range(config.num_env_runners):
        kw = {**runner_kwargs,
              "seed": runner_kwargs.get("seed", 0) + 1000 * (i + 1)}
        if index_key is not None:
            kw[index_key] = i
        out.append(remote_cls.options(num_cpus=1).remote(**kw))
    return out


class Algorithm:
    """reference: rllib/algorithms/algorithm.py:227 (step :896)."""

    def __init__(self, config: AlgorithmConfig):
        self.config = config
        self.iteration = 0
        self._start_time = time.monotonic()
        self.setup(config)

    # subclasses override
    def setup(self, config: AlgorithmConfig) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        """One training iteration (reference: Trainable.train → step :896)."""
        self.iteration += 1
        results = self.training_step()
        results.setdefault("training_iteration", self.iteration)
        results.setdefault("time_total_s",
                           time.monotonic() - self._start_time)
        return results

    def stop(self) -> None:
        pass
