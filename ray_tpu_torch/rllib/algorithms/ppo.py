"""Port of ``ray_tpu/rllib/algorithms/ppo.py``.

PPO on the new-stack shapes: EnvRunner actors → TorchLearner → weight sync.

Counterpart of the reference's PPO (reference: rllib/algorithms/ppo/ppo.py:67
PPOConfig, :427 training_step: synchronous_parallel_sample →
learner_group.update → env_runner_group.sync_weights :525).  The loss/GAE
math lives in the learner (core/learner.py); this module is the
orchestration: parallel sampling on actor env-runners, one device update,
broadcast weights through the object store.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import LearnerGroup
from ray_tpu_torch.rllib.env.env_runner import EnvRunner


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.training_params = {
            "lr": 3e-4,
            "gamma": 0.99,
            "gae_lambda": 0.95,
            "clip_param": 0.2,
            "vf_loss_coeff": 0.5,
            "vf_clip_param": 10.0,
            "entropy_coeff": 0.0,
            "num_epochs": 6,
            "minibatch_size": 256,
            "grad_clip": 0.5,
        }

    @property
    def algo_class(self):
        return PPO


class PPO(Algorithm):
    def setup(self, config: PPOConfig) -> None:
        from ray_tpu_torch.rllib.algorithms.algorithm import (build_module_spec,
                                                        build_runner_actors)

        if config.policies:
            self._setup_multi_agent(config)
            return
        self._multi = False
        self._module_spec = build_module_spec(config)
        self.learner_group = LearnerGroup(
            self._module_spec, config.training_params,
            num_learners=config.num_learners, seed=config.seed,
            device=config.learner_device,
            num_gpus_per_learner=config.num_gpus_per_learner)

        self._local_runner = None
        self._runner_actors = []
        runner_kwargs = dict(
            env_name=config.env,
            num_envs=config.num_envs_per_env_runner,
            rollout_length=config.rollout_fragment_length,
            module_spec=self._module_spec,
            seed=config.seed)
        if config.num_env_runners <= 0:
            self._local_runner = EnvRunner(**runner_kwargs)
        else:
            self._runner_actors = build_runner_actors(
                config, EnvRunner, runner_kwargs)

    # ------------------------------------------------- multi-agent setup
    def _setup_multi_agent(self, config: PPOConfig) -> None:
        """Per-policy learners over a multi-agent runner (reference: PPO's
        multi-agent training_step updating each module id's learner;
        rllib/env/multi_agent_env_runner.py).  Agents sharing a policy are
        extra env columns, so each policy reuses the single-agent learner."""
        from ray_tpu_torch.rllib.env.multi_agent import (MultiAgentEnvRunner,
                                                   make_multi_agent_env)

        self._multi = True
        probe = make_multi_agent_env(config.env, 1, seed=0)
        specs = {}
        for a in probe.agents:
            pid = config.policy_mapping_fn(a)
            spec = {"observation_size": probe.observation_sizes[a],
                    "num_actions": probe.num_actions[a],
                    "hidden": tuple(config.model.get("hidden", (64, 64)))}
            if pid in specs and specs[pid] != spec:
                raise ValueError(
                    f"agents sharing policy {pid!r} have different spaces")
            specs[pid] = spec
        unknown = set(specs) - set(config.policies)
        if unknown:
            raise ValueError(
                f"policy_mapping_fn produced unknown policies {unknown}; "
                f"declared: {config.policies}")
        unmapped = set(config.policies) - set(specs)
        if unmapped:
            raise ValueError(
                f"declared policies {sorted(unmapped)} are mapped to no "
                f"agent (typo in policy_mapping_fn?)")
        self._policy_specs = specs
        self.learner_groups = {
            pid: LearnerGroup(spec, config.training_params,
                              num_learners=config.num_learners,
                              seed=config.seed + i,
                              device=config.learner_device,
                              num_gpus_per_learner=(
                                  config.num_gpus_per_learner))
            for i, (pid, spec) in enumerate(sorted(specs.items()))}
        self._runner_actors = []
        runner_kwargs = dict(
            env_name=config.env, num_envs=config.num_envs_per_env_runner,
            rollout_length=config.rollout_fragment_length,
            policy_specs=specs,
            policy_mapping_fn=config.policy_mapping_fn, seed=config.seed)
        if config.num_env_runners <= 0:
            self._local_runner = MultiAgentEnvRunner(**runner_kwargs)
        else:
            from ray_tpu_torch.rllib.algorithms.algorithm import build_runner_actors

            self._local_runner = None
            self._runner_actors = build_runner_actors(
                config, MultiAgentEnvRunner, runner_kwargs)

    def _training_step_multi(self) -> Dict[str, Any]:
        import ray_tpu_torch

        weights = {pid: g.get_weights()
                   for pid, g in self.learner_groups.items()}
        if self._local_runner is not None:
            by_policy = [self._local_runner.sample(weights)]
            metrics = [self._local_runner.get_metrics()]
        else:
            wref = ray_tpu_torch.put(weights)
            by_policy = ray_tpu_torch.get(
                [r.sample.remote(wref) for r in self._runner_actors])
            metrics = ray_tpu_torch.get(
                [r.get_metrics.remote() for r in self._runner_actors])
        stats = {}
        for pid, group in self.learner_groups.items():
            batch = {k: np.concatenate([b[pid][k] for b in by_policy], axis=1)
                     for k in by_policy[0][pid]}
            for k, v in group.update(batch).items():
                stats[f"learner/{pid}/{k}"] = v
        returns = [m["episode_return_mean"] for m in metrics
                   if np.isfinite(m["episode_return_mean"])]
        return {
            "episode_return_mean": float(np.mean(returns)) if returns
            else float("nan"),
            "num_env_steps_sampled_lifetime": int(
                sum(m["num_env_steps_sampled_lifetime"] for m in metrics)),
            "num_episodes": int(sum(m["num_episodes"] for m in metrics)),
            **stats,
        }

    # ------------------------------------------------------------ one iter
    def training_step(self) -> Dict[str, Any]:
        if self._multi:
            return self._training_step_multi()
        weights = self.learner_group.get_weights()

        if self._local_runner is not None:
            batches = [self._local_runner.sample(weights)]
            metrics = [self._local_runner.get_metrics()]
        else:
            import ray_tpu_torch

            # ship weights once via the object store; every runner borrows
            # the same copy (reference: sync_weights broadcast, ppo.py:525)
            wref = ray_tpu_torch.put(weights)
            batches = ray_tpu_torch.get(
                [r.sample.remote(wref) for r in self._runner_actors])
            metrics = ray_tpu_torch.get(
                [r.get_metrics.remote() for r in self._runner_actors])

        batch = {k: np.concatenate([b[k] for b in batches], axis=1)
                 for k in batches[0]}
        stats = self.learner_group.update(batch)

        returns = [m["episode_return_mean"] for m in metrics
                   if np.isfinite(m["episode_return_mean"])]
        return {
            "episode_return_mean": float(np.mean(returns)) if returns
            else float("nan"),
            "num_env_steps_sampled_lifetime": int(
                sum(m["num_env_steps_sampled_lifetime"] for m in metrics)),
            "num_episodes": int(sum(m["num_episodes"] for m in metrics)),
            **{f"learner/{k}": v for k, v in stats.items()},
        }

    def stop(self) -> None:
        import ray_tpu_torch

        if getattr(self, "_multi", False):
            for g in self.learner_groups.values():
                g.shutdown()
        else:
            self.learner_group.shutdown()
        for r in self._runner_actors:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self._runner_actors = []
