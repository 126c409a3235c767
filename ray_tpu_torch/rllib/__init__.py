"""Port of ``ray_tpu/rllib/__init__.py``.

ray_tpu_torch.rllib: reinforcement learning on the actor runtime.

Counterpart of the reference's RLlib new API stack (reference: rllib/ —
EnvRunner actors sample on CPU, a torch Learner updates on the card, the
Algorithm is the Tune-trainable driver loop).
"""

from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import DQN, DQNConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALA, IMPALAConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.algorithms.sac import SAC, SACConfig
from ray_tpu_torch.rllib.offline import BC, BCConfig, MARWIL, MARWILConfig
from ray_tpu_torch.rllib.podracer import (FragmentStream, InferencePool,
                                    LearnerGang, PodracerLearner,
                                    WeightMailbox)

__all__ = ["Algorithm", "AlgorithmConfig", "BC", "BCConfig",
           "DQN", "DQNConfig", "FragmentStream", "IMPALA", "IMPALAConfig",
           "InferencePool", "LearnerGang", "MARWIL", "MARWILConfig",
           "PPO", "PPOConfig", "PodracerLearner", "SAC", "SACConfig",
           "WeightMailbox"]
