"""Port of ``ray_tpu/rllib/env/pendulum.py``.

Native vectorized Pendulum-v1 (no gym in the TPU image).

Standard underactuated pendulum swing-up (identical constants/reward to
Gymnasium's Pendulum-v1 so published SAC learning curves are comparable):
obs = (cos th, sin th, thdot), action = torque in [-2, 2],
reward = -(angle^2 + 0.1*thdot^2 + 0.001*a^2), truncation at 200 steps,
no termination.  Vectorized over K envs in numpy with auto-reset — env
stepping stays on the CPU actor (SURVEY §3.5: EnvRunners stay on CPU; the
Learner is the device program).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class PendulumVectorEnv:
    observation_size = 3
    action_size = 1
    max_action = 2.0
    max_episode_steps = 200
    continuous = True

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0

    def __init__(self, num_envs: int, seed: int = 0):
        self.num_envs = num_envs
        self._rng = np.random.default_rng(seed)
        self.th = np.zeros(num_envs, np.float32)
        self.thdot = np.zeros(num_envs, np.float32)
        self.steps = np.zeros(num_envs, np.int32)
        self.reset()

    def _obs(self) -> np.ndarray:
        return np.stack([np.cos(self.th), np.sin(self.th), self.thdot],
                        axis=1).astype(np.float32)

    def _sample(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        th = self._rng.uniform(-np.pi, np.pi, n).astype(np.float32)
        thdot = self._rng.uniform(-1.0, 1.0, n).astype(np.float32)
        return th, thdot

    def reset(self) -> np.ndarray:
        self.th, self.thdot = self._sample(self.num_envs)
        self.steps[:] = 0
        return self._obs()

    def step(self, actions: np.ndarray):
        """actions: (K,) or (K,1) torque.  Auto-resets truncated envs; the
        returned obs is the next episode's first obs at done slots, with
        info["final_obs"] carrying the true pre-reset observation."""
        a = np.clip(np.asarray(actions, np.float32).reshape(self.num_envs),
                    -self.MAX_TORQUE, self.MAX_TORQUE)
        th, thdot = self.th, self.thdot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        reward = -(norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * a ** 2)

        newthdot = thdot + (3.0 * self.G / (2.0 * self.L) * np.sin(th)
                            + 3.0 / (self.M * self.L ** 2) * a) * self.DT
        newthdot = np.clip(newthdot, -self.MAX_SPEED, self.MAX_SPEED)
        newth = th + newthdot * self.DT
        self.th, self.thdot = newth.astype(np.float32), \
            newthdot.astype(np.float32)
        self.steps += 1

        terminated = np.zeros(self.num_envs, bool)
        truncated = self.steps >= self.max_episode_steps
        final_obs = self._obs()
        if truncated.any():
            n = int(truncated.sum())
            th_new, thdot_new = self._sample(n)
            self.th[truncated] = th_new
            self.thdot[truncated] = thdot_new
            self.steps[truncated] = 0
        return (self._obs(), reward.astype(np.float32), terminated,
                truncated, {"final_obs": final_obs})
