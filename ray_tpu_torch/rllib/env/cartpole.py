"""Port of ``ray_tpu/rllib/env/cartpole.py``.

Native vectorized CartPole-v1 (no gym in the TPU image).

Standard cart-pole physics (Barto, Sutton & Anderson 1983; identical
constants/termination/reward semantics to Gymnasium's CartPole-v1 so the
BASELINE "return >= 350 within 200k steps" row is comparable): reward 1 per
step, termination at |x| > 2.4 or |theta| > 12 deg, truncation at 500 steps,
Euler integration with tau = 0.02.

Vectorized over K envs in numpy with auto-reset — env stepping stays on the
CPU actor (SURVEY §3.5: EnvRunners stay on CPU; the Learner is the device
program).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class CartPoleVectorEnv:
    observation_size = 4
    num_actions = 2
    max_episode_steps = 500

    GRAVITY = 9.8
    MASSCART = 1.0
    MASSPOLE = 0.1
    TOTAL_MASS = MASSCART + MASSPOLE
    LENGTH = 0.5  # half pole length
    POLEMASS_LENGTH = MASSPOLE * LENGTH
    FORCE_MAG = 10.0
    TAU = 0.02
    X_THRESHOLD = 2.4
    THETA_THRESHOLD = 12 * 2 * np.pi / 360

    def __init__(self, num_envs: int, seed: int = 0):
        self.num_envs = num_envs
        self._rng = np.random.default_rng(seed)
        self.state = np.zeros((num_envs, 4), np.float32)
        self.steps = np.zeros(num_envs, np.int32)
        self.reset()

    def _sample_state(self, n: int) -> np.ndarray:
        return self._rng.uniform(-0.05, 0.05, (n, 4)).astype(np.float32)

    def reset(self) -> np.ndarray:
        self.state = self._sample_state(self.num_envs)
        self.steps[:] = 0
        return self.state.copy()

    def step(self, actions: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, dict]:
        """actions: (K,) in {0,1}.  Returns (obs, rewards, terminated,
        truncated, info); terminated/truncated envs are auto-reset — the
        returned obs is the FIRST obs of the next episode for those slots.
        info["final_obs"] holds the true pre-reset observation (valid at done
        slots), which time-limit bootstrapping needs at truncations."""
        x, x_dot, theta, theta_dot = self.state.T
        force = np.where(actions == 1, self.FORCE_MAG, -self.FORCE_MAG)
        costheta = np.cos(theta)
        sintheta = np.sin(theta)
        temp = (force + self.POLEMASS_LENGTH * theta_dot**2 * sintheta) \
            / self.TOTAL_MASS
        thetaacc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.LENGTH * (4.0 / 3.0
                           - self.MASSPOLE * costheta**2 / self.TOTAL_MASS))
        xacc = temp - self.POLEMASS_LENGTH * thetaacc * costheta \
            / self.TOTAL_MASS
        x = x + self.TAU * x_dot
        x_dot = x_dot + self.TAU * xacc
        theta = theta + self.TAU * theta_dot
        theta_dot = theta_dot + self.TAU * thetaacc
        self.state = np.stack([x, x_dot, theta, theta_dot], axis=1) \
            .astype(np.float32)
        self.steps += 1

        terminated = (np.abs(x) > self.X_THRESHOLD) \
            | (np.abs(theta) > self.THETA_THRESHOLD)
        truncated = (self.steps >= self.max_episode_steps) & ~terminated
        rewards = np.ones(self.num_envs, np.float32)

        done = terminated | truncated
        final_obs = self.state.copy()
        if done.any():
            self.state[done] = self._sample_state(int(done.sum()))
            self.steps[done] = 0
        return (self.state.copy(), rewards, terminated, truncated,
                {"final_obs": final_obs})
