"""Generalized Advantage Estimation as parallel scans, in torch ops.

Port of ``ray_tpu/ops/gae.py``.  The backward recurrence
A_t = δ_t + γλ(1-done_t) A_{t+1} is a first-order linear recurrence.  The
JAX package solves it with ``jax.lax.associative_scan`` (``:27-32``); here
it is a log-depth doubling (Hillis-Steele) scan: ceil(log2 T) rounds of
``_linrec_combine`` over the flipped arrays, each round a few elementwise
ops over the whole (T, ...) array.  So a scan on the card is a handful of
launches a round, never a serial T-step loop, and a ``done`` (c_t = 0)
needs no division.  No hand kernel is written for it: the JAX package's
scan is XLA, not Pallas.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _linrec_combine(a, b):
    """Combine for y_t = c_t * y_{t+1} + d_t (scanned right-to-left): ``a``
    holds the later steps, ``b`` the earlier ones."""
    c_a, d_a = a
    c_b, d_b = b
    return c_a * c_b, d_b + c_b * d_a


def _reverse_linrec(c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Solve y_t = c_t * y_{t+1} + d_t (y_T = 0) along axis 0: an inclusive
    scan of ``_linrec_combine`` over the flipped arrays by doubling, round
    k combining each position with the one 2^k before it."""
    c = torch.flip(c, (0,))
    d = torch.flip(d, (0,))
    n = c.shape[0]
    off = 1
    while off < n:
        c_new, d_new = _linrec_combine((c[:-off], d[:-off]),
                                       (c[off:], d[off:]))
        c = torch.cat([c[:off], c_new], 0)
        d = torch.cat([d[:off], d_new], 0)
        off *= 2
    return torch.flip(d, (0,))


def discounted_returns(rewards: torch.Tensor, dones: torch.Tensor,
                       gamma: float,
                       bootstrap_value: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """R_t = r_t + γ(1-done_t) R_{t+1}; rewards/dones: (T,) or (T, B)."""
    cont = gamma * (1.0 - dones.to(rewards.dtype))
    d = rewards
    if bootstrap_value is not None:
        d = rewards.clone()
        d[-1] = d[-1] + cont[-1] * bootstrap_value
    return _reverse_linrec(cont, d)


def gae_advantages(rewards: torch.Tensor, values: torch.Tensor,
                   dones: torch.Tensor, gamma: float = 0.99,
                   gae_lambda: float = 0.95,
                   bootstrap_value: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE advantages + value targets.

    rewards/dones: (T,) or (T, B); values: same shape (V(s_t));
    bootstrap_value: V(s_T) for the state after the last step (0 if None).
    Returns (advantages, value_targets) with targets = advantages + values.
    """
    if bootstrap_value is None:
        bootstrap_value = torch.zeros_like(values[-1])
    next_values = torch.cat([values[1:], bootstrap_value[None]], 0)
    not_done = 1.0 - dones.to(values.dtype)
    deltas = rewards + gamma * not_done * next_values - values
    adv = _reverse_linrec(gamma * gae_lambda * not_done, deltas)
    return adv, adv + values


def gae_from_fragments(rewards: torch.Tensor, values: torch.Tensor,
                       next_values: torch.Tensor, dones: torch.Tensor,
                       gamma: float = 0.99, gae_lambda: float = 0.95
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over fixed-length rollout fragments with auto-reset envs.

    The caller supplies ``next_values`` — V(s_{t+1}), 0 at terminations and
    V(final pre-reset obs) at truncations — so the scan is right across
    episode boundaries inside a fragment; dones = terminated | truncated
    stops advantage propagation across the boundary.  All inputs (T,) or
    (T, K).
    """
    not_done = 1.0 - dones.to(values.dtype)
    deltas = rewards + gamma * next_values - values
    adv = _reverse_linrec(gamma * gae_lambda * not_done, deltas)
    return adv, adv + values
