"""V-trace off-policy correction as a parallel scan, in torch ops.

Port of ``ray_tpu/ops/vtrace.py``.  Actors sample with stale behavior
policies; the learner corrects with clipped importance ratios.  The
correction ``vs_t - V_t = delta_t + gamma c_t (1-done_t)(vs_{t+1} -
V_{t+1})`` is a first-order linear recurrence, solved by the doubling scan
of ``ops/gae.py``.

Fragment conventions match the EnvRunner: time-major (T, K) tensors;
``next_values`` is the value of the TRUE successor state (0 at
termination, V(final_obs) at truncation), so the recurrence only needs the
(1 - done) cut.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ray_tpu_torch.ops.gae import _reverse_linrec


def vtrace_from_fragments(behavior_logp: torch.Tensor,
                          target_logp: torch.Tensor, rewards: torch.Tensor,
                          values: torch.Tensor, next_values: torch.Tensor,
                          dones: torch.Tensor, gamma: float,
                          rho_clip: float = 1.0, c_clip: float = 1.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (vs, pg_advantages), both (T, K); call it with detached
    target log-probabilities and values."""
    not_done = 1.0 - dones.to(rewards.dtype)
    rhos = torch.exp(target_logp - behavior_logp)
    rho = torch.clamp(rhos, max=rho_clip)
    c = torch.clamp(rhos, max=c_clip)

    delta = rho * (rewards + gamma * next_values - values)
    # A_t = delta_t + gamma c_t (1-done_t) A_{t+1}
    a = _reverse_linrec(gamma * c * not_done, delta)
    vs = values + a

    # policy-gradient advantages: r_t + gamma vs_{t+1} - V_t, bootstrapping
    # with next_values at fragment tails and episode boundaries
    vs_next = torch.cat([vs[1:], next_values[-1:]], 0)
    vs_next = torch.where(dones.bool(), next_values, vs_next)
    pg_adv = rho * (rewards + gamma * vs_next - values)
    return vs, pg_adv
