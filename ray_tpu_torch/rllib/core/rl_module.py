"""RLModule: the policy and value networks as ``nn.Module``s.

Port of ``ray_tpu/rllib/core/rl_module.py``.  The JAX package keeps each
module as a pair of pure functions over a params pytree; here each module
holds its parameters, in the JAX layout: every layer is a ``w`` of shape
(in, out) and a ``b``, named as the pytree's path (``pi/0/w``,
``vf/1/b``, ...).  So the names a learner publishes and a runner loads are
the JAX package's, and ``params_from_jax`` maps a JAX params pytree onto a
module one to one.

A module's state (``state()``) is a dict of those names to CPU tensors:
what the weight mailbox carries and what ``load_state`` takes.  Every draw
(the initial weights, an action, the Gaussian's noise) comes from a
``torch.Generator`` the caller passes.
"""

from __future__ import annotations

import math
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class _Dense(nn.Module):
    """One layer as the JAX package lays it out: ``x @ w + b``."""

    def __init__(self, fan_in: int, fan_out: int, scale: float,
                 generator: torch.Generator):
        super().__init__()
        self.w = nn.Parameter(torch.randn(fan_in, fan_out,
                                          generator=generator)
                              * (scale / math.sqrt(fan_in)))
        self.b = nn.Parameter(torch.zeros(fan_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


def _init_mlp(generator: torch.Generator, sizes: Sequence[int],
              final_scale: float = 1.0) -> nn.ModuleList:
    """Tanh MLP layers; the final layer scaled down (policy heads want ~0
    logits at init so early exploration is uniform)."""
    n = len(sizes) - 1
    return nn.ModuleList(
        _Dense(sizes[i], sizes[i + 1],
               final_scale if i == n - 1 else 1.0, generator)
        for i in range(n))


def _apply_mlp(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def _apply_relu_mlp(layers: nn.ModuleList, x: torch.Tensor,
                    final_relu: bool = False) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1 or final_relu:
            x = torch.relu(x)
    return x


def _generator(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None \
        else torch.Generator().manual_seed(0)


class _RLModule(nn.Module):
    """What every module shares: its parameters by their JAX names."""

    def named_params(self) -> List[Tuple[str, nn.Parameter]]:
        """``(name, parameter)`` sorted by name, names as the JAX pytree's
        paths (``pi/0/w``)."""
        return sorted(((name.replace(".", "/"), p)
                       for name, p in self.named_parameters()),
                      key=lambda item: item[0])

    def param_names(self) -> List[str]:
        return [name for name, _ in self.named_params()]

    def state(self) -> Dict[str, torch.Tensor]:
        """The parameters as CPU tensors of their own, by name."""
        return {name: p.detach().to("cpu", copy=True)
                for name, p in self.named_params()}

    def load_state(self, state: Dict[str, torch.Tensor]) -> None:
        named = dict(self.named_params())
        if set(state) != set(named):
            raise ValueError(f"state names {sorted(state)} are not the "
                             f"module's {sorted(named)}")
        with torch.no_grad():
            for name, p in named.items():
                p.copy_(state[name])


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """A JAX params pytree (nested dicts and lists of arrays, as a module's
    ``init`` returns it) as a module state: each leaf as a float32 CPU
    tensor under its path's name."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + [str(i)])
        else:
            out["/".join(path)] = torch.tensor(np.array(node, np.float32))

    walk(tree, [])
    return out


def sample_categorical(logits: torch.Tensor, generator: torch.Generator
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One action per row of ``logits`` (..., A), drawn with
    ``generator``, and its log-probability: ``(actions int64, logp)``."""
    logp = torch.log_softmax(logits, -1)
    flat = logp.reshape(-1, logp.shape[-1])
    actions = torch.multinomial(flat.exp(), 1, generator=generator)
    logp_a = flat.gather(-1, actions)[:, 0].reshape(logits.shape[:-1])
    return actions[:, 0].reshape(logits.shape[:-1]), logp_a


class DiscretePolicyModule(_RLModule):
    """Separate policy/value tanh MLPs for discrete action spaces
    (reference default: vf_share_layers=False)."""

    def __init__(self, observation_size: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64), *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.observation_size = observation_size
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        gen = _generator(generator)
        self.pi = _init_mlp(gen, (observation_size, *self.hidden,
                                  num_actions), final_scale=0.01)
        self.vf = _init_mlp(gen, (observation_size, *self.hidden, 1))

    # --------------------------------------------------------- forwards
    def logits(self, obs: torch.Tensor) -> torch.Tensor:
        return _apply_mlp(self.pi, obs)

    def value(self, obs: torch.Tensor) -> torch.Tensor:
        return _apply_mlp(self.vf, obs)[..., 0]

    def forward_exploration(self, obs: torch.Tensor,
                            generator: torch.Generator
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
        """Sample actions; returns (actions, logp, values)."""
        actions, logp_a = sample_categorical(self.logits(obs), generator)
        return actions, logp_a, self.value(obs)

    def forward_inference(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.logits(obs), -1)

    def logp_entropy(self, obs: torch.Tensor, actions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        logp = torch.log_softmax(self.logits(obs), -1)
        logp_a = logp.gather(-1, actions.long()[..., None])[..., 0]
        entropy = -(logp.exp() * logp).sum(-1)
        return logp_a, entropy


class QModule(_RLModule):
    """Dueling Q-network for value-based algorithms (reference: DQN's
    catalog-built Q head; Q = V + A - mean(A), the reference's
    ``dueling=True`` default for the tuned CartPole example).  Relu trunk."""

    def __init__(self, observation_size: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64), dueling: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.observation_size = observation_size
        self.num_actions = num_actions
        self.hidden = tuple(hidden)
        self.dueling = dueling
        gen = _generator(generator)
        if not dueling:
            self.q = _init_mlp(gen, (observation_size, *self.hidden,
                                     num_actions))
            return
        last = self.hidden[-1]
        self.trunk = _init_mlp(gen, (observation_size, *self.hidden))
        self.adv = _init_mlp(gen, (last, num_actions))
        self.val = _init_mlp(gen, (last, 1))

    def q_values(self, obs: torch.Tensor) -> torch.Tensor:
        if not self.dueling:
            return _apply_relu_mlp(self.q, obs)
        h = _apply_relu_mlp(self.trunk, obs, final_relu=True)
        adv = _apply_relu_mlp(self.adv, h)
        val = _apply_relu_mlp(self.val, h)
        return val + adv - adv.mean(-1, keepdim=True)

    def forward_inference(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.q_values(obs), -1)


class SquashedGaussianModule(_RLModule):
    """Continuous-control actor: tanh-squashed Gaussian policy (the SAC
    actor).  ``sample`` returns (action, logp) with the tanh
    change-of-variables correction; actions scale to [-max_action,
    max_action]."""

    LOG_STD_MIN = -10.0
    LOG_STD_MAX = 2.0

    def __init__(self, observation_size: int, action_size: int,
                 max_action: float = 1.0, hidden: Sequence[int] = (64, 64),
                 *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.observation_size = observation_size
        self.action_size = action_size
        self.max_action = float(max_action)
        self.hidden = tuple(hidden)
        self.pi = _init_mlp(_generator(generator),
                            (observation_size, *self.hidden,
                             2 * action_size), final_scale=0.01)

    def _dist(self, obs: torch.Tensor):
        mean, log_std = torch.chunk(_apply_mlp(self.pi, obs), 2, -1)
        return mean, torch.clamp(log_std, self.LOG_STD_MIN, self.LOG_STD_MAX)

    def sample(self, obs: torch.Tensor, generator: torch.Generator
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, _ = self._dist(obs)
        eps = torch.randn(mean.shape, generator=generator,
                          device=generator.device).to(mean.device)
        return self.sample_with_eps(obs, eps)

    def sample_with_eps(self, obs: torch.Tensor, eps: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``sample`` with its standard normal noise ``eps`` given."""
        mean, log_std = self._dist(obs)
        pre = mean + torch.exp(log_std) * eps
        act = torch.tanh(pre)
        # log N(pre) - log |d tanh/d pre| (numerically stable softplus form)
        logp = (-0.5 * (eps ** 2 + 2 * log_std + math.log(2 * math.pi))
                ).sum(-1)
        logp = logp - (2.0 * (math.log(2.0) - pre
                              - F.softplus(-2.0 * pre))).sum(-1)
        # scaling by max_action is part of the bijector: its Jacobian
        # contributes -sum(log max_action) to the density of the action
        logp = logp - self.action_size * math.log(self.max_action)
        return act * self.max_action, logp

    def forward_inference(self, obs: torch.Tensor) -> torch.Tensor:
        mean, _ = self._dist(obs)
        return torch.tanh(mean) * self.max_action


class TwinQModule(_RLModule):
    """Twin continuous Q(s, a) critics (clipped double-Q; reference: SAC's
    twin_q=True default)."""

    def __init__(self, observation_size: int, action_size: int,
                 hidden: Sequence[int] = (64, 64), *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        sizes = (observation_size + action_size, *hidden, 1)
        gen = _generator(generator)
        self.q1 = _init_mlp(gen, sizes)
        self.q2 = _init_mlp(gen, sizes)

    def q_values(self, obs: torch.Tensor, act: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([obs, act], -1)
        return (_apply_relu_mlp(self.q1, x)[..., 0],
                _apply_relu_mlp(self.q2, x)[..., 0])


def process_facts(device=None) -> Dict:
    """What an RL process runs on: its device, whether CUDA is up in it,
    and the top-level packages it has loaded."""
    return {"device": str(device) if device is not None else "cpu",
            "cuda_initialized": torch.cuda.is_initialized(),
            "pid": os.getpid(),
            "packages": sorted({m.split(".")[0] for m in list(sys.modules)})}
