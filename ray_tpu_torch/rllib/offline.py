"""Offline RL: dataset recording + BC / MARWIL training from logged episodes.

Port of ``ray_tpu/rllib/offline.py``.  Counterpart of the reference's
offline stack (reference: rllib/offline/ — dataset readers feeding
Learners; rllib/algorithms/marwil/marwil.py MARWIL with BC as its beta=0
special case, rllib/algorithms/bc/bc.py).  Episodes are recorded through
``ray_tpu_torch.data`` (JSON blocks), the whole dataset lives on the
learner's device as dense tensors, and each training iteration is one
Python loop over minibatches on that device: a forward, MARWIL's loss, a
backward, optax's ``clip_by_global_norm`` and Adam, as PPO's
``TorchLearner`` takes them.  The JAX package jits the same loop as one
``lax.scan``; its carry, the moving norm of |A|, is a device tensor here,
updated minibatch by minibatch, so nothing waits for the card until the
iteration's losses are read.

MARWIL loss (Wang et al. 2018, exponentially weighted imitation):

    L = -E[ exp(beta * A / c) * log pi(a|s) ] + vf_coef * E[(V(s) - R)^2]

with A = R - V(s) (advantage against the learned value baseline), c a
running norm of |A|, and R the dataset's discounted return-to-go.
beta = 0 recovers plain behavior cloning (the value head still trains, but
the policy term ignores it).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.algorithms.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rllib.core.learner import apply_grads, make_optimizer
from ray_tpu_torch.rllib.core.rl_module import DiscretePolicyModule


# ---------------------------------------------------------------- recording

def rollout_rows(env_name: str, n_episodes: int,
                 policy_fn: Optional[Callable] = None, seed: int = 0,
                 gamma: float = 0.99) -> Tuple[list, list]:
    """Roll out ``policy_fn(obs) -> actions`` (default: a decent CartPole
    heuristic so the data carries signal): one row per step,
    ``{"obs", "action", "return_to_go"}``, and each episode's return."""
    from ray_tpu_torch.rllib.env import make_vector_env

    env = make_vector_env(env_name, 1, seed=seed)

    if policy_fn is None:
        def policy_fn(obs):  # lean-direction heuristic, ~mean return 40+
            return (obs[:, 2] + 0.5 * obs[:, 3] > 0).astype(np.int64)

    rows = []
    returns = []
    for _ in range(n_episodes):
        obs = env.reset()
        ep: list = []
        while True:
            a = policy_fn(obs)
            nxt, r, term, trunc, info = env.step(a)
            ep.append((obs[0].tolist(), int(a[0]), float(r[0])))
            obs = nxt
            if bool(term[0] or trunc[0]):
                break
        # discounted return-to-go per step
        g = 0.0
        rtg = [0.0] * len(ep)
        for i in range(len(ep) - 1, -1, -1):
            g = ep[i][2] + gamma * g
            rtg[i] = g
        returns.append(sum(r for _, _, r in ep))
        rows.extend({"obs": o, "action": a, "return_to_go": rt}
                    for (o, a, _), rt in zip(ep, rtg))
    return rows, returns


def record_dataset(path: str, env_name: str, n_episodes: int,
                   policy_fn: Optional[Callable] = None, seed: int = 0,
                   gamma: float = 0.99) -> Dict[str, Any]:
    """Roll out ``policy_fn`` (``rollout_rows``) and write one JSON row per
    step: ``{"obs", "action", "return_to_go"}`` (reference: offline
    output_config JSON episode writers).  Returns summary stats.  The JSON
    writer goes through pandas."""
    from ray_tpu_torch import data as rt_data

    rows, returns = rollout_rows(env_name, n_episodes, policy_fn, seed,
                                 gamma)
    rt_data.from_items(rows).write_json(path)
    return {"episodes": n_episodes, "steps": len(rows),
            "mean_return": float(np.mean(returns))}


# ----------------------------------------------------------------- learning

def _marwil_update(module: DiscretePolicyModule, params: List[torch.Tensor],
                   optimizer: torch.optim.Optimizer, norm: torch.Tensor,
                   batch: Dict[str, torch.Tensor], *, beta: float,
                   vf_coef: float, minibatch: int, grad_clip: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass over ``batch`` in whole minibatches of ``minibatch`` rows,
    in order: each takes one clipped Adam step on ``params`` (the module's,
    in ``optimizer``) and moves the norm.  Returns ``(norm, pi_losses,
    vf_losses)``, the losses one per minibatch, all on the batch's device."""
    n = batch["obs"].shape[0]
    n_mb = max(n // minibatch, 1)
    pi_ls, vf_ls = [], []
    for i in range(n_mb):
        mb = {k: v[i * minibatch:(i + 1) * minibatch]
              for k, v in batch.items()}
        logp, _ent = module.logp_entropy(mb["obs"], mb["action"])
        v = module.value(mb["obs"])
        adv = mb["return_to_go"] - v
        # running norm of |A| keeps exp() in range (reference: MARWIL's
        # moving average of the squared advantage)
        norm = 0.99 * norm + 0.01 * adv.detach().abs().mean()
        w = torch.exp(torch.clamp(
            beta * adv.detach() / torch.clamp(norm, min=1e-3),
            -10.0, 10.0))
        pi_loss = -(w * logp).mean()
        vf_loss = (adv ** 2).mean()
        grads = torch.autograd.grad(pi_loss + vf_coef * vf_loss, params)
        apply_grads(optimizer, params, grads, grad_clip)
        pi_ls.append(pi_loss.detach())
        vf_ls.append(vf_loss.detach())
    return norm, torch.stack(pi_ls), torch.stack(vf_ls)


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.input_path: Optional[str] = None
        self.training_params = {
            "lr": 3e-4,
            "beta": 1.0,
            "vf_coef": 1.0,
            "grad_clip": 10.0,
            "train_batch_size": 2048,
            "minibatch_size": 256,
        }

    def offline_data(self, *, input_path: str) -> "MARWILConfig":
        """Where the logged episodes live (reference:
        AlgorithmConfig.offline_data(input_))."""
        self.input_path = input_path
        return self

    @property
    def algo_class(self):
        return MARWIL


class BCConfig(MARWILConfig):
    """Behavior cloning = MARWIL with beta=0 (reference: bc.py subclasses
    MARWIL the same way)."""

    def __init__(self):
        super().__init__()
        self.training_params["beta"] = 0.0

    @property
    def algo_class(self):
        return BC


class MARWIL(Algorithm):
    def setup(self, config: MARWILConfig) -> None:
        from ray_tpu_torch import data as rt_data
        from ray_tpu_torch.rllib.algorithms.algorithm import build_module_spec

        # the learner runs on the card unless .learners(device="cpu")
        self.device = resolve_device(config.learner_device)
        if not config.input_path:
            raise ValueError("offline algorithms need "
                             "config.offline_data(input_path=...)")
        spec = build_module_spec(config)
        p = config.training_params
        self.module = DiscretePolicyModule(
            observation_size=spec["observation_size"],
            num_actions=spec["num_actions"], hidden=spec["hidden"],
            generator=torch.Generator().manual_seed(config.seed),
        ).to(self.device)
        self._params = [q for _, q in self.module.named_params()]
        self.optimizer = make_optimizer(self._params, p["lr"])
        self._norm = torch.tensor(1.0, device=self.device)

        # the dataset rides ray_tpu_torch.data; dense tensors on the
        # learner's device once, then each batch is a gather there
        rows = rt_data.read_json(config.input_path).take_all()
        self._data = {
            "obs": torch.tensor(np.asarray([r["obs"] for r in rows],
                                           np.float32), device=self.device),
            "action": torch.tensor(np.asarray([r["action"] for r in rows],
                                              np.int64), device=self.device),
            "return_to_go": torch.tensor(
                np.asarray([r["return_to_go"] for r in rows], np.float32),
                device=self.device)}
        self._rng = np.random.default_rng(config.seed)
        self._eval_env = None

    def training_step(self) -> Dict[str, Any]:
        p = self.config.training_params
        n = len(self._data["obs"])
        idx = torch.from_numpy(self._rng.integers(
            0, n, p["train_batch_size"])).to(self.device)
        batch = {k: v[idx] for k, v in self._data.items()}
        self._norm, pi_ls, vf_ls = _marwil_update(
            self.module, self._params, self.optimizer, self._norm, batch,
            beta=p["beta"], vf_coef=p["vf_coef"],
            minibatch=p["minibatch_size"], grad_clip=p["grad_clip"])
        pi_l, vf_l = torch.stack([pi_ls.mean(), vf_ls.mean()]).tolist()
        return {"policy_loss": pi_l, "vf_loss": vf_l, "dataset_size": n}

    def evaluate(self, n_episodes: int = 10) -> Dict[str, float]:
        """Greedy rollouts of the learned policy (reference:
        Algorithm.evaluate)."""
        from ray_tpu_torch.rllib.env import make_vector_env

        if self._eval_env is None:
            self._eval_env = make_vector_env(self.config.env, 1,
                                             seed=self.config.seed + 7)
        env = self._eval_env
        returns = []
        for _ in range(n_episodes):
            obs = env.reset()
            total = 0.0
            while True:
                with torch.no_grad():
                    a = self.module.forward_inference(torch.from_numpy(
                        np.asarray(obs, np.float32)).to(self.device))
                obs, r, term, trunc, _ = env.step(a.cpu().numpy())
                total += float(r[0])
                if bool(term[0] or trunc[0]):
                    break
            returns.append(total)
        return {"episode_return_mean": float(np.mean(returns))}


class BC(MARWIL):
    pass
