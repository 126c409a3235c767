"""TorchLearner + LearnerGroup: the device-side PPO update.

Port of ``ray_tpu/rllib/core/learner.py``.  ``TorchLearner`` is the
counterpart of ``JaxLearner``: one update is GAE (the doubling scan of
``ops/gae.py``), then epochs × shuffled minibatches, each a forward, a
backward, optax's ``clip_by_global_norm`` and Adam.  Where the JAX package
jits the whole update as nested ``lax.scan``s, this is a Python loop over
minibatches on the learner's device that never waits for the card until
the update's stats are read.  The permutations ``(num_epochs,
num_minibatches, minibatch_size)`` may come from the caller; otherwise the
learner draws them from its own ``torch.Generator``.

LearnerGroup: local mode (the learner in the caller's process) or actor
mode (learner actors, weights synced through the object store).  An actor
whose device is the card asks for a GPU lease (``num_gpus_per_learner``):
the nodelet gives a card only to a lease that asks for one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.pretrain import clip_by_global_norm
from ray_tpu_torch.rllib.core.rl_module import (DiscretePolicyModule,
                                                process_facts)

# time-major fragment keys and the dtype each takes on the learner
_BATCH_DTYPES = {"obs": torch.float32, "actions": torch.int64,
                 "logp": torch.float32, "values": torch.float32,
                 "rewards": torch.float32, "terminated": torch.bool,
                 "truncated": torch.bool, "next_values": torch.float32}


def batch_to(batch: Dict[str, Any], device: torch.device
             ) -> Dict[str, torch.Tensor]:
    """A fragment's arrays as tensors of their own on ``device`` (an array
    from the object store is read-only)."""
    return {k: torch.from_numpy(np.array(v)).to(device, _BATCH_DTYPES[k])
            for k, v in batch.items() if k in _BATCH_DTYPES}


def make_optimizer(params: List[torch.Tensor], lr: float
                   ) -> torch.optim.Adam:
    """``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, bias-corrected, which is ``torch.optim.Adam``'s formula; the
    foreach path pinned, so that replicas step with the same kernels."""
    return torch.optim.Adam(params, lr=lr, foreach=True)


def apply_grads(optimizer: torch.optim.Optimizer,
                params: List[torch.Tensor], grads: List[torch.Tensor],
                grad_clip: float) -> None:
    """``optax.chain(clip_by_global_norm(grad_clip), adam)``: the clip
    (no epsilon), then one Adam step."""
    grads = list(grads)
    clip_by_global_norm(grads, grad_clip)
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()


class TorchLearner:
    def __init__(self, module_spec: Dict, config: Dict, seed: int = 0,
                 device: Optional[str] = None):
        # device="cpu" keeps the learner off the card (tests, or CPU-only
        # clusters); None is the card, and raises without one
        self.device = resolve_device(device)
        self.config = dict(config)
        self.module = DiscretePolicyModule(
            **module_spec, generator=torch.Generator().manual_seed(seed)
        ).to(self.device)
        self._params = [p for _, p in self.module.named_params()]
        self.optimizer = make_optimizer(self._params,
                                        self.config.get("lr", 3e-4))
        self._perm_gen = torch.Generator().manual_seed(seed + 1)
        self.num_epochs = self.config.get("num_epochs", 6)
        self.minibatch_size = self.config.get("minibatch_size", 256)
        self._loss_kw = dict(
            clip_param=self.config.get("clip_param", 0.2),
            vf_loss_coeff=self.config.get("vf_loss_coeff", 0.5),
            entropy_coeff=self.config.get("entropy_coeff", 0.0),
            vf_clip_param=self.config.get("vf_clip_param", 10.0))
        self._gae_kw = dict(gamma=self.config.get("gamma", 0.99),
                            gae_lambda=self.config.get("gae_lambda", 0.95))
        self._update_ms: List[float] = []

    def minibatch_shape(self, n: int):
        """(num_minibatches, minibatch_size) for a batch of ``n`` rows."""
        size = min(self.minibatch_size, n)
        return max(n // size, 1), size

    def draw_permutations(self, n: int) -> torch.Tensor:
        """One shuffle of the ``n`` rows an epoch, cut to whole
        minibatches: (num_epochs, num_minibatches, minibatch_size)."""
        m, size = self.minibatch_shape(n)
        return torch.stack([
            torch.randperm(n, generator=self._perm_gen)[:m * size]
            .reshape(m, size) for _ in range(self.num_epochs)])

    def update(self, batch: Dict[str, np.ndarray],
               perms: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """batch: time-major fragments (T, K, ...) concatenated over runners
        along K, with next_values precomputed by the runners."""
        if perms is None:
            perms = self.draw_permutations(int(np.asarray(
                batch["rewards"]).size))
        events = None
        if self.device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in "se"]
            events[0].record()
        stats = _ppo_update(
            self.module, self._params, self.optimizer,
            batch_to(batch, self.device), perms.to(self.device),
            grad_clip=self.config.get("grad_clip", 0.5), **self._loss_kw,
            **self._gae_kw)
        if events is not None:
            events[1].record()
        values = torch.stack(list(stats.values())).tolist()
        if events is not None:
            self._update_ms.append(events[0].elapsed_time(events[1]))
        return dict(zip(stats, values))

    def update_times(self) -> List[float]:
        """Each update's time on the card in ms (CUDA events around the
        batch's copy and the whole update); empty on the CPU."""
        return list(self._update_ms)

    def gae_and_grads(self, batch: Dict[str, np.ndarray],
                      idx: torch.Tensor):
        """GAE's advantages over ``batch`` and the PPO loss's gradient on
        its rows ``idx`` (one flat vector, in the sorted names' order),
        with no step taken."""
        rows, adv, _ = ppo_flat_batch(batch_to(batch, self.device),
                                      **self._gae_kw)
        idx = idx.to(self.device)
        loss, _ = ppo_loss(self.module, {k: v[idx] for k, v in rows.items()},
                           **self._loss_kw)
        grads = torch.autograd.grad(loss, self._params)
        return adv, torch.cat([g.reshape(-1) for g in grads])

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return self.module.state()

    def set_weights(self, state: Dict[str, torch.Tensor]) -> None:
        self.module.load_state(state)

    def process_facts(self) -> Dict[str, Any]:
        return process_facts(self.device)


def ppo_flat_batch(batch: Dict[str, torch.Tensor], gamma: float,
                   gae_lambda: float):
    """GAE over the batch, then every per-step array flattened to rows:
    ``(rows, advantages, value_targets)``."""
    from ray_tpu_torch.ops.gae import gae_from_fragments

    dones = batch["terminated"] | batch["truncated"]
    adv, targets = gae_from_fragments(
        batch["rewards"], batch["values"], batch["next_values"], dones,
        gamma, gae_lambda)
    n = batch["rewards"].numel()
    rows = {
        "obs": batch["obs"].reshape(n, -1),
        "actions": batch["actions"].reshape(n),
        "logp_old": batch["logp"].reshape(n),
        "adv": adv.reshape(n),
        "targets": targets.reshape(n),
    }
    return rows, adv, targets


def ppo_loss(module: DiscretePolicyModule, mb: Dict[str, torch.Tensor], *,
             clip_param: float, vf_loss_coeff: float, entropy_coeff: float,
             vf_clip_param: float):
    """One minibatch's PPO loss and stats (reference math:
    rllib/algorithms/ppo/torch/ppo_torch_learner.py
    compute_loss_for_module)."""
    logp, entropy = module.logp_entropy(mb["obs"], mb["actions"])
    ratio = torch.exp(logp - mb["logp_old"])
    a = mb["adv"]
    # per-minibatch advantage norm, over the population std as jnp's
    a = (a - a.mean()) / (a.std(correction=0) + 1e-8)
    surrogate = torch.minimum(
        a * ratio, a * torch.clamp(ratio, 1 - clip_param, 1 + clip_param))
    v = module.value(mb["obs"])
    vf_err = torch.clamp((v - mb["targets"]) ** 2, 0.0, vf_clip_param)
    loss = (-surrogate.mean() + vf_loss_coeff * vf_err.mean()
            - entropy_coeff * entropy.mean())
    return loss, {
        "policy_loss": -surrogate.mean(),
        "vf_loss": vf_err.mean(),
        "entropy": entropy.mean(),
        "approx_kl": (mb["logp_old"] - logp).mean(),
    }


def _ppo_update(module, params, optimizer, batch, perms, *, clip_param,
                vf_loss_coeff, entropy_coeff, vf_clip_param, gamma,
                gae_lambda, grad_clip) -> Dict[str, torch.Tensor]:
    """The PPO update: GAE, then an Adam step a minibatch of ``perms``
    (epochs, minibatches, rows).  The stats are the last epoch's means
    over its minibatches, as tensors on the device."""
    rows, adv, targets = ppo_flat_batch(batch, gamma, gae_lambda)
    last_epoch = []
    for e, epoch in enumerate(perms):
        for idx in epoch:
            mb = {k: v[idx] for k, v in rows.items()}
            loss, stats = ppo_loss(
                module, mb, clip_param=clip_param,
                vf_loss_coeff=vf_loss_coeff, entropy_coeff=entropy_coeff,
                vf_clip_param=vf_clip_param)
            grads = torch.autograd.grad(loss, params)
            apply_grads(optimizer, params, grads, grad_clip)
            if e == len(perms) - 1:
                last_epoch.append({**stats, "total_loss": loss})
    out = {k: torch.stack([s[k].detach() for s in last_epoch]).mean()
           for k in last_epoch[0]}
    out["mean_advantage"] = adv.mean()
    out["mean_value_target"] = targets.mean()
    return out


class LearnerGroup:
    """Weight owner + update dispatcher (reference:
    rllib/core/learner/learner_group.py:83).  num_learners=0 → local learner
    in the driver process (the reference's default for single-device)."""

    def __init__(self, module_spec: Dict, config: Dict, num_learners: int = 0,
                 seed: int = 0, device: Optional[str] = None,
                 num_gpus_per_learner: float = 1):
        self._local: Optional[TorchLearner] = None
        self._actors: List = []
        if num_learners <= 0:
            self._local = TorchLearner(module_spec, config, seed, device)
        else:
            import ray_tpu_torch

            learner_cls = ray_tpu_torch.remote(TorchLearner)
            options = learner_options(device, num_gpus_per_learner)
            self._actors = [
                learner_cls.options(**options).remote(module_spec, config,
                                                      seed + i, device)
                for i in range(num_learners)
            ]

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        if self._local is not None:
            return self._local.update(batch)
        import ray_tpu_torch

        # shard the batch over learner actors along the env axis (K); each
        # learner updates independently and rank-0's weights win.  More
        # actors than env columns → the excess actors sit this round out
        # (an empty shard would divide by zero inside the update).
        k = batch["rewards"].shape[1]
        n_active = min(len(self._actors), k)
        per = k // n_active
        shards = []
        for i in range(n_active):
            sl = slice(i * per, (i + 1) * per if i < n_active - 1 else k)
            shards.append({key: v[:, sl] if v.ndim >= 2 else v
                           for key, v in batch.items()})
        stats = ray_tpu_torch.get([a.update.remote(s)
                                   for a, s in zip(self._actors, shards)])
        return stats[0]

    def get_weights(self):
        if self._local is not None:
            return self._local.get_weights()
        import ray_tpu_torch

        return ray_tpu_torch.get(self._actors[0].get_weights.remote())

    @property
    def actors(self) -> List:
        return list(self._actors)

    def shutdown(self) -> None:
        import ray_tpu_torch

        for a in self._actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        self._actors = []


def learner_options(device: Optional[str], num_gpus: float) -> Dict:
    """A learner actor's resources: one CPU, and on the card
    ``num_gpus`` of a GPU lease.  A cluster without that much GPU raises
    at once: nothing falls back to the CPU."""
    if str(device or "cuda") == "cpu":
        return {"num_cpus": 1}
    import ray_tpu_torch

    have = ray_tpu_torch.cluster_resources().get("GPU", 0)
    if have < num_gpus:
        raise RuntimeError(
            f"a learner on the card asks {num_gpus:g} GPU and the cluster "
            f"has {have:g}; pass learners(device='cpu') to learn on the CPU")
    return {"num_cpus": 1, "num_gpus": num_gpus}
