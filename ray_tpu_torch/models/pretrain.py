"""GPT pretraining step on one CUDA card: the port of
``ray_tpu/models/pretrain.py``.

The same program as the JAX trainer, in PyTorch idiom: ``init_params``
draws every parameter from the distribution flax's initialisers use for it;
``make_optimizer`` is optax's ``chain(clip_by_global_norm(1.0), adamw(...))``
on a ``warmup_cosine_decay_schedule``; ``train_step`` runs the forward, the
backward (the flash attention backward kernels on the card), the clip and
the update, and hands back the loss as a 0-dim tensor on the device without
waiting for it.  ``ShardedPretrainer`` owns the model and the optimizer.

One device only.  A mesh over more devices waits for the multi-GPU slice
(``ROADMAP.md`` A3), and sharded checkpoints for the train backend (A6).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.convert import params_from_flax
from ray_tpu_torch.models.gpt2 import GPT2LMModel, lm_loss

WARMUP = 100  # the JAX trainer's make_optimizer default
MESH_AXES = ("dp", "fsdp", "tp", "sp", "ep", "pp", "dcn_dp", "dcn_pp")


def warmup_cosine_decay(step: int, lr: float, warmup: int,
                        total_steps: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0.0, lr, warmup,
    max(total_steps, warmup + 1))`` at ``step``: linear from 0 to ``lr``
    over ``warmup`` steps, then a cosine to 0 over the rest of the decay
    steps (which count the warmup steps)."""
    if step < warmup:
        return lr * step / warmup
    decay = max(total_steps, warmup + 1) - warmup
    t = min(step - warmup, decay)
    return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place on a list of gradients:
    scaled by ``max_norm / norm`` when the global norm is at least
    ``max_norm`` (no epsilon), left as they are otherwise.  Returns the
    norm, a 0-dim tensor on the device; nothing waits for it."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0,
                                           max_norm / norm))
    return norm


class Optimizer:
    """The optimizer of ``make_optimizer``: clip the global gradient norm to
    1.0, then AdamW at the schedule's rate for the update count *before*
    this update (optax evaluates its schedule at the old count, so the first
    update has lr 0 and leaves the parameters as they are)."""

    def __init__(self, params, lr: float, weight_decay: float, warmup: int,
                 total_steps: int):
        self.params = list(params)
        self.lr, self.warmup, self.total_steps = lr, warmup, total_steps
        # decoupled decay p(1 - lr·wd) is optax's -lr·(update + wd·p), on
        # every parameter: optax's adamw is given no mask
        self.adamw = torch.optim.AdamW(self.params, lr=0.0, betas=(0.9, 0.95),
                                       eps=1e-8, weight_decay=weight_decay)
        self.count = 0
        self.last_grad_norm: Optional[torch.Tensor] = None

    def schedule(self, count: int) -> float:
        return warmup_cosine_decay(count, self.lr, self.warmup,
                                   self.total_steps)

    def step(self) -> None:
        grads = [p.grad for p in self.params]
        self.last_grad_norm = clip_by_global_norm(grads, 1.0)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "adamw": self.adamw.state_dict()}


def make_optimizer(params, lr: float = 3e-4, weight_decay: float = 0.1,
                   warmup: int = WARMUP,
                   total_steps: int = 10_000) -> Optimizer:
    return Optimizer(params, lr, weight_decay, warmup, total_steps)


@torch.no_grad()
def init_params(config, seed: int = 0, device=None
                ) -> Tuple[GPT2LMModel, Dict[str, torch.Tensor]]:
    """A ``GPT2LMModel`` on ``device`` and its parameters, each drawn on
    the CPU from a generator seeded with ``seed`` from the distribution of
    its flax initialiser: Dense kernels lecun-normal (a normal truncated to
    two standard deviations, scaled to variance 1/fan_in), embeddings
    normal with variance 1/E, biases 0, LayerNorm scales 1."""
    model = GPT2LMModel(config, device=device)
    gen = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in ("wte.weight", "wpe.weight"):
            w = torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5
        elif leaf == "bias":
            w = torch.zeros(p.shape)
        elif ".ln_" in f".{name}":
            w = torch.ones(p.shape)
        else:  # a Dense kernel, (out, in) here
            std = p.shape[1] ** -0.5 / 0.87962566103423978
            w = torch.nn.init.trunc_normal_(torch.empty(p.shape), 0.0, std,
                                            -2 * std, 2 * std, generator=gen)
        p.copy_(w)
    return model, dict(model.named_parameters())


def loss_fn(model: GPT2LMModel, batch: Mapping[str, torch.Tensor]):
    logits = model(batch["input_ids"])
    return lm_loss(logits, batch["targets"], batch.get("mask"))


def train_step(model: GPT2LMModel, opt: Optimizer,
               batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """One forward, backward, clip and AdamW update; returns the loss
    (0-dim, on the device, not synchronised)."""
    opt.zero_grad()
    loss = loss_fn(model, batch)
    loss.backward()
    opt.step()
    return loss.detach()


def _mesh_devices(mesh_config) -> int:
    """Devices a ``MeshConfig``-like object asks for; -1 (absorb the rest)
    counts as the one device this trainer holds."""
    n = 1
    for axis in MESH_AXES:
        size = getattr(mesh_config, axis, 1)
        n *= 1 if size == -1 else size
    return n


class ShardedPretrainer:
    """Owns the model, the optimizer and the step on one CUDA card (or the
    CPU when ``device="cpu"``)."""

    def __init__(self, config, mesh_config=None, lr: float = 3e-4,
                 device=None, total_steps: int = 10_000,
                 params: Optional[Mapping] = None):
        if mesh_config is not None and _mesh_devices(mesh_config) > 1:
            raise NotImplementedError(
                f"ShardedPretrainer runs on one device; {mesh_config} spans "
                f"more: multi-GPU meshes are not ported yet (ROADMAP.md A3)")
        self.config = config
        self.device = resolve_device(device)
        self.model, _ = init_params(config, device=self.device)
        if params is not None:
            self.model.load_state_dict(params_from_flax(params))
        self.model.train()
        self.opt = make_optimizer(self.model.parameters(), lr,
                                  total_steps=total_steps)

    @property
    def state(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """(params, optimizer state), as the JAX trainer's ``state``."""
        return dict(self.model.named_parameters()), self.opt.state_dict()

    def save_checkpoint(self, path: str) -> None:
        raise NotImplementedError(
            "sharded checkpoints are not ported yet (ROADMAP.md A6)")

    def restore_checkpoint(self, path: str) -> None:
        raise NotImplementedError(
            "sharded checkpoints are not ported yet (ROADMAP.md A6)")

    def shard_batch(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's ``input_ids``, ``targets`` and ``mask`` on the
        device (numpy arrays or tensors; ids as int64)."""
        out = {}
        for key in ("input_ids", "targets", "mask"):
            if key not in batch:
                continue
            val = torch.as_tensor(batch[key])
            if key != "mask":
                val = val.long()
            out[key] = val.to(self.device, non_blocking=True)
        return out

    def step(self, batch: Mapping[str, Any]) -> torch.Tensor:
        return train_step(self.model, self.opt, self.shard_batch(batch))

    def tokens_per_batch(self, batch) -> int:
        ids = batch["input_ids"]
        return int(ids.numel() if torch.is_tensor(ids) else np.size(ids))


__all__ = ["ShardedPretrainer", "clip_by_global_norm", "init_params",
           "loss_fn", "make_optimizer", "train_step", "warmup_cosine_decay",
           "Optimizer"]
