"""Sharded GPT and Llama pretraining: the port of
``ray_tpu/models/pretrain.py``.

The same program as the JAX trainer, in PyTorch idiom: ``init_params``
draws every parameter from the distribution flax's initialisers use for it;
``make_optimizer`` is optax's ``chain(clip_by_global_norm(1.0), adamw(...))``
on a ``warmup_cosine_decay_schedule``; ``train_step`` runs the forward, the
backward (the flash attention backward kernels on the card), the clip and
the update, and hands back the loss as a 0-dim tensor on the device without
waiting for it.  ``ShardedPretrainer`` owns the model and the optimizer; the
model family (GPT-2 or Llama) and its partition rules come as a pair from
the config's type (``_model_family``).

Over a mesh (``parallel/mesh.py``) of more than one rank, or whenever a
process group is initialised, the parameters are DTensors laid out by the
family's rules and the batch is sharded over (dp, fsdp) and its sequence
over sp; DTensor inserts the collectives GSPMD inserts in the JAX trainer
(NCCL on the card, gloo on the CPU).  With sp > 1 the trainer switches
flash attention to ring attention, as the JAX trainer does.  The experts
of an MoE model shard over ep and the batch is replicated over ep, as in
the JAX trainer.  AdamW runs on each rank's local shards, which is exact
because it is elementwise, and the clip takes the norm of the whole
gradient, each shard counted once.  ``save_checkpoint`` and
``restore_checkpoint`` write and read the parameters and the optimizer's
whole state through ``torch.distributed.checkpoint`` (orbax's place): each
rank writes its own shards, and a restore lays them out over the live mesh,
which may differ from the one that saved them.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.convert import params_from_flax
from ray_tpu_torch.models.gpt2 import GPT2LMModel, lm_loss
from ray_tpu_torch.models.moe import MoEMlpBlock, collect_moe_aux_loss
from ray_tpu_torch.ops.attention import _is_dtensor
from ray_tpu_torch.parallel.mesh import active_mesh, as_mesh_config, build_mesh
from ray_tpu_torch.parallel.sharding import (
    gpt_partition_rules,
    host_to_global,
    llama_partition_rules,
    match_partition_rules,
    placements,
)
from ray_tpu_torch.util.tracing import device_span

WARMUP = 100  # the JAX trainer's make_optimizer default
# the batch's layout: rows over (dp, fsdp), positions over sp
BATCH_SPEC = (("dp", "fsdp"), "sp")


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


def clip_by_global_norm(grads, max_norm: float,
                        replicas: Optional[Sequence[int]] = None
                        ) -> torch.Tensor:
    """optax's ``clip_by_global_norm`` in place on a list of gradients:
    scaled by ``max_norm / norm`` when the global norm is at least
    ``max_norm`` (no epsilon), left as they are otherwise.  Returns the
    norm, a 0-dim tensor on the device; nothing waits for it.

    With ``replicas``, ``grads`` are this rank's local shards of sharded
    gradients and ``replicas[i]`` ranks of the default process group hold
    each element of ``grads[i]``: the norm is that of the whole gradient,
    each shard's sum of squares over its replicas, summed over the world in
    one all-reduce."""
    norms = torch._foreach_norm(grads)
    if replicas is None:
        norm = torch.linalg.vector_norm(torch.stack(norms))
    else:
        sq = torch.stack([n * n / r for n, r in zip(norms, replicas)]).sum()
        dist.all_reduce(sq)
        norm = sq.sqrt()
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0,
                                           max_norm / norm))
    return norm


def _replicas(p) -> int:
    """How many ranks hold each element of a DTensor's local shard: the
    sizes of the mesh dims it is not sharded over."""
    return int(np.prod([p.device_mesh.size(m)
                        for m, pl in enumerate(p.placements)
                        if not pl.is_shard()]))


class Optimizer:
    """The optimizer of ``make_optimizer``: clip the global gradient norm to
    1.0, then AdamW at the schedule's rate for the update count *before*
    this update (optax evaluates its schedule at the old count, so the first
    update has lr 0 and leaves the parameters as they are).

    DTensor parameters (a sharded model) are updated through their local
    shards: each gradient is first laid out as its parameter is (the
    reduce-scatter or all-reduce over the axes the parameter is replicated
    or sharded over), and AdamW's state lives beside each shard.

    ``replicas`` overrides how many ranks of the default process group hold
    each element of each parameter, for the clip's norm: ``_replicas`` of a
    DTensor counts the ranks of its own mesh only, and a pipeline's
    parameters replicated over pp live on several such meshes (or are plain
    tensors on every pp rank)."""

    def __init__(self, params, lr: float, weight_decay: float, warmup: int,
                 total_steps: int, replicas: Optional[Sequence[int]] = None):
        self.params = list(params)
        self.sharded = any(_is_dtensor(p) for p in self.params)
        with torch.no_grad():
            self.local = ([p.to_local() for p in self.params]
                          if self.sharded else self.params)
        if replicas is None and self.sharded:
            replicas = [_replicas(p) for p in self.params]
        self.replicas = replicas
        self.lr, self.warmup, self.total_steps = lr, warmup, total_steps
        # decoupled decay p(1 - lr·wd) is optax's -lr·(update + wd·p), on
        # every parameter: optax's adamw is given no mask
        self.adamw = torch.optim.AdamW(self.local, lr=0.0, betas=(0.9, 0.95),
                                       eps=1e-8, weight_decay=weight_decay)
        self.count = 0
        self.last_grad_norm: Optional[torch.Tensor] = None

    def schedule(self, count: int) -> float:
        return warmup_cosine_decay(count, self.lr, self.warmup,
                                   self.total_steps)

    def step(self) -> None:
        if self.sharded:
            for p, local in zip(self.params, self.local):
                local.grad = p.grad.redistribute(
                    p.device_mesh, p.placements).to_local()
        grads = [p.grad for p in self.local]
        self.last_grad_norm = clip_by_global_norm(grads, 1.0, self.replicas)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
        self.adamw.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict[str, Any]:
        """The update count and AdamW's state (of the local shards, for a
        sharded model)."""
        return {"count": self.count, "adamw": self.adamw.state_dict()}


def make_optimizer(params, lr: float = 3e-4, weight_decay: float = 0.1,
                   warmup: int = WARMUP, total_steps: int = 10_000,
                   replicas: Optional[Sequence[int]] = None) -> Optimizer:
    return Optimizer(params, lr, weight_decay, warmup, total_steps, replicas)


def _model_family(config):
    """(model class, partition rules function) by config type: GPT-2 and
    the Llama family share the whole sharded-pretrain stack."""
    from ray_tpu_torch.models.llama import LlamaConfig, LlamaLMModel

    if isinstance(config, LlamaConfig):
        return LlamaLMModel, llama_partition_rules
    return GPT2LMModel, gpt_partition_rules


@torch.no_grad()
def init_params(config, seed: int = 0, device=None
                ) -> Tuple[nn.Module, Dict[str, torch.Tensor]]:
    """The config's model (``GPT2LMModel`` or ``LlamaLMModel``) on
    ``device`` and its parameters, each drawn on the CPU from a generator
    seeded with ``seed`` from the distribution of its flax initialiser:
    Dense kernels lecun-normal (a normal truncated to two standard
    deviations, scaled to variance 1/fan_in), embeddings normal with
    variance 1/E, biases 0, LayerNorm and RMSNorm scales 1, and an MoE
    block's expert weights normal with standard deviation 0.02/sqrt of
    their input width (``w_in`` (E, D, F): D; ``w_out`` (E, F, D): F)."""
    cls, _ = _model_family(config)
    model = cls(config, device=device)
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        for leaf, p in mod.named_parameters(recurse=False):
            if isinstance(mod, nn.Embedding):
                w = torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5
            elif isinstance(mod, MoEMlpBlock):  # w_in, w_out
                w = torch.randn(p.shape, generator=gen) * (
                    0.02 * p.shape[1] ** -0.5)
            elif leaf == "bias":
                w = torch.zeros(p.shape)
            elif not isinstance(mod, nn.Linear):  # a norm's scale
                w = torch.ones(p.shape)
            else:  # a Dense kernel, (out, in) here
                std = p.shape[1] ** -0.5 / 0.87962566103423978
                w = torch.nn.init.trunc_normal_(torch.empty(p.shape), 0.0,
                                                std, -2 * std, 2 * std,
                                                generator=gen)
            p.copy_(w)
    return model, dict(model.named_parameters())


def loss_fn(model: nn.Module, batch: Mapping[str, torch.Tensor]):
    """``lm_loss``, plus every MoE layer's aux term when the config has
    ``moe_every > 0`` (0 for a model without MoE blocks, as Llama's)."""
    if model.config.moe_every > 0:
        terms = []
        logits = model(batch["input_ids"], intermediates=terms)
        return (lm_loss(logits, batch["targets"], batch.get("mask"))
                + collect_moe_aux_loss(terms))
    logits = model(batch["input_ids"])
    return lm_loss(logits, batch["targets"], batch.get("mask"))


def train_step(model: nn.Module, opt: Optimizer,
               batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """One forward, backward, clip and AdamW update; returns the loss
    (0-dim, on the device, not synchronised; for a sharded model the
    global loss, on every rank).  Under a recording profiler the three
    phases are the spans ``train.forward``, ``train.backward`` and
    ``train.optimizer``."""
    opt.zero_grad()
    with device_span("train.forward"):
        loss = loss_fn(model, batch)
        if _is_dtensor(loss):
            loss = loss.full_tensor()
    with device_span("train.backward"):
        loss.backward()
    with device_span("train.optimizer"):
        opt.step()
    return loss.detach()


@torch.no_grad()
def distribute(model: nn.Module, mesh, specs: Mapping[str, Any]) -> None:
    """Every parameter of ``model`` replaced by the DTensor of its spec
    (``specs``, by parameter name) on ``mesh``; each rank keeps its own
    shard of the value all ranks drew from one seed."""
    for prefix, mod in model.named_modules():
        for leaf, p in list(mod.named_parameters(recurse=False)):
            name = f"{prefix}.{leaf}" if prefix else leaf
            mod.register_parameter(leaf, nn.Parameter(host_to_global(
                p.detach(), mesh, specs[name])))


class ShardedPretrainer:
    """Owns the mesh, the model, the optimizer and the step.

    ``mesh_config`` (this package's ``MeshConfig``, or any object with its
    fields) is resolved over the world of the process group, one rank a
    device; without an initialised group the world is this process alone
    and the model stays plain tensors on ``device`` (the CUDA card unless
    ``"cpu"`` is passed).  With a group, ``self.mesh`` is the
    ``DeviceMesh`` of ``build_mesh``, the parameters are DTensors laid out
    by the family's rules (``self.param_specs``, in the torch layout) on
    its axes of more than one rank, and ``step`` takes the same global
    batch on every rank.  ``self.config`` is the config trained: flash
    attention becomes ring attention when sp resolves to more than one
    rank.  ``params``, a flax tree as the JAX trainer's or the model's own
    state dict, are the initial parameters: none is drawn then."""

    def __init__(self, config, mesh_config=None, lr: float = 3e-4,
                 device=None, total_steps: int = 10_000,
                 params: Optional[Mapping] = None):
        mesh_config = as_mesh_config(mesh_config)
        grouped = dist.is_available() and dist.is_initialized()
        sizes = mesh_config.resolve(dist.get_world_size() if grouped else 1)
        if sizes["sp"] > 1 and config.attention_impl == "flash":
            # a sequence split needs the ring, as in the JAX trainer
            config = dataclasses.replace(config, attention_impl="ring")
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            self.model, _ = init_params(config, device=self.device)
        else:
            # built on its device, where the default initialisation that
            # the given parameters overwrite is cheap
            with torch.device(self.device):
                self.model = _model_family(config)[0](config,
                                                      device=self.device)
            self.model.load_state_dict(
                params if all(torch.is_tensor(v) for v in params.values())
                else params_from_flax(params))
        self.model.train()
        self.param_specs = match_partition_rules(
            _model_family(config)[1](), self.model)
        self.mesh = self._dmesh = None
        if grouped:
            self.mesh = build_mesh(mesh_config, self.device)
            self._dmesh = active_mesh(self.mesh)
            distribute(self.model, self._dmesh, self.param_specs)
        self.opt = make_optimizer(self.model.parameters(), lr,
                                  total_steps=total_steps)

    @property
    def state(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
        """(params, optimizer state), as the JAX trainer's ``state``."""
        return dict(self.model.named_parameters()), self.opt.state_dict()

    def _checkpoint_state(self) -> Dict[str, Any]:
        """The whole training state as ``torch.distributed.checkpoint``
        writes and reads it: every parameter as it is (a DTensor on a
        mesh), the update count, and AdamW's ``step``, ``exp_avg`` and
        ``exp_avg_sq`` of each parameter, the moments laid out as their
        parameter (DTensors over this rank's local shards on a mesh).  A
        load writes into these tensors in place.  AdamW's state is made
        here, as its first step makes it, when no step has run yet."""
        from torch.distributed.tensor import DTensor

        opt = self.opt
        state: Dict[str, Any] = {"count": torch.tensor(opt.count)}
        for (name, p), local in zip(self.model.named_parameters(),
                                    opt.local):
            st = opt.adamw.state[local]
            if not st:
                st.update(step=torch.tensor(0.0),
                          exp_avg=torch.zeros_like(local),
                          exp_avg_sq=torch.zeros_like(local))
            moments = {k: st[k] for k in ("exp_avg", "exp_avg_sq")}
            if _is_dtensor(p):
                moments = {k: DTensor.from_local(
                    t, p.device_mesh, p.placements, run_check=False,
                    shape=p.shape, stride=p.stride())
                    for k, t in moments.items()}
            state[name] = {"step": st["step"], **moments}
        return {"params": dict(self.model.named_parameters()),
                "optimizer": state}

    @torch.no_grad()
    def save_checkpoint(self, path: str) -> None:
        """Write the whole training state (parameters and optimizer) to the
        directory ``path``: each rank writes its own shards."""
        import torch.distributed.checkpoint as dcp

        dcp.save(self._checkpoint_state(),
                 checkpoint_id=os.path.abspath(path))

    @torch.no_grad()
    def restore_checkpoint(self, path: str) -> None:
        """Load the state ``save_checkpoint`` wrote into this trainer, laid
        out over this trainer's mesh (the one that saved it may differ)."""
        import torch.distributed.checkpoint as dcp

        state = self._checkpoint_state()
        dcp.load(state, checkpoint_id=os.path.abspath(path))
        self.opt.count = int(state["optimizer"]["count"])

    def shard_batch(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's ``input_ids`` and ``targets`` as int64 on the device
        (numpy arrays or tensors), rows over (dp, fsdp) and positions over
        sp on a mesh.  Other keys are dropped, as the JAX trainer's
        ``batch_sharding`` drops them: a ``mask`` does not reach the
        loss."""
        out = {}
        for key in ("input_ids", "targets"):
            val = torch.as_tensor(batch[key]).long()
            if self._dmesh is None:
                out[key] = val.to(self.device, non_blocking=True)
            else:
                out[key] = host_to_global(
                    val, self._dmesh, placements(BATCH_SPEC, self._dmesh))
        return out

    def step(self, batch: Mapping[str, Any]) -> torch.Tensor:
        """``train_step`` on ``batch`` placed by ``shard_batch``; under a
        recording profiler, the span ``train.step``."""
        with device_span("train.step"):
            return train_step(self.model, self.opt, self.shard_batch(batch))

    def tokens_per_batch(self, batch) -> int:
        ids = batch["input_ids"]
        return int(ids.numel() if torch.is_tensor(ids) else np.size(ids))


__all__ = ["ShardedPretrainer", "clip_by_global_norm", "distribute",
           "init_params", "loss_fn", "make_optimizer", "train_step",
           "warmup_cosine_decay", "Optimizer"]
