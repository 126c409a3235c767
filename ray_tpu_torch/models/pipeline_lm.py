"""Pipeline-parallel GPT-2 pretraining: GPipe over ``pp`` composed with dp,
fsdp and tp, the port of ``ray_tpu/models/pipeline_lm.py``.

The transformer blocks are cut into S stages of K = n_layer / S blocks;
stage s lives on the ranks of pp coordinate s only.  The embeddings, the
final LayerNorm and ``lm_head`` are replicated on every pp rank, and every
pp rank computes them for the whole batch (their FLOPs are small next to
the blocks'), so their gradients agree on every pp rank with no reduction
over pp: the head's because its input, the pipeline's output, is
broadcast to every pp rank, the embeddings' because the pipeline
broadcasts the microbatches' gradient (``parallel/pipeline.py``).  Within a
stage the parameters are DTensors on the mesh of the other axes, laid out
by ``gpt_partition_rules`` as in ``ShardedPretrainer``; each rank cuts its
own rows of the batch into M microbatches.

Without a process group the trainer holds every stage in one process and
runs every position's ticks through ``pipeline_apply_unrolled``: the same
schedule on one device.

One difference from the reference, kept on purpose (``ROADMAP.md`` C8):
the reference swaps the config's attention for its reference attention,
because its Pallas kernels inside a partial-manual ``shard_map`` want
aligned shapes.  That is a limit of the TPU program, not part of the
function, and the port keeps the config's attention: the flash kernels on
the card.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.models.convert import params_from_flax
from ray_tpu_torch.models.gpt2 import (
    GPT2Config,
    _dense,
    _embed,
    _layernorm,
    lm_loss,
)
from ray_tpu_torch.models.pretrain import (
    _replicas,
    distribute,
    init_params,
    make_optimizer,
)
from ray_tpu_torch.ops.attention import _is_dtensor
from ray_tpu_torch.parallel.mesh import (
    AXES,
    MeshConfig,
    as_mesh_config,
    build_mesh,
)
from ray_tpu_torch.parallel.pipeline import (
    _contiguous_stride,
    _tree_map,
    pipeline_apply,
    pipeline_apply_unrolled,
    stack_stage_params,
)
from ray_tpu_torch.parallel.sharding import (
    gpt_partition_rules,
    host_to_global,
    match_partition_rules,
    placements,
)

# the batch's and the activations' layout within a stage: rows over
# (dp, fsdp)
ROWS_SPEC = (("dp", "fsdp"),)


def split_lm_params(params: Mapping[str, Any], n_layer: int, n_stages: int):
    """A GPT2LMModel flax param tree -> (outer, stacked_blocks): outer holds
    the embeddings, the final LayerNorm and the head; stacked_blocks is the
    block trees stacked to leading dims (S, K), S stages of K blocks.  The
    leaves may be numpy arrays or tensors."""
    if n_layer % n_stages:
        raise ValueError(f"{n_layer} layers do not split into {n_stages} "
                         "stages")
    k = n_layer // n_stages
    blocks = [params[f"h_{i}"] for i in range(n_layer)]
    outer = {name: sub for name, sub in params.items()
             if not name.startswith("h_")}
    stacked = stack_stage_params([stack_stage_params(blocks[s * k:(s + 1) * k])
                                  for s in range(n_stages)])
    return outer, stacked


def merge_lm_params(outer: Mapping[str, Any], stacked, n_layer: int,
                    n_stages: int) -> Dict[str, Any]:
    """The inverse of ``split_lm_params``: the GPT2LMModel flax tree."""
    k = n_layer // n_stages
    params = dict(outer)
    for s in range(n_stages):
        for j in range(k):
            params[f"h_{s * k + j}"] = _tree_map(lambda a: a[s, j], stacked)
    return params


def stacked_block_specs(stacked):
    """The reference's specs for the stacked block tree, as tuples: the
    stage dim on ``pp``, and ``gpt_partition_rules`` on the trailing
    (in, out) dims of the (S, K, in, out) kernels.  The port lays a stage's
    blocks out by the same rules, on the mesh without pp (each rank holds
    its own stage's blocks whole along S and K)."""
    rules = gpt_partition_rules()

    def walk(tree, prefix):
        if isinstance(tree, Mapping):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        spec = rules.spec_for(prefix, np.shape(tree)[2:])
        return ("pp", None, *spec) if spec else ("pp",)
    return walk(stacked, "")


def _run_stage(blocks, h):
    """One pipeline stage: ``h`` through its K blocks in turn, without
    remat, as the reference's stage runs a plain ``Block``."""
    for block in blocks:
        h = block(h)
    return h


class PipelinedPretrainer:
    """The ``ShardedPretrainer`` counterpart for meshes with pp > 1: GPT-2's
    blocks in S = pp stages, M microbatches a step (2·S unless
    ``n_microbatches`` is given; each rank's rows of the batch must divide
    by it), one forward, backward, clip by the global norm and AdamW a
    ``step``, as ``make_optimizer`` sets them.

    ``mesh_config`` (``MeshConfig(pp=2)`` when None) is resolved over the
    world of the process group, one rank a device; sp and ep must stay at
    one rank (neither is composed with pp yet).  Without an initialised
    group this process holds every stage: ``mesh_config``'s pp positions,
    and one rank on every other axis.  ``params`` is a flax GPT2LMModel
    tree (``merge_lm_params`` of the reference's state); without it,
    ``init_params(config, seed=0)``.  The model is on ``device``, the card
    unless ``"cpu"`` is passed.

    ``self.model`` holds the embeddings, ``ln_f``, ``lm_head`` and this
    rank's blocks (every block without a group); ``self.stages`` the blocks
    of each stage this process runs."""

    def __init__(self, config, mesh_config=None, lr: float = 3e-4,
                 device=None, total_steps: int = 10_000,
                 n_microbatches: Optional[int] = None,
                 params: Optional[Mapping] = None):
        if not isinstance(config, GPT2Config):
            raise TypeError("PipelinedPretrainer trains GPT-2 only, as the "
                            f"reference does; got {type(config).__name__}")
        if config.moe_every:
            raise ValueError("pp with MoE blocks is not composed (the "
                             "reference asserts moe_every == 0)")
        mesh_config = (MeshConfig(pp=2) if mesh_config is None
                       else as_mesh_config(mesh_config))
        grouped = dist.is_available() and dist.is_initialized()
        # without a group, the world is the mesh the config asks for (a
        # wildcard at one rank); every axis but pp must then have one rank
        sizes = mesh_config.resolve(
            dist.get_world_size() if grouped else mesh_config.n_slices
            * int(np.prod([max(getattr(mesh_config, a), 1) for a in AXES])))
        if sizes["pp"] < 2:
            raise ValueError(f"pp={sizes['pp']}: use ShardedPretrainer for "
                             "pp=1")
        over = {a: sizes[a] for a in ("sp", "ep") if sizes[a] > 1}
        if over:
            raise ValueError(f"pp with {over}: the pipeline is not composed "
                             "with sp or ep yet (ROADMAP.md A7)")
        over = {a: n for a, n in sizes.items() if a != "pp" and n > 1}
        if over and not grouped:
            raise ValueError(f"{over} without a process group: one process "
                             "holds every pp position and one rank of "
                             "every other axis")
        n_stages = sizes["pp"]
        if config.n_layer % n_stages:
            raise ValueError(f"{config.n_layer} layers do not split into "
                             f"{n_stages} stages")
        self.config = config
        self.n_stages = n_stages
        self.n_micro = n_microbatches or 2 * n_stages
        self.device = resolve_device(device)
        self.model, _ = init_params(config, device=self.device)
        if params is not None:
            self.model.load_state_dict(params_from_flax(params))
        self.model.train()
        k = config.n_layer // n_stages
        self.stages = [self.model.h[s * k:(s + 1) * k]
                       for s in range(n_stages)]
        self.mesh = self._dmesh = self.pp_group = None
        replicas = None
        if grouped:
            self.mesh = build_mesh(mesh_config, self.device)
            self.pp_group = self.mesh.get_group("pp")
            # this rank's stage: its pp coordinate, the mesh's first dim
            self.stages = [self.stages[self.mesh.get_coordinate()[0]]]
            self.model.h = self.stages[0]
            names = tuple(n for n, s in zip(self.mesh.mesh_dim_names,
                                            self.mesh.mesh.shape)
                          if s > 1 and n != "pp")
            if names:
                self._dmesh = self.mesh[names]
                distribute(self.model, self._dmesh, match_partition_rules(
                    gpt_partition_rules(), self.model))
            # the clip counts each element once over the world: a stage's
            # blocks live in one pp slice, the rest in every one
            replicas = [
                (_replicas(p) if _is_dtensor(p) else 1)
                * (1 if name.startswith("h.") else n_stages)
                for name, p in self.model.named_parameters()]
            # NCCL wants every rank of a group in the group's first P2P
            # batch, and the fill and drain leave some out
            dist.all_reduce(torch.zeros(1, device=self.device),
                            group=self.pp_group)
        self._rows = (None if self._dmesh is None
                      else placements(ROWS_SPEC, self._dmesh))
        self._stage_fn = _run_stage
        self.opt = make_optimizer(self.model.parameters(), lr,
                                  total_steps=total_steps, replicas=replicas)

    def _microbatches(self, x):
        """(B, S, E) activations -> (M, B / M, S, E), each rank's own rows
        cut into M microbatches."""
        from torch.distributed.tensor import DTensor, Shard

        M = self.n_micro
        local = x if self._rows is None else x.redistribute(
            self._dmesh, self._rows).to_local()
        if local.shape[0] % M:
            raise ValueError(f"{local.shape[0]} rows on this rank do not "
                             f"divide into {M} microbatches")
        local = local.reshape(M, local.shape[0] // M, *local.shape[1:])
        if self._rows is None:
            return local
        shape = (M, x.shape[0] // M, *x.shape[1:])
        return DTensor.from_local(
            local, self._dmesh,
            [Shard(p.dim + 1) if p.is_shard() else p for p in self._rows],
            run_check=False, shape=shape, stride=_contiguous_stride(shape))

    def _rejoin(self, ys):
        """The inverse of ``_microbatches``."""
        from torch.distributed.tensor import DTensor

        if self._rows is None:
            return ys.reshape(-1, *ys.shape[2:])
        local = ys.to_local()
        shape = (ys.shape[0] * ys.shape[1], *ys.shape[2:])
        return DTensor.from_local(
            local.reshape(-1, *local.shape[2:]), self._dmesh, self._rows,
            run_check=False, shape=shape, stride=_contiguous_stride(shape))

    def forward(self, input_ids):
        """The logits of ``input_ids`` (a tensor, or a DTensor as
        ``shard_batch`` lays it out): the embeddings, the pipeline of the
        stages over M microbatches, ``ln_f`` and ``lm_head``."""
        cfg, m = self.config, self.model
        x = (_embed(m.wte.weight, input_ids, cfg.dtype)
             + m.wpe.weight[:input_ids.shape[1]].to(cfg.dtype))
        xs = self._microbatches(x)
        if self.pp_group is None:
            ys = pipeline_apply_unrolled(self._stage_fn, self.stages, xs)
        else:
            ys = pipeline_apply(self._stage_fn, self.stages[0], xs,
                                group=self.pp_group)
        y = _layernorm(m.ln_f, self._rejoin(ys), cfg.dtype)
        return _dense(m.lm_head, y, cfg.dtype)

    def shard_batch(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's ``input_ids`` and ``targets`` as int64 on the device,
        rows over (dp, fsdp) on a mesh; other keys are dropped, as the
        reference's ``batch_sharding`` drops them."""
        out = {}
        for key in ("input_ids", "targets"):
            val = torch.as_tensor(batch[key]).long()
            out[key] = (val.to(self.device, non_blocking=True)
                        if self._rows is None else
                        host_to_global(val, self._dmesh, self._rows))
        return out

    def step(self, batch: Mapping[str, Any]) -> torch.Tensor:
        """One forward, backward, clip and AdamW update on the global batch
        (the same on every rank); returns the loss (0-dim, on the device,
        not synchronised; the global loss on every rank)."""
        b = self.shard_batch(batch)
        self.opt.zero_grad()
        loss = lm_loss(self.forward(b["input_ids"]), b["targets"])
        if _is_dtensor(loss):
            loss = loss.full_tensor()
        loss.backward()
        self.opt.step()
        return loss.detach()

    def tokens_per_batch(self, batch) -> int:
        ids = batch["input_ids"]
        return int(ids.numel() if torch.is_tensor(ids) else np.size(ids))


__all__ = ["PipelinedPretrainer", "merge_lm_params", "split_lm_params",
           "stacked_block_specs"]
