"""Stage partitioning for MPMD pipelines: the port of
``ray_tpu/train/pipeline/partition.py``.

- ``stage_ranges``, ``factor_gang`` and ``GangCoords`` are copies: a
  model's layer stack splits into N contiguous stages, and a trainer's
  world factors replica-major into dp replicas × N stage gangs;
- ``GPT2StageModule`` is one stage of ``models/gpt2.GPT2LMModel`` as an
  ``nn.Module``, built from the same blocks and keyed by the model's
  CANONICAL parameter names (``wte``, ``h_3``, ``ln_f``, ...) in the flax
  layout, so per-stage checkpoint shards merge back into one tree and
  re-split onto a *different* stage count, and a JAX stage's parameters
  load unchanged (``models/convert.params_from_flax``);
- a stage sharded over tp is a gang of tp workers, one card each, under
  one ``torch.distributed`` world (the JAX worker's tp local devices):
  ``pipeline_mesh`` is a one-dim ``tp`` ``DeviceMesh`` over that world
  (``None`` for a gang of one), ``GPT2StageModule.shard_over`` lays its
  parameters out as DTensors by ``gpt_partition_rules``, and
  ``make_shard_and_gather_fns`` moves a leaf between a full host array
  and its DTensor.  Every rank draws the same full seeded tree and keeps
  its shard, so a tp stage starts from an unsharded stage's weights.

Unlike the JAX stage, which switches every stage to reference attention
(``attention_impl="reference"``, a limit of the Pallas kernel under
GSPMD), the port keeps the config's attention: each stage runs the flash
kernels, over tp on each rank's share of the heads.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Any, Callable, Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.convert import flax_paths, params_from_flax
from ray_tpu_torch.models.gpt2 import (
    LN_EPS,
    Block,
    _dense,
    _embed,
    _layernorm,
    lm_loss,
    run_blocks,
)
from ray_tpu_torch.parallel.sharding import (
    gpt_partition_rules,
    match_partition_rules,
)


# ------------------------------------------------------------- stage layout
def stage_ranges(n_layer: int, n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous near-equal [lo, hi) layer ranges, one per stage.  The
    remainder layers go to the EARLIEST stages: stage 0 also owns the
    embedding lookup and the last stage owns ln_f + lm_head + loss, so the
    extra transformer block lands where the fixed costs are smallest."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_layer < n_stages:
        raise ValueError(
            f"cannot split {n_layer} layers into {n_stages} stages")
    base, rem = divmod(n_layer, n_stages)
    ranges, lo = [], 0
    for s in range(n_stages):
        hi = lo + base + (1 if s < rem else 0)
        ranges.append((lo, hi))
        lo = hi
    return ranges


# ----------------------------------------------------------- gang factoring
@dataclasses.dataclass(frozen=True)
class GangCoords:
    """One worker's position in the 3D factoring dp × pp × tp.

    Replica-major layout over world ranks: with ``g`` workers per stage
    gang, rank r maps to replica ``r // (P*g)``, stage ``(r // g) % P``,
    in-gang index ``r % g``.  All stage gangs of one replica are
    contiguous, so a replica is a contiguous rank block — the per-replica
    data shard is then just a contiguous row slice of the global batch."""
    replica: int
    stage: int
    gang_rank: int
    dp: int
    n_stages: int
    gang_size: int

    def dp_group_name(self, job: str) -> str:
        """Name (= KV-rendezvous key under ``collective/``) of this
        stage's cross-replica collective group: one persistent group per
        stage carrying the gradient allreduce, namespaced by job so two
        concurrent trainers never collide.  A stage over tp has one a
        lane: in-gang index j syncs its shards with index j of the other
        replicas."""
        lane = f"/t{self.gang_rank}" if self.gang_size > 1 else ""
        return f"train/{job}/stage{self.stage}{lane}/dp"


def factor_gang(world_rank: int, world_size: int, *, dp: int,
                n_stages: int) -> GangCoords:
    """Factor a flat trainer world into dp replicas × n_stages stage
    gangs (replica-major).  ``world_size`` must be divisible by
    ``dp * n_stages``; the quotient is the per-stage gang size."""
    worlds = dp * n_stages
    if dp < 1 or n_stages < 1:
        raise ValueError(f"dp={dp} and n_stages={n_stages} must be >= 1")
    if world_size % worlds:
        raise ValueError(
            f"world size {world_size} not divisible by dp*stages={worlds}")
    gang_size = world_size // worlds
    if not 0 <= world_rank < world_size:
        raise ValueError(f"rank {world_rank} out of range")
    w = world_rank // gang_size
    return GangCoords(replica=w // n_stages, stage=w % n_stages,
                      gang_rank=world_rank % gang_size, dp=dp,
                      n_stages=n_stages, gang_size=gang_size)


# ------------------------------------------------------- the stage's mesh
def pipeline_mesh(device=None):
    """The gang-local mesh of one stage: a one-dim ``tp`` ``DeviceMesh``
    over every rank of the initialised process group (``TorchConfig``
    brings up one world a stage gang, one card a rank), or ``None`` where
    there is no group or it has one rank: the stage then runs on its
    worker's card with plain tensors.  ``device`` is the ranks' device
    type: the card unless ``"cpu"`` is asked for (a gloo gang)."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import MeshConfig, active_mesh, build_mesh

    if not (dist.is_available() and dist.is_initialized()) or \
            dist.get_world_size() == 1:
        return None
    tp = dist.get_world_size()
    return active_mesh(build_mesh(MeshConfig(dp=1, tp=tp), device))


def _tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def make_shard_and_gather_fns(partition_specs, mesh=None, dtype_specs=None):
    """Per-leaf shard/gather callables for a tree of specs (the
    ``parallel/sharding`` spec tuples).

    ``shard_fns``: host value -> DTensor on ``mesh`` under the leaf's
    ``placements``, each rank cutting its own shard of the value every
    rank holds (``host_to_global``).  ``gather_fns``: DTensor -> full host
    ndarray (``full_tensor()``, a collective that every rank of the mesh
    enters); a host value passes as it is.  Both cast to the leaf of
    ``dtype_specs`` when given.  Without a mesh the shard is the identity
    too."""
    import torch

    from ray_tpu_torch.ops.attention import _is_dtensor
    from ray_tpu_torch.parallel.sharding import host_to_global, placements

    def _pair(spec, dtype=None):
        def cast(x):
            return x if dtype is None else np.asarray(x).astype(dtype)

        def shard_fn(x):
            if mesh is None:
                return cast(x)
            return host_to_global(torch.as_tensor(np.asarray(cast(x))),
                                  mesh, placements(spec, mesh))

        def gather_fn(x):
            if _is_dtensor(x):
                # a copy: a replicated leaf's full tensor is its local
                # one, which a later update would change under the array
                x = x.full_tensor().detach().to("cpu", copy=True).numpy()
            return cast(x)

        return shard_fn, gather_fn

    if dtype_specs is None:
        pairs = _tree_map(_pair, partition_specs)
    else:
        pairs = _tree_map(_pair, partition_specs, dtype_specs)
    return (_tree_map(lambda p: p[0], pairs),
            _tree_map(lambda p: p[1], pairs))


# --------------------------------------------------------- GPT-2 stage module
class GPT2StageModule(nn.Module):
    """One pipeline stage of ``GPT2LMModel``, keyed by canonical param names.

    Stage 0 owns the embeddings (wte/wpe) plus its block range; the last
    stage owns its blocks plus ln_f/lm_head and computes the loss.  The
    forward is built from the SAME blocks GPT2LMModel composes, so a
    1-stage pipeline reproduces the monolithic model's math.  Parameters
    are f32 on ``device`` (the card unless ``"cpu"`` is passed), named as
    the whole model names them (``h.3.attn.qkv_proj.weight``), and cross
    the module's edge as a flax-layout tree (``flax_params``,
    ``load_flax_params``).
    """

    def __init__(self, config, stage: int, n_stages: int, device=None):
        super().__init__()
        from ray_tpu_torch._private.device import resolve_device

        if config.moe_every:
            raise NotImplementedError("pipeline stages + MoE not composed yet")
        if config.attention_impl == "ring":
            raise NotImplementedError(
                "ring attention needs a sequence split over sp, which a "
                "pipeline stage does not have")
        self.config = config
        self.stage = int(stage)
        self.n_stages = int(n_stages)
        self.lo, self.hi = stage_ranges(config.n_layer, n_stages)[self.stage]
        self.is_first = self.stage == 0
        self.is_last = self.stage == self.n_stages - 1
        if self.is_first:
            self.wte = nn.Embedding(config.vocab_size, config.n_embd)
            self.wpe = nn.Embedding(config.n_positions, config.n_embd)
        self.h = nn.ModuleDict({str(i): Block(config)
                                for i in range(self.lo, self.hi)})
        if self.is_last:
            self.ln_f = nn.LayerNorm(config.n_embd, eps=LN_EPS)
            self.lm_head = nn.Linear(config.n_embd, config.vocab_size,
                                     bias=False)
        self.device = resolve_device(device)
        self.to(self.device)
        # set by shard_over: the stage's tp mesh and its per-name fns
        self.mesh = self.shard_fns = self.gather_fns = None

    # ------------------------------------------------------------ params
    def param_keys(self) -> List[str]:
        keys = [f"h_{i}" for i in range(self.lo, self.hi)]
        if self.is_first:
            keys = ["wte", "wpe"] + keys
        if self.is_last:
            keys = keys + ["ln_f", "lm_head"]
        return keys

    def init_params(self, seed: int = 0) -> Dict[str, Any]:
        """Init the FULL model with a fixed seed (``models/pretrain.
        init_params``, on the CPU) and select this stage's slice — every
        stage derives from the same deterministic tree, so a 1-stage and
        an N-stage job start from identical weights."""
        from ray_tpu_torch.models.pretrain import init_params

        model, _ = init_params(self.config, seed=seed, device="cpu")
        return self.select_params(module_flax_params(model))

    def select_params(self, full_params: Dict[str, Any]) -> Dict[str, Any]:
        return {k: full_params[k] for k in self.param_keys()}

    def flax_params(self) -> Dict[str, Any]:
        """This stage's parameters as a flax-layout tree of full host
        arrays; over tp each is gathered (every rank of the mesh must
        call this)."""
        return module_flax_params(self, self.gather_fns)

    @torch.no_grad()
    def load_flax_params(self, params: Mapping[str, Any]) -> None:
        """Copy a flax-layout tree of this stage's keys into the module;
        over tp each rank copies its own shard."""
        state = params_from_flax(self.select_params(params))
        own = dict(self.named_parameters())
        if set(state) != set(own):
            raise KeyError(f"stage {self.stage}: parameters missing "
                           f"{sorted(set(own) - set(state))}, unexpected "
                           f"{sorted(set(state) - set(own))}")
        for name, p in own.items():
            if self.shard_fns is None:
                p.copy_(state[name])
            else:
                p.to_local().copy_(self.shard_fns[name](state[name])
                                   .to_local())

    # ---------------------------------------------------------- sharding
    def specs(self) -> Dict[str, Any]:
        """Parameter name -> spec in the torch layout: the JAX stage's
        ``match_partition_rules(gpt_partition_rules(), params)`` with the
        two entries of each Dense kernel's spec swapped."""
        return match_partition_rules(gpt_partition_rules(), self)

    @torch.no_grad()
    def shard_over(self, mesh) -> None:
        """Every parameter replaced by its DTensor on ``mesh`` (the stage's
        ``tp`` mesh), each rank keeping its shard of the value it holds:
        Megatron's column- and row-parallel layout, so attention runs on
        each rank's share of the heads."""
        from ray_tpu_torch.models.pretrain import distribute

        specs = self.specs()
        self.shard_fns, self.gather_fns = make_shard_and_gather_fns(
            specs, mesh)
        distribute(self, mesh, specs)
        self.mesh = mesh

    # ----------------------------------------------------------- forward
    def forward(self, x, batch):
        """(carried activation, batch of device tensors) -> activation, or
        the scalar loss on the last stage."""
        cfg = self.config
        if self.is_first:
            ids = batch["input_ids"]
            embed = (_vocab_parallel_embed if self.mesh is not None
                     else _embed)
            x = (embed(self.wte.weight, ids, cfg.dtype)
                 + self.wpe.weight[:ids.shape[1]].to(cfg.dtype))
        x, _ = run_blocks([self.h[str(i)] for i in range(self.lo, self.hi)],
                          x, cfg)
        if not self.is_last:
            return x
        x = _layernorm(self.ln_f, x, cfg.dtype)
        logits = _dense(self.lm_head, x, cfg.dtype)
        return lm_loss(logits, batch["targets"], batch.get("mask"))


def _vocab_parallel_embed(table, ids, dtype: torch.dtype):
    """The rows ``ids`` of ``table``, a DTensor whose vocab dim is sharded
    over a one-dim tp mesh, in ``dtype``: Megatron's vocab-parallel lookup.
    Each rank looks the ids up in its own rows (zeros for the others'),
    and a sum over tp, an all-reduce of the (B, S, E) activations, gives
    every rank the rows; bit for bit the lookup in the whole table, which
    is never gathered (``models/gpt2._embed`` gathers it, a vocab x
    n_embd transient on every call).  The gradient reaches the table as
    its own shard."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = table.device_mesh
    local = table.to_local()
    # torch.chunk's split, as Shard(0) cuts the rows
    lo = mesh.get_local_rank() * -(-table.shape[0] // mesh.size())
    ids = ids.to_local() if isinstance(ids, DTensor) else ids
    inside = (ids >= lo) & (ids < lo + local.shape[0])
    rows = F.embedding((ids - lo).clamp(0, max(local.shape[0] - 1, 0)),
                       local.to(dtype))
    part = rows * inside.unsqueeze(-1).to(dtype)
    return DTensor.from_local(part, mesh, [Partial()],
                              run_check=False).redistribute(
                                  mesh, [Replicate()])


def module_flax_params(model: nn.Module, gather_fns=None) -> Dict[str, Any]:
    """A port GPT-2 model's (or stage's) parameters as the flax tree
    ``params_from_flax`` reads: f32 host arrays, Dense kernels (in, out).
    ``gather_fns`` (by parameter name) gathers DTensor parameters."""
    paths = flax_paths(model)
    flat = {}
    for name, p in model.named_parameters():
        if gather_fns is not None:
            arr = gather_fns[name](p.detach().float())
        else:
            arr = p.detach().float().to("cpu", copy=True).numpy()
        path = paths[name]
        if path.endswith("/kernel"):
            arr = arr.T
        flat[path] = np.ascontiguousarray(arr)
    return unflatten_params(flat)


# -------------------------------------------------- checkpoint shard helpers
_META_KEY = "__pipeline_meta__"


def flatten_params(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Nested canonical tree -> {'h_0/attn/qkv_proj/kernel': ndarray, ...}."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for key, val in node.items():
            name = f"{prefix}/{key}" if prefix else str(key)
            if isinstance(val, Mapping):
                walk(val, name)
            else:
                flat[name] = np.asarray(val)

    walk(params, "")
    return flat


def unflatten_params(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, arr in flat.items():
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def save_stage_shard(path: str, params: Dict[str, Any], *, stage: int,
                     n_stages: int, step: int,
                     gather_fns=None) -> None:
    """Write one stage's params (a flax-layout tree of host arrays) as an
    npz shard.  ``gather_fns`` (from make_shard_and_gather_fns) maps each
    leaf first; merged shards are stage-count independent."""
    if gather_fns is not None:
        params = _tree_map(lambda x, fn: fn(x), params, gather_fns)
    flat = flatten_params(params)
    flat[_META_KEY] = np.array([stage, n_stages, step], dtype=np.int64)
    np.savez(path, **flat)


def load_pipeline_checkpoint(ckpt_dir: str,
                             filename: str = "pipe_stage.npz"):
    """Merge every stage shard under a trainer checkpoint directory (the
    canonical dir plus the rank_<k>/ sibling shards _persist_checkpoint
    lays down) into (full param tree, step).  The union is keyed by
    canonical layer names, so the caller re-selects per-stage slices for
    ANY stage count."""
    paths = sorted(glob.glob(os.path.join(ckpt_dir, filename)) +
                   glob.glob(os.path.join(ckpt_dir, "rank_*", filename)))
    if not paths:
        raise FileNotFoundError(
            f"no pipeline stage shards ({filename}) under {ckpt_dir}")
    flat: Dict[str, np.ndarray] = {}
    step = 0
    for p in paths:
        with np.load(p) as z:
            for k in z.files:
                if k == _META_KEY:
                    step = max(step, int(z[k][2]))
                else:
                    flat[k] = z[k]
    return unflatten_params(flat), step
