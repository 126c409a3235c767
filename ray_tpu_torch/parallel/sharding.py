"""Partition rules over DTensor: the port of ``ray_tpu/parallel/sharding.py``.

The same regex tables over the same flax-style paths
(``h_0/attn/qkv_proj/kernel``), first match wins, scalars and size-1 leaves
replicated.  A spec is a tuple with one entry a tensor dim: an axis name, a
tuple of axis names (one dim sharded over several mesh axes, the first
major), or ``None``; a spec shorter than the tensor leaves the rest
replicated, as a JAX ``PartitionSpec`` does.

Two things differ from the JAX side:

- a torch ``Linear.weight`` is the flax ``kernel`` transposed, (out, in)
  against (in, out), so ``match_partition_rules`` swaps the two entries of
  every Dense spec; an ``embedding`` is (V, E) on both sides and keeps its
  spec.  Each port parameter finds its flax path through
  ``models/convert.flax_paths``, the inverse of ``params_from_flax``;
- GSPMD's collectives are DTensor's: ``placements`` turns a spec into one
  ``Shard``/``Replicate`` a mesh dim, ``host_to_global`` builds a DTensor
  from the host value every rank holds (no bytes cross the wire), and
  ``with_sharding_constraint`` is a ``redistribute``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np

Spec = Tuple[Any, ...]


def _spec(*axes) -> Spec:
    return tuple(axes)


class PartitionRules:
    def __init__(self, rules: Sequence[Tuple[str, Spec]]):
        self.rules = list(rules)

    def spec_for(self, path: str, shape: Tuple[int, ...]) -> Spec:
        if len(shape) == 0 or int(np.prod(shape)) == 1:
            return _spec()
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                return spec
        return _spec()  # replicate by default


def gpt_partition_rules() -> PartitionRules:
    """Megatron-style TP + FSDP sharding for the GPT family, on the flax
    layout: weight matrices split on 'tp', the other large dim over
    'fsdp'."""
    return PartitionRules([
        # embeddings: (vocab, embed) — vocab on tp, embed on fsdp
        (r"wte/embedding", _spec("tp", "fsdp")),
        (r"wpe/embedding", _spec(None, "fsdp")),
        # attention qkv: (embed, heads*head_dim) — split heads over tp
        (r"attn/(q|k|v|qkv)_proj/kernel", _spec("fsdp", "tp")),
        (r"attn/out_proj/kernel", _spec("tp", "fsdp")),
        # mlp: (embed, 4*embed) in, (4*embed, embed) out
        (r"mlp/fc_in/kernel", _spec("fsdp", "tp")),
        (r"mlp/fc_out/kernel", _spec("tp", "fsdp")),
        # biases/layernorms replicated
        (r"bias|scale|ln", _spec()),
        # lm head (embed, vocab)
        (r"lm_head/kernel", _spec("fsdp", "tp")),
        # MoE experts: leading expert dim over ep (models/moe.py)
        (r"router/kernel", _spec()),
        (r"moe_mlp/w_in", _spec("ep", "fsdp", "tp")),
        (r"moe_mlp/w_out", _spec("ep", "tp", "fsdp")),
    ])


def llama_partition_rules() -> PartitionRules:
    """The same recipe for the Llama family, names matched to its
    RoPE/RMSNorm/SwiGLU module layout."""
    return PartitionRules([
        (r"wte/embedding", _spec("tp", "fsdp")),
        (r"attn/(wq|wk|wv)/kernel", _spec("fsdp", "tp")),
        (r"attn/wo/kernel", _spec("tp", "fsdp")),
        (r"mlp/(gate_proj|up_proj)/kernel", _spec("fsdp", "tp")),
        (r"mlp/down_proj/kernel", _spec("tp", "fsdp")),
        (r"norm|scale", _spec()),
        (r"lm_head/kernel", _spec("fsdp", "tp")),
    ])


def match_partition_rules(rules, model) -> Dict[str, Spec]:
    """Parameter name -> spec in the torch layout, for every parameter of
    ``model``: the spec the rules give its flax path and flax shape, its
    two entries swapped for a Dense kernel.  ``rules`` is a
    ``PartitionRules`` or a raw ``[(regex, spec), ...]`` sequence."""
    from ray_tpu_torch.models.convert import flax_paths

    if not isinstance(rules, PartitionRules):
        rules = PartitionRules(rules)
    paths = flax_paths(model)
    specs = {}
    for name, p in model.named_parameters():
        path = paths[name]
        kernel = path.endswith("/kernel")
        shape = tuple(p.shape[::-1]) if kernel else tuple(p.shape)
        spec = tuple(rules.spec_for(path, shape))
        if kernel and spec:
            spec = (spec + (None,) * (2 - len(spec)))[::-1]
        specs[name] = spec
    return specs


def placements(spec: Spec, mesh) -> list:
    """One placement a dim of ``mesh``: ``Shard(d)`` where the spec puts
    that axis on tensor dim ``d``, ``Replicate()`` elsewhere.  Axes the mesh
    lacks (dims of one rank, dropped by ``active_mesh``) shard nothing.
    Axes sharing a tensor dim must come in mesh order: DTensor splits a dim
    over its mesh dims outer first, as GSPMD splits it over a tuple's
    axes first-major."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        mesh_dims = [names.index(a) for a in axes if a in names]
        if mesh_dims != sorted(mesh_dims):
            raise ValueError(f"spec {spec}: the axes of dim {dim} are not in "
                             f"mesh order {tuple(names)}")
        for m in mesh_dims:
            if not isinstance(out[m], Replicate):
                raise ValueError(f"spec {spec} uses axis {names[m]} twice")
            out[m] = Shard(dim)
    return out


def host_to_global(x, mesh, placement):
    """Host value -> DTensor on ``mesh`` with ``placement`` (a spec or a
    list of placements).  Every caller holds the same full host value on
    every rank (seeded init, seeded batches), so each rank cuts its own
    shard, as DTensor's ``Shard`` cuts a dim (``torch.chunk``, outer mesh
    dim first), and moves it to the mesh's device; no bytes cross the
    wire."""
    import torch
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(placement, tuple):
        placement = placements(placement, mesh)
    coord = mesh.get_coordinate()
    local = x
    for m, pl in enumerate(placement):
        if isinstance(pl, Shard):
            n = mesh.size(m)
            chunks = torch.chunk(local, n, dim=pl.dim)
            local = (chunks[coord[m]] if coord[m] < len(chunks) else
                     local.narrow(pl.dim, 0, 0))
    local = local.to(mesh.device_type).contiguous()
    return DTensor.from_local(local, mesh, placement,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def shard_pytree(params: Mapping[str, Any], specs: Mapping[str, Spec],
                 mesh) -> Dict[str, Any]:
    """``host_to_global`` of every value by the spec of its name."""
    return {name: host_to_global(x, mesh, specs[name])
            for name, x in params.items()}


def with_sharding_constraint(x, spec: Spec, mesh=None):
    """Lay an intermediate DTensor out as ``spec`` says (on its own mesh
    unless another is given): a ``redistribute``."""
    mesh = mesh if mesh is not None else x.device_mesh
    return x.redistribute(mesh, placements(spec, mesh))


__all__ = ["PartitionRules", "Spec", "gpt_partition_rules", "host_to_global",
           "llama_partition_rules", "match_partition_rules", "placements",
           "shard_pytree", "with_sharding_constraint"]
