"""Device meshes over ``torch.distributed``: the port of
``ray_tpu/parallel/mesh.py``.

A rank is a device: one process drives one card (or, on the CPU, one gloo
rank).  ``MeshConfig`` sizes the logical axes exactly as the JAX package
does, -1 absorbing the rest; ``mesh_layout`` lays the world's ranks out in
the reference's dim order ``(pp, dp, fsdp, sp, tp, ep)``, with the DCN-major
merge of ``dcn_pp``/``dcn_dp`` into pp/dp when the mesh spans several
slices; ``build_mesh`` turns that layout into a
``torch.distributed.device_mesh.DeviceMesh``.  A slice is a host: ranks
group by ``LOCAL_WORLD_SIZE`` when the launcher sets it, and otherwise into
contiguous blocks, as JAX does on virtual platforms.

``active_mesh`` is the mesh that DTensors live on: the same ranks over only
the axes of more than one rank.  DTensor's sharding propagation enumerates
the placements of every mesh dim, so the four size-1 dims of a typical
mesh multiply its work (a linear layer's first step took minutes on a
six-dim gloo mesh, a fraction of a second on a two-dim one) and shard
nothing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

AXES = ("pp", "dp", "fsdp", "tp", "sp", "ep")
# outer -> inner: tp and ep innermost, on the closest links
MESH_ORDER = ("pp", "dp", "fsdp", "sp", "tp", "ep")


@dataclass(frozen=True)
class MeshConfig:
    """Sizes per logical axis; -1 on at most one axis means 'absorb the
    rest'.

    ``dcn_dp``/``dcn_pp`` extend the dp/pp axes across slices: the final
    size is ``dcn_axis * ici_axis`` with the DCN factor major, so
    neighbouring positions along dp/pp stay within a slice and only the
    outermost hop crosses slices."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1
    dcn_dp: int = 1
    dcn_pp: int = 1

    @property
    def n_slices(self) -> int:
        return self.dcn_dp * self.dcn_pp

    def resolve(self, n_devices: int) -> Dict[str, int]:
        """ICI (per-slice) sizes; wildcards absorb per-slice devices."""
        if n_devices % self.n_slices:
            raise ValueError(
                f"{n_devices} devices not divisible into {self.n_slices} "
                f"slices (dcn_dp={self.dcn_dp}, dcn_pp={self.dcn_pp})")
        per_slice = n_devices // self.n_slices
        sizes = {"pp": self.pp, "dp": self.dp, "fsdp": self.fsdp,
                 "tp": self.tp, "sp": self.sp, "ep": self.ep}
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        fixed = int(np.prod([v for v in sizes.values() if v != -1]))
        if wild:
            if per_slice % fixed:
                raise ValueError(
                    f"{per_slice} per-slice devices not divisible by fixed "
                    f"axes product {fixed}")
            sizes[wild[0]] = per_slice // fixed
        total = int(np.prod(list(sizes.values())))
        if total != per_slice:
            raise ValueError(
                f"mesh {sizes} covers {total} devices but {per_slice} are "
                f"present per slice")
        return sizes


def mesh_shape_for(n_devices: int, tp: int = 1, sp: int = 1, fsdp: int = 1,
                   ep: int = 1) -> Dict[str, int]:
    return MeshConfig(dp=-1, fsdp=fsdp, tp=tp, sp=sp, ep=ep).resolve(n_devices)


def as_mesh_config(config) -> MeshConfig:
    """``config`` as this module's ``MeshConfig``: ``None`` is the default,
    and any object with its fields (the JAX package's ``MeshConfig`` among
    them) is read field by field."""
    if config is None:
        return MeshConfig()
    if isinstance(config, MeshConfig):
        return config
    return MeshConfig(**{f: getattr(config, f)
                         for f in MeshConfig.__dataclass_fields__})


def _group_by_slice(ranks: Sequence[int], n_slices: int,
                    local_world_size: Optional[int] = None
                    ) -> List[List[int]]:
    """Partition ranks into slices: by host (``local_world_size`` ranks a
    host, contiguous as launchers number them) when it is known, folding
    several hosts into one slice when there are more hosts than slices;
    else contiguous equal blocks."""
    ranks = list(ranks)
    if local_world_size and len(ranks) % local_world_size == 0:
        hosts = [ranks[i:i + local_world_size]
                 for i in range(0, len(ranks), local_world_size)]
        if len(hosts) == n_slices:
            return hosts
        if len(hosts) % n_slices == 0 and len(hosts) > n_slices:
            per = len(hosts) // n_slices
            return [sum(hosts[i * per:(i + 1) * per], [])
                    for i in range(n_slices)]
    per = len(ranks) // n_slices
    return [ranks[i * per:(i + 1) * per] for i in range(n_slices)]


def _local_world_size() -> Optional[int]:
    val = os.environ.get("LOCAL_WORLD_SIZE")
    return int(val) if val else None


def mesh_layout(config: Optional[MeshConfig], n: int,
                local_world_size: Optional[int] = None) -> np.ndarray:
    """The ranks ``0..n-1`` as an array of shape (pp, dp, fsdp, sp, tp, ep):
    ``build_mesh``'s layout, as a pure function."""
    config = as_mesh_config(config)
    sizes = config.resolve(n)
    ici_shape = tuple(sizes[a] for a in MESH_ORDER)
    if config.n_slices == 1:
        return np.arange(n).reshape(ici_shape)
    # hybrid: stack per-slice meshes as (dcn_pp, dcn_dp, *ici_shape), then
    # merge the DCN factors into the pp/dp dims (DCN-major)
    groups = _group_by_slice(range(n), config.n_slices, local_world_size)
    stack = np.stack([np.asarray(g).reshape(ici_shape) for g in groups])
    stack = stack.reshape((config.dcn_pp, config.dcn_dp) + ici_shape)
    # (dcn_pp, dcn_dp, pp, dp, fsdp, sp, tp, ep)
    #   -> (dcn_pp, pp, dcn_dp, dp, fsdp, sp, tp, ep) -> merge pairs
    stack = np.transpose(stack, (0, 2, 1, 3, 4, 5, 6, 7))
    final_shape = (config.dcn_pp * sizes["pp"],
                   config.dcn_dp * sizes["dp"]) + ici_shape[2:]
    return stack.reshape(final_shape)


def _world_size() -> int:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs an initialised process group "
            "(torch.distributed.init_process_group): every rank of the "
            "world is a device of the mesh")
    return dist.get_world_size()


def build_mesh(config: Optional[MeshConfig] = None, device=None):
    """A ``DeviceMesh`` over every rank of the initialised process group,
    dims ``(pp, dp, fsdp, sp, tp, ep)`` laid out by ``mesh_layout``.
    ``device`` is the ranks' device type: the card unless ``"cpu"`` is
    asked for (a gloo gang)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from ray_tpu_torch._private.device import resolve_device

    layout = mesh_layout(config, _world_size(), _local_world_size())
    return DeviceMesh(resolve_device(device).type, torch.as_tensor(layout),
                      mesh_dim_names=MESH_ORDER)


def active_mesh(mesh):
    """``mesh`` over its dims of more than one rank, in its order (its
    first dim alone when every dim has one rank): the mesh DTensors live
    on."""
    names = [n for n, s in zip(mesh.mesh_dim_names, mesh.mesh.shape) if s > 1]
    return mesh[tuple(names) if names else mesh.mesh_dim_names[0]]


def local_mesh(axis: str = "dp", device=None):
    """A 1-axis mesh over the ranks of this host (single-host DP): the
    ``LOCAL_WORLD_SIZE`` ranks around this one, or the whole world when
    the launcher does not say."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from ray_tpu_torch._private.device import resolve_device

    n = _world_size()
    per_host = _local_world_size() or n
    layout = torch.arange(n).reshape(n // per_host, per_host)
    mesh = DeviceMesh(resolve_device(device).type, layout,
                      mesh_dim_names=("host", axis))
    return mesh[axis]


__all__ = ["AXES", "MESH_ORDER", "MeshConfig", "active_mesh", "as_mesh_config",
           "build_mesh", "local_mesh", "mesh_layout", "mesh_shape_for"]
