"""Mixture-of-Experts FFN with expert parallelism over ``ep``: the port of
``ray_tpu/models/moe.py``.

The same dense Switch/GShard design: a router in f32 picks each token's top-k
experts (k rounds of argmax, each token queued behind the tokens before it
in its batch row, tokens past an expert's capacity dropped), and the
dispatch and combine are einsums against dense one-hot (G, S, E, C)
tensors, so no op is ragged.  The expert weights carry a leading
(n_experts,) dim that ``moe_partition_rules`` shards over ep.

The einsums are plain torch ops here as they are XLA ops there.  On a mesh
(DTensor activations) each rank routes its own batch rows, whole (a
routing group is a batch row: its queue positions are a cumsum over the
sequence, so a row split over sp is gathered first), and runs its own
experts (the ep shard) on its F slice (the tp shard) on plain local
tensors, the weights gathered over fsdp first; the expert outputs are
summed over tp and gathered over ep before the combine.  DTensor moves the
data (``redistribute``) and keeps the gradients' layouts, and the aux
losses are DTensor means over the whole batch.  DTensor's own einsum
rules are not used there: they fold sharded dims that torch 2.11's
DTensor refuses to fold.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models.gpt2 import _dense
from ray_tpu_torch.ops.attention import _is_dtensor


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    d_model: int = 768
    d_ff: int = 3072
    dtype: torch.dtype = torch.bfloat16
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


def _router_probs(logits: torch.Tensor) -> torch.Tensor:
    # f32 softmax: router numerics decide token placement
    return torch.softmax(logits.float(), dim=-1)


def _assign(probs: torch.Tensor, top_k: int, capacity: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch (G, S, E, C) one-hot and combine (G, S, E, C) weighted, for
    plain ``probs`` (G, S, E).  Round r takes each token's r-th choice
    (argmax, first index on ties); its queue position counts the tokens
    before it in the row that chose the same expert, after the slots the
    earlier rounds took (``occupancy``), so no two tokens share a slot.  A
    position outside [0, C) matches no slot and leaves a zero row, as
    ``jax.nn.one_hot`` does for -1 (unrouted) and for C or more
    (dropped).  The gate is the chosen probability, not renormalised over
    the k choices; the dispatch carries no gradient."""
    G, S, E = probs.shape
    experts = torch.arange(E, device=probs.device)
    slots = torch.arange(capacity, device=probs.device, dtype=probs.dtype)
    dispatch = probs.new_zeros((G, S, E, capacity))
    combine = probs.new_zeros((G, S, E, capacity))
    occupancy = probs.new_zeros((G, 1, E))
    remaining = probs
    for _ in range(top_k):
        onehot = (remaining.argmax(-1)[..., None] == experts).to(probs.dtype)
        pos = (onehot.cumsum(1) + occupancy) * onehot - 1.0
        # zero outside onehot's expert (pos is -1 there): onehot * pos_oh
        # is pos_oh
        pos_oh = (pos[..., None] == slots).to(probs.dtype)
        gate = (remaining * onehot).sum(-1)[..., None, None]
        dispatch = dispatch + pos_oh
        combine = combine + gate * pos_oh
        occupancy = occupancy + onehot.sum(1, keepdim=True)
        remaining = remaining * (1.0 - onehot)
    return dispatch, combine


def _balance_loss(probs, dispatch, n_experts: int):
    """Switch's load-balancing loss: E · Σ_e mean(probs_e) · mean(tokens
    dispatched to e), the fraction taken after dropping."""
    me = probs.mean((0, 1))
    ce = dispatch.sum(-1).mean((0, 1))
    return (me * ce).sum() * n_experts


def _whole_rows(logits) -> Tuple[torch.Tensor, Callable]:
    """(this rank's whole batch rows of ``logits`` as a plain tensor, the
    function that turns a tensor of those rows, led by the same (G, S)
    dims, back into a DTensor laid out as they are).  A DTensor keeps only
    its batch-dim sharding: a sequence split is gathered, anything else
    replicated.  A plain tensor comes back as it is, with the identity."""
    if not _is_dtensor(logits):
        return logits, lambda t: t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = logits.device_mesh
    rows = logits.redistribute(mesh, [p if p.is_shard(0) else Replicate()
                                      for p in logits.placements])
    G, S = logits.shape[:2]

    def to_global(t):
        shape = (G, S) + tuple(t.shape[2:])
        return DTensor.from_local(t, mesh, rows.placements, run_check=False,
                                  shape=shape,
                                  stride=torch.empty(shape, device="meta")
                                  .stride())
    return rows.to_local(), to_global


def compute_routing(logits, n_experts: int, top_k: int, capacity: int):
    """Dense Switch/GShard routing of ``logits`` (G, S, E), G routing groups
    (batch rows): (dispatch (G, S, E, C) one-hot, combine (G, S, E, C)
    weighted, the load-balancing loss), as ``ray_tpu.models.moe`` computes
    them.  A DTensor is routed on each rank's whole rows."""
    rows, to_global = _whole_rows(logits)
    probs = _router_probs(rows)
    dispatch, combine = _assign(probs, top_k, capacity)
    probs, dispatch, combine = map(to_global, (probs, dispatch, combine))
    return dispatch, combine, _balance_loss(probs, dispatch, n_experts)


def _expert_ffn(x, dispatch, w_in, w_out, dtype):
    """Each expert's FFN on the tokens dispatched to it: (E, B, C, D) from x
    (B, S, D), dispatch (B, S, E, C), w_in (E, D, F), w_out (E, F, D), all
    in ``dtype``."""
    expert_in = torch.einsum("bsd,bsec->ebcd", x.to(dtype),
                             dispatch.to(dtype))
    h = torch.einsum("ebcd,edf->ebcf", expert_in, w_in.to(dtype))
    h = F.gelu(h, approximate="tanh")
    return torch.einsum("ebcf,efd->ebcd", h, w_out.to(dtype))


class MoEMlpBlock(nn.Module):
    """Expert-parallel FFN: ``forward(x)`` of x (B, S, D) gives (out (B, S,
    D) in ``config.dtype``, this layer's aux term ``router_aux_weight ·
    aux + router_z_weight · z``).  The flax names: ``router`` (a Linear
    without bias, computed in f32), ``w_in`` (E, D, F) and ``w_out`` (E,
    F, D), kept in the flax layout.  Parameters are created on the CPU
    (the model moves them)."""

    def __init__(self, config: MoEConfig):
        super().__init__()
        self.config = config
        E, D, Fd = config.n_experts, config.d_model, config.d_ff
        self.router = nn.Linear(D, E, bias=False)
        self.w_in = nn.Parameter(torch.empty(E, D, Fd))
        self.w_out = nn.Parameter(torch.empty(E, Fd, D))

    def forward(self, x):
        cfg = self.config
        B, S, D = x.shape
        E = cfg.n_experts
        # per routing group (one batch row): sizing it from B*S would
        # inflate the dispatch tensors and the expert FFN by a factor of B
        capacity = max(int(cfg.capacity_factor * S * cfg.top_k / E), 1)
        router = _dense(self.router, x, torch.float32)          # (B, S, E)
        rows, to_global = _whole_rows(router)
        probs = _router_probs(rows)
        dispatch, combine = _assign(probs, cfg.top_k, capacity)
        aux = _balance_loss(to_global(probs), to_global(dispatch), E)
        # the router z-loss keeps the logits bounded (GShard, ST-MoE)
        z = to_global(torch.logsumexp(rows, dim=-1)).pow(2).mean()
        term = cfg.router_aux_weight * aux + cfg.router_z_weight * z

        dtype = cfg.dtype
        if _is_dtensor(x):
            return self._on_mesh(x, dispatch, combine), term
        expert_out = _expert_ffn(x, dispatch, self.w_in, self.w_out, dtype)
        out = torch.einsum("ebcd,bsec->bsd", expert_out, combine.to(dtype))
        return out.to(dtype), term

    def _on_mesh(self, x, dispatch, combine):
        """The experts for a DTensor ``x``, given this rank's whole rows'
        plain ``dispatch`` and ``combine``: this rank's experts on its F
        slice, their outputs summed over tp and gathered over ep, then the
        combine of its rows; the output laid out as ``x``.  Each local
        tensor's gradient is declared as the partial sum it is."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        mesh, dtype = x.device_mesh, self.config.dtype
        names = mesh.mesh_dim_names
        batch = [n for n, p in zip(names, x.placements) if p.is_shard(0)]

        def layout(**by_axis):
            return [by_axis.get(n, Replicate()) for n in names]
        rows = layout(**{n: Shard(0) for n in batch})
        # x's gradient here comes from this rank's experts and F slice
        x_rows = x.redistribute(mesh, rows).to_local(grad_placements=layout(
            **{n: Shard(0) for n in batch}, ep=Partial(), tp=Partial()))

        def gathered(w):  # the weight whole over fsdp; its gradient is
            # this rank's rows' part
            whole = w.redistribute(mesh, [Replicate() if n == "fsdp" else p
                                          for n, p in zip(names,
                                                          w.placements)])
            return whole.to_local(grad_placements=[
                Partial() if n in batch else p
                for n, p in zip(names, whole.placements)])
        w_in, w_out = gathered(self.w_in), gathered(self.w_out)
        first = 0
        if "ep" in names:  # Shard(0) cuts the experts as torch.chunk does
            per = -(-dispatch.shape[2] // mesh.size(names.index("ep")))
            first = mesh.get_local_rank("ep") * per
        mine = dispatch[:, :, first:first + w_in.shape[0]]
        expert_out = _expert_ffn(x_rows, mine, w_in, w_out, dtype)
        # every expert's output for these rows: summed over tp (F),
        # gathered over ep
        expert_out = DTensor.from_local(
            expert_out, mesh, layout(**{n: Shard(1) for n in batch},
                                     ep=Shard(0), tp=Partial()),
            run_check=False).redistribute(
                mesh, layout(**{n: Shard(1) for n in batch})).to_local()
        out = torch.einsum("ebcd,bsec->bsd", expert_out, combine.to(dtype))
        return DTensor.from_local(out, mesh, rows, run_check=False,
                                  shape=x.shape, stride=x.stride()
                                  ).redistribute(mesh, x.placements)


def moe_partition_rules():
    """The rules for MoE parameters: experts over ep, then fsdp and tp
    within (``gpt_partition_rules`` holds them too)."""
    from ray_tpu_torch.parallel.sharding import PartitionRules, _spec

    return PartitionRules([
        (r"router/kernel", _spec()),
        (r"w_in", _spec("ep", "fsdp", "tp")),
        (r"w_out", _spec("ep", "tp", "fsdp")),
    ])


def collect_moe_aux_loss(terms: Iterable):
    """The sum of every MoE layer's aux term (what the model's forward
    appended to its ``intermediates`` list); 0 when there are none."""
    total = 0.0
    for term in terms:
        total = total + term
    return total


__all__ = ["MoEConfig", "MoEMlpBlock", "collect_moe_aux_loss",
           "compute_routing", "moe_partition_rules"]
