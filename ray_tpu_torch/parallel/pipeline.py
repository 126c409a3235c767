"""Pipeline parallelism: GPipe over the ``pp`` process group, the port of
``ray_tpu/parallel/pipeline.py``.

The reference runs one static program on every pp rank under
``shard_map``: a ``fori_loop`` of M + S - 1 ticks in which every rank runs
its stage and ``ppermute`` rotates the activations.  Here each rank runs
its own part of the same schedule in Python, and the activations move to
the next rank by ``torch.distributed`` P2P on the pp group:

- S stages, M microbatches, T = M + S - 1 ticks; rank 0 ingests microbatch
  t at tick t, rank r runs microbatch t - r at tick t, and the last rank
  emits microbatch t - (S - 1).  Bubble fraction (S - 1) / T.
- A tick on which a rank has no microbatch launches nothing (the reference
  computes a stage on garbage there and throws it away, its program being
  static); the last rank sends nothing back round to rank 0; the outputs
  are replicated by a broadcast from the last rank, not a ``psum`` of
  zeros.
- The backward runs the schedule in reverse: each rank takes the gradient
  of its tick's output from rank r + 1 (the last rank from its own output's
  gradient), back-propagates through the graph it kept from the forward
  (no recomputation: the reference's stages have no remat) and sends its
  input's gradient to rank r - 1.  The microbatches' gradient, which rank
  0 computes, is broadcast over pp, so that every rank gets the gradient
  of its replicated inputs whole.

``_Position`` holds one pp position's schedule, forward and backward, as
generators of its ticks: each tick yields what the position sends and
whether it receives.  ``pipeline_apply`` drives the rank's own position
with P2P in between; ``pipeline_apply_unrolled`` drives every position in
one process, in lockstep, handing each activation and gradient over by
reference.
Activations that are DTensors (the stages sharded over the other mesh axes)
travel as their local tensors, laid out as the microbatches are.
"""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ray_tpu_torch.ops.attention import _is_dtensor, _wait


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _stack(*leaves):
    if torch.is_tensor(leaves[0]):
        return torch.stack(leaves)
    return np.stack([np.asarray(x) for x in leaves])


def stack_stage_params(per_stage_params: Sequence[Any]) -> Any:
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage dim
    (numpy arrays or tensors, in nested dicts, lists or tuples)."""
    return _tree_map(_stack, *per_stage_params)


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a stage's parameters: a module's parameters, or the
    tensor leaves of nested dicts, lists and tuples."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, Mapping):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


class _Layout:
    """How a DTensor microbatch is laid out: the mesh, the placements of
    one microbatch (those of the (M, ...) tensor with each sharded dim one
    lower) and its global shape.  A tick's input and output are this
    microbatch's local tensor."""

    def __init__(self, xs):
        from torch.distributed.tensor import Shard

        if any(p.is_shard(0) for p in xs.placements):
            raise ValueError("the microbatch dim of a DTensor's (M, ...) "
                             "microbatches must not be sharded")
        self.mesh = xs.device_mesh
        self.placements = [Shard(p.dim - 1) if p.is_shard() else p
                           for p in xs.placements]
        self.shape = tuple(xs.shape[1:])

    def wrap(self, x):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(x, self.mesh, self.placements,
                                  run_check=False, shape=self.shape,
                                  stride=_contiguous_stride(self.shape))

    def unwrap(self, y):
        return y.redistribute(self.mesh, self.placements).to_local()


class _Position:
    """Pipeline position ``rank`` of ``n_stages``: its stage function and
    parameters, and the graph of each microbatch it ran, kept from its
    forward tick to its backward tick."""

    def __init__(self, stage_fn: Callable, params, rank: int,
                 n_stages: int, n_micro: int, layout: Optional[_Layout]):
        self.stage_fn, self.params = stage_fn, params
        self.leaves = [p for p in _leaves(params) if p.requires_grad]
        self.rank, self.n_stages, self.n_micro = rank, n_stages, n_micro
        self.layout = layout
        self.graphs = {}
        self.grads: List[Optional[torch.Tensor]] = [None] * len(self.leaves)

    def microbatch(self, t: int) -> Optional[int]:
        """The microbatch this position runs at tick ``t``, or None."""
        mb = t - self.rank
        return mb if 0 <= mb < self.n_micro else None

    def forward(self, mb: int, x: torch.Tensor, keep: bool) -> torch.Tensor:
        """The stage on microbatch ``mb``'s input ``x`` (a local tensor);
        with ``keep``, the tick's graph is kept for ``backward``.  Returns
        the output, a local tensor shaped as ``x``, outside any graph."""
        x_in = x.detach().requires_grad_(keep)
        with torch.set_grad_enabled(keep):
            h = x_in if self.layout is None else self.layout.wrap(x_in)
            y = self.stage_fn(self.params, h)
            if self.layout is not None:
                y = self.layout.unwrap(y)
        if y.shape != x.shape or y.dtype != x.dtype:
            raise ValueError(f"a pipeline stage maps {tuple(x.shape)} "
                             f"{x.dtype} to {tuple(y.shape)} {y.dtype}; its "
                             "output must be shaped as its input")
        if keep:
            self.graphs[mb] = (x_in, y)
        return y.detach()

    def backward(self, mb: int, g: torch.Tensor) -> torch.Tensor:
        """Back-propagate ``g``, the gradient of microbatch ``mb``'s output,
        through the graph its forward kept: adds the parameters' gradients
        into ``self.grads`` and returns the input's gradient."""
        x_in, y = self.graphs.pop(mb)
        got = torch.autograd.grad(y, [x_in, *self.leaves], g,
                                  allow_unused=True)
        for i, gp in enumerate(got[1:]):
            if gp is not None:
                self.grads[i] = gp if self.grads[i] is None else (
                    self.grads[i] + gp)
        return torch.zeros_like(x_in) if got[0] is None else got[0]

    def forward_ticks(self, xs: torch.Tensor, keep: bool):
        """This position's forward schedule, a generator of its ticks: at
        the end of tick t it yields what it sends to position r + 1 (or
        None) and whether it takes an input from position r - 1 for tick
        t + 1, and is sent that input.  Returns the outputs by microbatch
        (None but on the last position)."""
        r, last = self.rank, self.n_stages - 1
        outs, x = [None] * self.n_micro, None
        for t in range(self.n_micro + last):
            mb, y = self.microbatch(t), None
            if mb is not None:
                y = self.forward(mb, xs[mb] if r == 0 else x, keep)
                if r == last:
                    outs[mb] = y
            x = yield (y if r < last else None,
                       r > 0 and self.microbatch(t + 1) is not None)
        return outs

    def backward_ticks(self, g_outs: torch.Tensor):
        """The backward schedule, the forward's ticks in reverse, as
        ``forward_ticks``: it yields what it sends to position r - 1 and
        whether it takes a gradient from position r + 1.  Only the last
        position's output gradient enters (the outputs, and so what each
        rank computes from them, are replicated).  Returns the
        microbatches' gradients (None but on position 0)."""
        r, last = self.rank, self.n_stages - 1
        gxs, g = [None] * self.n_micro, None
        for t in reversed(range(self.n_micro + last)):
            mb, gx = self.microbatch(t), None
            if mb is not None:
                gx = self.backward(mb, g_outs[mb] if r == last else g)
                if r == 0:
                    gxs[mb] = gx
            g = yield (gx if r > 0 else None,
                       r < last and self.microbatch(t - 1) is not None)
        return gxs


class _Ranked:
    """This rank's position driven over ``group``: what a tick sends goes
    to the neighbouring rank by P2P at the end of the tick, and the
    outputs, and the microbatches' gradient, are broadcast at the end."""

    def __init__(self, pos: _Position, group):
        self.pos, self.group = pos, group

    def _peer(self, r: int) -> int:
        return dist.get_global_rank(self.group, r)

    def _exchange(self, send: Optional[torch.Tensor], to: int,
                  recv_like: Optional[torch.Tensor], frm: int):
        """Send ``send`` to pp rank ``to`` and receive a tensor like
        ``recv_like`` from pp rank ``frm``, each when given, in one batch:
        the received tensor, or None."""
        ops, buf = [], None
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(),
                                  self._peer(to), self.group))
        if recv_like is not None:
            buf = torch.empty_like(recv_like)
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(frm),
                                  self.group))
        if ops:
            _wait(dist.batch_isend_irecv(ops))
        return buf

    def _drive(self, ticks, step: int, like: torch.Tensor):
        """Run a tick generator to its end, sending to pp rank r + step and
        receiving from r - step: its return value."""
        r, got = self.pos.rank, None
        while True:
            try:
                send, want = ticks.send(got)
            except StopIteration as done:
                return done.value
            got = self._exchange(send, r + step, like if want else None,
                                 r - step)

    def forward(self, xs: torch.Tensor, keep: bool) -> torch.Tensor:
        pos, last = self.pos, self.pos.n_stages - 1
        outs = self._drive(pos.forward_ticks(xs, keep), 1, xs[0])
        out = torch.stack(outs) if pos.rank == last else torch.empty_like(xs)
        dist.broadcast(out, self._peer(last), group=self.group)
        return out

    def backward(self, g_outs: torch.Tensor):
        pos = self.pos
        gxs = self._drive(pos.backward_ticks(g_outs), -1, g_outs[0])
        out = (torch.stack(gxs) if pos.rank == 0 else
               torch.empty(g_outs.shape, dtype=g_outs.dtype,
                           device=g_outs.device))
        dist.broadcast(out, self._peer(0), group=self.group)
        return out, pos.grads


class _Unrolled:
    """Every position driven in one process, in lockstep: what position r
    sends at the end of a tick is its neighbour's input at the next,
    handed over by reference on the microbatches' device."""

    def __init__(self, positions: List[_Position]):
        self.positions = positions

    @staticmethod
    def _drive(ticks, step: int, like: torch.Tensor) -> list:
        """Run every position's tick generator, tick by tick: what position
        r sends goes to r + step.  Their return values."""
        n, got = len(ticks), [None] * len(ticks)
        while True:
            sent, wants, done = [None] * n, [], []
            for r, gen in enumerate(ticks):
                try:
                    send, want = gen.send(got[r])
                except StopIteration as stop:
                    done.append(stop.value)
                    continue
                wants.append(want)
                if send is None:
                    continue
                if send.device != like.device:
                    raise RuntimeError(f"the unrolled pipeline moved a tensor "
                                       f"from {like.device} to {send.device}")
                sent[r + step] = send
            if done:  # every position has the same ticks
                return done
            if [s is not None for s in sent] != wants:
                raise RuntimeError("a pipeline tick's sends and receives do "
                                   "not pair up, as the ranks' P2P needs")
            got = sent

    def forward(self, xs: torch.Tensor, keep: bool) -> torch.Tensor:
        outs = self._drive([pos.forward_ticks(xs, keep)
                            for pos in self.positions], 1, xs)
        return torch.stack(outs[-1])

    def backward(self, g_outs: torch.Tensor):
        gxs = self._drive([pos.backward_ticks(g_outs)
                           for pos in self.positions], -1, g_outs)
        return torch.stack(gxs[0]), [g for pos in self.positions
                                     for g in pos.grads]


class _Pipeline(torch.autograd.Function):
    """A schedule (``_Ranked`` or ``_Unrolled``) as an autograd op of the
    microbatches and the stage parameters it runs."""

    @staticmethod
    def forward(ctx, schedule, xs, *leaves):
        ctx.schedule = schedule
        return schedule.forward(xs, keep=True)

    @staticmethod
    def backward(ctx, g_outs):
        gxs, grads = ctx.schedule.backward(g_outs)
        return (None, gxs, *grads)


def _run(schedule, positions, microbatches):
    """``schedule`` on ``microbatches`` (a tensor, or a DTensor whose local
    tensor travels), recorded for autograd when a gradient is wanted."""
    xs = microbatches.to_local() if _is_dtensor(microbatches) else microbatches
    leaves = [p for pos in positions for p in pos.leaves]
    if torch.is_grad_enabled() and (xs.requires_grad or leaves):
        out = _Pipeline.apply(schedule, xs, *leaves)
    else:
        out = schedule.forward(xs, keep=False)
    if not _is_dtensor(microbatches):
        return out
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(out, microbatches.device_mesh,
                              microbatches.placements, run_check=False,
                              shape=microbatches.shape,
                              stride=microbatches.stride())


def _layout(microbatches) -> Optional[_Layout]:
    return _Layout(microbatches) if _is_dtensor(microbatches) else None


def pipeline_apply(stage_fn: Callable, stage_params, microbatches, *, group):
    """Run ``stage_fn(stage_params, x)`` as one stage of a GPipe pipeline
    over the ranks of ``group`` (the pp process group), stage r on its
    rank r.

    Args:
      stage_fn: one pipeline stage, mapping a microbatch to a tensor of the
        same shape and dtype; the same function on every rank.
      stage_params: this rank's own stage parameters (a module, or nested
        dicts, lists or tuples of tensors); the gradients of those that
        require one flow back through the pipeline.
      microbatches: (M, ...) microbatch inputs, the same on every rank of
        ``group``: a tensor, or a DTensor on the mesh of the other axes
        whose dim 0 is not sharded (each rank's local tensor travels).
    Returns: the (M, ...) outputs of the last stage, on every rank of
    ``group``, as ``microbatches`` is.  Differentiable: the outputs'
    gradient is taken from the last rank (every rank's is the same, the
    outputs being replicated), and the microbatches' gradient reaches every
    rank.  With NCCL, run a collective on ``group`` before the first call:
    a rank of the fill or drain takes no part in some ticks' P2P, and NCCL
    wants every rank of a group in its first P2P batch.
    """
    layout = _layout(microbatches)
    pos = _Position(stage_fn, stage_params, group.rank(), group.size(),
                    microbatches.shape[0], layout)
    return _run(_Ranked(pos, group), [pos], microbatches)


def pipeline_apply_unrolled(stage_fn: Callable,
                            per_stage_params: Sequence[Any], microbatches):
    """``pipeline_apply`` with every position in this process: position r
    runs ``stage_fn(per_stage_params[r], x)``, each tick's positions in
    turn, and each activation and gradient passes to the next position by
    reference, on the device it was made on.  The same ticks as the
    distributed schedule, so the same results: for checking the schedule,
    and for running it where one process holds every stage (one card)."""
    layout = _layout(microbatches)
    positions = [_Position(stage_fn, params, r, len(per_stage_params),
                           microbatches.shape[0], layout)
                 for r, params in enumerate(per_stage_params)]
    return _run(_Unrolled(positions), positions, microbatches)


__all__ = ["pipeline_apply", "pipeline_apply_unrolled", "stack_stage_params"]
