"""Deterministic 1F1B schedule generation + per-stage execution: the port
of ``ray_tpu/train/pipeline/schedule.py``.

``one_f_one_b`` emits the full op list for one optimizer step of one stage —
warmup forwards (fill), steady 1F1B interleave, cooldown backwards (drain),
one optim step — as plain data, so tests can assert the exact schedule and
the executor is a dumb interpreter: no control flow depends on timing.
``one_f_one_b``, ``PipelineOp``, ``BubbleClock`` and
``theoretical_bubble_fraction`` are copies.

``StageExecutor`` runs that op list over a ``GPT2StageModule`` on its card,
or over a stage gang of tp cards (``mesh``, the stage's ``tp`` mesh).
Where the JAX executor's forward and backward are jit/vjp calls that
recompute the stage forward in the backward, the port keeps each in-flight
microbatch's autograd graph from its forward (its output, and its received
input with ``requires_grad``) and runs ``torch.autograd.backward`` on it
with the gradient the next stage sent.  Gradients accumulate in f32 across
the M microbatches in the parameters' ``.grad``; the global-norm clip is
exact across stages: grad-norm partials ride the upstream grad frames,
stage 0 reduces them (and the microbatch losses) and broadcasts one commit
frame downstream so every stage applies the identical clip scale, after
which AdamW on optax's warmup-cosine schedule (``make_pipeline_optimizer``)
updates the parameters without a clip of its own.  Activations and
gradients cross the links as CPU tensors in the compute dtype (bf16
included), through the port's tensor serializer.  Per-op wall clock is
split into compute / transfer / wait buckets.

Over tp (the JAX executor's GSPMD stage, ``ray_tpu/train/pipeline/
schedule.py:185-196,240-262``) the parameters, gradients and AdamW's state
are DTensors laid out by ``gpt_partition_rules``, and each tp rank of a
stage talks to the same tp rank of the next (a lane): the stage's output
leaves as the local tensor of a replicated DTensor (after the
row-parallel reduction every rank holds all of it), and an incoming
activation or gradient frame is wrapped as one.  Each microbatch's
gradients accumulate in DTensors laid out as their parameters
(``PipelineOptimizer``), AdamW steps each rank's local shards, and the
norm counts each element once: the sharded gradients' sums of squares
summed over tp, the replicated ones added as they are.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch._private import fault_injection
from ray_tpu_torch.models.pretrain import warmup_cosine_decay
from ray_tpu_torch.ops.attention import _is_dtensor
from ray_tpu_torch.train.pipeline import channels as pipechan

# op kinds, in the order they appear inside one microbatch's slot
OP_KINDS = ("recv_act", "fwd", "send_act", "recv_grad", "bwd", "send_grad",
            "optim")


@dataclasses.dataclass(frozen=True)
class PipelineOp:
    kind: str
    micro: int = -1  # -1 for optim

    def __str__(self):
        return self.kind if self.micro < 0 else f"{self.kind}({self.micro})"


def one_f_one_b(stage: int, n_stages: int, n_micro: int) -> List[PipelineOp]:
    """The deterministic per-stage op list for one optimizer step.

    Warmup depth is ``min(S - 1 - stage, M)`` forwards, then the steady
    one-forward-one-backward interleave, then the cooldown drains the
    remaining backwards; bubble fraction approaches (S-1)/(S-1+M)
    (arXiv:2412.14374 §2).
    """
    if not (0 <= stage < n_stages):
        raise ValueError(f"stage {stage} out of range for {n_stages}")
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    first, last = stage == 0, stage == n_stages - 1
    ops: List[PipelineOp] = []

    def _fwd(i):
        if not first:
            ops.append(PipelineOp("recv_act", i))
        ops.append(PipelineOp("fwd", i))
        if not last:
            ops.append(PipelineOp("send_act", i))

    def _bwd(i):
        if not last:
            ops.append(PipelineOp("recv_grad", i))
        ops.append(PipelineOp("bwd", i))
        if not first:
            ops.append(PipelineOp("send_grad", i))

    warmup = min(n_stages - 1 - stage, n_micro)
    for i in range(warmup):
        _fwd(i)
    for k in range(n_micro):
        if warmup + k < n_micro:
            _fwd(warmup + k)
        _bwd(k)
    ops.append(PipelineOp("optim"))
    return ops


def theoretical_bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_stages - 1 + n_micro)


# ------------------------------------------------------------- bubble clock
class BubbleClock:
    """Per-step wall-clock split: compute (fwd/bwd/optim), transfer
    (send/serialize), wait (blocked on a peer — the bubble), comm (the dp
    collective: bucket packing/launch + time blocked at the clip barrier).

    ``comm`` is its own bucket so collective waits don't inflate ``wait``:
    the bubble fraction keeps meaning "1F1B schedule stall", and overlap
    claims are measured against the comm bucket instead of inferred."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.compute_s = 0.0
        self.xfer_s = 0.0
        self.wait_s = 0.0
        self.comm_s = 0.0
        self._t0 = time.monotonic()

    def charge(self, kind: str, seconds: float):
        if kind in ("fwd", "bwd", "optim"):
            self.compute_s += seconds
        elif kind == "comm":
            self.comm_s += seconds
        elif kind.startswith("send"):
            self.xfer_s += seconds
        else:
            self.wait_s += seconds

    def summary(self) -> Dict[str, float]:
        wall = max(time.monotonic() - self._t0, 1e-9)
        return {
            "step_wall_s": wall,
            "busy_s": self.compute_s,
            "xfer_s": self.xfer_s,
            "bubble_s": self.wait_s,
            "bubble_fraction": self.wait_s / wall,
            "comm_s": self.comm_s,
        }


class PipelineOptimizer:
    """``optax.adamw(warmup_cosine_decay_schedule(0, lr, warmup,
    max(total_steps, warmup + 1)), b1=0.9, b2=0.95, weight_decay=...)``,
    ``models/pretrain.Optimizer`` without its clip: ``step(scale)`` first
    multiplies every gradient by ``scale`` (the 1/M mean times the clip
    scale the stages agreed on), then takes AdamW at the schedule's rate
    for the update count before this one.

    DTensor parameters (a stage over tp) are updated through their local
    shards, as ``models/pretrain.Optimizer`` updates them: AdamW is
    elementwise, so that is exact, and its state lives beside each shard.
    Each one's gradient is a DTensor laid out as the parameter, made once
    (``_make_state``): the backward adds each microbatch's gradient into
    it in place, redistributed to that layout, and ``grads()`` are its
    local shards."""

    def __init__(self, params, lr: float, weight_decay: float, warmup: int,
                 total_steps: int):
        self.params = list(params)
        with torch.no_grad():
            self.local = [p.to_local() if _is_dtensor(p) else p
                          for p in self.params]
        self.lr, self.warmup, self.total_steps = lr, warmup, total_steps
        self.adamw = torch.optim.AdamW(self.local, lr=0.0, betas=(0.9, 0.95),
                                       eps=1e-8, weight_decay=weight_decay)
        self.count = 0
        self._make_state()

    @torch.no_grad()
    def _make_state(self) -> None:
        """Make AdamW's moments and the gradients' buffers now, before the
        first step's activations, so that step 1 finds the stage at the
        memory it keeps.  Made lazily, the moments took the blocks step 0's
        activations had freed, and step 1 took new segments from CUDA
        (``cudaMalloc``), which stalls while another process uses the
        card.  AdamW makes its state its own way in a step at lr 0 on
        zero gradients, which leaves every parameter as it was (the decay
        multiplies by 1, the update adds -0 times 0); its step count is
        then set back to 0, so the first real step is the first.  A
        DTensor parameter's gradient is a DTensor (so the backward
        accumulates into it), and its local shard the buffer AdamW reads."""
        for p, local in zip(self.params, self.local):
            p.grad = torch.zeros_like(p)
            if local is not p:
                local.grad = p.grad.to_local()
        self.adamw.step()
        for state in self.adamw.state.values():
            state["step"].zero_()

    def grads(self) -> List[torch.Tensor]:
        return [p.grad for p in self.local]

    @torch.no_grad()
    def step(self, scale: float) -> None:
        torch._foreach_mul_(self.grads(), scale)
        for group in self.adamw.param_groups:
            group["lr"] = warmup_cosine_decay(self.count, self.lr,
                                              self.warmup, self.total_steps)
        self.adamw.step()
        self.count += 1

    def zero_grad(self) -> None:
        # in place: each step reuses the buffers _make_state made
        self.adamw.zero_grad(set_to_none=False)


def make_pipeline_optimizer(params, lr: float = 3e-4,
                            weight_decay: float = 0.1, warmup: int = 100,
                            total_steps: int = 10_000) -> PipelineOptimizer:
    """``models.pretrain.make_optimizer`` minus the global-norm clip: the
    clip needs the CROSS-STAGE norm, so the executor applies the identical
    ``min(1, clip/||g||)`` scale itself after the commit reduction."""
    return PipelineOptimizer(params, lr, weight_decay, warmup, total_steps)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A tensor as a frame carries it: detached, contiguous, on the CPU,
    in its own dtype."""
    return t.detach().contiguous().cpu()


# ------------------------------------------------------------ the executor
class StageExecutor:
    """Runs the 1F1B op list for ONE stage, one call per optimizer step.
    Owns the stage module and its optimizer on the stage's card, its links
    to the adjacent stages, and the bubble accounting.  ``params`` (a
    flax-layout tree) are the initial parameters; without them the module
    draws its slice of the seeded full model.  With ``mesh`` (the stage's
    ``tp`` mesh, ``partition.pipeline_mesh``) the module is sharded over
    it; every rank of the mesh runs this executor over its own lane of
    ``links``."""

    def __init__(self, module, mesh=None, *, n_micro: int = 1,
                 links: Optional[Dict[str, Any]] = None,
                 lr: float = 3e-4, total_steps: int = 10_000,
                 clip_norm: float = 1.0, timeout_s: Optional[float] = None,
                 job: str = "", experiment: str = "", seed: int = 0,
                 params: Optional[Dict[str, Any]] = None,
                 dp_sync: Optional[Any] = None, replica: int = 0):
        from ray_tpu_torch.train.pipeline.partition import (
            make_shard_and_gather_fns)

        self.module = module
        self.stage = module.stage
        self.n_stages = module.n_stages
        self.n_micro = int(n_micro)
        self.mesh = mesh
        self.tp_rank = 0 if mesh is None else mesh.get_local_rank()
        self.device = module.device
        self.links = links or {}
        self.clip_norm = float(clip_norm)
        self.timeout_s = (timeout_s if timeout_s is not None
                          else pipechan.DEFAULT_TIMEOUT_S)
        self.job = job
        self.experiment = experiment
        # dp composition: a DpGradSync over this stage's cross-replica
        # collective group.  None = single replica (the exact path:
        # grad-norm partials ride the last upstream grad frame).
        self.dp_sync = dp_sync
        self.replica = int(replica)
        self.ops = one_f_one_b(self.stage, self.n_stages, self.n_micro)
        self.clock = BubbleClock()
        self.step_idx = 0
        self._op_comm_s = 0.0
        self.last_cpath: Optional[Dict[str, Any]] = None  # last step's stamp
        # the bytes of each frame sent on each link in the last step
        self.frame_bytes: Dict[str, int] = {}

        host_params = params if params is not None else module.init_params(seed)
        # the checkpoint's fns over the host tree ``params`` gives: a
        # gathered leaf passes as it is
        self.shard_fns, self.gather_fns = make_shard_and_gather_fns(
            host_params)
        if mesh is not None and module.mesh is None:
            module.shard_over(mesh)
        module.load_flax_params(host_params)
        module.train()
        self._lr, self._total_steps = lr, total_steps
        self.opt = make_pipeline_optimizer(module.parameters(), lr,
                                           total_steps=total_steps)

    # -------------------------------------------------------------- params
    @property
    def params(self) -> Dict[str, Any]:
        """The stage's parameters as a flax-layout tree of full host
        arrays, gathered over tp (a collective: every rank of the mesh
        calls it)."""
        return self.module.flax_params()

    def gathered_params(self) -> Dict[str, Any]:
        return self.params

    def load_full_params(self, full_tree: Dict[str, Any]) -> None:
        """Load this stage's slice out of a merged full-model tree — the
        restore half of the stage-count-independent checkpoint, each tp
        rank keeping its shard — with a fresh optimizer state."""
        self.module.load_flax_params(full_tree)
        self.opt = make_pipeline_optimizer(self.module.parameters(),
                                           self._lr,
                                           total_steps=self._total_steps)

    # --------------------------------------------------------------- step
    def _to_device(self, t) -> torch.Tensor:
        return torch.as_tensor(t).to(self.device, non_blocking=True)

    def _on_mesh(self, t: torch.Tensor):
        """``t``, which every rank of the stage holds whole, as a
        replicated DTensor over tp (as it is on one card)."""
        if self.mesh is None:
            return t
        from torch.distributed.tensor import DTensor, Replicate

        return DTensor.from_local(t, self.mesh, [Replicate()],
                                  run_check=False)

    def _replicated(self, t):
        """A stage output or loss over tp as the replicated DTensor whose
        local tensor every rank holds whole."""
        if not _is_dtensor(t):
            return t
        from torch.distributed.tensor import Replicate

        return t.redistribute(self.mesh, [Replicate()])

    def _micro_batch(self, batch, i):
        if batch is None:
            return None
        b = next(iter(batch.values())).shape[0]
        if b % self.n_micro:
            raise ValueError(
                f"batch size {b} not divisible by num_microbatches "
                f"{self.n_micro}")
        lo = (b // self.n_micro) * i
        hi = lo + b // self.n_micro
        return {k: self._on_mesh(self._to_device(np.asarray(v[lo:hi])).long())
                for k, v in batch.items()}

    def _send(self, link: str, tag: str, payload: Any, nbytes: int,
              tmo: float) -> None:
        self.frame_bytes[link] = max(self.frame_bytes.get(link, 0), nbytes)
        self.links[link].send(tag, payload, timeout_s=tmo)

    def _grad_norm_sq(self) -> float:
        """The sum of squares of the accumulated gradients, in f32, over
        M² (the norm of the microbatch mean).  Over tp each element counts
        once: the local sums of the sharded gradients are summed over the
        mesh in one all-reduce, and those of the replicated ones, equal on
        every rank, are added as they are."""
        grads = self.opt.grads()
        if self.mesh is None:
            sq = torch.stack([g.float().pow(2).sum() for g in grads]).sum()
            return float(sq) / float(self.n_micro) ** 2
        parts = {True: [], False: []}
        for p, g in zip(self.opt.params, grads):
            parts[any(pl.is_shard() for pl in p.placements)].append(
                g.float().pow(2).sum())
        sharded = torch.stack(parts[True]).sum()
        dist.all_reduce(sharded, group=self.mesh.get_group())
        sq = sharded + torch.stack(parts[False]).sum()
        return float(sq) / float(self.n_micro) ** 2

    def train_step(self, batch) -> Dict[str, Any]:
        """Execute one full 1F1B step.  ``batch`` is the GLOBAL host batch
        (same deterministic value on every stage; each stage touches only
        the pieces its position needs)."""
        self.clock.reset()
        self._op_comm_s = 0.0
        step = self.step_idx
        step_t0 = time.monotonic()
        step_wall0 = time.time()
        op_log: List[Any] = []  # [kind, start_rel, dur, comm] per op
        acts: Dict[int, Any] = {}    # micro -> received input activation
        outs: Dict[int, Any] = {}    # micro -> output (or loss) with graph
        losses: List[float] = []
        below_gnormsq: Optional[float] = None
        grads_red = None
        mod = self.module
        tmo = self.timeout_s
        sync = self.device.type == "cuda"
        self.opt.zero_grad()

        for op in self.ops:
            if fault_injection.ENABLED and fault_injection.hit(
                    "pipeline.stage_step",
                    detail=f"stage{self.stage}:{op.kind}{max(op.micro, 0)}"
                    ) == "kill":
                fault_injection.kill_self()
            if self.job:
                pipechan.stamp_progress(self.job, self.stage, step,
                                        op.micro, op.kind)
            t0 = time.monotonic()
            i = op.micro

            if op.kind == "recv_act":
                payload = self.links["act_in"].recv(f"{step}.a{i}",
                                                    timeout_s=tmo)
                acts[i] = self._to_device(payload).requires_grad_(True)
            elif op.kind == "fwd":
                mb = self._micro_batch(batch, i) if (
                    mod.is_first or mod.is_last) else None
                x = acts.get(i)
                outs[i] = self._replicated(
                    mod(None if x is None else self._on_mesh(x), mb))
                if sync:
                    # sync here, not in send_act: the next op copies this
                    # value to the host anyway, and an async launch would
                    # charge the compute tail to the transfer bucket
                    torch.cuda.synchronize(self.device)
            elif op.kind == "send_act":
                out = outs[i]
                y = _to_host(out.to_local() if _is_dtensor(out) else out)
                self._send("act_out", f"{step}.a{i}", y,
                           y.numel() * y.element_size(), tmo)
            elif op.kind == "recv_grad":
                payload = self.links["grad_in"].recv(f"{step}.g{i}",
                                                     timeout_s=tmo)
                self._g_in = self._to_device(payload["g"])
                if payload.get("loss") is not None:
                    losses.append(payload["loss"])
                if payload.get("gnormsq") is not None:
                    below_gnormsq = payload["gnormsq"]
            elif op.kind == "bwd":
                out = outs.pop(i)
                if mod.is_last:
                    if _is_dtensor(out):
                        out = out.to_local()
                    losses.append(float(out.detach()))
                    out.backward()
                else:
                    torch.autograd.backward(out, self._on_mesh(self._g_in))
                    self._g_in = None
                x = acts.pop(i, None)
                self._gx = None if x is None else x.grad
                if sync:
                    torch.cuda.synchronize(self.device)
                if self.dp_sync is not None and i == self.n_micro - 1:
                    # bucket-ready hook: the accumulated grads are final
                    # the moment the last backward microbatch lands —
                    # launch the bucketed dp allreduces NOW so the wire
                    # overlaps the remaining drain (over tp, each lane
                    # syncs its rank's shards)
                    tc = time.monotonic()
                    self.dp_sync.launch(
                        {name: g.detach().float().cpu().numpy()
                         for (name, _), g in zip(mod.named_parameters(),
                                                 self.opt.grads())})
                    self._op_comm_s += time.monotonic() - tc
            elif op.kind == "send_grad":
                g = _to_host(self._gx)
                self._gx = None
                payload = {"g": g,
                           "loss": losses[i] if mod.is_last else
                           (losses[i] if i < len(losses) else None),
                           "gnormsq": None}
                if i == self.n_micro - 1 and self.dp_sync is None:
                    payload["gnormsq"] = self._grad_norm_sq() + (
                        below_gnormsq or 0.0)
                self._send("grad_out", f"{step}.g{i}", payload,
                           g.numel() * g.element_size(), tmo)
            elif op.kind == "optim":
                if self.dp_sync is not None:
                    # wait-at-clip-barrier: the reduced grads are needed
                    # for the norm, so this is the latest possible wait
                    tc = time.monotonic()
                    grads_red = self.dp_sync.wait_all(timeout_s=tmo)
                    with torch.no_grad():
                        for (name, _), g in zip(mod.named_parameters(),
                                                self.opt.grads()):
                            g.copy_(torch.from_numpy(grads_red[name]))
                    self._op_comm_s += time.monotonic() - tc
                    commit = self._commit_dp(losses, step, tmo)
                else:
                    commit = self._commit(losses, below_gnormsq, step, tmo)
                self.opt.step((1.0 / self.n_micro) * commit["clip_scale"])
                if sync:
                    torch.cuda.synchronize(self.device)
            dt = time.monotonic() - t0
            comm = min(self._op_comm_s, dt)
            self._op_comm_s = 0.0
            if comm > 0.0:
                self.clock.charge("comm", comm)
            self.clock.charge(op.kind, dt - comm)
            op_log.append([op.kind, round(t0 - step_t0, 6), round(dt, 6),
                           round(comm, 6)])

        self.step_idx += 1
        out = self.clock.summary()
        out.update({"loss": commit["loss_mean"],
                    "grad_norm": commit["gnorm"],
                    "stage": self.stage, "step": step,
                    "replica": self.replica, "tp_rank": self.tp_rank,
                    "overlap_fraction":
                        self.dp_sync.last_overlap_fraction()
                        if self.dp_sync is not None else 0.0,
                    "dp_wire_bytes":
                        self.dp_sync.last_wire_bytes
                        if self.dp_sync is not None else 0})
        self._emit_metrics(out)
        self._emit_cpath(step, step_wall0, op_log, out)
        return out

    def _emit_cpath(self, step: int, t0_wall: float, op_log: List[Any],
                    out: Dict[str, Any]) -> None:
        """Stamp this stage's per-op intervals as a CPATH annotation on the
        task-event stream, so a critical-path reader reconstructs the
        step's per-stage breakdown and reconciles it against the
        BubbleClock.  The payload is also kept on ``self.last_cpath`` so
        core-less harnesses (benches, unit tests) reconcile directly;
        without a core worker the event emit is skipped — the step itself
        never depends on observability."""
        wall = sum(d for _k, _s, d, _c in op_log)
        exp = self.experiment or self.job or ""
        self.last_cpath = {
            "kind": "train_step",
            "experiment": exp,
            "stage": self.stage,
            "step": step,
            "t0": t0_wall,
            "wall_s": round(wall, 6),
            "ops": op_log,
            "clock": {k: round(v, 6)
                      for k, v in out.items()
                      if isinstance(v, float)
                      and k in ("step_wall_s", "busy_s", "xfer_s",
                                "bubble_s", "bubble_fraction", "comm_s")},
        }
        try:
            from ray_tpu_torch._private.config import RayConfig
            from ray_tpu_torch._private.worker import global_worker_core

            core = global_worker_core()
            if core is None or not RayConfig.task_events_enabled:
                return
            core.emit_raw_event({
                "task_id": f"cpath-train-{exp}-{self.stage}-{step}",
                "attempt": 0,
                "name": f"train_step:{exp}:s{self.stage}:{step}",
                "state": "CPATH",
                "ts": time.time(),
                "job_id": core.job_id.hex(),
                "type": "ANNOTATION",
                "node_id": core._node_id_hex,
                "worker_id": core._worker_id_hex,
                "cpath": self.last_cpath,
            }, terminal=True)
        except Exception:
            pass  # observability must never fail a step

    def _clip(self, commit: Dict[str, float]) -> Dict[str, float]:
        gnorm = commit["gnorm"]
        commit["clip_scale"] = min(1.0, self.clip_norm / gnorm) \
            if gnorm > 0 else 1.0
        return commit

    def _commit(self, losses, below_gnormsq, step: int,
                tmo: float) -> Dict[str, float]:
        """Cross-stage reduction: stage 0 totals the grad-norm partials
        (its own + the upstream-riding sum) and the microbatch losses, then
        broadcasts one commit frame down the act links so every stage
        applies the identical clip scale."""
        if self.stage == 0:
            total_sq = self._grad_norm_sq() + (below_gnormsq or 0.0)
            gnorm = float(np.sqrt(total_sq))
            loss_mean = float(np.mean(losses)) if losses else float("nan")
            commit = {"gnorm": gnorm, "loss_mean": loss_mean}
            if "act_out" in self.links:
                self.links["act_out"].send(f"{step}.c", commit, timeout_s=tmo)
        else:
            commit = self.links["act_in"].recv(f"{step}.c", timeout_s=tmo)
            if "act_out" in self.links:
                self.links["act_out"].send(f"{step}.c", commit, timeout_s=tmo)
        return self._clip(commit)

    def _commit_dp(self, losses, step: int, tmo: float) -> Dict[str, float]:
        """dp-composed commit: the norm partials cross BOTH the stage
        frames and the dp allreduce, yet stay exact.

        The dp-mean grads returned by ``wait_all`` are identical on every
        replica, so each stage's own sum of squares is replica-consistent
        by construction.  Partials then flow upstream over a dedicated
        ``{step}.n`` frame on the grad links, and stage 0 folds ONE extra
        scalar allreduce — dp-mean of [loss_mean, total_sq], exact and
        full-participation — into the commit frame it broadcasts
        downstream.  Averaging replica-identical values is bitwise stable,
        so dp=2 on one batch reproduces the dp=1 norm bit for bit.
        """
        own_sq = self._grad_norm_sq()
        below = 0.0
        if "grad_in" in self.links:
            below = float(self.links["grad_in"].recv(f"{step}.n",
                                                     timeout_s=tmo))
        subtotal = own_sq + below
        if self.stage == 0:
            loss_local = float(np.mean(losses)) if losses else float("nan")
            tc = time.monotonic()
            vec = self.dp_sync.allreduce_scalars([loss_local, subtotal],
                                                 timeout_s=tmo)
            self._op_comm_s += time.monotonic() - tc
            commit = {"gnorm": float(np.sqrt(float(vec[1]))),
                      "loss_mean": float(vec[0])}
            if "act_out" in self.links:
                self.links["act_out"].send(f"{step}.c", commit, timeout_s=tmo)
        else:
            self.links["grad_out"].send(f"{step}.n", subtotal, timeout_s=tmo)
            commit = self.links["act_in"].recv(f"{step}.c", timeout_s=tmo)
            if "act_out" in self.links:
                self.links["act_out"].send(f"{step}.c", commit, timeout_s=tmo)
        return self._clip(commit)

    def _emit_metrics(self, out: Dict[str, Any]) -> None:
        try:
            from ray_tpu_torch.train._metrics import train_metrics

            m = train_metrics()
            labels = {"experiment": self.experiment or self.job or "",
                      "stage": str(self.stage)}
            m["pipeline_bubble"].inc(out["bubble_s"], labels)
            m["pipeline_bubble_fraction"].set(out["bubble_fraction"], labels)
            m["pipeline_stage_busy"].set(out["busy_s"], labels)
            m["pipeline_comm"].inc(out["comm_s"], labels)
            m["pipeline_overlap_fraction"].set(out["overlap_fraction"],
                                               labels)
            if out.get("dp_wire_bytes"):
                m["train_dp_wire_bytes"].inc(out["dp_wire_bytes"], labels)
        except Exception:
            pass  # metrics must never fail a step

    def close(self) -> None:
        for link in self.links.values():
            link.close()
