"""Podracer learner gang: per-learner V-trace, collective gradient fold.

Port of ``ray_tpu/rllib/podracer/learner.py``.  Each learner holds a full
replica of the policy (same seed => identical init on every rank) and runs
the IMPALA V-trace update in two halves: ``_vtrace_grads`` (loss +
gradient) and ``apply_grads`` (the clip and the Adam step).  Between them
the gradients, flattened in the sorted order of their names on every rank,
cross the gang's persistent host-ring collective group
(``util/collective/``) with ``allreduce_async(op="mean")`` — optionally
with ``quorum=K-1`` so one straggling learner never stalls a round (its
late gradient parks at the root and folds into the next fold).  Because
every rank applies the SAME folded gradient to the SAME replica, parameters
stay bitwise identical across the gang and rank 0 alone publishes
versioned weights (a state of CPU tensors) to the
:class:`~ray_tpu_torch.rllib.podracer.weights.WeightMailbox`.

``world_size=1`` skips the group entirely, so a driver-local learner and a
one-actor gang run the identical update — the bitwise Anakin/Sebulba
parity contract the tests pin down.  A gang on the card asks each actor
``num_gpus_per_learner`` of a GPU lease; a share of one card is allowed,
since no ``torch.distributed`` group forms.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.core.learner import (apply_grads, batch_to,
                                              learner_options, make_optimizer)
from ray_tpu_torch.rllib.core.rl_module import (DiscretePolicyModule,
                                                process_facts)


def _vtrace_grads(module, params, batch, *, gamma, rho_clip, c_clip,
                  vf_loss_coeff, entropy_coeff):
    """Loss + gradient half of the IMPALA update (ops/vtrace.py): the
    stats as device tensors and the gradients in ``params``' order."""
    from ray_tpu_torch.ops.vtrace import vtrace_from_fragments

    T, K = batch["rewards"].shape
    obs = batch["obs"].reshape(T * K, -1)
    actions = batch["actions"].reshape(T * K)
    dones = batch["terminated"] | batch["truncated"]

    # target policy/value under CURRENT params; behavior logp/values in
    # the batch came from the stale runner weights
    logp, entropy = module.logp_entropy(obs, actions)
    v = module.value(obs)
    logp_t = logp.reshape(T, K)
    v_t = v.reshape(T, K)
    v_d = v_t.detach()
    nv = torch.cat([v_d[1:], batch["next_values"][-1:]], 0)
    nv = torch.where(dones, batch["next_values"], nv)
    vs, pg_adv = vtrace_from_fragments(
        batch["logp"], logp_t.detach(), batch["rewards"], v_d, nv, dones,
        gamma, rho_clip, c_clip)
    pg_loss = -(pg_adv * logp_t).mean()
    vf_loss = 0.5 * ((v_t - vs) ** 2).mean()
    loss = pg_loss + vf_loss_coeff * vf_loss - entropy_coeff * entropy.mean()
    grads = torch.autograd.grad(loss, params)
    stats = {
        "policy_loss": pg_loss,
        "vf_loss": vf_loss,
        "entropy": entropy.mean(),
        "mean_vtrace_target": vs.mean(),
        "mean_is_ratio": torch.exp(logp_t.detach() - batch["logp"]).mean(),
        "total_loss": loss,
    }
    return {k: t.detach() for k, t in stats.items()}, list(grads)


class PodracerLearner:
    """One learner replica (driver-local object or actor — same class)."""

    def __init__(self, module_spec: Dict, training_params: Dict, *,
                 seed: int = 0, rank: int = 0, world_size: int = 1,
                 job: str = "", quorum: Optional[int] = None,
                 device: Optional[str] = None, publish_every: int = 1,
                 collective_timeout_s: float = 120.0):
        self.device = resolve_device(device)
        self.module = DiscretePolicyModule(
            **module_spec, generator=torch.Generator().manual_seed(seed)
        ).to(self.device)
        # the gang's flat order: the sorted names, the same on every rank
        self._params = [p for _, p in self.module.named_params()]
        get = training_params.get
        self.optimizer = make_optimizer(self._params, get("lr", 5e-4))
        self._grad_clip = get("grad_clip", 40.0)
        self._loss_kw = dict(
            gamma=get("gamma", 0.99), rho_clip=get("rho_clip", 1.0),
            c_clip=get("c_clip", 1.0),
            vf_loss_coeff=get("vf_loss_coeff", 0.5),
            entropy_coeff=get("entropy_coeff", 0.01))
        self.rank = rank
        self.world_size = world_size
        self.job = job
        self._quorum = quorum
        self._publish_every = max(int(publish_every), 1)
        self._timeout_s = collective_timeout_s
        self._group = None
        self._updates = 0
        self._version = 0
        self._mailbox = None
        if job and rank == 0:
            from ray_tpu_torch.rllib.podracer.weights import WeightMailbox

            # keep=4: a runner mid-fetch loses the race only if four
            # versions roll out during its one object-store get
            self._mailbox = WeightMailbox(job, keep=4)

    # ----------------------------------------------------------- grad fold
    def _ensure_group(self):
        if self._group is None and self.world_size > 1:
            from ray_tpu_torch.util.collective.collective import \
                get_or_init_collective_group

            self._group = get_or_init_collective_group(
                self.world_size, self.rank,
                group_name=f"rllib/{self.job or 'default'}/learners")
        return self._group

    def _fold(self, grads: List[torch.Tensor], labels) -> List[torch.Tensor]:
        """The gang's mean of every rank's gradients: one flat f32 vector
        in the sorted names' order through the host ring, and back."""
        from ray_tpu_torch.rllib._metrics import rllib_metrics

        flat = torch.cat([g.reshape(-1) for g in grads])
        handle = self._group.allreduce_async(
            flat.cpu().numpy(), op="mean", quorum=self._quorum,
            timeout_s=self._timeout_s)
        folded = handle.wait(self._timeout_s)
        rllib_metrics()["allreduce_seconds"].observe(handle.op_seconds,
                                                     labels)
        folded = torch.from_numpy(np.asarray(folded, np.float32)).to(
            self.device)
        return [part.view_as(g) for part, g in zip(
            torch.split(folded, [g.numel() for g in grads]), grads)]

    def update(self, fragment) -> Dict[str, Any]:
        """One V-trace update; with a gang, folds this rank's gradient with
        the others' (mean) before applying.  Accepts either a raw batch
        dict or a streamed fragment wrapper carrying ``{"batch": ...}``."""
        from ray_tpu_torch.rllib._metrics import rllib_metrics

        batch = fragment.get("batch", fragment) \
            if isinstance(fragment, dict) else fragment
        mlabels = {"job": self.job or "default"}
        t0 = time.monotonic()
        stats, grads = _vtrace_grads(self.module, self._params,
                                     batch_to(batch, self.device),
                                     **self._loss_kw)
        if self._ensure_group() is not None:
            grads = self._fold(grads, mlabels)
        apply_grads(self.optimizer, self._params, grads, self._grad_clip)
        self._updates += 1
        out = dict(zip(stats, torch.stack(list(stats.values())).tolist()))
        if self._mailbox is not None and \
                self._updates % self._publish_every == 0:
            self._version = self._mailbox.publish(self.module.state())
        out["weight_version"] = float(self._version)
        rllib_metrics()["update_seconds"].observe(
            time.monotonic() - t0, mlabels)
        return out

    # ------------------------------------------------------------ weights
    def publish(self) -> int:
        """Publish the current params (v0 before any update, or an
        off-cycle refresh).  Rank 0 only."""
        if self._mailbox is None:
            raise RuntimeError("only rank 0 of a named job publishes")
        self._version = self._mailbox.publish(self.module.state())
        return self._version

    def get_weights(self) -> Dict[str, torch.Tensor]:
        return self.module.state()

    def set_weights(self, state: Dict[str, torch.Tensor]) -> None:
        self.module.load_state(state)

    def get_version(self) -> int:
        return self._version

    def param_names(self) -> List[str]:
        """Every parameter's name (e.g. ``pi/0/w``), sorted: the JAX
        package's pytree paths."""
        return self.module.param_names()

    def process_facts(self) -> Dict[str, Any]:
        return process_facts(self.device)

    def nap(self, seconds: float) -> bool:
        """Occupy this learner's serial call queue for ``seconds`` — a
        deterministic straggler for quorum tests and benches."""
        time.sleep(float(seconds))
        return True

    def ping(self) -> bool:
        return True


class LearnerGang:
    """Driver-side handle over K PodracerLearner actors.

    Fragments buffer until one is available per rank, then the round
    dispatches to all ranks at once (the collective fold needs every rank
    in every op).  With ``quorum=K-1`` the round's stats return after K-1
    learners finish — the straggler's update keeps running and its result
    is harvested opportunistically on a later round.
    """

    def __init__(self, module_spec: Dict, training_params: Dict, *,
                 num_learners: int, job: str, seed: int = 0,
                 quorum: Optional[int] = None,
                 device: Optional[str] = None,
                 num_gpus_per_learner: float = 1, publish_every: int = 1,
                 round_timeout_s: float = 300.0):
        import ray_tpu_torch

        if num_learners < 1:
            raise ValueError("LearnerGang needs num_learners >= 1")
        cls = ray_tpu_torch.remote(PodracerLearner)
        options = learner_options(device, num_gpus_per_learner)
        self._learners = [
            cls.options(**options).remote(
                module_spec, training_params, seed=seed, rank=r,
                world_size=num_learners, job=job, quorum=quorum,
                device=device, publish_every=publish_every)
            for r in range(num_learners)
        ]
        self._await_n = quorum if quorum is not None else num_learners
        self._timeout_s = round_timeout_s
        self._buf: List[Any] = []
        self._straggling: List[Any] = []

    def __len__(self) -> int:
        return len(self._learners)

    @property
    def learners(self) -> List[Any]:
        return list(self._learners)

    def submit(self, fragment_ref) -> List[Dict[str, Any]]:
        """Queue one fragment (pass the plasma REF, not the value — the
        learner fetches it without a driver re-put).  Returns the stats
        dicts of every update that completed as a result (empty until a
        full round dispatches)."""
        import ray_tpu_torch

        self._buf.append(fragment_ref)
        k = len(self._learners)
        if len(self._buf) < k:
            return []
        round_frags, self._buf = self._buf[:k], self._buf[k:]
        refs = [ln.update.remote(f)
                for ln, f in zip(self._learners, round_frags)]
        ready, late = ray_tpu_torch.wait(refs, num_returns=self._await_n,
                                         timeout=self._timeout_s)
        if len(ready) < self._await_n:
            raise TimeoutError(
                f"learner round: {len(ready)}/{self._await_n} updates "
                f"finished within {self._timeout_s}s")
        self._straggling.extend(late)
        done, self._straggling = ray_tpu_torch.wait(
            self._straggling, num_returns=len(self._straggling), timeout=0)
        return ray_tpu_torch.get(ready) + ray_tpu_torch.get(done)

    def flush(self, timeout_s: float = 120.0) -> List[Dict[str, Any]]:
        """Collect every straggling update (end of run / test barrier)."""
        import ray_tpu_torch

        done, self._straggling = ray_tpu_torch.wait(
            self._straggling, num_returns=len(self._straggling),
            timeout=timeout_s)
        return ray_tpu_torch.get(done)

    def publish(self) -> int:
        import ray_tpu_torch

        return ray_tpu_torch.get(self._learners[0].publish.remote(),
                                 timeout=60)

    def get_weights(self, rank: int = 0):
        import ray_tpu_torch

        return ray_tpu_torch.get(self._learners[rank].get_weights.remote(),
                                 timeout=60)

    def stop(self) -> None:
        import ray_tpu_torch

        for ln in self._learners:
            try:
                ray_tpu_torch.kill(ln)
            except Exception:
                pass
        self._learners = []
