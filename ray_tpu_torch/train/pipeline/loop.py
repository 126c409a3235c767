"""The ready-made ``train_loop_per_worker`` for pipeline-parallel GPT-2: the
port of ``ray_tpu/train/pipeline/loop.py``.

``TorchTrainer(gpt2_pipeline_loop, pipeline_stages=P, mesh=(dp, tp),
num_microbatches=M, scaling_config=ScalingConfig(num_workers=dp*P*tp))``
gives each (replica, stage) cell of the factoring a gang of tp workers, one
card each, under one ``torch.distributed`` world (the JAX worker's tp local
devices): each worker derives its coordinates from its world rank
(replica-major; see ``partition.factor_gang``, the gang rank its tp
index), builds its stage module on its card, sharded over the gang's
``tp`` mesh when tp > 1, rendezvouses its channels over the GCS KV
(namespaced per replica and, over tp, per lane: tp rank j of stage s talks
to tp rank j of stage s±1), joins its lane's cross-replica collective group
(``train/{job}/stage{k}/dp``, ``.../stage{k}/t{j}/dp`` over tp) for the
bucketed gradient allreduce over the host ring, and drives the 1F1B
executor — reporting loss/grad-norm (reduced to stage 0 by the schedule's
commit frame, dp-mean across replicas) and the bubble/comm/overlap
accounting through the normal ``train.report`` lockstep.  After the
row-parallel reduction a stage's output is whole on every tp rank, so each
lane carries its own copy of every frame (tp copies of each host frame)
and no broadcast inside the gang is needed.

``train_loop_config`` keys: ``steps``, ``batch_size`` (GLOBAL batch; each
replica trains on its contiguous ``batch_size/dp`` row slice), ``seq_len``,
``model`` (GPT2Config field overrides, applied over ``GPT2Config.tiny()``;
``dtype`` by name), ``lr``, ``seed``, ``timeout_s``, ``checkpoint_every``
(0 = only the final step checkpoints), ``device`` (the worker's card unless
``"cpu"``), plus the dp grad-exchange knobs ``grad_bucket_bytes`` /
``grad_quant`` / ``dp_quorum``.  The driver injects ``_pipeline`` =
{n_stages, n_micro, dp, tp}.

The stage links' shm slots hold the largest frame the stage sends: one
microbatch's activation or gradient, (batch/dp/M) × seq × n_embd in the
compute dtype, plus the frame's header (``frame_slot_bytes``).  The JAX
loop keeps ``connect_links``'s 1 MiB default, which a GPT-2-small
microbatch overflows.

Checkpoint layout: every stage gathers its params over tp (each rank of
the gang enters the gather) and its gang rank 0 writes them as
``pipe_stage.npz`` keyed by CANONICAL layer names in the flax layout; the
trainer's persist step files stage 0's under the checkpoint dir and the
rest under ``rank_<k>/``.  Restore merges every shard and re-selects this
job's slices, each tp rank keeping its shard, so a checkpoint restores
onto any other stage count and tp.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Dict

import numpy as np

# room in a stage link's slot beyond the tensor: the frame's pickle of
# (tag, payload) and the tensor's metadata
FRAME_HEADER_BYTES = 64 * 1024


def frame_slot_bytes(rows: int, seq_len: int, n_embd: int,
                     itemsize: int) -> int:
    """The slot a stage link needs for one microbatch's activation or
    gradient frame, and never less than ``connect_links``'s default."""
    return max(1 << 20, rows * seq_len * n_embd * itemsize
               + FRAME_HEADER_BYTES)


def gpt2_pipeline_loop(config: Dict[str, Any]) -> None:
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.train.pipeline import channels as pipechan
    from ray_tpu_torch.train.pipeline.dp_sync import DpGradSync
    from ray_tpu_torch.train.pipeline.partition import (
        GPT2StageModule, factor_gang, load_pipeline_checkpoint,
        pipeline_mesh, save_stage_shard)
    from ray_tpu_torch.train.pipeline.schedule import StageExecutor

    ctx = train.get_context()
    pcfg = config.get("_pipeline") or {"n_stages": 1, "n_micro": 1}
    n_stages, n_micro = int(pcfg["n_stages"]), int(pcfg["n_micro"])
    dp = int(pcfg.get("dp", 1))
    tp = int(pcfg.get("tp", 1))
    world = ctx.get_world_size()
    if world != dp * n_stages * tp:
        raise ValueError(
            f"num_workers {world} must equal dp * pipeline_stages * tp = "
            f"{dp} * {n_stages} * {tp}")
    coords = factor_gang(ctx.get_world_rank(), world, dp=dp,
                         n_stages=n_stages)
    stage, replica = coords.stage, coords.replica
    job = config.get("job") or ctx.get_experiment_name()
    # channels rendezvous per REPLICA: each replica runs its own 1F1B
    # pipeline, so its act/grad links must never cross replicas; over tp,
    # per LANE too: tp rank j of each stage has links of its own
    chjob = job if dp == 1 else f"{job}/r{replica}"
    if tp > 1:
        chjob = f"{chjob}/t{coords.gang_rank}"

    model_cfg = GPT2Config.tiny()
    overrides = dict(config.get("model") or {})
    if isinstance(overrides.get("dtype"), str):
        overrides["dtype"] = getattr(torch, overrides["dtype"])
    if overrides:
        model_cfg = dataclasses.replace(model_cfg, **overrides)

    steps = int(config.get("steps", 4))
    batch_size = int(config.get("batch_size", 8))
    seq_len = int(config.get("seq_len", min(32, model_cfg.n_positions)))
    ckpt_every = int(config.get("checkpoint_every", 0))
    timeout_s = float(config.get("timeout_s", 60.0))
    if batch_size % dp:
        raise ValueError(
            f"global batch_size {batch_size} not divisible by dp {dp}")
    rep_batch = batch_size // dp

    module = GPT2StageModule(model_cfg, stage, n_stages,
                             device=config.get("device"))
    # over tp, the gang's world (one a stage gang, TorchConfig); None on
    # one card
    mesh = pipeline_mesh(module.device)
    itemsize = torch.empty((), dtype=model_cfg.dtype).element_size()
    slot_size = frame_slot_bytes(-(-rep_batch // n_micro), seq_len,
                                 model_cfg.n_embd, itemsize)
    links = pipechan.connect_links(chjob, stage, n_stages, n_micro,
                                   slot_size=slot_size,
                                   timeout_s=timeout_s) if n_stages > 1 else {}

    dp_sync = None
    dp_group_name = None
    if dp > 1:
        from ray_tpu_torch.util import collective

        dp_group_name = coords.dp_group_name(job)
        # persistent per-stage group, reused across every step
        member = collective.get_or_init_collective_group(
            dp, replica, backend="cpu", group_name=dp_group_name)
        dp_sync = DpGradSync(
            member,
            bucket_bytes=config.get("grad_bucket_bytes"),
            quant=config.get("grad_quant"),
            quorum=config.get("dp_quorum"),
            timeout_s=timeout_s)

    executor = StageExecutor(
        module, mesh, n_micro=n_micro, links=links,
        lr=float(config.get("lr", 3e-4)), total_steps=max(steps, 101),
        timeout_s=timeout_s, job=chjob, experiment=ctx.get_experiment_name(),
        seed=int(config.get("seed", 0)), dp_sync=dp_sync, replica=replica)

    def _destroy_dp():
        if dp_group_name is not None:
            from ray_tpu_torch.util import collective

            collective.destroy_collective_group(dp_group_name)

    start_step = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        with ckpt.as_directory() as d:
            full, saved_step = load_pipeline_checkpoint(d)
            executor.load_full_params(full)
            start_step = saved_step + 1

    def _checkpoint(step: int):
        # every tp rank enters the gather; gang rank 0 writes the shard
        params = executor.gathered_params()
        if coords.gang_rank:
            return None
        d = tempfile.mkdtemp()
        save_stage_shard(
            os.path.join(d, "pipe_stage.npz"), params,
            stage=stage, n_stages=n_stages, step=step)
        return train.Checkpoint.from_directory(d)

    rng_seed = int(config.get("seed", 0))
    if start_step >= steps:
        # restored at or past the horizon: re-emit the restored params so a
        # cross-stage-count restore is observable without training further
        train.report({"step": start_step - 1, "stage": stage,
                      "restored": True}, checkpoint=_checkpoint(start_step - 1))
        _destroy_dp()
        return

    for step in range(start_step, steps):
        # every stage derives the SAME global batch from the seeded stream
        # (stage 0 reads input_ids, the last stage reads targets); each
        # replica trains on its contiguous row slice, so the dp-mean grad
        # equals the full-batch grad up to fp reassociation
        rng = np.random.default_rng((rng_seed << 20) + step)
        batch = {
            "input_ids": rng.integers(
                0, model_cfg.vocab_size, (batch_size, seq_len),
                dtype=np.int32),
            "targets": rng.integers(
                0, model_cfg.vocab_size, (batch_size, seq_len),
                dtype=np.int32),
        }
        if dp > 1:
            lo = replica * rep_batch
            batch = {k: v[lo:lo + rep_batch] for k, v in batch.items()}
        out = executor.train_step(batch)
        checkpoint = None
        if step == steps - 1 or (ckpt_every and (step + 1) % ckpt_every == 0):
            checkpoint = _checkpoint(step)
        train.report({k: out[k] for k in
                      ("loss", "grad_norm", "step", "stage", "replica",
                       "tp_rank", "step_wall_s", "busy_s", "xfer_s",
                       "bubble_s", "bubble_fraction", "comm_s",
                       "overlap_fraction", "dp_wire_bytes")},
                     checkpoint=checkpoint)
    executor.close()
    _destroy_dp()
