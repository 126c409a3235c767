"""TorchTrainer: distributed PyTorch training on the port's actor runtime.

The port of ``ray_tpu/train/jax_trainer.py`` (its SPMD part, ``:38-114``),
after the reference's ``TorchTrainer`` (reference:
python/ray/train/torch/torch_trainer.py:11).  Workers are gang-scheduled
actors, each on its own card by default; ``TorchConfig`` brings up one
``torch.distributed`` process group over them (NCCL, or gloo for CPU
workers: ``ScalingConfig(use_gpu=False)``),
so inside ``train_loop_per_worker`` the user builds a mesh over the whole
world (``parallel.MeshConfig``) and trains with ``ShardedPretrainer`` as
in one ``torchrun`` job.

Usage::

    def train_loop(config):
        from ray_tpu_torch import train
        from ray_tpu_torch.models import GPT2Config, ShardedPretrainer
        from ray_tpu_torch.parallel import MeshConfig

        trainer = ShardedPretrainer(GPT2Config(), MeshConfig(dp=-1))
        for step in range(config["steps"]):
            loss = trainer.step(batch)
            train.report({"loss": loss.item()})

    trainer = TorchTrainer(
        train_loop,
        train_loop_config={"steps": 100},
        scaling_config=ScalingConfig(num_workers=4),
    )
    result = trainer.fit()

``pipeline_stages=N`` switches the worker layout from one SPMD gang to N
MPMD stage gangs (``ray_tpu_torch.train.pipeline``, the port of
``ray_tpu/train/jax_trainer.py:41-104``): workers split into N contiguous
gangs, each gang its OWN world (no cross-stage process group — stages talk
through channel frames), and the train loop sees ``_pipeline`` =
``{"n_stages": N, "n_micro": M, "dp": dp, "tp": tp}`` in its config.
``num_microbatches`` is the gradient-accumulation width of the 1F1B
schedule, and ``mesh=(dp, tp)`` adds ``dp`` data-parallel replicas, each
stage's replicas syncing gradients over the host collective ring, and
shards each stage over ``tp`` cards: a stage gang of ``tp`` workers, one
card each, under one NCCL world (the JAX worker's tp local devices).
``num_workers`` must equal ``dp * pipeline_stages * tp`` whenever
``pipeline_stages``, dp or tp is above 1.  Gangs of one worker bring up
no process group, so their workers may share a card
(``ScalingConfig(gpus_per_worker=0.5)``)::

    trainer = TorchTrainer(
        gpt2_pipeline_loop, train_loop_config={"steps": 10, ...},
        scaling_config=ScalingConfig(num_workers=2, gpus_per_worker=0.5),
        pipeline_stages=2, num_microbatches=4)

``datasets={"train": ds}`` splits each ``ray_tpu_torch.data`` Dataset
into one coordinated streaming iterator per worker
(``ds.streaming_split(num_workers, equal=True)``); the loop pulls its
share with ``train.get_dataset_shard("train")``, and
``iter_torch_batches(device=...)`` moves each batch to its card::

    def train_loop(config):
        shard = train.get_dataset_shard("train")
        for batch in shard.iter_torch_batches(batch_size=16,
                                              device="cuda"):
            loss = trainer.step(batch)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.base_trainer import DataParallelTrainer
from ray_tpu_torch.train.torch_config import (
    TorchConfig,
    check_card_share,
)


class TorchTrainer(DataParallelTrainer):
    """The same ``train_loop_per_worker`` on every worker of the gang, one
    ``torch.distributed`` world over them, or one over each MPMD stage gang
    (``pipeline_stages``, ``mesh``)."""

    _default_backend_config = TorchConfig()

    def __init__(self, train_loop_per_worker: Callable,
                 *, train_loop_config: Optional[Dict[str, Any]] = None,
                 torch_config: Optional[TorchConfig] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None,
                 pipeline_stages: int = 1,
                 num_microbatches: int = 1,
                 mesh: Optional[tuple] = None):
        import dataclasses

        if pipeline_stages < 1:
            raise ValueError(f"pipeline_stages must be >= 1, got "
                             f"{pipeline_stages}")
        if num_microbatches < 1:
            raise ValueError(f"num_microbatches must be >= 1, got "
                             f"{num_microbatches}")
        if mesh is not None and (len(mesh) != 2 or min(mesh) < 1):
            raise ValueError(f"mesh must be (dp, tp) with both >= 1, "
                             f"got {mesh!r}")
        dp, tp = (int(mesh[0]), int(mesh[1])) if mesh is not None else (1, 1)
        torch_config = torch_config or TorchConfig()
        scaling_config = scaling_config or ScalingConfig()
        num_workers = scaling_config.num_workers
        mpmd = pipeline_stages > 1 or dp > 1 or tp > 1
        # a gang of more than one worker forms a process group: first,
        # since a wrong worker count names the share it was given
        check_card_share(
            scaling_config._worker_resources.get("GPU", 0.0),
            max(tp, num_workers // (pipeline_stages * dp)) if mpmd
            else num_workers)
        if mpmd:
            if num_workers != dp * pipeline_stages * tp:
                raise ValueError(
                    f"num_workers {num_workers} must equal dp * "
                    f"pipeline_stages * tp = {dp} * {pipeline_stages} * "
                    f"{tp} (each stage a gang of tp workers, a card each)")
            torch_config = dataclasses.replace(
                torch_config, pipeline_stages=pipeline_stages,
                dp_replicas=dp)
        if mpmd or num_microbatches > 1:
            train_loop_config = dict(train_loop_config or {})
            train_loop_config["_pipeline"] = {
                "n_stages": pipeline_stages, "n_micro": num_microbatches,
                "dp": dp, "tp": tp}
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend_config=torch_config,
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint,
        )
