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

The MPMD layout (``pipeline_stages``, ``num_microbatches``, ``mesh``) and
``datasets=`` are not ported and raise.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train.base_trainer import DataParallelTrainer
from ray_tpu_torch.train.torch_config import TorchConfig


class TorchTrainer(DataParallelTrainer):
    """The same ``train_loop_per_worker`` on every worker of the gang, one
    ``torch.distributed`` world over them."""

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
        if pipeline_stages > 1 or num_microbatches > 1 or mesh is not None:
            raise NotImplementedError(
                "TorchTrainer: the MPMD layout (pipeline_stages, "
                "num_microbatches, mesh) is not ported yet (ROADMAP A7's "
                "MPMD part); the SPMD pipeline trains through "
                "models.PipelinedPretrainer with MeshConfig(pp=...) inside "
                "the loop")
        if datasets:
            raise NotImplementedError(
                "TorchTrainer: datasets= needs the Data library, which is "
                "not ported; feed batches from the loop")
        super().__init__(
            train_loop_per_worker,
            train_loop_config=train_loop_config,
            backend_config=torch_config or TorchConfig(),
            scaling_config=scaling_config or ScalingConfig(),
            run_config=run_config,
            resume_from_checkpoint=resume_from_checkpoint,
        )
