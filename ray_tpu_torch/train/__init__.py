"""ray_tpu_torch.train: distributed training orchestration.

The port of ``ray_tpu/train/__init__.py``: trainer -> worker group of
gang-scheduled actors -> torch.distributed bring-up -> the user's SPMD loop
with report()/checkpointing.  The MPMD pipeline (``ray_tpu/train/pipeline``)
is not ported, and is not imported here.
"""

from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train._checkpoint import Checkpoint
from ray_tpu_torch.train._session import (
    get_dataset_shard,
    TrainContext,
    get_checkpoint,
    get_context,
    report,
)
from ray_tpu_torch.train.base_trainer import BaseTrainer, DataParallelTrainer
from ray_tpu_torch.train.torch_config import BackendConfig, TorchConfig
from ray_tpu_torch.train.torch_trainer import TorchTrainer
from ray_tpu_torch.train._backend_executor import TrainingFailedError

__all__ = [
    "BaseTrainer", "DataParallelTrainer", "TorchTrainer",
    "BackendConfig", "TorchConfig",
    "Checkpoint", "TrainContext", "TrainingFailedError",
    "report", "get_checkpoint", "get_context", "get_dataset_shard",
    "ScalingConfig", "RunConfig", "FailureConfig", "CheckpointConfig",
    "Result",
]
