"""ray_tpu_torch.train.pipeline: MPMD pipeline-parallel training over actor
gangs, the port of ``ray_tpu/train/pipeline``.

The model's layer stack splits into N contiguous stages (``partition``),
each stage runs in its own worker actor on its own card (or a share of
one), adjacent stages exchange activations/gradients over the compiled-DAG
channel primitives (``channels``), data-parallel replicas of a stage sync
their gradients over ``util/collective``'s host ring (``dp_sync``), and a
deterministic 1F1B schedule drives each stage's train session
(``schedule``).  ``loop.gpt2_pipeline_loop`` is the ready-made train loop
``TorchTrainer(pipeline_stages=N, num_microbatches=M)`` runs per worker.
"""

from ray_tpu_torch.exceptions import PipelineStageDied
from ray_tpu_torch.train.pipeline.channels import (
    StageLink,
    connect_links,
    publish_endpoint,
    stage_alive,
    stamp_progress,
)
from ray_tpu_torch.train.pipeline.dp_sync import (
    DpGradSync,
    LocalReplicaGroup,
    LocalReplicaMember,
    resolve_grad_sync_flags,
)
from ray_tpu_torch.train.pipeline.loop import gpt2_pipeline_loop
from ray_tpu_torch.train.pipeline.partition import (
    GangCoords,
    GPT2StageModule,
    factor_gang,
    load_pipeline_checkpoint,
    make_shard_and_gather_fns,
    pipeline_mesh,
    save_stage_shard,
    stage_ranges,
)
from ray_tpu_torch.train.pipeline.schedule import (
    BubbleClock,
    PipelineOp,
    StageExecutor,
    make_pipeline_optimizer,
    one_f_one_b,
    theoretical_bubble_fraction,
)

__all__ = [
    "PipelineStageDied",
    "StageLink", "connect_links", "publish_endpoint", "stage_alive",
    "stamp_progress",
    "gpt2_pipeline_loop",
    "DpGradSync", "LocalReplicaGroup", "LocalReplicaMember",
    "resolve_grad_sync_flags",
    "GangCoords", "GPT2StageModule", "factor_gang",
    "load_pipeline_checkpoint", "make_shard_and_gather_fns",
    "pipeline_mesh", "save_stage_shard", "stage_ranges",
    "BubbleClock", "PipelineOp", "StageExecutor", "make_pipeline_optimizer",
    "one_f_one_b", "theoretical_bubble_fraction",
]
