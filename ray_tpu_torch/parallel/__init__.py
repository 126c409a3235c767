"""Parallelism layer of the port: device meshes and partition rules over
``torch.distributed`` (DTensor), the counterpart of ``ray_tpu/parallel``.

- ``dp``   data parallelism (replicated params, sharded batch)
- ``fsdp`` fully-sharded data parallelism (params sharded over this axis too)
- ``tp``   tensor parallelism (weight matrices split)
- ``sp``   sequence parallelism (ring attention over the sequence split)
- ``ep``   expert parallelism (the MoE experts of ``models/moe.py``; the
           batch is replicated over it)
- ``pp``   pipeline stages (GPipe over the pp process group,
           ``parallel/pipeline.py``; ``models/pipeline_lm.py`` trains
           GPT-2 through it)
"""

from ray_tpu_torch.parallel.mesh import (
    MeshConfig,
    build_mesh,
    local_mesh,
    mesh_shape_for,
)
from ray_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_apply_unrolled,
    stack_stage_params,
)
from ray_tpu_torch.parallel.sharding import (
    PartitionRules,
    gpt_partition_rules,
    llama_partition_rules,
    match_partition_rules,
    shard_pytree,
    with_sharding_constraint,
)

__all__ = [
    "MeshConfig", "build_mesh", "local_mesh", "mesh_shape_for",
    "PartitionRules", "gpt_partition_rules", "llama_partition_rules",
    "match_partition_rules", "pipeline_apply", "pipeline_apply_unrolled",
    "shard_pytree", "stack_stage_params", "with_sharding_constraint",
]
