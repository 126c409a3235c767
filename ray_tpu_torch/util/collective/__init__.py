"""Port of ``ray_tpu/util/collective/__init__.py``.

Collective communication library.

Counterpart of ray.util.collective (reference: python/ray/util/collective/
collective.py:40 GroupManager, :120 init_collective_group, :258 allreduce; NCCL
backend collective_group/nccl_collective_group.py:128, gloo backend
gloo_collective_group.py:184).  Two backends, TPU-native split:

- ``xla`` (the ICI fast path): collectives INSIDE jit — thin wrappers over
  jax.lax.psum/all_gather/ppermute compiled by XLA onto ICI.  Multi-host jax
  processes join one program via jax.distributed; no eager message passing.
- ``cpu`` (the gloo-equivalent): eager cross-process collectives over the
  runtime's RPC + GCS-KV rendezvous, for host-side data and CPU-only tests.
"""

from ray_tpu_torch.util.collective.collective import (
    AsyncCollectiveHandle,
    allgather,
    allreduce,
    barrier,
    broadcast,
    destroy_collective_group,
    get_collective_group_size,
    get_group_progress,
    get_or_init_collective_group,
    get_rank,
    init_collective_group,
    recv,
    reducescatter,
    rejoin_collective_group,
    send,
    wait_all,
)
from ray_tpu_torch.util.collective import quantization, topology

__all__ = [
    "init_collective_group", "rejoin_collective_group",
    "get_or_init_collective_group",
    "destroy_collective_group", "allreduce",
    "allgather", "reducescatter", "broadcast", "send", "recv", "barrier",
    "wait_all", "AsyncCollectiveHandle",
    "get_rank", "get_collective_group_size", "get_group_progress",
    "quantization", "topology",
]
