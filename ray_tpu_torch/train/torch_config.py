"""TorchConfig: bring up torch.distributed on a train worker group.

The port of ``ray_tpu/train/jax_config.py``, after the reference's torch
backend (reference: python/ray/train/torch/config.py TorchConfig,
_setup_torch_process_group).  Every worker of a gang of more than one runs
``torch.distributed.init_process_group`` with its world rank and the world
size, rendezvousing at a free port on rank 0's node; NCCL on the CUDA cards,
gloo on the CPU.  A gang of one starts no process group, as a one-process
gang starts no ``jax.distributed`` in the JAX package: its trainer runs plain
tensors on its card.

Worker placement -> ranks: world rank i = bundle i of the gang's placement
group, and a worker's local rank is its place among the workers on its
node.  With ``pipeline_stages`` or ``dp_replicas`` (set by
``TorchTrainer(pipeline_stages=N, mesh=(dp, 1))``) the worker group
factors replica-major into dp × N contiguous gangs, each its own world:
stages exchange channel frames and replicas sync over the host collective
ring, never through torch.distributed, so MPMD gangs of one worker bring
up no process group, and only they may take a share of a card
(``ScalingConfig(gpus_per_worker=0.5)``).  The device follows
``ScalingConfig.use_gpu``.  The nodelet gives each
GPU worker's lease its own card (``CUDA_VISIBLE_DEVICES``); before CUDA
starts, the gang's workers on a node all see the cards given to them, so
that NCCL reaches its peers' cards, and each binds its own.  CUDA's current
device is per thread, so the worker binds each thread that runs user code
to its card (``_worker_group.set_thread_setup``): the session's loop thread
and every ``execute``.  ``torch.cuda.current_device()`` inside the loop,
and so every entry point's default device, is the worker's own card.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.train import _worker_group
from ray_tpu_torch.train._worker_group import WorkerGroup

DEFAULT_INIT_TIMEOUT_S = 300.0


@dataclass
class BackendConfig:
    """Base backend config (reference: train/backend_config.py)."""

    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Framework hook points (reference: train/_internal/backend_executor.py
    Backend.on_start/on_training_start/on_shutdown)."""

    def on_start(self, worker_group: WorkerGroup, backend_config: BackendConfig):
        pass

    def on_training_start(self, worker_group: WorkerGroup,
                          backend_config: BackendConfig):
        pass

    def on_shutdown(self, worker_group: WorkerGroup,
                    backend_config: BackendConfig):
        pass


@dataclass
class TorchConfig(BackendConfig):
    """Backend config for torch.distributed training.  The device follows
    ``ScalingConfig.use_gpu``: GPU workers each on a card of their own with
    NCCL between them (the default), CPU workers with gloo.  Nothing falls
    back: the cards must be there when they are asked for.

    init_timeout_s: how long the rendezvous and the gang's first
        collective may take.
    """

    init_timeout_s: float = DEFAULT_INIT_TIMEOUT_S
    # MPMD pipeline layout (set by TorchTrainer(pipeline_stages=N)): the
    # worker group splits into N contiguous stage gangs, each its own world
    pipeline_stages: int = 1
    # data-parallel replicas of the pipeline (TorchTrainer(mesh=(dp, 1))):
    # the group factors replica-major into dp_replicas × pipeline_stages
    # gangs; replicas sync gradients over the host collective ring
    dp_replicas: int = 1

    @property
    def backend_cls(self):
        return _TorchBackend


def check_card_share(gpus_per_worker: float, gang: int) -> None:
    """A share of a card (0 < gpus_per_worker < 1) is for gangs of one
    worker, which bring up no process group; a gang of more forms one, and
    NCCL puts no two ranks on one card."""
    if 0 < gpus_per_worker < 1 and gang > 1:
        raise ValueError(
            f"gpus_per_worker={gpus_per_worker:g}: a share of a card is for "
            f"gangs of one worker (num_workers=1, or MPMD stage gangs: "
            f"pipeline_stages or mesh with num_workers == dp * "
            f"pipeline_stages); this layout puts "
            f"{gang} workers in one torch.distributed gang, which needs a "
            f"card for each")


def _device_and_backend(resources_per_worker: Dict[str, float]
                        ) -> Tuple[str, str]:
    """``("cuda", "nccl")`` for a gang of GPU workers, else ``("cpu",
    "gloo")``."""
    if resources_per_worker.get("GPU", 0.0) > 0:
        return "cuda", "nccl"
    return "cpu", "gloo"


def _given_cards() -> Optional[str]:
    """The cards that the nodelet gave this worker's lease."""
    import os

    return os.environ.get("CUDA_VISIBLE_DEVICES")


def _shared_cards(node_ranks: List[List[int]], given: List[str]
                  ) -> Tuple[List[str], List[int]]:
    """For each rank, the cards given to the gang's workers on its node
    (``node_ranks``: the ranks of each node), which it makes visible so
    that NCCL reaches its peers' cards, and the index among them of its
    own first card."""
    cards: List[str] = [""] * len(given)
    card: List[int] = [0] * len(given)
    for ranks in node_ranks:
        shared = list(dict.fromkeys(
            i for r in ranks for i in given[r].split(",")))
        for r in ranks:
            cards[r] = ",".join(shared)
            card[r] = shared.index(given[r].split(",")[0])
    return cards, card


def _setup_torch_distributed(rank: int, world_size: int, local_rank: int,
                             local_world_size: int, master_addr: str,
                             master_port: int, cards: Optional[str],
                             card: Optional[int], backend: str,
                             init_timeout_s: float) -> tuple:
    """Runs INSIDE each train worker before any device use: the launcher's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); for a GPU
    worker the cards of the gang's workers on its node made visible
    (``cards``) and its own (index ``card`` among them) bound to its
    threads; then the process group when the gang has more than one
    worker.  Returns ``(rank, world size, backend, device index, PCI bus id,
    torch version)``; the backend is None for a gang of one, and the device
    index and bus id are None on the CPU."""
    import datetime
    import os

    import torch
    import torch.distributed as dist

    # a dict, not keywords: the wire-contract extractor reads a top-level
    # function's ``.update(name=...)`` as a table of RPC handlers
    os.environ.update({
        "RANK": str(rank), "WORLD_SIZE": str(world_size),
        "LOCAL_RANK": str(local_rank),
        "LOCAL_WORLD_SIZE": str(local_world_size),
        "MASTER_ADDR": master_addr, "MASTER_PORT": str(master_port)})
    index = bus_id = None
    if cards is not None:
        # CUDA reads the variable once, when it starts
        if os.environ.get("CUDA_VISIBLE_DEVICES") != cards and \
                torch.cuda.is_initialized():
            raise RuntimeError(f"train worker {rank}: CUDA started before "
                               f"the gang's cards ({cards}) were set")
        os.environ["CUDA_VISIBLE_DEVICES"] = cards
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"train worker {rank}: no CUDA device is visible "
                f"(CUDA_VISIBLE_DEVICES={cards}); pass "
                f"ScalingConfig(use_gpu=False) for CPU workers")
        index = card
        torch.cuda.set_device(index)
        _worker_group.set_thread_setup(
            lambda: torch.cuda.set_device(index))
        bus_id = _pci_bus_id(index)
    if world_size > 1:
        dist.init_process_group(
            backend, init_method=f"tcp://{master_addr}:{master_port}",
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=init_timeout_s))
    return (rank, world_size, backend if world_size > 1 else None, index,
            bus_id, torch.__version__)


def _pci_bus_id(index: int) -> str:
    """The card's PCI address (domain:bus:device.function), as
    ``nvidia-smi`` writes it."""
    import torch

    props = torch.cuda.get_device_properties(index)
    return (f"{props.pci_domain_id:08X}:{props.pci_bus_id:02X}:"
            f"{props.pci_device_id:02X}.0")


def _teardown_torch_distributed() -> None:
    import torch.distributed as dist

    _worker_group.set_thread_setup(None)
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


class _TorchBackend(Backend):
    def on_start(self, worker_group: WorkerGroup,
                 backend_config: TorchConfig):
        import ray_tpu_torch

        n = len(worker_group)
        stages = max(1, backend_config.pipeline_stages)
        dp = max(1, backend_config.dp_replicas)
        # replica-major factoring: dp*stages independent worlds, each a
        # contiguous rank block of `gang` workers
        worlds = stages * dp
        if n % worlds:
            raise RuntimeError(
                f"worker group of {n} not divisible by dp_replicas * "
                f"pipeline_stages = {dp} * {stages}")
        gang = n // worlds
        device_type, backend = _device_and_backend(
            worker_group.resources_per_worker)
        given = (worker_group.execute(_given_cards)
                 if device_type == "cuda" else [None] * n)
        if device_type == "cuda" and not all(given):
            raise RuntimeError(f"a GPU train worker was given no card: "
                               f"{given}")
        refs = []
        for lo in range(0, n, gang):
            ranks = range(lo, lo + gang)
            # local ranks: each worker's place among its gang's on its node
            per_node = collections.defaultdict(list)
            for r in ranks:
                per_node[worker_group.metadata[r].node_id].append(r - lo)
            port = worker_group.execute_single(lo, _free_port)
            addr = worker_group.metadata[lo].node_ip
            cards: List[Optional[str]] = [None] * gang
            card: List[Optional[int]] = [None] * gang
            if device_type == "cuda":
                cards, card = _shared_cards(list(per_node.values()),
                                            given[lo:lo + gang])
            for r in ranks:
                siblings = per_node[worker_group.metadata[r].node_id]
                refs.append(worker_group.workers[r].execute.remote(
                    _setup_torch_distributed, r - lo, gang,
                    siblings.index(r - lo), len(siblings), addr, port,
                    cards[r - lo], card[r - lo], backend,
                    backend_config.init_timeout_s))
        infos = ray_tpu_torch.get(refs,
                                  timeout=backend_config.init_timeout_s)
        # within each gang one world, one backend, and on the cards a card
        # of its own for every rank
        for lo in range(0, n, gang):
            got = infos[lo:lo + gang]
            if len({(i[1], i[2]) for i in got}) != 1 or \
                    [i[0] for i in got] != list(range(gang)):
                raise RuntimeError(f"torch.distributed came up inconsistent "
                                   f"across gang {lo // gang} (replica-major "
                                   f"order): {got}")
            if device_type == "cuda":
                owned = {(meta.node_id, info[4]) for meta, info in
                         zip(worker_group.metadata[lo:lo + gang], got)}
                if len(owned) != gang:
                    raise RuntimeError(f"two ranks of gang {lo // gang} "
                                       f"share a card: {got}")
        self.device_info = infos

    def on_shutdown(self, worker_group: WorkerGroup,
                    backend_config: TorchConfig):
        import ray_tpu_torch

        try:
            ray_tpu_torch.get(
                worker_group.execute_async(_teardown_torch_distributed),
                timeout=10.0)
        except Exception:
            pass


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]
