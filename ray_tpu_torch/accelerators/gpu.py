"""GPU accelerator manager: CUDA card detection and visibility.

The port's counterpart of ``ray_tpu/accelerators/tpu.py`` (detection
``:56-70``, the visibility variable ``:126-127``), after the reference's
NVIDIA manager (reference: python/ray/_private/accelerators/nvidia_gpu.py):

- the node's cards are counted from ``CUDA_VISIBLE_DEVICES`` when it is
  set (entries up to the first invalid one, as the CUDA runtime reads it),
  else from the driver's ``/proc/driver/nvidia/gpus/*`` entries, else from
  ``nvidia-smi -L``; none of these imports torch, so the nodelet that
  spawns the workers neither pays torch's import nor initialises CUDA;
- ``CUDA_VISIBLE_DEVICES`` is the visibility variable: the nodelet gives
  each GPU lease card ids from its ``CardPool`` and sets the variable to
  them in the lease's worker;
- a request is a fraction of one card or a whole number of cards.
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Optional

from ray_tpu_torch.accelerators.accelerator import AcceleratorManager

NVIDIA_PROC_GPUS = "/proc/driver/nvidia/gpus"


def _visible_ids(value: str) -> List[str]:
    """The cards a ``CUDA_VISIBLE_DEVICES`` value leaves visible: its
    entries up to the first empty or negative one."""
    ids = []
    for entry in value.split(","):
        entry = entry.strip()
        if not entry or entry.startswith("-"):
            break
        ids.append(entry)
    return ids


class GPUAcceleratorManager(AcceleratorManager):
    def __init__(self, proc_dir: str = NVIDIA_PROC_GPUS):
        self.proc_dir = proc_dir

    def get_resource_name(self) -> str:
        return "GPU"

    # -- detection ------------------------------------------------------------
    def get_current_node_num_accelerators(self) -> int:
        visible = os.environ.get(self.get_visible_accelerator_ids_env_var())
        if visible is not None:
            return len(_visible_ids(visible))
        try:
            return len([d for d in os.listdir(self.proc_dir)
                        if os.path.isdir(os.path.join(self.proc_dir, d))])
        except OSError:
            pass
        try:
            out = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                                 text=True, timeout=10)
        except (OSError, subprocess.SubprocessError):
            return 0
        if out.returncode != 0:
            return 0
        return sum(1 for line in out.stdout.splitlines()
                   if line.startswith("GPU "))

    def get_visible_accelerator_ids_env_var(self) -> Optional[str]:
        return "CUDA_VISIBLE_DEVICES"

    def validate_resource_request_quantity(self, quantity: float) -> Optional[str]:
        if quantity < 0 or (quantity > 1 and quantity != int(quantity)):
            return (
                f"GPU request of {quantity} is invalid: a task can use a "
                f"fraction of one card or a whole number of cards.")
        return None


def gpu_ids(count: int) -> List[str]:
    """The ids of the node's ``count`` cards (its advertised ``GPU``): the
    visible entries of ``CUDA_VISIBLE_DEVICES`` when it is set and names
    that many, else the indices ``0 .. count - 1``."""
    ids = _visible_ids(os.environ.get("CUDA_VISIBLE_DEVICES") or "")
    return ids[:count] if len(ids) >= count else \
        [str(i) for i in range(count)]


class CardPool:
    """A node's cards by id, and the share of each that GPU leases hold."""

    def __init__(self, ids: List[str]):
        self.held = dict.fromkeys(ids, 0.0)

    def take(self, gpus: float) -> Optional[List[str]]:
        """Card ids for a lease of ``gpus`` GPU: whole cards that no lease
        holds, or for a fraction the fullest card with room for it; None
        when the cards are not free."""
        if gpus <= 0:
            return []
        if gpus >= 1:
            ids = [i for i, h in self.held.items() if h == 0.0][:int(gpus)]
        else:
            room = [i for i, h in self.held.items() if h + gpus <= 1 + 1e-9]
            ids = sorted(room, key=lambda i: -self.held[i])[:1]
        if len(ids) < max(int(gpus), 1):
            return None
        for i in ids:
            self.held[i] += min(gpus, 1.0)
        return ids

    def give_back(self, ids: List[str], gpus: float) -> None:
        for i in ids:
            self.held[i] = max(self.held[i] - min(gpus, 1.0), 0.0)
