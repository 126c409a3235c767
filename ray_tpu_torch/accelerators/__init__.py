"""Port of ``ray_tpu/accelerators/__init__.py``.

Accelerator plugin registry.

Counterpart of the reference's accelerator managers (reference:
python/ray/_private/accelerators/__init__.py + accelerator.py ABC).  Each manager
detects local hardware and contributes resources to the node; the GPU manager is
the first-class citizen here, as in the reference.
"""

from __future__ import annotations

from typing import Dict

from ray_tpu_torch.accelerators.accelerator import AcceleratorManager
from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager

_MANAGERS = [GPUAcceleratorManager()]


def get_all_accelerator_managers():
    return list(_MANAGERS)


def detect_accelerator_resources() -> Dict[str, float]:
    res: Dict[str, float] = {}
    for mgr in _MANAGERS:
        count = mgr.get_current_node_num_accelerators()
        if count > 0:
            res[mgr.get_resource_name()] = float(count)
            res.update(mgr.get_current_node_additional_resources())
    return res


def gpu_manager() -> GPUAcceleratorManager:
    return _MANAGERS[0]
