"""Port of ``ray_tpu/_private/resources.py``.

Node resource detection.

Counterpart of the reference's resource spec assembly (reference:
python/ray/_private/resource_spec.py) + accelerator plugin detection
(python/ray/_private/accelerators/).  CUDA cards are first-class resources
named ``GPU``, counted by the GPU accelerator manager.
"""

from __future__ import annotations

import os
from typing import Dict, Optional


def default_node_resources(overrides: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    res: Dict[str, float] = {}
    res["CPU"] = float(os.cpu_count() or 1)
    try:
        import psutil

        res["memory"] = float(psutil.virtual_memory().total)
    except Exception:
        res["memory"] = 4.0 * 1024**3
    # Accelerators: each manager contributes its resources if hardware is present.
    from ray_tpu_torch.accelerators import detect_accelerator_resources

    res.update(detect_accelerator_resources())
    if overrides:
        for k, v in overrides.items():
            if v is None:
                res.pop(k, None)
            else:
                res[k] = float(v)
    return res
