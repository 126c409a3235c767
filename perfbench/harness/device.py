"""The card: its published peaks, the look for it, and what a result line
says of it."""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

# NVIDIA H100 SXM, dense rates without sparsity, at the full 700 W (NVIDIA's
# data sheet): bytes/s of HBM3 and FLOP/s by the type the products run in.
# The same numbers as the port's smoke script's table.
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "flops_per_s": {"bfloat16": 989e12, "float16": 989e12,
                    "tf32": 495e12, "float32": 67e12},
}

# top-level module names that may not be loaded by a run: JAX and the JAX
# package the port was made from, compared whole (``ray_tpu_torch`` is not
# ``ray_tpu``)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "ray_tpu")


def forbidden_loaded() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def look_for_cards(chips: int) -> Optional[str]:
    """None when ``chips`` CUDA cards are visible; otherwise why not."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards and "
                f"{torch.cuda.device_count()} are visible")
    return None


def power_limit_w(device) -> Optional[float]:
    """The card's power limit in watts as ``nvidia-smi`` reads it (a card
    set under its 700 W runs slower under load); None where it cannot be
    read."""
    import subprocess

    import torch

    try:
        uuid = str(torch.cuda.get_device_properties(device).uuid)
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        rows = [line.split(",") for line in out.strip().splitlines()]
        mine = [w for u, w in rows if uuid in u] or (
            [rows[0][1]] if len(rows) == 1 else [])
        return float(mine[0]) if mine else None
    except (OSError, subprocess.SubprocessError, RuntimeError, ValueError,
            AttributeError, IndexError):
        return None


def device_facts(device, chips: int, memory_peak_bytes: int) -> Dict:
    """The ``device`` object of the result line; the peak is the one read
    when the window closed, before the reference ran."""
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": chips,
                "memory_peak_bytes": int(memory_peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(memory_peak_bytes),
            "power_limit_w": power_limit_w(device)}
