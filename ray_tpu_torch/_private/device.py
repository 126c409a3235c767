"""Device selection for the PyTorch port.

The port is written for one CUDA card.  Every entry point takes a
``device`` argument and resolves it here: nothing given means the card, and
the CPU is used only when a caller names it (the CPU tests do).  There is no
silent fallback: asking for the card on a machine without one raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises when no card
    is visible); ``"cpu"`` -> the CPU, only when asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev!r}: the port runs on "
                         "'cuda' (default) or, when asked, 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
