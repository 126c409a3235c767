"""Flax GPT-2 param tree -> PyTorch state dict.

The flax tree of ``ray_tpu/models/gpt2.GPT2LMModel`` (numpy arrays, the
``{"params": ...}`` wrapper optional) maps onto ``models/gpt2.GPT2LMModel``:

    wte/embedding              -> wte.weight            (V, E)
    wpe/embedding              -> wpe.weight            (P, E)
    h_{i}/<path>/kernel (in,out) -> h.{i}.<path>.weight (out, in)
    h_{i}/<path>/bias          -> h.{i}.<path>.bias
    h_{i}/ln_*/scale           -> h.{i}.ln_*.weight
    ln_f/{scale,bias}          -> ln_f.{weight,bias}
    lm_head/kernel (E, V)      -> lm_head.weight        (V, E)

The serving runner (``llm/model_runner.py``) keeps its weights under the
same names, so one mapping serves both.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path))
        else:
            flat[path] = np.asarray(val, np.float32)
    return flat


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict (f32 CPU tensors) of the port's ``GPT2LMModel``."""
    if "params" in tree and "wte" not in tree:
        tree = tree["params"]
    out = {}
    for path, arr in _flatten(tree).items():
        parts = path.split("/")
        leaf = parts[-1]
        if parts[0].startswith("h_"):
            parts[0] = "h." + parts[0][2:]
        if leaf == "kernel":
            parts[-1], arr = "weight", arr.T
        elif leaf in ("scale", "embedding"):
            parts[-1] = "weight"
        out[".".join(parts)] = torch.tensor(arr)
    return out


def runner_weights_from_flax(tree: Mapping, device) -> Dict[str, torch.Tensor]:
    """The runner's weights: ``params_from_flax`` moved to ``device``."""
    return {name: t.to(device) for name, t in params_from_flax(tree).items()}
