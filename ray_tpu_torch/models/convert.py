"""Flax param tree -> PyTorch state dict, for GPT-2 and Llama.

The flax tree of ``ray_tpu/models/gpt2.GPT2LMModel`` (numpy arrays, the
``{"params": ...}`` wrapper optional) maps onto ``models/gpt2.GPT2LMModel``:

    wte/embedding              -> wte.weight            (V, E)
    wpe/embedding              -> wpe.weight            (P, E)
    h_{i}/<path>/kernel (in,out) -> h.{i}.<path>.weight (out, in)
    h_{i}/<path>/bias          -> h.{i}.<path>.bias
    h_{i}/ln_*/scale           -> h.{i}.ln_*.weight
    ln_f/{scale,bias}          -> ln_f.{weight,bias}
    lm_head/kernel (E, V)      -> lm_head.weight        (V, E)
    h_{i}/moe_mlp/router/kernel -> h.{i}.moe_mlp.router.weight (n_experts, E)
    h_{i}/moe_mlp/w_in, w_out  -> h.{i}.moe_mlp.w_in, w_out (flax layout)

The serving runner (``llm/model_runner.py``) keeps its weights under the
same names, so one mapping serves both.  The Llama tree
(``ray_tpu/models/llama.LlamaLMModel``) follows the same rules
(``llama_params_from_flax``), and so does the MLP of ``models/mlp.py``
(``dense_{i}`` and ``head``).  ``flax_paths`` is the naming the other way:
each parameter of a port model to its flax path.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


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


def llama_params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """State dict (f32 CPU tensors) of the port's ``LlamaLMModel``:

        wte/embedding                 -> wte.weight             (V, E)
        h_{i}/attn/w{q,k,v,o}/kernel  -> h.{i}.attn.w{q,k,v,o}.weight,
                                         transposed to (out, in)
        h_{i}/mlp/{gate,up,down}_proj/kernel -> h.{i}.mlp.*.weight (T)
        h_{i}/{attn,mlp}_norm/scale   -> h.{i}.{attn,mlp}_norm.weight
        norm_f/scale                  -> norm_f.weight
        lm_head/kernel (E, V)         -> lm_head.weight         (V, E)

    The rules of ``params_from_flax``, which it applies."""
    return params_from_flax(tree)


def flax_paths(model: nn.Module) -> Dict[str, str]:
    """Each parameter name of a port model -> its path in the flax tree
    (``h.0.attn.qkv_proj.weight`` -> ``h_0/attn/qkv_proj/kernel``): a
    Linear's weight is a ``kernel``, an Embedding's an ``embedding``, a
    norm's a ``scale``; biases keep their name."""
    out = {}
    for mod_name, mod in model.named_modules():
        parts = mod_name.split(".") if mod_name else []
        if parts[:1] == ["h"] and len(parts) > 1:
            parts = [f"h_{parts[1]}"] + parts[2:]
        for leaf, _ in mod.named_parameters(recurse=False):
            flax_leaf = leaf
            if leaf == "weight":
                flax_leaf = ("embedding" if isinstance(mod, nn.Embedding)
                             else "kernel" if isinstance(mod, nn.Linear)
                             else "scale")
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            out[name] = "/".join(parts + [flax_leaf])
    return out


def runner_weights_from_flax(tree: Mapping, device) -> Dict[str, torch.Tensor]:
    """The runner's weights: ``params_from_flax`` moved to ``device``."""
    return {name: t.to(device) for name, t in params_from_flax(tree).items()}
