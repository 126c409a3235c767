"""GPT-2's weights made on the device from the seed, and the port's
configuration for a configuration file.

GPT-2's own initialisation (Radford et al. 2019; the published code and
``GPT2PreTrainedModel._init_weights``): every matrix and embedding normal
with standard deviation ``initializer_range``, the two projections that
write into the residual stream (``out_proj``, ``fc_out``) scaled by
1/sqrt(2 n_layer), biases 0, LayerNorm scales 1.  ``lm_head`` is a matrix
of its own, as the port keeps it.  All normals come from one generator on
the device in one call, in float32, laid out as a state dict; both the
program and the reference are handed these tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch

from perfbench.harness.seeds import WEIGHTS, derive


def shapes(cfg: Mapping) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every parameter of GPT-2 (untied ``lm_head``) by state-dict name."""
    E, V, P = cfg["n_embd"], cfg["vocab_size"], cfg["n_positions"]
    F = cfg.get("n_inner") or 4 * E
    out = [("wte.weight", (V, E)), ("wpe.weight", (P, E))]
    for i in range(cfg["n_layer"]):
        p = f"h.{i}."
        out += [(p + "ln_1.weight", (E,)), (p + "ln_1.bias", (E,)),
                (p + "attn.qkv_proj.weight", (3 * E, E)),
                (p + "attn.qkv_proj.bias", (3 * E,)),
                (p + "attn.out_proj.weight", (E, E)),
                (p + "attn.out_proj.bias", (E,)),
                (p + "ln_2.weight", (E,)), (p + "ln_2.bias", (E,)),
                (p + "mlp.fc_in.weight", (F, E)),
                (p + "mlp.fc_in.bias", (F,)),
                (p + "mlp.fc_out.weight", (E, F)),
                (p + "mlp.fc_out.bias", (E,))]
    out += [("ln_f.weight", (E,)), ("ln_f.bias", (E,)),
            ("lm_head.weight", (V, E))]
    return out


def _std(name: str, cfg: Mapping) -> float:
    std = cfg["initializer_range"]
    if name.endswith(("out_proj.weight", "fc_out.weight")):
        std /= math.sqrt(2 * cfg["n_layer"])
    return std


def make_weights(cfg: Mapping, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of GPT-2 ``cfg`` drawn from ``seed`` on ``device``."""
    leaves = shapes(cfg)
    drawn = [(n, s) for n, s in leaves if len(s) == 2]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(derive(seed, WEIGHTS))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape in drawn:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(_std(name, cfg))
        at += n
    for name, shape in leaves:
        if len(shape) == 1:  # a LayerNorm's scale, or a bias
            fill = 1.0 if name.endswith("weight") else 0.0
            out[name] = torch.full(shape, fill, device=device)
    return {name: out[name] for name, _ in leaves}


def port_config(cfg: Mapping, **kwargs):
    """The port's ``GPT2Config`` for the configuration ``cfg`` (``kwargs``
    set how it runs); refuses one the port cannot run as written."""
    from ray_tpu_torch.models.gpt2 import LN_EPS, GPT2Config

    if cfg.get("n_inner") not in (None, 4 * cfg["n_embd"]):
        raise ValueError("the port's MLP is four times the width")
    if cfg["layer_norm_epsilon"] != LN_EPS:
        raise ValueError(f"the port's LayerNorm epsilon is {LN_EPS}")
    return GPT2Config(vocab_size=cfg["vocab_size"],
                      n_positions=cfg["n_positions"], n_embd=cfg["n_embd"],
                      n_layer=cfg["n_layer"], n_head=cfg["n_head"], **kwargs)
