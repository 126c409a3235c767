"""MNIST-scale MLP: the port of ``ray_tpu/models/mlp.py`` (BASELINE.json
config #2, the JaxTrainer MNIST MLP).

Dense layers ``dense_{i}`` with ReLU between them and a ``head``, on the
input flattened to (B, -1); a flax param tree loads through
``models/convert.params_from_flax``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device


class MLP(nn.Module):
    """``MLP(features=(512, 256, 10), in_features=784, device=None)``: f32
    parameters on ``device`` (the CUDA card unless ``"cpu"`` is passed).
    flax infers the input width at init; here it is ``in_features``."""

    def __init__(self, features: Sequence[int] = (512, 256, 10),
                 in_features: int = 784, device=None):
        super().__init__()
        self.features = tuple(features)
        widths = (in_features,) + self.features
        for i in range(len(self.features) - 1):
            setattr(self, f"dense_{i}", nn.Linear(widths[i], widths[i + 1]))
        self.head = nn.Linear(widths[-2], widths[-1])
        self.to(resolve_device(device))

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(len(self.features) - 1):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return self.head(x)


def classification_loss(logits, labels):
    """Mean cross entropy of integer ``labels``, in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None].long()).mean()


__all__ = ["MLP", "classification_loss"]
