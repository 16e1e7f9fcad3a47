"""Linear models (port of ``fedml_tpu/models/linear.py``)."""

from __future__ import annotations

import math

import torch
from torch import nn


class Dense(nn.Module):
    """``flax.linen.Dense`` layout: ``kernel`` (in, out), ``bias`` (out,);
    ``y = x @ kernel + bias``."""

    def __init__(self, features_in: int, features_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features_in, features_out))
        self.bias = nn.Parameter(torch.zeros(features_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class LogisticRegression(nn.Module):
    """LR over the flattened input; logits out (softmax-CE is the loss)."""

    def __init__(self, in_shape, num_classes: int):
        super().__init__()
        self.linear = Dense(math.prod(in_shape), num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x.reshape(x.shape[0], -1).float())
