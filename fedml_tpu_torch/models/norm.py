"""GroupNorm with ``flax.linen.GroupNorm``'s semantics, on NHWC tensors.

``num_groups = C // group_size``; statistics over (H, W, the group's
channels) in one pass, ``var = max(0, E[x^2] - E[x]^2)`` (flax's
``use_fast_variance``), ``epsilon`` 1e-6 (torch's default is 1e-5), and
``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in flax's order.
Plain tensor ops only, so it runs under ``torch.func.vmap``.
"""

from __future__ import annotations

import torch
from torch import nn


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm(num_groups=None, group_size=16)``: leaves
    ``scale`` (ones) and ``bias`` (zeros) of shape (C,)."""

    def __init__(self, features: int, group_size: int = 16, epsilon: float = 1e-6):
        super().__init__()
        if features % group_size:
            raise ValueError(f"{features} channels do not split into groups of {group_size}")
        self.group_size, self.epsilon = group_size, epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gs = self.group_size
        shape = (x.shape[-1] // gs, gs)
        xg = x.reshape(*x.shape[:-1], *shape)
        axes = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
        mean = xg.mean(dim=axes, keepdim=True)
        mean2 = (xg * xg).mean(dim=axes, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.reshape(shape)
        return ((xg - mean) * mul + self.bias.reshape(shape)).reshape(x.shape)
