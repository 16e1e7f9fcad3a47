"""GroupNorm and BatchNorm with ``flax.linen``'s semantics, on NHWC tensors.

Both take their statistics in float32 whatever the input's dtype (flax's
``force_float32_reductions``) in one pass, ``var = max(0, E[x^2] -
E[x]^2)`` (``use_fast_variance``), and normalise in flax's order, ``y = (x
- mean) * (rsqrt(var + eps) * scale) + bias``, in float32, rounding once to
the module's ``dtype`` (the input's when None). Plain tensor ops only, so
they run under ``torch.func.vmap``.

- :class:`GroupNorm`: ``epsilon`` 1e-6 (torch's default is 1e-5),
  statistics over (H, W, the group's channels).
- :class:`BatchNorm`: ``flax.linen.BatchNorm(momentum=0.9)``, ``epsilon``
  1e-5, statistics over every axis but the channels. It is functional: the
  running ``mean`` and ``var`` are buffers that ``models.apply`` replaces
  with the caller's ``batch_stats`` leaves, and in training mode the module
  writes the advanced averages ``0.9 ra + 0.1 batch`` (the batch variance
  biased, the reverse of torch's ``momentum`` convention) into the apply
  context instead of updating a buffer in place. Out of training it
  normalises with the running averages.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def _normalize(x, mean, var, epsilon, scale, bias, dtype):
    mul = torch.rsqrt(var + epsilon) * scale
    return ((x.float() - mean) * mul + bias).to(dtype or x.dtype)


def _fast_stats(xf: torch.Tensor, dims):
    mean = xf.mean(dim=dims, keepdim=True)
    mean2 = (xf * xf).mean(dim=dims, keepdim=True)
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm(num_groups=None, group_size=16)``: leaves
    ``scale`` (ones) and ``bias`` (zeros) of shape (C,)."""

    def __init__(self, features: int, group_size: int = 16, epsilon: float = 1e-6,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if features % group_size:
            raise ValueError(f"{features} channels do not split into groups of {group_size}")
        self.group_size, self.epsilon, self.dtype = group_size, epsilon, dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, ctx=None) -> torch.Tensor:
        gs = self.group_size
        shape = (x.shape[-1] // gs, gs)
        xg = x.float().reshape(*x.shape[:-1], *shape)
        mean, var = _fast_stats(xg, tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,))
        y = _normalize(xg, mean, var, self.epsilon, self.scale.reshape(shape),
                       self.bias.reshape(shape), self.dtype or x.dtype)
        return y.reshape(x.shape)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9)``: leaves ``scale`` (ones) and
    ``bias`` (zeros) under ``params``, ``mean`` (zeros) and ``var`` (ones)
    under ``batch_stats``, all of shape (C,). ``path`` is the module's
    ``batch_stats/...`` prefix, set by ``models.apply``."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.momentum, self.epsilon, self.dtype = momentum, epsilon, dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.path = None

    def forward(self, x: torch.Tensor, ctx=None) -> torch.Tensor:
        if ctx is not None and ctx.train:
            mean, var = _fast_stats(x.float(), tuple(range(x.dim() - 1)))
            mean, var = mean.reshape(-1), var.reshape(-1)
            m = self.momentum
            ctx.stats[f"{self.path}/mean"] = m * self.mean + (1 - m) * mean
            ctx.stats[f"{self.path}/var"] = m * self.var + (1 - m) * var
        else:
            mean, var = self.mean, self.var
        return _normalize(x, mean, var, self.epsilon, self.scale, self.bias, self.dtype)
