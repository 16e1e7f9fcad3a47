"""Linear models (port of ``fedml_tpu/models/linear.py``)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class Dense(nn.Module):
    """``flax.linen.Dense`` layout: ``kernel`` (in, out), ``bias`` (out,);
    ``y = x @ kernel + bias``. With ``dtype`` set, the input, the kernel and
    the bias are cast to it first, as flax's ``dtype`` does; the
    parameters themselves stay float32."""

    def __init__(self, features_in: int, features_out: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features_in, features_out))
        self.bias = nn.Parameter(torch.zeros(features_out)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = self.kernel, self.bias
        if self.dtype is not None:
            x, kernel = x.to(self.dtype), kernel.to(self.dtype)
            bias = None if bias is None else bias.to(self.dtype)
        y = x @ kernel
        return y if bias is None else y + bias


class LogisticRegression(nn.Module):
    """LR over the flattened input; logits out (softmax-CE is the loss).
    ``dtype`` is the compute dtype (``use_bf16``: bfloat16)."""

    def __init__(self, in_shape, num_classes: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.linear = Dense(math.prod(in_shape), num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor, ctx=None) -> torch.Tensor:
        return self.linear(x.reshape(x.shape[0], -1).float())
