"""CIFAR ResNets (port of ``fedml_tpu/models/resnet.py``: ``BasicBlock``:62
and ``CifarResNet``:86) with GroupNorm, NHWC throughout.

Submodules carry flax's auto-names, so the path-keyed leaves are the JAX
package's: top level ``Conv_0``, ``GroupNorm_0``, ``BasicBlock_0..3n-1``,
``Dense_0``; inside a block ``Conv_0``, ``Conv_1``, ``GroupNorm_0``,
``GroupNorm_1`` and, where the shape changes, ``proj`` / ``proj_norm``.
``conv_impl`` picks the conv path of ``ops.conv.Conv``; ``"pallas"`` runs
every stride-1 3x3 conv through the CUDA kernels. BatchNorm (``norm:
batch`` / ``sync_batch``, whose ``batch_stats`` thread through local
training) is not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.conv import Conv
from .linear import Dense
from .norm import GroupNorm


class BasicBlock(nn.Module):
    """Two 3x3 convs with GroupNorm and a projected shortcut where the
    output shape differs from the input's (``residual.shape != y.shape``)."""

    def __init__(self, in_shape, filters: int, strides: int = 1, conv_impl: str = "xla"):
        super().__init__()
        h, w, c = in_shape
        self.Conv_0 = Conv(c, filters, (3, 3), strides, "SAME", conv_impl)
        self.GroupNorm_0 = GroupNorm(filters)
        self.Conv_1 = Conv(filters, filters, (3, 3), 1, "SAME", conv_impl)
        self.GroupNorm_1 = GroupNorm(filters)
        self.out_shape = (-(-h // strides), -(-w // strides), filters)
        self.has_proj = self.out_shape != tuple(in_shape)
        if self.has_proj:
            self.proj = Conv(c, filters, (1, 1), strides, "SAME", conv_impl)
            self.proj_norm = GroupNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        residual = self.proj_norm(self.proj(x)) if self.has_proj else x
        return torch.relu(y + residual)


class CifarResNet(nn.Module):
    """CIFAR-style 6n+2 ResNet: stages (16, 32, 64) x n blocks; depth 56
    -> n = 9, 20 -> 3, 8 -> 1. Inputs NHWC of ``in_shape``."""

    def __init__(self, depth: int = 56, num_classes: int = 10, in_shape=(32, 32, 3),
                 norm_kind: str = "group", conv_impl: str = "xla"):
        super().__init__()
        if norm_kind != "group":
            raise NotImplementedError(
                f"norm '{norm_kind}' (BatchNorm and its batch_stats) is not ported yet "
                "(ROADMAP.md Queue 1, item 7); use 'group'")
        n = (depth - 2) // 6
        h, w, c = in_shape
        self.Conv_0 = Conv(c, 16, (3, 3), 1, "SAME", conv_impl)
        self.GroupNorm_0 = GroupNorm(16)
        shape = (h, w, 16)
        self._blocks = []
        for i, filters in enumerate((16, 32, 64)):
            for j in range(n):
                block = BasicBlock(shape, filters, 2 if i > 0 and j == 0 else 1, conv_impl)
                name = f"BasicBlock_{len(self._blocks)}"
                setattr(self, name, block)
                self._blocks.append(name)
                shape = block.out_shape
        self.Dense_0 = Dense(64, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.GroupNorm_0(self.Conv_0(x.float())))
        for name in self._blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(1, 2)))
