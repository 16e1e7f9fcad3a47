"""CIFAR ResNets (port of ``fedml_tpu/models/resnet.py``: ``BasicBlock``:62
and ``CifarResNet``:86) with GroupNorm or BatchNorm, NHWC throughout.

Submodules carry flax's auto-names, so the path-keyed leaves are the JAX
package's: top level ``Conv_0``, ``GroupNorm_0`` (``BatchNorm_0``),
``BasicBlock_0..3n-1``, ``Dense_0``; inside a block ``Conv_0``, ``Conv_1``,
``GroupNorm_0``, ``GroupNorm_1`` (``BatchNorm_*``) and, where the shape
changes, ``proj`` / ``proj_norm``. ``conv_impl`` picks the conv path of
``ops.conv.Conv``; ``"pallas"`` runs every stride-1 3x3 conv through the
CUDA kernels. ``dtype`` is the compute dtype (``use_bf16``: bfloat16): the
input is cast to it at entry and every conv, norm and the head compute in
it from float32 parameters cast per op, as the JAX modules' ``dtype`` does.
``norm: batch`` threads the ``batch_stats`` collection through training
(``norm.BatchNorm``, running averages out of training, ``resnet.py:101``);
``sync_batch`` all-reduces the batch statistics over a device axis, which
nothing binds on one device, and raises.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.conv import Conv
from .linear import Dense
from .norm import BatchNorm, GroupNorm

NORMS = {"group": ("GroupNorm", GroupNorm), "batch": ("BatchNorm", BatchNorm)}


class BasicBlock(nn.Module):
    """Two 3x3 convs with a norm each and a projected shortcut where the
    output shape differs from the input's (``residual.shape != y.shape``)."""

    def __init__(self, in_shape, filters: int, strides: int = 1, conv_impl: str = "xla",
                 norm_kind: str = "group", dtype=None):
        super().__init__()
        h, w, c = in_shape
        name, norm = NORMS[norm_kind]
        self._norms = (f"{name}_0", f"{name}_1")
        self.Conv_0 = Conv(c, filters, (3, 3), strides, "SAME", conv_impl, dtype)
        setattr(self, self._norms[0], norm(filters, dtype=dtype))
        self.Conv_1 = Conv(filters, filters, (3, 3), 1, "SAME", conv_impl, dtype)
        setattr(self, self._norms[1], norm(filters, dtype=dtype))
        self.out_shape = (-(-h // strides), -(-w // strides), filters)
        self.has_proj = self.out_shape != tuple(in_shape)
        if self.has_proj:
            self.proj = Conv(c, filters, (1, 1), strides, "SAME", conv_impl, dtype)
            self.proj_norm = norm(filters, dtype=dtype)

    def forward(self, x: torch.Tensor, ctx=None) -> torch.Tensor:
        n0, n1 = (getattr(self, n) for n in self._norms)
        y = torch.relu(n0(self.Conv_0(x), ctx))
        y = n1(self.Conv_1(y), ctx)
        residual = self.proj_norm(self.proj(x), ctx) if self.has_proj else x
        return torch.relu(y + residual)


class CifarResNet(nn.Module):
    """CIFAR-style 6n+2 ResNet: stages (16, 32, 64) x n blocks; depth 56
    -> n = 9, 20 -> 3, 8 -> 1. Inputs NHWC of ``in_shape``."""

    def __init__(self, depth: int = 56, num_classes: int = 10, in_shape=(32, 32, 3),
                 norm_kind: str = "group", conv_impl: str = "xla", dtype=None):
        super().__init__()
        if norm_kind == "sync_batch":
            raise NotImplementedError(
                "norm 'sync_batch' all-reduces BatchNorm statistics over a device axis "
                "(SYNC_BN_AXIS), which needs a mesh (ROADMAP.md Queue 1, item 10); use 'batch'")
        if norm_kind not in NORMS:
            raise ValueError(f"unknown norm '{norm_kind}' (group | batch | sync_batch)")
        n = (depth - 2) // 6
        h, w, c = in_shape
        self.dtype = dtype
        name, norm = NORMS[norm_kind]
        self._norm = f"{name}_0"
        self.Conv_0 = Conv(c, 16, (3, 3), 1, "SAME", conv_impl, dtype)
        setattr(self, self._norm, norm(16, dtype=dtype))
        shape = (h, w, 16)
        self._blocks = []
        for i, filters in enumerate((16, 32, 64)):
            for j in range(n):
                block = BasicBlock(shape, filters, 2 if i > 0 and j == 0 else 1, conv_impl,
                                   norm_kind, dtype)
                name = f"BasicBlock_{len(self._blocks)}"
                setattr(self, name, block)
                self._blocks.append(name)
                shape = block.out_shape
        self.Dense_0 = Dense(64, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor, ctx=None) -> torch.Tensor:
        x = x.to(self.dtype or torch.float32)
        x = torch.relu(getattr(self, self._norm)(self.Conv_0(x), ctx))
        for name in self._blocks:
            x = getattr(self, name)(x, ctx)
        return self.Dense_0(x.mean(dim=(1, 2)))
