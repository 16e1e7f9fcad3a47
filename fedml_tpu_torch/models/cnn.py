"""CNNs (port of ``fedml_tpu/models/cnn.py``).

Inputs are NHWC at the public boundary, as in the JAX package, and
parameters keep flax layout (HWIO conv kernels), so the flattened feature
order after the conv stack — and with it every parameter — is the same in
both packages. Activations run NCHW inside, which is what cuDNN takes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .linear import Dense


class Conv(nn.Module):
    """``flax.linen.Conv`` with SAME padding and stride 1: ``kernel``
    (H, W, in, out), ``bias`` (out,), NCHW activations."""

    def __init__(self, features_in: int, features_out: int, size: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(size, size, features_in, features_out))
        self.bias = nn.Parameter(torch.zeros(features_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), self.bias, padding="same")


class CNNOriginalFedAvg(nn.Module):
    """McMahan et al. CNN (reference ``CNN_OriginalFedAvg``): two 5x5 convs
    (32, 64) each followed by 2x2 maxpool, then 512-dense."""

    def __init__(self, in_shape=(28, 28, 1), num_classes: int = 10):
        super().__init__()
        h, w, c = in_shape
        self.Conv_0 = Conv(c, 32, 5)
        self.Conv_1 = Conv(32, 64, 5)
        self.Dense_0 = Dense((h // 4) * (w // 4) * 64, 512)
        self.Dense_1 = Dense(512, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        # flatten in NHWC order, as flax does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x)
