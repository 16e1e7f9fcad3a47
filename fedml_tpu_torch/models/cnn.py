"""CNNs (port of ``fedml_tpu/models/cnn.py``).

Inputs are NHWC at the public boundary, as in the JAX package, and
parameters keep flax layout (HWIO conv kernels), so the flattened feature
order after the conv stack — and with it every parameter — is the same in
both packages. Activations run NCHW inside, which is what cuDNN takes.
``dtype`` is the compute dtype (``use_bf16``: bfloat16): inputs, kernels
and biases are cast to it per op, the parameters stay float32.

Dropout (``CNNDropOut``) follows ``flax.linen.Dropout``: in training a
kept element is scaled by ``1 / keep``, a dropped one is zero. Torch cannot
replay JAX's PRNG and ``torch.func.vmap`` threads no generator, so the
keep masks are drawn outside the model (:func:`draw_dropout_masks`, from a
generator the simulator keys by (seed, round, client position, step)) and
come in through the apply context, one bool tensor per ``Dropout`` in call
order, in the NHWC layout of the activation it masks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .linear import Dense


class Conv(nn.Module):
    """``flax.linen.Conv`` with stride 1, SAME or VALID padding: ``kernel``
    (H, W, in, out), ``bias`` (out,), NCHW activations."""

    def __init__(self, features_in: int, features_out: int, size: int,
                 padding: str = "same", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.padding, self.dtype = padding, dtype
        self.kernel = nn.Parameter(torch.empty(size, size, features_in, features_out))
        self.bias = nn.Parameter(torch.zeros(features_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.kernel.permute(3, 2, 0, 1), self.bias
        if self.dtype is not None:
            x, w, b = x.to(self.dtype), w.to(self.dtype), b.to(self.dtype)
        return F.conv2d(x, w, b, padding=self.padding)


class Dropout(nn.Module):
    """``flax.linen.Dropout(rate)``: ``where(keep, x / (1 - rate), 0)`` with
    the context's ``index``-th mask in training, the identity otherwise."""

    def __init__(self, rate: float, index: int):
        super().__init__()
        self.rate, self.index = rate, index

    def forward(self, x: torch.Tensor, ctx=None) -> torch.Tensor:
        if ctx is None or not ctx.train:
            return x
        if ctx.dropout is None:
            raise ValueError("a model with dropout trains only with its keep masks "
                             "(models.draw_dropout_masks)")
        keep = ctx.dropout[self.index]
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype,
                                                                       device=x.device))


class CNNOriginalFedAvg(nn.Module):
    """McMahan et al. CNN (reference ``CNN_OriginalFedAvg``): two 5x5 convs
    (32, 64) each followed by 2x2 maxpool, then 512-dense."""

    def __init__(self, in_shape=(28, 28, 1), num_classes: int = 10,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        h, w, c = in_shape
        self.dtype = dtype
        self.Conv_0 = Conv(c, 32, 5, dtype=dtype)
        self.Conv_1 = Conv(32, 64, 5, dtype=dtype)
        self.Dense_0 = Dense((h // 4) * (w // 4) * 64, 512, dtype=dtype)
        self.Dense_1 = Dense(512, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor, ctx=None) -> torch.Tensor:
        x = x.to(self.dtype or torch.float32).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        # flatten in NHWC order, as flax does
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x)


class CNNDropOut(nn.Module):
    """FedAvg-paper CNN with dropout (reference ``CNN_DropOut``, JAX
    ``models/cnn.py:12``): two VALID 3x3 convs (32, 64), 2x2 maxpool,
    dropout 0.25, 128-dense, dropout 0.5, then 10 classes (``only_digits``)
    or ``num_classes``."""

    def __init__(self, in_shape=(28, 28, 1), num_classes: int = 62, only_digits: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        h, w, c = in_shape
        self.dtype = dtype
        self.Conv_0 = Conv(c, 32, 3, "valid", dtype)
        self.Conv_1 = Conv(32, 64, 3, "valid", dtype)
        self._pooled = ((h - 4) // 2, (w - 4) // 2, 64)
        self.Dropout_0 = Dropout(0.25, 0)
        self.Dense_0 = Dense(self._pooled[0] * self._pooled[1] * 64, 128, dtype=dtype)
        self.Dropout_1 = Dropout(0.5, 1)
        self.Dense_1 = Dense(128, 10 if only_digits else num_classes, dtype=dtype)

    def dropout_layers(self) -> List[Tuple[Tuple[int, ...], float]]:
        """(per-example mask shape, rate) of each Dropout, in call order."""
        return [(self._pooled, self.Dropout_0.rate), ((128,), self.Dropout_1.rate)]

    def forward(self, x: torch.Tensor, ctx=None) -> torch.Tensor:
        x = x.to(self.dtype or torch.float32).permute(0, 3, 1, 2)
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        x = F.max_pool2d(x, 2, 2).permute(0, 2, 3, 1)  # NHWC: the mask's layout
        x = self.Dropout_0(x, ctx).reshape(x.shape[0], -1)
        x = self.Dropout_1(F.relu(self.Dense_0(x)), ctx)
        return self.Dense_1(x)


def draw_dropout_masks(layers: Sequence[Tuple[Tuple[int, ...], float]], batch: int,
                       generator: torch.Generator, device=None) -> List[torch.Tensor]:
    """Keep masks (``uniform < 1 - rate``, as ``jax.random.bernoulli``) for
    one batch of ``batch`` examples, one (batch, *shape) bool tensor per
    layer of ``dropout_layers()``, drawn in order from ``generator``."""
    return [torch.rand((batch,) + tuple(shape), generator=generator, device=device) < 1.0 - rate
            for shape, rate in layers]
