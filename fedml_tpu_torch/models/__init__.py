"""Model factory: ``create``, ``init_params`` and ``apply``.

Port of ``fedml_tpu/models/__init__.py`` for the slice's two models, ``lr``
and ``cnn_fedavg``. Parameters live outside the module as one flat dict
keyed by flax path (``params/Conv_0/kernel``), in ``jax.tree_util`` leaf
order and flax layout: the codec's per-leaf hash streams and the Krum
distances see exactly the leaves the JAX package sees. ``apply`` runs the
module on such a dict through ``torch.func.functional_call``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn
from torch.func import functional_call

from .cnn import CNNOriginalFedAvg
from .linear import LogisticRegression

__all__ = ["create", "init_params", "apply", "LogisticRegression", "CNNOriginalFedAvg"]

_PREFIX = "params/"


def create(args, output_dim: int, in_shape: Tuple[int, ...] = (28, 28, 1)) -> nn.Module:
    """The module named by ``args.model`` for inputs of (NHWC) ``in_shape``."""
    name = getattr(args, "model", "lr")
    if name == "lr":
        return LogisticRegression(in_shape, output_dim)
    if name == "cnn_fedavg":
        return CNNOriginalFedAvg(in_shape, output_dim)
    if name == "cnn":
        raise NotImplementedError(
            "model 'cnn' (CNN_DropOut) has dropout, which is not ported yet "
            "(ROADMAP.md Queue 1, item 3)")
    raise NotImplementedError(
        f"model '{name}' is not ported yet (ROADMAP.md Queue 1, items 3 and 7)")


def init_params(model: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fresh parameters with flax's default initialisers: LeCun-normal
    (truncated at two standard deviations) kernels, zero biases. Drawn
    from ``generator`` on the CPU, so the values do not depend on the
    device; torch cannot reproduce JAX's PRNG, so tests that compare the
    packages carry the JAX weights over (``utils.convert``)."""
    out = {}
    for name, p in model.named_parameters():
        t = torch.zeros(p.shape)
        if name.endswith("kernel"):
            fan_in = math.prod(p.shape[:-1])
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
        out[_PREFIX + name.replace(".", "/")] = t.to(p.device)
    return dict(sorted(out.items(), key=lambda kv: kv[0].split("/")))


def apply(model: nn.Module, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Forward pass of ``model`` with the path-keyed ``params``."""
    named = {k[len(_PREFIX):].replace("/", "."): v for k, v in params.items()}
    return functional_call(model, named, (x,))
