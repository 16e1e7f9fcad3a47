"""Model factory: ``create``, ``init_params`` and ``apply``.

Port of ``fedml_tpu/models/__init__.py`` for ``lr``, ``cnn_fedavg`` and the
CIFAR ResNets ``resnet56`` / ``resnet20`` / ``resnet8`` (GroupNorm).
Parameters live outside the module as one flat dict keyed by flax path
(``params/Conv_0/kernel``), in ``jax.tree_util`` leaf order and flax
layout: the codec's per-leaf hash streams and the Krum distances see
exactly the leaves the JAX package sees. ``apply`` runs the module on such
a dict through ``torch.func.functional_call``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn
from torch.func import functional_call

from .cnn import CNNOriginalFedAvg
from .linear import LogisticRegression
from .resnet import CifarResNet

__all__ = ["create", "init_params", "apply", "LogisticRegression", "CNNOriginalFedAvg",
           "CifarResNet"]

_PREFIX = "params/"


def create(args, output_dim: int, in_shape: Tuple[int, ...] = (28, 28, 1)) -> nn.Module:
    """The module named by ``args.model`` for inputs of (NHWC) ``in_shape``."""
    name = getattr(args, "model", "lr")
    if getattr(args, "use_bf16", False):
        raise NotImplementedError(
            "use_bf16 (bfloat16 compute) is not ported yet (ROADMAP.md Queue 1, item 7)")
    if name == "lr":
        return LogisticRegression(in_shape, output_dim)
    if name == "cnn_fedavg":
        return CNNOriginalFedAvg(in_shape, output_dim)
    if name in ("resnet56", "resnet20", "resnet8"):
        return CifarResNet(int(name[len("resnet"):]), output_dim, in_shape,
                           norm_kind=getattr(args, "norm", None) or "group",
                           conv_impl=getattr(args, "conv_impl", None) or "xla")
    if name == "cnn":
        raise NotImplementedError(
            "model 'cnn' (CNN_DropOut) has dropout, which is not ported yet "
            "(ROADMAP.md Queue 1, item 3)")
    raise NotImplementedError(
        f"model '{name}' is not ported yet (ROADMAP.md Queue 1, item 14)")


def init_params(model: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fresh parameters with flax's default initialisers: LeCun-normal
    (truncated at two standard deviations) ``kernel``s, ``Embed`` tables
    normal (not truncated) with standard deviation 1/sqrt(features), zero
    ``bias``es, norm ``scale``s at one. Drawn from ``generator`` on the CPU,
    so the values do not depend on the device; torch cannot reproduce JAX's
    PRNG, so tests that compare the packages carry the JAX weights over
    (``utils.convert``)."""
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "kernel":
            t = torch.empty(p.shape)
            std = math.sqrt(1.0 / math.prod(p.shape[:-1])) / 0.87962566103423978
            nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
        elif leaf == "embedding":
            # flax's Embed: variance_scaling(1, "fan_in", "normal", out_axis=0),
            # whose fan_in for a (num, features) table is the features
            t = torch.empty(p.shape)
            nn.init.normal_(t, 0.0, math.sqrt(1.0 / p.shape[-1]), generator=generator)
        elif leaf == "scale":
            t = torch.ones(p.shape)
        elif leaf == "bias":
            t = torch.zeros(p.shape)
        else:
            raise ValueError(f"no flax initialiser known for parameter '{name}'")
        out[_PREFIX + name.replace(".", "/")] = t.to(p.device)
    return dict(sorted(out.items(), key=lambda kv: kv[0].split("/")))


def apply(model: nn.Module, params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Forward pass of ``model`` with the path-keyed ``params``."""
    named = {k[len(_PREFIX):].replace("/", "."): v for k, v in params.items()}
    return functional_call(model, named, (x,))
