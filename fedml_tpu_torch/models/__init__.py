"""Model factory: ``create``, ``init_params`` and ``apply``.

Port of ``fedml_tpu/models/__init__.py`` for ``lr``, ``cnn`` (CNN_DropOut),
``cnn_fedavg`` and the CIFAR ResNets ``resnet56`` / ``resnet20`` /
``resnet8`` (GroupNorm or BatchNorm), each in float32 or, under
``use_bf16``, bfloat16 compute. Variables live outside the module as one
flat dict keyed by flax path (``params/Conv_0/kernel``, and for BatchNorm
models ``batch_stats/BatchNorm_0/mean``), in ``jax.tree_util`` leaf order
and flax layout: the codec's per-leaf hash streams and the Krum distances
see exactly the leaves the JAX package sees. ``apply`` runs the module on
such a dict through ``torch.func.functional_call``, with flax's ``train``
flag, dropout keep masks in place of the ``dropout`` rng, and the updated
``batch_stats`` returned as ``mutable=["batch_stats"]`` returns them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.func import functional_call

from .cnn import CNNDropOut, CNNOriginalFedAvg, draw_dropout_masks
from .linear import LogisticRegression
from .norm import BatchNorm
from .resnet import CifarResNet

__all__ = ["create", "init_params", "apply", "dropout_layers", "draw_dropout_masks",
           "LogisticRegression", "CNNDropOut", "CNNOriginalFedAvg", "CifarResNet"]

PARAMS = "params/"
BATCH_STATS = "batch_stats/"


def create(args, output_dim: int, in_shape: Sequence[int] = (28, 28, 1)) -> nn.Module:
    """The module named by ``args.model`` for inputs of (NHWC) ``in_shape``
    (JAX ``models/__init__.py:69``)."""
    name = getattr(args, "model", "lr")
    dtype = torch.bfloat16 if getattr(args, "use_bf16", False) else None
    in_shape = tuple(in_shape)
    if name == "lr":
        return LogisticRegression(in_shape, output_dim, dtype)
    if name == "cnn":
        return CNNDropOut(in_shape, output_dim,
                          only_digits=getattr(args, "dataset", "mnist") == "mnist", dtype=dtype)
    if name == "cnn_fedavg":
        return CNNOriginalFedAvg(in_shape, output_dim, dtype)
    if name in ("resnet56", "resnet20", "resnet8"):
        return CifarResNet(int(name[len("resnet"):]), output_dim, in_shape,
                           norm_kind=getattr(args, "norm", None) or "group",
                           conv_impl=getattr(args, "conv_impl", None) or "xla", dtype=dtype)
    raise NotImplementedError(
        f"model '{name}' is not ported yet (ROADMAP.md Queue 1, item 14)")


def _leaf_init(name: str, p: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel":
        t = torch.empty(p.shape)
        std = math.sqrt(1.0 / math.prod(p.shape[:-1])) / 0.87962566103423978
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
        return t
    if leaf == "embedding":
        # flax's Embed: variance_scaling(1, "fan_in", "normal", out_axis=0),
        # whose fan_in for a (num, features) table is the features
        t = torch.empty(p.shape)
        nn.init.normal_(t, 0.0, math.sqrt(1.0 / p.shape[-1]), generator=generator)
        return t
    if leaf in ("scale", "var"):
        return torch.ones(p.shape)
    if leaf in ("bias", "mean"):
        return torch.zeros(p.shape)
    raise ValueError(f"no flax initialiser known for '{name}'")


def init_params(model: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fresh variables with flax's default initialisers: LeCun-normal
    (truncated at two standard deviations) ``kernel``s, ``Embed`` tables
    normal (not truncated) with standard deviation 1/sqrt(features), zero
    ``bias``es, norm ``scale``s at one; BatchNorm's ``batch_stats`` ``mean``
    at zero and ``var`` at one. Drawn from ``generator`` on the CPU, so the
    values do not depend on the device; torch cannot reproduce JAX's PRNG,
    so tests that compare the packages carry the JAX weights over
    (``utils.convert``)."""
    out = {}
    for prefix, named in ((PARAMS, model.named_parameters()),
                          (BATCH_STATS, model.named_buffers())):
        for name, p in named:
            out[prefix + name.replace(".", "/")] = _leaf_init(name, p, generator).to(p.device)
    return dict(sorted(out.items(), key=lambda kv: kv[0].split("/")))


def dropout_layers(model: nn.Module) -> List:
    """(per-example mask shape, rate) of each of the model's Dropouts, in
    call order; [] for a model without dropout."""
    fn = getattr(model, "dropout_layers", None)
    return fn() if fn is not None else []


def has_batch_stats(variables: Dict[str, torch.Tensor]) -> bool:
    return any(k.startswith(BATCH_STATS) for k in variables)


class ApplyContext:
    """What one ``apply`` call threads through the modules: the ``train``
    flag, the dropout keep masks, and the BatchNorm statistics the call
    advances (``stats``, keyed by ``batch_stats/...`` path)."""

    def __init__(self, train: bool, dropout: Optional[Sequence[torch.Tensor]]):
        self.train, self.dropout = train, dropout
        self.stats: Dict[str, torch.Tensor] = {}


def _name_batch_norms(model: nn.Module) -> None:
    if getattr(model, "_batch_norm_paths", False):
        return
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            m.path = (BATCH_STATS + name.replace(".", "/")).rstrip("/")
    model._batch_norm_paths = True


def apply(model: nn.Module, variables: Dict[str, torch.Tensor], x: torch.Tensor,
          train: bool = False, dropout: Optional[Sequence[torch.Tensor]] = None,
          mutable: bool = False):
    """Forward pass of ``model`` with the path-keyed ``variables``. In
    ``train`` mode BatchNorm normalises with the batch's statistics and
    ``dropout`` (the keep masks of :func:`draw_dropout_masks`) drives the
    Dropouts; otherwise both are identities on the running averages. With
    ``mutable`` it returns ``(out, batch_stats)``, the second the
    ``batch_stats/...`` leaves after the call (advanced in training,
    unchanged otherwise)."""
    _name_batch_norms(model)
    named = {}
    for k, v in variables.items():
        prefix = PARAMS if k.startswith(PARAMS) else BATCH_STATS
        named[k[len(prefix):].replace("/", ".")] = v
    ctx = ApplyContext(train, dropout)
    out = functional_call(model, named, (x,), {"ctx": ctx})
    if not mutable:
        return out
    return out, {k: ctx.stats.get(k, v) for k, v in variables.items()
                 if k.startswith(BATCH_STATS)}
