"""The local-training loop (port of ``fedml_tpu/algorithms/local_sgd.py``).

``local_update(global_params, data) -> ClientOutput`` runs one client's
epochs of plain SGD over its padded batch rectangle. It is written for ONE
client and made cohort-wide by ``torch.func.vmap`` in the simulator, the
counterpart of the JAX package's ``vmap`` over ``lax.scan``; gradients come
from ``torch.func.grad_and_value`` over the path-keyed parameter dict.

Padded rows are masked out of the loss and the gradient, and a batch with
no real rows is a no-op for the parameters (``local_sgd.py:274-286``).
Only the slice's optimizer is ported: plain SGD with cross-entropy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch.func import grad_and_value

from ..core.algframe import ClientOutput

Params = Dict[str, torch.Tensor]


def _masked_loss_and_metrics(out, y, mask):
    """Masked softmax cross-entropy plus (correct, valid) counts — the
    ``loss_kind="ce"`` branch of the JAX helper (``local_sgd.py:38``)."""
    logz = torch.log_softmax(out.float(), dim=-1)
    ll = torch.take_along_dim(logz, y.long()[..., None], dim=-1)[..., 0]
    valid = mask.sum()
    loss = -(ll * mask).sum() / torch.clamp(valid, min=1.0)
    correct = ((out.argmax(dim=-1) == y) * mask).sum()
    return loss, correct, valid


@dataclasses.dataclass(frozen=True)
class LocalTrainConfig:
    """Local optimizer settings. The slice ports plain SGD with a
    cross-entropy loss; every other setting of the JAX config raises."""

    lr: float = 0.03
    epochs: int = 1
    client_optimizer: str = "sgd"
    momentum: float = 0.0
    weight_decay: float = 0.0
    loss_kind: str = "ce"

    def __post_init__(self):
        if (self.client_optimizer != "sgd" or self.momentum
                or self.weight_decay or self.loss_kind != "ce"):
            raise NotImplementedError(
                "only plain SGD with a cross-entropy loss is ported "
                f"(got {self}); see ROADMAP.md Queue 1, item 3")


def make_loss_fn(apply_fn: Callable) -> Callable:
    """``(params, x, y, mask) -> (loss, (correct, valid))`` with masking."""

    def loss_fn(params, x, y, mask):
        loss, correct, valid = _masked_loss_and_metrics(apply_fn(params, x), y, mask)
        return loss, (correct, valid)

    return loss_fn


def make_local_update(apply_fn: Callable, cfg: LocalTrainConfig) -> Callable:
    """One client's local update. ``data`` holds x (NB, BS, *feat), y and
    mask (NB, BS), num_samples (); the update is the parameter delta."""
    grad_fn = grad_and_value(make_loss_fn(apply_fn), has_aux=True)
    neg_lr = -float(cfg.lr)

    def local_update(global_params: Params, data) -> ClientOutput:
        x, y, mask = data["x"], data["y"], data["mask"]
        params = global_params
        losses, corrects, valids, bweights = [], [], [], []
        for _ in range(cfg.epochs):
            for b in range(x.shape[0]):
                grads, (loss, (correct, valid)) = grad_fn(params, x[b], y[b], mask[b])
                bweight = (mask[b].sum() > 0).float()
                # optax.sgd: update = g * (-lr), applied as p + update; an
                # all-padding batch keeps the old parameters
                params = {
                    k: torch.where(bweight > 0, p + (grads[k] * bweight) * neg_lr, p)
                    for k, p in params.items()
                }
                losses.append(loss)
                corrects.append(correct)
                valids.append(valid)
                bweights.append(bweight)
        losses, bweights = torch.stack(losses), torch.stack(bweights)
        delta = {k: params[k] - global_params[k] for k in params}
        metrics = {
            "train_loss": (losses * bweights).sum() / torch.clamp(bweights.sum(), min=1.0),
            "train_correct": torch.stack(corrects).sum(),
            "train_valid": torch.stack(valids).sum(),
        }
        return ClientOutput(delta, data["num_samples"].float(), metrics)

    return local_update


def make_eval_fn(apply_fn: Callable) -> Callable:
    """Batched global eval: ``(params, x, y, mask) -> (loss_sum, correct,
    count)``; ``mask`` keeps the padded tail batch exact."""

    def eval_fn(params, x, y, mask):
        loss, correct, valid = _masked_loss_and_metrics(apply_fn(params, x), y, mask)
        return loss * valid, correct, valid

    return eval_fn
