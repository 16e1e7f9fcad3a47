"""The local-training loop (port of ``fedml_tpu/algorithms/local_sgd.py``).

``local_update(global_params, client_state, data, rng) -> ClientOutput``
runs one client's epochs over its padded batch rectangle with the
configured local optimizer (``LocalTrainConfig.make_optimizer``: global
norm clipping, coupled weight decay, then SGD with optional momentum or
Adam, all from ``utils/optim.py``), an optional FedProx proximal term,
SCAFFOLD's control-variate correction, and example-level DP-SGD. It is
written for ONE client and made cohort-wide by ``torch.func.vmap`` in the
simulator, the counterpart of the JAX package's ``vmap`` over
``lax.scan``; gradients come from ``torch.func.grad_and_value`` over the
path-keyed parameter dict.

Padded rows are masked out of the loss and the gradient, and a batch with
no real rows is a no-op for the parameters AND the optimizer state
(``local_sgd.py:274-286``): momentum does not coast and Adam's count and
moments do not advance on it.

DP-SGD (``local_sgd.py:223-258``): per-example gradients (``vmap`` of
``grad`` over the batch, inside the cohort ``vmap``), each clipped to
``dp_l2_clip`` over the whole tree, summed, Gaussian noise of standard
deviation ``dp_noise_multiplier * dp_l2_clip`` added, divided by the
batch's real row count. Torch cannot replay JAX's PRNG and
``torch.func.vmap`` threads no generator, so the noise is drawn outside
(``simulation/fed_sim.py::dp_noise``) and comes in as ``rng``: a
``(steps, n_params)`` float32 tensor of standard normals, row ``s``
feeding batch step ``s`` (``epoch * n_batches + batch``), split over the
leaves in dict order. ``rng`` is None when no noise is drawn.

Dropout models (``needs_dropout``) take their keep masks the same way: the
simulator draws them outside (``simulation/fed_sim.py::dropout_masks``),
keyed by (seed, round, cohort position, batch step) as the JAX package
folds its dropout key (``fed_sim.py:329``, ``local_sgd.py:262``), and
passes them in ``data["dropout"]``: one bool tensor per Dropout layer of
shape ``(epochs * NB, BS, *layer shape)``, row ``s`` feeding step ``s``.

BatchNorm models (``has_batch_stats``, JAX ``_make_bn_local_update``:334):
the variables dict holds ``params/...`` and ``batch_stats/...`` leaves,
which the one loop carries apart (the statistics dict is empty for every
other model); the gradient is taken on the params only, the running statistics advance on
every batch with a real row (the forward in training mode returns them),
a batch without one leaves params, optimizer state and statistics alike
unchanged, and the delta covers both collections, so aggregation averages
the running statistics as the reference FedAvg does. SCAFFOLD and DP-SGD
refuse BatchNorm, with the JAX package's messages.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch.func import grad_and_value, vmap

from ..core.algframe import ClientOutput
from ..models import BATCH_STATS
from ..utils import optim

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
    """Local optimizer settings (``local_sgd.py:66``). ``prox_mu`` None is
    unset (the FedProx bundle defaults it to 0.1; an explicit 0.0 is
    honoured); ``dp_l2_clip`` None disables DP-SGD. Only the cross-entropy
    loss is ported: another ``loss_kind`` raises."""

    lr: float = 0.03
    epochs: int = 1
    client_optimizer: str = "sgd"  # sgd | adam
    momentum: float = 0.0
    weight_decay: float = 0.0
    prox_mu: Optional[float] = None
    use_scaffold: bool = False
    max_grad_norm: Optional[float] = None
    dp_l2_clip: Optional[float] = None
    dp_noise_multiplier: float = 0.0
    loss_kind: str = "ce"

    def __post_init__(self):
        if self.loss_kind != "ce":
            raise NotImplementedError(
                f"loss_kind={self.loss_kind!r} is not ported yet (ROADMAP.md Queue 1, "
                "item 3); the port trains with cross-entropy")

    def make_optimizer(self) -> optim.Transform:
        """The chain of ``local_sgd.py:95-105``: clip, decay, then adam or
        sgd (a trace only with momentum)."""
        chain = []
        if self.max_grad_norm:
            chain.append(optim.clip_by_global_norm(self.max_grad_norm))
        if self.weight_decay:
            chain.append(optim.add_decayed_weights(self.weight_decay))
        if self.client_optimizer == "adam":
            chain.append(optim.adam(self.lr))
        else:
            chain.append(optim.sgd(self.lr, momentum=self.momentum or None))
        return optim.chain(*chain)

    @property
    def dp_noise_sigma(self) -> float:
        """The noise's standard deviation on the clipped sum (0: clip only)."""
        return self.dp_noise_multiplier * self.dp_l2_clip if self.dp_l2_clip else 0.0


def make_loss_fn(apply_fn: Callable) -> Callable:
    """``(params, x, y, mask, dropout=None) -> (loss, (correct, valid))``
    with masking; ``dropout`` (the step's keep masks) runs the model in
    training mode."""

    def loss_fn(params, x, y, mask, dropout=None):
        out = (apply_fn(params, x) if dropout is None
               else apply_fn(params, x, train=True, dropout=dropout))
        loss, correct, valid = _masked_loss_and_metrics(out, y, mask)
        return loss, (correct, valid)

    return loss_fn


def _step_masks(data, step: int):
    masks = data.get("dropout")
    return None if masks is None else tuple(m[step] for m in masks)


def _split_noise(row: torch.Tensor, params: Params) -> Params:
    """A flat (n_params,) noise row as leaves shaped like ``params``."""
    out, off = {}, 0
    for k, p in params.items():
        n = p.numel()
        out[k] = row[off:off + n].reshape(p.shape)
        off += n
    return out


def make_local_update(apply_fn: Callable, cfg: LocalTrainConfig, needs_dropout: bool = False,
                      has_batch_stats: bool = False) -> Callable:
    """One client's local update. ``data`` holds x (NB, BS, *feat), y and
    mask (NB, BS), num_samples () and, with ``needs_dropout``, the keep
    masks ``dropout``; the update is the variables' delta (SCAFFOLD:
    ``{"delta", "delta_c"}``). ``client_state`` is ``()`` or SCAFFOLD's
    ``(c_global, c_local)``."""
    if cfg.dp_noise_multiplier > 0.0 and cfg.dp_l2_clip is None:
        raise ValueError(
            "dp_noise_multiplier set without dp_l2_clip — noise calibration "
            "needs the clip (sensitivity); set dp_l2_clip to enable DP-SGD")
    opt = cfg.make_optimizer()
    prox_mu = 0.0 if cfg.prox_mu is None else cfg.prox_mu
    if has_batch_stats:
        # local_sgd.py:191-212: hard errors, not silent non-private or
        # non-SCAFFOLD training (another loss_kind already fails in
        # LocalTrainConfig, and the port takes no custom loss)
        if cfg.use_scaffold:
            raise ValueError(
                "SCAFFOLD control variates are defined on params only; "
                "combine with GroupNorm models instead")
        if cfg.dp_l2_clip is not None:
            raise ValueError(
                "DP-SGD with BatchNorm is unsupported (running statistics "
                "leak unclipped example information); use a GroupNorm "
                "model variant")
    if needs_dropout and cfg.dp_l2_clip is not None:
        raise NotImplementedError(
            "DP-SGD on a dropout model (one mask per example step) is not ported yet "
            "(ROADMAP.md Queue 1, item 3)")
    loss_fn = make_loss_fn(apply_fn)

    def step_loss(params, stats, x, y, mask, dropout):
        """``loss_fn`` with the running statistics threaded: the aux also
        holds ``stats`` as the training-mode forward advanced them (an
        empty dict in, an empty dict out)."""
        if not stats:
            loss, (correct, valid) = loss_fn(params, x, y, mask, dropout)
            return loss, (correct, valid, stats)
        out, new_stats = apply_fn({**stats, **params}, x, train=True, dropout=dropout,
                                  mutable=True)
        loss, correct, valid = _masked_loss_and_metrics(out, y, mask)
        return loss, (correct, valid, new_stats)

    grad_fn = grad_and_value(step_loss, has_aux=True)
    sigma = cfg.dp_noise_sigma

    def ex_loss(p, ex_x, ex_y, ex_m):
        return loss_fn(p, ex_x[None], ex_y[None], ex_m[None])

    ex_grads = vmap(grad_and_value(ex_loss, has_aux=True), in_dims=(None, 0, 0, 0))

    def dp_grads(params, bx, by, bm, noise_row):
        """Per-example clip + noise (``local_sgd.py:223``)."""
        C = cfg.dp_l2_clip
        g_ex, (losses, (corrects, valids)) = ex_grads(params, bx, by, bm)
        sq = sum(torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1) for g in g_ex.values())
        scale = torch.clamp(C / torch.clamp(torch.sqrt(sq), min=1e-12), max=1.0)
        summed = {k: (g * scale.reshape((-1,) + (1,) * (g.dim() - 1))).sum(dim=0)
                  for k, g in g_ex.items()}
        if sigma > 0.0:
            noise = _split_noise(noise_row, summed)
            summed = {k: g + sigma * noise[k] for k, g in summed.items()}
        denom = torch.clamp(bm.sum(), min=1.0)
        grads = {k: g / denom for k, g in summed.items()}
        loss = (losses * bm.reshape(losses.shape)).sum() / denom
        return grads, (loss, (corrects.sum(), valids.sum()))

    def local_update(global_variables: Params, client_state, data, rng=None) -> ClientOutput:
        x, y, mask = data["x"], data["y"], data["mask"]
        n_batches = x.shape[0]
        if sigma > 0.0 and rng is None:
            raise ValueError("DP-SGD noise needs the client's pre-drawn normals as rng "
                             "(simulation.fed_sim.dp_noise)")
        if cfg.use_scaffold:
            c_global, c_local = client_state
            correction = {k: c_global[k] - c_local[k] for k in c_global}
        global_params = {k: v for k, v in global_variables.items()
                         if not k.startswith(BATCH_STATS)}
        stats = {k: v for k, v in global_variables.items() if k.startswith(BATCH_STATS)}
        params = global_params
        opt_state = opt.init(global_params)
        losses, corrects, valids, bweights = [], [], [], []
        for epoch in range(cfg.epochs):
            for b in range(n_batches):
                bm = mask[b]
                if cfg.dp_l2_clip is not None:
                    row = None if rng is None else rng[epoch * n_batches + b]
                    grads, (loss, (correct, valid)) = dp_grads(params, x[b], y[b], bm, row)
                    new_stats = stats
                else:
                    grads, (loss, (correct, valid, new_stats)) = grad_fn(
                        params, stats, x[b], y[b], bm, _step_masks(data, epoch * n_batches + b))
                if prox_mu > 0.0:
                    grads = {k: g + (params[k] - global_params[k]) * prox_mu
                             for k, g in grads.items()}
                if cfg.use_scaffold:
                    grads = {k: g + correction[k] for k, g in grads.items()}
                # an all-padding batch is a no-op for the parameters, the
                # optimizer state and the running statistics alike
                bweight = (bm.sum() > 0).float()
                grads = {k: g * bweight for k, g in grads.items()}
                updates, new_state = opt.update(grads, opt_state, params)
                new_params = optim.apply_updates(params, updates)
                real = bweight > 0
                params = {k: torch.where(real, new_params[k], p) for k, p in params.items()}
                opt_state = optim.tree_where(real, new_state, opt_state)
                stats = {k: torch.where(real, new_stats[k], s) for k, s in stats.items()}
                losses.append(loss)
                corrects.append(correct)
                valids.append(valid)
                bweights.append(bweight)
        losses, bweights = torch.stack(losses), torch.stack(bweights)
        new = {**stats, **params}
        delta = {k: new[k] - g for k, g in global_variables.items()}
        real_steps = bweights.sum()
        metrics = {
            "train_loss": (losses * bweights).sum() / torch.clamp(bweights.sum(), min=1.0),
            "train_correct": torch.stack(corrects).sum(),
            "train_valid": torch.stack(valids).sum(),
            "local_steps": real_steps,
        }
        weight = data["num_samples"].float()
        if cfg.use_scaffold:
            # c_i+ = c_i - c + (w_global - w_local) / (K lr), K = max(real steps, 1)
            inv = 1.0 / (torch.clamp(real_steps, min=1.0) * cfg.lr)
            new_c_local = {k: (c_local[k] - c_global[k]) + (global_params[k] - params[k]) * inv
                           for k in params}
            delta_c = {k: new_c_local[k] - c_local[k] for k in params}
            return ClientOutput({"delta": delta, "delta_c": delta_c}, weight, metrics,
                                (c_global, new_c_local))
        return ClientOutput(delta, weight, metrics, client_state)

    return local_update


def make_eval_fn(apply_fn: Callable) -> Callable:
    """Batched global eval: ``(params, x, y, mask) -> (loss_sum, correct,
    count)``; ``mask`` keeps the padded tail batch exact."""

    def eval_fn(params, x, y, mask):
        loss, correct, valid = _masked_loss_and_metrics(apply_fn(params, x), y, mask)
        return loss * valid, correct, valid

    return eval_fn
