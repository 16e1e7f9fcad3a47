"""Federated optimizer registry (port of ``fedml_tpu/algorithms/__init__.py``
:53-265): FedAvg, FedAvg_robust (every defense), FedProx, FedOpt, FedNova
and SCAFFOLD, each a ``FedAlgorithm`` bundle of plain functions.

BatchNorm models (``has_batch_stats``, JAX :73-90): the running-statistics
deltas are plainly weighted-averaged, never fed through a server optimizer
or a defense. FedAvg and FedProx do that natively, FedOpt splits the
variables (its server optimizer on the ``params/...`` leaves, a plain add on
the ``batch_stats/...`` ones), and FedNova, FedAvg_robust and SCAFFOLD
refuse the combination."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..constants import (
    FEDML_FEDERATED_OPTIMIZER_FEDAVG,
    FEDML_FEDERATED_OPTIMIZER_FEDAVG_ROBUST,
    FEDML_FEDERATED_OPTIMIZER_FEDNOVA,
    FEDML_FEDERATED_OPTIMIZER_FEDOPT,
    FEDML_FEDERATED_OPTIMIZER_FEDPROX,
    FEDML_FEDERATED_OPTIMIZER_SCAFFOLD,
)
from ..core.algframe import ClientOutput, FedAlgorithm
from ..core.robust import RobustAggregator, add_gaussian_noise
from ..utils import optim
from .local_sgd import LocalTrainConfig, make_eval_fn, make_local_update

__all__ = ["LocalTrainConfig", "make_local_update", "make_eval_fn", "get_algorithm",
           "server_optimizer"]


def _add(params, delta):
    return {k: p + delta[k] for k, p in params.items()}


def _scale(tree, s):
    return {k: v * s for k, v in tree.items()}


def _zeros(params):
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _keep_state(params, agg, state):
    return _add(params, agg), state


def server_optimizer(name, lr: float, momentum: float) -> optim.Transform:
    """FedOpt's server optimizer by name, case- and None-tolerant
    (``algorithms/__init__.py:172-187``)."""
    sopt_name = str(name or "sgd").strip().lower()
    if sopt_name == "adam":
        return optim.adam(lr)
    if sopt_name == "yogi":
        return optim.yogi(lr)
    if sopt_name == "adagrad":
        return optim.adagrad(lr)
    if sopt_name in ("sgd", "", "none"):
        return optim.sgd(lr, momentum=momentum or None)
    raise ValueError(f"unknown server_optimizer '{name}' (sgd | adam | yogi | adagrad)")


def get_algorithm(
    name: str,
    apply_fn: Callable,
    cfg: LocalTrainConfig,
    needs_dropout: bool = False,
    has_batch_stats: bool = False,
    server_lr: float = 1.0,
    server_optimizer_name: str = "sgd",
    server_momentum: float = 0.9,
    client_fraction: float = 1.0,
    defense_type: Optional[str] = None,
    norm_bound: float = 5.0,
    stddev: float = 0.0,
    trim_ratio: float = 0.1,
    byzantine_n: int = 0,
    multi_krum_m: Optional[int] = None,
    dp_seed: int = 0,
) -> FedAlgorithm:
    """Build the named optimizer's bundle. Every server update applies the
    aggregated delta as ``w + delta`` but FedOpt's (a server optimizer on
    the pseudo-gradient ``-delta``), FedNova's (``w + tau_eff *
    mean(delta / tau)``) and SCAFFOLD's (``w + server_lr * delta``)."""
    name_l = name.lower()
    if has_batch_stats and name_l in (
        FEDML_FEDERATED_OPTIMIZER_FEDNOVA.lower(),
        FEDML_FEDERATED_OPTIMIZER_FEDAVG_ROBUST.lower(),
        FEDML_FEDERATED_OPTIMIZER_SCAFFOLD.lower(),
    ):
        raise ValueError(
            f"{name}: norm='batch' is unsupported (tau scaling / defenses / "
            "control variates would treat BatchNorm running stats as "
            "gradients); use norm='group', or FedAvg/FedProx/FedOpt")

    def local(cfg):
        return make_local_update(apply_fn, cfg, needs_dropout, has_batch_stats)

    if name_l == FEDML_FEDERATED_OPTIMIZER_FEDAVG_ROBUST.lower():
        ra = RobustAggregator(defense_type=defense_type or "norm_diff_clipping",
                              norm_bound=norm_bound, stddev=stddev, trim_ratio=trim_ratio,
                              byzantine_n=byzantine_n, multi_krum_m=multi_krum_m)
        local_update = local(cfg)
        if ra.defense_type != "weak_dp":
            return FedAlgorithm(name=name, local_update=local_update,
                                server_update=_keep_state, aggregate=ra.aggregate, robust=ra)
        # weak DP: the clip in aggregate, the noise in server_update from a
        # generator whose state the server state carries, fresh every round
        clip = RobustAggregator(defense_type="norm_diff_clipping", norm_bound=norm_bound)

        def init_server_state(params):
            dev = next(iter(params.values())).device
            return {"rng": torch.Generator(device=dev).manual_seed(int(dp_seed)).get_state()}

        def server_update(params, agg, state):
            gen = torch.Generator(device=next(iter(params.values())).device)
            gen.set_state(state["rng"].cpu())
            agg = add_gaussian_noise(agg, stddev, gen)
            return _add(params, agg), {"rng": gen.get_state()}

        return FedAlgorithm(name=name, local_update=local_update, server_update=server_update,
                            aggregate=clip.aggregate, robust=clip,
                            init_server_state=init_server_state)

    if name_l == FEDML_FEDERATED_OPTIMIZER_FEDPROX.lower():
        # mu defaults to 0.1 only when unset; an explicit 0.0 is honoured
        mu = 0.1 if cfg.prox_mu is None else cfg.prox_mu
        cfg = LocalTrainConfig(**{**cfg.__dict__, "prox_mu": mu})
        name_l = FEDML_FEDERATED_OPTIMIZER_FEDAVG.lower()
    if name_l == FEDML_FEDERATED_OPTIMIZER_SCAFFOLD.lower():
        cfg = LocalTrainConfig(**{**cfg.__dict__, "use_scaffold": True})
    local_update = local(cfg)

    if name_l == FEDML_FEDERATED_OPTIMIZER_FEDAVG.lower():
        return FedAlgorithm(name=name, local_update=local_update, server_update=_keep_state)

    if name_l == FEDML_FEDERATED_OPTIMIZER_FEDOPT.lower():
        sopt = server_optimizer(server_optimizer_name, server_lr, server_momentum)

        def _params(tree):
            # the server optimizer sees the params only; BatchNorm running
            # statistics are plainly averaged (adam or momentum on them
            # would corrupt them)
            if not has_batch_stats:
                return tree
            return {k: v for k, v in tree.items() if k.startswith("params/")}

        def init_server_state(params):
            return sopt.init(_params(params))

        def fedopt_update(params, agg, opt_state):
            p = _params(params)
            pseudo_grad = _scale(_params(agg), -1.0)
            updates, opt_state = sopt.update(pseudo_grad, opt_state, p)
            new_p = optim.apply_updates(p, updates)
            if not has_batch_stats:
                return new_p, opt_state
            return {k: new_p[k] if k in new_p else v + agg[k] for k, v in params.items()}, \
                opt_state

        return FedAlgorithm(name=name, local_update=local_update, server_update=fedopt_update,
                            init_server_state=init_server_state)

    if name_l == FEDML_FEDERATED_OPTIMIZER_FEDNOVA.lower():
        # clients ship tau-normalised deltas and tau; the server scales the
        # mean normalised delta by the mean tau (FedNova.average():171)
        def nova_local_update(params, client_state, data, rng=None):
            out = local_update(params, client_state, data, rng)
            tau = torch.clamp(out.metrics["local_steps"], min=1.0)
            upd = {"norm_delta": _scale(out.update, 1.0 / tau), "tau": tau}
            return ClientOutput(upd, out.weight, out.metrics, out.state)

        def nova_server_update(params, agg, state):
            return _add(params, _scale(agg["norm_delta"], agg["tau"])), state

        return FedAlgorithm(name=name, local_update=nova_local_update,
                            server_update=nova_server_update, update_is_params=False)

    if name_l == FEDML_FEDERATED_OPTIMIZER_SCAFFOLD.lower():
        def init_server_state(params):
            return {"c": _zeros(params)}

        def init_client_state(params):
            return (_zeros(params), _zeros(params))  # (c, c_i)

        def scaffold_server_update(params, agg, state):
            params = _add(params, _scale(agg["delta"], server_lr))
            return params, {"c": _add(state["c"], _scale(agg["delta_c"], client_fraction))}

        def prepare_client_state(server_state, client_state):
            return (server_state["c"], client_state[1])

        return FedAlgorithm(name=name, local_update=local_update,
                            server_update=scaffold_server_update,
                            init_server_state=init_server_state,
                            init_client_state=init_client_state,
                            prepare_client_state=prepare_client_state,
                            update_is_params=False)

    if name_l == "fednas":
        raise NotImplementedError(
            "federated optimizer 'FedNAS' (bilevel DARTS search) is not ported yet "
            "(ROADMAP.md Queue 1, item 14)")
    raise ValueError(f"unknown federated optimizer '{name}'")
