"""Federated optimizer registry (port of ``fedml_tpu/algorithms/__init__.py``
for ``FedAvg`` and ``FedAvg_robust``, :91-165)."""

from __future__ import annotations

from typing import Callable, Optional

from ..constants import (
    FEDML_FEDERATED_OPTIMIZER_FEDAVG,
    FEDML_FEDERATED_OPTIMIZER_FEDAVG_ROBUST,
)
from ..core.algframe import FedAlgorithm
from ..core.robust import RobustAggregator
from .local_sgd import LocalTrainConfig, make_eval_fn, make_local_update

__all__ = ["LocalTrainConfig", "make_local_update", "make_eval_fn", "get_algorithm"]


def _add(params, delta):
    return {k: p + delta[k] for k, p in params.items()}


def get_algorithm(
    name: str,
    apply_fn: Callable,
    cfg: LocalTrainConfig,
    defense_type: Optional[str] = None,
    byzantine_n: int = 0,
    multi_krum_m: Optional[int] = None,
) -> FedAlgorithm:
    """Build the named optimizer. Both ported optimizers apply the
    aggregated delta as ``w + delta``; ``FedAvg_robust`` aggregates through
    a :class:`RobustAggregator` (the JAX default defense,
    ``norm_diff_clipping``, is not ported, so the defense must be named)."""
    local_update = make_local_update(apply_fn, cfg)
    name_l = name.lower()
    if name_l == FEDML_FEDERATED_OPTIMIZER_FEDAVG_ROBUST.lower():
        ra = RobustAggregator(
            defense_type=defense_type or "norm_diff_clipping",
            byzantine_n=byzantine_n,
            multi_krum_m=multi_krum_m,
        )
        return FedAlgorithm(name=name, local_update=local_update,
                            server_update=_add, aggregate=ra.aggregate,
                            robust=ra)
    if name_l == FEDML_FEDERATED_OPTIMIZER_FEDAVG.lower():
        return FedAlgorithm(name=name, local_update=local_update,
                            server_update=_add)
    raise NotImplementedError(
        f"federated optimizer '{name}' is not ported yet (ROADMAP.md Queue 1, "
        "item 3); this slice has FedAvg and FedAvg_robust")
