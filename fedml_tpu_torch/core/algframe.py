"""Algorithm frame (port of ``fedml_tpu/core/algframe.py``): a federated
optimizer as a bundle of plain functions on path-keyed tensor dicts."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

Tree = Dict[str, torch.Tensor]


class ClientOutput(NamedTuple):
    """One client's local result: the update (a params-shaped delta), its
    aggregation weight (the sample count) and a small dict of scalars.
    Under the cohort ``vmap`` every field gains a leading client axis."""

    update: Tree
    weight: torch.Tensor
    metrics: Dict[str, torch.Tensor]


def weighted_mean(stacked_updates: Tree, weights: torch.Tensor) -> Tree:
    """Sample-weighted mean over the leading client axis, accumulated in
    f32 and cast back to each leaf's dtype (``algframe.py:87``)."""
    w = weights.float()
    total = torch.clamp(w.sum(), min=1.0)
    return {k: torch.tensordot(w / total, u.float(), dims=([0], [0])).to(u.dtype)
            for k, u in stacked_updates.items()}


@dataclasses.dataclass(frozen=True)
class FedAlgorithm:
    """``local_update(params, data) -> ClientOutput`` for one client;
    ``aggregate(stacked, weights)`` (None = :func:`weighted_mean`);
    ``server_update(params, agg) -> params``. ``robust`` is the
    RobustAggregator behind ``aggregate`` when there is one, so the
    simulator can fuse the sanitizer with a Krum defense."""

    name: str
    local_update: Callable[..., ClientOutput]
    server_update: Callable[[Tree, Tree], Tree]
    aggregate: Optional[Callable[[Tree, torch.Tensor], Tree]] = None
    robust: Optional[Any] = None
