"""Algorithm frame (port of ``fedml_tpu/core/algframe.py``): a federated
optimizer as a bundle of plain functions on path-keyed tensor dicts."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

Tree = Dict[str, torch.Tensor]


class ClientOutput(NamedTuple):
    """One client's local result: the update (a params-shaped delta, or an
    algorithm's own structure such as FedNova's ``{norm_delta, tau}``),
    its aggregation weight (the sample count), a small dict of scalars and
    the client's persistent state (SCAFFOLD's control variates; ``()``
    for stateless algorithms). Under the cohort ``vmap`` every field gains
    a leading client axis."""

    update: Any
    weight: torch.Tensor
    metrics: Dict[str, torch.Tensor]
    state: Any = ()


def weighted_mean(stacked_updates, weights: torch.Tensor):
    """Sample-weighted mean over the leading client axis of every leaf of
    ``stacked_updates`` (any nesting of dicts and tuples), accumulated in
    f32 and cast back to each leaf's dtype (``algframe.py:87``)."""
    w = weights.float()
    total = torch.clamp(w.sum(), min=1.0)
    return pytree.tree_map(
        lambda u: torch.tensordot(w / total, u.float(), dims=([0], [0])).to(u.dtype),
        stacked_updates)


def has_leaves(tree) -> bool:
    """True when ``tree`` holds at least one tensor (``()`` and ``{}`` do not)."""
    return bool(pytree.tree_leaves(tree))


def _no_state(params):
    return ()


@dataclasses.dataclass(frozen=True)
class FedAlgorithm:
    """``local_update(params, client_state, data, rng) -> ClientOutput`` for
    one client; ``aggregate(stacked, weights)`` (None = :func:`weighted_mean`);
    ``server_update(params, agg, server_state) -> (params, server_state)``.
    ``init_server_state(params)`` and ``init_client_state(params)`` build
    the states (``()`` when there is none); ``prepare_client_state(
    server_state, client_state)`` runs on each client's state before its
    local update (SCAFFOLD's broadcast of the server control variate).
    ``update_is_params`` is False when the update is not params-shaped
    (FedNova, SCAFFOLD): such updates take the even schedule and no codec.
    ``robust`` is the RobustAggregator behind ``aggregate`` when there is
    one, so the simulator can fuse the sanitizer with a Krum defense."""

    name: str
    local_update: Callable[..., ClientOutput]
    server_update: Callable[..., tuple]
    aggregate: Optional[Callable[[Tree, torch.Tensor], Tree]] = None
    robust: Optional[Any] = None
    init_server_state: Callable[[Tree], Any] = _no_state
    init_client_state: Callable[[Tree], Any] = _no_state
    prepare_client_state: Optional[Callable[[Any, Any], Any]] = None
    update_is_params: bool = True
