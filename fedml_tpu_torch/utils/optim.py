"""Optimizer arithmetic: the port's own copy of the optax transforms the JAX
package uses (optax 0.2.6), as plain functions over path-keyed tensor
dicts.

A transform is a pair ``init(params) -> state`` and ``update(updates,
state, params) -> (updates, state)``; a state is a dict of tensors (or of
path-keyed dicts), and a chain's state is the tuple of its members'
states, as optax's. Every expression follows optax's, operand order
included, so float32 results agree to the rounding of the elementwise
library routines. The transforms are per-leaf tensor arithmetic with no
in-place op, so they run unchanged under ``torch.func.vmap`` (one client
of a cohort, one lane of the packed schedule).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

Tree = Dict[str, torch.Tensor]


class Transform(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Tuple[Tree, Any]]


def _map(fn, *trees: Tree) -> Tree:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


def tree_where(cond: torch.Tensor, new, old):
    """``where(cond, new, old)`` over two states (or trees) of one structure."""
    return pytree.tree_map(lambda n, o: torch.where(cond, n, o), new, old)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``optax.apply_updates``: ``p + u`` in each parameter's dtype."""
    return _map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree: Tree) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum over leaves of their squares."""
    return torch.sqrt(sum(torch.sum(x * x) for x in tree.values()))


def identity() -> Transform:
    return Transform(lambda params: {}, lambda updates, state, params=None: (updates, state))


def scale(step_size: float) -> Transform:
    """``optax.scale``: ``g * step_size``."""
    return Transform(lambda params: {},
                     lambda updates, state, params=None:
                     (_map(lambda g: g * step_size, updates), state))


def trace(decay: float) -> Transform:
    """``optax.trace`` (no Nesterov): ``t = g + decay * t``, update ``t``."""

    def update(updates, state, params=None):
        new = _map(lambda g, t: g + decay * t, updates, state["trace"])
        return new, {"trace": new}

    return Transform(lambda params: {"trace": _map(torch.zeros_like, params)}, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    """``optax.add_decayed_weights``: ``g + wd * p`` (coupled decay)."""

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the parameters")
        return _map(lambda g, p: g + weight_decay * p, updates, params), state

    return Transform(lambda params: {}, update)


def clip_by_global_norm(max_norm: float) -> Transform:
    """``optax.clip_by_global_norm``: every leaf scaled by ``max_norm /
    norm`` when the global norm reaches ``max_norm``."""

    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        return _map(lambda t: torch.where(trigger, t, (t / g_norm.to(t.dtype)) * max_norm),
                    updates), state

    return Transform(lambda params: {}, update)


def _count0(params: Tree) -> torch.Tensor:
    leaf = next(iter(params.values()))
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def _bias_correction(moment: Tree, decay: float, count: torch.Tensor) -> Tree:
    """``t / (1 - decay ** count)``, the power in float32."""
    bc = 1 - torch.pow(torch.tensor(decay, dtype=torch.float32, device=count.device),
                       count.to(torch.float32))
    return _map(lambda t: t / bc.to(t.dtype), moment)


def _adam_like(b1: float, b2: float, eps: float, eps_root: float, init_value: float,
               nu_update: Callable) -> Transform:
    def init(params):
        full = (torch.zeros_like if init_value == 0.0
                else lambda p: torch.full_like(p, init_value))
        return {"count": _count0(params), "mu": _map(full, params), "nu": _map(full, params)}

    def update(updates, state, params=None):
        mu = _map(lambda g, t: (1 - b1) * g + b1 * t, updates, state["mu"])
        nu = _map(nu_update, updates, state["nu"])
        count = state["count"] + 1
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        out = _map(lambda m, v: m / (torch.sqrt(v + eps_root) + eps), mu_hat, nu_hat)
        return out, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> Transform:
    """``optax.scale_by_adam``: moments from zero, int32 count incremented
    before the bias correction, ``mu_hat / (sqrt(nu_hat + eps_root) + eps)``."""
    return _adam_like(b1, b2, eps, eps_root, 0.0,
                      lambda g, t: (1 - b2) * (g * g) + b2 * t)


def scale_by_yogi(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3,
                  eps_root: float = 0.0, initial_accumulator_value: float = 1e-6) -> Transform:
    """``optax.scale_by_yogi``: both moments start at 1e-6, ``nu - (1 - b2)
    sign(nu - g^2) g^2``, bias-corrected, eps outside the sqrt."""
    return _adam_like(b1, b2, eps, eps_root, initial_accumulator_value,
                      lambda g, v: v - (1 - b2) * torch.sign(v - g * g) * (g * g))


def scale_by_rss(initial_accumulator_value: float = 0.1, eps: float = 1e-7) -> Transform:
    """``optax.scale_by_rss`` (adagrad): ``s += g^2``, update
    ``where(s > 0, rsqrt(s + eps), 0) * g``."""

    def init(params):
        return {"sum_of_squares": _map(lambda p: torch.full_like(p, initial_accumulator_value),
                                       params)}

    def update(updates, state, params=None):
        sos = _map(lambda g, t: g * g + t, updates, state["sum_of_squares"])
        inv = _map(lambda t: torch.where(t > 0, torch.rsqrt(t + eps), 0.0), sos)
        return _map(lambda i, g: i * g, inv, updates), {"sum_of_squares": sos}

    return Transform(init, update)


def chain(*transforms: Transform) -> Transform:
    """``optax.chain``: the members in order; the state is their tuple."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return Transform(init, update)


def sgd(learning_rate: float, momentum: Optional[float] = None) -> Transform:
    """``optax.sgd``: no trace at all without momentum."""
    return chain(trace(momentum) if momentum is not None else identity(),
                 scale(-1 * learning_rate))


def adam(learning_rate: float) -> Transform:
    return chain(scale_by_adam(), scale(-1 * learning_rate))


def yogi(learning_rate: float) -> Transform:
    return chain(scale_by_yogi(), scale(-1 * learning_rate))


def adagrad(learning_rate: float) -> Transform:
    return chain(scale_by_rss(), scale(-1 * learning_rate))


__all__ = ["Transform", "apply_updates", "tree_where", "global_norm", "identity", "scale",
           "trace", "add_decayed_weights", "clip_by_global_norm", "scale_by_adam",
           "scale_by_yogi", "scale_by_rss", "chain", "sgd", "adam", "yogi", "adagrad"]
