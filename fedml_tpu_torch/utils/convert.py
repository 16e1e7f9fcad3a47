"""Parameter transfer from the JAX package.

The port keeps parameters in flax layout under flax paths (HWIO conv
kernels, ``(in, out)`` dense kernels, keys like ``params/Conv_0/kernel``),
so a JAX variables tree transfers without any transpose: this is the glue
that lets a test start both packages from the same weights, and (with
:func:`state_from_jax` and :func:`arena_state_from_jax`) from the same
optimizer, server and client states. It takes numpy (or array-like) leaves
and never imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def flatten_paths(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> ``{"a/b/c": leaf}`` in ``jax.tree_util`` leaf order
    (keys sorted at every level)."""
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_paths(v, path))
        else:
            out[path] = v
    return out


def variables_from_jax(numpy_tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A JAX variables tree (``{"params": {...}}``, with a ``batch_stats``
    collection for BatchNorm models, numpy leaves) -> the port's flat,
    path-keyed float32 variables dict (on the CPU; the simulator moves it
    to its device)."""
    return {p: torch.from_numpy(np.array(v, np.float32))
            for p, v in flatten_paths(numpy_tree).items()}


def variables_to_jax(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`variables_from_jax`: the port's path-keyed
    variables -> a nested variables tree (``params`` and ``batch_stats``
    collections) with numpy leaves, which ``jax.tree_util`` maps to
    arrays."""
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v.detach().cpu().numpy()
    return tree


def _tensor(v) -> torch.Tensor:
    a = np.asarray(v)
    return torch.from_numpy(np.array(a, np.float32 if a.dtype.kind == "f" else a.dtype))


def state_from_jax(tree: Any) -> Any:
    """A state of the JAX package with numpy leaves -> the port's layout of
    the same state (``utils/optim.py``, ``algorithms/__init__.py``):

    - a variables tree (a dict of the ``params`` and, for BatchNorm
      models, ``batch_stats`` collections) -> the flat, path-keyed dict of
      :func:`variables_from_jax`;
    - an optax state (a NamedTuple: ``ScaleByAdamState`` of adam and yogi,
      ``TraceState``, ``ScaleByRssState``; ``EmptyState``) -> a dict of its
      fields, each converted;
    - a tuple (an optax chain's state, SCAFFOLD's ``(c, c_i)``) -> a tuple,
      a dict (SCAFFOLD's server ``{"c": ...}``) -> a dict, each converted;
    - an array -> a tensor (float32, or its integer dtype: adam's count).
    """
    if isinstance(tree, Mapping):
        if "params" in tree and set(tree) <= {"params", "batch_stats"}:
            return variables_from_jax(tree)
        return {k: state_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: state_from_jax(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, (tuple, list)):
        return tuple(state_from_jax(v) for v in tree)
    return _tensor(tree)


def arena_state_from_jax(export: Mapping[str, Any]) -> Dict[str, Any]:
    """``ClientStateArena.export_state()`` of the JAX package (numpy) -> the
    port arena's ``import_state`` input (CPU tensors). Both arenas key the
    leaves by their flat index in the proto's leaf order, which is the same
    for a proto of path-sorted dicts."""
    out = {"leaves": {i: _tensor(v) for i, v in export["leaves"].items()},
           "slot_client": torch.from_numpy(np.asarray(export["slot_client"], np.int64)),
           "last_used": torch.from_numpy(np.asarray(export["last_used"], np.int64)),
           "clock": torch.tensor(int(np.asarray(export["clock"])), dtype=torch.int64)}
    if export.get("spilled"):
        out["spilled"] = {cid: {i: _tensor(v) for i, v in rows.items()}
                          for cid, rows in export["spilled"].items()}
    return out
