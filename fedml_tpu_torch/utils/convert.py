"""Parameter transfer from the JAX package.

The port keeps parameters in flax layout under flax paths (HWIO conv
kernels, ``(in, out)`` dense kernels, keys like ``params/Conv_0/kernel``),
so a JAX variables tree transfers without any transpose: this is the glue
that lets a test start both packages from the same weights. It takes numpy
(or array-like) leaves and never imports JAX.
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
    """A JAX variables tree (``{"params": {...}}`` with numpy leaves) ->
    the port's flat, path-keyed float32 parameter dict (on the CPU; the
    simulator moves it to its device)."""
    return {p: torch.from_numpy(np.array(v, np.float32))
            for p, v in flatten_paths(numpy_tree).items()}
