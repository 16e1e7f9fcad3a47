"""Synthetic stand-in datasets (numpy).

``make_classification_like`` is the port's copy of
``fedml_tpu/data/synthetic.py:83``: deterministic arrays shaped like MNIST /
CIFAR, byte-identical to the JAX package's for the same arguments, so both
packages train on the same data when the real files are absent.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .federated import ArrayPair


def make_classification_like(
    n_train: int,
    n_test: int,
    feat_shape: Tuple[int, ...],
    class_num: int,
    seed: int = 0,
    separation: float = 6.0,
) -> Tuple[ArrayPair, ArrayPair]:
    """Learnable deterministic synthetic data with class-dependent means.

    Classes are separable enough that accuracy curves are meaningful in tests
    without real downloads.
    """
    rng = np.random.default_rng(seed)
    dim = int(np.prod(feat_shape))
    centers = rng.normal(0, separation / np.sqrt(dim), (class_num, dim)).astype(np.float32)

    def gen(n, s):
        r = np.random.default_rng(s)
        y = r.integers(0, class_num, n).astype(np.int32)
        x = centers[y] + r.normal(0, 1, (n, dim)).astype(np.float32)
        return ArrayPair(x.reshape((n,) + feat_shape).astype(np.float32), y)

    return gen(n_train, seed + 1), gen(n_test, seed + 2)
