"""Federated loaders (numpy), MNIST only in this slice.

The port's copy of the MNIST branch of ``fedml_tpu/data/loaders.py``
(``_read_idx:32``, ``_load_mnist_arrays:42``, ``load_partition_data:169``).
Real idx / npz files are read from ``data_cache_dir`` when present;
otherwise the full-cardinality synthetic stand-in (60,000 / 10,000) is
generated, byte-identical to the JAX package's. The other datasets of the
JAX loader (and MNIST's LEAF-json natural partition) are not ported yet.
"""

from __future__ import annotations

import gzip
import os
from typing import Optional

import numpy as np

from ..core.partition import homo_partition, non_iid_partition_with_dirichlet_distribution
from .federated import ArrayPair, FederatedData, build_federated_data
from .synthetic import make_classification_like

_SIZES = {"mnist": (60000, 10000)}  # (train, test) cardinalities


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    magic = int.from_bytes(data[0:4], "big")
    ndim = magic & 0xFF
    dims = [int.from_bytes(data[4 + 4 * i : 8 + 4 * i], "big") for i in range(ndim)]
    return np.frombuffer(data, dtype=np.uint8, offset=4 + 4 * ndim).reshape(dims)


def _load_mnist_arrays(cache_dir: Optional[str], n_train: int, n_test: int):
    if cache_dir:
        for suffix in ("", ".gz"):
            p = lambda name: os.path.join(cache_dir, name + suffix)  # noqa: E731
            if os.path.exists(p("train-images-idx3-ubyte")):
                tx = _read_idx(p("train-images-idx3-ubyte")).astype(np.float32) / 255.0
                ty = _read_idx(p("train-labels-idx1-ubyte")).astype(np.int32)
                vx = _read_idx(p("t10k-images-idx3-ubyte")).astype(np.float32) / 255.0
                vy = _read_idx(p("t10k-labels-idx1-ubyte")).astype(np.int32)
                return ArrayPair(tx[..., None], ty), ArrayPair(vx[..., None], vy)
        npz = os.path.join(cache_dir, "mnist.npz")
        if os.path.exists(npz):
            d = np.load(npz)
            return (
                ArrayPair(d["x_train"].astype(np.float32)[..., None] / 255.0, d["y_train"].astype(np.int32)),
                ArrayPair(d["x_test"].astype(np.float32)[..., None] / 255.0, d["y_test"].astype(np.int32)),
            )
    return make_classification_like(n_train, n_test, (28, 28, 1), 10, seed=10)


def load_partition_data(
    dataset: str,
    data_cache_dir: Optional[str],
    partition_method: str,
    partition_alpha: float,
    client_num: int,
    small: bool = False,
) -> FederatedData:
    """MNIST with a Dirichlet ("hetero") or IID partition. ``small`` shrinks
    the synthetic fallback 50x for tests. The partition draws from the
    process-global numpy stream, which ``init`` seeds, exactly as the JAX
    package does."""
    if dataset != "mnist":
        raise NotImplementedError(
            f"dataset '{dataset}' is not ported yet (ROADMAP.md Queue 1, "
            "item 2: host substrate); this slice loads mnist only")
    scale = 0.02 if small else 1.0
    n_tr, n_te = (int(s * scale) for s in _SIZES[dataset])
    train, test = _load_mnist_arrays(data_cache_dir, n_tr, n_te)
    class_num = 10
    if partition_method == "hetero":
        idx_map = non_iid_partition_with_dirichlet_distribution(
            train.y, client_num, class_num, partition_alpha)
    else:
        idx_map = homo_partition(len(train.x), client_num)
    return build_federated_data(train, test, idx_map, class_num)
