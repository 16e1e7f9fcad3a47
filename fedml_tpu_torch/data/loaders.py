"""Federated loaders (numpy): MNIST and CIFAR-10.

The port's copy of the MNIST and CIFAR-10 branches of
``fedml_tpu/data/loaders.py`` (``_read_idx:32``, ``_load_mnist_arrays:42``,
``_load_cifar_arrays:62``, ``load_partition_data:169``). Real files are read
from ``data_cache_dir`` when present (idx / npz for MNIST, the dataset's
extracted pickle batches ``cifar-10-batches-py/`` for CIFAR-10); otherwise
the full-cardinality synthetic stand-in (60,000 / 10,000 of 28x28x1;
50,000 / 10,000 of 32x32x3) is generated, byte-identical to the JAX
package's. The other datasets of the JAX loader, and MNIST's LEAF-json
natural partition, are not ported yet: where the JAX loader would read LEAF
json dirs (``leaf_json_dirs``), this one raises instead of partitioning
other data.
"""

from __future__ import annotations

import gzip
import os
import pickle
from typing import Optional, Tuple

import numpy as np

from ..core.partition import homo_partition, non_iid_partition_with_dirichlet_distribution
from .federated import ArrayPair, FederatedData, build_federated_data
from .synthetic import make_classification_like

_SIZES = {"mnist": (60000, 10000), "cifar10": (50000, 10000)}  # (train, test)


def leaf_json_dirs(cache_dir: Optional[str]) -> Optional[Tuple[str, str]]:
    """The port's copy of ``fedml_tpu/data/leaf.py::leaf_json_dirs``: LEAF
    ``train``/``test`` dirs under ``cache_dir`` or ``cache_dir/MNIST`` (where
    the reference MNIST zip extracts), ``train`` holding a ``.json`` file."""
    if not cache_dir:
        return None
    for base in (cache_dir, os.path.join(cache_dir, "MNIST")):
        tr, te = os.path.join(base, "train"), os.path.join(base, "test")
        if os.path.isdir(tr) and os.path.isdir(te):
            if any(f.endswith(".json") for f in os.listdir(tr)):
                return tr, te
    return None


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


def _load_cifar10_arrays(cache_dir: Optional[str], n_train: int, n_test: int):
    """The CIFAR-10 pickle batches under ``cache_dir/cifar-10-batches-py``
    (the dataset's own distribution format, read as the JAX package reads
    it), scaled to [0, 1] NHWC float32; else the synthetic stand-in."""
    root = os.path.join(cache_dir, "cifar-10-batches-py") if cache_dir else None
    if root and os.path.exists(os.path.join(root, "data_batch_1")):
        xs, ys = [], []
        for i in range(1, 6):
            with open(os.path.join(root, f"data_batch_{i}"), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        with open(os.path.join(root, "test_batch"), "rb") as f:
            d = pickle.load(f, encoding="bytes")

        def to_img(a):
            return a.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.float32) / 255.0

        return (ArrayPair(to_img(np.concatenate(xs)), np.asarray(ys, np.int32)),
                ArrayPair(to_img(d[b"data"]), np.asarray(d[b"labels"], np.int32)))
    return make_classification_like(n_train, n_test, (32, 32, 3), 10, seed=32)


def load_partition_data(
    dataset: str,
    data_cache_dir: Optional[str],
    partition_method: str,
    partition_alpha: float,
    client_num: int,
    small: bool = False,
) -> FederatedData:
    """MNIST or CIFAR-10 with a Dirichlet ("hetero") or IID partition.
    ``small`` shrinks the synthetic fallback 50x for tests. The partition
    draws from the process-global numpy stream, which ``init`` seeds,
    exactly as the JAX package does."""
    if dataset not in _SIZES:
        raise NotImplementedError(
            f"dataset '{dataset}' is not ported yet (ROADMAP.md Queue 1, "
            "item 2: host substrate); the port loads mnist and cifar10")
    if dataset == "mnist" and leaf_json_dirs(data_cache_dir):
        # the JAX loader would take these files' natural per-user partition
        raise NotImplementedError(
            f"mnist under data_cache_dir={data_cache_dir!r}: the LEAF json partition "
            "is not ported yet (ROADMAP.md Queue 1, item 2)")
    scale = 0.02 if small else 1.0
    n_tr, n_te = (int(s * scale) for s in _SIZES[dataset])
    load_arrays = _load_mnist_arrays if dataset == "mnist" else _load_cifar10_arrays
    train, test = load_arrays(data_cache_dir, n_tr, n_te)
    class_num = 10
    if partition_method == "hetero":
        idx_map = non_iid_partition_with_dirichlet_distribution(
            train.y, client_num, class_num, partition_alpha)
    else:
        idx_map = homo_partition(len(train.x), client_num)
    return build_federated_data(train, test, idx_map, class_num)
