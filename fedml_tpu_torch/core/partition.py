"""Non-IID data partitioning (Dirichlet / LDA) + homogeneous split.

Semantics parity with reference ``core/data/noniid_partition.py``
(``non_iid_partition_with_dirichlet_distribution:6``,
``partition_class_samples_with_dirichlet_distribution:87``): same seeded
numpy draws, same min-10-samples retry loop, same proportion-balancing rule,
so that with equal seeds the client->indices map matches the reference and
accuracy curves are comparable round-for-round. A numpy copy of
``fedml_tpu/core/partition.py``: the maps are identical between the two
packages.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def non_iid_partition_with_dirichlet_distribution(
    label_list: np.ndarray,
    client_num: int,
    classes: int,
    alpha: float,
    task: str = "classification",
) -> Dict[int, List[int]]:
    """Partition sample indices across clients by per-class Dirichlet draws.

    Reference: noniid_partition.py:6-84. Retries until every client has >= 10
    samples (min_size loop), then shuffles each client's indices.
    """
    net_dataidx_map: Dict[int, List[int]] = {}
    K = classes
    N = len(label_list)
    # reference parity: retry until every client holds >= 10 samples
    # (noniid_partition.py:14). When the dataset itself cannot give every
    # client 10 (N // client_num < 10, e.g. tiny test fixtures), that loop
    # would spin forever — degrade the target to what is feasible. A retry
    # CAP guards the statistically-unreachable case (many clients, few
    # samples, low alpha: each draw leaves someone near-empty), falling
    # back to deterministic rebalancing — the reference would spin.
    target = min(10, max(1, N // client_num))
    max_retries = 500
    attempts = 0
    min_size = 0
    while min_size < target:
        attempts += 1
        if attempts > max_retries:
            _rebalance_to_min(idx_batch, target)
            break
        idx_batch: List[List[int]] = [[] for _ in range(client_num)]
        if task == "segmentation":
            # label_list here is (classes, samples) of per-class presence
            for k in range(K):
                idx_k = np.asarray(
                    [np.any(label_list[i] == k) for i in range(len(label_list))]
                ).nonzero()[0]
                idx_batch, min_size = partition_class_samples_with_dirichlet_distribution(
                    N, alpha, client_num, idx_batch, idx_k
                )
        else:
            for k in range(K):
                idx_k = np.where(label_list == k)[0]
                idx_batch, min_size = partition_class_samples_with_dirichlet_distribution(
                    N, alpha, client_num, idx_batch, idx_k
                )
    for i in range(client_num):
        np.random.shuffle(idx_batch[i])
        net_dataidx_map[i] = idx_batch[i]
    return net_dataidx_map


def _rebalance_to_min(idx_batch: List[List[int]], target: int) -> None:
    """Deterministically move samples from the largest clients to those
    below ``target`` until everyone meets it (retry-cap fallback)."""
    while True:
        sizes = [len(b) for b in idx_batch]
        lo = int(np.argmin(sizes))
        hi = int(np.argmax(sizes))
        if sizes[lo] >= target or sizes[hi] <= max(target, 1):
            return
        idx_batch[lo].append(idx_batch[hi].pop())


def partition_class_samples_with_dirichlet_distribution(
    N: int,
    alpha: float,
    client_num: int,
    idx_batch: List[List[int]],
    idx_k: np.ndarray,
):
    """One class's samples split by a Dirichlet(alpha) draw.

    Reference: noniid_partition.py:87-124 — including the balancing rule that
    zeroes proportions for clients already holding >= N/client_num samples.
    """
    np.random.shuffle(idx_k)
    proportions = np.random.dirichlet(np.repeat(alpha, client_num))
    proportions = np.array(
        [p * (len(idx_j) < N / client_num) for p, idx_j in zip(proportions, idx_batch)]
    )
    proportions = proportions / proportions.sum()
    proportions = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
    idx_batch = [
        idx_j + idx.tolist() for idx_j, idx in zip(idx_batch, np.split(idx_k, proportions))
    ]
    min_size = min([len(idx_j) for idx_j in idx_batch])
    return idx_batch, min_size


def homo_partition(n_samples: int, client_num: int) -> Dict[int, List[int]]:
    """IID partition: shuffled equal split (reference data loaders' ``homo``)."""
    idxs = np.random.permutation(n_samples)
    batch_idxs = np.array_split(idxs, client_num)
    return {i: batch_idxs[i].tolist() for i in range(client_num)}


def record_net_data_stats(label_list: np.ndarray, net_dataidx_map: Dict[int, List[int]]):
    """Per-client class histogram (reference noniid_partition.py tail helper)."""
    net_cls_counts = {}
    for net_i, dataidx in net_dataidx_map.items():
        unq, unq_cnt = np.unique(label_list[dataidx], return_counts=True)
        net_cls_counts[net_i] = {int(u): int(c) for u, c in zip(unq, unq_cnt)}
    return net_cls_counts
