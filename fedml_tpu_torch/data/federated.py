"""Federated dataset container + the index-only cohort packing (numpy).

The port's copy of ``fedml_tpu/data/federated.py`` (``FederatedData:63``,
``pack_client_index:93``, ``build_federated_data:218``), cut to what the
device-resident round uses. The training set
lives on the device as one global array pair; a round ships only the
cohort's ``(C, NB, BS)`` index rectangle and mask, and the simulator gathers
x/y on the device (``simulation.fed_sim._gather_from_device``). The index
rectangles are identical to the JAX package's for the same inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Sequence

import numpy as np


class ArrayPair(NamedTuple):
    x: np.ndarray
    y: np.ndarray

    def __len__(self) -> int:
        return len(self.x)


class ClientIndexBatches(NamedTuple):
    """Index-only cohort rectangle for the device-resident data path.

    idx (C, NB, BS) int32 rows into the *global* train arrays (0 for padding),
    mask (C, NB, BS) float32 {0,1}, num_samples (C,) int32.
    """

    idx: np.ndarray
    mask: np.ndarray
    num_samples: np.ndarray


@dataclasses.dataclass
class FederatedData:
    """Global train/test arrays plus each client's rows into the train set
    (the parts of the JAX container the round uses)."""

    train_data_global: ArrayPair
    test_data_global: ArrayPair
    class_num: int
    # client -> indices into train_data_global
    _global_index: Dict[int, np.ndarray]

    def pack_client_index(
        self,
        client_ids: Sequence[int],
        batch_size: int,
        num_batches: int,
        perms: Sequence[np.ndarray],
    ) -> ClientIndexBatches:
        """Index rectangle of a cohort: each client's rows into the global
        train arrays in the order of its permutation (``perms``, one per
        client), padded to ``num_batches * batch_size`` with index 0 and
        mask 0."""
        idx_lists = [self._global_index[c] for c in client_ids]
        sizes = np.asarray([len(ix) for ix in idx_lists], dtype=np.int32)
        cap = num_batches * batch_size
        C = len(idx_lists)
        ns = np.minimum(sizes, cap).astype(np.int64)
        valid = np.arange(cap, dtype=np.int64)[None, :] < ns[:, None]
        takes = [ix[np.asarray(p)[:n]] for ix, p, n in zip(idx_lists, perms, ns)]
        idx = np.zeros((C, cap), dtype=np.int32)
        if C:
            idx[valid] = np.concatenate(takes)
        shape = (C, num_batches, batch_size)
        return ClientIndexBatches(
            idx=idx.reshape(shape),
            mask=valid.astype(np.float32).reshape(shape),
            num_samples=ns.astype(np.int32),
        )


def build_federated_data(
    train: ArrayPair,
    test: ArrayPair,
    net_dataidx_map: Dict[int, List[int]],
    class_num: int,
) -> FederatedData:
    """Assemble the container from global arrays + a client->indices map."""
    return FederatedData(
        train_data_global=train,
        test_data_global=test,
        class_num=class_num,
        _global_index={
            c: np.asarray(idx, np.int64) for c, idx in net_dataidx_map.items()
        },
    )
