"""Port vs JAX package: the host substrate is EXACTLY equal.

Partition maps, client sampling, per-client permutations, the index-only
cohort rectangles and the synthetic arrays are integer / numpy decisions:
fedml_tpu_torch must reproduce fedml_tpu's bit for bit.
"""

import numpy as np
import pytest

from fedml_tpu.core import partition as jpart
from fedml_tpu.data import federated as jfed
from fedml_tpu.data import synthetic as jsyn
from fedml_tpu.simulation import sampling as jsamp
from fedml_tpu_torch.core import partition as tpart
from fedml_tpu_torch.data import federated as tfed
from fedml_tpu_torch.data import synthetic as tsyn
from fedml_tpu_torch.simulation import sampling as tsamp


def test_synthetic_arrays_byte_identical():
    a = jsyn.make_classification_like(300, 50, (28, 28, 1), 10, seed=10)
    b = tsyn.make_classification_like(300, 50, (28, 28, 1), 10, seed=10)
    for pa, pb in zip(a, b):
        assert pa.x.tobytes() == pb.x.tobytes() and pa.x.dtype == pb.x.dtype
        assert pa.y.tobytes() == pb.y.tobytes() and pa.y.dtype == pb.y.dtype


@pytest.mark.parametrize("method", ["hetero", "homo"])
def test_partition_maps_identical(method):
    labels = np.random.default_rng(3).integers(0, 10, 2000)
    maps = []
    for mod in (jpart, tpart):
        np.random.seed(7)
        if method == "hetero":
            maps.append(mod.non_iid_partition_with_dirichlet_distribution(labels, 40, 10, 0.5))
        else:
            maps.append(mod.homo_partition(len(labels), 40))
    assert maps[0].keys() == maps[1].keys()
    for c in maps[0]:
        assert list(maps[0][c]) == list(maps[1][c])


@pytest.mark.parametrize("total,per_round", [(1000, 10), (10, 10), (50, 7)])
def test_sample_clients_identical(total, per_round):
    for r in range(4):
        np.testing.assert_array_equal(jsamp.sample_clients(5, r, total, per_round),
                                      tsamp.sample_clients(5, r, total, per_round))


def test_client_permutations_identical():
    cids = np.array([3, 999, 17, 0, 512])
    sizes = np.array([9, 140, 1, 60, 33])
    np.testing.assert_array_equal(jsamp.client_permutations(2, 4, cids, sizes),
                                  tsamp.client_permutations(2, 4, cids, sizes))
    for a, b in zip(jsamp.client_permutation_list(2, 4, cids, sizes),
                    tsamp.client_permutation_list(2, 4, cids, sizes)):
        np.testing.assert_array_equal(a, b)
    # the port's vectorised PCG64 stream is the numpy Generator's stream
    bg = tsamp._VecPCG64(tsamp._seedseq_state64(tsamp._seedseq_pool(
        tsamp._entropy_words(2, 4, cids))))
    ref = [np.random.default_rng([2, 4, int(c)]).bit_generator.random_raw() for c in cids]
    np.testing.assert_array_equal(bg.next64(slice(None)), np.asarray(ref, np.uint64))


def test_pack_client_index_identical():
    train = jfed.ArrayPair(np.zeros((500, 2), np.float32), np.zeros(500, np.int32))
    np.random.seed(1)
    idx_map = jpart.non_iid_partition_with_dirichlet_distribution(
        np.random.default_rng(0).integers(0, 10, 500), 20, 10, 0.5)
    jd = jfed.build_federated_data(train, train, idx_map, 10)
    td = tfed.build_federated_data(tfed.ArrayPair(train.x, train.y),
                                   tfed.ArrayPair(train.x, train.y), idx_map, 10)
    cids = jsamp.sample_clients(0, 3, 20, 6)
    sizes = [len(idx_map[int(c)]) for c in cids]
    perms = jsamp.client_permutation_list(0, 3, cids, sizes)
    a = jd.pack_client_index(cids, 8, 6, perms=perms)
    b = td.pack_client_index(cids, 8, 6, perms=perms)
    for fa, fb in zip(a, b):
        assert fa.dtype == fb.dtype
        np.testing.assert_array_equal(fa, fb)
