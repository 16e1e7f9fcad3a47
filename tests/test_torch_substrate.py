"""Port vs JAX package: the host substrate is EXACTLY equal.

Partition maps, client sampling, per-client permutations, the index-only
cohort rectangles and the synthetic arrays are integer / numpy decisions:
fedml_tpu_torch must reproduce fedml_tpu's bit for bit.
"""

import json
import types

import numpy as np
import pytest

import fedml_tpu.data as jdata
import fedml_tpu_torch.data as tdata
from fedml_tpu.core import partition as jpart
from fedml_tpu.data import leaf as jleaf
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


def _write_leaf(root, with_json=True):
    """A tiny LEAF MNIST tree: train/ and test/ with two users of 784-float
    rows (the reference's json layout), or train/ without any json."""
    rng = np.random.default_rng(6)
    for split, n in (("train", 3), ("test", 2)):
        d = root / split
        d.mkdir(parents=True)
        if not with_json:
            (d / "README.txt").write_text("no json here")
            continue
        users = ["u0", "u1"]
        blob = {"users": users, "num_samples": [n, n], "user_data": {
            u: {"x": rng.random((n, 784)).round(3).tolist(),
                "y": rng.integers(0, 10, n).tolist()} for u in users}}
        (d / "a.json").write_text(json.dumps(blob))


def _mnist_args(cache_dir, **kw):
    return types.SimpleNamespace(dataset="mnist", data_cache_dir=str(cache_dir),
                                 partition_method="hetero", partition_alpha=0.5,
                                 client_num_in_total=10, client_num_per_round=10,
                                 debug_small_data=True, device="cpu", **kw)


@pytest.mark.parametrize("sub", ["", "MNIST"])
def test_mnist_leaf_json_dirs_raise_instead_of_diverging(tmp_path, sub):
    """Where the reference loads LEAF json dirs with their natural per-user
    partition, the port raises rather than building a Dirichlet federation
    of other data."""
    _write_leaf(tmp_path / sub if sub else tmp_path)
    found = jleaf.leaf_json_dirs(str(tmp_path))
    assert found is not None and found == tdata.loaders.leaf_json_dirs(str(tmp_path))
    fed, _ = jdata.load(_mnist_args(tmp_path))
    assert fed.client_num == 2  # what the reference builds from these files
    with pytest.raises(NotImplementedError, match="LEAF json partition"):
        tdata.load(_mnist_args(tmp_path))


def test_mnist_without_leaf_json_matches_the_reference_partition(tmp_path):
    """train/ and test/ without a json file: the reference does not load
    them, so the port does not raise and partitions the same synthetic
    stand-in as the reference."""
    _write_leaf(tmp_path, with_json=False)
    assert jleaf.leaf_json_dirs(str(tmp_path)) is None
    assert tdata.loaders.leaf_json_dirs(str(tmp_path)) is None
    feds = []
    for mod in (jdata, tdata):
        np.random.seed(11)
        feds.append(mod.load(_mnist_args(tmp_path))[0])
    (jf, tf) = feds
    assert jf.client_num == len(tf._global_index) == 10
    for c in range(10):
        np.testing.assert_array_equal(jf._global_index[c], tf._global_index[c])
    assert jf.train_data_global.x.tobytes() == tf.train_data_global.x.tobytes()
