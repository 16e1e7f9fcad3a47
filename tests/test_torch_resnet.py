"""Port vs JAX package: the CIFAR-10 ResNet slice.

Leaf paths and order of the ResNets, flax's initialisers (GroupNorm
``scale`` at one), forwards with ``conv_impl`` ``pallas`` (the JAX conv in
Pallas interpret mode) and ``xla``, a local update, the CIFAR-10 loader
(synthetic stand-in and the pickle reader) and the whole slice through both
packages' ``build_simulator`` from the same weights.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_default_matmul_precision", "highest")

import fedml_tpu  # noqa: E402
import fedml_tpu_torch  # noqa: E402
from fedml_tpu import models as jmodels  # noqa: E402
from fedml_tpu.algorithms.local_sgd import LocalTrainConfig as JCfg  # noqa: E402
from fedml_tpu.algorithms.local_sgd import make_local_update as jmake  # noqa: E402
from fedml_tpu.data import loaders as jloaders  # noqa: E402
from fedml_tpu.simulation import build_simulator as jbuild  # noqa: E402
from fedml_tpu_torch import models as tmodels  # noqa: E402
from fedml_tpu_torch.algorithms.local_sgd import LocalTrainConfig, make_local_update  # noqa: E402
from fedml_tpu_torch.data import loaders as tloaders  # noqa: E402
from fedml_tpu_torch.simulation import build_simulator as tbuild  # noqa: E402
from fedml_tpu_torch.utils.convert import flatten_paths, variables_from_jax  # noqa: E402


@pytest.fixture()
def interp_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


class _Args:
    dataset = "cifar10"

    def __init__(self, model, conv_impl="pallas", norm=None):
        self.model, self.conv_impl, self.norm = model, conv_impl, norm


def _pair(name, conv_impl="pallas", seed=0):
    jm = jmodels.create(_Args(name, conv_impl, "group"), 10)
    jv = jmodels.init_params(jm, jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3)))
    tm = tmodels.create(_Args(name, conv_impl), 10, (32, 32, 3))
    return jm, jax.tree_util.tree_map(np.asarray, jv), tm


def _perturbed(jv, seed):
    """JAX weights with GroupNorm scale/bias moved off 1/0, so the forward
    checks also hold the norms' affine parts."""
    rng = np.random.default_rng(seed)
    flat = {p: (v + rng.standard_normal(v.shape).astype(np.float32) * 0.2
                if p.endswith(("scale", "bias")) else v)
            for p, v in flatten_paths(jv).items()}
    return variables_from_jax(flat)


def test_resnet56_leaves_and_init_match_jax():
    # the JAX tree does not depend on conv_impl (test_mw_conv.py); its init
    # runs the xla conv, which needs no Pallas interpreter
    _, jv, _ = _pair("resnet56", "xla")
    tm = tmodels.create(_Args("resnet56", "pallas"), 10, (32, 32, 3))
    jflat = flatten_paths(jv)
    tv = tmodels.init_params(tm, torch.Generator().manual_seed(0))
    # 173 leaves in jax.tree_util order: BasicBlock_10 sorts before BasicBlock_2
    assert len(jflat) == 173 and list(tv) == list(jflat)
    assert list(tv).index("params/BasicBlock_10/Conv_0/kernel") < \
        list(tv).index("params/BasicBlock_2/Conv_0/kernel")
    assert sum(v.size for v in jflat.values()) == 855770
    for p, v in jflat.items():
        assert tuple(tv[p].shape) == v.shape, p
        if p.endswith("scale"):  # GroupNorm scale starts at one, as flax's
            assert torch.equal(tv[p], torch.ones(v.shape)) and (v == 1).all()
        elif p.endswith("bias"):
            assert not tv[p].any() and not v.any()
        else:  # LeCun-normal truncated at 2 std: the same spread as flax's
            std = float(np.std(v))
            assert abs(float(tv[p].std()) - std) < 0.25 * std, p


@pytest.mark.parametrize("name,conv_impl", [("resnet8", "pallas"), ("resnet20", "pallas"),
                                            ("resnet8", "xla"), ("resnet20", "xla")])
def test_forward_matches_jax(interp_pallas, name, conv_impl):
    jm, jv, tm = _pair(name, conv_impl, 1)
    tv = _perturbed(jv, 2)
    x = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(np.float32)
    jout = np.asarray(jm.apply({"params": jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()), _unflatten(tv))}, jnp.asarray(x)))
    tout = tmodels.apply(tm, tv, torch.from_numpy(x)).detach().numpy()
    # f32 convs and GroupNorm statistics summed in another order: measured
    # ~1e-6 of logits of O(1)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=2e-5 * max(1.0, np.abs(jout).max()))


def _unflatten(flat):
    tree = {}
    for p, v in flat.items():
        node = tree
        parts = p.split("/")[1:]
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return tree


def test_local_update_matches_jax(interp_pallas):
    """Two batches of resnet8 SGD with conv_impl pallas, the second batch
    partly padding."""
    jm, jv, tm = _pair("resnet8", "pallas", 3)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (2, 4)).astype(np.int32)
    mask = np.ones((2, 4), np.float32)
    mask[1, 2:] = 0.0
    jlu = jmake(lambda v, xx, train=False, rngs=None, mutable=False: jm.apply(v, xx),
                JCfg(lr=0.05, epochs=1))
    jout = jlu(jax.tree_util.tree_map(jnp.asarray, jv), (),
               {"x": jnp.asarray(x), "y": jnp.asarray(y), "mask": jnp.asarray(mask),
                "num_samples": jnp.int32(6)}, jax.random.PRNGKey(0))
    tlu = make_local_update(lambda p, xx: tmodels.apply(tm, p, xx), LocalTrainConfig(lr=0.05))
    tout = tlu(variables_from_jax(jv), (),
               {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                "mask": torch.from_numpy(mask), "num_samples": torch.tensor(6)}, None)
    # deltas after 2 SGD steps; f32 differences of ~1e-7 per step
    for p, v in flatten_paths(jax.tree_util.tree_map(np.asarray, jout.update)).items():
        np.testing.assert_allclose(tout.update[p].detach().numpy(), v, rtol=1e-4,
                                   atol=1e-5 * max(1e-3, np.abs(v).max()))
    for k in ("train_loss", "train_correct", "train_valid"):
        np.testing.assert_allclose(float(tout.metrics[k]), float(jout.metrics[k]), rtol=1e-5)


def test_cifar10_synthetic_arrays_byte_identical():
    jtr, jte = jloaders._load_cifar_arrays(None, "cifar10", 300, 70)
    ttr, tte = tloaders._load_cifar10_arrays(None, 300, 70)
    for j, t in ((jtr, ttr), (jte, tte)):
        assert t.x.shape[1:] == (32, 32, 3) and t.x.dtype == np.float32
        assert t.x.tobytes() == j.x.tobytes() and t.y.tobytes() == j.y.tobytes()
    np.random.seed(0)  # both partitions draw from numpy's global stream
    jfed = jloaders.load_partition_data("cifar10", None, "hetero", 0.5, 7, small=True)
    np.random.seed(0)
    tfed = tloaders.load_partition_data("cifar10", None, "hetero", 0.5, 7, small=True)
    assert {k: list(v) for k, v in tfed._global_index.items()} == \
        {k: list(v) for k, v in jfed._global_index.items()}
    assert tfed.class_num == 10


def test_cifar10_pickle_batches_read_as_jax_reads_them(tmp_path):
    root = tmp_path / "cifar-10-batches-py"
    root.mkdir()
    rng = np.random.default_rng(7)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        n = 3
        batch = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
                 b"labels": [int(v) for v in rng.integers(0, 10, n)]}
        with open(root / name, "wb") as f:
            pickle.dump(batch, f)
    jtr, jte = jloaders._load_cifar_arrays(str(tmp_path), "cifar10", 0, 0)
    ttr, tte = tloaders._load_cifar10_arrays(str(tmp_path), 0, 0)
    assert ttr.x.shape == (15, 32, 32, 3) and tte.x.shape == (3, 32, 32, 3)
    for j, t in ((jtr, ttr), (jte, tte)):
        assert t.x.tobytes() == j.x.tobytes() and t.y.tobytes() == j.y.tobytes()


def test_unported_cifar_variants_raise():
    for name in ("cifar100", "cinic10", "fed_cifar100"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tloaders.load_partition_data(name, None, "hetero", 0.5, 4, small=True)


SLICE = dict(dataset="cifar10", model="resnet8", conv_impl="pallas", cohort_schedule="even",
             debug_small_data=True, client_num_in_total=8, client_num_per_round=4,
             comm_round=2, learning_rate=0.05, batch_size=32, frequency_of_the_test=1,
             random_seed=0, epochs=1)


@pytest.mark.parametrize("cohort_schedule", ["even", "packed"])
def test_resnet_slice_matches_jax(interp_pallas, cohort_schedule):
    """A small cifar10 resnet8 FedAvg run (conv_impl pallas) under the even
    and the packed schedule through both packages' build_simulator from the
    same initial weights."""
    cfg = dict(SLICE, cohort_schedule=cohort_schedule)
    jsim, japply = jbuild(fedml_tpu.init(config=dict(cfg, prefetch=False)))
    init = jax.tree_util.tree_map(np.asarray, jsim.params)
    jhist = jsim.run(japply, log_fn=None)
    tsim, tapply = tbuild(fedml_tpu_torch.init(config=dict(cfg, device="cpu")),
                          variables=variables_from_jax(init))
    assert tsim.schedule == cohort_schedule
    thist = tsim.run(tapply, log_fn=None)
    assert len(thist) == len(jhist) == SLICE["comm_round"]
    for jr, tr in zip(jhist, thist):
        # f32 conv sums and GroupNorm statistics in another order differ by
        # ~1e-6 per step and grow through SGD: measured here up to 5e-5
        # relative after 2 rounds of 5 steps (even) and 4.6e-5 under packed
        # (rounds of 2 lanes x 8 slots, then 1 x 16); 5e-4 leaves a 10x margin
        for k in ("train_loss", "test_loss"):
            assert tr[k] == pytest.approx(jr[k], rel=5e-4), (k, jr, tr)
        assert abs(tr["train_acc"] - jr["train_acc"]) <= 1e-6
        assert abs(tr["test_acc"] - jr["test_acc"]) <= 1.0 / 200  # one of 200 test images


def test_unported_norm_and_bf16_raise():
    """sync_batch (BatchNorm statistics all-reduced over a device axis) is
    still unported; norm: batch and use_bf16 now build."""
    args = fedml_tpu_torch.init(config=dict(SLICE, comm_round=1, device="cpu",
                                            norm="sync_batch"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, item 10"):
        fedml_tpu_torch.run_simulation(args=args)
    for knob in (dict(norm="batch"), dict(use_bf16=True)):
        sim, _ = tbuild(fedml_tpu_torch.init(config=dict(SLICE, comm_round=1, device="cpu",
                                                         **knob)))
        assert sim.schedule == "even"
