"""Port vs JAX package: lr and cnn_fedavg forwards and one local update,
from the same weights (carried over by ``variables_from_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_default_matmul_precision", "highest")

from fedml_tpu import models as jmodels  # noqa: E402
from fedml_tpu.algorithms.local_sgd import LocalTrainConfig as JCfg  # noqa: E402
from fedml_tpu.algorithms.local_sgd import make_local_update as jmake  # noqa: E402
from fedml_tpu_torch import models as tmodels  # noqa: E402
from fedml_tpu_torch.algorithms.local_sgd import LocalTrainConfig, make_local_update  # noqa: E402
from fedml_tpu_torch.utils.convert import flatten_paths, variables_from_jax  # noqa: E402


class _Args:
    dataset = "mnist"

    def __init__(self, model):
        self.model = model


def _pair(name, seed=0):
    jm = jmodels.create(_Args(name), 10)
    jv = jmodels.init_params(jm, jax.random.PRNGKey(seed), jnp.zeros((1, 28, 28, 1)))
    tm = tmodels.create(_Args(name), 10, (28, 28, 1))
    return jm, jax.tree_util.tree_map(np.asarray, jv), tm


@pytest.mark.parametrize("name", ["lr", "cnn_fedavg"])
def test_param_paths_shapes_and_init_match(name):
    _, jv, tm = _pair(name)
    tv = tmodels.init_params(tm, torch.Generator().manual_seed(0))
    jflat = flatten_paths(jv)
    # same flax paths, same leaf order, same (flax) layouts
    assert list(tv) == list(jflat)
    for p, v in jflat.items():
        assert tuple(tv[p].shape) == v.shape
        if p.endswith("bias"):
            assert not tv[p].any()
        else:  # LeCun-normal truncated at 2 std: same spread as flax's
            std = float(np.std(v))
            assert abs(float(tv[p].std()) - std) < 0.15 * std + 1e-3


@pytest.mark.parametrize("name", ["lr", "cnn_fedavg"])
def test_forward_matches_jax(name):
    jm, jv, tm = _pair(name, 1)
    x = np.random.default_rng(0).standard_normal((6, 28, 28, 1)).astype(np.float32)
    jout = np.asarray(jm.apply(jv, jnp.asarray(x)))
    tout = tmodels.apply(tm, variables_from_jax(jv), torch.from_numpy(x))
    # f32 convolutions/matmuls in another summation order
    np.testing.assert_allclose(tout.detach().numpy(), jout, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["lr", "cnn_fedavg"])
def test_local_update_matches_jax(name):
    """Two epochs over three batches, the last one all padding (a no-op)."""
    jm, jv, tm = _pair(name, 2)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 4, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (3, 4)).astype(np.int32)
    mask = np.ones((3, 4), np.float32)
    mask[1, 3] = 0.0
    mask[2] = 0.0
    jlu = jmake(lambda v, xx, train=False, rngs=None, mutable=False: jm.apply(v, xx),
                JCfg(lr=0.05, epochs=2))
    jout = jlu(jax.tree_util.tree_map(jnp.asarray, jv), (),
               {"x": jnp.asarray(x), "y": jnp.asarray(y), "mask": jnp.asarray(mask),
                "num_samples": jnp.int32(7)}, jax.random.PRNGKey(0))
    tlu = make_local_update(lambda p, xx: tmodels.apply(tm, p, xx),
                            LocalTrainConfig(lr=0.05, epochs=2))
    tout = tlu(variables_from_jax(jv), (),
               {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                "mask": torch.from_numpy(mask), "num_samples": torch.tensor(7)}, None)
    # deltas after 4 real SGD steps: f32 differences of ~1e-7 per step
    for p, v in flatten_paths(jax.tree_util.tree_map(np.asarray, jout.update)).items():
        np.testing.assert_allclose(tout.update[p].detach().numpy(), v, rtol=1e-4, atol=1e-6)
    assert float(tout.weight) == 7.0
    for k in ("train_loss", "train_correct", "train_valid"):
        np.testing.assert_allclose(float(tout.metrics[k]), float(jout.metrics[k]), rtol=1e-5)


def test_unported_models_and_optimizers_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodels.create(_Args("resnet18_gn"), 10, (32, 32, 3))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodels.create(_Args("efficientnet-b0"), 10, (32, 32, 3))
    resnet_sync = _Args("resnet56")
    resnet_sync.norm = "sync_batch"  # needs a device axis to all-reduce over
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmodels.create(resnet_sync, 10, (32, 32, 3))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LocalTrainConfig(loss_kind="mse")  # momentum, decay and adam are ported
