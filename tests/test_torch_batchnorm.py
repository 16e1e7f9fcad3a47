"""Port vs JAX package: BatchNorm and its ``batch_stats`` threading.

``models.norm.BatchNorm`` against ``flax.linen.BatchNorm`` (train and eval,
float32 and bfloat16, outputs and updated statistics), resnet8 with
``norm: batch`` (leaves, train and eval forwards), the BN local update
against ``_make_bn_local_update`` (two epochs, a partial and a fully padded
batch), FedOpt's split server update, the auto schedule, the refusals, and
the variables' round trip with ``batch_stats``. The simulator-scale cases
have files of their own, so that ``--dist loadfile`` spreads them over the
workers: the 2-round FedAvg history under the even and bucketed schedules
(``test_torch_batchnorm_slice.py``) and the checkpoint's resume
(``test_torch_batchnorm_resume.py``).
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_default_matmul_precision", "highest")

import fedml_tpu  # noqa: E402
import fedml_tpu_torch  # noqa: E402
from fedml_tpu import models as jmodels  # noqa: E402
from fedml_tpu.algorithms import get_algorithm as jget  # noqa: E402
from fedml_tpu.algorithms.local_sgd import LocalTrainConfig as JCfg  # noqa: E402
from fedml_tpu.algorithms.local_sgd import make_local_update as jmake  # noqa: E402
from fedml_tpu.simulation import build_simulator as jbuild  # noqa: E402
from fedml_tpu_torch import models as tmodels  # noqa: E402
from fedml_tpu_torch.algorithms import get_algorithm as tget  # noqa: E402
from fedml_tpu_torch.algorithms.local_sgd import LocalTrainConfig, make_local_update  # noqa: E402
from fedml_tpu_torch.models.norm import BatchNorm  # noqa: E402
from fedml_tpu_torch.simulation import build_simulator as tbuild  # noqa: E402
from fedml_tpu_torch.utils.convert import (  # noqa: E402
    flatten_paths, state_from_jax, variables_from_jax, variables_to_jax)


class _Args:
    dataset = "cifar10"

    def __init__(self, model, conv_impl="xla", norm="batch", use_bf16=False):
        self.model, self.conv_impl, self.norm, self.use_bf16 = model, conv_impl, norm, use_bf16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jnp(flat):
    return jax.tree_util.tree_map(jnp.asarray, variables_to_jax(flat))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_flax(dtype, train):
    """Outputs and advanced running statistics of one call, from perturbed
    scale, bias, mean and var, on an input with a large common offset (fast
    variance's weak spot)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 5, 6, 16)) * 2.0 + 3.0).astype(np.float32)
    leaves = {"scale": 1 + 0.2 * rng.standard_normal(16), "bias": 0.2 * rng.standard_normal(16),
              "mean": 0.5 * rng.standard_normal(16), "var": 1 + rng.random(16)}
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jbn = fnn.BatchNorm(use_running_average=not train, momentum=0.9, dtype=jdt)
    jvars = {"params": {"scale": leaves["scale"], "bias": leaves["bias"]},
             "batch_stats": {"mean": leaves["mean"], "var": leaves["var"]}}
    jx = jnp.asarray(x).astype(jdt)
    jout, jnew = jbn.apply(jvars, jx, mutable=["batch_stats"])
    tvars = {"params/bias": leaves["bias"], "params/scale": leaves["scale"],
             "batch_stats/mean": leaves["mean"], "batch_stats/var": leaves["var"]}
    tvars = {k: torch.from_numpy(v) for k, v in tvars.items()}
    tout, tnew = tmodels.apply(BatchNorm(16, dtype=tdt), tvars,
                               torch.from_numpy(x).to(tdt), train=train, mutable=True)
    assert tout.dtype == tdt and str(jout.dtype) == dtype
    got, want = tout.float().numpy(), np.asarray(jout.astype(jnp.float32))
    if dtype == "float32":
        # statistics summed in another order; the fast variance E[x^2] -
        # E[x]^2 at mean 3 and variance 4 cancels ~2 bits: measured 4.8e-6
        # on outputs of O(1)
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    else:
        # the same float32 value rounded once to bf16: at most one bf16
        # step (2^-8 relative), and nearly always the same bits
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
        assert np.mean(got != want) < 0.01
    for leaf in ("mean", "var"):
        # float32 statistics whatever the compute dtype, taken from the
        # bf16-rounded input: exact up to the reduction order
        np.testing.assert_allclose(tnew[f"batch_stats/{leaf}"].numpy(),
                                   np.asarray(jnew["batch_stats"][leaf]), rtol=2e-6, atol=1e-6)
        if not train:
            assert torch.equal(tnew[f"batch_stats/{leaf}"], tvars[f"batch_stats/{leaf}"])


def _pair(name="resnet8", conv_impl="xla", seed=0, **kw):
    jm = jmodels.create(_Args(name, conv_impl, **kw), 10)
    jv = _np(jmodels.init_params(jm, jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3))))
    tm = tmodels.create(_Args(name, conv_impl, **kw), 10, (32, 32, 3))
    return jm, jv, tm


def _perturbed(jv, seed):
    """JAX variables with BN scale/bias and running statistics moved off
    their initial values."""
    rng = np.random.default_rng(seed)
    out = {}
    for p, v in flatten_paths(jv).items():
        if p.endswith(("scale", "bias", "mean")):
            v = v + rng.standard_normal(v.shape).astype(np.float32) * 0.2
        elif p.endswith("var"):
            v = v + rng.random(v.shape).astype(np.float32)
        out[p] = v
    return variables_from_jax(variables_to_jax({k: torch.from_numpy(np.array(v))
                                                for k, v in out.items()}))


def test_resnet56_batchnorm_leaves_and_init_match_jax():
    _, jv, tm = _pair("resnet56")
    jflat = flatten_paths(jv)
    tv = tmodels.init_params(tm, torch.Generator().manual_seed(0))
    # params and batch_stats, in jax.tree_util order: batch_stats first
    assert list(tv) == list(jflat)
    assert list(tv)[0].startswith("batch_stats/") and list(tv)[-1].startswith("params/")
    stats = [p for p in tv if p.startswith("batch_stats/")]
    assert len(stats) == 2 * 57 and len(jflat) == 173 + len(stats)
    for p, v in jflat.items():
        assert tuple(tv[p].shape) == v.shape, p
        if p.endswith(("mean", "bias")):
            assert not tv[p].any() and not v.any()
        elif p.endswith(("var", "scale")):
            assert (tv[p] == 1).all() and (v == 1).all()


@pytest.mark.parametrize("train", [True, False])
def test_resnet8_batchnorm_forward_matches_jax(train):
    jm, jv, tm = _pair("resnet8", seed=1)
    tv = _perturbed(jv, 2)
    x = np.random.default_rng(0).standard_normal((3, 32, 32, 3)).astype(np.float32)
    jout, jnew = jm.apply(_jnp(tv), jnp.asarray(x), train=train, mutable=["batch_stats"])
    tout, tnew = tmodels.apply(tm, tv, torch.from_numpy(x), train=train, mutable=True)
    # f32 convs and statistics summed in another order, normalised 7 times
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=0,
                               atol=5e-5 * max(1.0, np.abs(np.asarray(jout)).max()))
    jstats = flatten_paths({"batch_stats": _np(jnew["batch_stats"])})
    assert list(tnew) == list(jstats)
    for p, v in jstats.items():
        np.testing.assert_allclose(tnew[p].numpy(), v, rtol=5e-5, atol=5e-5, err_msg=p)
        if not train:
            assert torch.equal(tnew[p], tv[p])


def _data(seed, nb=3, bs=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nb, bs, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (nb, bs)).astype(np.int32)
    mask = np.ones((nb, bs), np.float32)
    mask[1:2, 2:] = 0.0   # a partial last batch
    mask[2:] = 0.0        # and a fully padded one: a no-op for params and stats
    return x, y, mask


def _jax_apply(jm):
    def apply_fn(v, xx, train=False, rngs=None, mutable=False):
        return jm.apply(v, xx, train=train, rngs=rngs, mutable=mutable)
    return apply_fn


@pytest.mark.parametrize("opt", [dict(), dict(momentum=0.9, weight_decay=5e-4, prox_mu=0.1)])
def test_bn_local_update_matches_jax(opt):
    """Two epochs over three batches (one partial, one fully padded) of
    resnet8 with BatchNorm: the delta of both collections, the metrics."""
    jm, jv, tm = _pair("resnet8", seed=3)
    tv = _perturbed(jv, 4)
    x, y, mask = _data(5)
    jlu = jmake(_jax_apply(jm), JCfg(lr=0.05, epochs=2, **opt), has_batch_stats=True)
    jout = jlu(_jnp(tv), (), {"x": jnp.asarray(x), "y": jnp.asarray(y),
                               "mask": jnp.asarray(mask), "num_samples": jnp.int32(6)},
               jax.random.PRNGKey(0))
    tlu = make_local_update(functools.partial(tmodels.apply, tm),
                            LocalTrainConfig(lr=0.05, epochs=2, **opt), has_batch_stats=True)
    tout = tlu(tv, (), {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                        "mask": torch.from_numpy(mask), "num_samples": torch.tensor(6)})
    jdelta = flatten_paths(_np(jout.update))
    assert list(tout.update) == list(jdelta)
    for p, v in jdelta.items():
        # 4 real SGD steps: f32 differences of ~1e-7 per step, amplified by
        # the normalisations
        np.testing.assert_allclose(tout.update[p].detach().numpy(), v, rtol=1e-3,
                                   atol=2e-5 * max(1e-2, np.abs(v).max()), err_msg=p)
    assert float(tout.metrics["local_steps"]) == float(jout.metrics["local_steps"]) == 4.0
    for k in ("train_loss", "train_correct", "train_valid"):
        np.testing.assert_allclose(float(tout.metrics[k]), float(jout.metrics[k]), rtol=1e-5)


def test_bn_padded_batch_leaves_stats_unchanged():
    """A client whose only batch is padding: params, optimizer state and
    running statistics stay the global ones (the delta is exactly zero)."""
    _, jv, tm = _pair("resnet8", seed=6)
    tv = _perturbed(jv, 7)
    x, y, mask = _data(8, nb=1)
    lu = make_local_update(functools.partial(tmodels.apply, tm),
                           LocalTrainConfig(lr=0.1, momentum=0.9), has_batch_stats=True)
    out = lu(tv, (), {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                      "mask": torch.zeros(1, 4), "num_samples": torch.tensor(0)})
    assert all(not d.any() for d in out.update.values())
    out = lu(tv, (), {"x": torch.from_numpy(x), "y": torch.from_numpy(y),
                      "mask": torch.ones(1, 4), "num_samples": torch.tensor(4)})
    assert all(out.update[k].any() for k in tv if k.startswith("batch_stats/"))


def test_fedopt_split_server_update_matches_jax():
    """FedOpt with BatchNorm: adam on the params (its moments cover only
    them), the statistics' delta added plainly."""
    _, jv, _ = _pair("resnet8", seed=9)
    tv = _perturbed(jv, 10)
    rng = np.random.default_rng(11)
    agg = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32) * 0.01)
           for k, v in tv.items()}
    kw = dict(server_lr=0.01, server_optimizer="adam")
    jalg = jget("FedOpt", None, JCfg(), has_batch_stats=True, **kw)
    talg = tget("FedOpt", None, LocalTrainConfig(), has_batch_stats=True,
                server_lr=0.01, server_optimizer_name="adam")
    jp, js = _jnp(tv), jalg.init_server_state(_jnp(tv))
    tp, ts = tv, talg.init_server_state(tv)
    assert set(ts[0]["mu"]) == {k for k in tv if k.startswith("params/")}
    for _ in range(2):
        jp, js = jalg.server_update(jp, _jnp(agg), js)
        tp, ts = talg.server_update(tp, agg, ts)
    jflat = flatten_paths(_np(jp))
    assert list(tp) == list(jflat)
    for p, v in jflat.items():
        np.testing.assert_allclose(tp[p].numpy(), v, rtol=1e-6, atol=1e-7, err_msg=p)
        if p.startswith("batch_stats/"):
            np.testing.assert_allclose(tp[p].numpy(), (tv[p] + 2 * agg[p]).numpy(), rtol=1e-6)
    jadam = _np(js[0])
    assert int(ts[0]["count"]) == int(jadam.count) == 2
    for k in ("mu", "nu"):
        jflat = flatten_paths({"params": getattr(jadam, k)})
        assert list(ts[0][k]) == list(jflat)
        for p, v in jflat.items():
            np.testing.assert_allclose(ts[0][k][p].numpy(), v, rtol=1e-5, atol=1e-12)


SLICE = dict(dataset="cifar10", model="resnet8", norm="batch", conv_impl="xla",
             debug_small_data=True, client_num_in_total=8, client_num_per_round=4,
             comm_round=2, learning_rate=0.05, batch_size=32, frequency_of_the_test=1,
             random_seed=0, epochs=1)


def jsim_schedule(jsim):
    return "packed" if jsim._packed else "bucketed" if jsim._bucketed else "even"


def test_bn_auto_schedule_follows_jax_rule():
    """auto never packs a BatchNorm model: a skewed population goes to
    bucketed (fed_sim.py:547, :566-570), as in the JAX package; an explicit
    packed raises in both."""
    cfg = dict(SLICE, client_num_in_total=6, client_num_per_round=6, partition_alpha=0.1,
               comm_round=1, cohort_schedule="auto")
    jsim, _ = jbuild(fedml_tpu.init(config=dict(cfg, prefetch=False)))
    tsim, _ = tbuild(fedml_tpu_torch.init(config=dict(cfg, device="cpu")))
    assert tsim.schedule == jsim_schedule(jsim)
    gn, _ = tbuild(fedml_tpu_torch.init(config=dict(cfg, norm="group", device="cpu")))
    counts = np.asarray(list(tsim._batch_counts.values()))
    if counts.max() >= 2 * max(np.median(counts), 1):
        assert tsim.schedule == "bucketed" and gn.schedule == "packed"
    for pkg, build, extra in ((fedml_tpu, jbuild, dict(prefetch=False)),
                              (fedml_tpu_torch, tbuild, dict(device="cpu"))):
        with pytest.raises(ValueError, match="BatchNorm"):
            build(pkg.init(config=dict(cfg, cohort_schedule="packed", **extra)))


@pytest.mark.parametrize("knob", [dict(federated_optimizer="FedNova"),
                                  dict(federated_optimizer="FedAvg_robust"),
                                  dict(federated_optimizer="SCAFFOLD"),
                                  dict(dp_l2_clip=1.0)])
def test_bn_refusals_match_jax(knob):
    cfg = dict(SLICE, comm_round=1, **knob)
    with pytest.raises(ValueError) as jerr:
        jbuild(fedml_tpu.init(config=dict(cfg, prefetch=False)))
    with pytest.raises(ValueError) as terr:
        tbuild(fedml_tpu_torch.init(config=dict(cfg, device="cpu")))
    assert str(terr.value) == str(jerr.value)


def test_batch_stats_convert_round_trip():
    _, jv, _ = _pair("resnet8", seed=12)
    flat = variables_from_jax(jv)
    assert any(k.startswith("batch_stats/") for k in flat)
    back = variables_to_jax(flat)
    assert set(back) == {"params", "batch_stats"}
    for p, v in flatten_paths(jv).items():
        np.testing.assert_array_equal(flatten_paths(back)[p], v)
    assert list(state_from_jax(jv)) == list(flat)
