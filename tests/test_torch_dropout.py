"""Port vs JAX package: ``CNNDropOut`` (``model: cnn``) and its dropout.

Eval forwards against the JAX module, exact to float32 rounding; a train
forward and its gradients against the JAX module fed the same keep masks
(flax's ``random.bernoulli`` replaced by the masks, in call order); the
masks' keep rate and flax's ``1 / keep`` scaling; and the simulator's
keying of the masks by (seed, round, client position, step): two runs
equal, and the even, bucketed and packed schedules in agreement at one
epoch, where their step indices coincide.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_default_matmul_precision", "highest")

import fedml_tpu_torch  # noqa: E402
from fedml_tpu import models as jmodels  # noqa: E402
from fedml_tpu_torch import models as tmodels  # noqa: E402
from fedml_tpu_torch.simulation import build_simulator  # noqa: E402
from fedml_tpu_torch.simulation.fed_sim import dropout_masks  # noqa: E402
from fedml_tpu_torch.utils.convert import flatten_paths, variables_from_jax  # noqa: E402


class _Args:
    def __init__(self, dataset="mnist", use_bf16=False):
        self.model, self.dataset, self.use_bf16 = "cnn", dataset, use_bf16


def _pair(dataset="mnist", seed=0, in_shape=(28, 28, 1), out=62):
    jm = jmodels.create(_Args(dataset), out)
    jv = jax.tree_util.tree_map(np.asarray, jmodels.init_params(
        jm, jax.random.PRNGKey(seed), jnp.zeros((1,) + in_shape)))
    tm = tmodels.create(_Args(dataset), out, in_shape)
    return jm, jv, tm


@pytest.mark.parametrize("dataset,classes", [("mnist", 10), ("femnist", 62)])
def test_cnn_dropout_leaves_and_eval_match_jax(dataset, classes):
    jm, jv, tm = _pair(dataset, 1)
    tv = variables_from_jax(jv)
    assert list(tmodels.init_params(tm, torch.Generator())) == list(flatten_paths(jv))
    assert tuple(tv["params/Dense_1/kernel"].shape) == (128, classes)
    x = np.random.default_rng(0).standard_normal((6, 28, 28, 1)).astype(np.float32)
    jout = np.asarray(jm.apply(jax.tree_util.tree_map(jnp.asarray, jv), jnp.asarray(x)))
    tout = tmodels.apply(tm, tv, torch.from_numpy(x)).detach().numpy()
    # float32 convs and products summed in another order
    np.testing.assert_allclose(tout, jout, rtol=0, atol=1e-5 * max(1.0, np.abs(jout).max()))


def _masks(tm, batch, seed):
    return tmodels.draw_dropout_masks(tmodels.dropout_layers(tm), batch,
                                      torch.Generator().manual_seed(seed))


def test_cnn_dropout_train_with_injected_masks_matches_jax(monkeypatch):
    """The same keep masks through both: JAX's Dropout draws them from
    ``random.bernoulli``, replaced here by the port's masks in call order."""
    import flax.linen.stochastic as stochastic

    jm, jv, tm = _pair("mnist", 2)
    tv = variables_from_jax(jv)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 5)
    masks = _masks(tm, 5, 4)
    assert [tuple(m.shape) for m in masks] == [(5, 12, 12, 64), (5, 128)]
    queue = [jnp.asarray(m.numpy()) for m in masks]

    def bernoulli(key, p, shape):
        m = queue.pop(0)
        assert m.shape == tuple(shape)
        return m

    monkeypatch.setattr(stochastic, "random", types.SimpleNamespace(bernoulli=bernoulli))

    def jloss(params):
        out = jm.apply({"params": params}, jnp.asarray(x), train=True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        logz = jax.nn.log_softmax(out)
        return -jnp.take_along_axis(logz, jnp.asarray(y)[:, None], 1).mean(), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jv["params"]))
    assert not queue  # both masks consumed, in order

    tp = {k: v.clone().requires_grad_() for k, v in tv.items()}
    tout = tmodels.apply(tm, tp, torch.from_numpy(x), train=True, dropout=masks)
    tl = torch.nn.functional.cross_entropy(tout, torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jout)).max())
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    for p, v in flatten_paths({"params": jax.tree_util.tree_map(np.asarray, jg)}).items():
        np.testing.assert_allclose(tp[p].grad.numpy(), v, rtol=1e-4,
                                   atol=1e-5 * max(1e-3, np.abs(v).max()), err_msg=p)
    # training needs masks; without train the Dropouts are identities
    with pytest.raises(ValueError, match="keep masks"):
        tmodels.apply(tm, tv, torch.from_numpy(x), train=True)
    assert torch.equal(tmodels.apply(tm, tv, torch.from_numpy(x), dropout=masks),
                       tmodels.apply(tm, tv, torch.from_numpy(x)))


def test_dropout_keep_rate_and_scaling():
    """keep = uniform < 1 - rate, as jax.random.bernoulli; a kept element
    is x / (1 - rate), a dropped one 0."""
    _, _, tm = _pair()
    m0, m1 = _masks(tm, 2000, 5)
    for m, rate in ((m0, 0.25), (m1, 0.5)):
        n = m.numel()
        keep = m.float().mean().item()
        assert abs(keep - (1 - rate)) < 4 * np.sqrt(rate * (1 - rate) / n), (rate, keep)
    x = torch.randn(2000, 128)
    ctx = tmodels.ApplyContext(True, [m0, m1])
    out = tm.Dropout_1(x, ctx)
    assert torch.equal(out[m1], x[m1] / 0.5) and not out[~m1].any()
    # the same generator state draws the same masks
    assert all(torch.equal(a, b) for a, b in zip(_masks(tm, 2000, 5), (m0, m1)))


CNN = dict(dataset="mnist", model="cnn", debug_small_data=True, client_num_in_total=20,
           client_num_per_round=4, comm_round=2, learning_rate=0.05, batch_size=10,
           frequency_of_the_test=1, random_seed=0, epochs=1, device="cpu")


def _run(**extra):
    sim, apply_fn = build_simulator(fedml_tpu_torch.init(config=dict(CNN, **extra)))
    return sim, sim.run(apply_fn, log_fn=None)


def test_cnn_dropout_simulator_repeats_and_schedules_agree():
    """Two runs of one config are bit-equal; at one epoch the even, packed
    and bucketed schedules feed each client step the same masks (keyed by
    the client's cohort position and its step). Bucketed aggregates in the
    even schedule's order and agrees to float32 rounding; packed sums its
    lanes' flushes in another order, which round 0 shows at ~4e-7 and round
    1 amplifies through training to 2.7e-4 (measured; from the same
    parameters its round 1 agrees to 3e-7)."""
    runs = {s: _run(cohort_schedule=s) for s in ("even", "packed", "bucketed")}
    sim2, hist2 = _run(cohort_schedule="even")
    sim, hist = runs["even"]
    assert [r["train_loss"] for r in hist] == [r["train_loss"] for r in hist2]
    assert all(torch.equal(v, sim2.params[k]) for k, v in sim.params.items())
    for s, rels in (("bucketed", (1e-6, 1e-6)), ("packed", (1e-5, 2e-3))):
        assert runs[s][0].schedule == s
        for a, b, rel in zip(hist, runs[s][1], rels):
            assert b["train_loss"] == pytest.approx(a["train_loss"], rel=rel), s
            assert b["test_loss"] == pytest.approx(a["test_loss"], rel=rel), s


def test_dropout_masks_keyed_by_position_and_step():
    """A client's masks depend on (seed, round, position, step) only: a
    cohort rectangle of two clients draws, for the second, what a rectangle
    holding that client alone at the same position draws; steps without a
    real row keep nothing; another round draws other masks."""
    layers = [((3, 4), 0.25), ((5,), 0.5)]
    mask = np.ones((2, 3, 4), np.float32)
    mask[1, 2] = 0.0
    pos = np.array([0, 7], np.uint32)
    both = dropout_masks(0, 3, pos, mask, 2, layers, "cpu")
    alone = dropout_masks(0, 3, pos[1:], mask[1:], 2, layers, "cpu")
    assert [tuple(m.shape) for m in both] == [(2, 6, 4, 3, 4), (2, 6, 4, 5)]
    for a, b in zip(both, alone):
        assert torch.equal(a[1], b[0])
        assert not a[1, 2].any() and not a[1, 5].any()  # padded batch, both epochs
    other = dropout_masks(0, 4, pos, mask, 2, layers, "cpu")
    assert not torch.equal(other[0], both[0])
