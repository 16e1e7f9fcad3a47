"""Port vs JAX package: bfloat16 compute (``use_bf16``).

The bf16 3x3 conv's plain version and its gradients against
``conv2d_pallas`` on bf16 inputs (Pallas interpret mode), including the
weight gradient's single rounding to bf16; and the resnet8 (GroupNorm and
BatchNorm), ``lr`` and ``cnn_fedavg`` forwards under ``use_bf16``. Both
packages compute each op in float32 and round its result to bf16, but not
always at the same places (XLA fuses elementwise chains and rounds once at
their end; torch rounds after each op), so whole-model tolerances are bf16
ones, stated per test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

jax.config.update("jax_default_matmul_precision", "highest")

import fedml_tpu_torch  # noqa: E402
from fedml_tpu import models as jmodels  # noqa: E402
from fedml_tpu.ops.conv import conv2d_pallas  # noqa: E402
from fedml_tpu_torch import models as tmodels  # noqa: E402
from fedml_tpu_torch.ops import conv as C  # noqa: E402
from fedml_tpu_torch.utils.convert import (  # noqa: E402
    flatten_paths, variables_from_jax, variables_to_jax)

BF16_STEP = 2.0 ** -7  # the spacing of bf16 values relative to the lower power of two


@pytest.fixture()
def interp_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t.astype(jnp.float32))


def _within_one_step(got, want, mag, tol=1e-5):
    """Each element within one bf16 step of the other (at the larger value)
    plus ``tol`` of its float32 magnitude (sums in another order); returns
    the share of elements that differ at all."""
    step = BF16_STEP * np.maximum(np.abs(got), np.abs(want))
    assert np.all(np.abs(got - want) <= step + tol * mag), np.abs(got - want).max()
    return float(np.mean(got != want))


@pytest.mark.parametrize("B,H,W,ci,co", [(2, 8, 8, 16, 16), (2, 6, 7, 3, 16), (1, 4, 4, 32, 8)])
def test_bf16_conv3x3_and_grads_match_conv2d_pallas(interp_pallas, B, H, W, ci, co):
    """y, dx and dw of the bf16 conv against conv2d_pallas's custom_vjp on
    the same bf16 operands: both take float32 products of the bf16 values,
    sum them in float32 and round once to bf16 (dw after its sum over the
    batch, ``.astype(w.dtype)``), so they agree to one bf16 step and nearly
    always bit for bit."""
    rng = np.random.default_rng(B * 100 + ci)
    x = rng.standard_normal((B, H, W, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, ci, co)) * 0.3).astype(np.float32)
    g = rng.standard_normal((B, H, W, co)).astype(np.float32)
    jx, jw, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, w, g))
    jy, vjp = jax.vjp(lambda a, b: conv2d_pallas(a, b), jx, jw)
    jdx, jdw = vjp(jg)
    assert jy.dtype == jdx.dtype == jdw.dtype == jnp.bfloat16

    tx, tw = _bf16(x).requires_grad_(), _bf16(w).requires_grad_()
    ty = C.conv3x3(tx, tw)
    ty.backward(_bf16(g))
    assert ty.dtype == tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    xb, wb, gb = (_bf16(a).float().numpy() for a in (x, w, g))
    mag_y = C.conv3x3_plain(torch.from_numpy(np.abs(xb))[None],
                            torch.from_numpy(np.abs(wb))[None])[0].numpy()
    mag_dw = C.conv3x3_dw_plain(torch.from_numpy(np.abs(xb))[None],
                                torch.from_numpy(np.abs(gb))[None])[0].numpy()
    shares = [_within_one_step(_f32(ty.detach()), _f32(jy), mag_y),
              _within_one_step(_f32(tw.grad), _f32(jdw), mag_dw)]
    dx_mag = np.abs(_f32(jdx)).max()
    shares.append(_within_one_step(_f32(tx.grad), _f32(jdx), dx_mag))
    # float32 sums of at most 9 Ci (y, dx) or B H W (dw) products in another
    # order cross a bf16 rounding boundary rarely: measured 0 here
    assert max(shares) <= 0.02, shares


def test_bf16_conv3x3_plain_rounds_once():
    """The plain versions are the float32 results of the bf16 operands,
    rounded once to bf16; under vmap (per-lane weights) the same."""
    rng = np.random.default_rng(3)
    x = _bf16(rng.standard_normal((3, 2, 5, 5, 16)).astype(np.float32))
    w = _bf16(rng.standard_normal((3, 3, 3, 16, 16)).astype(np.float32) * 0.3)
    y = C.conv3x3_lanes(x, w)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, C.conv3x3_plain(x.float(), w.float()).to(torch.bfloat16))
    dw = C.conv3x3_dw_lanes(x, y)
    assert torch.equal(dw, C.conv3x3_dw_plain(x.float(), y.float()).to(torch.bfloat16))
    yv = vmap(C.conv3x3)(x, w)
    assert torch.equal(yv, y)

    def loss(wl, xl):
        return C.conv3x3(xl, wl).float().square().sum()

    gv = vmap(grad(loss))(w, x)
    assert gv.dtype == torch.bfloat16
    g0 = grad(loss)(w[0], x[0])
    assert torch.equal(gv[0], g0)
    with pytest.raises(ValueError, match="float32 or both bfloat16"):
        C.conv3x3_lanes(x, w.float())


class _Args:
    def __init__(self, model, dataset="cifar10", conv_impl="pallas", norm="group",
                 use_bf16=True):
        self.model, self.dataset, self.conv_impl = model, dataset, conv_impl
        self.norm, self.use_bf16 = norm, use_bf16


def _pair(name, in_shape, seed, **kw):
    jm = jmodels.create(_Args(name, **kw), 10)
    jv = jax.tree_util.tree_map(np.asarray, jmodels.init_params(
        jm, jax.random.PRNGKey(seed), jnp.zeros((1,) + in_shape)))
    tm = tmodels.create(_Args(name, **kw), 10, in_shape)
    return jm, jv, tm


@pytest.mark.parametrize("norm,conv_impl,train", [("group", "pallas", False),
                                                  ("batch", "pallas", True),
                                                  ("batch", "xla", False)])
def test_resnet8_bf16_forward_matches_jax(interp_pallas, norm, conv_impl, train):
    jm, jv, tm = _pair("resnet8", (32, 32, 3), 1, norm=norm, conv_impl=conv_impl)
    tv = variables_from_jax(jv)
    x = np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(np.float32)
    # the port computes in bf16: every conv, norm and dense layer takes and
    # gives bf16 activations (a float32 forward rounded at the end would
    # meet the logit tolerance below as well)
    seen = []

    def record(module, args, out):
        seen.append((type(module).__name__, args[0].dtype, out.dtype))

    layers = [m for m in tm.modules() if type(m).__name__ in ("Conv", "GroupNorm", "BatchNorm",
                                                              "Dense")]
    hooks = [m.register_forward_hook(record) for m in layers]
    jout = jm.apply(jax.tree_util.tree_map(jnp.asarray, variables_to_jax(tv)), jnp.asarray(x),
                    train=train, mutable=["batch_stats"] if train else False)
    tout = tmodels.apply(tm, tv, torch.from_numpy(x), train=train, mutable=train)
    for h in hooks:
        h.remove()
    assert len(seen) == len(layers) and {n for n, _, _ in seen} >= {"Conv", "Dense"}
    assert all(i == torch.bfloat16 and o == torch.bfloat16 for _, i, o in seen), seen
    if train:
        (jout, jstats), (tout, tstats) = jout, tout
        jflat = flatten_paths({"batch_stats": jax.tree_util.tree_map(
            np.asarray, jstats["batch_stats"])})
        assert list(tstats) == list(jflat)
        for k, want in jflat.items():
            # float32 statistics of bf16 activations that differ by a few
            # bf16 steps: measured 4.5e-4 of the leaf's largest value
            np.testing.assert_allclose(tstats[k].numpy(), want, rtol=0,
                                       atol=5e-3 * max(np.abs(want).max(), 1e-3), err_msg=k)
    assert tout.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    got, want = _f32(tout.detach()), _f32(jout)
    # eight layers, each rounding to bf16 (2^-8 relative) at places that
    # differ between XLA's fusions and torch's ops: measured up to 4.7e-3 of
    # the largest logit
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * np.abs(want).max())


@pytest.mark.parametrize("name", ["lr", "cnn_fedavg"])
def test_lr_cnn_bf16_forward_matches_jax(name):
    jm, jv, tm = _pair(name, (28, 28, 1), 2, dataset="mnist")
    tv = variables_from_jax(jv)
    x = np.random.default_rng(1).standard_normal((5, 28, 28, 1)).astype(np.float32)
    jout = jm.apply(jax.tree_util.tree_map(jnp.asarray, jv), jnp.asarray(x))
    tout = tmodels.apply(tm, tv, torch.from_numpy(x))
    assert tout.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    got, want = _f32(tout.detach()), _f32(jout)
    # lr: one bf16 product of 784 terms, then the bias in bf16 (measured
    # bit-equal); cnn_fedavg: two convs (torch adds the bias inside the
    # conv, XLA after it: one rounding fewer) and two dense layers, measured
    # 6e-5 of the largest logit
    tol = 2.0 ** -8 if name == "lr" else 2e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def test_bf16_simulator_runs_and_keeps_float32_params():
    """use_bf16 no longer raises: the parameters (and their gradients'
    updates) stay float32, the compute is bf16."""
    from fedml_tpu_torch.simulation import build_simulator

    cfg = dict(dataset="cifar10", model="resnet8", norm="batch", conv_impl="pallas",
               use_bf16=True, debug_small_data=True, client_num_in_total=4,
               client_num_per_round=2, comm_round=1, batch_size=16, frequency_of_the_test=1,
               device="cpu")
    sim, apply_fn = build_simulator(fedml_tpu_torch.init(config=cfg))
    hist = sim.run(apply_fn, log_fn=None)
    assert all(v.dtype == torch.float32 for v in sim.params.values())
    assert np.isfinite(hist[0]["train_loss"]) and np.isfinite(hist[0]["test_loss"])
