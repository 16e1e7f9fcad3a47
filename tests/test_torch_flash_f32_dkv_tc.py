"""The arithmetic of the float32 Dh-256 flash dk/dv and the float32 Dh-128
flash forward on the tensor cores (``fedml_tpu_torch/csrc/flash_f32_sm90.cu``),
emulated on the CPU.

The CUDA kernels run only on the card. Here their arithmetic is written out
in float32 torch, tile by tile, as the kernels order it, with
``tests/test_torch_flash_f32_tc.py``'s three-TF32 products (each operand
split into hi and lo where it is loaded; lo hi, hi lo and hi hi summed
smallest first):

- dk/dv: blocks of 64 key rows, k and v resident; per 16-row q/dO tile,
  S = K Q^T and dP = V dO^T over all 256 columns, p = exp(scale S - lse)
  (0 where causal masks a key past the query, and past T), dS = p (dP -
  delta); P^T dO and dS^T Q from a zero accumulator per q tile, added to
  dv and (times scale) to dk in float32;
- the forward at Dh 128: the Dh-256 forward's tiles (64 q rows, 32-key
  tiles, the online softmax per key tile, P V from zero per key tile).

The tensor core's own order inside one product is not reproduced: each of
the three products is one float32 matrix product here. Held against float64
at (1, 1024, 2, Dh), against the JAX package's ``flash_attention`` (its
Pallas kernels in interpret mode, dk and dv through ``jax.vjp``) at (1, 256,
2, Dh), and against its dense attention at a ragged T, within the
tolerances ``tests/test_torch_flash_dh256.py`` holds the plain versions to.
Planted faults (the hi hi product alone; one q tile dropped from dk/dv, one
key tile from the forward) fail the same limits. The kernels themselves are
held to the plain versions on the card by ``chip_smoke.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax.config.update("jax_default_matmul_precision", "highest")

from fedml_tpu.ops import attention as jatt  # noqa: E402
from fedml_tpu_torch.ops import attention as tatt  # noqa: E402
from fedml_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from test_torch_conv import _split  # noqa: E402
from test_torch_flash_dh256 import FWD_ATOL, GRAD_ATOL  # noqa: E402
from test_torch_flash_f32_tc import (EXACT_TOL, _exact, _heads, _inputs,  # noqa: E402
                                     _jax_layout, _rel, _split_t, _tf32x3, _tiles,
                                     emulate_forward, in_fragment_order)
from test_torch_flash_f32_tc import _one_thread  # noqa: E402, F401  (autouse: one thread)

jfa = importlib.import_module("fedml_tpu.ops.pallas.flash_attention")

KEY_ROWS = 64     # key rows of a dk/dv block
DKV_QUERIES = 16  # rows of dk/dv's q and dO tiles


def emulate_dkv(q, k, v, do, lse, delta, causal, terms=3, drop_query=None, key_rows=KEY_ROWS,
                queries=DKV_QUERIES, key_order=None, combine=None, scale=None):
    """From (H, T, Dh) q, k, v, dO and (H, T) lse and delta -> (dk, dv),
    both (H, T, Dh), in blocks of ``key_rows`` keys and tiles of ``queries``
    q/dO rows; P^T dO and dS^T Q with their queries paired by ``key_order``
    (``in_fragment_order``). Every key block at once; causal q tiles before
    a key block give p = 0 there, adding exact zeros where the kernel skips
    them. ``drop_query``: the q tile that holds it is left out (a planted
    fault). ``combine`` maps each score product (S^T, dP^T) before its use
    (a cluster's sum of its column parts' partial scores, the heads then
    being column parts); ``scale`` defaults to Dh ** -0.5."""
    H, T, Dh = q.shape
    nk, nq = -(-T // key_rows), -(-T // queries)
    scale = Dh ** -0.5 if scale is None else scale
    ks, vs = _split(_tiles(k, key_rows, nk)), _split(_tiles(v, key_rows, nk))
    qt, ot = _tiles(q, queries, nq), _tiles(do, queries, nq)
    lse_t, delta_t = (F.pad(x, (0, nq * queries - T)).view(H, nq, 1, 1, queries)
                      for x in (lse, delta))
    keys = torch.arange(nk * key_rows).view(nk, key_rows, 1)
    dk = torch.zeros(H, nk, key_rows, Dh)
    dv = torch.zeros(H, nk, key_rows, Dh)
    for j in range(nq):
        if drop_query is not None and j == drop_query // queries:
            continue
        cols = torch.arange(j * queries, (j + 1) * queries)
        s = _tf32x3(ks, _split_t(qt[:, j, None]), terms)
        dp = _tf32x3(vs, _split_t(ot[:, j, None]), terms)
        if combine is not None:
            s, dp = combine(s), combine(dp)
        x = (scale * s).masked_fill(causal & (keys > cols), tfa.NEG_INF)
        p = torch.exp(x - lse_t[:, j]).masked_fill(cols >= T, 0.0)
        pf, oj = in_fragment_order(p, ot[:, j, None], key_order)
        dv = dv + _tf32x3(_split(pf), _split(oj), terms)  # per q tile, from zero
        ds = p * (dp - delta_t[:, j])
        dsf, qj = in_fragment_order(ds, qt[:, j, None], key_order)
        dk = dk + scale * _tf32x3(_split(dsf), _split(qj), terms)
    return (dk.view(H, nk * key_rows, Dh)[:, :T], dv.view(H, nk * key_rows, Dh)[:, :T])


# the sound arithmetic and its planted faults: (terms, a row whose tile is
# left out: a query for dk/dv, a key for the forward)
FAULTS = {"sound": (3, None), "hi_hi_only": (1, None), "tile_dropped": (3, 100)}


@pytest.fixture(scope="module")
def t1024():
    """(1, 1024, 2, Dh) inputs as (H, T, Dh) and their float64 results, for
    Dh 256 (dk/dv) and 128 (the forward), causal and full."""
    cases = {}
    for Dh in (128, 256):
        q, k, v, do = (_heads(a) for a in _inputs((1, 1024, 2, Dh), seed=31))
        cases[Dh] = (q, k, v, do), {c: _exact(q, k, v, do, c) for c in (True, False)}
    return cases


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh256_dkv_arithmetic_is_float32_exact(t1024, causal, fault):
    """At (1, 1024, 2, 256), dk and dv (from float64's lse and delta, so
    that their own arithmetic is what is held) against float64: within
    EXACT_TOL of the largest exact value when sound; each planted fault
    fails that limit for dk and for dv."""
    (q, k, v, do), exact = t1024[256]
    _, lse64, delta64, _, dk64, dv64 = exact[causal]
    terms, drop = FAULTS[fault]
    dk, dv = emulate_dkv(q, k, v, do, lse64.float(), delta64.float(), causal, terms, drop)
    errs = (_rel(dk, dk64), _rel(dv, dv64))
    if fault == "sound":
        assert max(errs) <= EXACT_TOL, errs
    else:
        assert min(errs) > EXACT_TOL, errs


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh128_forward_arithmetic_is_float32_exact(t1024, causal, fault):
    """At (1, 1024, 2, 128), out and lse against float64: within EXACT_TOL
    when sound; each planted fault fails that limit for out."""
    (q, k, v, _), exact = t1024[128]
    out64, lse64 = exact[causal][:2]
    terms, drop = FAULTS[fault]
    out, lse = emulate_forward(q, k, v, causal, terms, drop)
    if fault == "sound":
        assert (lse.double() - lse64).abs().max().item() <= EXACT_TOL
        assert _rel(out, out64) <= EXACT_TOL
    else:
        assert _rel(out, out64) > EXACT_TOL


def _jax_flash(q, k, v, do, causal, grads):
    """The JAX package's flash_attention output, lse and, with ``grads``,
    (dq, dk, dv) on (1, T, H, Dh) numpy inputs, its Pallas kernels in
    interpret mode."""
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, causal), jq, jk, jv)
    bq = jfa.auto_block(q.shape[1])
    _, jlse = jfa._flash_forward(jq, jk, jv, causal, bq, bq, True)
    return (np.asarray(jout), np.asarray(jlse)[:, 0],
            tuple(np.asarray(g) for g in vjp(jnp.asarray(do))) if grads else None)


@pytest.fixture(scope="module")
def jax_t256():
    """(1, 256, 2, Dh) inputs and the JAX package's results on them, causal
    and full: at Dh 256 with the gradients (dk/dv), at 128 the forward."""
    cases = {}
    for Dh in (128, 256):
        inputs = _inputs((1, 256, 2, Dh), seed=32)
        cases[Dh] = inputs, {c: _jax_flash(*inputs, c, Dh == 256) for c in (True, False)}
    return cases


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh256_dkv_arithmetic_matches_jax(jax_t256, causal, fault):
    """At (1, 256, 2, 256), the emulated dk and dv (lse and delta from the
    emulated forward, as the port's backward forms them) against the JAX
    package's gradients through jax.vjp, within GRAD_ATOL when sound; each
    planted fault fails that limit."""
    inputs, want = jax_t256[256]
    _, _, (_, jdk, jdv) = want[causal]
    th = [_heads(a) for a in inputs]
    terms, drop = FAULTS[fault]
    out, lse = emulate_forward(*th[:3], causal)
    dk, dv = emulate_dkv(*th, lse, (th[3] * out).sum(-1), causal, terms, drop)
    checks = ((_jax_layout(dk), jdk), (_jax_layout(dv), jdv))
    if fault == "sound":
        for got, w in checks:
            np.testing.assert_allclose(got, w, atol=GRAD_ATOL)
    else:
        assert max(np.abs(got - w).max() for got, w in checks) > GRAD_ATOL


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh128_forward_arithmetic_matches_jax(jax_t256, causal, fault):
    """At (1, 256, 2, 128), the emulated out and lse against the JAX
    package's flash_attention and its lse, within FWD_ATOL when sound; each
    planted fault fails that limit for out."""
    inputs, want = jax_t256[128]
    jout, jlse, _ = want[causal]
    th = [_heads(a) for a in inputs]
    terms, drop = FAULTS[fault]
    out, lse = emulate_forward(*th[:3], causal, terms, drop)
    if fault == "sound":
        np.testing.assert_allclose(_jax_layout(out), jout, atol=FWD_ATOL)
        np.testing.assert_allclose(lse.numpy(), jlse, atol=FWD_ATOL)
    else:
        assert np.abs(_jax_layout(out) - jout).max() > FWD_ATOL


@pytest.mark.parametrize("causal", [True, False])
def test_f32_arithmetic_at_ragged_t_matches_jax_dense(causal):
    """At T 130, a multiple of no tile (the kernels zero-fill and mask the
    rows and columns past it), against the JAX package's dense attention:
    dk and dv at Dh 256 through jax.vjp, the output at Dh 128 (its
    flash_attention refuses a T without a block tiling)."""
    for Dh in (256, 128):
        q, k, v, do = _inputs((1, 130, 2, Dh), seed=33)
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        jout, vjp = jax.vjp(lambda q, k, v: jatt.multihead_attention(
            q, k, v, causal=causal, impl="dense"), jq, jk, jv)
        th = [_heads(a) for a in (q, k, v, do)]
        out, lse = emulate_forward(*th[:3], causal)
        if Dh == 128:
            np.testing.assert_allclose(_jax_layout(out), np.asarray(jout), atol=FWD_ATOL)
            continue
        _, jdk, jdv = vjp(jnp.asarray(do))
        dk, dv = emulate_dkv(*th, lse, (th[3] * out).sum(-1), causal)
        np.testing.assert_allclose(_jax_layout(dk), np.asarray(jdk), atol=GRAD_ATOL)
        np.testing.assert_allclose(_jax_layout(dv), np.asarray(jdv), atol=GRAD_ATOL)


@pytest.mark.parametrize("T", [4096, 4352, 4608])
def test_mid_f32_dispatch_matches_jax(T):
    """The float32 LM at --dim 1024 (B 8, H 8, Dh 128, 4-byte items): the
    port's auto dispatch decides as the JAX package's, flash at T 4352 and
    4608, dense at 4096 (the shared guard's budget refuses its block 1024)."""
    got = tatt.auto_attention_impl(8, 8, T, 128, 4)
    assert got == jatt.auto_attention_impl(8, 8, T, 128, 4)
    assert got == ("dense" if T == 4096 else "flash")
