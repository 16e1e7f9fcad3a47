"""The arithmetic of the bf16 Dh-256 flash kernels (forward, dq and dk/dv
of ``fedml_tpu_torch/csrc/flash_dh256_sm90.cu``), emulated on the CPU.

The CUDA kernels run only on the card. Here their arithmetic is written out
in float32 torch, tile by tile, as the kernels order it:

- forward: each 64-row q tile's scores against each 64-key tile in one
  product over all 256 columns of bf16-valued inputs, the online softmax per
  key tile (finfo(float32).min masking, l clamped at 1e-30), P V as three
  bf16 terms of p (smallest first) from a zero accumulator per key tile,
  added to the output in float32 after the rescale;
- dk/dv: per k tile and q tile, S^T = K Q^T and p = exp(scale S^T - lse) (the
  exchanged tile: its values cross shared memory unchanged), dP^T = V dO^T,
  ds = p (dP^T - delta), and P^T dO and dS^T Q as three bf16 terms from a zero
  accumulator per q tile, added in float32; dk scaled at the end;
- dq: per q tile and k tile, S = Q K^T and dP = dO V^T in one product each
  over all 256 columns, except dP on the causal diagonal, summed column by
  column in float32 from zero (a plain float32 product's order), ds = p (dP
  - delta), and dS K as three bf16 terms from a zero accumulator per k tile,
  scale times it added to dq in float32.

Held against float64 at (1, 1024, 2, 256) (bf16 outputs almost never off the
exactly rounded value, float32 summation noise) and against the JAX
package's ``flash_attention``, whose Pallas kernels run in interpret mode off
the TPU, at (1, 256, 2, 256) within the tolerances
``tests/test_torch_flash_dh256.py`` holds the plain versions to. The kernels
themselves are held to the plain versions on the card by ``chip_smoke.py``
and ``tests/test_torch_flash.py::test_flash_kernels_match_plain_on_card``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax.config.update("jax_default_matmul_precision", "highest")

from fedml_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from test_torch_flash import GATE_SHARE, _split_mm, _vs_exact  # noqa: E402
from test_torch_flash_dh256 import FWD_ATOL, GRAD_ATOL  # noqa: E402

jfa = importlib.import_module("fedml_tpu.ops.pallas.flash_attention")

TILE = 64


def _bf16_inputs(shape, seed):
    """q, k, v, dO as bf16 values in float32 numpy arrays, (B, T, H, Dh)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                 .to(torch.bfloat16).float().numpy() for _ in range(4))


def _heads(a):
    """(1, T, H, Dh) numpy -> (H, T, Dh) float32 torch."""
    return torch.from_numpy(a[0]).permute(1, 0, 2).contiguous()


def _tiles(x, nt):
    """(H, T, Dh) -> (H, nt, 64, Dh), rows past T zero (TMA's fill)."""
    H, T, Dh = x.shape
    return F.pad(x, (0, 0, 0, nt * TILE - T)).view(H, nt, TILE, Dh)


def emulate_forward(q, k, v, causal):
    """q, k, v (H, T, 256) float32 holding bf16 values -> (out (H, T, 256)
    in float32, before its bf16 store; lse (H, T)). Every q tile at once;
    causal key tiles past a q tile's diagonal are fully masked, which leaves
    m, l and the output bit for bit as the kernel's skipping them does."""
    H, T, Dh = q.shape
    nt = -(-T // TILE)
    scale = Dh ** -0.5
    qt, kt, vt = (_tiles(x, nt) for x in (q, k, v))
    rows = torch.arange(nt * TILE).view(nt, TILE, 1)
    m = torch.full((H, nt, TILE, 1), tfa.NEG_INF)
    l = torch.zeros(H, nt, TILE, 1)
    acc = torch.zeros(H, nt, TILE, Dh)
    for j in range(nt):
        s = qt @ kt[:, j, None].transpose(-1, -2)  # one product over 256 columns
        cols = torch.arange(j * TILE, (j + 1) * TILE)
        x = (s * scale).masked_fill((cols >= T) | (causal & (cols > rows)), tfa.NEG_INF)
        nm = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp(m - nm)
        p = torch.exp(x - nm)
        l = l * corr + p.sum(-1, keepdim=True)
        m = nm
        acc = acc * corr + _split_mm(p, vt[:, j, None])  # per key tile, from zero
    ls = l.clamp_min(1e-30)
    out = (acc / ls).view(H, nt * TILE, Dh)[:, :T]
    return out, (m + torch.log(ls)).view(H, nt * TILE)[:, :T]


def emulate_dkv(q, k, v, do, lse, delta, causal):
    """From (H, T, 256) bf16-valued q, k, v, dO and (H, T) lse and delta ->
    (dk, dv) (H, T, 256) in float32. Every k tile at once; causal q tiles
    before a k tile's diagonal give p = 0, adding exact zeros."""
    H, T, Dh = q.shape
    nt = -(-T // TILE)
    scale = Dh ** -0.5
    qt, kt, vt, ot = (_tiles(x, nt) for x in (q, k, v, do))
    lse_t, delta_t = (F.pad(x, (0, nt * TILE - T)).view(H, nt, TILE) for x in (lse, delta))
    keys = torch.arange(nt * TILE).view(nt, TILE, 1)
    dk, dv = torch.zeros(H, nt, TILE, Dh), torch.zeros(H, nt, TILE, Dh)
    for i in range(nt):
        cols = torch.arange(i * TILE, (i + 1) * TILE)
        x = (scale * (kt @ qt[:, i, None].transpose(-1, -2))).masked_fill(
            causal & (keys > cols), tfa.NEG_INF)  # S^T: keys x queries
        p = torch.where(cols < T, torch.exp(x - lse_t[:, i, None, None, :]), 0.0)
        dp = vt @ ot[:, i, None].transpose(-1, -2)  # dP^T
        ds = p * (dp - delta_t[:, i, None, None, :])
        dv = dv + _split_mm(p, ot[:, i, None])  # P^T dO per q tile, from zero
        dk = dk + _split_mm(ds, qt[:, i, None])  # dS^T Q
    return ((scale * dk).view(H, nt * TILE, Dh)[:, :T], dv.view(H, nt * TILE, Dh)[:, :T])


@pytest.mark.parametrize("causal", [True, False])
def test_dh256_kernel_arithmetic_is_float32_exact(causal):
    """At (1, 1024, 2, 256), out, dv and dk against float64: within float32
    summation noise, and bf16 outputs almost never off the exactly rounded
    value (a quarter of the card's gate). dk/dv take float64's lse and delta,
    so their own arithmetic is what is held."""
    q, k, v, do = (_heads(a) for a in _bf16_inputs((1, 1024, 2, 256), seed=11))
    T, Dh = q.shape[1], q.shape[2]
    scale = Dh ** -0.5
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    s64 = scale * (q64 @ k64.transpose(1, 2))
    if causal:
        s64 = s64.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
    lse64 = torch.logsumexp(s64, -1)
    p64 = torch.exp(s64 - lse64[..., None])
    out64 = p64 @ v64
    delta64 = (do64 * out64).sum(-1)
    ds64 = p64 * (do64 @ v64.transpose(1, 2) - delta64[..., None])
    want = {"out": out64, "dv": p64.transpose(1, 2) @ do64,
            "dk": scale * (ds64.transpose(1, 2) @ q64)}
    out, lse = emulate_forward(q, k, v, causal)
    dk, dv = emulate_dkv(q, k, v, do, lse64.float(), delta64.float(), causal)
    assert (lse.double() - lse64).abs().max().item() <= 1e-5
    for name, got in (("out", out), ("dv", dv), ("dk", dk)):
        share, err = _vs_exact(got, want[name])
        assert share <= GATE_SHARE / 4, (name, share)
        assert err <= 1e-5, (name, err)  # float32 summation noise over <= 1024 terms


@pytest.mark.parametrize("causal", [True, False])
def test_dh256_kernel_arithmetic_matches_jax(causal):
    """At (1, 256, 2, 256), the emulated out, lse, dk and dv (delta from the
    emulated out, as the port's backward forms it) against the JAX package's
    flash_attention and its lse, on the same bf16-valued inputs."""
    q, k, v, do = _bf16_inputs((1, 256, 2, 256), seed=12)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, causal)
    _, jdk, jdv = jax.grad(lambda q, k, v: (jfa.flash_attention(q, k, v, causal) * do).sum(),
                           argnums=(0, 1, 2))(jq, jk, jv)
    bq = jfa.auto_block(256)
    _, jlse = jfa._flash_forward(jq, jk, jv, causal, bq, bq, True)
    th = [_heads(a) for a in (q, k, v, do)]
    out, lse = emulate_forward(*th[:3], causal)
    delta = (th[3] * out).sum(-1)
    dk, dv = emulate_dkv(*th, lse, delta, causal)

    def jax_layout(x):  # (H, T, Dh) -> (1, T, H, Dh)
        return x.permute(1, 0, 2)[None].numpy()

    np.testing.assert_allclose(jax_layout(out), np.asarray(want), atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0], atol=FWD_ATOL)
    np.testing.assert_allclose(jax_layout(dk), np.asarray(jdk), atol=GRAD_ATOL)
    np.testing.assert_allclose(jax_layout(dv), np.asarray(jdv), atol=GRAD_ATOL)


def _plain_order_dots(a, b):
    """a (..., 64, Dh) b^T as the kernel's diagonal sums it: per output, a
    chain of float32 multiply-adds over the columns in increasing order from
    zero (each product of two bf16 values is exact in float32)."""
    d = torch.zeros(*a.shape[:-1], b.shape[-2])
    for c in range(a.shape[-1]):
        d = d + a[..., c, None] * b[..., None, :, c]
    return d


def emulate_dq(q, k, v, do, lse, delta, causal):
    """From (H, T, 256) bf16-valued q, k, v, dO and (H, T) lse and delta ->
    dq (H, T, 256) in float32. Every q tile at once; causal k tiles past a q
    tile's diagonal give p = 0, adding exact zeros."""
    H, T, Dh = q.shape
    nt = -(-T // TILE)
    scale = Dh ** -0.5
    qt, kt, vt, ot = (_tiles(x, nt) for x in (q, k, v, do))
    lse_t, delta_t = (F.pad(x, (0, nt * TILE - T)).view(H, nt, TILE, 1) for x in (lse, delta))
    rows = torch.arange(nt * TILE).view(nt, TILE, 1)
    dq = torch.zeros(H, nt, TILE, Dh)
    for j in range(nt):
        cols = torch.arange(j * TILE, (j + 1) * TILE)
        x = (scale * (qt @ kt[:, j, None].transpose(-1, -2))).masked_fill(
            causal & (cols > rows), tfa.NEG_INF)
        p = torch.where(cols < T, torch.exp(x - lse_t), 0.0)
        dp = ot @ vt[:, j, None].transpose(-1, -2)
        if causal:  # q tile j's diagonal: dP in a plain product's order
            dp[:, j] = _plain_order_dots(ot[:, j], vt[:, j])
        ds = p * (dp - delta_t)
        dq = dq + scale * _split_mm(ds, kt[:, j, None])  # per k tile, from zero
    return dq.view(H, nt * TILE, Dh)[:, :T]


def _exact_backward(q, k, v, do, causal):
    """(lse, delta, dq) in float64 from float32 (H, T, Dh) inputs."""
    T, Dh = q.shape[1], q.shape[2]
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    s64 = Dh ** -0.5 * (q64 @ k64.transpose(1, 2))
    if causal:
        s64 = s64.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
    lse64 = torch.logsumexp(s64, -1)
    p64 = torch.exp(s64 - lse64[..., None])
    delta64 = (do64 * (p64 @ v64)).sum(-1)
    ds64 = p64 * (do64 @ v64.transpose(1, 2) - delta64[..., None])
    return lse64, delta64, Dh ** -0.5 * (ds64 @ k64)


@pytest.mark.parametrize("causal", [True, False])
def test_dh256_dq_arithmetic_is_float32_exact(causal):
    """At (1, 1024, 2, 256), dq against float64 (from float64's lse and
    delta): within float32 summation noise, and its bf16 outputs off the
    exactly rounded value within the card's gate. Causal row 0 is rounding
    noise of dp - delta (p = 1 on one key; exactly 0 in float64), so its 256
    values per head count among those off: 0.1% of the outputs, which is
    why this holds to the card's share and not to a quarter of it."""
    q, k, v, do = (_heads(a) for a in _bf16_inputs((1, 1024, 2, 256), seed=13))
    lse64, delta64, want = _exact_backward(q, k, v, do, causal)
    got = emulate_dq(q, k, v, do, lse64.float(), delta64.float(), causal)
    share, err = _vs_exact(got, want)
    assert share <= GATE_SHARE, share
    assert err <= 1e-5, err  # float32 summation noise over <= 1024 terms


@pytest.mark.parametrize("causal", [True, False])
def test_dh256_dq_arithmetic_matches_jax(causal):
    """At (1, 256, 2, 256), the emulated dq (lse and delta from the emulated
    forward, as the port's backward forms them) against the gradient of the
    JAX package's flash_attention on the same bf16-valued inputs."""
    q, k, v, do = _bf16_inputs((1, 256, 2, 256), seed=14)
    jdq = jax.grad(lambda q: (jfa.flash_attention(q, jnp.asarray(k), jnp.asarray(v), causal)
                              * do).sum())(jnp.asarray(q))
    th = [_heads(a) for a in (q, k, v, do)]
    out, lse = emulate_forward(*th[:3], causal)
    dq = emulate_dq(*th, lse, (th[3] * out).sum(-1), causal)
    np.testing.assert_allclose(dq.permute(1, 0, 2)[None].numpy(), np.asarray(jdq),
                               atol=GRAD_ATOL)

