"""The arithmetic of the bf16 Dh-384 flash kernels (forward, dq and dk/dv
of ``fedml_tpu_torch/csrc/flash_dh384_sm90.cu``), emulated on the CPU.

The CUDA kernels run only on the card. Here their arithmetic is written out
in float32 torch, tile by tile, as the kernels order it. What differs from
the Dh-256 kernels (``tests/test_torch_flash_dh256_tc.py``, whose dk/dv and
tile helpers are reused):

- forward: each warpgroup sums the scores of its half of the 384 columns
  (a product over 192 columns), and S is the two halves added once in
  float32, the same bits in both warpgroups; the online softmax and P V as
  at Dh 256, P V over each warpgroup's own column groups (the same per
  output column as one product over all of them);
- dq: S and dP each in one product over all 384 columns, except on the
  causal diagonal, where both are summed column by column in float32 from
  zero (a plain float32 product's order), ds = p (dP - delta), and dS K as
  three bf16 terms from a zero accumulator per k tile;
- dk/dv: the Dh-256 kernel's arithmetic; a block's column half changes
  which outputs it sums, not how.

Held against float64 at (1, 1024, 2, 384) and against the JAX package's
``flash_attention``, whose Pallas kernels run in interpret mode off the
TPU, at (1, 256, 2, 384) within the tolerances
``tests/test_torch_flash_dh384.py`` holds the plain versions to; a forward
that adds its own half twice (reading its own exchange tile) must fail. The
kernels themselves are held to the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_flash.py::test_flash_kernels_match_plain_on_card``.
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
from test_torch_flash_dh256_tc import (TILE, _bf16_inputs, _exact_backward,  # noqa: E402
                                       _heads, _plain_order_dots, _tiles, emulate_dkv)
from test_torch_flash_dh384 import FWD_ATOL, GRAD_ATOL  # noqa: E402

jfa = importlib.import_module("fedml_tpu.ops.pallas.flash_attention")

HALF = 192  # a warpgroup's columns of the score product in the forward


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulations are many small tensor operations: torch's thread pool
    over several test workers at once spends its time waiting, not
    computing, so they run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def emulate_forward(q, k, v, causal, fault=None):
    """q, k, v (H, T, 384) float32 holding bf16 values -> (out (H, T, 384)
    in float32, before its bf16 store; lse (H, T)). Every q tile at once;
    causal key tiles past a q tile's diagonal are fully masked, which leaves
    m, l and the output bit for bit as the kernel's skipping them does.
    ``fault="own_tile"``: each warpgroup adds its own half twice."""
    H, T, Dh = q.shape
    nt = -(-T // TILE)
    scale = Dh ** -0.5
    qt, kt, vt = (_tiles(x, nt) for x in (q, k, v))
    rows = torch.arange(nt * TILE).view(nt, TILE, 1)
    m = torch.full((H, nt, TILE, 1), tfa.NEG_INF)
    l = torch.zeros(H, nt, TILE, 1)
    acc = torch.zeros(H, nt, TILE, Dh)
    for j in range(nt):
        kj = kt[:, j, None].transpose(-1, -2)
        s0 = qt[..., :HALF] @ kj[..., :HALF, :]  # warpgroup 0's half
        s1 = qt[..., HALF:] @ kj[..., HALF:, :]  # warpgroup 1's half
        s = s0 + s0 if fault == "own_tile" else s0 + s1
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


def emulate_dq(q, k, v, do, lse, delta, causal):
    """From (H, T, 384) bf16-valued q, k, v, dO and (H, T) lse and delta ->
    dq (H, T, 384) in float32. Every q tile at once; causal k tiles past a q
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
        s = qt @ kt[:, j, None].transpose(-1, -2)
        dp = ot @ vt[:, j, None].transpose(-1, -2)
        if causal:  # q tile j's diagonal: S and dP in a plain product's order
            s[:, j] = _plain_order_dots(qt[:, j], kt[:, j])
            dp[:, j] = _plain_order_dots(ot[:, j], vt[:, j])
        x = (scale * s).masked_fill(causal & (cols > rows), tfa.NEG_INF)
        p = torch.where(cols < T, torch.exp(x - lse_t), 0.0)
        ds = p * (dp - delta_t)
        dq = dq + scale * _split_mm(ds, kt[:, j, None])  # per k tile, from zero
    return dq.view(H, nt * TILE, Dh)[:, :T]


@pytest.fixture(scope="module")
def t1024():
    """(1, 1024, 2, 384) bf16-valued inputs as (H, T, Dh)."""
    return tuple(_heads(a) for a in _bf16_inputs((1, 1024, 2, 384), seed=31))


@pytest.mark.parametrize("causal", [True, False])
def test_dh384_kernel_arithmetic_is_float32_exact(t1024, causal):
    """At (1, 1024, 2, 384), out, dv, dk and dq against float64 (dk/dv and
    dq from float64's lse and delta, so their own arithmetic is what is
    held): within float32 summation noise; bf16 outputs off the exactly
    rounded value within a quarter of the card's gate, dq within the gate
    (causal row 0 is rounding noise of dp - delta, exactly 0 in float64)."""
    q, k, v, do = t1024
    T, Dh = q.shape[1], q.shape[2]
    lse64, delta64, dq64 = _exact_backward(q, k, v, do, causal)
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    s64 = Dh ** -0.5 * (q64 @ k64.transpose(1, 2))
    if causal:
        s64 = s64.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
    p64 = torch.exp(s64 - lse64[..., None])
    ds64 = p64 * (do64 @ v64.transpose(1, 2) - delta64[..., None])
    want = {"out": p64 @ v64, "dv": p64.transpose(1, 2) @ do64,
            "dk": Dh ** -0.5 * (ds64.transpose(1, 2) @ q64)}
    out, lse = emulate_forward(q, k, v, causal)
    dk, dv = emulate_dkv(q, k, v, do, lse64.float(), delta64.float(), causal)
    dq = emulate_dq(q, k, v, do, lse64.float(), delta64.float(), causal)
    assert (lse.double() - lse64).abs().max().item() <= 1e-5
    for name, got in (("out", out), ("dv", dv), ("dk", dk)):
        share, err = _vs_exact(got, want[name])
        assert share <= GATE_SHARE / 4, (name, share)
        assert err <= 1e-5, (name, err)  # float32 summation noise over <= 1024 terms
    share, err = _vs_exact(dq, dq64)
    assert share <= GATE_SHARE, share
    assert err <= 1e-5, err


def test_dh384_forward_reading_its_own_tile_fails(t1024):
    """A forward whose warpgroups add their own half of the scores twice
    (the exchange read from the wrong tile) is far outside the limits."""
    q, k, v, _ = t1024
    T = q.shape[1]
    s64 = (q.double() @ k.double().transpose(1, 2)) * q.shape[2] ** -0.5
    s64 = s64.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
    out64 = torch.softmax(s64, -1) @ v.double()
    assert _vs_exact(emulate_forward(q, k, v, True)[0], out64)[1] <= 1e-5
    out, _ = emulate_forward(q, k, v, True, fault="own_tile")
    assert _vs_exact(out, out64)[1] > 1e-2


@pytest.mark.parametrize("causal", [True, False])
def test_dh384_kernel_arithmetic_matches_jax(causal):
    """At (1, 256, 2, 384), the emulated out, lse, dq, dk and dv (delta from
    the emulated out, as the port's backward forms it) against the JAX
    package's flash_attention and its lse, on the same bf16-valued inputs."""
    q, k, v, do = _bf16_inputs((1, 256, 2, 384), seed=32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, causal)
    jdq, jdk, jdv = jax.grad(lambda q, k, v: (jfa.flash_attention(q, k, v, causal) * do).sum(),
                             argnums=(0, 1, 2))(jq, jk, jv)
    bq = jfa.auto_block(256)
    _, jlse = jfa._flash_forward(jq, jk, jv, causal, bq, bq, True)
    th = [_heads(a) for a in (q, k, v, do)]
    out, lse = emulate_forward(*th[:3], causal)
    delta = (th[3] * out).sum(-1)
    dk, dv = emulate_dkv(*th, lse, delta, causal)
    dq = emulate_dq(*th, lse, delta, causal)

    def jax_layout(x):  # (H, T, Dh) -> (1, T, H, Dh)
        return x.permute(1, 0, 2)[None].numpy()

    np.testing.assert_allclose(jax_layout(out), np.asarray(want), atol=FWD_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, 0], atol=FWD_ATOL)
    for got, w in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(jax_layout(got), np.asarray(w), atol=GRAD_ATOL)
