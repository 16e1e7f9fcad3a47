"""The bf16 weight gradient on the tensor cores (``bf16_tc`` route of
``fedml_tpu_torch/ops/conv.py``; ``conv3x3_dw_bf16_kernel`` of
``fedml_tpu_torch/csrc/conv3x3_sm90.cu``), emulated on the CPU.

The kernel runs only on the card. Here its arithmetic is written out in
float32 torch as the kernel orders it: the pixels cut into tiles of whole
image rows (``dw_tc_geometry``), each tile's halo of x read at the nine tap
shifts, 16-pixel k-steps of exact bf16 x bf16 products summed into a
float32 accumulator that starts from zero for each tile, the tiles of a span
added in float32, the spans' partials added in the fixed order s = 0..S-1
(``dw_split_plan``), and one rounding to bf16. It is held against float64
with the card's bf16 gate, and against the JAX package's ``conv2d_pallas``
VJP in Pallas interpret mode at small ResNet shapes. The kernel itself is
held to the plain version on the card by ``chip_smoke.py`` and by the
``cuda``-marked test below.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax.config.update("jax_default_matmul_precision", "highest")

from fedml_tpu.ops.conv import conv2d_pallas  # noqa: E402
from fedml_tpu_torch.ops import conv as C  # noqa: E402

# chip_smoke.py's bf16 conv gate: every output within one bf16 step of the
# exactly rounded value (plus CONV_TOL of its magnitude), and at most this
# share of the outputs (or CONV_MISMATCH_FLOOR of them) off it at all
CONV_TOL = 1e-5
CONV_MISMATCH_SHARE = 0.0025
CONV_MISMATCH_FLOOR = 8


@pytest.fixture()
def interp_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _bf16_values(shape, rng, scale=1.0):
    """A float32 tensor holding bf16 values."""
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(torch.bfloat16).float()


def emulate_tc_dw(x, dy, L=1):
    """x (B, H, W, Ci), dy (B, H, W, Co) float32 holding bf16 values -> dw
    (3, 3, Ci, Co) in float32, before its rounding, summed as the kernel
    sums one lane of L."""
    B, H, W, ci = x.shape
    co = dy.shape[-1]
    rb, cb, tiles = C.dw_tc_geometry(B, H, W)
    span, splits = C.dw_split_plan(L, tiles, ci, co, "bf16_tc")
    nh, nw = -(-H // rb), -(-W // cb)
    steps = -(-rb * cb // 16)
    # the halo of every tile: one zero pixel around the image, zero past it
    xp = F.pad(x, (0, 0, 1, nw * cb - W + 1, 1, nh * rb - H + 1))
    dp = F.pad(dy, (0, 0, 0, nw * cb - W, 0, nh * rb - H))
    rows = torch.arange(rb)[:, None].expand(rb, cb).reshape(-1)
    cols = torch.arange(cb)[None, :].expand(rb, cb).reshape(-1)
    t = torch.arange(tiles)
    b, h0, w0 = t // (nh * nw), (t // nw) % nh * rb, t % nw * cb
    hh, ww = h0[:, None] + rows[None], w0[:, None] + cols[None]  # (tiles, slots)
    bb = b[:, None].expand_as(hh)
    # A: (tiles, slots, 9 Ci) in (dy, dx, ci) order; the slots past rb * cb
    # (the last k-step's padding) read zero dy
    A = torch.cat([xp[bb, hh + ty, ww + tx] for ty in range(3) for tx in range(3)], -1)
    D = dp[bb, hh, ww]
    pad = steps * 16 - rb * cb
    A, D = F.pad(A, (0, 0, 0, pad)), F.pad(D, (0, 0, 0, pad))
    sacc = torch.zeros(tiles, 9 * ci, co)
    for j in range(steps):  # a tile's k-steps into one zero-started accumulator
        k = slice(16 * j, 16 * j + 16)
        sacc = sacc + A[:, k].transpose(1, 2) @ D[:, k]
    part = torch.zeros(splits, 9 * ci, co)
    for i in range(span):  # each span's tiles in order, added in float32
        idx = torch.arange(splits) * span + i
        ok = idx < tiles
        part[ok] = part[ok] + sacc[idx[ok]]
    dw = torch.zeros(9 * ci, co)
    for s in range(splits):
        dw = dw + part[s]
    return dw.reshape(3, 3, ci, co)


def _dw64(x, dy):
    """dw of one lane, x (B, H, W, Ci) and dy (B, H, W, Co), in float64:
    patches(x)^T dy, (3, 3, Ci, Co)."""
    B, H, W, ci = x.shape
    p = C.extract_patches(x.double(), 3, 3, 1, "SAME").reshape(-1, 9 * ci)
    return (p.T @ dy.double().reshape(-1, dy.shape[-1])).reshape(3, 3, ci, -1)


def _bf16_gate(got32, exact, mag):
    """(share of bf16 outputs off the exactly rounded value, largest
    difference in bf16 steps) of float32 ``got32`` rounded once, against
    float64 ``exact`` with magnitudes ``mag``; asserts the card's gate."""
    got, want = got32.to(torch.bfloat16), exact.float().to(torch.bfloat16)
    _, e = torch.frexp(torch.maximum(got.float().abs(), want.float().abs()))
    step = torch.ldexp(torch.ones_like(got.float()), e - 8)
    diff = (got.float() - want.float()).abs()
    assert (diff <= step + CONV_TOL * mag.float()).all()
    off = (got != want).sum().item()
    assert off <= max(CONV_MISMATCH_SHARE * got.numel(), CONV_MISMATCH_FLOOR), off
    return off / got.numel(), (diff / step).max().item()


# (B, H, W, Ci): ResNet-56's block widths at a few images (several tiles
# and spans per image at 32 x 32 and 16 x 16), a width past DW_SLOTS
# (tiles of one row's columns) and ragged images
EMULATED = ((4, 32, 32, 16), (8, 16, 16, 32), (16, 8, 8, 64), (2, 3, 130, 16), (3, 7, 9, 32))


@pytest.mark.parametrize("B,H,W,ci", EMULATED)
def test_tc_dw_arithmetic_is_float32_exact(B, H, W, ci):
    """The emulated kernel against float64: within float32 summation noise,
    and its bf16 outputs within the card's gate of the exactly rounded
    value."""
    rng = np.random.default_rng(B * H + ci)
    x, dy = _bf16_values((B, H, W, ci), rng), _bf16_values((B, H, W, ci), rng)
    got = emulate_tc_dw(x, dy)
    exact, mag = _dw64(x, dy), _dw64(x.abs(), dy.abs())
    assert ((got.double() - exact).abs() / mag).max().item() <= 1e-6
    _bf16_gate(got, exact, mag)


@pytest.mark.parametrize("B,H,W,ci", [(2, 8, 8, 16), (2, 8, 8, 32), (1, 8, 8, 64)])
def test_tc_dw_arithmetic_matches_conv2d_pallas(interp_pallas, B, H, W, ci):
    """The emulated kernel, rounded to bf16, against the weight gradient of
    the JAX package's conv2d_pallas on the same bf16 operands (its float32
    grid accumulation, then ``.astype(w.dtype)``): within one bf16 step,
    and nearly always bit for bit."""
    rng = np.random.default_rng(ci)
    x, dy = _bf16_values((B, H, W, ci), rng), _bf16_values((B, H, W, ci), rng)
    w = _bf16_values((3, 3, ci, ci), rng, 0.3)
    jx, jw, jg = (jnp.asarray(t.numpy()).astype(jnp.bfloat16) for t in (x, w, dy))
    _, vjp = jax.vjp(lambda a, b: conv2d_pallas(a, b), jx, jw)
    jdw = torch.from_numpy(np.asarray(vjp(jg)[1].astype(jnp.float32)))
    got = emulate_tc_dw(x, dy).to(torch.bfloat16).float()
    _, e = torch.frexp(torch.maximum(got.abs(), jdw.abs()))
    step = torch.ldexp(torch.ones_like(got), e - 8)
    mag = C.conv3x3_dw_plain(x.abs()[None], dy.abs()[None])[0]
    assert ((got - jdw).abs() <= step + CONV_TOL * mag).all()
    assert (got != jdw).float().mean().item() <= 0.02


# (Ci, Co, dtype, route) of every weight gradient of ResNet-56 (the stem,
# then each stage's block convs) in both dtypes, and ragged channels
RESNET56_DW_ROUTES = ((3, 16, torch.bfloat16, "fma_bf16"), (16, 16, torch.bfloat16, "bf16_tc"),
                      (32, 32, torch.bfloat16, "bf16_tc"), (64, 64, torch.bfloat16, "bf16_tc"),
                      (16, 32, torch.bfloat16, "fma_bf16"), (5, 7, torch.bfloat16, "fma_bf16"),
                      (3, 16, torch.float32, "fma"), (16, 16, torch.float32, "fma"),
                      (64, 64, torch.float32, "fma"))


@pytest.mark.parametrize("ci,co,dtype,route", RESNET56_DW_ROUTES)
def test_dw_route_by_channels(ci, co, dtype, route):
    """bf16 block convs (Ci = Co in {16, 32, 64}) on the tensor cores, the
    stem, unequal and ragged widths on the FMA kernel's bf16 form, float32
    on the FMA kernel."""
    assert C.dw_route(ci, co, dtype) == route
    assert C.DW_ROUTES[route][0] == ("conv3x3_sm90" if route == "bf16_tc" else "conv3x3")
    assert C.ROUTE_DTYPE[route] == dtype


@pytest.mark.parametrize("L,B,H,W,ci", [(1, 64, 32, 32, 16), (10, 64, 32, 32, 16),
                                        (1, 64, 16, 16, 32), (10, 64, 8, 8, 64),
                                        (128, 1, 32, 32, 16), (1, 1, 1, 1, 64),
                                        (3, 2, 5, 300, 32), (2, 3, 200, 1, 16)])
def test_tc_geometry_and_split_plan_cover_every_pixel(L, B, H, W, ci):
    """Tiles of at most DW_SLOTS slots cover each image once; spans cover
    the tiles once; blocks (lanes x row tiles x spans) stay within one wave
    unless one span per row tile already passes it."""
    rb, cb, tiles = C.dw_tc_geometry(B, H, W)
    assert 1 <= rb * cb <= C.DW_SLOTS and rb <= H and cb <= W
    assert (cb == W) or rb == 1
    assert tiles == B * -(-H // rb) * -(-W // cb)
    rows, cols, threads, _ = C.dw_tile(ci, ci, "bf16_tc")
    assert (9 * ci) % rows == 0 and cols == ci and threads % 32 == 0
    span, splits = C.dw_split_plan(L, tiles, ci, ci, "bf16_tc")
    assert (splits - 1) * span < tiles <= splits * span and splits <= 65535
    assert L * (9 * ci // rows) * splits <= max(C.TARGET_BLOCKS, L * 9 * ci // rows)


@pytest.mark.cuda
@pytest.mark.parametrize("L,B,H,W,ci", [(1, 64, 32, 32, 16), (10, 64, 16, 16, 32),
                                        (2, 64, 8, 8, 64), (3, 2, 5, 300, 32)])
def test_tc_dw_matches_plain_on_card(L, B, H, W, ci):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(L, B, H, W, ci, generator=g).to("cuda", torch.bfloat16)
    dy = torch.randn(L, B, H, W, ci, generator=g).to("cuda", torch.bfloat16)
    dw = C.conv3x3_dw_lanes(x, dy)
    for lane in range(L):
        xl, gl = x[lane].float().cpu(), dy[lane].float().cpu()
        _bf16_gate(dw[lane].float().cpu(), _dw64(xl, gl), _dw64(xl.abs(), gl.abs()))
    assert torch.equal(dw, C.conv3x3_dw_lanes(x, dy))
