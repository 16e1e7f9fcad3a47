"""The bf16 conv forward on the tensor cores (routes ``bf16_tc`` at Ci = Co
= 64 and ``stem_bf16`` of ``fedml_tpu_torch/ops/conv.py``; the kernels
``conv3x3_bf16_cut_kernel`` and ``conv3x3_stem_bf16_kernel`` of
``fedml_tpu_torch/csrc/conv3x3_sm90.cu``), held on the CPU.

The kernels run only on the card. Here their launch plans are held through
the Python mirrors (``fwd_tc_geometry``, ``fwd_tc_plan``): every output of
every lane and column slice written by exactly one block, in the shared
memory a block may use, with enough blocks to fill the card at one lane.
Their arithmetic is written out in float32 torch as the kernels order it:
the stem's 27-deep contraction in (tap, channel) order padded with zeros
to two 16-deep k-steps, and at Ci 64 each block's 32-column slice summed
over the nine taps' four 16-channel k-steps; bf16 x bf16 products are exact
in float32, the sums float32, one rounding to bf16. The emulations are held
against float64 with the card's bf16 gate and against the JAX package's
``conv2d_pallas`` in Pallas interpret mode, and planted faults (a k-step
dropped, a column slice shifted) must fail the same limits. The kernels
themselves are held to the plain version on the card by ``chip_smoke.py``
and by the ``cuda``-marked test below; this file imports JAX only inside
the tests that compare with it.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu_torch.ops import conv as C

# chip_smoke.py's bf16 conv gate: every output within one bf16 step of the
# exactly rounded value (plus CONV_TOL of its magnitude), and at most this
# share of the outputs (or CONV_MISMATCH_FLOOR of them) off it at all
CONV_TOL = 1e-5
CONV_MISMATCH_SHARE = 0.0025
CONV_MISMATCH_FLOOR = 8

BF = torch.bfloat16
# (B, H, W, Ci, Co) of ResNet-56's stride-1 3x3 convs (chip_smoke.py's
# CONV_LAYERS): the stem, then one block conv per stage
CONV_LAYERS = ((64, 32, 32, 3, 16), (64, 32, 32, 16, 16), (64, 16, 16, 32, 32),
               (64, 8, 8, 64, 64))
# the eval batch; ragged shapes on the two routes (odd images, a row wider
# than a tile, a column image, single pixels); CONV_NESTED's lanes (cohort 4
# x batch 8, one image a lane)
PLAN_SHAPES = ([(L,) + s for L in (1, 2, 10) for s in CONV_LAYERS] +
               [(1, 256, 32, 32, 3, 16), (1, 256, 8, 8, 64, 64), (3, 5, 7, 9, 3, 16),
                (2, 3, 5, 300, 3, 16), (3, 2, 5, 300, 64, 64), (2, 3, 200, 1, 3, 16),
                (2, 3, 200, 1, 64, 64), (2, 7, 1, 1, 3, 16), (1, 1, 1, 1, 64, 64),
                (32, 1, 32, 32, 3, 16), (32, 1, 8, 8, 64, 64)])


def _covered(L, B, H, W, ci, co, sms, per_sm):
    """How often the plan writes each output of one lane, (slices, B, H, W),
    and the most tiles a block walks; asserts the plan's own bounds."""
    imgs, rb, cb, tiles, nbytes = C.fwd_tc_geometry(B, H, W, ci, co)
    blocks, rounds, nbytes2 = C.fwd_tc_plan(L, B, H, W, ci, co, sms, per_sm)
    assert nbytes == nbytes2 <= C.MAX_SMEM
    slices = 1 if (ci, co) == C.STEM_CHANNELS else C.FWD_TC_TILES[ci][3]
    assert blocks % (L * slices) == 0
    per_unit = blocks // (L * slices)
    nh, nw = -(-H // rb), -(-W // cb)
    # block j of a unit walks tiles j, j + per_unit, ...: each tile once
    walk = [np.arange(j, tiles, per_unit) for j in range(per_unit)]
    assert sorted(np.concatenate(walk).tolist()) == list(range(tiles))
    most = max(len(t) for t in walk)
    # each tile's slots: imgs x rb x cb pixels from its origin, clipped
    t = np.arange(tiles)
    w0, h0, b0 = t % nw * cb, t // nw % nh * rb, t // (nw * nh) * imgs
    si, sr, sc = np.meshgrid(np.arange(imgs), np.arange(rb), np.arange(cb), indexing="ij")
    b = (b0[:, None] + si.reshape(-1)).reshape(-1)
    h = (h0[:, None] + sr.reshape(-1)).reshape(-1)
    w = (w0[:, None] + sc.reshape(-1)).reshape(-1)
    ok = (b < B) & (h < H) & (w < W)
    count = np.zeros((B, H, W), dtype=np.int64)
    np.add.at(count, (b[ok], h[ok], w[ok]), 1)
    return np.broadcast_to(count, (slices, B, H, W)), most, rounds


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_fwd_plans_cover_every_output_once(shape):
    """At any number of blocks an SM holds, every output pixel of every
    column slice lies in exactly one tile of exactly one block of its unit,
    no block walks more tiles than the plan's rounds (the first walks that
    many), a tile holds at most its slots and the stem's halo at most
    STEM_HALO pixels, and the shared memory stays within the 227 KB a block
    may use."""
    L, B, H, W, ci, co = shape
    imgs, rb, cb, _, _ = C.fwd_tc_geometry(B, H, W, ci, co)
    stem = (ci, co) == C.STEM_CHANNELS
    slots = C.STEM_SLOTS if stem else C.FWD_TC_TILES[ci][0]
    assert imgs * rb * cb <= slots and (cb == W or rb == 1) and (rb == H or imgs == 1)
    if stem:
        assert imgs * (rb + 2) * (cb + 2) <= C.STEM_HALO
    for per_sm in (1, 2, 3, 8):
        count, most, rounds = _covered(L, B, H, W, ci, co, 132, per_sm)
        assert (count == 1).all()
        assert most == rounds


def test_fwd_plan_fills_the_card_at_one_lane():
    """ResNet-56's last stage at one lane, (1, 64, 8, 8, 64, 64), launches at
    least 128 blocks (a 64-slot tile per image, two column slices), even
    at one block an SM; the stem at least one block a tile row group."""
    for per_sm in (1, 2, 3):
        assert C.fwd_tc_plan(1, 64, 8, 8, 64, 64, 132, per_sm)[0] >= 128
    assert C.fwd_tc_geometry(64, 8, 8, 64, 64)[:4] == (1, 8, 8, 64)
    assert C.fwd_tc_plan(1, 64, 32, 32, 3, 16, 132, 4)[:2] == (512, 1)


def _bf16_values(shape, rng, scale=1.0):
    """A float32 tensor holding bf16 values."""
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(BF).float()


def _taps(x):
    """x (B, H, W, Ci) -> (B H W, 9, Ci): each pixel's nine taps in (dy, dx)
    order, zero outside the image."""
    B, H, W, ci = x.shape
    return C.extract_patches(x, 3, 3, 1, "SAME").reshape(B * H * W, 9, ci)


def emulate_stem(x, w, drop_kstep=False):
    """The stem kernel's sums, float32 before the rounding: x (B, H, W, 3),
    w (3, 3, 3, 16) holding bf16 values; k = 3 tap + ci padded with zeros to
    32, two 16-deep k-steps into one accumulator from zero."""
    B, H, W, ci = x.shape
    a = F.pad(_taps(x).reshape(-1, 9 * ci), (0, 32 - 9 * ci))
    b = F.pad(w.reshape(9 * ci, -1), (0, 0, 0, 32 - 9 * ci))
    acc = torch.zeros(a.shape[0], b.shape[1])
    for s in range(1 if drop_kstep else 2):
        acc = acc + a[:, 16 * s:16 * s + 16] @ b[16 * s:16 * s + 16]
    return acc.reshape(B, H, W, -1)


def emulate_cut(x, w, ns=32, drop_kstep=None, shift=0):
    """The Ci-64 kernel's sums, float32 before the rounding: each block's
    ``ns``-column slice of y summed over the taps in order, each tap's
    16-channel k-steps in order, into one accumulator from zero. Faults:
    ``drop_kstep`` = (tap, k-step) left out; ``shift`` columns by which each
    slice reads its neighbour's w."""
    B, H, W, ci = x.shape
    co = w.shape[-1]
    a = _taps(x)
    y = torch.zeros(a.shape[0], co)
    for n0 in range(0, co, ns):
        cols = (torch.arange(ns) + n0 + shift) % co
        acc = torch.zeros(a.shape[0], ns)
        for tap in range(9):
            for ks in range(ci // 16):
                if (tap, ks) == drop_kstep:
                    continue
                k = slice(16 * ks, 16 * ks + 16)
                acc = acc + a[:, tap, k] @ w[tap // 3, tap % 3, k][:, cols]
        y[:, n0:n0 + ns] = acc
    return y.reshape(B, H, W, co)


def _exact(x, w):
    """(y, magnitudes) of one lane in float64: patches(x) @ w."""
    ci = x.shape[-1]

    def f(a, b):
        p = C.extract_patches(a.double(), 3, 3, 1, "SAME")
        return p @ b.double().reshape(9 * ci, -1)

    return f(x, w), f(x.abs(), w.abs())


def _gate(got, want, mag):
    """(passes, share off, largest difference in bf16 steps) of bf16 ``got``
    against ``want`` rounded to bf16: every output within one step (at the
    larger value) plus CONV_TOL of its magnitude, at most
    CONV_MISMATCH_SHARE of them (or CONV_MISMATCH_FLOOR) off at all."""
    got, want = got.to(BF).float(), want.float().to(BF).float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    step = torch.ldexp(torch.ones_like(got), e - 8)
    diff = (got - want).abs()
    off = (diff > 0).sum().item()
    ok = bool((diff <= step + CONV_TOL * mag.float()).all()) and off <= max(
        CONV_MISMATCH_SHARE * got.numel(), CONV_MISMATCH_FLOOR)
    return ok, off / got.numel(), (diff / step).max().item()


# (B, H, W, Ci, Co) emulated against float64: both routes' shapes at a few
# images, and ragged ones
EMULATED = ((4, 32, 32, 3, 16), (3, 7, 9, 3, 16), (16, 8, 8, 64, 64), (2, 5, 13, 64, 64))


@pytest.mark.parametrize("B,H,W,ci,co", EMULATED)
def test_emulated_kernels_within_the_bf16_gate(B, H, W, ci, co):
    """The emulated kernel against float64: within float32 summation noise
    of the magnitudes, and inside the card's bf16 gate; a dropped k-step or
    a shifted column slice fails the gate."""
    rng = np.random.default_rng(B * H + ci)
    x, w = _bf16_values((B, H, W, ci), rng), _bf16_values((3, 3, ci, co), rng, 0.3)
    exact, mag = _exact(x, w)
    emulate = emulate_stem if ci == 3 else emulate_cut
    got = emulate(x, w)
    assert ((got.double() - exact).abs() / mag).max().item() <= 1e-6
    assert _gate(got, exact, mag)[0]
    faults = ([emulate_stem(x, w, drop_kstep=True)] if ci == 3 else
              [emulate_cut(x, w, drop_kstep=(4, 3)), emulate_cut(x, w, shift=16)])
    for bad in faults:
        assert not _gate(bad, exact, mag)[0]


@pytest.fixture()
def interp_pallas(monkeypatch):
    import jax
    from jax.experimental import pallas as pl

    jax.config.update("jax_default_matmul_precision", "highest")
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("B,H,W,ci,co", [(2, 32, 32, 3, 16), (2, 8, 8, 64, 64)])
def test_emulated_kernels_match_conv2d_pallas(interp_pallas, B, H, W, ci, co):
    """The emulated kernel, rounded to bf16, against the JAX package's
    conv2d_pallas on the same bf16 operands (float32 products and sums by
    preferred_element_type, one rounding to bf16): inside the bf16 gate;
    the planted faults are not."""
    import jax.numpy as jnp

    from fedml_tpu.ops.conv import conv2d_pallas

    rng = np.random.default_rng(ci)
    x, w = _bf16_values((B, H, W, ci), rng), _bf16_values((3, 3, ci, co), rng, 0.3)
    jy = conv2d_pallas(jnp.asarray(x.numpy()).astype(jnp.bfloat16),
                       jnp.asarray(w.numpy()).astype(jnp.bfloat16))
    assert jy.dtype == jnp.bfloat16
    want = torch.from_numpy(np.array(jy.astype(jnp.float32)))
    mag = _exact(x, w)[1]
    if ci == 3:
        got, faults = emulate_stem(x, w), [emulate_stem(x, w, drop_kstep=True)]
    else:
        got, faults = emulate_cut(x, w), [emulate_cut(x, w, drop_kstep=(0, 0)),
                                          emulate_cut(x, w, shift=16)]
    assert _gate(got, want, mag)[0]
    for bad in faults:
        assert not _gate(bad, want, mag)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("L,B,H,W,ci,co", [(1, 64, 32, 32, 3, 16), (10, 64, 32, 32, 3, 16),
                                           (1, 64, 8, 8, 64, 64), (10, 64, 8, 8, 64, 64),
                                           (3, 5, 7, 9, 3, 16), (3, 2, 5, 300, 64, 64)])
def test_tc_fwd_matches_plain_on_card(L, B, H, W, ci, co):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator().manual_seed(2)
    x = torch.randn(L, B, H, W, ci, generator=g).to("cuda", BF)
    w = (torch.randn(L, 3, 3, ci, co, generator=g) * 0.3).to("cuda", BF)
    route = C.fwd_route(ci, co, BF)
    before = C.conv3x3_lanes.route_launches[route]
    y = C.conv3x3_lanes(x, w)
    assert C.conv3x3_lanes.route_launches[route] == before + 1
    want = C.conv3x3_plain(x.float(), w.float())
    mag = C.conv3x3_plain(x.float().abs(), w.float().abs())
    assert _gate(y.float().cpu(), want.cpu(), mag.cpu())[0]
    assert torch.equal(y, C.conv3x3_lanes(x, w))
    plan = C.fwd_tc_plan_on_card(L, B, H, W, ci, co)
    assert plan[:3] == C.fwd_tc_plan(L, B, H, W, ci, co, *plan[3:])
