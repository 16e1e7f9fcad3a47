"""The float32 conv stem (3 -> 16) on the tensor cores (route ``stem_tf32x3``
of ``fedml_tpu_torch/ops/conv.py``; ``conv3x3_stem_tf32_kernel`` of
``fedml_tpu_torch/csrc/conv3x3_sm90.cu``), held on the CPU.

The kernel runs only on the card. Here its arithmetic is written out in
float32 torch as the kernel orders it: each output pixel's 27-deep
contraction in (tap, channel) order, k = 3 tap + ci, padded with zeros to 32
(the halo pixel's zero channel 3 against w's zero rows 27-31), as four
8-deep k-steps into one accumulator from zero, each k-step as three TF32
products, lo hi, hi lo and hi hi, from the split hi = cvt.rna.tf32(v), lo =
v - hi (``tests/test_torch_conv.py``'s ``_split``). The tensor core's own
order inside one product is not reproduced: each is one float32 matrix
product here. The emulation is held against float64 and against the JAX
package's ``conv2d_pallas`` in Pallas interpret mode under ``jax.vmap``
over lanes, within ``CONV_TOL`` of the magnitudes (chip_smoke.py's gate);
planted faults (a k-step dropped, the lo hi term dropped, the padding not
zero) fail it. The launch plan, the bf16 stem's tiles, covers every output
once at the paths' shapes through the ``fwd_tc_geometry`` mirror. The
``cuda``-marked cases hold the kernel to the plain version on the card; this
file imports JAX only inside the test that compares with it.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu_torch.ops import conv as C
from test_torch_conv_fwd_bf16_tc import _covered

F32 = torch.float32
CONV_TOL = 1e-5  # chip_smoke.py's gate: |y - plain| / (the product on |x|, |w|)
K, KPAD, KSTEP = 27, 32, 8  # the stem's contraction, padded, and an mma k-step

# the sound arithmetic and its planted faults
FAULTS = ("sound", "kstep_dropped", "lo_hi_dropped", "padding_not_zero")


def _split(t):
    """The kernel's split (tests/test_torch_conv.py's, restated here so that
    this file imports no JAX at its top): hi = cvt.rna.tf32(v), rounding the
    float32 bits at mantissa bit 13 with ties away from zero, and lo = v -
    hi, both as the tensor core reads them (the low 13 bits dropped)."""
    hi = ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    lo = ((t - hi).contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)
    return hi, lo


def emulate_stem(x, w, fault="sound"):
    """The kernel's output, x (L, B, H, W, 3) and w (L, 3, 3, 3, 16) float32
    -> (L, B, H, W, 16): per lane the (pixels, 32) patch matrix and w as (32,
    16), both padded with zeros past k = 27, four k-steps of lo hi + hi lo +
    hi hi into one accumulator from zero. ``fault``: ``kstep_dropped`` leaves
    k-step 1 out, ``lo_hi_dropped`` the lo hi product, ``padding_not_zero``
    fills the padded k of both operands (a halo whose channel 3 is not
    zero, w read past its 27 rows)."""
    L, B, H, W, ci = x.shape
    co = w.shape[-1]
    p = C.extract_patches(x.reshape(L * B, H, W, ci), 3, 3, 1, "SAME").reshape(L, -1, K)
    a = F.pad(p, (0, KPAD - K))
    b = F.pad(w.reshape(L, K, co), (0, 0, 0, KPAD - K))
    if fault == "padding_not_zero":
        a[..., K:] = 1.0
        b[:, K:] = w.reshape(L, K, co)[:, :KPAD - K]
    y = torch.zeros(L, a.shape[1], co)
    for s in range(KPAD // KSTEP):
        if fault == "kstep_dropped" and s == 1:
            continue
        k = slice(KSTEP * s, KSTEP * s + KSTEP)
        (ah, al), (bh, bl) = _split(a[..., k]), _split(b[:, k])
        if fault != "lo_hi_dropped":
            y = y + al @ bh
        y = y + ah @ bl
        y = y + ah @ bh
    return y.reshape(L, B, H, W, co)


def _inputs(shape, seed):
    """x (L, B, H, W, 3) and w (L, 3, 3, 3, 16) float32 numpy, w scaled as
    chip_smoke.py scales it."""
    L, B, H, W, ci, co = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((L, B, H, W, ci), dtype=np.float32),
            rng.standard_normal((L, 3, 3, ci, co), dtype=np.float32) * np.float32(0.3))


def _err(got, want, x, w):
    """|got - want| / (the product on |x|, |w|), the largest over outputs."""
    mag = C.conv3x3_plain(x.abs().double(), w.abs().double())
    return ((got.double() - want.double()).abs() / mag.clamp_min(1e-30)).max().item()


def _hold(err, fault):
    if fault == "sound":
        assert err <= CONV_TOL, err
    else:
        assert err > CONV_TOL, err


# (L, B, H, W, Ci, Co) emulated against float64: the packed path's lanes at
# a few images, a ragged image and DP-SGD's many one-image lanes
EXACT_SHAPES = ((1, 4, 32, 32, 3, 16), (2, 3, 7, 9, 3, 16), (16, 1, 32, 32, 3, 16))


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("shape", EXACT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_stem_tf32x3_arithmetic_within_conv_tol(shape, fault):
    """The emulated kernel against float64 patches @ w: within CONV_TOL of
    the magnitudes when sound; each planted fault fails it."""
    x, w = (torch.from_numpy(a) for a in _inputs(shape, sum(shape)))
    exact = C.conv3x3_plain(x.double(), w.double())
    _hold(_err(emulate_stem(x, w, fault), exact, x, w), fault)


@pytest.fixture()
def interp_pallas(monkeypatch):
    import jax
    from jax.experimental import pallas as pl

    jax.config.update("jax_default_matmul_precision", "highest")
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("fault", FAULTS)
def test_stem_tf32x3_arithmetic_matches_conv2d_pallas(interp_pallas, fault):
    """At the stem's shape with lanes, (2, 2, 32, 32, 3, 16), the emulated
    kernel against the JAX package's conv2d_pallas under jax.vmap over the
    lanes (one weight set a lane, as the simulator runs it): within
    CONV_TOL of the magnitudes when sound; each planted fault fails it."""
    import jax
    import jax.numpy as jnp

    from fedml_tpu.ops.conv import conv2d_pallas

    x, w = _inputs((2, 2, 32, 32, 3, 16), seed=3)
    jy = jax.vmap(lambda a, b: conv2d_pallas(a, b, 1, "SAME"))(jnp.asarray(x), jnp.asarray(w))
    want = torch.from_numpy(np.array(jy))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    _hold(_err(emulate_stem(tx, tw, fault), want, tx, tw), fault)


# the stem's launch shapes on the paths: ResNet-56's packed L = 1 and 2 and
# even L = 10 at batch 64, the eval's (1, 256), resnet8's DP-SGD at 128
# one-image lanes (cohort 4 x batch 32 under two vmap levels), ragged ones
PLAN_SHAPES = ((1, 64, 32, 32, 3, 16), (2, 64, 32, 32, 3, 16), (10, 64, 32, 32, 3, 16),
               (1, 256, 32, 32, 3, 16), (128, 1, 32, 32, 3, 16), (3, 5, 7, 9, 3, 16),
               (2, 3, 5, 300, 3, 16), (2, 7, 1, 1, 3, 16))


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_stem_tf32_plan_covers_every_output_once(shape):
    """The float32 stem walks the bf16 stem's tiles (stem_geometry, mirrored
    by fwd_tc_geometry): at any number of blocks an SM holds, every output
    pixel lies in exactly one tile of exactly one block of its lane, no
    block walks more tiles than the plan's rounds, and the halo stays within
    STEM_HALO pixels, in the float32 stem's shared memory (16-byte pixels,
    w as 32 x 16 floats)."""
    L, B, H, W, ci, co = shape
    imgs, rb, cb, _, nbytes = C.fwd_tc_geometry(B, H, W, ci, co, F32)
    assert imgs * rb * cb <= C.STEM_SLOTS and imgs * (rb + 2) * (cb + 2) <= C.STEM_HALO
    assert nbytes == C.STEM_SMEM[F32] == 2 * C.STEM_HALO * 16 + KPAD * co * 4
    assert C.fwd_tc_geometry(B, H, W, ci, co)[:4] == (imgs, rb, cb, _)
    for per_sm in (1, 4, 8):
        count, most, rounds = _covered(L, B, H, W, ci, co, 132, per_sm)
        assert (count == 1).all() and most == rounds
        assert C.fwd_tc_plan(L, B, H, W, ci, co, 132, per_sm, F32)[2] == nbytes


@pytest.mark.parametrize("ci,co,dtype,route", [
    (3, 16, F32, "stem_tf32x3"), (3, 16, torch.bfloat16, "stem_bf16"),
    (5, 7, F32, "fma"), (3, 8, F32, "fma"), (4, 16, F32, "fma"), (16, 3, F32, "fma"),
    (5, 7, torch.bfloat16, "fma_bf16"), (16, 16, F32, "tf32x3")])
def test_stem_routes(ci, co, dtype, route):
    """The float32 stem goes to its tensor-core kernel at every lane count
    and batch (the route takes no shape), the bf16 stem stays on its own,
    ragged float32 channels stay on the FMA kernel; the stem's dw
    stays on the FMA kernel in both dtypes; a stem route refuses other
    channels before any launch."""
    assert C.fwd_route(ci, co, dtype) == route
    assert C.ROUTE_DTYPE[route] == dtype
    assert C.FWD_ROUTES[route] == (("conv3x3_sm90", "fedml_conv3x3_stem_sm90")
                                   if route == "stem_tf32x3" else C.FWD_ROUTES[route])
    if (ci, co) == C.STEM_CHANNELS:
        assert C.dw_route(ci, co, dtype) == ("fma" if dtype == F32 else "fma_bf16")
    x = torch.zeros(1, 1, 4, 4, 5)
    with pytest.raises(ValueError, match="channels"):
        C.conv3x3_fwd_route(x, torch.zeros(1, 3, 3, 5, 16), "stem_tf32x3")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 64, 32, 32, 3, 16), (2, 64, 32, 32, 3, 16),
                                   (10, 64, 32, 32, 3, 16), (1, 256, 32, 32, 3, 16),
                                   (128, 1, 32, 32, 3, 16), (3, 5, 7, 9, 3, 16)],
                         ids=lambda s: "x".join(map(str, s)))
def test_stem_tf32_matches_plain_on_card(shape):
    """On the card, the float32 stem against the plain version within
    CONV_TOL of the magnitudes, bit-repeatable, one launch on its route,
    and its launch plan the mirror's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    L, B, H, W, ci, co = shape
    x, w = (torch.from_numpy(a).cuda() for a in _inputs(shape, seed=5))
    before = C.conv3x3_lanes.route_launches["stem_tf32x3"]
    y = C.conv3x3_lanes(x, w)
    assert C.conv3x3_lanes.route_launches["stem_tf32x3"] == before + 1
    assert _err(y, C.conv3x3_plain(x, w), x, w) <= CONV_TOL
    assert torch.equal(y, C.conv3x3_lanes(x, w))
    plan = C.fwd_tc_plan_on_card(L, B, H, W, ci, co, dtype=F32)
    assert plan[:3] == C.fwd_tc_plan(L, B, H, W, ci, co, *plan[3:], F32)
