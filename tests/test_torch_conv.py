"""Port vs JAX package: the multi-weight 3x3 conv (``ops/conv.py``).

The port's ``conv3x3`` (on the CPU its plain version, through the same
autograd/vmap plumbing that launches the CUDA kernels on the card) is held
against the JAX ``conv2d_pallas`` run in Pallas interpret mode and against
``lax.conv_general_dilated``: forward, dx and dw, ragged channels and odd
sizes, and ``vmap(grad)`` over per-lane x and w and with w unbatched.
The CUDA kernels are held to the plain versions on the card (``cuda``
marker; skips without one).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

jax.config.update("jax_default_matmul_precision", "highest")

from fedml_tpu.ops import conv as jconv  # noqa: E402
from fedml_tpu_torch.ops import conv as tconv  # noqa: E402

# f32 sums of <= 9*Ci*... terms in another order than XLA's: ~1e-6 of the
# magnitudes; absolute tolerances below are for O(1) inputs
FWD_ATOL = 1e-5
GRAD_RTOL = 1e-5


@pytest.fixture()
def interp_pallas(monkeypatch):
    from jax.experimental import pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _lax(x, w, s=1, pad="SAME"):
    return jax.lax.conv_general_dilated(x, w, (s, s), pad,
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))


def _inputs(seed, *shape_x_w):
    rng = np.random.default_rng(seed)
    (b, h, w, ci, co) = shape_x_w
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    k = (rng.standard_normal((3, 3, ci, co)) * 0.3).astype(np.float32)
    return x, k


def _close(got, want, rtol):
    """|got - want| within rtol of want's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


SHAPES = [(2, 8, 8, 5, 7), (2, 7, 9, 3, 16), (1, 5, 6, 16, 16), (3, 4, 4, 32, 8)]


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_pallas_and_lax(interp_pallas, shape):
    x, k = _inputs(0, *shape)
    want_p = jconv.conv2d_pallas(jnp.asarray(x), jnp.asarray(k), 1, "SAME")
    want_l = _lax(jnp.asarray(x), jnp.asarray(k))
    got = tconv.conv3x3(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want_p, atol=FWD_ATOL)
    np.testing.assert_allclose(got, want_l, atol=FWD_ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_dx_and_dw_match_pallas_and_lax(interp_pallas, shape):
    x, k = _inputs(1, *shape)

    def jloss(conv):
        return lambda x, w: (conv(x, w) ** 2).sum()

    jp = jax.grad(jloss(lambda x, w: jconv.conv2d_pallas(x, w, 1, "SAME")), (0, 1))(
        jnp.asarray(x), jnp.asarray(k))
    jl = jax.grad(jloss(_lax), (0, 1))(jnp.asarray(x), jnp.asarray(k))
    tx = torch.from_numpy(x).requires_grad_()
    tk = torch.from_numpy(k).requires_grad_()
    (tconv.conv3x3(tx, tk) ** 2).sum().backward()
    for got, want_p, want_l in zip((tx.grad, tk.grad), jp, jl):
        _close(got.numpy(), want_p, GRAD_RTOL)
        _close(got.numpy(), want_l, GRAD_RTOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3, 4, 1, 1), (2, 8, 8, 3, 4, 1, 2),
                                   (2, 9, 9, 4, 6, 3, 2), (2, 8, 8, 16, 32, 3, 2),
                                   (2, 11, 11, 2, 3, 5, 2), (2, 10, 10, 4, 4, 3, 1)])
def test_im2col_matches_jax(shape):
    b, h, w, ci, co, ksz, s = shape
    rng = np.random.default_rng(2)
    x = rng.standard_normal((b, h, w, ci)).astype(np.float32)
    k = (rng.standard_normal((ksz, ksz, ci, co)) * 0.3).astype(np.float32)
    want = jconv.conv2d_im2col(jnp.asarray(x), jnp.asarray(k), s, "SAME")
    got = tconv.conv2d_im2col(torch.from_numpy(x), torch.from_numpy(k), s, "SAME").numpy()
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)
    np.testing.assert_allclose(got, _lax(jnp.asarray(x), jnp.asarray(k), s), atol=FWD_ATOL)


@pytest.mark.parametrize("w_batched", [True, False])
def test_vmap_grad_matches_jax_pallas(interp_pallas, w_batched):
    """The simulator's case: vmap over clients of grad, with per-lane x and
    w (every later step) or one shared w (the first step); dw per lane."""
    L = 3
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((L, 2, 6, 7, 16)).astype(np.float32)
    ws = (rng.standard_normal((L, 3, 3, 16, 5)) * 0.3).astype(np.float32)
    if not w_batched:
        ws = ws[0]
    w_dim = 0 if w_batched else None

    def jloss(w, x):
        return (jconv.conv2d_pallas(x, w, 1, "SAME") ** 2).sum()

    def tloss(w, x):
        return (tconv.conv3x3(x, w) ** 2).sum()

    jg = jax.vmap(jax.grad(jloss, (0, 1)), in_axes=(w_dim, 0))(jnp.asarray(ws), jnp.asarray(xs))
    tg = vmap(grad(tloss, argnums=(0, 1)), in_dims=(w_dim, 0))(torch.from_numpy(ws),
                                                                torch.from_numpy(xs))
    assert tuple(tg[0].shape) == (L, 3, 3, 16, 5)
    for got, want in zip(tg, jg):
        _close(got.numpy(), want, GRAD_RTOL)


@pytest.mark.parametrize("w_batched", [True, False])
def test_nested_vmap_per_example_grads_equal_a_loop(monkeypatch, w_batched):
    """DP-SGD's case: per-example gradients (vmap over the batch of grad)
    inside the cohort vmap, through a two-layer conv stack. Every kernel
    wrapper call receives plain lane-stacked tensors with the two vmap
    levels folded into one lane axis (cohort x examples), never a batched
    tensor (which the CUDA launch cannot take); the gradients equal a
    Python loop over clients and examples (through the plain versions on
    the CPU; the kernels' side is chip_smoke.py's algorithms phase)."""
    import torch._C._functorch as functorch

    C, B = 3, 4
    rng = np.random.default_rng(7)
    xs = torch.from_numpy(rng.standard_normal((C, B, 5, 6, 4)).astype(np.float32))
    w1 = torch.from_numpy((rng.standard_normal((C, 3, 3, 4, 16)) * 0.3).astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((C, 3, 3, 16, 16)) * 0.3).astype(np.float32))
    if not w_batched:
        w1, w2 = w1[0], w2[0]
    calls = []

    def spying(fn):
        def wrapped(a, b):
            assert not functorch.is_batchedtensor(a) and not functorch.is_batchedtensor(b)
            calls.append(a.shape[0])
            return fn(a, b)
        return staticmethod(wrapped)

    monkeypatch.setattr(tconv._Conv3x3Lanes, "kernel", spying(tconv.conv3x3_lanes))
    monkeypatch.setattr(tconv._Conv3x3DwLanes, "kernel", spying(tconv.conv3x3_dw_lanes))

    def loss(w, x1):
        h = torch.tanh(tconv.conv3x3(x1[None], w[0]))
        return (tconv.conv3x3(h, w[1]) ** 2).sum()

    w_dim = 0 if w_batched else None
    per_example = vmap(grad(loss), in_dims=(None, 0))
    got = vmap(per_example, in_dims=(w_dim, 0))((w1, w2), xs)
    assert calls and set(calls) == {C * B}
    for c in range(C):
        wc = (w1[c], w2[c]) if w_batched else (w1, w2)
        for b in range(B):
            def plain(w):
                h = torch.tanh(tconv.conv3x3_plain(xs[c, b][None, None], w[0][None])[0])
                return (tconv.conv3x3_plain(h[None], w[1][None]) ** 2).sum()
            want = grad(plain)(wc)
            for g, wv in zip(got, want):
                _close(g[c, b].numpy(), wv.numpy(), GRAD_RTOL)


def test_lanes_wrappers_take_a_broadcast_lane():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 2, 5, 5, 4)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1, 3, 3, 4, 6)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((3, 2, 5, 5, 6)).astype(np.float32))
    got = tconv.conv3x3_lanes(x, w.expand(3, 3, 3, 4, 6))
    for lane in range(3):
        torch.testing.assert_close(got[lane], tconv.conv3x3(x[lane], w[0]))
    dw = tconv.conv3x3_dw_lanes(x[:1].expand(3, 2, 5, 5, 4), dy)
    torch.testing.assert_close(dw[2], tconv.conv3x3_dw_lanes(x[:1], dy[2:]).squeeze(0))
    with pytest.raises(ValueError):
        tconv.conv3x3_lanes(x, w)  # lane counts differ


def test_conv_module_dispatch(monkeypatch):
    """impl='pallas' sends 3x3/s1/SAME to conv3x3 and nothing else; every
    impl computes the same conv from the same ``kernel``."""
    seen = []
    real = tconv.conv3x3
    monkeypatch.setattr(tconv, "conv3x3", lambda x, w: seen.append(tuple(w.shape)) or real(x, w))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 8, 8, 4)).astype(np.float32))
    for ksz, s in ((3, 1), (3, 2), (1, 1), (1, 2)):
        outs = []
        for impl in tconv.IMPLS:
            m = tconv.Conv(4, 6, (ksz, ksz), s, impl=impl)
            torch.manual_seed(0)
            torch.nn.init.normal_(m.kernel)
            outs.append(m(x).detach())
        for o in outs[1:]:
            torch.testing.assert_close(o, outs[0], rtol=1e-5, atol=1e-5)
    assert seen == [(3, 3, 4, 6)]
    with pytest.raises(ValueError):
        tconv.Conv(4, 6, impl="cudnn")


@pytest.mark.parametrize("L,P,ci,co", [(10, 65536, 3, 16), (10, 65536, 16, 16),
                                       (10, 16384, 32, 32), (10, 4096, 64, 64),
                                       (3, 315, 5, 7), (1, 1, 1, 1), (1, 65536, 8, 100)])
def test_dw_split_plan_covers_the_contraction(L, P, ci, co):
    """Spans are whole slices of the block's tile and cover every pixel once;
    the tiles cover every (k, n) of dw; the block has 256 or 288 threads and
    the grid never exceeds TARGET_BLOCKS (whole waves) unless one span per
    tile already does."""
    rows, cols, threads, sl = tconv.dw_tile(ci, co)
    assert rows % 16 == 0 and cols % 16 == 0 and threads in (256, 288) and threads % sl == 0
    assert cols >= min(co, 64) and cols == tconv.block_cols(co)
    span, splits = tconv.dw_split_plan(L, P, ci, co)
    assert span % sl == 0 and 1 <= splits <= 65535
    assert (splits - 1) * span < P <= splits * span
    tiles = -(-9 * ci // rows) * -(-co // cols)
    blocks = L * tiles * splits
    assert blocks <= max(tconv.TARGET_BLOCKS, L * tiles)


# (Ci, Co) of ResNet-56's weight gradients: the stem, then each stage
RESNET56_DW = ((3, 16), (16, 16), (32, 32), (64, 64))


@pytest.mark.parametrize("ci,co", RESNET56_DW)
def test_dw_tile_fits_the_contraction_at_resnet56_shapes(ci, co):
    """The dw block's rows are sized to 9 Ci: under 25% of the rows it
    computes are padding (the stem's 27 in 32; 144, 288 and 576 in whole
    144-row tiles)."""
    rows, cols, _, _ = tconv.dw_tile(ci, co)
    k = 9 * ci
    computed = -(-k // rows) * rows
    assert (computed - k) / computed < 0.25
    assert cols == co  # and no padding columns


def test_wrappers_refuse_other_devices():
    x = torch.ones(1, 2, 4, 4, 3, device="meta")
    with pytest.raises(ValueError):
        tconv.conv3x3_lanes(x, torch.ones(1, 3, 3, 3, 4, device="meta"))
    with pytest.raises(ValueError):
        tconv.conv3x3_dw_lanes(x, torch.ones(1, 2, 4, 4, 4, device="meta"))


# |kernel - plain| / (the same product on |x|, |w|): each output is a sum of
# at most 9*Ci (forward) or B*H*W (dw) fp32 products in another order; the
# rounding of each partial sum is at most 6e-8 of the magnitudes, and the
# H100 measured <= 3.1e-7. 1e-5 leaves margin yet catches a wrong tap or
# channel, which errs by O(1) of the magnitude.
CARD_TOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("L,B,H,W,ci,co", [(10, 64, 32, 32, 3, 16), (10, 64, 32, 32, 16, 16),
                                           (10, 64, 16, 16, 32, 32), (10, 64, 8, 8, 64, 64),
                                           (1, 256, 8, 8, 64, 64), (3, 5, 7, 9, 5, 7)])
def test_conv_kernels_match_plain_on_card(L, B, H, W, ci, co):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(L, B, H, W, ci, generator=g).cuda()
    w = torch.randn(L, 3, 3, ci, co, generator=g).cuda()
    dy = torch.randn(L, B, H, W, co, generator=g).cuda()
    y = tconv.conv3x3_lanes(x, w)
    mag = tconv.conv3x3_plain(x.abs(), w.abs())
    assert ((y - tconv.conv3x3_plain(x, w)).abs() / mag).max().item() < CARD_TOL
    assert torch.equal(y, tconv.conv3x3_lanes(x, w))  # no atomics on either route
    dw = tconv.conv3x3_dw_lanes(x, dy)
    mag = tconv.conv3x3_dw_plain(x.abs(), dy.abs())
    assert ((dw - tconv.conv3x3_dw_plain(x, dy)).abs() / mag).max().item() < CARD_TOL
    assert torch.equal(dw, tconv.conv3x3_dw_lanes(x, dy))  # fixed-order reduction


# (Ci, Co, route) of every stride-1 3x3 conv shape of ResNet-56 and its dx:
# the stem (its dx is never taken), the three block widths (forward and dx
# alike, also at the eval batch), and a ragged shape
RESNET56_ROUTES = ((3, 16, "stem_tf32x3"), (16, 16, "tf32x3"), (32, 32, "tf32x3"),
                   (64, 64, "tf32x3"), (5, 7, "fma"), (16, 32, "fma"), (48, 48, "fma"))


@pytest.mark.parametrize("ci,co,route", RESNET56_ROUTES)
def test_fwd_route_by_channels(ci, co, route):
    """ResNet's block convs (and so their dx, the same Ci = Co) run on the
    tensor-core kernel, the stem on its own tensor-core kernel; ragged and
    unequal widths on the FMA one."""
    assert tconv.fwd_route(ci, co) == route
    assert tconv.FWD_ROUTES[route][0] in ("conv3x3_sm90", "conv3x3")


# (Ci, Co, route) of the same shapes in bfloat16 (use_bf16): the stem on its
# own tensor-core kernel, the block convs on the bf16_tc kernels, ragged and
# unequal widths on the FMA kernel's bf16 form
RESNET56_ROUTES_BF16 = ((3, 16, "stem_bf16"), (16, 16, "bf16_tc"), (32, 32, "bf16_tc"),
                        (64, 64, "bf16_tc"), (5, 7, "fma_bf16"), (16, 32, "fma_bf16"),
                        (48, 48, "fma_bf16"))


@pytest.mark.parametrize("ci,co,route", RESNET56_ROUTES_BF16)
def test_fwd_route_by_channels_bf16(ci, co, route):
    """bf16: the stem's 3 -> 16 and the block convs on the tensor cores of
    conv3x3_sm90.cu, the rest on conv3x3.cu's FMA kernel; the float32 stem
    has a tensor-core kernel of its own beside the bf16 one."""
    assert tconv.fwd_route(ci, co, torch.bfloat16) == route
    assert tconv.ROUTE_DTYPE[route] == torch.bfloat16
    assert tconv.FWD_ROUTES[route][0] == ("conv3x3" if route == "fma_bf16" else "conv3x3_sm90")
    assert tconv.fwd_route(3, 16) == "stem_tf32x3"


def _tf32_rna(t):
    """cvt.rna.tf32.f32 on the CPU: round the float32 bit pattern at
    mantissa bit 13, ties away from zero (add half of the dropped unit to
    the magnitude, then clear the 13 bits)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_read(t):
    """A float32 register read as a TF32 operand: the tensor core drops the
    low 13 mantissa bits."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(t):
    """The kernel's split: hi = cvt.rna.tf32(v), lo = v - hi (exact in
    float32), both as the tensor core reads them."""
    hi = _tf32_rna(t)
    return hi, _tf32_read(t - hi)


def _conv3x3_tf32x3_emulated(x, w, terms=3):
    """The kernel's arithmetic: x and w split into TF32 hi + lo, per tap the
    products lo hi, hi lo, hi hi (each exact in float32) summed from zero,
    the nine tap sums added in float32 in tap order. ``terms=1`` keeps only
    hi hi (one rounded TF32 product, no split)."""
    L, B, H, W, ci = x.shape
    co = w.shape[-1]
    p = tconv.extract_patches(x.reshape(L * B, H, W, ci), 3, 3, 1, "SAME")
    p = p.reshape(L, B * H * W, 9, ci)
    wt = w.reshape(L, 9, ci, co)
    y = torch.zeros(L, B * H * W, co)
    for tap in range(9):
        (ah, al), (bh, bl) = _split(p[:, :, tap]), _split(wt[:, tap])
        prods = (torch.matmul(al, bh), torch.matmul(ah, bl), torch.matmul(ah, bh))
        s = torch.zeros_like(y)
        for q in prods[3 - terms:]:
            s = s + q
        y = y + s
    return y.reshape(L, B, H, W, co)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    v = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2), 1.0 + one_ulp / 4,
                      1.0 + 3 * one_ulp / 4, 3.0], dtype=torch.float32)
    got = _tf32_rna(v)
    want = torch.tensor([1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + one_ulp, 3.0])
    assert torch.equal(got, want)
    v = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    hi, lo = _split(v)
    for t in (hi, lo):
        assert torch.equal(t.view(torch.int32) & 0x1FFF, torch.zeros(1000, dtype=torch.int32))
    # hi + lo is v to 2^-21 of |v|: lo = v - hi exactly, then read to TF32
    assert ((hi + lo - v).abs() <= 2.0 ** -21 * v.abs()).all()


# the ResNet-56 block shapes at B = 2 (one lane): (B, H, W, Ci, Co)
RESNET56_BLOCKS_B2 = ((2, 32, 32, 16, 16), (2, 16, 16, 32, 32), (2, 8, 8, 64, 64))
CONV_TOL = 1e-5  # chip_smoke.py's gate: |y - plain| / (the product on |x|, |w|)


@pytest.mark.parametrize("shape", RESNET56_BLOCKS_B2)
def test_tf32x3_split_within_conv_tol(interp_pallas, shape):
    """The exactness argument of csrc/conv3x3_sm90.cu, emulated on the CPU:
    the 3xTF32 per-tap sum is within CONV_TOL of the magnitudes from the
    plain version and from the JAX package's conv2d_pallas, while one
    unsplit TF32 product is not."""
    x, k = _inputs(7, *shape)
    tx, tk = torch.from_numpy(x)[None], torch.from_numpy(k)[None]
    mag = tconv.conv3x3_plain(tx.abs(), tk.abs())
    got = _conv3x3_tf32x3_emulated(tx, tk)
    want_p = torch.from_numpy(np.array(
        jconv.conv2d_pallas(jnp.asarray(x), jnp.asarray(k), 1, "SAME")))[None]
    for want in (tconv.conv3x3_plain(tx, tk), want_p):
        assert ((got - want).abs() / mag).max().item() <= CONV_TOL
    one = _conv3x3_tf32x3_emulated(tx, tk, terms=1)
    assert ((one - want_p).abs() / mag).max().item() > CONV_TOL
