"""Port vs JAX package: the Gram plane, the sanitizer and multi-Krum.

Float reductions run in another order in torch than in XLA, so the Gram
matrix and distances are held to a tolerance (stated per test), while
every decision — quarantine set, Krum selection — must be identical. The
CUDA Gram kernel is held to the plain version on the card (``cuda``
marker; skips without a card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_default_matmul_precision", "highest")

from fedml_tpu.core import robust as jrobust  # noqa: E402
from fedml_tpu.ops.pallas.agg_robust import _reference_gram, fused_gram  # noqa: E402
from fedml_tpu_torch.core import robust as trobust  # noqa: E402
from fedml_tpu_torch.ops import agg_robust as ar  # noqa: E402


def _norm_err(a, b):
    """max |a - b|_ij / sqrt(b_ii b_jj): Gram error relative to row norms."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.sqrt(np.diag(b))
    return float((np.abs(a - b) / (d[:, None] * d[None, :])).max())


@pytest.mark.parametrize("C,D", [(3, 64), (8, 1000), (13, 777)])
def test_gram_plain_matches_jax_kernel(C, D):
    # f32 dot products of <= 1000 terms in another order: ~eps*sqrt(D) of
    # the row norms, well under 1e-6
    flat = np.random.default_rng(C).standard_normal((C, D)).astype(np.float32)
    jg = fused_gram(jnp.asarray(flat), interpret=True)
    tg = ar.gram(torch.from_numpy(flat))
    assert tg.shape == (C, C) and tg.dtype == torch.float32
    assert _norm_err(tg.numpy(), jg) < 1e-6


@pytest.mark.parametrize("C,D", [(1, 5), (10, 1663370), (100, 65536), (1000, 7850), (17, 100)])
def test_split_plan_covers_the_contraction(C, D):
    span, splits = ar.split_plan(C, D)
    assert span % ar.COLS == 0 and 1 <= splits <= 65535
    assert (splits - 1) * span < D <= splits * span


@pytest.mark.parametrize("C,want", [(1, "small"), (10, "small"), (16, "small"), (17, "tiled"),
                                    (100, "tiled"), (1000, "tiled")])
def test_gram_route_by_cohort_size(C, want):
    assert ar.route(C) == want


@pytest.mark.parametrize("D", [1, 3, 4, 7, 8, 9, 11, 1001, 4099, 65537, 1663370, 1663371,
                               4 * 256 * ar.SMALL_BLOCKS + 6])
def test_small_route_reads_every_column_once(D):
    """The small route's spans partition [0, D): whole groups of four per
    block (no block empty, at most SMALL_BLOCKS), then the 4..7 tail
    columns; every 16-byte load of a group, shifted back to its row's
    alignment or forward for the next lane's share, stays inside the row."""
    nbody, per_block, nblocks = ar.small_plan(D)
    spans = [(b, 4 * b * per_block, 4 * min((b + 1) * per_block, nbody))
             for b in range(nblocks) if nbody] + [(nblocks - 1, 4 * nbody, D)]
    seen = np.zeros(D, np.int64)
    for b, lo, hi in spans:
        assert 0 <= b < nblocks and lo <= hi
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert 1 <= nblocks <= ar.SMALL_BLOCKS
    assert [b for b, _, _ in spans[:-1]] == list(range(nblocks if nbody else 0))
    assert all(hi > lo and lo % 4 == 0 and hi % 4 == 0 for _, lo, hi in spans[:-1])
    assert 4 * nbody + 4 <= D or nbody == 0
    assert D - 4 * nbody <= 7 and (nbody == 0 or D - 4 * nbody >= 4)


def _emulate_small_gram(x):
    """csrc/agg_robust.cu's small route in float32 on the CPU, in its order:
    per thread an fmaf per (column, i, j >= i) (emulated as the float64
    product plus the sum, rounded once), the tail columns on the last
    block's first threads, shuffle-down trees over each warp's lanes, the
    fixed tree over eight warps, lane-strided sums of the block partials and
    one more lane tree; then the triangle mirrored."""
    C, D = x.shape
    T, W = ar.SMALL_THREADS, 32
    nbody, per_block, nblocks = ar.small_plan(D)
    iu, ju = np.triu_indices(C)
    acc = np.zeros((nblocks, T, iu.size), np.float32)

    def fma(v, acc):  # v (C, ...) -> acc[..., p] += v[i] v[j]
        vi, vj = np.moveaxis(v[iu], 0, -1), np.moveaxis(v[ju], 0, -1)
        return (vi.astype(np.float64) * vj + acc).astype(np.float32)

    b, t = np.arange(nblocks)[:, None], np.arange(T)[None, :]
    q1 = np.minimum((b + 1) * per_block, nbody)
    for it in range(-(-per_block // T) if nbody else 0):
        q = b * per_block + it * T + t
        on = q < q1
        for c in range(4):
            acc = fma(np.where(on, x[:, np.where(on, 4 * q + c, 0)], 0.0), acc)
    for k, col in enumerate(range(4 * nbody, D)):
        acc[-1, k] = fma(x[:, col], acc[-1, k])

    def lane_tree(v):  # (..., 32, P) -> lane 0's shuffle-down sum
        for off in (16, 8, 4, 2, 1):
            v = v[..., :off, :] + v[..., off:2 * off, :]
        return v[..., 0, :]

    w = lane_tree(acc.reshape(nblocks, T // W, W, -1))
    part = ((w[:, 0] + w[:, 1]) + (w[:, 2] + w[:, 3])) + ((w[:, 4] + w[:, 5]) + (w[:, 6] + w[:, 7]))
    lanes = np.zeros((W, iu.size), np.float32)
    for blk in range(nblocks):
        lanes[blk % W] += part[blk]
    tri = lane_tree(lanes)
    g = np.zeros((C, C), np.float32)
    g[iu, ju] = tri
    g[ju, iu] = tri
    return g


@pytest.mark.parametrize("C,D", [(10, 5003), (16, 1001), (1, 9), (3, 7), (5, 4 * 256 * 270 + 6)])
def test_small_route_order_matches_jax_reference(C, D):
    # f32 sums in the kernel's order vs XLA's: ~eps * sqrt(D / terms per
    # thread) of the row norms, far under 1e-6
    x = np.random.default_rng(C + D).standard_normal((C, D)).astype(np.float32)
    g = _emulate_small_gram(x)
    assert np.array_equal(g, g.T)
    assert _norm_err(g, _reference_gram(jnp.asarray(x))) < 1e-6


def _stack(C, seed, nan_row=None, boost_row=None):
    rng = np.random.default_rng(seed)
    tree = {"params": {"Dense_0": {"kernel": rng.standard_normal((C, 40, 30)),
                                   "bias": rng.standard_normal((C, 30))},
                       "Dense_1": {"kernel": rng.standard_normal((C, 30, 10))}}}
    tree = jax.tree_util.tree_map(lambda x: (x * 0.01).astype(np.float32), tree)
    if nan_row is not None:
        tree["params"]["Dense_0"]["bias"][nan_row, 3] = np.nan
    if boost_row is not None:
        tree = jax.tree_util.tree_map(
            lambda x: np.where(np.arange(C).reshape((C,) + (1,) * (x.ndim - 1)) == boost_row,
                               x * 10.0, x).astype(np.float32), tree)
    return tree


def _torch(tree):
    from fedml_tpu_torch.utils.convert import variables_from_jax

    return variables_from_jax(tree)


@pytest.mark.parametrize("C,nan_row,boost_row", [(10, 2, 6), (7, None, 0), (12, 11, None)])
def test_fused_sanitize_krum_matches_jax(C, nan_row, boost_row):
    tree = _stack(C, C, nan_row, boost_row)
    w = np.random.default_rng(1).integers(20, 80, C).astype(np.float32)
    f, m = jrobust.RobustAggregator("multi_krum")._krum_fm(C)
    jagg, jw, jq, jz, jsel = jrobust.fused_sanitize_krum(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(w), 6.0, f, m,
        use_kernel=True, interpret=True)
    tagg, tw, tq, tz, tsel = trobust.fused_sanitize_krum(_torch(tree), torch.from_numpy(w),
                                                         6.0, f, m)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert (np.isinf(tz.numpy()) == np.isinf(np.asarray(jz))).all()
    fin = np.isfinite(np.asarray(jz))
    # z = (norm - median) / scale; norms are f32 sums in another order
    np.testing.assert_allclose(tz.numpy()[fin], np.asarray(jz)[fin], rtol=1e-5, atol=1e-5)
    if nan_row is not None:
        assert bool(tq[nan_row])
    if boost_row is not None:
        assert bool(tq[boost_row])
    from fedml_tpu_torch.utils.convert import flatten_paths

    for p, v in flatten_paths(jax.tree_util.tree_map(np.asarray, jagg)).items():
        # weighted sums of <= 12 f32 rows: a few ulp
        np.testing.assert_allclose(tagg[p].numpy(), v, rtol=1e-6, atol=1e-8)


def test_sequential_path_matches_fused_and_jax():
    """sanitize_stacked -> RobustAggregator.aggregate (the unfused path)
    selects what the fused pass selects, and both match JAX's."""
    C = 10
    tree = _stack(C, 5, nan_row=1, boost_row=8)
    w = np.full(C, 30.0, np.float32)
    clean, cw, q, _ = trobust.sanitize_stacked(_torch(tree), torch.from_numpy(w))
    jclean, jcw, jq, _ = jrobust.sanitize_stacked(jax.tree_util.tree_map(jnp.asarray, tree),
                                                  jnp.asarray(w))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    ra = trobust.RobustAggregator("multi_krum")
    agg = ra.aggregate(clean, cw)
    jagg = jrobust.RobustAggregator("multi_krum").aggregate(jclean, jcw)
    fagg = trobust.fused_sanitize_krum(_torch(tree), torch.from_numpy(w), 6.0,
                                       *ra._krum_fm(C))[0]
    from fedml_tpu_torch.utils.convert import flatten_paths

    for p, v in flatten_paths(jax.tree_util.tree_map(np.asarray, jagg)).items():
        np.testing.assert_allclose(agg[p].numpy(), v, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(fagg[p].numpy(), v, rtol=1e-6, atol=1e-8)
    # distances to the JAX untiled oracle: rtol 1e-5 on the non-trivial ones
    jd = np.asarray(jrobust.pairwise_sq_dists(jclean))
    td = trobust.pairwise_sq_dists(clean).numpy()
    big = jd > 1e-6 * jd.max()
    np.testing.assert_allclose(td[big], jd[big], rtol=1e-5)


def test_krum_ties_break_by_lower_index_like_top_k():
    d = np.zeros((6, 6), np.float32)  # six identical updates: every score ties
    scores_t = trobust.krum_scores(torch.from_numpy(d), 1)
    w = torch.ones(6)
    sel, _ = trobust._krum_weights(scores_t, w, 3, False)
    scores_j = jrobust.krum_scores(jnp.asarray(d), 1)
    _, idx = jax.lax.top_k(-scores_j, 3)
    want = np.zeros(6, np.float32)
    want[np.asarray(idx)] = 1.0
    np.testing.assert_array_equal(sel.numpy(), want)
    np.testing.assert_array_equal(sel.numpy(), [1, 1, 1, 0, 0, 0])


def test_median_averages_middle_pair_like_jnp():
    for x in ([3.0, 1.0, 2.0, 10.0], [5.0, 1.0, 4.0], [2.0, np.nan, 1.0, 0.0]):
        got = trobust._median(torch.tensor(x, dtype=torch.float32)).item()
        want = float(jnp.median(jnp.asarray(x, jnp.float32)))
        assert (np.isnan(got) and np.isnan(want)) or got == want


def test_unported_defense_raises():
    # every defense of the JAX package is ported; a name it does not know
    # raises as there
    with pytest.raises(ValueError, match="unknown defense_type"):
        trobust.RobustAggregator("bulyan")
    trobust.RobustAggregator("trimmed_mean")


@pytest.mark.cuda
@pytest.mark.parametrize("C,D", [(10, 1663370), (100, 65536), (1000, 7850), (13, 1000),
                                 (1, 1663371), (16, 1001), (16, 1663370), (17, 65537)])
def test_gram_kernel_matches_plain_on_card(C, D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    flat = torch.randn(C, D, generator=torch.Generator().manual_seed(0)).cuda() * 0.01
    g = ar.gram(flat)
    # fp32 sums of up to ~8e3 terms in another order: ~5e-6 of the row norms
    assert _norm_err(g.cpu().numpy(), ar.gram_plain(flat).cpu().numpy()) < 2e-5
    assert torch.equal(g, ar.gram(flat))  # fixed-order reduction repeats
    assert torch.equal(g, g.T)  # exactly symmetric
