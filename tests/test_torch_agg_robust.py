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
from fedml_tpu.ops.pallas.agg_robust import fused_gram  # noqa: E402
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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trobust.RobustAggregator("trimmed_mean")


@pytest.mark.cuda
@pytest.mark.parametrize("C,D", [(10, 1663370), (100, 65536), (1000, 7850), (13, 1000)])
def test_gram_kernel_matches_plain_on_card(C, D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    flat = torch.randn(C, D, generator=torch.Generator().manual_seed(0)).cuda() * 0.01
    g = ar.gram(flat)
    # fp32 sums of up to ~8e3 terms in another order: ~5e-6 of the row norms
    assert _norm_err(g.cpu().numpy(), ar.gram_plain(flat).cpu().numpy()) < 2e-5
    assert torch.equal(g, ar.gram(flat))  # fixed-order reduction repeats
