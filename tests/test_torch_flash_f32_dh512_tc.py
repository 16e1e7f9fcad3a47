"""The arithmetic of the float32 Dh-512 flash dq and dk/dv on wgmma as
four-block clusters (``fedml_tpu_torch/csrc/flash_f32_wgmma_sm90.cu``,
template parameter P = 4), emulated on the CPU.

The CUDA kernels run only on the card. Here their arithmetic is written out
in float32 torch, tile by tile, as the kernels order it:

- a cluster of four blocks owns one (b, h, 64-row tile); block c is the
  Dh-128 block of ``tests/test_torch_flash_f32_dh128_tc.py`` on the 128
  columns 128 c .. 128 c + 127 (the 3xTF32 split and its term order, 64-row
  blocks, 32-row streamed tiles, the output products' keys in the
  fragment's order), emulated by ``emulate_dq`` and ``emulate_dkv`` on the
  column parts as heads of their own;
- each part's score products (S and dP in dq, S^T and dP^T in dk/dv) start
  from zero, and the cluster adds the four parts as ((part 0 + part 1) +
  part 2) + part 3, rank order, so every block holds the same bits of p and
  ds (``_group_sum``), from which each block sums its own 128 columns of
  dq, dk and dv.

The tensor core's own order inside one product is not reproduced: each of
the three products is one float32 matrix product here. Held against float64
at (1, 512, 2, 512), against the JAX package's ``flash_attention`` (its
Pallas kernels in interpret mode, dq, dk and dv through ``jax.vjp``) at (1,
256, 1, 512), and against its dense attention at a ragged T of 130, within
``tests/test_torch_flash_dh384.py``'s tolerances, every block holding the
same bits of the summed scores. Planted faults fail those limits: a part
left out of the sum, each block adding its own part first (the blocks then
disagree), the lo hi term dropped, a tile dropped, and a B side that takes
its keys in plain order against the fragment's. The ``cuda``-marked cases
hold the kernels to their plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_default_matmul_precision", "highest")

from fedml_tpu.ops import attention as jatt  # noqa: E402
from fedml_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from test_torch_flash_dh384 import FWD_ATOL, GRAD_ATOL  # noqa: E402
from test_torch_flash_f32_dh128_tc import FRAGMENT, KEYS, PLAIN, ROWS  # noqa: E402
from test_torch_flash_f32_dkv_tc import emulate_dkv  # noqa: E402
from test_torch_flash_f32_tc import (EXACT_TOL, _exact, _heads, _inputs,  # noqa: E402
                                     _jax_layout, _rel, emulate_dq)
from test_torch_flash_f32_tc import _one_thread  # noqa: E402, F401  (autouse: one thread)
from test_torch_flash_wide_f32_tc import _group_sum, _hold, _jax_flash  # noqa: E402
from test_torch_flash_wide_f32_tc import emulate_forward as wide_forward  # noqa: E402

DH = 512
PARTS = DH // 128  # blocks of a cluster, one per 128-column slice

# the sound arithmetic and its planted faults: (terms, a row whose tile is
# left out (a key for dq, a query for dk/dv), the (A, B) key orders, the
# fault of the parts' sum (_group_sum))
FAULTS = {"sound": (3, None, (FRAGMENT, FRAGMENT), "sound"),
          "part_dropped": (3, None, (FRAGMENT, FRAGMENT), "part_dropped"),
          "own_part_first": (3, None, (FRAGMENT, FRAGMENT), "own_part_first"),
          "term_dropped": (2, None, (FRAGMENT, FRAGMENT), "sound"),
          "tile_dropped": (3, 100, (FRAGMENT, FRAGMENT), "sound"),
          "key_order": (3, None, (FRAGMENT, PLAIN), "sound")}


def _to_parts(x):
    """(H, T, Dh) -> (P H, T, 128): the column parts as heads, part-major."""
    H, T, _ = x.shape
    return x.view(H, T, PARTS, -1).permute(2, 0, 1, 3).reshape(PARTS * H, T, -1)


def _from_parts(x, H):
    """(P H, T, 128) -> (H, T, Dh): each block's columns back in place."""
    return torch.cat(list(x.view(PARTS, H, *x.shape[1:])), -1)


def _backward(q, k, v, do, lse, delta, causal, fault):
    """(dq, dk, dv) as the clusters compute them, with ``fault`` planted, and
    how far the blocks of a cluster disagree on the summed scores."""
    terms, drop, order, sum_fault = FAULTS[fault]
    H = q.shape[0]
    spread = [0.0]

    def combine(partial):
        sums = _group_sum(partial.view(PARTS, H, *partial.shape[1:]), sum_fault)
        spread[0] = max(spread[0], (sums - sums[:1]).abs().max().item())
        return sums.view(partial.shape)

    parts = [_to_parts(x) for x in (q, k, v, do)]
    rows = [x.repeat(PARTS, 1) for x in (lse, delta)]
    kw = dict(key_order=order, combine=combine, scale=DH ** -0.5)
    dq = emulate_dq(*parts, *rows, causal, terms, drop, ROWS, KEYS, **kw)
    dk, dv = emulate_dkv(*parts, *rows, causal, terms, drop, ROWS, KEYS, **kw)
    return tuple(_from_parts(x, H) for x in (dq, dk, dv)), spread[0]


@pytest.fixture(scope="module")
def t512():
    """(1, 512, 2, 512) inputs as (H, T, Dh) and their float64 results,
    causal and full."""
    q, k, v, do = (_heads(a) for a in _inputs((1, 512, 2, DH), seed=51))
    return (q, k, v, do), {c: _exact(q, k, v, do, c) for c in (True, False)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh512_cluster_arithmetic_is_float32_exact(t512, causal, fault):
    """At (1, 512, 2, 512), dq, dk and dv (from float64's lse and delta, so
    that their own arithmetic is what is held) against float64: within
    EXACT_TOL of the largest exact value, the blocks agreeing bit for bit,
    when sound; each planted fault fails one of these."""
    (q, k, v, do), exact = t512
    _, lse64, delta64, dq64, dk64, dv64 = exact[causal]
    got, spread = _backward(q, k, v, do, lse64.float(), delta64.float(), causal, fault)
    errs = [_rel(g, e) for g, e in zip(got, (dq64, dk64, dv64))]
    _hold(max(errs) <= EXACT_TOL, spread, fault)


@pytest.fixture(scope="module")
def jax_t256():
    """(1, 256, 1, 512) inputs and the JAX package's flash_attention output,
    lse and (dq, dk, dv) on them, causal and full (Pallas in interpret
    mode)."""
    inputs = _inputs((1, 256, 1, DH), seed=52)
    return inputs, {c: jax.tree_util.tree_map(np.asarray,
                                              _jax_flash(*map(jnp.asarray, inputs), c))
                    for c in (True, False)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh512_cluster_arithmetic_matches_jax(jax_t256, causal, fault):
    """At (1, 256, 1, 512), the emulated dq, dk and dv (lse and delta from
    the emulated forward that runs at Dh 512, as the port's backward forms
    them) against the JAX package's gradients through jax.vjp: within
    GRAD_ATOL, the blocks agreeing bit for bit, when sound; each planted
    fault fails one of these."""
    inputs, want = jax_t256
    jout, _, grads = want[causal]
    th = [_heads(a) for a in inputs]
    out, lse, _ = wide_forward(*th[:3], causal)
    np.testing.assert_allclose(_jax_layout(out), jout, atol=FWD_ATOL)
    got, spread = _backward(*th, lse, (th[3] * out).sum(-1), causal, fault)
    diffs = [np.abs(_jax_layout(g) - w).max() for g, w in zip(got, grads)]
    _hold(max(diffs) <= GRAD_ATOL, spread, fault)


@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh512_cluster_at_ragged_t_matches_jax_dense(causal):
    """At (1, 130, 2, 512), a T that is a multiple of no tile (every block
    of a cluster zero-fills and masks the rows and columns past it alike),
    against the JAX package's dense attention and its gradients: its
    flash_attention refuses a T without a block tiling."""
    q, k, v, do = _inputs((1, 130, 2, DH), seed=53)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _, vjp = jax.vjp(lambda q, k, v: jatt.multihead_attention(
        q, k, v, causal=causal, impl="dense"), jq, jk, jv)
    th = [_heads(a) for a in (q, k, v, do)]
    out, lse, _ = wide_forward(*th[:3], causal)
    got, spread = _backward(*th, lse, (th[3] * out).sum(-1), causal, "sound")
    assert spread == 0.0
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_jax_layout(g), np.asarray(w), atol=GRAD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((2, 333, 3, 512), True), ((3, 130, 2, 512), False),
                                          ((1, 2048, 2, 512), True)])
def test_f32_dh512_cluster_kernels_match_plain_on_card(shape, causal):
    """On the card, the clusters' dq and dk/dv against the plain versions
    from the same lse and delta, within 1e-4 of the largest plain value, and
    bit-repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    assert tfa.route("fedml_flash_dq", torch.float32, DH)[0] == "flash_f32_wgmma_sm90"
    assert tfa.route("fedml_flash_dkv", torch.float32, DH)[0] == "flash_f32_wgmma_sm90"
    g = torch.Generator().manual_seed(2)
    q, k, v, do = (torch.randn(*shape, generator=g).cuda() for _ in range(4))
    out, lse = tfa.flash_forward(q, k, v, causal)
    delta = tfa.attention_delta(do, out)
    got = (tfa.flash_dq(q, k, v, do, lse, delta, causal),
           *tfa.flash_dkv(q, k, v, do, lse, delta, causal))
    want = (tfa.flash_dq_plain(q, k, v, do, lse, delta, causal),
            *tfa.flash_dkv_plain(q, k, v, do, lse, delta, causal))
    for a, b in zip(got, want):
        assert ((a - b).abs().max() / b.abs().max()).item() < 1e-4
    again = (tfa.flash_dq(q, k, v, do, lse, delta, causal),
             *tfa.flash_dkv(q, k, v, do, lse, delta, causal))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
