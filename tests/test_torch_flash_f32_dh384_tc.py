"""The arithmetic of the float32 Dh-384 flash dq on wgmma as three-block
clusters (``fedml_tpu_torch/csrc/flash_f32_wgmma_sm90.cu``, template
parameter P = 3), emulated on the CPU.

The CUDA kernel runs only on the card. Here its arithmetic is written out in
float32 torch, tile by tile, as the kernel orders it:

- a cluster of three blocks owns one (b, h, 64-row tile); block c is the
  Dh-128 block of ``tests/test_torch_flash_f32_dh128_tc.py`` on the 128
  columns 128 c .. 128 c + 127 (the 3xTF32 split and its term order, 64-row
  blocks, 32-key streamed tiles, the output product's keys in the
  fragment's order), emulated by ``emulate_dq`` on the column parts as
  heads of their own;
- each part's score products (S and dP) start from zero; every 8-row half
  of a warp's rows at each 8-key step of a tile has one owner rank (step j
  < 3: rank j; step 3: rank (2 warp + half) mod 3), which adds the three
  parts as (part 0 + part 1) + part 2, rank order (``_group_sum``), and
  sends ds formed from the sum to every block, so all three blocks hold the
  same bits of ds, from which each sums its own 128 columns of dq.

The tensor core's own order inside one product is not reproduced: each of
the three products is one float32 matrix product here. Held against float64
at (1, 256, 2, 384), against the JAX package's ``flash_attention`` (its
Pallas kernels in interpret mode, dq through ``jax.vjp``) at (1, 256, 1,
384), and against its dense attention at a ragged T of 130, within
``tests/test_torch_flash_dh384.py``'s tolerances, every block holding the
same bits of the summed scores. Planted faults fail those limits: a part
left out of the sum, each block adding its own part first (the blocks then
disagree), the lo hi term dropped, a tile dropped, and a row half with no
owner or with two.

The owner map here (``_owners``) restates the kernel's ``send_parts3`` and
``own3``; it is not read from them. Under the sound map every owner forms
the same rank-order sum, so the owner faults show only as the NaN that
``_backward`` writes where a row half has no owner or two: they check this
emulation, not the kernel. The kernel's own map is checked on the card, by
the ``cuda``-marked case below and by ``chip_smoke.py`` (the plain
version, bit-repeatability, and column parts bit-equal on inputs whose
parts repeat). dk/dv at Dh 384 stays on ``flash_f32_sm90.cu``.

This file imports JAX, the JAX package and the helpers of the other
emulations (which import both) only where they import, so that its
``cuda`` cases also collect on a machine with the card and without them.
"""

import numpy as np
import pytest
import torch

from fedml_tpu_torch.ops import flash_attention as tfa

try:  # JAX, the JAX package, and the other emulations' helpers, which import both
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_default_matmul_precision", "highest")

    from fedml_tpu.ops import attention as jatt
    from test_torch_flash_dh384 import FWD_ATOL, GRAD_ATOL
    from test_torch_flash_f32_dh128_tc import FRAGMENT, KEYS, ROWS
    from test_torch_flash_f32_dh384 import emulate_forward
    from test_torch_flash_f32_dkv_tc import _jax_flash
    from test_torch_flash_f32_tc import (EXACT_TOL, _exact, _heads, _inputs, _jax_layout, _rel,
                                         emulate_dq)
    from test_torch_flash_f32_tc import _one_thread  # noqa: F401  (autouse: one thread)
    from test_torch_flash_wide_f32_tc import _group_sum, _hold
except ImportError:  # a machine with the card and without them: the cuda cases only
    jax = None

DH = 384
PARTS = DH // 128  # blocks of a cluster, one per 128-column slice
WARPS, STEPS = 64 // 16, 32 // 8  # 16-row warps of a block, 8-key steps of a tile

# the sound arithmetic and its planted faults: (terms, a key whose tile is
# left out, the fault of the parts' sum
# (_group_sum), the fault of the owner map (_owners))
FAULTS = {"sound": (3, None, "sound", "sound"),
          "part_dropped": (3, None, "part_dropped", "sound"),
          "own_part_first": (3, None, "own_part_first", "sound"),
          "term_dropped": (2, None, "sound", "sound"),
          "tile_dropped": (3, 100, "sound", "sound"),
          "no_owner": (3, None, "sound", "no_owner"),
          "two_owners": (3, None, "sound", "two_owners")}


def _owners(fault="sound"):
    """{(warp, half, step): owner ranks} of every 8-row half of a warp's rows
    at every 8-key step of a tile, as the kernel's send_parts3 and own3 map
    them (restated, not read from the kernel); the planted faults leave warp 3's second half of step 3 with no
    owner or give it a second one."""
    own = {(w, hh, j): [j] if j < 3 else [(2 * w + hh) % 3]
           for w in range(WARPS) for hh in range(2) for j in range(STEPS)}
    if fault == "no_owner":
        own[3, 1, 3] = []
    if fault == "two_owners":
        own[3, 1, 3] = own[3, 1, 3] + [2]
    return own


def _to_parts(x):
    """(H, T, Dh) -> (P H, T, 128): the column parts as heads, part-major."""
    H, T, _ = x.shape
    return x.view(H, T, PARTS, -1).permute(2, 0, 1, 3).reshape(PARTS * H, T, -1)


def _from_parts(x, H):
    """(P H, T, 128) -> (H, T, Dh): each block's columns back in place."""
    return torch.cat(list(x.view(PARTS, H, *x.shape[1:])), -1)


def _dq(q, k, v, do, lse, delta, causal, fault):
    """dq as the clusters compute it, with ``fault`` planted, and how far
    the blocks of a cluster disagree on the values they share."""
    terms, drop, sum_fault, owner_fault = FAULTS[fault]
    own = _owners(owner_fault)
    H = q.shape[0]
    spread = [0.0]

    def combine(partial):
        # (P H, tiles, 64, 32): each block's view of the summed scores
        sums = _group_sum(partial.view(PARTS, H, *partial.shape[1:]), sum_fault)
        if sum_fault != "own_part_first":  # else every block keeps its own sum
            shared = torch.empty_like(sums)
            for (w, hh, j), ranks in own.items():
                r, c = slice(16 * w + 8 * hh, 16 * w + 8 * hh + 8), slice(8 * j, 8 * j + 8)
                shared[..., r, c] = sums[ranks[0]][..., r, c] if len(ranks) == 1 else torch.nan
            sums = shared
        spread[0] = max(spread[0], (sums - sums[:1]).abs().max().item())
        return sums.view(partial.shape)

    parts = [_to_parts(x) for x in (q, k, v, do)]
    rows = [x.repeat(PARTS, 1) for x in (lse, delta)]
    dq = emulate_dq(*parts, *rows, causal, terms, drop, ROWS, KEYS,
                    key_order=(FRAGMENT, FRAGMENT), combine=combine, scale=DH ** -0.5)
    return _from_parts(dq, H), spread[0]


def test_owner_map_gives_every_row_half_one_owner():
    """Every 8-row half of every warp's rows at every 8-key step has one
    owner rank; rank r owns its step's 8 halves and (10 - r) // 3 of step
    3's (3, 3, 2), so it receives 3 ranks x 2 tensors x 256 bytes a half:
    16,896, 16,896 and 15,360 bytes of parts a tile (the kernel's
    parts_bytes3), within the 16,896 its buffer holds."""
    own = _owners()
    assert all(len(r) == 1 for r in own.values())
    halves = [sum(r == [rank] for r in own.values()) for rank in range(PARTS)]
    assert halves == [8 + (10 - r) // 3 for r in range(PARTS)] == [11, 11, 10]
    assert [h * PARTS * 2 * 256 for h in halves] == [16896, 16896, 15360]
    for fault in ("no_owner", "two_owners"):
        assert any(len(r) != 1 for r in _owners(fault).values())


@pytest.fixture(scope="module")
def t256():
    """(1, 256, 2, 384) inputs as (H, T, Dh) and their float64 results,
    causal and full."""
    q, k, v, do = (_heads(a) for a in _inputs((1, 256, 2, DH), seed=38))
    return (q, k, v, do), {c: _exact(q, k, v, do, c) for c in (True, False)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh384_cluster_arithmetic_is_float32_exact(t256, causal, fault):
    """At (1, 256, 2, 384), dq (from float64's lse and delta, so that its own
    arithmetic is what is held) against float64: within EXACT_TOL of the
    largest exact value, the blocks agreeing bit for bit, when sound; each
    planted fault fails one of these."""
    (q, k, v, do), exact = t256
    _, lse64, delta64, dq64 = exact[causal][:4]
    got, spread = _dq(q, k, v, do, lse64.float(), delta64.float(), causal, fault)
    _hold(_rel(got, dq64) <= EXACT_TOL, spread, fault)


@pytest.fixture(scope="module")
def jax_t256():
    """(1, 256, 1, 384) inputs and the JAX package's flash_attention output,
    lse and gradients on them, causal and full (Pallas in interpret
    mode)."""
    inputs = _inputs((1, 256, 1, DH), seed=39)
    return inputs, {c: _jax_flash(*inputs, c, True) for c in (True, False)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh384_cluster_arithmetic_matches_jax(jax_t256, causal, fault):
    """At (1, 256, 1, 384), the emulated dq (lse and delta from the emulated
    Dh-384 forward of flash_f32_sm90.cu, as the port's backward forms them)
    against the JAX package's dq through jax.vjp: within GRAD_ATOL, the
    blocks agreeing bit for bit, when sound; each planted fault fails one
    of these."""
    inputs, want = jax_t256
    jout, _, grads = want[causal]
    th = [_heads(a) for a in inputs]
    out, lse, _ = emulate_forward(*th[:3], causal)
    np.testing.assert_allclose(_jax_layout(out), jout, atol=FWD_ATOL)
    got, spread = _dq(*th, lse, (th[3] * out).sum(-1), causal, fault)
    diff = np.abs(_jax_layout(got) - np.asarray(grads[0])).max()
    _hold(diff <= GRAD_ATOL, spread, fault)


@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh384_cluster_at_ragged_t_matches_jax_dense(causal):
    """At (1, 130, 2, 384), a T that is a multiple of no tile (every block
    of a cluster zero-fills and masks the rows and columns past it alike),
    against the JAX package's dense attention and its dq: its
    flash_attention refuses a T without a block tiling."""
    q, k, v, do = _inputs((1, 130, 2, DH), seed=40)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _, vjp = jax.vjp(lambda q, k, v: jatt.multihead_attention(
        q, k, v, causal=causal, impl="dense"), jq, jk, jv)
    th = [_heads(a) for a in (q, k, v, do)]
    out, lse, _ = emulate_forward(*th[:3], causal)
    got, spread = _dq(*th, lse, (th[3] * out).sum(-1), causal, "sound")
    assert spread == 0.0
    np.testing.assert_allclose(_jax_layout(got), np.asarray(vjp(jnp.asarray(do))[0]),
                               atol=GRAD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((2, 333, 3, 384), True), ((3, 130, 2, 384), False),
                                          ((1, 2048, 2, 384), True)])
def test_f32_dh384_cluster_kernels_match_plain_on_card(shape, causal):
    """On the card, the clusters' dq (the route's) against the plain version
    from the same lse and delta, within 1e-4 of the largest plain value,
    bit-repeatable, with one launch counted a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    assert tfa.route("fedml_flash_dq", torch.float32, DH)[0] == "flash_f32_wgmma_sm90"
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(*shape, generator=g).cuda() for _ in range(4))
    out, lse = tfa.flash_forward(q, k, v, causal)
    delta = tfa.attention_delta(do, out)
    before = tfa.flash_dq.launches
    got = tfa.flash_dq(q, k, v, do, lse, delta, causal)
    assert tfa.flash_dq.launches == before + 1
    want = tfa.flash_dq_plain(q, k, v, do, lse, delta, causal)
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-4
    assert torch.equal(got, tfa.flash_dq(q, k, v, do, lse, delta, causal))
