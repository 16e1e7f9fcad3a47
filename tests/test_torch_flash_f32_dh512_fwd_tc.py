"""The arithmetic of the float32 Dh-512 flash forward on wgmma as four-block
clusters (``fedml_tpu_torch/csrc/flash_f32_wgmma_sm90.cu``,
``flash_fwd_f32wg_kernel<4>``), emulated on the CPU.

The CUDA kernel runs only on the card. Here its arithmetic is written out in
float32 torch, tile by tile, as the kernel orders it:

- q is scaled before the product; every product is three TF32 products,
  lo hi, hi lo and hi hi, from the split hi = cvt.rna.tf32(v), lo = v - hi;
- a cluster of four blocks owns one (b, h, 128-row q tile), each of its
  warpgroups 64 of the rows; block c owns the 128 columns 128 c .. 128 c +
  127 and sums each row's partial score over them, from zero a 32-key
  tile;
- the rows' owner adds the four parts in rank order, ((part 0 + part 1) +
  part 2) + part 3, masks with finfo(float32).min and takes the
  online-softmax step (new m, p, corr, l = l corr + rowsum p), and every
  block receives p, corr and l, so all four hold the same bits (here each
  block's view is computed on its own and compared: the spread);
- each block scales its 128 output columns by corr and adds P V, P's keys
  in the score accumulator's fragment order against v's transposed tile in
  the same order, from zero a tile; at the end o = acc / max(l, 1e-30) and
  lse = m + log max(l, 1e-30).

The tensor core's own order inside one product is not reproduced: each of
the three products is one float32 matrix product here. Held against float64
at (1, 512, 2, 512), against the JAX package's ``flash_attention`` forward
(out and lse, its Pallas kernel in interpret mode) at (1, 256, 1, 512), and
against its dense attention at a ragged T of 130, causal and full, within
``tests/test_torch_flash_dh384.py``'s tolerances, with m, l and p the same
bits in every block. Planted faults fail those limits: a part left out,
each block adding its own part first (the blocks then disagree), one block
skipping the corr rescale, the lo hi term dropped, a tile dropped, and v's
keys in plain order against the fragment's. The ``cuda``-marked cases hold
the kernel to the plain version on the card.

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
    from test_torch_conv import _split
    from test_torch_flash_dh384 import FWD_ATOL
    from test_torch_flash_f32_dh128_tc import FRAGMENT, KEYS, PLAIN
    from test_torch_flash_f32_tc import (EXACT_TOL, _exact, _heads, _inputs, _jax_layout, _rel,
                                         _split_t, _tf32x3, _tiles, in_fragment_order)
    from test_torch_flash_f32_tc import _one_thread  # noqa: F401  (autouse: one thread)
    from test_torch_flash_wide_f32_tc import _hold, _jax_flash
except ImportError:  # a machine with the card and without them: the cuda cases only
    jax = FRAGMENT = PLAIN = None

DH = 512
BLOCKS = DH // 128  # blocks of a cluster, one per 128-column slice: the score parts
ROWS = 128          # q rows of a block, 64 a warpgroup

# the sound arithmetic and its planted faults: (terms, a key whose tile is
# left out, (P's, v's) key orders, the fault of the parts' sum, a block that
# skips the corr rescale)
FAULTS = {} if jax is None else {
          "sound": (3, None, (FRAGMENT, FRAGMENT), "sound", None),
          "part_dropped": (3, None, (FRAGMENT, FRAGMENT), "part_dropped", None),
          "own_part_first": (3, None, (FRAGMENT, FRAGMENT), "own_part_first", None),
          "corr_skipped": (3, None, (FRAGMENT, FRAGMENT), "sound", 1),
          "term_dropped": (2, None, (FRAGMENT, FRAGMENT), "sound", None),
          "tile_dropped": (3, 100, (FRAGMENT, FRAGMENT), "sound", None),
          "key_order": (3, None, (FRAGMENT, PLAIN), "sound", None)}


def _chunks(x, n):
    """(..., Dh) -> (n, ..., Dh / n): the column chunks, stacked."""
    return torch.stack(x.split(x.shape[-1] // n, -1))


def _cluster_sum(parts, fault):
    """Each block's sum of the four partial scores (BLOCKS, ...) ->
    (BLOCKS, ...): in the sound kernel the owner adds them in rank order and
    sends the result to all, so every block holds those bits.
    ``own_part_first``: block c starts from its own part and goes round
    (the blocks then disagree in the low bits); ``part_dropped``: the last
    part left out."""
    sums = []
    for c in range(BLOCKS):
        if fault == "own_part_first":
            order = [(c + i) % BLOCKS for i in range(BLOCKS)]
        else:
            order = list(range(BLOCKS - 1 if fault == "part_dropped" else BLOCKS))
        s = parts[order[0]]
        for j in order[1:]:
            s = s + parts[j]
        sums.append(s)
    return torch.stack(sums)


def _spread(x):
    """How far the blocks (axis 0) of ``x`` are from block 0's bits."""
    return (x - x[:1]).abs().max().item()


def emulate_forward(q, k, v, causal, fault="sound"):
    """q, k, v (H, T, 512) float32 -> (out (H, T, 512), lse (H, T), the
    largest difference between the blocks' m, l and p), with ``fault``
    planted. Every q tile at once; causal key tiles past a q tile's diagonal
    are fully masked, which leaves m, l and the output as the kernel's
    skipping them does."""
    terms, drop, order, sum_fault, no_corr = FAULTS[fault]
    H, T, _ = q.shape
    nq, nk = -(-T // ROWS), -(-T // KEYS)
    qp = _split(_chunks(_tiles(q * DH ** -0.5, ROWS, nq), BLOCKS))  # scaled, then split
    kt, vt = _tiles(k, KEYS, nk), _tiles(v, KEYS, nk)
    qrows = torch.arange(nq * ROWS).view(nq, ROWS, 1)
    m = torch.full((BLOCKS, H, nq, ROWS, 1), tfa.NEG_INF)
    l = torch.zeros(BLOCKS, H, nq, ROWS, 1)
    acc = torch.zeros(BLOCKS, H, nq, ROWS, DH // BLOCKS)
    spread = 0.0
    for j in range(nk):
        if drop is not None and j == drop // KEYS:
            continue
        parts = _tf32x3(qp, _split_t(_chunks(kt[:, j, None], BLOCKS)), terms)
        s = _cluster_sum(parts, sum_fault)  # (BLOCKS, H, nq, ROWS, KEYS)
        cols = torch.arange(j * KEYS, (j + 1) * KEYS)
        x = s.masked_fill((cols >= T) | (causal & (cols > qrows)), tfa.NEG_INF)
        nm = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp(m - nm)
        p = torch.exp(x - nm)
        l = l * corr + p.sum(-1, keepdim=True)
        m = nm
        spread = max(spread, _spread(m), _spread(l), _spread(p))
        if no_corr is not None:
            corr = corr.clone()
            corr[no_corr] = 1.0
        pf, vf = in_fragment_order(p, _chunks(vt[:, j, None], BLOCKS), order)
        acc = acc * corr + _tf32x3(_split(pf), _split(vf), terms)  # from zero a tile
    ls = l.clamp_min(1e-30)
    out = torch.cat(list(acc / ls), -1).view(H, nq * ROWS, DH)[:, :T]
    lse = (m[0] + torch.log(ls[0])).view(H, nq * ROWS)[:, :T]
    return out, lse, spread


@pytest.fixture(scope="module")
def t512():
    """(1, 512, 2, 512) inputs as (H, T, Dh) and their float64 results,
    causal and full."""
    q, k, v, do = (_heads(a) for a in _inputs((1, 512, 2, DH), seed=61))
    return (q, k, v), {c: _exact(q, k, v, do, c) for c in (True, False)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh512_fwd_cluster_arithmetic_is_float32_exact(t512, causal, fault):
    """At (1, 512, 2, 512), out and lse against float64: within EXACT_TOL
    of the largest exact value, the blocks holding the same bits of m, l and
    p, when sound; each planted fault fails one of these."""
    (q, k, v), exact = t512
    out64, lse64 = exact[causal][:2]
    out, lse, spread = emulate_forward(q, k, v, causal, fault)
    ok = (_rel(out, out64) <= EXACT_TOL
          and (lse.double() - lse64).abs().max().item() <= EXACT_TOL)
    _hold(ok, spread, fault)


@pytest.fixture(scope="module")
def jax_t256():
    """(1, 256, 1, 512) inputs and the JAX package's flash_attention output
    and lse on them, causal and full (Pallas in interpret mode)."""
    inputs = _inputs((1, 256, 1, DH), seed=62)
    return inputs, {c: tuple(np.asarray(a) for a in
                             _jax_flash(*map(jnp.asarray, inputs), c)[:2])
                    for c in (True, False)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh512_fwd_cluster_arithmetic_matches_jax(jax_t256, causal, fault):
    """At (1, 256, 1, 512), the emulated out and lse against the JAX
    package's flash_attention forward and its lse: within FWD_ATOL, the
    blocks agreeing bit for bit, when sound; each planted fault fails one of
    these."""
    inputs, want = jax_t256
    jout, jlse = want[causal]
    out, lse, spread = emulate_forward(*(_heads(a) for a in inputs[:3]), causal, fault)
    ok = (np.abs(_jax_layout(out) - jout).max() <= FWD_ATOL
          and np.abs(lse.numpy() - jlse).max() <= FWD_ATOL)
    _hold(ok, spread, fault)


@pytest.mark.parametrize("fault", ["sound", "own_part_first", "corr_skipped", "tile_dropped"])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh512_fwd_cluster_at_ragged_t_matches_jax_dense(causal, fault):
    """At (1, 130, 2, 512), a T that is a multiple of no tile (every block
    of a cluster zero-fills and masks the rows and columns past it alike),
    against the JAX package's dense attention (its flash_attention refuses a
    T without a block tiling): within FWD_ATOL, the blocks agreeing bit for
    bit, when sound; the planted faults fail one of these."""
    q, k, v, _ = _inputs((1, 130, 2, DH), seed=63)
    want = np.asarray(jatt.multihead_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                               impl="dense"))
    out, _, spread = emulate_forward(*(_heads(a) for a in (q, k, v)), causal, fault)
    _hold(np.abs(_jax_layout(out) - want).max() <= FWD_ATOL, spread, fault)


@pytest.mark.parametrize("Dh,want", [(512, "flash_f32_wgmma_sm90"), (384, "flash_f32_sm90"),
                                     (640, "flash_wide_f32_sm90"), (128, "flash_f32_sm90")])
def test_route_sends_the_f32_dh512_forward_to_the_clusters(Dh, want):
    """The float32 forward at Dh 512 goes to the four-block clusters; at Dh
    384 and 128 it stays on flash_f32_sm90.cu, at 640 on
    flash_wide_f32_sm90.cu; the bf16 forward at Dh 512 stays on
    flash_wide_sm90.cu."""
    lib, entry = tfa.route("fedml_flash_fwd", torch.float32, Dh)
    assert lib == want
    assert entry == "fedml_flash_fwd" + {"flash_f32_wgmma_sm90": "_f32wg_sm90",
                                         "flash_f32_sm90": "_f32_sm90",
                                         "flash_wide_f32_sm90": "_wide_f32_sm90"}[lib]
    assert tfa.route("fedml_flash_fwd", torch.bfloat16, 512)[0] == "flash_wide_sm90"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((2, 333, 3, 512), True), ((3, 130, 2, 512), False),
                                          ((1, 2048, 2, 512), True), ((1, 4224, 1, 512), False)])
def test_f32_dh512_fwd_cluster_matches_plain_on_card(shape, causal):
    """On the card, the clusters' out and lse against the plain version,
    within 1e-4 of the largest plain value, and bit-repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    assert tfa.route("fedml_flash_fwd", torch.float32, DH)[0] == "flash_f32_wgmma_sm90"
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(*shape, generator=g).cuda() for _ in range(3))
    before = tfa.flash_forward.launches
    out, lse = tfa.flash_forward(q, k, v, causal)
    assert tfa.flash_forward.launches == before + 1
    for a, b in zip((out, lse), tfa.flash_forward_plain(q, k, v, causal)):
        assert ((a - b).abs().max() / b.abs().max()).item() < 1e-4
    again = tfa.flash_forward(q, k, v, causal)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
