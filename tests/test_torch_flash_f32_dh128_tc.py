"""The arithmetic of the float32 Dh-128 flash dq and dk/dv on wgmma
(``fedml_tpu_torch/csrc/flash_f32_wgmma_sm90.cu``), emulated on the CPU.

The CUDA kernels run only on the card. Here their arithmetic is written out
in float32 torch, tile by tile, as the kernels order it, through the
emulations of ``tests/test_torch_flash_f32_tc.py`` (dq) and
``tests/test_torch_flash_f32_dkv_tc.py`` (dk/dv) at these kernels' tile
heights:

- every product is three TF32 products, each operand split into hi =
  cvt.rna.tf32(v) and lo = v - hi, lo hi, hi lo and hi hi summed smallest
  first;
- dq: blocks of 64 q rows, 32-key tiles; per tile S = Q K^T and dP = dO V^T
  over all 128 columns, p = exp(scale S - lse), ds = p (dP - delta), dS K
  from a zero accumulator per key tile, scale times it added in float32;
- dk/dv: blocks of 64 keys, 32-query tiles; S^T = K Q^T and dP^T = V dO^T,
  P^T dO and dS^T Q from a zero accumulator per q tile, added to dv and
  (times scale) to dk in float32;
- the output products take P (dS) from the score accumulator as their
  register A operand, whose k index t holds key 2 t and t + 4 key 2 t + 1
  of each 8-key step; the transposed B tiles store their keys in the same
  order (FRAGMENT).

The tensor core's own order inside one product is not reproduced: each of
the three products is one float32 matrix product here. Held against float64
at (1, 1024, 2, 128), against the JAX package's ``flash_attention`` (its
Pallas kernels in interpret mode, dq, dk and dv through ``jax.vjp``) at (1,
256, 2, 128), and against its dense attention at a ragged T of 130, within
the tolerances ``tests/test_torch_flash_dh256.py`` holds the plain versions
to. Planted faults fail the same limits: a dropped term (lo hi), a dropped
tile, and a B side that takes its keys in plain order against the
fragment's. The ``cuda``-marked case holds the kernels to their plain
versions on the card.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_default_matmul_precision", "highest")

from fedml_tpu.ops import attention as jatt  # noqa: E402
from fedml_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from test_torch_flash_dh256 import FWD_ATOL, GRAD_ATOL  # noqa: E402
from test_torch_flash_f32_dkv_tc import _jax_flash, emulate_dkv  # noqa: E402
from test_torch_flash_f32_tc import (EXACT_TOL, _exact, _heads, _inputs,  # noqa: E402
                                     _jax_layout, _rel, emulate_dq, emulate_forward)
from test_torch_flash_f32_tc import _one_thread  # noqa: E402, F401  (autouse: one thread)

jfa = importlib.import_module("fedml_tpu.ops.pallas.flash_attention")

ROWS = 64  # q rows of a dq block, key rows of a dk/dv block
KEYS = 32  # rows of the streamed tiles: k and v in dq, q and dO in dk/dv
# the k order of an m16n8k8 A fragment taken from a score accumulator: k
# index t is key 2 t, t + 4 is key 2 t + 1
FRAGMENT = (0, 2, 4, 6, 1, 3, 5, 7)
PLAIN = tuple(range(8))

# the sound arithmetic and its planted faults: (terms, a row whose tile is
# left out (a key for dq, a query for dk/dv), the (A, B) key orders)
FAULTS = {"sound": (3, None, (FRAGMENT, FRAGMENT)),
          "term_dropped": (2, None, (FRAGMENT, FRAGMENT)),
          "tile_dropped": (3, 100, (FRAGMENT, FRAGMENT)),
          "key_order": (3, None, (FRAGMENT, PLAIN))}


def _backward(q, k, v, do, lse, delta, causal, fault):
    """(dq, dk, dv) as the kernels compute them, with ``fault`` planted."""
    terms, drop, order = FAULTS[fault]
    dq = emulate_dq(q, k, v, do, lse, delta, causal, terms, drop, ROWS, KEYS, order)
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, causal, terms, drop, ROWS, KEYS, order)
    return dq, dk, dv


@pytest.fixture(scope="module")
def t1024():
    """(1, 1024, 2, 128) inputs as (H, T, Dh) and their float64 results,
    causal and full."""
    q, k, v, do = (_heads(a) for a in _inputs((1, 1024, 2, 128), seed=41))
    return (q, k, v, do), {c: _exact(q, k, v, do, c) for c in (True, False)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh128_backward_arithmetic_is_float32_exact(t1024, causal, fault):
    """At (1, 1024, 2, 128), dq, dk and dv (from float64's lse and delta, so
    that their own arithmetic is what is held) against float64: within
    EXACT_TOL of the largest exact value when sound; each planted fault
    fails that limit for all three."""
    (q, k, v, do), exact = t1024
    _, lse64, delta64, dq64, dk64, dv64 = exact[causal]
    got = _backward(q, k, v, do, lse64.float(), delta64.float(), causal, fault)
    errs = [_rel(g, e) for g, e in zip(got, (dq64, dk64, dv64))]
    if fault == "sound":
        assert max(errs) <= EXACT_TOL, errs
    else:
        assert min(errs) > EXACT_TOL, errs


@pytest.fixture(scope="module")
def jax_t256():
    """(1, 256, 2, 128) inputs and the JAX package's flash_attention output,
    lse and (dq, dk, dv) on them, causal and full (Pallas in interpret
    mode)."""
    inputs = _inputs((1, 256, 2, 128), seed=42)
    return inputs, {c: _jax_flash(*inputs, c, True) for c in (True, False)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh128_backward_arithmetic_matches_jax(jax_t256, causal, fault):
    """At (1, 256, 2, 128), the emulated dq, dk and dv (lse and delta from
    the emulated forward, as the port's backward forms them) against the
    JAX package's gradients through jax.vjp, within GRAD_ATOL when sound;
    each planted fault fails that limit."""
    inputs, want = jax_t256
    jout, _, grads = want[causal]
    th = [_heads(a) for a in inputs]
    out, lse = emulate_forward(*th[:3], causal)
    np.testing.assert_allclose(_jax_layout(out), jout, atol=FWD_ATOL)
    got = _backward(*th, lse, (th[3] * out).sum(-1), causal, fault)
    diffs = [np.abs(_jax_layout(g) - w).max() for g, w in zip(got, grads)]
    if fault == "sound":
        assert max(diffs) <= GRAD_ATOL, diffs
    else:
        assert max(diffs) > GRAD_ATOL, diffs


@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh128_backward_at_ragged_t_matches_jax_dense(causal):
    """At (1, 130, 2, 128), a T that is a multiple of no tile (the kernels
    zero-fill and mask the rows and columns past it), against the JAX
    package's dense attention and its gradients: its flash_attention
    refuses a T without a block tiling."""
    q, k, v, do = _inputs((1, 130, 2, 128), seed=43)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _, vjp = jax.vjp(lambda q, k, v: jatt.multihead_attention(
        q, k, v, causal=causal, impl="dense"), jq, jk, jv)
    th = [_heads(a) for a in (q, k, v, do)]
    out, lse = emulate_forward(*th[:3], causal)
    got = _backward(*th, lse, (th[3] * out).sum(-1), causal, "sound")
    for g, w in zip(got, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(_jax_layout(g), np.asarray(w), atol=GRAD_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((3, 130, 2, 128), True), ((2, 333, 3, 128), False),
                                          ((1, 2048, 2, 128), True)])
def test_f32_dh128_backward_kernels_match_plain_on_card(shape, causal):
    """On the card, flash_f32_wgmma_sm90's dq and dk/dv against the plain
    versions from the same lse and delta, within 1e-4 of the largest plain
    value, and bit-repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    assert tfa.route("fedml_flash_dq", torch.float32, 128)[0] == "flash_f32_wgmma_sm90"
    g = torch.Generator().manual_seed(1)
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
