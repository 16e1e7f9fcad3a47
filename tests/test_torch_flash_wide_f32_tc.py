"""The arithmetic of the float32 flash forward, dq and dk/dv at Dh 512-896 on
the tensor cores (``fedml_tpu_torch/csrc/flash_wide_f32_sm90.cu``), emulated
on the CPU.

The CUDA kernels run only on the card. Here their arithmetic is written out
in float32 torch, tile by tile, as the kernels order it, with
``tests/test_torch_flash_f32_tc.py``'s three TF32 products (each operand
split into hi and lo where it is loaded; lo hi, hi lo and hi hi summed
smallest first) and the column split of every row group among Dh / 128
warps:

- forward: q scaled before the product; per 8-key tile, each warp sums the
  scores over its 128 columns from zero, and every warp adds the partial
  scores in one fixed order, part 0 + part 1 + ... + part P - 1; each warp
  runs the online softmax (l clamped at 1e-30) on that sum and adds P V over
  its 128 columns, from a zero accumulator per key tile, to its output
  after the rescale by corr; lse is part 0's;
- dq: per 8-key tile, S = Q K^T and dP = dO V^T summed over the 128-column
  parts alike, p = exp(scale S - lse), ds = p (dP - delta), and each warp's
  dS K over its 128 columns from zero, scale times it added to dq;
- dk/dv: per 8-row q/dO tile, S = K Q^T and dP = V dO^T summed over the
  parts alike (the dk warps add the S parts too, so both roles form the same
  p), p = exp(scale S - lse) (0 where causal masks a key past the query, and
  past T), dS = p (dP - delta); P^T dO and dS^T Q over each warp's 128
  columns from zero per q tile, added to dv and (times scale) to dk.

The rows of the other axis do not meet each other in this arithmetic, so
they are emulated all at once (the kernels' 16, 32 or 64 resident rows are
a layout, not an order). The tensor core's own order inside one product,
and each warp's split of its 128 columns into two chains, are not
reproduced: each of the three products is one float32 matrix product here.
Each emulation also returns how far the warps of a row disagree on what
they must share (lse in the forward, ds in dq, p and ds in dk/dv), which is
0 when they add their partial scores in one order. Held against float64 at
(1, 256, 2, Dh), against the JAX package's ``flash_attention`` (its Pallas
kernels in interpret mode, dq, dk and dv through ``jax.vjp``) at (1, 256, 1,
Dh) and against its dense attention at a ragged T of 130, at Dh 512 and 896,
within the tolerances ``tests/test_torch_flash_dh384.py`` holds the plain
versions to and with that disagreement 0. Planted faults fail those limits:
the partial scores added own part first (each warp of a row group starting
from its own part, so the parts of a row use different softmaxes), and one
part left out of every warp's sum. The kernels themselves are held to the
plain versions, and their column parts to each other, on the card by
``chip_smoke.py``.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax.config.update("jax_default_matmul_precision", "highest")

from fedml_tpu.ops import attention as jatt  # noqa: E402
from fedml_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from test_torch_conv import _split  # noqa: E402
from test_torch_flash_dh384 import FWD_ATOL, GRAD_ATOL  # noqa: E402
from test_torch_flash_f32_tc import (EXACT_TOL, _exact, _heads, _inputs,  # noqa: E402
                                     _jax_layout, _rel, _split_t, _tf32x3, _tiles)
from test_torch_flash_f32_tc import _one_thread  # noqa: E402, F401  (autouse: one thread)

jfa = importlib.import_module("fedml_tpu.ops.pallas.flash_attention")

WARP_COLS = 128  # score and output columns of a warp: Dh / 128 a row or key group
TILE = 8         # rows of every streamed tile (k/v in the forward and dq, q/dO in dk/dv)
DIMS = (512, 896)

# each kernel's sound arithmetic at both masks, and its planted faults (causal)
CASES = [(kernel, causal, "sound") for kernel in ("fwd", "dq", "dkv") for causal in (True, False)] \
    + [(kernel, True, fault) for kernel in ("fwd", "dq", "dkv")
       for fault in ("own_part_first", "part_dropped")]


def _parts(x):
    """(..., Dh) -> (Dh / 128, ..., 128): the warps' column parts, stacked."""
    return torch.stack(x.split(WARP_COLS, -1))


def _group_sum(partials, fault):
    """Each warp's score from the stacked partial scores (P, ...): every warp
    adds part 0 + part 1 + ... + part P - 1 in that order, as the kernels'
    group_add and sum_parts do. Planted faults: ``own_part_first`` starts
    each warp from its own part and goes round (the parts of a row then
    differ in their low bits); ``part_dropped`` leaves the last part out of
    every warp's sum."""
    n = partials.shape[0]
    sums = []
    for w in range(n):
        if fault == "own_part_first":
            order = [(w + i) % n for i in range(n)]
        else:
            order = list(range(n - 1 if fault == "part_dropped" else n))
        s = partials[order[0]]
        for j in order[1:]:
            s = s + partials[j]
        sums.append(s)
    return torch.stack(sums)


def _spread(x):
    """How far the parts (axis 0) of ``x`` are from part 0's bits."""
    return (x - x[:1]).abs().max().item()


def emulate_forward(q, k, v, causal, fault="sound"):
    """q, k, v (H, T, Dh) float32 -> (out (H, T, Dh), lse (H, T), the
    largest difference between the warps' lse)."""
    H, T, Dh = q.shape
    P, nk, scale = Dh // WARP_COLS, -(-T // TILE), Dh ** -0.5
    qp = _split(_parts(q * scale))  # scaled before the product
    kt, vt = _tiles(k, TILE, nk), _tiles(v, TILE, nk)
    rows = torch.arange(T)[:, None]
    m = torch.full((P, H, T, 1), tfa.NEG_INF)
    l = torch.zeros(P, H, T, 1)
    acc = torch.zeros(P, H, T, WARP_COLS)
    for j in range(nk):
        s = _group_sum(_tf32x3(qp, _split_t(_parts(kt[:, j]))), fault)
        cols = torch.arange(j * TILE, (j + 1) * TILE)
        x = s.masked_fill((cols >= T) | (causal & (cols > rows)), tfa.NEG_INF)
        nm = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp(m - nm)
        p = torch.exp(x - nm)
        l = l * corr + p.sum(-1, keepdim=True)
        m = nm
        acc = acc * corr + _tf32x3(_split(p), _split(_parts(vt[:, j])))  # from zero
    ls = l.clamp_min(1e-30)
    lse = (m + torch.log(ls))[..., 0]
    return torch.cat(list(acc / ls), -1), lse[0], _spread(lse)


def emulate_dq(q, k, v, do, lse, delta, causal, fault="sound"):
    """From (H, T, Dh) q, k, v, dO and (H, T) lse and delta -> (dq (H, T,
    Dh), the largest difference between the warps' ds)."""
    H, T, Dh = q.shape
    P, nk, scale = Dh // WARP_COLS, -(-T // TILE), Dh ** -0.5
    qp, op = _split(_parts(q)), _split(_parts(do))
    kt, vt = _tiles(k, TILE, nk), _tiles(v, TILE, nk)
    rows = torch.arange(T)[:, None]
    dq = torch.zeros(P, H, T, WARP_COLS)
    spread = 0.0
    for j in range(nk):
        cols = torch.arange(j * TILE, (j + 1) * TILE)
        ks = _split(_parts(kt[:, j]))
        s = _group_sum(_tf32x3(qp, tuple(t.transpose(-1, -2) for t in ks)), fault)
        dp = _group_sum(_tf32x3(op, _split_t(_parts(vt[:, j]))), fault)
        x = (scale * s).masked_fill((cols >= T) | (causal & (cols > rows)), tfa.NEG_INF)
        ds = torch.exp(x - lse[..., None]) * (dp - delta[..., None])
        spread = max(spread, _spread(ds))
        dq = dq + scale * _tf32x3(_split(ds), ks)  # per key tile, from zero
    return torch.cat(list(dq), -1), spread


def emulate_dkv(q, k, v, do, lse, delta, causal, fault="sound"):
    """From (H, T, Dh) q, k, v, dO and (H, T) lse and delta -> (dk, dv,
    both (H, T, Dh), the largest difference between the warps' p or ds).
    Causal q tiles before a key's diagonal give p = 0 there, adding exact
    zeros where the kernel skips them."""
    H, T, Dh = q.shape
    nq, scale = -(-T // TILE), Dh ** -0.5
    kp, vp = _split(_parts(k)), _split(_parts(v))
    qt, ot = _tiles(q, TILE, nq), _tiles(do, TILE, nq)
    lse_t, delta_t = (F.pad(x, (0, nq * TILE - T)).view(H, nq, 1, TILE) for x in (lse, delta))
    keys = torch.arange(T)[:, None]
    dk = torch.zeros(kp[0].shape)
    dv = torch.zeros(vp[0].shape)
    spread = 0.0
    for j in range(nq):
        cols = torch.arange(j * TILE, (j + 1) * TILE)
        qj, oj = _parts(qt[:, j]), _parts(ot[:, j])
        s = _group_sum(_tf32x3(kp, _split_t(qj)), fault)  # (P, H, T, 8): each warp's sum
        dp = _group_sum(_tf32x3(vp, _split_t(oj)), fault)
        x = (scale * s).masked_fill(causal & (keys > cols), tfa.NEG_INF)
        p = torch.exp(x - lse_t[:, j]).masked_fill(cols >= T, 0.0)
        ds = p * (dp - delta_t[:, j])
        spread = max(spread, _spread(p), _spread(ds))
        dv = dv + _tf32x3(_split(p), _split(oj))  # per q tile, from zero
        dk = dk + scale * _tf32x3(_split(ds), _split(qj))
    return torch.cat(list(dk), -1), torch.cat(list(dv), -1), spread


def _emulate_all(q, k, v, do, causal, fault, kernel):
    """The port's path through the emulated kernels: the forward, then the
    backward from its lse and delta = rowsum(dO * O); ``fault`` planted in
    ``kernel`` only. Returns ({output: value}, that kernel's spread)."""
    out, lse, spread = emulate_forward(q, k, v, causal, fault if kernel == "fwd" else "sound")
    if kernel == "fwd":
        return {"out": out, "lse": lse}, spread
    delta = (do * out).sum(-1)
    if kernel == "dq":
        dq, spread = emulate_dq(q, k, v, do, lse, delta, causal, fault)
        return {"dq": dq}, spread
    dk, dv, spread = emulate_dkv(q, k, v, do, lse, delta, causal, fault)
    return {"dk": dk, "dv": dv}, spread


def _hold(ok, spread, fault):
    """A sound emulation meets its limits (``ok``) with the warps agreeing
    bit for bit; a planted fault fails one of them."""
    if fault == "sound":
        assert ok and spread == 0.0, (ok, spread)
    else:
        assert not (ok and spread == 0.0), (ok, spread)


@pytest.fixture(scope="module")
def t256():
    """(1, 256, 2, Dh) inputs as (H, T, Dh) and their float64 results, causal
    and full, at Dh 512 and 896."""
    cases = {}
    for Dh in DIMS:
        q, k, v, do = (_heads(a) for a in _inputs((1, 256, 2, Dh), seed=Dh))
        cases[Dh] = (q, k, v, do), {c: _exact(q, k, v, do, c) for c in (True, False)}
    return cases


@pytest.mark.parametrize("kernel,causal,fault", CASES)
@pytest.mark.parametrize("Dh", DIMS)
def test_f32_wide_arithmetic_is_float32_exact(t256, Dh, kernel, causal, fault):
    """At (1, 256, 2, Dh), each kernel against float64 (the backward from
    float64's lse and delta, so that its own arithmetic is what is held):
    within EXACT_TOL of the largest exact value, the warps agreeing bit for
    bit."""
    (q, k, v, do), exact = t256[Dh]
    out64, lse64, delta64, dq64, dk64, dv64 = exact[causal]
    if kernel == "fwd":
        out, lse, spread = emulate_forward(q, k, v, causal, fault)
        ok = (_rel(out, out64) <= EXACT_TOL
              and (lse.double() - lse64).abs().max().item() <= EXACT_TOL)
    elif kernel == "dq":
        dq, spread = emulate_dq(q, k, v, do, lse64.float(), delta64.float(), causal, fault)
        ok = _rel(dq, dq64) <= EXACT_TOL
    else:
        dk, dv, spread = emulate_dkv(q, k, v, do, lse64.float(), delta64.float(), causal,
                                     fault)
        ok = max(_rel(dk, dk64), _rel(dv, dv64)) <= EXACT_TOL
    _hold(ok, spread, fault)


@functools.partial(jax.jit, static_argnums=4)
def _jax_flash(q, k, v, do, causal):
    """The JAX package's flash_attention output, lse and (dq, dk, dv) on (1,
    T, H, Dh) inputs, its Pallas kernels in interpret mode, traced once."""
    out, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, causal), q, k, v)
    bq = jfa.auto_block(q.shape[1])
    return out, jfa._flash_forward(q, k, v, causal, bq, bq, True)[1][:, 0], vjp(do)


@pytest.fixture(scope="module")
def jax_t256():
    """(1, 256, 1, Dh) inputs and the JAX package's flash_attention output,
    lse and (dq, dk, dv) on them, causal and full (Pallas in interpret
    mode), at Dh 512 and 896."""
    cases = {}
    for Dh in DIMS:
        inputs = _inputs((1, 256, 1, Dh), seed=Dh + 2)
        cases[Dh] = inputs, {c: jax.tree_util.tree_map(
            np.asarray, _jax_flash(*map(jnp.asarray, inputs), c)) for c in (True, False)}
    return cases


@pytest.mark.parametrize("kernel,causal,fault", CASES)
@pytest.mark.parametrize("Dh", DIMS)
def test_f32_wide_arithmetic_matches_jax(jax_t256, Dh, kernel, causal, fault):
    """At (1, 256, 1, Dh), each emulated kernel's outputs (the backward's lse
    and delta from the emulated forward, as the port's backward forms them)
    against the JAX package's flash_attention, its lse and its gradients
    through jax.vjp: within FWD_ATOL (out, lse) and GRAD_ATOL (dq, dk, dv),
    the warps agreeing bit for bit."""
    inputs, want = jax_t256[Dh]
    jout, jlse, (jdq, jdk, jdv) = want[causal]
    got, spread = _emulate_all(*(_heads(a) for a in inputs), causal, fault, kernel)
    ref = {"out": (jout, FWD_ATOL), "lse": (jlse, FWD_ATOL), "dq": (jdq, GRAD_ATOL),
           "dk": (jdk, GRAD_ATOL), "dv": (jdv, GRAD_ATOL)}
    ok = all(np.abs((x.numpy() if n == "lse" else _jax_layout(x)) - ref[n][0]).max() <= ref[n][1]
             for n, x in got.items())
    _hold(ok, spread, fault)


@pytest.fixture(scope="module")
def dense_t130():
    """(1, 130, 2, Dh) inputs, a T that is a multiple of no tile, and the JAX
    package's dense attention and its gradients on them, causal and full, at
    Dh 512 and 896 (its flash_attention refuses a T without a block
    tiling)."""
    cases = {}
    for Dh in DIMS:
        q, k, v, do = _inputs((1, 130, 2, Dh), seed=Dh + 3)
        want = {}
        for causal in (True, False):
            jout, vjp = jax.vjp(lambda q, k, v: jatt.multihead_attention(
                q, k, v, causal=causal, impl="dense"), *map(jnp.asarray, (q, k, v)))
            want[causal] = (np.asarray(jout),
                            tuple(np.asarray(g) for g in vjp(jnp.asarray(do))))
        cases[Dh] = (q, k, v, do), want
    return cases


@pytest.mark.parametrize("kernel,causal,fault", CASES)
@pytest.mark.parametrize("Dh", DIMS)
def test_f32_wide_arithmetic_at_ragged_t_matches_jax_dense(dense_t130, Dh, kernel, causal,
                                                            fault):
    """At T 130 (the kernels zero-fill and mask the rows and columns past
    it), each emulated kernel's outputs against the JAX package's dense
    attention and its gradients: within FWD_ATOL and GRAD_ATOL, the warps
    agreeing bit for bit."""
    inputs, want = dense_t130[Dh]
    jout, (jdq, jdk, jdv) = want[causal]
    got, spread = _emulate_all(*(_heads(a) for a in inputs), causal, fault, kernel)
    ref = {"out": (jout, FWD_ATOL), "dq": (jdq, GRAD_ATOL), "dk": (jdk, GRAD_ATOL),
           "dv": (jdv, GRAD_ATOL)}
    ok = all(np.abs(_jax_layout(x) - ref[n][0]).max() <= ref[n][1]
             for n, x in got.items() if n in ref)
    _hold(ok, spread, fault)
