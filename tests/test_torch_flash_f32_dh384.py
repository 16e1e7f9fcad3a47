"""The arithmetic of the float32 Dh-384 flash forward, dq and dk/dv on the
tensor cores (``fedml_tpu_torch/csrc/flash_f32_sm90.cu``), emulated on the
CPU.

The CUDA kernels run only on the card. Here their arithmetic is written out
in float32 torch, tile by tile, as the kernels order it, with
``tests/test_torch_flash_f32_tc.py``'s three TF32 products (each operand
split into hi and lo where it is loaded; lo hi, hi lo and hi hi summed
smallest first) and, what Dh 384 adds, the column split among warps:

- forward: q scaled before the product; per 16-key tile, three warps each
  sum the scores over their 128 columns from zero, and every warp adds the
  three partial scores in one fixed order, part 0 + part 1 + part 2; each
  warp runs the online softmax (l clamped at 1e-30) on that sum and adds P
  V over its 128 columns, from a zero accumulator per key tile, to its
  output after the rescale by corr; lse is part 0's;
- dq: per 16-key tile, S = Q K^T and dP = dO V^T summed over three
  128-column parts alike, p = exp(scale S - lse), ds = p (dP - delta), and
  each warp's dS K over its 128 columns from zero, scale times it added to
  dq in float32;
- dk/dv: per 16-row q/dO tile, S = K Q^T and dP = V dO^T over two
  192-column parts added once (a + b is b + a), p = exp(scale S - lse) (0
  where causal masks a key past the query, and past T), dS = p (dP -
  delta); P^T dO and dS^T Q over each part's 192 columns from zero per q
  tile, added to dv and (times scale) to dk.

The rows of the other axis (q rows in the forward and dq, key rows in
dk/dv) do not meet each other in this arithmetic, so they are emulated all
at once. The tensor core's own order inside one product is not reproduced:
each of the three products is one float32 matrix product here. Each
emulation also returns how far the warps of a row disagree on what they
must share (lse in the forward, ds in dq, p and ds in dk/dv), which is 0
when they add their partial scores in one order. Held against float64 at
(1, 1024, 2, 384), against the JAX package's ``flash_attention`` (its
Pallas kernels in interpret mode, dq, dk and dv through ``jax.vjp``) at (1,
256, 2, 384) and against its dense attention at a ragged T of 130, within
the tolerances ``tests/test_torch_flash_dh384.py`` holds the plain versions
to and with that disagreement 0. Planted faults fail those limits: the
partial scores added own part first (every warp of a row group starting
from its own part, so the three thirds of a row use different softmaxes),
one TF32 product dropped, and in dk/dv the partner's partial score never
added. The kernels themselves are held to the plain versions, and their
column parts to each other, on the card by ``chip_smoke.py``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax.config.update("jax_default_matmul_precision", "highest")

from fedml_tpu.ops import attention as jatt  # noqa: E402
from fedml_tpu_torch import ops as tops  # noqa: E402
from fedml_tpu_torch.ops import attention as tatt  # noqa: E402
from fedml_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from test_torch_conv import _split  # noqa: E402
from test_torch_flash_dh384 import FWD_ATOL, GRAD_ATOL  # noqa: E402
from test_torch_flash_f32_dkv_tc import _jax_flash  # noqa: E402
from test_torch_flash_f32_tc import (EXACT_TOL, _exact, _heads, _inputs,  # noqa: E402
                                     _jax_layout, _rel, _split_t, _tf32x3, _tiles)
from test_torch_flash_f32_tc import _one_thread  # noqa: E402, F401  (autouse: one thread)

jfa = importlib.import_module("fedml_tpu.ops.pallas.flash_attention")

DH = 384
WARP_COLS = 128  # score and output columns of a forward or dq warp: three a row group
DKV_COLS = 192   # columns of a dk/dv warp: two for dv and two for dk a key group
KEYS = 16        # rows of the forward's and dq's k/v tiles
QUERIES = 16     # rows of dk/dv's q/dO tiles

# the sound arithmetic and the planted faults of each kernel
FWD_FAULTS = ("sound", "own_part_first", "term_dropped")
DKV_FAULTS = ("sound", "partner_dropped", "term_dropped")


def _parts(x, width):
    """(..., Dh) -> (Dh / width, ..., width): the column parts, stacked."""
    return torch.stack(x.split(width, -1))


def _group_sum(partials, fault):
    """Each warp's score from the stacked partial scores (n, ...): every warp
    adds part 0 + part 1 + ... in that order, as the kernel's group_add
    does; ``own_part_first`` starts each warp from its own part (a planted
    fault: the thirds of a row then differ in their low bits)."""
    n = partials.shape[0]
    sums = []
    for w in range(n):
        order = [(w + i) % n for i in range(n)] if fault == "own_part_first" else range(n)
        order = iter(order)
        s = partials[next(order)]
        for j in order:
            s = s + partials[j]
        sums.append(s)
    return torch.stack(sums)


def _terms(fault):
    return 2 if fault == "term_dropped" else 3  # 2: lo hi left out


def _spread(x):
    """How far the parts (axis 0) of ``x`` are from part 0's bits."""
    return (x - x[:1]).abs().max().item()


def emulate_forward(q, k, v, causal, fault="sound"):
    """q, k, v (H, T, 384) float32 -> (out (H, T, 384), lse (H, T), the
    largest difference between the three warps' lse)."""
    H, T, Dh = q.shape
    nk, scale, terms = -(-T // KEYS), Dh ** -0.5, _terms(fault)
    qp = _split(_parts(q * scale, WARP_COLS))  # scaled before the product
    kt, vt = _tiles(k, KEYS, nk), _tiles(v, KEYS, nk)
    rows = torch.arange(T)[:, None]
    m = torch.full((3, H, T, 1), tfa.NEG_INF)
    l = torch.zeros(3, H, T, 1)
    acc = torch.zeros(3, H, T, WARP_COLS)
    for j in range(nk):
        s = _group_sum(_tf32x3(qp, _split_t(_parts(kt[:, j], WARP_COLS)), terms), fault)
        cols = torch.arange(j * KEYS, (j + 1) * KEYS)
        x = s.masked_fill((cols >= T) | (causal & (cols > rows)), tfa.NEG_INF)
        nm = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp(m - nm)
        p = torch.exp(x - nm)
        l = l * corr + p.sum(-1, keepdim=True)
        m = nm
        acc = acc * corr + _tf32x3(_split(p), _split(_parts(vt[:, j], WARP_COLS)), terms)
    ls = l.clamp_min(1e-30)
    lse = (m + torch.log(ls))[..., 0]
    return torch.cat(list(acc / ls), -1), lse[0], _spread(lse)


def emulate_dq(q, k, v, do, lse, delta, causal, fault="sound"):
    """From (H, T, 384) q, k, v, dO and (H, T) lse and delta -> (dq (H, T,
    384), the largest difference between the three warps' ds)."""
    H, T, Dh = q.shape
    nk, scale, terms = -(-T // KEYS), Dh ** -0.5, _terms(fault)
    qp, op = _split(_parts(q, WARP_COLS)), _split(_parts(do, WARP_COLS))
    kt, vt = _tiles(k, KEYS, nk), _tiles(v, KEYS, nk)
    rows = torch.arange(T)[:, None]
    dq = torch.zeros(3, H, T, WARP_COLS)
    spread = 0.0
    for j in range(nk):
        cols = torch.arange(j * KEYS, (j + 1) * KEYS)
        ks = _split(_parts(kt[:, j], WARP_COLS))
        s = _group_sum(_tf32x3(qp, tuple(t.transpose(-1, -2) for t in ks), terms), fault)
        dp = _group_sum(_tf32x3(op, _split_t(_parts(vt[:, j], WARP_COLS)), terms), fault)
        x = (scale * s).masked_fill((cols >= T) | (causal & (cols > rows)), tfa.NEG_INF)
        ds = torch.exp(x - lse[..., None]) * (dp - delta[..., None])
        spread = max(spread, _spread(ds))
        dq = dq + scale * _tf32x3(_split(ds), ks, terms)  # per key tile, from zero
    return torch.cat(list(dq), -1), spread


def emulate_dkv(q, k, v, do, lse, delta, causal, fault="sound"):
    """From (H, T, 384) q, k, v, dO and (H, T) lse and delta -> (dk, dv,
    both (H, T, 384), the largest difference between the two dv warps' p or
    the two dk warps' ds). Causal q tiles before a key's diagonal give p = 0
    there, adding exact zeros where the kernel skips them."""
    H, T, Dh = q.shape
    nq, scale, terms = -(-T // QUERIES), Dh ** -0.5, _terms(fault)
    kp, vp = _split(_parts(k, DKV_COLS)), _split(_parts(v, DKV_COLS))
    qt, ot = _tiles(q, QUERIES, nq), _tiles(do, QUERIES, nq)
    lse_t, delta_t = (F.pad(x, (0, nq * QUERIES - T)).view(H, nq, 1, QUERIES)
                      for x in (lse, delta))
    keys = torch.arange(T)[:, None]
    dk = torch.zeros(2, H, T, DKV_COLS)
    dv = torch.zeros(2, H, T, DKV_COLS)
    spread = 0.0
    for j in range(nq):
        cols = torch.arange(j * QUERIES, (j + 1) * QUERIES)
        qj, oj = _parts(qt[:, j], DKV_COLS), _parts(ot[:, j], DKV_COLS)
        s = _tf32x3(kp, _split_t(qj), terms)  # (2, H, T, 16): each part's partial
        dp = _tf32x3(vp, _split_t(oj), terms)
        if fault != "partner_dropped":
            s, dp = (s[0] + s[1]).expand_as(s), (dp[0] + dp[1]).expand_as(dp)
        x = (scale * s).masked_fill(causal & (keys > cols), tfa.NEG_INF)
        p = torch.exp(x - lse_t[:, j]).masked_fill(cols >= T, 0.0)
        ds = p * (dp - delta_t[:, j])
        spread = max(spread, _spread(p), _spread(ds))
        dv = dv + _tf32x3(_split(p), _split(oj), terms)  # per q tile, from zero
        dk = dk + scale * _tf32x3(_split(ds), _split(qj), terms)
    return torch.cat(list(dk), -1), torch.cat(list(dv), -1), spread


def _hold(ok, spread, fault):
    """A sound emulation meets its limits (``ok``) with the warps agreeing
    bit for bit; a planted fault fails one of them."""
    if fault == "sound":
        assert ok and spread == 0.0, (ok, spread)
    else:
        assert not (ok and spread == 0.0), (ok, spread)


@pytest.fixture(scope="module")
def t1024():
    """(1, 1024, 2, 384) inputs as (H, T, Dh) and their float64 results,
    causal and full."""
    q, k, v, do = (_heads(a) for a in _inputs((1, 1024, 2, DH), seed=41))
    return (q, k, v, do), {c: _exact(q, k, v, do, c) for c in (True, False)}


@pytest.mark.parametrize("fault", FWD_FAULTS)
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh384_forward_is_float32_exact(t1024, causal, fault):
    """At (1, 1024, 2, 384), out and lse against float64: within EXACT_TOL
    of the largest exact value, the three warps' lse bit-equal."""
    (q, k, v, _), exact = t1024
    out64, lse64 = exact[causal][:2]
    out, lse, spread = emulate_forward(q, k, v, causal, fault)
    ok = (_rel(out, out64) <= EXACT_TOL
          and (lse.double() - lse64).abs().max().item() <= EXACT_TOL)
    _hold(ok, spread, fault)


@pytest.mark.parametrize("fault", FWD_FAULTS)
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh384_dq_is_float32_exact(t1024, causal, fault):
    """At (1, 1024, 2, 384), dq from float64's lse and delta (so that dq's
    own arithmetic is what is held) against float64: within EXACT_TOL, the
    three warps' ds bit-equal."""
    (q, k, v, do), exact = t1024
    _, lse64, delta64, dq64 = exact[causal][:4]
    dq, spread = emulate_dq(q, k, v, do, lse64.float(), delta64.float(), causal, fault)
    _hold(_rel(dq, dq64) <= EXACT_TOL, spread, fault)


@pytest.mark.parametrize("fault", DKV_FAULTS)
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh384_dkv_is_float32_exact(t1024, causal, fault):
    """At (1, 1024, 2, 384), dk and dv from float64's lse and delta against
    float64: within EXACT_TOL, the split warps' p and ds bit-equal."""
    (q, k, v, do), exact = t1024
    _, lse64, delta64, _, dk64, dv64 = exact[causal]
    dk, dv, spread = emulate_dkv(q, k, v, do, lse64.float(), delta64.float(), causal, fault)
    _hold(max(_rel(dk, dk64), _rel(dv, dv64)) <= EXACT_TOL, spread, fault)


@pytest.fixture(scope="module")
def jax_t256():
    """(1, 256, 2, 384) inputs and the JAX package's flash_attention output,
    lse and (dq, dk, dv) on them, causal and full (Pallas in interpret
    mode)."""
    inputs = _inputs((1, 256, 2, DH), seed=42)
    return inputs, {c: _jax_flash(*inputs, c, True) for c in (True, False)}


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


KERNEL_FAULTS = [(kernel, fault) for kernel in ("fwd", "dq") for fault in FWD_FAULTS] + \
    [("dkv", fault) for fault in DKV_FAULTS]


@pytest.mark.parametrize("kernel,fault", KERNEL_FAULTS)
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh384_matches_jax(jax_t256, causal, kernel, fault):
    """At (1, 256, 2, 384), each emulated kernel's outputs (the backward's
    lse and delta from the emulated forward, as the port's backward forms
    them) against the JAX package's flash_attention, its lse and its
    gradients through jax.vjp: within FWD_ATOL (out, lse) and GRAD_ATOL (dq,
    dk, dv), the warps agreeing bit for bit."""
    inputs, want = jax_t256
    jout, jlse, (jdq, jdk, jdv) = want[causal]
    got, spread = _emulate_all(*(_heads(a) for a in inputs), causal, fault, kernel)
    ref = {"out": (jout, FWD_ATOL), "lse": (jlse, FWD_ATOL), "dq": (jdq, GRAD_ATOL),
           "dk": (jdk, GRAD_ATOL), "dv": (jdv, GRAD_ATOL)}
    ok = all(np.abs((x.numpy() if n == "lse" else _jax_layout(x)) - ref[n][0]).max() <= ref[n][1]
             for n, x in got.items())
    _hold(ok, spread, fault)


@pytest.fixture(scope="module")
def dense_t130():
    """(1, 130, 2, 384) inputs, a T that is a multiple of no tile, and the
    JAX package's dense attention and its gradients on them, causal and
    full (its flash_attention refuses a T without a block tiling)."""
    q, k, v, do = _inputs((1, 130, 2, DH), seed=43)
    want = {}
    for causal in (True, False):
        jout, vjp = jax.vjp(lambda q, k, v: jatt.multihead_attention(
            q, k, v, causal=causal, impl="dense"), *map(jnp.asarray, (q, k, v)))
        want[causal] = (np.asarray(jout),
                        tuple(np.asarray(g) for g in vjp(jnp.asarray(do))))
    return (q, k, v, do), want


@pytest.mark.parametrize("kernel,fault", KERNEL_FAULTS)
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh384_at_ragged_t_matches_jax_dense(dense_t130, causal, kernel, fault):
    """At T 130 (the kernels zero-fill and mask the rows and columns past
    it), each emulated kernel's outputs against the JAX package's dense
    attention and its gradients: within FWD_ATOL and GRAD_ATOL, the warps
    agreeing bit for bit."""
    inputs, want = dense_t130
    jout, (jdq, jdk, jdv) = want[causal]
    got, spread = _emulate_all(*(_heads(a) for a in inputs), causal, fault, kernel)
    ref = {"out": (jout, FWD_ATOL), "dq": (jdq, GRAD_ATOL), "dk": (jdk, GRAD_ATOL),
           "dv": (jdv, GRAD_ATOL)}
    ok = all(np.abs(_jax_layout(x) - ref[n][0]).max() <= ref[n][1]
             for n, x in got.items() if n in ref)
    _hold(ok, spread, fault)


def test_route_sends_f32_dh384_to_flash_f32_sm90():
    """The float32 forward and dk/dv at Dh 384 go to flash_f32_sm90's entry
    points, dq to flash_f32_wgmma_sm90's three-block clusters, all of which
    the card's wrappers accept; bf16 at Dh 384 keeps flash_dh384_sm90."""
    assert {"flash_f32_sm90", "flash_f32_wgmma_sm90"} <= set(tops.KERNELS)
    tfa.check_head_dim(DH, torch.float32)
    for name in ("fedml_flash_fwd", "fedml_flash_dkv"):
        assert tfa.route(name, torch.float32, DH) == ("flash_f32_sm90", name + "_f32_sm90")
    assert tfa.route("fedml_flash_dq", torch.float32, DH) == (
        "flash_f32_wgmma_sm90", "fedml_flash_dq_f32wg_sm90")
    for name in ("fedml_flash_fwd", "fedml_flash_dq", "fedml_flash_dkv"):
        assert tfa.route(name, torch.bfloat16, DH)[0] == "flash_dh384_sm90"


@pytest.mark.parametrize("B,H", [(8, 8), (1, 1)])
def test_xl_f32_dispatch_matches_jax(B, H):
    """The XL LM trained in float32 (--dim 3072: Dh 384, 4-byte items) at
    T 4352, and small_lm_384_f32's one head: the port's auto dispatch picks
    flash, as the JAX package's does."""
    got = tatt.auto_attention_impl(B, H, 4352, DH, 4)
    assert got == jatt.auto_attention_impl(B, H, 4352, DH, 4) == "flash"
