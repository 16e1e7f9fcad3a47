"""The arithmetic of the bf16 flash kernels at head dims 512-1536 (forward, dq
and dk/dv of ``fedml_tpu_torch/csrc/flash_wide_sm90.cu``), emulated on the
CPU.

The CUDA kernels run only on the card. Here their arithmetic is written out
in float32 torch, tile by tile, as the kernels order it. What the wide
kernels add to the Dh-384 design is the column slice: a block owns W = 256
output columns where Dh % 256 == 0, else 128, and recomputes the scores over
the whole Dh from 64-column chunks, each summed from zero and added in
float32 in one order, so every slice must form the same bits of the scores,
p and ds:

- forward: per 64-key tile, two consumers each sum the score chunks of
  their half of the columns in order, and both add the two partial scores
  (a + b is b + a); the online softmax (finfo(float32).min masking, l
  clamped at 1e-30), then P V over the slice's columns as three bf16 terms
  of p (smallest first) from a zero accumulator per key tile, added in
  float32 after the rescale;
- dq: per k tile, the causal diagonal's too, S = Q K^T and dP = dO V^T
  each summed over the chunks in order; p = exp(scale S - lse), ds = p (dP
  - delta), dS K over the slice's columns as three bf16 terms from a zero
  accumulator per k tile, scale times it added in float32;
- dk/dv: per q tile, S^T = K Q^T and dP^T = V dO^T over the chunks in
  order, p = exp(scale S^T - lse) (0 where causal masks a key past the
  query, and past T), ds = p (dP^T - delta); P^T dO and dS^T Q over the
  slice's columns as three bf16 terms from a zero accumulator per q tile,
  added to dv and (times scale) to dk.

The tensor core's own order inside one 64-column chunk is not reproduced:
each chunk is one float32 matrix product here. Each emulation also returns
how far the slices disagree on what they must share (lse in the forward,
ds in dq, p and ds in dk/dv), which is 0 when every slice sums its chunks
in one order. Held, at Dh 512 and 1536, to the port's plain versions within
float32 exactness (1e-5 of the largest value) and to the JAX package's
dense attention (output and, through ``jax.vjp``, dq, dk and dv) at a
ragged T. Planted faults fail those limits: a slice that reads its
neighbour's columns of v, k, q and dO, the middle split term dropped, and
one slice summing its score chunks out of order (which only the
disagreement shows: its outputs stay within float32 noise, and on the card
the check on inputs whose column slices repeat catches it). The kernels
themselves are held to the plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

jax.config.update("jax_default_matmul_precision", "highest")

from fedml_tpu.ops import attention as jatt  # noqa: E402
from fedml_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from test_torch_flash import _split3  # noqa: E402
from test_torch_flash_dh384 import FWD_ATOL, GRAD_ATOL  # noqa: E402
from test_torch_flash_f32_tc import EXACT_TOL  # noqa: E402
from test_torch_flash_f32_tc import _one_thread  # noqa: E402, F401  (autouse: one thread)

TILE = 64   # rows of every tile
CHUNK = 64  # columns of a streamed score chunk

FAULTS = ("sound", "neighbour_columns", "term_dropped", "chunk_out_of_order")


def _slice_width(Dh):
    return 256 if Dh % 256 == 0 else 128


def _inputs(shape, seed):
    """q, k, v, dO as bf16 values in float32, (H, T, Dh) torch, from numpy."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                 .to(torch.bfloat16).float() for _ in range(4))


def _tiles(x, nt):
    """(H, T, Dh) -> (H, nt, 64, Dh), rows past T zero (TMA's fill)."""
    H, T, Dh = x.shape
    return F.pad(x, (0, 0, 0, nt * TILE - T)).view(H, nt, TILE, Dh)


def _split_mm(a, b, fault):
    """a @ b for float32 a and bf16-valued b as the tensor cores take it:
    each term of a times b, smallest term first; the planted fault drops
    the middle term."""
    hi, mid, lo = _split3(a)
    terms = (lo, hi) if fault == "term_dropped" else (lo, mid, hi)
    out = terms[0] @ b
    for t in terms[1:]:
        out = out + t @ b
    return out


class _Slices:
    """Per slice: its columns of the outputs, the columns it reads (a
    neighbour's under the planted fault) and its chunk order (one slice
    reverses it under the planted fault)."""

    def __init__(self, Dh, fault):
        self.W = W = _slice_width(Dh)
        self.n = Dh // W
        nc = Dh // CHUNK
        self.cols, self.reads, self.orders = [], [], []
        for s in range(self.n):
            self.cols.append(slice(s * W, (s + 1) * W))
            r = (s + 1) % self.n if fault == "neighbour_columns" and s == self.n - 1 else s
            self.reads.append(slice(r * W, (r + 1) * W))
            order = list(range(nc))
            self.orders.append(order[::-1] if fault == "chunk_out_of_order" and s == 1 else order)


def _chunk_scores(a, b, order):
    """sum over the 64-column chunks in ``order`` of a_c b_c^T, one float32
    addition a chunk: (..., 64, Dh) x (..., 64, Dh) -> (..., 64, 64)."""
    s = None
    for c in order:
        cols = slice(c * CHUNK, (c + 1) * CHUNK)
        part = a[..., cols] @ b[..., cols].transpose(-1, -2)
        s = part if s is None else s + part
    return s


def emulate_forward(q, k, v, causal, fault="sound"):
    """q, k, v (H, T, Dh) float32 holding bf16 values -> (out (H, T, Dh) in
    float32, before its bf16 store; lse (H, T) of slice 0; the largest lse
    difference between slices). Every q tile at once; causal key tiles past
    a q tile's diagonal are fully masked, which leaves m, l and the output
    bit for bit as the kernel's skipping them does."""
    H, T, Dh = q.shape
    nt = -(-T // TILE)
    scale = Dh ** -0.5
    sl = _Slices(Dh, fault)
    qt, kt, vt = (_tiles(x, nt) for x in (q, k, v))
    rows = torch.arange(nt * TILE).view(nt, TILE, 1)
    out = torch.zeros(H, nt, TILE, Dh)
    lses = []
    for s in range(sl.n):
        half = len(sl.orders[s]) // 2
        m = torch.full((H, nt, TILE, 1), tfa.NEG_INF)
        l = torch.zeros(H, nt, TILE, 1)
        acc = torch.zeros(H, nt, TILE, sl.W)
        for j in range(nt):
            kj = kt[:, j, None]
            # the two consumers' partial scores, added
            x = (_chunk_scores(qt, kj, sl.orders[s][:half])
                 + _chunk_scores(qt, kj, sl.orders[s][half:]))
            cols = torch.arange(j * TILE, (j + 1) * TILE)
            x = (x * scale).masked_fill((cols >= T) | (causal & (cols > rows)), tfa.NEG_INF)
            nm = torch.maximum(m, x.amax(-1, keepdim=True))
            corr = torch.exp(m - nm)
            p = torch.exp(x - nm)
            l = l * corr + p.sum(-1, keepdim=True)
            m = nm
            acc = acc * corr + _split_mm(p, vt[:, j, None, :, sl.reads[s]], fault)
        ls = l.clamp_min(1e-30)
        out[..., sl.cols[s]] = acc / ls
        lses.append((m + torch.log(ls)).view(H, nt * TILE)[:, :T])
    disagree = max((x - lses[0]).abs().max().item() for x in lses)
    return out.view(H, nt * TILE, Dh)[:, :T], lses[0], disagree


def emulate_dq(q, k, v, do, lse, delta, causal, fault="sound"):
    """From (H, T, Dh) bf16-valued q, k, v, dO and (H, T) lse and delta ->
    (dq (H, T, Dh) in float32, the largest ds difference between slices).
    Every q tile at once; causal k tiles past a q tile's diagonal give p =
    0, adding exact zeros."""
    H, T, Dh = q.shape
    nt = -(-T // TILE)
    scale = Dh ** -0.5
    sl = _Slices(Dh, fault)
    qt, kt, vt, ot = (_tiles(x, nt) for x in (q, k, v, do))
    lse_t, delta_t = (F.pad(x, (0, nt * TILE - T)).view(H, nt, TILE, 1) for x in (lse, delta))
    rows = torch.arange(nt * TILE).view(nt, TILE, 1)
    dq = torch.zeros(H, nt, TILE, Dh)
    ds_of = []
    for s in range(sl.n):
        acc = torch.zeros(H, nt, TILE, sl.W)
        dss = []
        for j in range(nt):
            cols = torch.arange(j * TILE, (j + 1) * TILE)
            sc = _chunk_scores(qt, kt[:, j, None], sl.orders[s])
            dp = _chunk_scores(ot, vt[:, j, None], sl.orders[s])
            x = (scale * sc).masked_fill(causal & (cols > rows), tfa.NEG_INF)
            p = torch.where(cols < T, torch.exp(x - lse_t), 0.0)
            ds = p * (dp - delta_t)
            dss.append(ds)
            acc = acc + scale * _split_mm(ds, kt[:, j, None, :, sl.reads[s]], fault)
        dq[..., sl.cols[s]] = acc
        ds_of.append(torch.stack(dss))
    disagree = max((x - ds_of[0]).abs().max().item() for x in ds_of)
    return dq.view(H, nt * TILE, Dh)[:, :T], disagree


def emulate_dkv(q, k, v, do, lse, delta, causal, fault="sound"):
    """From (H, T, Dh) bf16-valued q, k, v, dO and (H, T) lse and delta ->
    (dk, dv (H, T, Dh) in float32, the largest p or ds difference between
    slices). Every k tile at once; causal q tiles before a k tile's diagonal
    give p = 0, adding exact zeros."""
    H, T, Dh = q.shape
    nt = -(-T // TILE)
    scale = Dh ** -0.5
    sl = _Slices(Dh, fault)
    qt, kt, vt, ot = (_tiles(x, nt) for x in (q, k, v, do))
    lse_t, delta_t = (F.pad(x, (0, nt * TILE - T)).view(H, nt, TILE) for x in (lse, delta))
    keys = torch.arange(nt * TILE).view(nt, TILE, 1)
    dk, dv = torch.zeros(H, nt, TILE, Dh), torch.zeros(H, nt, TILE, Dh)
    shared = []
    for s in range(sl.n):
        adk, adv = torch.zeros(H, nt, TILE, sl.W), torch.zeros(H, nt, TILE, sl.W)
        pds = []
        for i in range(nt):
            cols = torch.arange(i * TILE, (i + 1) * TILE)
            x = (scale * _chunk_scores(kt, qt[:, i, None], sl.orders[s])).masked_fill(
                causal & (keys > cols), tfa.NEG_INF)  # S^T: keys x queries
            p = torch.where(cols < T, torch.exp(x - lse_t[:, i, None, None, :]), 0.0)
            dp = _chunk_scores(vt, ot[:, i, None], sl.orders[s])  # dP^T
            ds = p * (dp - delta_t[:, i, None, None, :])
            pds.append(torch.stack((p, ds)))
            adv = adv + _split_mm(p, ot[:, i, None, :, sl.reads[s]], fault)
            adk = adk + _split_mm(ds, qt[:, i, None, :, sl.reads[s]], fault)
        dk[..., sl.cols[s]], dv[..., sl.cols[s]] = scale * adk, adv
        shared.append(torch.stack(pds))
    disagree = max((x - shared[0]).abs().max().item() for x in shared)
    return (dk.view(H, nt * TILE, Dh)[:, :T], dv.view(H, nt * TILE, Dh)[:, :T], disagree)


def _bthd(x):
    """(H, T, Dh) -> (1, T, H, Dh)."""
    return x.permute(1, 0, 2)[None]


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _emulate_all(q, k, v, do, causal, fault):
    """The forward, then dq and dk/dv from its lse and delta, as the port's
    backward forms them: ({name: value}, {kernel: slice disagreement})."""
    out, lse, d_fwd = emulate_forward(q, k, v, causal, fault)
    delta = (do * out).sum(-1)
    dq, d_dq = emulate_dq(q, k, v, do, lse, delta, causal, fault)
    dk, dv, d_dkv = emulate_dkv(q, k, v, do, lse, delta, causal, fault)
    return ({"out": out, "lse": lse, "delta": delta, "dq": dq, "dk": dk, "dv": dv},
            {"forward": d_fwd, "dq": d_dq, "dkv": d_dkv})


def _vs_plain(got, q, k, v, do, causal):
    """The largest error / max|plain| of out, lse, dq, dk, dv against the
    port's plain versions (dq, dk, dv from the emulation's lse and delta)."""
    bq, bk, bv, bdo = (_bthd(x) for x in (q, k, v, do))
    lse, delta = got["lse"][:, None], got["delta"][:, None]
    out_p, lse_p = tfa.flash_forward_plain(bq, bk, bv, causal)
    dq_p = tfa.flash_dq_plain(bq, bk, bv, bdo, lse, delta, causal)
    dk_p, dv_p = tfa.flash_dkv_plain(bq, bk, bv, bdo, lse, delta, causal)
    errs = {"out": _rel(_bthd(got["out"]), out_p), "dq": _rel(_bthd(got["dq"]), dq_p),
            "dk": _rel(_bthd(got["dk"]), dk_p), "dv": _rel(_bthd(got["dv"]), dv_p)}
    errs["lse"] = (got["lse"] - lse_p[:, 0]).abs().max().item()
    return errs


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Dh", [512, 1536])
def test_wide_kernel_arithmetic_is_float32_exact(Dh, causal):
    """At (1, 512, 1, Dh): out, lse, dq, dk and dv within EXACT_TOL (1e-5)
    of the plain versions, which sum the same float32 products in another
    order; every slice holds the same lse, p and ds bit for bit."""
    q, k, v, do = _inputs((1, 512, Dh), seed=Dh + causal)
    got, disagree = _emulate_all(q, k, v, do, causal, "sound")
    errs = _vs_plain(got, q, k, v, do, causal)
    assert max(errs.values()) <= EXACT_TOL, errs
    assert disagree == {"forward": 0.0, "dq": 0.0, "dkv": 0.0}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Dh", [512, 1536])
def test_wide_kernel_arithmetic_matches_jax(Dh, causal):
    """At a ragged (1, 200, 1, Dh) (the last tile 8 rows, the rest
    zero-filled), the emulated out, dq, dk and dv against the JAX package's
    dense attention and its gradients through jax.vjp, on the same
    bf16-valued inputs, within the tolerances the plain versions are held
    to."""
    q, k, v, do = _inputs((1, 200, Dh), seed=Dh + 2 + causal)
    got, _ = _emulate_all(q, k, v, do, causal, "sound")

    def attend(q, k, v):
        return jatt.multihead_attention(q, k, v, causal=causal, impl="dense")

    jq, jk, jv = (jnp.asarray(_bthd(x).numpy()) for x in (q, k, v))
    want, vjp = jax.vjp(attend, jq, jk, jv)
    jdq, jdk, jdv = vjp(jnp.asarray(_bthd(do).numpy()))
    np.testing.assert_allclose(_bthd(got["out"]).numpy(), np.asarray(want), atol=FWD_ATOL)
    for name, w in (("dq", jdq), ("dk", jdk), ("dv", jdv)):
        np.testing.assert_allclose(_bthd(got[name]).numpy(), np.asarray(w), atol=GRAD_ATOL)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_limits(fault):
    """At (1, 256, 1, 512), causal: the sound arithmetic passes both limits
    (EXACT_TOL of the plain versions, slices in bit-for-bit agreement);
    each planted fault fails one. A slice that reads its neighbour's columns
    errs by O(1) and dropping the middle split term by ~2^-9 of p; a slice
    that sums its score chunks out of order stays within float32 noise but
    disagrees with the other slice in every kernel."""
    q, k, v, do = _inputs((1, 256, 512), seed=30)
    got, disagree = _emulate_all(q, k, v, do, True, fault)
    err = max(_vs_plain(got, q, k, v, do, True).values())
    if fault == "sound":
        assert err <= EXACT_TOL and max(disagree.values()) == 0.0, (err, disagree)
    elif fault == "chunk_out_of_order":
        assert err <= EXACT_TOL and min(disagree.values()) > 0.0, (err, disagree)
    else:
        assert err > EXACT_TOL, err
