"""The arithmetic of the float32 Dh-256 flash forward and dq on the tensor
cores (``fedml_tpu_torch/csrc/flash_f32_sm90.cu``), emulated on the CPU.

The CUDA kernels run only on the card. Here their arithmetic is written out
in float32 torch, tile by tile, as the kernels order it:

- every product is three TF32 products: each operand split where it is
  loaded into hi = cvt.rna.tf32(v) and lo = v - hi, lo read by the tensor
  core with its low 13 bits dropped (``tests/test_torch_conv.py``'s
  ``_split``), and lo hi, hi lo, hi hi summed smallest first;
- forward: q scaled before the product; each 64-row q tile's scores against
  each 32-key tile over all 256 columns, masked with finfo(float32).min, the
  online softmax per key tile (l clamped at 1e-30), P V from a zero
  accumulator per key tile, added to the output in float32 after the
  rescale by corr;
- dq: per q tile and 16-key tile, S = Q K^T and dP = dO V^T over all 256
  columns, p = exp(scale S - lse), ds = p (dP - delta), and dS K from a zero
  accumulator per key tile, scale times it added to dq in float32.

The tensor core's own order inside one product is not reproduced: each of
the three products is one float32 matrix product here. Held against float64
at (1, 1024, 2, 256) and against the JAX package's ``flash_attention``,
whose Pallas kernels run in interpret mode off the TPU, at (1, 256, 2, 256),
and against its dense attention at a ragged T (its flash refuses a T without
a block tiling), within the tolerances ``tests/test_torch_flash_dh256.py``
holds the plain versions to. Planted faults (the hi hi product alone, one
key tile dropped) fail the same limits. The kernels themselves are held to
the plain versions on the card by ``chip_smoke.py`` and
``tests/test_torch_flash.py::test_flash_kernels_match_plain_on_card``.
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
from test_torch_flash_dh256 import FWD_ATOL, GRAD_ATOL  # noqa: E402

jfa = importlib.import_module("fedml_tpu.ops.pallas.flash_attention")

ROWS = 64      # q rows of a block
FWD_KEYS = 32  # rows of the forward's k and v tiles
DQ_KEYS = 16   # rows of dq's k and v tiles
# against float64, relative to the largest exact value: three TF32 products
# leave ~1.2e-6 of the magnitudes, float32 sums over <= 1024 terms a few
# 1e-7 more; one TF32 product alone errs by ~2^-11 ~ 5e-4
EXACT_TOL = 1e-5


def _tf32x3(a, b, terms=3):
    """a @ b as the kernels multiply, from the operands' (hi, lo) splits:
    the products lo hi, hi lo and hi hi summed smallest first; ``terms=1``
    keeps hi hi alone (one TF32 product: a planted fault)."""
    (ah, al), (bh, bl) = a, b
    prods = (al @ bh, ah @ bl, ah @ bh)[3 - terms:]
    out = prods[0]
    for p in prods[1:]:
        out = out + p
    return out


def _split_t(x):
    """The split of x's transpose over its last two axes."""
    return tuple(t.transpose(-1, -2) for t in _split(x))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulations are many small tensor operations: torch's thread pool
    over several test workers at once spends its time waiting, not
    computing, so they run on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiles(x, rows, n):
    """(H, T, Dh) -> (H, n, rows, Dh), rows past T zero (cp.async's fill)."""
    H, T, Dh = x.shape
    return F.pad(x, (0, 0, 0, n * rows - T)).view(H, n, rows, Dh)


def emulate_forward(q, k, v, causal, terms=3, drop_key=None, rows=ROWS, keys=FWD_KEYS):
    """q, k, v (H, T, Dh) float32, Dh 128 or 256 -> (out (H, T, Dh), lse
    (H, T)), in blocks of ``rows`` q rows and tiles of ``keys`` k/v rows.
    Every q tile at once; causal key tiles past a q tile's diagonal are
    fully masked, which leaves m, l and the output as the kernel's skipping
    them does. ``drop_key``: the key tile that holds it is left out (a
    planted fault)."""
    H, T, Dh = q.shape
    nq, nk = -(-T // rows), -(-T // keys)
    scale = Dh ** -0.5
    qt = _split(_tiles(q * scale, rows, nq))  # scaled before the product
    kt, vt = _tiles(k, keys, nk), _tiles(v, keys, nk)
    qrows = torch.arange(nq * rows).view(nq, rows, 1)
    m = torch.full((H, nq, rows, 1), tfa.NEG_INF)
    l = torch.zeros(H, nq, rows, 1)
    acc = torch.zeros(H, nq, rows, Dh)
    for j in range(nk):
        if drop_key is not None and j == drop_key // keys:
            continue
        s = _tf32x3(qt, _split_t(kt[:, j, None]), terms)
        cols = torch.arange(j * keys, (j + 1) * keys)
        x = s.masked_fill((cols >= T) | (causal & (cols > qrows)), tfa.NEG_INF)
        nm = torch.maximum(m, x.amax(-1, keepdim=True))
        corr = torch.exp(m - nm)
        p = torch.exp(x - nm)
        l = l * corr + p.sum(-1, keepdim=True)
        m = nm
        acc = acc * corr + _tf32x3(_split(p), _split(vt[:, j, None]), terms)  # from zero
    ls = l.clamp_min(1e-30)
    out = (acc / ls).view(H, nq * rows, Dh)[:, :T]
    return out, (m + torch.log(ls)).view(H, nq * rows)[:, :T]


def in_fragment_order(f, x, key_order):
    """The operands of an output product F X (f (..., M, K), x (..., K, N))
    as a kernel pairs them when F comes from a score accumulator: the k
    index j of each 8-step holds f's column a[j] and x's row b[j], key_order
    = (a, b), permutations of range(8). Sound when a == b (the sum is F X in
    another order); None keeps both in order."""
    if key_order is None:
        return f, x
    a, b = (torch.tensor(o) + 8 * torch.arange(f.shape[-1] // 8)[:, None] for o in key_order)
    return f[..., a.reshape(-1)], x[..., b.reshape(-1), :]


def emulate_dq(q, k, v, do, lse, delta, causal, terms=3, drop_key=None, rows=ROWS,
               keys=DQ_KEYS, key_order=None, combine=None, scale=None):
    """From (H, T, Dh) q, k, v, dO and (H, T) lse and delta -> dq (H, T,
    Dh), in blocks of ``rows`` q rows and tiles of ``keys`` k/v rows; dS K
    with its keys paired by ``key_order`` (:func:`in_fragment_order`).
    Every q tile at once; causal key tiles past a q tile's diagonal give p
    = 0, adding exact zeros. ``combine`` maps each score product (S, dP)
    before its use (a cluster's sum of its column parts' partial scores,
    the heads then being column parts); ``scale`` defaults to Dh ** -0.5."""
    H, T, Dh = q.shape
    nq, nk = -(-T // rows), -(-T // keys)
    scale = Dh ** -0.5 if scale is None else scale
    qt, ot = _split(_tiles(q, rows, nq)), _split(_tiles(do, rows, nq))
    kt, vt = _tiles(k, keys, nk), _tiles(v, keys, nk)
    lse_t, delta_t = (F.pad(x, (0, nq * rows - T)).view(H, nq, rows, 1) for x in (lse, delta))
    qrows = torch.arange(nq * rows).view(nq, rows, 1)
    dq = torch.zeros(H, nq, rows, Dh)
    for j in range(nk):
        if drop_key is not None and j == drop_key // keys:
            continue
        cols = torch.arange(j * keys, (j + 1) * keys)
        s = _tf32x3(qt, _split_t(kt[:, j, None]), terms)
        dp = _tf32x3(ot, _split_t(vt[:, j, None]), terms)
        if combine is not None:
            s, dp = combine(s), combine(dp)
        x = (scale * s).masked_fill((cols >= T) | (causal & (cols > qrows)), tfa.NEG_INF)
        p = torch.exp(x - lse_t)
        ds, kj = in_fragment_order(p * (dp - delta_t), kt[:, j, None], key_order)
        dq = dq + scale * _tf32x3(_split(ds), _split(kj), terms)  # per key tile, from zero
    return dq.view(H, nq * rows, Dh)[:, :T]


def _inputs(shape, seed):
    """q, k, v, dO as float32 numpy arrays, (B, T, H, Dh)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32) for _ in range(4))


def _heads(a):
    """(1, T, H, Dh) numpy -> (H, T, Dh) float32 torch."""
    return torch.from_numpy(a[0]).permute(1, 0, 2).contiguous()


def _jax_layout(x):
    """(H, T, Dh) torch -> (1, T, H, Dh) numpy."""
    return x.permute(1, 0, 2)[None].numpy()


def _exact(q, k, v, do, causal):
    """(out, lse, delta, dq, dk, dv) in float64 from float32 (H, T, Dh)
    inputs."""
    T, Dh = q.shape[1], q.shape[2]
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    s64 = Dh ** -0.5 * (q64 @ k64.transpose(1, 2))
    if causal:
        s64 = s64.masked_fill(torch.ones(T, T, dtype=torch.bool).triu(1), float("-inf"))
    lse64 = torch.logsumexp(s64, -1)
    p64 = torch.exp(s64 - lse64[..., None])
    out64 = p64 @ v64
    delta64 = (do64 * out64).sum(-1)
    ds64 = p64 * (do64 @ v64.transpose(1, 2) - delta64[..., None])
    return (out64, lse64, delta64, Dh ** -0.5 * (ds64 @ k64),
            Dh ** -0.5 * (ds64.transpose(1, 2) @ q64), p64.transpose(1, 2) @ do64)


def _rel(got, exact):
    return ((got.double() - exact).abs().max() / exact.abs().max()).item()


# the sound arithmetic and its planted faults: (terms, a key whose tile is
# left out)
FAULTS = {"sound": (3, None), "hi_hi_only": (1, None), "key_tile_dropped": (3, 100)}


@pytest.fixture(scope="module")
def t1024():
    """(1, 1024, 2, 256) inputs as (H, T, Dh) and their float64 results,
    causal and full."""
    q, k, v, do = (_heads(a) for a in _inputs((1, 1024, 2, 256), seed=21))
    return (q, k, v, do), {c: _exact(q, k, v, do, c) for c in (True, False)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh256_arithmetic_is_float32_exact(t1024, causal, fault):
    """At (1, 1024, 2, 256), out, lse and dq (from float64's lse and delta,
    so that dq's own arithmetic is what is held) against float64: within
    EXACT_TOL of the largest exact value when sound; each planted fault
    fails that limit for out and for dq."""
    (q, k, v, do), exact = t1024
    out64, lse64, delta64, dq64 = exact[causal][:4]
    terms, drop = FAULTS[fault]
    out, lse = emulate_forward(q, k, v, causal, terms, drop)
    dq = emulate_dq(q, k, v, do, lse64.float(), delta64.float(), causal, terms, drop)
    errs = (_rel(out, out64), _rel(dq, dq64))
    if fault == "sound":
        assert (lse.double() - lse64).abs().max().item() <= EXACT_TOL
        assert max(errs) <= EXACT_TOL, errs
    else:
        assert min(errs) > EXACT_TOL, errs


@pytest.fixture(scope="module")
def jax_t256():
    """(1, 256, 2, 256) inputs and, causal and full, the JAX package's
    flash_attention output, lse and dq on them (Pallas in interpret mode)."""
    q, k, v, do = _inputs((1, 256, 2, 256), seed=22)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    bq = jfa.auto_block(256)
    want = {}
    for causal in (True, False):
        jout, vjp = jax.vjp(lambda q: jfa.flash_attention(q, jk, jv, causal), jq)
        _, jlse = jfa._flash_forward(jq, jk, jv, causal, bq, bq, True)
        want[causal] = (np.asarray(jout), np.asarray(jlse)[:, 0],
                        np.asarray(vjp(jnp.asarray(do))[0]))
    return (q, k, v, do), want


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh256_arithmetic_matches_jax(jax_t256, causal, fault):
    """At (1, 256, 2, 256), the emulated out, lse and dq (lse and delta from
    the emulated forward, as the port's backward forms them) against the JAX
    package's flash_attention, its lse and its gradient, within FWD_ATOL and
    GRAD_ATOL when sound; each planted fault fails those limits."""
    (q, k, v, do), want = jax_t256
    jout, jlse, jdq = want[causal]
    th = [_heads(a) for a in (q, k, v, do)]
    terms, drop = FAULTS[fault]
    out, lse = emulate_forward(*th[:3], causal, terms, drop)
    dq = emulate_dq(*th, lse, (th[3] * out).sum(-1), causal, terms, drop)
    checks = ((_jax_layout(out), jout, FWD_ATOL), (lse.numpy(), jlse, FWD_ATOL),
              (_jax_layout(dq), jdq, GRAD_ATOL))
    if fault == "sound":
        for got, w, atol in checks:
            np.testing.assert_allclose(got, w, atol=atol)
    else:
        for got, w, atol in (checks[0], checks[2]):
            assert np.abs(got - w).max() > atol


@pytest.mark.parametrize("causal", [True, False])
def test_f32_dh256_arithmetic_at_ragged_t_matches_jax_dense(causal):
    """At (1, 130, 2, 256), a T that is a multiple of no tile (the kernels
    zero-fill and mask the rows and columns past it), against the JAX
    package's dense attention and its gradient: its flash_attention refuses
    a T without a block tiling."""
    q, k, v, do = _inputs((1, 130, 2, 256), seed=23)
    jq, jk, jv = map(jnp.asarray, (q, k, v))

    def jattn(q):
        return jatt.multihead_attention(q, jk, jv, causal=causal, impl="dense")

    jout, vjp = jax.vjp(jattn, jq)
    jdq = vjp(jnp.asarray(do))[0]
    th = [_heads(a) for a in (q, k, v, do)]
    out, lse = emulate_forward(*th[:3], causal)
    dq = emulate_dq(*th, lse, (th[3] * out).sum(-1), causal)
    np.testing.assert_allclose(_jax_layout(out), np.asarray(jout), atol=FWD_ATOL)
    np.testing.assert_allclose(_jax_layout(dq), np.asarray(jdq), atol=GRAD_ATOL)


@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_sends_f32_tensor_core_kernels_to_flash_f32_sm90(Dh, dtype):
    """The float32 forward, dq and dk/dv at Dh 256 and the float32 forward
    at Dh 128 go to flash_f32_sm90; float32 dq and dk/dv at Dh 128 to
    flash_f32_wgmma_sm90; every float32 kernel at Dh 64 keeps the FMA
    kernels, bf16 keeps the wgmma kernels."""
    assert "flash_f32_sm90" in tops.KERNELS and "flash_f32_wgmma_sm90" in tops.KERNELS
    for name in ("fedml_flash_fwd", "fedml_flash_dq", "fedml_flash_dkv"):
        lib, entry = tfa.route(name, dtype, Dh)
        if dtype == torch.float32 and (Dh == 256 or (Dh == 128 and name == "fedml_flash_fwd")):
            assert (lib, entry) == ("flash_f32_sm90", name + "_f32_sm90")
        elif dtype == torch.float32 and Dh == 128:
            assert (lib, entry) == ("flash_f32_wgmma_sm90", name + "_f32wg_sm90")
        elif dtype == torch.float32:
            assert (lib, entry) == ("flash_attention", name)
        else:
            assert lib in ("flash_attention_sm90", "flash_dh256_sm90")


@pytest.mark.parametrize("T", [4096, 4352, 4608])
def test_wide_f32_dispatch_matches_jax(T):
    """The wide float32 LM's attention (B 8, H 8, Dh 256, 4-byte items):
    the port's auto dispatch decides as the JAX package's, flash at T 4352
    only of these."""
    got = tatt.auto_attention_impl(8, 8, T, 256, 4)
    assert got == jatt.auto_attention_impl(8, 8, T, 256, 4)
    assert got == ("flash" if T == 4352 else "dense")
