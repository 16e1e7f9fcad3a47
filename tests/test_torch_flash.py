"""Port vs JAX package: flash attention and the attention dispatch.

The port's ``flash_attention`` (on the CPU, its plain versions through the
same ``torch.autograd.Function`` that launches the CUDA kernels on the card)
is held against the JAX ``flash_attention``, which runs its Pallas kernels
in interpret mode off the TPU, as ``tests/test_flash_attention.py`` runs it.
The dispatch guards and ``auto_attention_impl`` must decide as the JAX
package decides. The CUDA kernels are held to the plain versions on the
card (``cuda`` marker; skips without one).
"""

import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_default_matmul_precision", "highest")

from fedml_tpu.ops import attention as jatt  # noqa: E402
from fedml_tpu_torch.ops import attention as tatt  # noqa: E402
from fedml_tpu_torch.ops import flash_attention as tfa  # noqa: E402

jfa = importlib.import_module("fedml_tpu.ops.pallas.flash_attention")

# the JAX package's own flash tolerances (tests/test_flash_attention.py):
# float32 sums over <= 256 keys in another order
FWD_ATOL = 2e-5
GRAD_ATOL = 1e-4


def _qkv(B=2, T=256, H=2, Dh=64, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, T, H, Dh)).astype(np.float32) for _ in range(4))


def _cotangent(shape):
    # non-uniform, so dq/dk/dv are exercised beyond sum(); as the JAX test
    return np.cos(np.arange(np.prod(shape)).reshape(shape) * 0.01).astype(np.float32)


def _torch_grads(fn, q, k, v, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("T", [256, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_and_grads_match_jax(T, causal):
    q, k, v, _ = _qkv(T=T)
    g = _cotangent(q.shape)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, causal)

    def jloss(q, k, v):
        return (jfa.flash_attention(q, k, v, causal) * g).sum()

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    out, grads = _torch_grads(lambda q, k, v: tfa.flash_attention(q, k, v, causal), q, k, v, g)
    np.testing.assert_allclose(out, np.asarray(want), atol=FWD_ATOL)
    for got, w in zip(grads, jgrads):
        np.testing.assert_allclose(got, np.asarray(w), atol=GRAD_ATOL)
    # the forward's saved logsumexp, in the TPU kernel's (B*H, 1, T) layout
    bq = jfa.auto_block(T)
    _, jlse = jfa._flash_forward(jq, jk, jv, causal, bq, bq, True)
    _, lse = tfa.flash_forward(*map(torch.from_numpy, (q, k, v)), causal)
    assert tuple(lse.shape) == tuple(jlse.shape)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=FWD_ATOL)


@pytest.mark.parametrize("T,causal", [(77, True), (77, False), (130, True)])
def test_plain_versions_at_ragged_t_match_jax_dense(monkeypatch, T, causal):
    """The plain versions (the card's reference) at a T the TPU kernel cannot
    tile, chunked over query rows, against JAX's dense attention."""
    monkeypatch.setattr(tfa, "PLAIN_ROWS", 32)
    q, k, v, _ = _qkv(B=2, T=T, H=3, Dh=64, seed=1)
    g = _cotangent(q.shape)
    jq, jk, jv = map(jnp.asarray, (q, k, v))

    def jloss(q, k, v):
        return (jatt.multihead_attention(q, k, v, causal=causal, impl="dense") * g).sum()

    want = jatt.multihead_attention(jq, jk, jv, causal=causal, impl="dense")
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    out, grads = _torch_grads(lambda q, k, v: tfa._FlashAttention.apply(q, k, v, causal),
                              q, k, v, g)
    np.testing.assert_allclose(out, np.asarray(want), atol=FWD_ATOL)
    for got, w in zip(grads, jgrads):
        np.testing.assert_allclose(got, np.asarray(w), atol=GRAD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_attention_matches_jax(causal, dtype):
    q, k, v, _ = _qkv(B=2, T=64, H=2, Dh=32, seed=2)
    want = jatt.multihead_attention(*(jnp.asarray(a, dtype) for a in (q, k, v)),
                                    causal=causal, impl="dense")
    tdt = getattr(torch, dtype)
    got = tatt.multihead_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                                   causal=causal, impl="dense")
    assert got.dtype == tdt
    # bf16: both sides round logits, probabilities and output to bf16 at the
    # same points, but XLA and torch sum the products in another order
    atol = FWD_ATOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol)


def test_auto_attention_impl_matches_jax():
    # tests/test_flash_attention.py:76-82, and the LM slice's attention
    cases = {(4, 8, 2048, 64): "dense", (16, 16, 2048, 64): "flash",
             (1, 1, 8192, 64): "flash", (16, 16, 2048, 48): "dense",
             (2, 16, 8192, 64): "flash"}
    for args, want in cases.items():
        assert tatt.auto_attention_impl(*args) == jatt.auto_attention_impl(*args) == want
    for B in (1, 2, 4, 16):
        for H in (1, 8, 16):
            for T in (100, 128, 256, 1024, 2048, 4096, 8192, 8200, 16384):
                for Dh in (32, 48, 64, 128, 256):
                    for itemsize in (2, 4):
                        args = (B, H, T, Dh, itemsize)
                        assert tatt.auto_attention_impl(*args) == \
                            jatt.auto_attention_impl(*args), args


def test_dispatch_guards_match_jax():
    for T in (100, 128, 256, 384, 640, 896, 1024, 2048, 8192, 8200, 12288, 16384, 65536):
        assert tfa.auto_block(T) == jfa.auto_block(T), T
        for Dh in (48, 64, 128, 256):
            for itemsize in (2, 4):
                assert tfa.flash_shapes_ok(T, Dh, itemsize=itemsize) == \
                    jfa.flash_shapes_ok(T, Dh, itemsize=itemsize), (T, Dh, itemsize)
                assert tfa.flash_vmem_ok(T, Dh, itemsize) == jfa.flash_vmem_ok(T, Dh, itemsize)
        for Dh, itemsize in ((64, 2), (128, 4)):
            try:
                want = jfa._resolve_blocks(T, None, None, Dh=Dh, itemsize=itemsize)
            except ValueError:
                with pytest.raises(ValueError):
                    tfa._resolve_blocks(T, Dh=Dh, itemsize=itemsize)
            else:
                assert tfa._resolve_blocks(T, Dh=Dh, itemsize=itemsize) == want
    assert tfa.BLOCK_TABLE == jfa.BLOCK_TABLE == {}
    assert tfa.NEG_INF == jfa.NEG_INF


def test_multihead_attention_routes_by_dispatch(monkeypatch):
    calls = []
    monkeypatch.setattr(tatt, "flash_attention",
                        lambda q, k, v, causal: calls.append((tuple(q.shape), causal)) or q)
    q = torch.zeros(1, 8192, 1, 64, dtype=torch.bfloat16)
    assert tatt.multihead_attention(q, q, q, causal=True) is q
    small = torch.zeros(1, 128, 1, 64)
    assert tatt.multihead_attention(small, small, small, impl="flash") is small
    tatt.multihead_attention(small, small, small)  # auto: dense at T = 128
    assert calls == [((1, 8192, 1, 64), True), ((1, 128, 1, 64), False)]
    with pytest.raises(ValueError):
        tatt.multihead_attention(q, q, q, impl="ring")


def test_dense_fallback_at_long_t_warns(monkeypatch, caplog):
    """An untileable long T falls back to dense loudly, as in JAX."""
    monkeypatch.setattr(torch, "einsum", lambda eq, a, b: torch.zeros(()))
    q = torch.zeros(1, 8200, 1, 64, dtype=torch.bfloat16)
    with caplog.at_level(logging.WARNING):
        tatt.multihead_attention(q, q, q)
    assert "DENSE O(T^2)" in caplog.text


def test_flash_attention_refuses_untileable_t_as_jax_does():
    q = torch.zeros(1, 100, 1, 64)
    with pytest.raises(ValueError, match="block tiling"):
        tfa.flash_attention(q, q, q)
    # the kernel wrappers themselves take any T
    out, lse = tfa.flash_forward(q, q, q, True)
    assert out.shape == q.shape and tuple(lse.shape) == (1, 1, 100)


def test_wrappers_validate_operands():
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError):
        tfa.flash_forward(q, q[:, :64], q, True)  # shapes differ
    with pytest.raises(ValueError):
        tfa.flash_forward(q, q.double(), q, True)  # dtypes differ
    with pytest.raises(ValueError):
        tfa.flash_forward(q.half(), q.half(), q.half(), True)  # no fp16 kernel


# |kernel - plain| / max|plain|, plain in float32: up to T * Dh products per
# output summed in another order (sqrt(n) * 2^-24 ~ 1e-5 of the magnitudes
# at these sizes); a bf16 output may sit one bf16 step (2^-7) from the
# rounded plain value
CARD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-4 + 2.0 ** -7}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,causal", [((2, 1024, 4, 64), torch.bfloat16, True),
                                                ((1, 512, 2, 128), torch.float32, False),
                                                ((3, 333, 2, 64), torch.float32, True),
                                                ((1, 1000, 4, 64), torch.bfloat16, False),
                                                ((2, 100, 3, 128), torch.bfloat16, True),
                                                ((2, 333, 3, 256), torch.bfloat16, True),
                                                ((1, 1000, 2, 256), torch.bfloat16, False),
                                                ((3, 130, 2, 256), torch.float32, True),
                                                ((1, 256, 2, 256), torch.float32, False),
                                                ((2, 333, 3, 384), torch.bfloat16, True),
                                                ((1, 1000, 2, 384), torch.bfloat16, False),
                                                ((3, 130, 2, 384), torch.float32, True),
                                                ((1, 1000, 2, 384), torch.float32, False),
                                                ((2, 333, 3, 384), torch.float32, True),
                                                ((2, 333, 3, 512), torch.bfloat16, True),
                                                ((1, 1000, 2, 1024), torch.bfloat16, False),
                                                ((1, 300, 2, 1536), torch.bfloat16, True)])
def test_flash_kernels_match_plain_on_card(shape, dtype, causal):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(*shape, generator=g).cuda().to(dtype) for _ in range(4))
    out, lse = tfa.flash_forward(q, k, v, causal)
    delta = tfa.attention_delta(do, out)
    dq = tfa.flash_dq(q, k, v, do, lse, delta, causal)
    dk, dv = tfa.flash_dkv(q, k, v, do, lse, delta, causal)
    f = [t.float() for t in (q, k, v, do)]
    want = [tfa.flash_forward_plain(*f[:3], causal)[0], tfa.flash_dq_plain(*f, lse, delta, causal),
            *tfa.flash_dkv_plain(*f, lse, delta, causal)]
    for got, w in zip((out, dq, dk, dv), want):
        assert ((got.float() - w).abs().max() / w.abs().max()).item() < CARD_TOL[dtype]
    assert torch.equal(dq, tfa.flash_dq(q, k, v, do, lse, delta, causal))


@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_route_sends_bf16_forward_and_dkv_to_the_tensor_cores(Dh):
    """float32 to the FMA kernels at Dh 64; the forward, dq and dk/dv at Dh
    256 and the forward at Dh 128 run on the tensor cores in three TF32
    products (flash_f32_sm90), dq and dk/dv at Dh 128 likewise on wgmma
    (flash_f32_wgmma_sm90); bf16 to the wgmma kernels, the forward, dq and
    dk/dv at Dh 256 to their own design (scores once, TMA)."""
    for name in ("fedml_flash_fwd", "fedml_flash_dq", "fedml_flash_dkv"):
        want = ("flash_attention", name)
        if Dh == 256 or (Dh == 128 and name == "fedml_flash_fwd"):
            want = ("flash_f32_sm90", name + "_f32_sm90")
        elif Dh == 128:
            want = ("flash_f32_wgmma_sm90", name + "_f32wg_sm90")
        assert tfa.route(name, torch.float32, Dh) == want
    if Dh == 256:
        fwd_dkv = ("flash_dh256_sm90", "_dh256_sm90")
    else:
        fwd_dkv = ("flash_attention_sm90", "_sm90")
    assert tfa.route("fedml_flash_fwd", torch.bfloat16, Dh) == \
        (fwd_dkv[0], "fedml_flash_fwd" + fwd_dkv[1])
    assert tfa.route("fedml_flash_dkv", torch.bfloat16, Dh) == \
        (fwd_dkv[0], "fedml_flash_dkv" + fwd_dkv[1])
    assert tfa.route("fedml_flash_dq", torch.bfloat16, Dh) == \
        (fwd_dkv[0], "fedml_flash_dq" + fwd_dkv[1])


# --- the tensor-core kernels' arithmetic, emulated on the CPU -----------------

# chip_smoke.FLASH_MISMATCH_SHARE: the share of bf16 outputs the card's gate
# lets differ from the exactly rounded value
GATE_SHARE = 0.0025


def _top16(x: torch.Tensor) -> torch.Tensor:
    """x rounded toward zero to bf16 (its top 16 bits), as a float32 tensor."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _split3(x: torch.Tensor):
    """A float32 tensor as three bf16-valued terms hi + mid + lo, as
    ``split3`` in fedml_tpu_torch/csrc/flash_attention_sm90.cu:232 does it."""
    hi = _top16(x)
    mid = _top16(x - hi)
    return hi, mid, _top16(x - hi - mid)


def _split_mm(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """a @ b for float32 a and bf16-valued b as the tensor cores take it: each
    term of a times b (exact products, float32 sums), smallest term first."""
    parts = _split3(a)[:terms]
    out = parts[-1] @ b
    for t in reversed(parts[:-1]):
        out = out + t @ b
    return out


def _vs_exact(got32: torch.Tensor, exact: torch.Tensor):
    """(share of bf16 outputs off the exactly rounded value, error / max|exact|)."""
    share = (got32.to(torch.bfloat16) != exact.float().to(torch.bfloat16)).double().mean()
    return share.item(), ((got32.double() - exact).abs().max() / exact.abs().max()).item()


def test_three_term_split_is_exact():
    """hi + mid + lo == x wherever lo is a normal number (|x| >= 2^-102);
    below that lo keeps its top 16 bits, an error under 2^-133."""
    rng = np.random.default_rng(6)
    big = np.concatenate([rng.standard_normal(4096), rng.random(4096) * 1e-30 + 1e-30,
                          -rng.random(4096) * 3e38, [1.0, -2.5, np.finfo(np.float32).max]])
    tiny = np.concatenate([rng.random(4096) * 1e-33, [0.0, 1e-45]])
    for vals, exact in ((big, True), (tiny, False)):
        x = torch.from_numpy(vals.astype(np.float32))
        hi, mid, lo = _split3(x)
        for t in (hi, mid, lo):  # each term is a bf16 value
            assert torch.equal(t.to(torch.bfloat16).float(), t)
        if exact:
            assert torch.equal(hi + mid + lo, x)
        else:
            assert (hi + mid + lo - x).abs().max().item() < 2.0 ** -133


def test_three_term_split_products_are_float32_exact():
    """At (1, 2048, 4, 64) bf16 causal, the products with a float32 operand
    (P V, P^T dO, dS^T Q, dS K) taken as three bf16 terms, f32 sums: out, dv,
    dk and dq against float64 stay within float32 summation noise and almost
    never move a bf16 output; p rounded once to bf16 moves far more than the
    gate allows. dq sums its 64-key tiles as the kernel does: each tile's
    split product from zero, then scale times it added in float32."""
    B, T, H, Dh = 1, 2048, 4, 64
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((H, T, Dh), dtype=np.float32))
                   .to(torch.bfloat16).float() for _ in range(4))
    scale = Dh ** -0.5
    above = torch.ones(T, T, dtype=torch.bool).triu(1)
    names = ("out", "dv", "dk", "dq")
    got, want, one_term = {n: [] for n in names}, {n: [] for n in names}, []
    for h in range(H):
        qh, kh, vh, doh = q[h], k[h], v[h], do[h]
        # exact, in float64
        s64 = (qh.double() @ kh.double().T * scale).masked_fill(above, float("-inf"))
        lse64 = torch.logsumexp(s64, -1, keepdim=True)
        p64 = torch.exp(s64 - lse64)
        out64 = p64 @ vh.double()
        delta64 = (doh.double() * out64).sum(-1, keepdim=True)
        ds64 = p64 * (doh.double() @ vh.double().T - delta64)
        want["out"].append(out64)
        want["dv"].append(p64.T @ doh.double())
        want["dk"].append(scale * (ds64.T @ qh.double()))
        want["dq"].append(scale * (ds64 @ kh.double()))
        # the kernels: bf16 x bf16 products exact with float32 sums
        s32 = (qh @ kh.T * scale).masked_fill(above, tfa.NEG_INF)
        p = torch.exp(s32 - s32.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        got["out"].append(_split_mm(p, vh) / l)
        one_term.append(_split_mm(p, vh, terms=1) / l)
        pb = torch.exp(s32 - lse64.float())
        ds = pb * (doh @ vh.T - delta64.float())
        got["dv"].append(_split_mm(pb.T.contiguous(), doh))
        got["dk"].append(scale * _split_mm(ds.T.contiguous(), qh))
        dq = torch.zeros(T, Dh)
        for k0 in range(0, T, 64):
            dq += scale * _split_mm(ds[:, k0:k0 + 64].contiguous(), kh[k0:k0 + 64])
        got["dq"].append(dq)
    for name in got:
        share, err = _vs_exact(torch.stack(got[name]), torch.stack(want[name]))
        assert share <= GATE_SHARE / 4, (name, share)
        assert err <= 1e-5, (name, err)  # float32 summation noise over <= 2048 terms
    share, _ = _vs_exact(torch.stack(one_term), torch.stack(want["out"]))
    assert share > 10 * GATE_SHARE, share
