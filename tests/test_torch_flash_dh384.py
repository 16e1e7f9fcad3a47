"""Port vs JAX package: flash attention at head dim 384.

Dh 384 is the Cheetah example's head dim at ``--dim 3072`` (8 heads), where
auto dispatch picks flash at ``--seq_len 4352``. The port's
``flash_attention`` (on the CPU its plain versions, through the same
``torch.autograd.Function`` that launches the bf16 kernels of
``csrc/flash_dh384_sm90.cu`` on the card) is held against the JAX
``flash_attention``, whose Pallas kernels run in interpret mode off the TPU,
as ``tests/test_torch_flash.py`` runs them; the plain versions at a ragged T
against JAX's dense attention; a Dh-384 ``TransformerLM`` against flax; and
the route, which sends bf16 at Dh 384 to ``csrc/flash_dh384_sm90.cu`` and
float32 at Dh 384 to ``csrc/flash_f32_sm90.cu``. Inputs come from numpy
seeds. The CUDA kernels are held to the plain versions on the card by
``tests/test_torch_flash.py::test_flash_kernels_match_plain_on_card``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_default_matmul_precision", "highest")

from fedml_tpu.models.transformer import TransformerLM as JLM  # noqa: E402
from fedml_tpu.ops import attention as jatt  # noqa: E402
from fedml_tpu.ops import losses as jlosses  # noqa: E402
from fedml_tpu_torch.models.transformer import TransformerLM as TLM  # noqa: E402
from fedml_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from fedml_tpu_torch.ops import losses as tlosses  # noqa: E402
from fedml_tpu_torch.ops.attention import auto_attention_impl  # noqa: E402
from fedml_tpu_torch.utils.convert import flatten_paths, variables_from_jax  # noqa: E402

jfa = importlib.import_module("fedml_tpu.ops.pallas.flash_attention")

# the JAX package's own flash tolerances (tests/test_flash_attention.py), as
# at Dh 256 (tests/test_torch_flash_dh256.py): each score sums 384 products,
# each output at most T = 256 weighted rows, float32 noise of ~sqrt(384) *
# 2^-24 of the magnitudes, well inside both
FWD_ATOL = 2e-5
GRAD_ATOL = 1e-4


def _qkv(B, T, H, Dh, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, T, H, Dh)).astype(np.float32) for _ in range(3))


def _cotangent(shape):
    # non-uniform, so dq/dk/dv are exercised beyond sum(); as the JAX test
    return np.cos(np.arange(np.prod(shape)).reshape(shape) * 0.01).astype(np.float32)


def _torch_grads(fn, q, k, v, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_dh384_forward_lse_and_grads_match_jax(causal):
    q, k, v = _qkv(1, 256, 2, 384, seed=0)
    g = _cotangent(q.shape)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, causal)
    jgrads = jax.grad(lambda q, k, v: (jfa.flash_attention(q, k, v, causal) * g).sum(),
                      argnums=(0, 1, 2))(jq, jk, jv)
    out, grads = _torch_grads(lambda q, k, v: tfa.flash_attention(q, k, v, causal), q, k, v, g)
    np.testing.assert_allclose(out, np.asarray(want), atol=FWD_ATOL)
    for got, w in zip(grads, jgrads):
        np.testing.assert_allclose(got, np.asarray(w), atol=GRAD_ATOL)
    bq = jfa.auto_block(256)
    _, jlse = jfa._flash_forward(jq, jk, jv, causal, bq, bq, True)
    _, lse = tfa.flash_forward(*map(torch.from_numpy, (q, k, v)), causal)
    assert tuple(lse.shape) == tuple(jlse.shape)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=FWD_ATOL)


def test_plain_versions_dh384_at_ragged_t_match_jax_dense(monkeypatch):
    """The plain versions (the card's reference) at T 130, causal, chunked
    over query rows, against JAX's dense attention."""
    monkeypatch.setattr(tfa, "PLAIN_ROWS", 32)
    q, k, v = _qkv(2, 130, 2, 384, seed=1)
    g = _cotangent(q.shape)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = jatt.multihead_attention(jq, jk, jv, causal=True, impl="dense")
    jgrads = jax.grad(
        lambda q, k, v: (jatt.multihead_attention(q, k, v, causal=True, impl="dense") * g).sum(),
        argnums=(0, 1, 2))(jq, jk, jv)
    out, grads = _torch_grads(lambda q, k, v: tfa._FlashAttention.apply(q, k, v, True),
                              q, k, v, g)
    np.testing.assert_allclose(out, np.asarray(want), atol=FWD_ATOL)
    for got, w in zip(grads, jgrads):
        np.testing.assert_allclose(got, np.asarray(w), atol=GRAD_ATOL)


# the Cheetah example's widths cut to a CPU test: dim 768 over 2 heads keeps
# Dh 384, as --dim 3072 over its 8 heads does
XL = dict(vocab_size=64, dim=768, num_heads=2, num_layers=2, max_len=256)


def test_dh384_transformer_lm_flash_loss_and_grads_match_jax():
    jmodel = JLM(**XL, dtype=jnp.float32, attn_impl="flash")
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 256), jnp.int32)))
    rng = np.random.default_rng(4)
    tokens, targets = (rng.integers(0, XL["vocab_size"], (2, 256)).astype(np.int32)
                       for _ in range(2))

    def jloss(v):
        return jlosses.softmax_cross_entropy(jmodel.apply(v, jnp.asarray(tokens)),
                                             jnp.asarray(targets))

    jl, jg = jax.value_and_grad(jloss)(variables)
    jg = flatten_paths(jax.tree_util.tree_map(np.asarray, jg))
    params = variables_from_jax(variables)
    model = TLM(**XL, dtype=torch.float32, attn_impl="flash")
    assert {"params/" + n.replace(".", "/") for n, _ in model.named_parameters()} == set(params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params["params/" + name.replace(".", "/")])
    assert model.block_0.SelfAttention_0.qkv.kernel.shape == (768, 3 * 768)
    loss = tlosses.softmax_cross_entropy(model(torch.from_numpy(tokens).long()),
                                         torch.from_numpy(targets))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    # float32, the same arithmetic summed in another order (test_torch_lm.LM_TOL)
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    for (name, _), g in zip(model.named_parameters(), grads):
        want = jg["params/" + name.replace(".", "/")]
        err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-12)
        assert err < 1e-4, (name, err)


def test_route_sends_bf16_dh384_to_its_kernels_and_nothing_else():
    """bf16 at Dh 384 runs flash_dh384_sm90.cu's three entry points; float32
    at Dh 384 runs flash_f32_sm90.cu's forward and dk/dv and
    flash_f32_wgmma_sm90.cu's dq (three-block clusters), which the card's
    wrappers accept too;
    Dh 512 and 1536 in either dtype go to neither: bf16 there runs
    flash_wide_sm90.cu's entry points, which the card's wrappers accept,
    float32 at Dh 512 flash_f32_wgmma_sm90.cu's clusters, and float32 at Dh 1536,
    which the guard admits at no T, is refused. The XL LM's shape is one
    that auto dispatch sends to flash, in both dtypes."""
    for name in ("fedml_flash_fwd", "fedml_flash_dq", "fedml_flash_dkv"):
        assert tfa.route(name, torch.bfloat16, 384) == ("flash_dh384_sm90", name + "_dh384_sm90")
        assert tfa.route(name, torch.float32, 384) == (
            ("flash_f32_wgmma_sm90", name + "_f32wg_sm90") if name == "fedml_flash_dq"
            else ("flash_f32_sm90", name + "_f32_sm90"))
        for dtype, Dh in ((torch.bfloat16, 512), (torch.float32, 512),
                          (torch.bfloat16, 1536), (torch.float32, 1536)):
            assert tfa.route(name, dtype, Dh)[0] != "flash_dh384_sm90"
        for Dh in (512, 1536):
            assert tfa.route(name, torch.bfloat16, Dh) == ("flash_wide_sm90",
                                                           name + "_wide_sm90")
    for dtype in (torch.bfloat16, torch.float32):
        tfa.check_head_dim(384, dtype)
    for Dh in (512, 1536):
        tfa.check_head_dim(Dh, torch.bfloat16)
    tfa.check_head_dim(512, torch.float32)
    with pytest.raises(ValueError, match="admits this head dim at no T"):
        tfa.check_head_dim(1536, torch.float32)
    for itemsize in (2, 4):
        assert auto_attention_impl(8, 8, 4352, 384, itemsize) == "flash"
    for T in (2048, 4096, 4608, 8192):
        assert auto_attention_impl(8, 8, T, 384, 2) == "dense"
