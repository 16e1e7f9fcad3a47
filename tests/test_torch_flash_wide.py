"""Port vs JAX package: flash attention at head dims 512-1536 in bf16.

Dh 512 is the Cheetah example's head dim at ``--dim 4096`` (8 heads), where
auto dispatch picks flash in bf16 at ``--seq_len 4352``; the guard admits
every Dh = 128 n up to 1536. The port's ``flash_attention`` (on the CPU its
plain versions, through the same ``torch.autograd.Function`` that launches
the bf16 kernels of ``csrc/flash_wide_sm90.cu`` on the card) is held
against the JAX ``flash_attention``, whose Pallas kernels run in interpret
mode off the TPU, at Dh 512 and 1536; the plain versions at a ragged T
against JAX's dense attention; a Dh-512 ``TransformerLM`` against flax; the
route, which sends bf16 at Dh 512-1536 to ``csrc/flash_wide_sm90.cu`` and
refuses float32 there; and the dispatch decisions at the shapes
``chip_smoke.py`` runs. Inputs come from numpy seeds. The kernels' own order
of sums is emulated in ``tests/test_torch_flash_wide_tc.py``; the kernels
are held to the plain versions on the card by ``chip_smoke.py`` and
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
from test_torch_flash_dh384 import FWD_ATOL, GRAD_ATOL, _cotangent, _qkv  # noqa: E402
from test_torch_flash_dh384 import _torch_grads  # noqa: E402

jfa = importlib.import_module("fedml_tpu.ops.pallas.flash_attention")

# (B, T, H, Dh) of chip_smoke.py's wide paths: lm_xxl (the example at --dim
# 4096 --seq_len 4352), small_lm_512 and small_lm_1536 (one head each)
WIDE_SHAPES = ((8, 4352, 8, 512), (1, 4352, 1, 512), (1, 4224, 1, 1536))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Dh,H", [(512, 2), (1536, 1)])
def test_flash_wide_forward_lse_and_grads_match_jax(Dh, H, causal):
    """Each score sums up to 1536 float32 products, each output at most T =
    256 weighted rows: float32 noise of ~sqrt(1536) * 2^-24 of the
    magnitudes, well inside the JAX package's own tolerances."""
    q, k, v = _qkv(1, 256, H, Dh, seed=Dh)
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


@pytest.mark.parametrize("Dh", [640, 1408])
def test_plain_versions_wide_at_ragged_t_match_jax_dense(Dh, monkeypatch):
    """The plain versions (the card's reference) at T 130, causal, chunked
    over query rows, against JAX's dense attention, at two head dims whose
    kernels take 128-column slices."""
    monkeypatch.setattr(tfa, "PLAIN_ROWS", 32)
    q, k, v = _qkv(1, 130, 2, Dh, seed=Dh)
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


# the Cheetah example's widths cut to a CPU test: dim 1024 over 2 heads keeps
# Dh 512, as --dim 4096 over its 8 heads does
XXL = dict(vocab_size=64, dim=1024, num_heads=2, num_layers=1, max_len=256)


def test_dh512_transformer_lm_flash_loss_and_grads_match_jax():
    jmodel = JLM(**XXL, dtype=jnp.float32, attn_impl="flash")
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 256), jnp.int32)))
    rng = np.random.default_rng(4)
    tokens, targets = (rng.integers(0, XXL["vocab_size"], (2, 256)).astype(np.int32)
                       for _ in range(2))

    def jloss(v):
        return jlosses.softmax_cross_entropy(jmodel.apply(v, jnp.asarray(tokens)),
                                             jnp.asarray(targets))

    jl, jg = jax.value_and_grad(jloss)(variables)
    jg = flatten_paths(jax.tree_util.tree_map(np.asarray, jg))
    params = variables_from_jax(variables)
    model = TLM(**XXL, dtype=torch.float32, attn_impl="flash")
    assert {"params/" + n.replace(".", "/") for n, _ in model.named_parameters()} == set(params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params["params/" + name.replace(".", "/")])
    assert model.block_0.SelfAttention_0.qkv.kernel.shape == (1024, 3 * 1024)
    loss = tlosses.softmax_cross_entropy(model(torch.from_numpy(tokens).long()),
                                         torch.from_numpy(targets))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    # float32, the same arithmetic summed in another order (test_torch_lm.LM_TOL)
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    for (name, _), g in zip(model.named_parameters(), grads):
        want = jg["params/" + name.replace(".", "/")]
        err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-12)
        assert err < 1e-4, (name, err)


def test_route_sends_bf16_wide_head_dims_to_their_kernels():
    """bf16 at every Dh = 128 n from 512 to 1536 runs flash_wide_sm90.cu's
    three entry points, and the card's wrappers accept it; float32 there
    runs flash_wide_f32_sm90.cu up to Dh 896, and past it, like bf16 at a
    Dh that is no multiple of 128 (576) or past 1536 (1664), goes to no
    kernel and is refused: the guard admits those head dims at no T."""
    assert tfa.BF16_WIDE == (512, 640, 768, 896, 1024, 1152, 1280, 1408, 1536)
    for name in ("fedml_flash_fwd", "fedml_flash_dq", "fedml_flash_dkv"):
        for Dh in tfa.BF16_WIDE:
            assert tfa.route(name, torch.bfloat16, Dh) == ("flash_wide_sm90", name + "_wide_sm90")
            assert tfa.route(name, torch.float32, Dh)[0] != "flash_wide_sm90"
        for Dh in (64, 128, 256, 384):
            assert tfa.route(name, torch.bfloat16, Dh)[0] != "flash_wide_sm90"
    for Dh in tfa.BF16_WIDE:
        tfa.check_head_dim(Dh, torch.bfloat16)
        if Dh <= 896:
            tfa.check_head_dim(Dh, torch.float32)
            continue
        with pytest.raises(ValueError, match="admits this head dim at no T"):
            tfa.check_head_dim(Dh, torch.float32)
    for Dh in (576, 1664):
        with pytest.raises(ValueError, match="admits this head dim at no T"):
            tfa.check_head_dim(Dh, torch.bfloat16)
    assert "flash_wide_sm90" in tfa._build.library_path("flash_wide_sm90").name
    from fedml_tpu_torch.ops import KERNELS
    assert "flash_wide_sm90" in KERNELS


@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_auto_dispatch_at_the_wide_paths_matches_jax(shape):
    """At lm_xxl's, small_lm_512's and small_lm_1536's shapes both packages
    pick flash in bf16 (2-byte items) and dense in float32, where the
    guard's budget refuses the block."""
    B, T, H, Dh = shape
    for itemsize, want in ((2, "flash"), (4, "dense")):
        assert auto_attention_impl(B, H, T, Dh, itemsize) == \
            jatt.auto_attention_impl(B, H, T, Dh, itemsize) == want
