"""Port vs JAX package: flash attention at head dims 512-896 in float32.

Dh 512 is the Cheetah example's head dim at ``--dim 4096`` (8 heads); trained
in float32, auto dispatch picks flash at ``--seq_len 4224`` (33 x 128, block
128), where the guard's budget admits 4-byte items up to Dh 896. The port's
``flash_attention`` (on the CPU its plain versions, through the same
``torch.autograd.Function`` that launches the kernels of
``csrc/flash_wide_f32_sm90.cu`` on the card) is held against the JAX
``flash_attention``, whose Pallas kernels run in interpret mode off the TPU,
at Dh 512 and 896; the plain versions at a ragged T against JAX's dense
attention at Dh 640; a one-layer float32 Dh-512 LM through the port's
``DistributedLMTrainer`` loss (chunked cross-entropy at chunk 128, full
remat) against the JAX trainer's loss function, with the weights carried
across by ``variables_from_jax``; the route, which sends float32 at Dh
512-896 to ``csrc/flash_wide_f32_sm90.cu`` (but dq and dk/dv at Dh 512 to
``csrc/flash_f32_wgmma_sm90.cu``'s four-block clusters) and refuses the
head dims the guard admits at no T; and the dispatch decisions at ``chip_smoke.py``'s
float32 XXL shape. Inputs come from numpy seeds. The kernels' own order of
sums is emulated in ``tests/test_torch_flash_wide_f32_tc.py``; the kernels
are held to the plain versions on the card by the ``cuda``-marked case here
(skipped without one) and by ``chip_smoke.py``.
"""

import functools
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
from fedml_tpu_torch.ops import KERNELS  # noqa: E402
from fedml_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from fedml_tpu_torch.ops.attention import auto_attention_impl  # noqa: E402
from fedml_tpu_torch.parallel import DistTrainConfig, DistributedLMTrainer  # noqa: E402
from fedml_tpu_torch.utils.convert import flatten_paths, variables_from_jax  # noqa: E402
from test_torch_flash import CARD_TOL  # noqa: E402
from test_torch_flash_dh384 import FWD_ATOL, GRAD_ATOL, _cotangent, _qkv  # noqa: E402
from test_torch_flash_dh384 import _torch_grads  # noqa: E402

jfa = importlib.import_module("fedml_tpu.ops.pallas.flash_attention")

NAMES = ("fedml_flash_fwd", "fedml_flash_dq", "fedml_flash_dkv")


@functools.partial(jax.jit, static_argnums=4)
def _jax_flash_jit(q, k, v, g, causal):
    """The JAX package's flash_attention output, its gradients against the
    cotangent g (through jax.vjp) and its lse, in one jit (the Pallas
    kernels in interpret mode run several times faster traced once than op
    by op)."""
    out, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(q, k, v, causal), q, k, v)
    bq = jfa.auto_block(q.shape[1])
    return out, vjp(g), jfa._flash_forward(q, k, v, causal, bq, bq, True)[1]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("Dh,H", [(512, 2), (896, 1)])
def test_flash_wide_f32_forward_lse_and_grads_match_jax(Dh, H, causal):
    """At T 256 (block 128) each score sums up to 896 float32 products and
    each output at most 256 weighted rows: float32 noise of ~sqrt(896) *
    2^-24 of the magnitudes, well inside the JAX package's own tolerances
    (FWD_ATOL, GRAD_ATOL)."""
    q, k, v = _qkv(1, 256, H, Dh, seed=Dh + 1)
    g = _cotangent(q.shape)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want, jgrads, jlse = _jax_flash_jit(jq, jk, jv, jnp.asarray(g), causal)
    out, grads = _torch_grads(lambda q, k, v: tfa.flash_attention(q, k, v, causal), q, k, v, g)
    np.testing.assert_allclose(out, np.asarray(want), atol=FWD_ATOL)
    for got, w in zip(grads, jgrads):
        np.testing.assert_allclose(got, np.asarray(w), atol=GRAD_ATOL)
    _, lse = tfa.flash_forward(*map(torch.from_numpy, (q, k, v)), causal)
    assert tuple(lse.shape) == tuple(jlse.shape)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=FWD_ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_versions_f32_dh640_at_ragged_t_match_jax_dense(causal, monkeypatch):
    """The plain versions (the card's reference) at T 130, chunked over
    query rows, against JAX's dense attention at Dh 640 (five warps a row
    group in the kernels)."""
    monkeypatch.setattr(tfa, "PLAIN_ROWS", 32)
    q, k, v = _qkv(2, 130, 2, 640, seed=640)
    g = _cotangent(q.shape)

    def jattn(q, k, v):
        return jatt.multihead_attention(q, k, v, causal=causal, impl="dense")

    want, vjp = jax.vjp(jattn, *map(jnp.asarray, (q, k, v)))
    out, grads = _torch_grads(lambda q, k, v: tfa._FlashAttention.apply(q, k, v, causal),
                              q, k, v, g)
    np.testing.assert_allclose(out, np.asarray(want), atol=FWD_ATOL)
    for got, w in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got, np.asarray(w), atol=GRAD_ATOL)


# the Cheetah example's widths cut to a CPU test: dim 1024 over 2 heads keeps
# Dh 512, as --dim 4096 over its 8 heads does; one layer, T 128 (one block)
XXL_F32 = dict(vocab_size=64, dim=1024, num_heads=2, num_layers=1, max_len=128)
CE_CHUNK = 128  # --ce_chunk 128, as at T 4224


def test_f32_dh512_trainer_loss_and_grads_match_jax():
    """The port's DistributedLMTrainer.loss in float32 (flash on every
    block, full remat, chunked cross-entropy at chunk 128) and its gradients
    against the JAX trainer's loss function (``_build_train_step``'s
    ``loss_fn``: the model's hidden states, the head kernel, the chunked
    cross-entropy) on flax's weights, carried across by
    ``variables_from_jax``; float32 summed in another order
    (``test_torch_lm.LM_TOL``). The JAX side runs without remat, which
    changes what is kept, not what is computed (flax's remat of the flash
    blocks triples the CPU test's time); its weights come from the dense
    model's init, the same tree; both are traced once (jit)."""
    init = jax.jit(JLM(**XXL_F32, dtype=jnp.float32, attn_impl="dense").init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    variables = jax.tree_util.tree_map(np.asarray, init)
    jmodel = JLM(**XXL_F32, dtype=jnp.float32, attn_impl="flash")
    rng = np.random.default_rng(5)
    tokens, targets = (rng.integers(0, XXL_F32["vocab_size"], (2, 128)).astype(np.int32)
                       for _ in range(2))

    def jloss(params):
        hid = jmodel.apply(params, jnp.asarray(tokens), return_hidden=True)
        head = params["params"]["head"]["kernel"].astype(hid.dtype)
        return jlosses.chunked_lm_cross_entropy(hid, head, jnp.asarray(targets), chunk=CE_CHUNK)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(variables)
    jg = flatten_paths(jax.tree_util.tree_map(np.asarray, jg))
    tr = DistributedLMTrainer(DistTrainConfig(lr=3e-4, weight_decay=0.01, use_remat=True,
                                              ce_chunk=CE_CHUNK),
                              dtype=torch.float32, device="cpu",
                              params=variables_from_jax(variables), **XXL_F32)
    attn = tr.model.block_0.SelfAttention_0
    attn.attn_impl = "flash"
    assert attn.qkv.kernel.shape == (1024, 3 * 1024)
    loss = tr.loss(torch.from_numpy(tokens).long(), torch.from_numpy(targets).long())
    grads = torch.autograd.grad(loss, list(tr.params.values()))
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    assert set(tr.params) == set(jg)
    for (path, _), g in zip(tr.params.items(), grads):
        want = jg[path]
        err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-12)
        assert err < 1e-4, (path, err)


def test_route_sends_f32_wide_head_dims_to_their_kernels():
    """Float32 at Dh 640, 768 and 896 runs flash_wide_f32_sm90.cu's three
    entry points, and at Dh 512 all three run flash_f32_wgmma_sm90.cu's
    four-block clusters (the forward's entry there stays, off the route,
    timed beside the clusters on the card); the card's wrappers accept
    them all (bf16 there keeps flash_wide_sm90.cu); float32 at Dh 1024 and
    576 and bf16 at Dh 576 and 1664, head dims that the guard admits at no T,
    go to no kernel and are refused, saying so."""
    assert tfa.F32_WIDE == (512, 640, 768, 896)
    assert "flash_wide_f32_sm90" in KERNELS and "flash_f32_wgmma_sm90" in KERNELS
    assert "flash_wide_f32_sm90" in tfa._build.library_path("flash_wide_f32_sm90").name
    for Dh in tfa.F32_WIDE:
        tfa.check_head_dim(Dh, torch.float32)
        for name in NAMES:
            want = ("flash_f32_wgmma_sm90", name + "_f32wg_sm90") \
                if Dh == 512 \
                else ("flash_wide_f32_sm90", name + "_wide_f32_sm90")
            assert tfa.route(name, torch.float32, Dh) == want
            assert tfa.route(name, torch.bfloat16, Dh) == ("flash_wide_sm90",
                                                           name + "_wide_sm90")
    for name in NAMES:
        assert tfa.route(name, torch.float32, 384)[0] == (
            "flash_f32_wgmma_sm90" if name == "fedml_flash_dq" else "flash_f32_sm90")
    for Dh, dtype in ((1024, torch.float32), (576, torch.float32), (576, torch.bfloat16),
                      (1664, torch.bfloat16)):
        itemsize = torch.zeros(1, dtype=dtype).element_size()
        assert not any(tfa.flash_shapes_ok(T, Dh, itemsize) for T in (256, 4224, 4352, 8192))
        with pytest.raises(ValueError, match="admits this head dim at no T"):
            tfa.check_head_dim(Dh, dtype)


@pytest.mark.parametrize("Dh", [512, 640, 768, 896, 1024])
def test_auto_dispatch_at_the_f32_xxl_shape_matches_jax(Dh):
    """At lm_xxl_f32's (8, 4224, 8, Dh) with 4-byte items both packages pick
    flash up to Dh 896 and dense at 1024 (the guard's budget); at lm_xxl's
    T 4352 float32 Dh 512 stays dense (block 256 is over the budget)."""
    want = "flash" if Dh <= 896 else "dense"
    assert auto_attention_impl(8, 8, 4224, Dh, 4) == \
        jatt.auto_attention_impl(8, 8, 4224, Dh, 4) == want
    assert auto_attention_impl(8, 8, 4352, 512, 4) == \
        jatt.auto_attention_impl(8, 8, 4352, 512, 4) == "dense"


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((2, 333, 3, 512), True), ((3, 130, 2, 512), False),
                                          ((3, 130, 2, 640), False), ((1, 300, 2, 768), True),
                                          ((3, 130, 2, 896), True)])
def test_f32_wide_kernels_match_plain_on_card(shape, causal):
    """The float32 kernels at Dh 512-896 (flash_wide_f32_sm90.cu's, and at
    Dh 512 flash_f32_wgmma_sm90.cu's four-block clusters) against the
    plain versions on the card, within test_torch_flash.CARD_TOL; dq, dk and
    dv repeat bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator().manual_seed(19)
    q, k, v, do = (torch.randn(*shape, generator=g).cuda() for _ in range(4))
    out, lse = tfa.flash_forward(q, k, v, causal)
    delta = tfa.attention_delta(do, out)
    dq = tfa.flash_dq(q, k, v, do, lse, delta, causal)
    dk, dv = tfa.flash_dkv(q, k, v, do, lse, delta, causal)
    want = [tfa.flash_forward_plain(q, k, v, causal)[0],
            tfa.flash_dq_plain(q, k, v, do, lse, delta, causal),
            *tfa.flash_dkv_plain(q, k, v, do, lse, delta, causal)]
    for got, w in zip((out, dq, dk, dv), want):
        assert ((got - w).abs().max() / w.abs().max()).item() < CARD_TOL[torch.float32]
    dk2, dv2 = tfa.flash_dkv(q, k, v, do, lse, delta, causal)
    assert torch.equal(dq, tfa.flash_dq(q, k, v, do, lse, delta, causal))
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
