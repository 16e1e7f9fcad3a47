"""Port vs JAX package: flash attention at head dim 256, and remat "dots".

Dh 256 is the Cheetah example's head dim at ``--dim 2048`` (8 heads). The
port's ``flash_attention`` (on the CPU its plain versions, through the same
``torch.autograd.Function`` that launches the CUDA kernels on the card) is
held against the JAX ``flash_attention``, whose Pallas kernels run in
interpret mode off the TPU, as ``tests/test_torch_flash.py`` runs them; then
a Dh-256 ``TransformerLM`` against flax, and the trainer under remat "dots"
against the JAX trainer and against "full". Inputs come from numpy seeds.
The CUDA kernels at Dh 256 are held to the plain versions on the card by
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
from fedml_tpu.parallel import trainer as jtrainer  # noqa: E402
from fedml_tpu_torch.models.transformer import TransformerLM as TLM  # noqa: E402
from fedml_tpu_torch.ops import flash_attention as tfa  # noqa: E402
from fedml_tpu_torch.ops import losses as tlosses  # noqa: E402
from fedml_tpu_torch.parallel import DistTrainConfig, DistributedLMTrainer  # noqa: E402
from fedml_tpu_torch.utils.convert import flatten_paths, variables_from_jax  # noqa: E402

jfa = importlib.import_module("fedml_tpu.ops.pallas.flash_attention")

# the JAX package's own flash tolerances (tests/test_flash_attention.py).
# At Dh 256 each score sums 256 products instead of 64, and each output
# still sums at most T = 256 weighted rows: float32 noise of ~sqrt(256) *
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
def test_flash_dh256_forward_lse_and_grads_match_jax(causal):
    q, k, v = _qkv(1, 256, 2, 256, seed=0)
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


def test_plain_versions_dh256_at_ragged_t_match_jax_dense(monkeypatch):
    """The plain versions (the card's reference) at T 130, causal, chunked
    over query rows, against JAX's dense attention."""
    monkeypatch.setattr(tfa, "PLAIN_ROWS", 32)
    q, k, v = _qkv(2, 130, 2, 256, seed=1)
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


def test_head_dims_past_256_name_the_roadmap():
    """Dh 384-1536 pass the shared guard, as JAX's does. On the card both
    dtypes take Dh 384 (bf16 on flash_dh384_sm90.cu, float32 on
    flash_f32_sm90.cu) and Dh 512 (bf16 on flash_wide_sm90.cu, float32 on
    flash_f32_wgmma_sm90.cu's clusters), and bf16 takes Dh 1536; float32 at Dh 1536,
    which the guard admits at no T with 4-byte items, has no kernel, and
    the wrappers refuse it, saying so."""
    for dtype in (torch.float32, torch.bfloat16):
        for Dh in (64, 128, 256, 384):
            tfa.check_head_dim(Dh, dtype)
    for Dh in (384, 512, 1536):
        assert tfa.flash_shapes_ok(256, Dh) == jfa.flash_shapes_ok(256, Dh) is True
    for Dh in (512, 1536):
        tfa.check_head_dim(Dh, torch.bfloat16)
    tfa.check_head_dim(512, torch.float32)
    assert not tfa.flash_shapes_ok(256, 1536, 4)
    with pytest.raises(ValueError, match="admits this head dim at no T"):
        tfa.check_head_dim(1536, torch.float32)


# the Cheetah example's widths cut to a CPU test: dim 512 over 2 heads keeps
# Dh 256, as --dim 2048 over its 8 heads does
WIDE = dict(vocab_size=64, dim=512, num_heads=2, num_layers=2, max_len=256)


def test_dh256_transformer_lm_flash_loss_and_grads_match_jax():
    jmodel = JLM(**WIDE, dtype=jnp.float32, attn_impl="flash")
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 256), jnp.int32)))
    rng = np.random.default_rng(4)
    tokens, targets = (rng.integers(0, WIDE["vocab_size"], (2, 256)).astype(np.int32)
                       for _ in range(2))

    def jloss(v):
        return jlosses.softmax_cross_entropy(jmodel.apply(v, jnp.asarray(tokens)),
                                             jnp.asarray(targets))

    jl, jg = jax.value_and_grad(jloss)(variables)
    jg = flatten_paths(jax.tree_util.tree_map(np.asarray, jg))
    params = variables_from_jax(variables)
    model = TLM(**WIDE, dtype=torch.float32, attn_impl="flash")
    assert {"params/" + n.replace(".", "/") for n, _ in model.named_parameters()} == set(params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params["params/" + name.replace(".", "/")])
    assert model.block_0.SelfAttention_0.qkv.kernel.shape == (512, 3 * 512)
    loss = tlosses.softmax_cross_entropy(model(torch.from_numpy(tokens).long()),
                                         torch.from_numpy(targets))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    # float32, the same arithmetic summed in another order (test_torch_lm.LM_TOL)
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    for (name, _), g in zip(model.named_parameters(), grads):
        want = jg["params/" + name.replace(".", "/")]
        err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-12)
        assert err < 1e-4, (name, err)


def _data(vocab, B, T, seed=0):
    rng = np.random.default_rng(seed)
    while True:  # examples/cheetah_lm/main.py's data
        start = rng.integers(0, vocab, (B, 1))
        seq = (start + np.arange(T + 1)) % vocab
        yield seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


# tests/test_torch_lm.py::test_cheetah_trainer_matches_jax's setup and bounds
MODEL_KW = dict(vocab_size=64, dim=128, num_heads=2, num_layers=2, max_len=128)
TRAIN_LR = 3e-4
TRAIN_PARAM_ATOL = 2 * 3 * TRAIN_LR


def test_cheetah_trainer_remat_dots_matches_jax():
    jcfg = jtrainer.DistTrainConfig(lr=TRAIN_LR, weight_decay=0.01, use_remat=True,
                                    ce_chunk=64, remat_policy="dots")
    jtr = jtrainer.DistributedLMTrainer(jcfg, dtype=jnp.float32, seed=0,
                                        mesh=jtrainer.make_lm_mesh(jcfg, jax.devices()[:1]),
                                        **MODEL_KW)
    init = jax.tree_util.tree_map(np.asarray, jtr.params)
    ttr = DistributedLMTrainer(DistTrainConfig(lr=TRAIN_LR, weight_decay=0.01, use_remat=True,
                                               ce_chunk=64, remat_policy="dots"),
                               dtype=torch.float32, device="cpu",
                               params=variables_from_jax(init), **MODEL_KW)
    assert ttr.model.remat == "dots"
    jl = jtr.train(_data(64, 2, 128), 3, log_fn=None)
    tl = ttr.train(_data(64, 2, 128), 3, log_fn=None)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    want = flatten_paths(jax.tree_util.tree_map(np.asarray, jtr.params))
    close = total = 0
    for path, p in ttr.params.items():
        diff = np.abs(p.detach().numpy() - want[path])
        assert diff.max() <= TRAIN_PARAM_ATOL, (path, diff.max())
        close += int((diff <= 1e-5).sum())
        total += diff.size
    assert close >= 0.99 * total


@pytest.mark.parametrize("attn_impl", ["dense", "flash"])
def test_remat_dots_gradients_equal_full(monkeypatch, attn_impl):
    """The policy decides what is kept, not what is computed: "dots" and
    "full" give the same loss and gradients bit for bit, with dense
    attention and with flash (whose forward the recompute runs again)."""
    calls = []
    plain = tfa.flash_forward_plain
    monkeypatch.setattr(tfa, "flash_forward_plain", lambda *a: calls.append(1) or plain(*a))
    tokens, targets = (torch.from_numpy(t).long() for t in next(_data(64, 2, 256, seed=7)))
    runs = {}
    for remat in ("full", "dots"):
        tr = DistributedLMTrainer(DistTrainConfig(ce_chunk=64, remat_policy=remat),
                                  dtype=torch.float32, device="cpu", seed=3,
                                  **dict(MODEL_KW, max_len=256))
        for i in range(MODEL_KW["num_layers"]):
            getattr(tr.model, f"block_{i}").SelfAttention_0.attn_impl = attn_impl
        calls.clear()
        loss = tr.loss(tokens, targets)
        grads = torch.autograd.grad(loss, list(tr.params.values()))
        # the forward and its recompute: one flash forward each per block
        assert len(calls) == (2 * MODEL_KW["num_layers"] if attn_impl == "flash" else 0)
        runs[remat] = (loss, grads)
    assert torch.equal(runs["full"][0], runs["dots"][0])
    for a, b in zip(runs["full"][1], runs["dots"][1]):
        assert torch.equal(a, b)
