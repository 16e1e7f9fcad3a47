"""Port vs JAX package: the Cheetah LM slice.

``TransformerLM`` (parameter tree, loss and gradients with flash attention),
the LM losses, ``init_params``' statistics, the parameter transfer, and the
whole slice: the port's ``DistributedLMTrainer`` against the JAX one over
three steps from the same weights and batches. Inputs come from numpy
seeds; the JAX flash kernels run in Pallas interpret mode off the TPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

jax.config.update("jax_default_matmul_precision", "highest")

from fedml_tpu.models.transformer import TransformerLM as JLM  # noqa: E402
from fedml_tpu.ops import losses as jlosses  # noqa: E402
from fedml_tpu.parallel import trainer as jtrainer  # noqa: E402
from fedml_tpu_torch.models import init_params  # noqa: E402
from fedml_tpu_torch.models.transformer import TransformerLM as TLM  # noqa: E402
from fedml_tpu_torch.ops import losses as tlosses  # noqa: E402
from fedml_tpu_torch.parallel import DistTrainConfig, DistributedLMTrainer  # noqa: E402
from fedml_tpu_torch.utils.convert import flatten_paths, variables_from_jax  # noqa: E402

SMALL = dict(vocab_size=64, dim=128, num_heads=2, num_layers=2, max_len=256)


def _jax_init(seed=0, **kw):
    cfg = dict(SMALL, **kw)
    model = JLM(**cfg)
    # flash needs a tileable T even at init
    init_T = 256 if kw.get("attn_impl") == "flash" else 8
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, init_T), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _load(model, params):
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(params["params/" + name.replace(".", "/")])
    return model


def _tokens(B, T, vocab, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, vocab, (B, T)).astype(np.int32) for _ in range(2))


def test_lm_parameter_tree_matches_flax():
    _, variables = _jax_init()
    want = {k: v.shape for k, v in flatten_paths(variables).items()}
    got = init_params(TLM(**SMALL), torch.Generator().manual_seed(0))
    assert list(got) == list(want)  # jax.tree_util leaf order
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert "params/block_1/SelfAttention_0/qkv/kernel" in got
    assert "params/block_0/SelfAttention_0/qkv/bias" not in got  # qkv has no bias


def test_variables_from_jax_carries_the_lm_tree():
    _, variables = _jax_init(seed=3)
    params = variables_from_jax(variables)
    model = _load(TLM(**SMALL), params)
    for name, p in model.named_parameters():
        path = "params/" + name.replace(".", "/")
        leaf = flatten_paths(variables)[path]
        assert p.dtype == torch.float32
        np.testing.assert_array_equal(p.detach().numpy(), leaf)


# float32: the same arithmetic summed in another order: losses to ~1e-6
# relative, gradients to ~1e-6 of their largest magnitude
# bfloat16: XLA-on-CPU and torch round to bf16 at other points (products,
# GELU, residual adds), so only loosely
LM_TOL = {"float32": dict(loss=1e-5, grad=1e-4), "bfloat16": dict(loss=2e-2, grad=1e-1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transformer_lm_flash_loss_and_grads_match_jax(dtype):
    jmodel, variables = _jax_init(seed=1, dtype=getattr(jnp, dtype), attn_impl="flash")
    tokens, targets = _tokens(2, 256, SMALL["vocab_size"], seed=4)

    def jloss(v):
        logits = jmodel.apply(v, jnp.asarray(tokens))
        return jlosses.softmax_cross_entropy(logits, jnp.asarray(targets))

    jl, jg = jax.value_and_grad(jloss)(variables)
    jg = flatten_paths(jax.tree_util.tree_map(np.asarray, jg))
    model = _load(TLM(**SMALL, dtype=getattr(torch, dtype), attn_impl="flash"),
                  variables_from_jax(variables))
    loss = tlosses.softmax_cross_entropy(model(torch.from_numpy(tokens).long()),
                                         torch.from_numpy(targets))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    tol = LM_TOL[dtype]
    assert loss.item() == pytest.approx(float(jl), rel=tol["loss"])
    for (name, _), g in zip(model.named_parameters(), grads):
        want = jg["params/" + name.replace(".", "/")]
        err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-12)
        assert err < tol["grad"], (name, err)


@pytest.mark.parametrize("chunk", [32, 128])
def test_chunked_lm_cross_entropy_matches_jax(chunk):
    rng = np.random.default_rng(5)
    hidden = rng.normal(size=(2, 128, 32)).astype(np.float32)
    head = (rng.normal(size=(32, 50)) * 0.2).astype(np.float32)
    targets = rng.integers(0, 50, (2, 128)).astype(np.int32)
    jl, jg = jax.value_and_grad(
        lambda h, w: jlosses.chunked_lm_cross_entropy(h, w, jnp.asarray(targets), chunk),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(head))
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(head).requires_grad_()
    loss = tlosses.chunked_lm_cross_entropy(h, w, torch.from_numpy(targets), chunk)
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), rel=1e-6)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jg[0]), atol=1e-7)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jg[1]), atol=1e-7)
    full = tlosses.softmax_cross_entropy(h @ w, torch.from_numpy(targets))
    assert full.item() == pytest.approx(loss.item(), rel=1e-6)
    with pytest.raises(ValueError):
        tlosses.chunked_lm_cross_entropy(h, w, torch.from_numpy(targets), 48)


def test_init_statistics_match_jax():
    """Per leaf kind: Embed tables normal with standard deviation
    1/sqrt(features), Dense kernels truncated-normal (at two sigma) with
    1/sqrt(fan_in), LayerNorm scales one and biases zero."""
    cfg = dict(vocab_size=512, dim=256, num_heads=4, num_layers=2, max_len=512)
    _, variables = _jax_init(seed=2, **cfg)
    want = flatten_paths(variables)
    got = init_params(TLM(**cfg), torch.Generator().manual_seed(2))
    for path, w in want.items():
        g = got[path].numpy()
        kind = path.rsplit("/", 1)[-1]
        if kind in ("kernel", "embedding"):
            fan = w.shape[-1] if kind == "embedding" else w.shape[0]
            # tens of thousands of draws: the sample std is within 3% of 1/sqrt(fan)
            assert g.std() == pytest.approx(w.std(), rel=0.03), path
            assert g.std() == pytest.approx(fan ** -0.5, rel=0.03), path
            bound = 2 * fan ** -0.5 / 0.87962566103423978  # truncation at two sigma
            for t in (g, w):
                # Embed tables are not truncated: tens of thousands of draws
                # pass two sigma (5% of them) and reach past four
                past = np.abs(t).max() > 1.8 * bound
                assert past if kind == "embedding" else np.abs(t).max() <= bound * (1 + 1e-6), path
            assert abs(g.mean()) < 0.1 * fan ** -0.5
        else:
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="initialiser"):
        init_params(torch.nn.Linear(2, 2), torch.Generator())


def test_remat_under_functional_call_keeps_the_gradients():
    """A checkpointed block recomputes in the backward, after
    functional_call has restored the module: the gradients must still be
    those of the tensors the forward used."""
    cfg = dict(SMALL, num_layers=2, max_len=64)
    grads = []
    for remat in (False, True, "full"):
        model = TLM(**cfg, remat=remat)
        params = init_params(model, torch.Generator().manual_seed(0))
        named = {k[len("params/"):].replace("/", "."): v.requires_grad_()
                 for k, v in params.items()}
        tokens = torch.from_numpy(_tokens(2, 64, cfg["vocab_size"], seed=6)[0]).long()
        out = functional_call(model, named, (tokens,))
        grads.append(torch.autograd.grad(out.float().logsumexp(-1).mean(), list(named.values())))
    for g in grads[1:]:
        for a, b in zip(g, grads[0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        TLM(**cfg, remat="everything")


def _data(vocab, B, T, seed=0):
    rng = np.random.default_rng(seed)
    while True:  # examples/cheetah_lm/main.py's data
        start = rng.integers(0, vocab, (B, 1))
        seq = (start + np.arange(T + 1)) % vocab
        yield seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


# Losses: float32 with the same weights and batches; the first step agrees
# to ~1e-7 and Adam's later steps to ~1e-6 relative. With mu stored in
# bf16, reduction-order noise in a gradient can flip the rounding of that
# element's mu and move its step by 2^-8, so the losses agree more loosely. Parameters: Adam moves
# each by up to ~lr per step whatever the gradient's size, so where a
# gradient is reduction-order noise the two runs may step apart: 2 * lr per
# step bounds that over 3 steps; nearly all parameters agree to 1e-5.
TRAIN_LR = 3e-4
TRAIN_PARAM_ATOL = 2 * 3 * TRAIN_LR


@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_cheetah_trainer_matches_jax(mu_dtype):
    model_kw = dict(vocab_size=64, dim=128, num_heads=2, num_layers=2, max_len=128)
    jcfg = jtrainer.DistTrainConfig(lr=TRAIN_LR, weight_decay=0.01, use_remat=True,
                                    ce_chunk=64, mu_dtype=mu_dtype)
    jtr = jtrainer.DistributedLMTrainer(jcfg, dtype=jnp.float32, seed=0,
                                        mesh=jtrainer.make_lm_mesh(jcfg, jax.devices()[:1]),
                                        **model_kw)
    init = jax.tree_util.tree_map(np.asarray, jtr.params)
    ttr = DistributedLMTrainer(DistTrainConfig(lr=TRAIN_LR, weight_decay=0.01, use_remat=True,
                                               ce_chunk=64, mu_dtype=mu_dtype),
                               dtype=torch.float32, device="cpu",
                               params=variables_from_jax(init), **model_kw)
    jl = jtr.train(_data(64, 2, 128), 3, log_fn=None)
    tl = ttr.train(_data(64, 2, 128), 3, log_fn=None)
    np.testing.assert_allclose(tl, jl, rtol=1e-4 if mu_dtype else 1e-5)
    assert tl[-1] < tl[0]
    want = flatten_paths(jax.tree_util.tree_map(np.asarray, jtr.params))
    close = total = 0
    for path, p in ttr.params.items():
        diff = np.abs(p.detach().numpy() - want[path])
        assert diff.max() <= TRAIN_PARAM_ATOL, (path, diff.max())
        close += int((diff <= 1e-5).sum())
        total += diff.size
    assert close >= 0.99 * total
    if mu_dtype:
        assert all(m.dtype == torch.bfloat16 for m in ttr.opt_state.mu.values())
