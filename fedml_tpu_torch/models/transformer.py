"""Decoder-only transformer LM (port of ``fedml_tpu/models/transformer.py``):
``causal_mask``, ``MLPBlock``, ``SelfAttention``, ``Block`` and
``TransformerLM``.

Parameters keep flax's layout under flax's paths (``wte/embedding``,
``block_0/SelfAttention_0/qkv/kernel``, ``block_0/MLPBlock_0/Dense_0/bias``,
``ln_f/scale``, ``head/kernel``), so ``utils.convert.variables_from_jax``
carries a JAX tree over without a transpose. Parameters are float32; the
module's ``dtype`` is the compute dtype, to which every layer casts its
input and its parameters, as flax's ``dtype`` does.

Only the single-device path is ported: attention runs through
``ops.attention.multihead_attention`` (dense, or the CUDA flash kernels).
The sequence-parallel path (``seq_axis``, ring and Ulysses attention) waits
for a mesh (ROADMAP.md Queue 1 item 10); the encoder models, ViT and
seq2seq wait for a later slice (item 13).
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..ops.attention import multihead_attention
from .linear import Dense


def causal_mask(T: int, device=None) -> torch.Tensor:
    return torch.ones((T, T), dtype=torch.bool, device=device).tril()


class Embed(nn.Module):
    """``flax.linen.Embed``: leaf ``embedding`` (num, features), cast to
    ``dtype`` before the lookup."""

    def __init__(self, num_embeddings: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, self.embedding.to(self.dtype))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm`` over the last axis: statistics in float32 as
    E[x^2] - E[x]^2 clipped at 0, epsilon 1e-6, ``y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias`` in float32, returned in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32, epsilon: float = 1e-6):
        super().__init__()
        self.dtype, self.epsilon = dtype, epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.scale) + self.bias
        return y.to(self.dtype)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden_mult: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = Dense(dim, dim * hidden_mult, dtype=dtype)
        self.Dense_1 = Dense(dim * hidden_mult, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax's nn.gelu is the tanh approximation
        return self.Dense_1(F.gelu(self.Dense_0(x), approximate="tanh"))


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, causal: bool = True,
                 dtype: torch.dtype = torch.float32, attn_impl: Optional[str] = None):
        super().__init__()
        self.dim, self.num_heads, self.causal, self.attn_impl = dim, num_heads, causal, attn_impl
        self.qkv = Dense(dim, 3 * dim, use_bias=False, dtype=dtype)
        self.proj = Dense(dim, dim, use_bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads
        # views of the projection: the flash kernels read them through strides
        q, k, v = (t.reshape(B, T, H, D // H) for t in self.qkv(x).split(self.dim, dim=-1))
        out = multihead_attention(q, k, v, causal=self.causal, impl=self.attn_impl)
        return self.proj(out.reshape(B, T, D))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, causal: bool = True,
                 dtype: torch.dtype = torch.float32, attn_impl: Optional[str] = None):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, dtype)
        self.SelfAttention_0 = SelfAttention(dim, num_heads, causal, dtype, attn_impl)
        self.LayerNorm_1 = LayerNorm(dim, dtype)
        self.MLPBlock_0 = MLPBlock(dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.SelfAttention_0(self.LayerNorm_0(x))
        return x + self.MLPBlock_0(self.LayerNorm_1(x))


# the matrix products whose outputs remat "dots" saves, as
# jax.checkpoint_policies.checkpoint_dots saves every dot_general's output
# (batched ones too): Dense's ``x @ kernel`` reaches the dispatcher as mm,
# dense attention's einsums as bmm
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _rematerialized(block: nn.Module, h: torch.Tensor, policy: str) -> torch.Tensor:
    """``block(h)`` under ``torch.utils.checkpoint``: the backward recomputes
    the block, all of it ("full") or all but the outputs of ``_DOT_OPS``
    ("dots", a selective checkpoint). Either way the flash forward runs
    again in the recompute: its kernel launches through ctypes, unseen by
    the dispatcher, inside ``_FlashAttention.forward``, which the recompute
    re-executes. The block's parameters are passed in explicitly, so the
    recompute uses the tensors of the forward even where the forward ran
    under ``functional_call`` (which has restored the module by then)."""
    names = [n for n, _ in block.named_parameters()]
    tensors = [functools.reduce(getattr, n.split("."), block) for n in names]

    def run(h, *ts):
        return functional_call(block, dict(zip(names, ts)), (h,))

    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             list(_DOT_OPS))
    return checkpoint(run, h, *tensors, use_reentrant=False, **kw)


class TransformerLM(nn.Module):
    """Decoder-only causal LM.

    ``remat``: False saves every activation; True or "full" recomputes each
    block in the backward (``torch.utils.checkpoint``); "dots" saves the
    outputs of the block's matrix products and recomputes the rest, the
    flash forward included (JAX's ``checkpoint_dots``)."""

    def __init__(self, vocab_size: int = 32000, dim: int = 256, num_heads: int = 8,
                 num_layers: int = 4, max_len: int = 2048, dtype: torch.dtype = torch.float32,
                 attn_impl: Optional[str] = None, remat: Union[bool, str] = False):
        super().__init__()
        if remat not in (False, True, "full", "dots"):
            raise ValueError(f"unknown remat policy {remat!r}; use False, True, 'full', or 'dots'")
        self.num_layers, self.max_len = num_layers, max_len
        # None (save everything), "full" or "dots"
        self.remat = "dots" if remat == "dots" else ("full" if remat else None)
        self.wte = Embed(vocab_size, dim, dtype)
        self.wpe = Embed(max_len, dim, dtype)
        for i in range(num_layers):
            self.add_module(f"block_{i}", Block(dim, num_heads, True, dtype, attn_impl))
        self.ln_f = LayerNorm(dim, dtype)
        self.head = Dense(dim, vocab_size, use_bias=False, dtype=dtype)

    def forward(self, tokens: torch.Tensor, train: bool = False,
                return_hidden: bool = False) -> torch.Tensor:
        T = tokens.shape[1]
        if T > self.max_len:
            raise ValueError(f"sequence length {T} exceeds max_len {self.max_len}")
        h = self.wte(tokens) + self.wpe(torch.arange(T, device=tokens.device)[None, :])
        for i in range(self.num_layers):
            block = getattr(self, f"block_{i}")
            h = _rematerialized(block, h, self.remat) if self.remat else block(h)
        h = self.ln_f(h)
        if return_hidden:
            # for the chunked CE (ops/losses.py): the head runs per chunk
            return h
        return self.head(h)
