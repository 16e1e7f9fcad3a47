"""Attention (port of ``fedml_tpu/ops/attention.py``): the single-device
``multihead_attention``, dense or flash, and its auto dispatch.

``ulysses_attention`` and ``ring_attention`` need a device mesh and wait
for it (ROADMAP.md Queue 1 item 10).
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from .flash_attention import (BLOCK_TABLE, BLOCK_TABLE_SWEPT_SHAPE, flash_attention,
                              flash_shapes_ok)


def auto_attention_impl(B: int, H: int, T: int, Dh: int, itemsize: int = 2) -> str:
    """'flash' or 'dense' for (B, T, H, Dh) attention, decided as the JAX
    package decides: flash from T = 4096 (the v5e's speed crossover), or
    where one layer's saved dense probabilities pass 512 MiB, or at a T that
    ``BLOCK_TABLE`` lists for the swept shape — and only where
    ``flash_shapes_ok``. The thresholds are the v5e's; re-deriving them on
    the H100 is ROADMAP.md Queue 1 item 13."""
    dense_saved_bytes = B * H * T * T * itemsize
    want_flash = (T >= 4096 or dense_saved_bytes > 512 * 1024**2
                  or (T in BLOCK_TABLE and (Dh, itemsize) == BLOCK_TABLE_SWEPT_SHAPE))
    if want_flash and flash_shapes_ok(T, Dh, itemsize=itemsize):
        return "flash"
    return "dense"


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, impl: Optional[str] = None) -> torch.Tensor:
    """Attention on q/k/v (B, T, H, Dh) -> (B, T, H, Dh). ``impl``: 'flash'
    (the CUDA kernels, ``ops/flash_attention.py``), 'dense', or None = auto.

    Dense keeps the JAX arithmetic: logits in the compute dtype times
    ``1/sqrt(Dh)`` cast to that dtype, masked with ``finfo(dtype).min``,
    softmax in float32, cast back."""
    T, Dh = q.shape[1], q.shape[-1]
    if impl is None:
        itemsize = q.element_size()
        impl = auto_attention_impl(q.shape[0], q.shape[2], T, Dh, itemsize)
        saved_gb = q.shape[0] * q.shape[2] * T * T * itemsize / 2**30
        if impl == "dense" and (T >= 8192 or saved_gb > 0.5):
            logging.warning(
                "attention auto-dispatch: falling back to DENSE O(T^2) attention at T=%d "
                "(flash needs T tileable by 128-blocks and Dh in {64, k*128}; got Dh=%d) — "
                "expect ~%.1f GB of saved probabilities PER LAYER", T, Dh, saved_gb)
    if impl == "flash":
        return flash_attention(q, k, v, causal)
    if impl != "dense":
        raise ValueError(f"attention impl must be 'flash', 'dense' or None, got {impl!r}")
    scale = 1.0 / torch.sqrt(torch.tensor(float(Dh))).to(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = torch.ones((T, k.shape[1]), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
