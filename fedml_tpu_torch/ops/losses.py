"""Losses (port of ``fedml_tpu/ops/losses.py``): ``softmax_cross_entropy``
and ``chunked_lm_cross_entropy`` for the LM, ``per_sample_metrics`` for
the per-client local tests."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch. logits (..., C), labels (...) int."""
    logz = torch.log_softmax(logits.float(), dim=-1)
    return -logz.gather(-1, labels[..., None].long())[..., 0].mean()


def _chunk_log_likelihood(h: torch.Tensor, t: torch.Tensor, head_kernel: torch.Tensor):
    logz = torch.log_softmax((h @ head_kernel).float(), dim=-1)
    return logz.gather(-1, t[..., None].long())[..., 0]


def chunked_lm_cross_entropy(hidden: torch.Tensor, head_kernel: torch.Tensor,
                             targets: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Mean next-token CE without the full (B, T, V) float32 logits: the head
    product and the log-softmax run one sequence chunk at a time, each under
    ``torch.utils.checkpoint`` (as JAX's ``jax.checkpoint`` under
    ``lax.map``), so the backward recomputes a chunk's logits from its saved
    hidden slice. hidden (B, T, D), head_kernel (D, V), targets (B, T) int;
    T must be divisible by ``chunk``."""
    B, T, D = hidden.shape
    if T % chunk:
        raise ValueError(f"T={T} not divisible by chunk={chunk}")
    ll = [checkpoint(_chunk_log_likelihood, hidden[:, c:c + chunk], targets[:, c:c + chunk],
                     head_kernel, use_reentrant=False)
          for c in range(0, T, chunk)]
    return -torch.stack(ll).mean()


def per_sample_metrics(out: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                       loss_kind: str = "ce"):
    """Per-sample ``(loss_sum, correct, valid)`` float32 vectors, shape (B,)
    (``fedml_tpu/ops/losses.py:114``, its ``ce`` branch): the segmented
    per-client evaluator scatter-adds them into each sample's client.
    Reductions run over every trailing label axis."""
    if loss_kind != "ce":
        raise NotImplementedError(
            f"per_sample_metrics for loss_kind '{loss_kind}' is not ported yet "
            "(ROADMAP.md Queue 1, item 3); the port has the 'ce' branch")
    axes = tuple(range(1, max(y.dim(), mask.dim())))
    logz = torch.log_softmax(out.float(), dim=-1)
    ll = torch.take_along_dim(logz, y.long()[..., None], dim=-1)[..., 0]
    m = mask.reshape(mask.shape + (1,) * (ll.dim() - mask.dim())).expand(ll.shape).float()
    correct = ((out.argmax(dim=-1) == y) * m)
    if axes:
        return -(ll * m).sum(axes), correct.sum(axes), m.sum(axes)
    return -(ll * m), correct, m
