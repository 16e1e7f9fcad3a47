"""Cheetah: the causal-LM trainer (port of ``fedml_tpu/parallel/trainer.py``).

One device only: ``dp = tp = sp = 1``. The JAX trainer's data, tensor and
sequence parallelism over a mesh wait for ROADMAP.md Queue 1 item 10; any
other degree raises. A step is the JAX step: the loss (chunked CE when
``ce_chunk`` is set, with the head kernel cast to the hidden's dtype), its
gradient through the blocks (recomputed in the backward when ``use_remat``,
wholly or, with ``remat_policy="dots"``, all but the matrix products),
and optax's ``adamw`` written out over the parameter dict. Parameters are
float32; the model computes in ``dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..models import init_params
from ..models.transformer import TransformerLM
from ..ops.losses import chunked_lm_cross_entropy, softmax_cross_entropy
from ..utils import resolve_device

__all__ = ["DistTrainConfig", "DistributedLMTrainer", "AdamWState", "adamw_init",
           "adamw_update"]


@dataclasses.dataclass(frozen=True)
class DistTrainConfig:
    dp: int = 1
    tp: int = 1
    sp: int = 1
    lr: float = 3e-4
    weight_decay: float = 0.01
    use_remat: bool = True   # recompute each block in the backward
    remat_policy: str = "full"  # or "dots": save the matrix products' outputs
    # chunked LM cross-entropy (ops/losses.py): 0 = full logits, else the
    # sequence-chunk size
    ce_chunk: int = 0
    # AdamW first-moment dtype ("bfloat16" or None = the gradient's)
    mu_dtype: Optional[str] = None


class AdamWState(NamedTuple):
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def adamw_init(params: Dict[str, torch.Tensor], mu_dtype: Optional[torch.dtype] = None):
    mu = {k: torch.zeros_like(p, dtype=mu_dtype or p.dtype) for k, p in params.items()}
    return AdamWState(0, mu, {k: torch.zeros_like(p) for k, p in params.items()})


def adamw_update(grads, state: AdamWState, params, lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: Optional[torch.dtype] = None):
    """optax's ``adamw``: ``scale_by_adam`` (bias-corrected moments, the
    first stored in ``mu_dtype``), then ``add_decayed_weights`` on every
    leaf, then ``-lr``. Returns (updates, new state); the caller adds the
    updates to the parameters."""
    count = state.count + 1
    # 1 - decay**count in float32, as optax's bias_correction computes it
    bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
    bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
    updates, mu, nu = {}, {}, {}
    for k, g in grads.items():
        m = (1 - b1) * g + b1 * state.mu[k]
        v = (1 - b2) * (g * g) + b2 * state.nu[k]
        u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        updates[k] = (u + weight_decay * params[k]) * -lr
        mu[k] = m.to(mu_dtype) if mu_dtype is not None else m
        nu[k] = v
    return updates, AdamWState(count, mu, nu)


class DistributedLMTrainer:
    """The Cheetah causal-LM trainer on one device.

    ``device`` defaults to the CUDA card and raises without one; pass
    ``device="cpu"`` to run on the CPU (the plain kernel versions).
    ``params`` (a flat path-keyed dict, e.g. from
    ``utils.convert.variables_from_jax``) replaces the seeded init."""

    def __init__(self, cfg: DistTrainConfig, vocab_size: int = 1024, dim: int = 256,
                 num_heads: int = 8, num_layers: int = 4, max_len: int = 2048,
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device=None, params: Optional[Dict[str, torch.Tensor]] = None):
        if max(cfg.dp, cfg.tp, cfg.sp) > 1:
            raise NotImplementedError(
                f"dp={cfg.dp}, tp={cfg.tp}, sp={cfg.sp} needs a device mesh, which is not "
                "ported yet (ROADMAP.md Queue 1 item 10); the port trains on one device")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = TransformerLM(
            vocab_size=vocab_size, dim=dim, num_heads=num_heads, num_layers=num_layers,
            max_len=max_len, dtype=dtype,
            remat=(cfg.remat_policy if cfg.remat_policy != "full" else True)
            if cfg.use_remat else False).to(self.device)
        init = params if params is not None else init_params(
            self.model, torch.Generator().manual_seed(seed))
        # the module's own parameters, keyed by flax path
        self.params: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                path = "params/" + name.replace(".", "/")
                if tuple(init[path].shape) != tuple(p.shape):
                    raise ValueError(f"{path}: {tuple(init[path].shape)} != {tuple(p.shape)}")
                p.copy_(init[path])
                self.params[path] = p
        self.mu_dtype = getattr(torch, cfg.mu_dtype) if cfg.mu_dtype else None
        self.opt_state = adamw_init(self.params, self.mu_dtype)

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        if self.cfg.ce_chunk:
            hid = self.model(tokens, return_hidden=True)
            head = self.model.head.kernel.to(hid.dtype)
            return chunked_lm_cross_entropy(hid, head, targets, chunk=self.cfg.ce_chunk)
        return softmax_cross_entropy(self.model(tokens), targets)

    def step(self, tokens: np.ndarray, targets: np.ndarray) -> float:
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long).to(self.device)
        targets = torch.as_tensor(np.asarray(targets), dtype=torch.long).to(self.device)
        loss = self.loss(tokens, targets)
        grads = torch.autograd.grad(loss, list(self.params.values()))
        with torch.no_grad():
            updates, self.opt_state = adamw_update(
                dict(zip(self.params, grads)), self.opt_state, self.params, self.cfg.lr,
                self.cfg.weight_decay, mu_dtype=self.mu_dtype)
            for k, p in self.params.items():
                p.add_(updates[k])
        return float(loss.detach())

    def train(self, data_iter, steps: int, log_every: int = 10, log_fn=print) -> list:
        losses = []
        for i in range(steps):
            tokens, targets = next(data_iter)
            loss = self.step(tokens, targets)
            losses.append(loss)
            if log_fn and i % log_every == 0:
                log_fn(f"[cheetah step {i}] loss={loss:.4f}")
        return losses
