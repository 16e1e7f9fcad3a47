"""Update sanitizer and the Krum defense family (port of
``fedml_tpu/core/robust.py``).

Everything works on a *stacked* cohort: a path-keyed dict of (C, *leaf)
tensors in the JAX package's leaf order. The expressions follow the JAX
functions one for one; the places where torch differs are handled here:

- medians average the two middle order statistics for an even count, as
  ``jnp.median`` does (``torch.median`` returns the lower one);
- Krum's m best clients are picked by a *stable* ascending sort, which
  breaks ties by the lower index exactly as ``jax.lax.top_k(-scores, m)``;
- quarantined rows are masked with ``where``, never multiplied (0 * inf).

The Gram plane of the pairwise distances goes through
``ops.agg_robust.gram`` (the CUDA kernel on the card) on both the fused and
the sequential path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..ops import agg_robust

Tree = Dict[str, torch.Tensor]


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: mean of the two middle order
    statistics (``_masked_median``, :137), NaN if any entry is NaN."""
    n = x.shape[0]
    s = torch.sort(x).values
    med = 0.5 * (s[(n - 1) // 2] + s[n // 2])
    return torch.where(torch.isnan(x).any(), torch.nan, med)


def _row_mask(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (x.dim() - 1))


def _sanitize_stats(stacked: Tree, z_thresh: float):
    """Per-client non-finite flag and robust z of the update norm, with
    ``sanitize_stacked``'s per-leaf expressions (robust.py:189-212)."""
    leaves = list(stacked.values())
    C = leaves[0].shape[0]
    bad = torch.zeros(C, dtype=torch.bool, device=leaves[0].device)
    sq = torch.zeros(C, dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        xf = x.float().reshape(C, -1)
        bad = bad | ~torch.isfinite(xf).all(dim=1)
        sq = sq + torch.square(torch.nan_to_num(xf)).sum(dim=1)
    norm = torch.sqrt(sq)
    med = _median(norm)
    mad = _median(torch.abs(norm - med))
    scale = torch.maximum(1.4826 * mad, 1e-6 + 0.05 * med)
    z = torch.where(bad, torch.inf, (norm - med) / scale)
    quarantine = bad | (z > z_thresh)
    return quarantine, z


def sanitize_stacked(stacked: Tree, weights: torch.Tensor, z_thresh: float = 6.0):
    """Quarantine non-finite and norm-outlier rows: returns ``(clean,
    clean_weights, quarantine, z)`` with quarantined rows zeroed and
    zero-weighted (robust.py:147)."""
    quarantine, z = _sanitize_stats(stacked, z_thresh)
    keep = 1.0 - quarantine.float()
    clean = {k: torch.where(_row_mask(quarantine, x), torch.zeros_like(x), x)
             for k, x in stacked.items()}
    return clean, weights * keep, quarantine, z


def _flat(stacked: Tree) -> torch.Tensor:
    C = next(iter(stacked.values())).shape[0]
    return torch.cat([torch.nan_to_num(x.float()).reshape(C, -1)
                      for x in stacked.values()], dim=1)


def _dists(sqn: torch.Tensor, gram: torch.Tensor) -> torch.Tensor:
    return torch.clamp(sqn[:, None] + sqn[None, :] - 2.0 * gram, min=0.0)


def pairwise_sq_dists(stacked: Tree) -> torch.Tensor:
    """(C, C) squared L2 distances between clients' (nan-zeroed) updates
    from one Gram matrix (robust.py:231)."""
    flat = _flat(stacked)
    return _dists((flat * flat).sum(dim=1), agg_robust.gram(flat))


def krum_scores(dists: torch.Tensor, n_byz: int) -> torch.Tensor:
    """Sum of each client's ``C - f - 2`` smallest distances to others
    (robust.py:281)."""
    C = dists.shape[0]
    k = max(1, min(C - n_byz - 2, C - 1))
    return torch.sort(dists, dim=1).values[:, 1:k + 1].sum(dim=1)


def _krum_weights(scores, weights, m, sample_weighted):
    """Selection mask and normalised averaging weights of the ``m``
    lowest-scoring clients; zero-weight clients are never selected."""
    scores = torch.where(weights > 0, scores, torch.inf)
    C = scores.shape[0]
    m = max(1, min(int(m), C))
    idx = torch.sort(scores, stable=True).indices[:m]
    selected = torch.zeros(C, dtype=torch.float32, device=scores.device)
    selected[idx] = 1.0
    selected = selected * (weights > 0)
    w = selected * weights.float() if sample_weighted else selected
    return selected, w / torch.clamp(w.sum(), min=1e-12)


def krum_aggregate(stacked: Tree, weights: torch.Tensor, n_byz: int = 0, m: int = 1,
                   sample_weighted: bool = False) -> Tuple[Tree, torch.Tensor]:
    """Krum (m=1) / multi-Krum aggregate and the (C,) selection mask
    (robust.py:296)."""
    scores = krum_scores(pairwise_sq_dists(stacked), n_byz)
    selected, w = _krum_weights(scores, weights, m, sample_weighted)
    agg = {k: torch.tensordot(w.to(x.dtype), x, dims=1) for k, x in stacked.items()}
    return agg, selected


def fused_sanitize_krum(stacked: Tree, weights: torch.Tensor, z_thresh: float = 6.0,
                        n_byz: int = 0, m: int = 1, sample_weighted: bool = False):
    """``sanitize_stacked`` followed by ``krum_aggregate`` without the
    zeroed copy of the stack (robust.py:335): the Gram matrix is taken of
    the raw (nan-zeroed) stack and the quarantine is applied to it with
    ``where`` masks — a zeroed row has squared norm and Gram entries exactly
    0, so the distances equal the sequential path's.
    Returns ``(agg, clean_weights, quarantine, z, selected)``."""
    quarantine, z = _sanitize_stats(stacked, z_thresh)
    clean_weights = weights * (1.0 - quarantine.float())
    flat = _flat(stacked)
    sqn = (flat * flat).sum(dim=1)
    gram = agg_robust.gram(flat)
    sqn_m = torch.where(quarantine, 0.0, sqn)
    pair_q = quarantine[:, None] | quarantine[None, :]
    d = _dists(sqn_m, torch.where(pair_q, 0.0, gram))
    selected, w = _krum_weights(krum_scores(d, n_byz), clean_weights, m, sample_weighted)
    agg = {k: torch.tensordot(w.to(x.dtype),
                              torch.where(_row_mask(quarantine, x), torch.zeros_like(x), x),
                              dims=1)
           for k, x in stacked.items()}
    return agg, clean_weights, quarantine, z, selected


@dataclasses.dataclass(frozen=True)
class RobustAggregator:
    """Config-driven defense (robust.py:445) for ``defense_type`` None /
    "none" and the Krum family. ``byzantine_n`` is Krum's f (0 = auto
    ``(C-3)//2``); ``multi_krum_m`` the survivor count (None = ``C - f``)."""

    defense_type: Optional[str] = None
    byzantine_n: int = 0
    multi_krum_m: Optional[int] = None

    KRUM_FAMILY = ("krum", "multi_krum", "krum_fedavg")

    def __post_init__(self):
        if self.defense_type not in (None, "none") + self.KRUM_FAMILY:
            raise NotImplementedError(
                f"defense_type '{self.defense_type}' is not ported yet (ROADMAP.md "
                "Queue 1, item 5); this slice has none and the Krum family")

    def _krum_fm(self, cohort_size: int) -> tuple:
        f = self.byzantine_n if self.byzantine_n > 0 else max(0, (cohort_size - 3) // 2)
        if self.defense_type == "krum":
            return f, 1
        m = int(self.multi_krum_m) if self.multi_krum_m else max(1, cohort_size - f)
        return f, m

    def aggregate(self, stacked: Tree, weights: torch.Tensor) -> Tree:
        if self.defense_type in (None, "none"):
            w = weights / torch.clamp(weights.sum(), min=1e-12)
            return {k: torch.tensordot(w.to(x.dtype), x, dims=1) for k, x in stacked.items()}
        f, m = self._krum_fm(weights.shape[0])
        agg, _ = krum_aggregate(stacked, weights, n_byz=f, m=m,
                                sample_weighted=self.defense_type == "krum_fedavg")
        return agg
