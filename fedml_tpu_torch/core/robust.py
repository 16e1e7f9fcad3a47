"""Robust aggregation defenses (port of ``fedml_tpu/core/robust.py``):
norm clipping, weak DP, coordinate median, trimmed mean, the update
sanitizer and the Krum family.

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
from torch.func import vmap

from ..ops import agg_robust

Tree = Dict[str, torch.Tensor]


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: mean of the two middle order
    statistics (``_masked_median``, :137), NaN if any entry is NaN."""
    n = x.shape[0]
    s = torch.sort(x).values
    med = 0.5 * (s[(n - 1) // 2] + s[n // 2])
    return torch.where(torch.isnan(x).any(), torch.nan, med)


_NON_WEIGHT_KEYS = ("running_mean", "running_var", "num_batches_tracked", "batch_stats")


def _is_weight_path(path: str) -> bool:
    """False for BatchNorm running statistics, which the clipping defenses
    leave unscaled (robust.py:32, the reference's ``is_weight_param``)."""
    return not any(nk in part for part in path.split("/") for nk in _NON_WEIGHT_KEYS)


def global_norm(tree: Tree, weights_only: bool = False) -> torch.Tensor:
    """L2 norm over all (weight) leaves of one client's tree (robust.py:37)."""
    leaves = [v for k, v in tree.items() if not weights_only or _is_weight_path(k)]
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def norm_clip_update(update: Tree, norm_bound: float) -> Tree:
    """Scale one client's update so its weight norm is at most
    ``norm_bound`` (robust.py:73); running statistics pass unscaled."""
    norm = global_norm(update, weights_only=True)
    scale = 1.0 / torch.clamp(norm / norm_bound, min=1.0)
    return {k: v * scale if _is_weight_path(k) else v for k, v in update.items()}


def norm_clip_stacked(stacked: Tree, norm_bound: float) -> Tree:
    """:func:`norm_clip_update` of every client of a stacked cohort."""
    return vmap(lambda u: norm_clip_update(u, norm_bound))(stacked)


def add_gaussian_noise(tree: Tree, stddev: float, generator: torch.Generator) -> Tree:
    """Weak-DP Gaussian noise on the aggregate (robust.py:91): one draw per
    leaf, in leaf order, from ``generator``."""
    return {k: v + stddev * torch.randn(v.shape, generator=generator, dtype=v.dtype,
                                        device=v.device)
            for k, v in tree.items()}


def coordinate_median(stacked: Tree) -> Tree:
    """Coordinate-wise median over the client axis (robust.py:102), as
    ``jnp.median``: the mean of the two middle values for an even count
    (``torch.median`` returns the lower one), NaN where a column has one."""

    def med(x):
        n = x.shape[0]
        s = torch.sort(x, dim=0).values
        m = 0.5 * (s[(n - 1) // 2] + s[n // 2])
        return torch.where(torch.isnan(x).any(dim=0), torch.nan, m)

    return {k: med(x) for k, x in stacked.items()}


def trimmed_mean(stacked: Tree, trim_ratio: float = 0.1,
                 weights: Optional[torch.Tensor] = None) -> Tree:
    """Coordinate-wise trimmed mean (robust.py:109): ``k = min(int(n
    trim_ratio), (n - 1) // 2)`` values cut at each end; with ``weights``
    the survivors are combined by their owners' weights (a stable sort, so
    ties keep the client order, as ``jnp.argsort``)."""

    def tm(x):
        n = x.shape[0]
        k = min(int(n * trim_ratio), (n - 1) // 2)
        if weights is None:
            return torch.sort(x, dim=0).values[k:n - k].mean(dim=0)
        xf = x.float()
        order = torch.sort(xf, dim=0, stable=True).indices
        xs = torch.take_along_dim(xf, order, dim=0)
        ws = weights.float()[order]
        num = torch.sum(xs[k:n - k] * ws[k:n - k], dim=0)
        den = torch.clamp(torch.sum(ws[k:n - k], dim=0), min=1e-12)
        return (num / den).to(x.dtype)

    return {k: tm(x) for k, x in stacked.items()}


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
    """Config-driven defense (robust.py:445): ``defense_type`` None / "none",
    "norm_diff_clipping", "weak_dp", "coordinate_median", "trimmed_mean"
    and the Krum family. ``norm_bound`` is the clip, ``stddev`` weak DP's
    noise, ``trim_ratio`` the trimmed share; ``byzantine_n`` is Krum's f
    (0 = auto ``(C-3)//2``), ``multi_krum_m`` the survivor count (None =
    ``C - f``)."""

    defense_type: Optional[str] = None
    norm_bound: float = 1.0
    stddev: float = 0.0
    trim_ratio: float = 0.1
    byzantine_n: int = 0
    multi_krum_m: Optional[int] = None

    KRUM_FAMILY = ("krum", "multi_krum", "krum_fedavg")
    DEFENSES = (None, "none", "norm_diff_clipping", "weak_dp", "coordinate_median",
                "trimmed_mean") + KRUM_FAMILY

    def __post_init__(self):
        if self.defense_type not in self.DEFENSES:
            raise ValueError(f"unknown defense_type '{self.defense_type}'")

    def _krum_fm(self, cohort_size: int) -> tuple:
        f = self.byzantine_n if self.byzantine_n > 0 else max(0, (cohort_size - 3) // 2)
        if self.defense_type == "krum":
            return f, 1
        m = int(self.multi_krum_m) if self.multi_krum_m else max(1, cohort_size - f)
        return f, m

    def aggregate(self, stacked: Tree, weights: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> Tree:
        """The defended aggregate (robust.py:486); weak DP draws its noise
        from ``generator``, which must be fresh every round."""
        w = weights / torch.clamp(weights.sum(), min=1e-12)

        def mean(tree):
            return {k: torch.tensordot(w.to(x.dtype), x, dims=1) for k, x in tree.items()}

        dt = self.defense_type
        if dt in (None, "none"):
            return mean(stacked)
        if dt == "norm_diff_clipping":
            return mean(norm_clip_stacked(stacked, self.norm_bound))
        if dt == "weak_dp":
            if generator is None:
                raise ValueError("weak_dp requires a fresh per-round generator; a fixed one "
                                 "would add the same noise every round (no privacy)")
            return add_gaussian_noise(mean(norm_clip_stacked(stacked, self.norm_bound)),
                                      self.stddev, generator)
        if dt == "coordinate_median":
            return coordinate_median(stacked)
        if dt == "trimmed_mean":
            return trimmed_mean(stacked, self.trim_ratio, weights=weights)
        f, m = self._krum_fm(weights.shape[0])
        agg, _ = krum_aggregate(stacked, weights, n_byz=f, m=m,
                                sample_weighted=dt == "krum_fedavg")
        return agg
