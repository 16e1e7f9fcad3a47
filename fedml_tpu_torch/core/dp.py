"""Differential-privacy accounting for the DP-SGD mechanism (port of
``fedml_tpu/core/dp.py``; numpy only).

The mechanism lives in ``algorithms/local_sgd.py`` (``dp_l2_clip`` +
``dp_noise_multiplier``: per-example gradient clipping, Gaussian noise on
the batch sum); this module turns (noise multiplier, steps) into an
(eps, delta) guarantee by Renyi-DP composition of the Gaussian mechanism:
RDP_alpha = T alpha / (2 sigma^2), eps = min_alpha RDP_alpha +
log(1/delta) / (alpha - 1). It applies no subsampling amplification, so the
reported eps is an upper bound whenever batches are subsampled.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def rdp_epsilon(noise_multiplier: float, steps: int, delta: float = 1e-5,
                orders: Optional[np.ndarray] = None) -> float:
    """(eps, delta)-DP upper bound after ``steps`` compositions of the
    Gaussian mechanism with the given noise multiplier (sigma = multiplier
    * sensitivity, the sensitivity being the clip norm). inf without noise."""
    if noise_multiplier <= 0:
        return float("inf")
    if orders is None:
        orders = np.concatenate([
            np.linspace(1.1, 10.9, 99), np.arange(11, 256, dtype=np.float64),
        ])
    rdp = steps * orders / (2.0 * noise_multiplier ** 2)
    eps = rdp + np.log(1.0 / delta) / (orders - 1.0)
    return float(np.min(eps))


def epsilon_for_training(noise_multiplier: float, comm_rounds: int, steps_per_round: int,
                         delta: float = 1e-5) -> float:
    """eps for a whole run: every local DP-SGD step composes."""
    return rdp_epsilon(noise_multiplier, comm_rounds * steps_per_round, delta)
