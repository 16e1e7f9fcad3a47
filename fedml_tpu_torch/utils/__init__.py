"""Process-level helpers: seeding and device selection."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seeds(seed: int) -> None:
    """One-shot startup seeding, as ``fedml_tpu.utils.set_seeds``: Python's
    and numpy's process-global streams (the Dirichlet partition draws from
    numpy's, so both packages partition identically) plus torch's default
    generator for user code. The port's own random draws use explicit
    ``torch.Generator``s."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ.setdefault("PYTHONHASHSEED", str(seed))
    torch.manual_seed(seed)


def resolve_device(name=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU (``device: cpu`` in the config). Asking for the card
    without one raises — the port never falls back to the CPU quietly.

    On the card, float32 matmuls and convolutions are pinned to full fp32
    (TF32 off), matching the reference harness's
    ``jax_default_matmul_precision=highest``."""
    dev = torch.device(str(name) if name else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fedml_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device '{dev}' (expected cuda or cpu)")
    return dev


__all__ = ["set_seeds", "resolve_device"]
