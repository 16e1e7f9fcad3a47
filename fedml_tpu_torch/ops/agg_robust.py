"""Gram matrix of the flat cohort stack (kernel 2 of the slice).

Port of ``fedml_tpu/ops/pallas/agg_robust.py::fused_gram``. On a CUDA
tensor :func:`gram` launches the hand-written split-contraction kernel in
``csrc/agg_robust.cu`` (or raises); on a CPU tensor it runs
:func:`gram_plain`. Unlike the Pallas kernel, which fell back to its jnp
reference above D = 131,072, the CUDA kernel takes any (C, D).

The contract is a tolerance, not bits: the kernel sums in another order
than XLA or cuBLAS. Krum selections must come out identical, and the
kernel's own result repeats bit for bit (fixed-order reduction).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

TILE = 16       # output tile edge (csrc/agg_robust.cu kTile)
COLS = 64       # contraction columns staged per step (kCols)
TARGET_BLOCKS = 132 * 8  # about eight blocks per H100 SM


def split_plan(C: int, D: int) -> Tuple[int, int]:
    """(span, splits): the contraction is cut into ``splits`` column spans
    of ``span`` (a multiple of COLS) so that tiles x tiles x splits fills
    the card even when the (C, C) output is a single tile."""
    def cdiv(a, b):
        return -(-a // b)

    tiles = cdiv(C, TILE)
    splits = min(max(1, cdiv(TARGET_BLOCKS, tiles * tiles)), cdiv(D, COLS), 65535)
    span = cdiv(cdiv(D, splits), COLS) * COLS
    return span, cdiv(D, span)


def gram_plain(flat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``flat @ flat.T``."""
    return flat @ flat.T


def gram(flat: torch.Tensor) -> torch.Tensor:
    """(C, C) f32 Gram matrix of a finite (C, D) f32 stack (the caller
    applies ``nan_to_num`` first, as the JAX caller does)."""
    if flat.dtype != torch.float32 or flat.dim() != 2 or min(flat.shape) < 1:
        raise ValueError(f"flat must be a non-empty 2-D float32 tensor, got "
                         f"{flat.dtype} {tuple(flat.shape)}")
    if flat.device.type == "cpu":
        return gram_plain(flat)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    if not flat.is_contiguous():
        raise ValueError("flat must be contiguous")
    C, D = flat.shape
    span, splits = split_plan(C, D)
    lib = _build.load("agg_robust")
    fn = lib.fedml_gram
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    partial = torch.empty((splits, C, C), dtype=torch.float32, device=flat.device)
    out = torch.empty((C, C), dtype=torch.float32, device=flat.device)
    err = fn(flat.data_ptr(), C, D, span, splits, partial.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(flat.device).cuda_stream)
    _build.check(err, "fedml_gram")
    gram.launches += 1
    return out


gram.launches = 0
