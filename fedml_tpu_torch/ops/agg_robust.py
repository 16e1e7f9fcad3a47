"""Gram matrix of the flat cohort stack (kernel 2 of the slice).

Port of ``fedml_tpu/ops/pallas/agg_robust.py::fused_gram``. On a CUDA
tensor :func:`gram` launches the hand-written kernels in
``csrc/agg_robust.cu`` (or raises); on a CPU tensor it runs
:func:`gram_plain`. Unlike the Pallas kernel, which fell back to its jnp
reference above D = 131,072, the CUDA kernels take any (C, D).

:func:`route` picks the kernel by cohort size: ``small`` (C <= 16, every
example config's cohort) streams each element once and keeps the upper
triangle in registers; ``tiled`` (C > 16) computes 16x16 output tiles over
column spans.

The contract is a tolerance, not bits: the kernels sum in another order
than XLA or cuBLAS. Krum selections must come out identical, the kernels'
own result repeats bit for bit (fixed-order reductions, no atomics) and is
exactly symmetric.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

SMALL_MAX_C = 16          # largest cohort of the small route (kSmallMaxC)
SMALL_THREADS = 256       # threads of a small-route block (kSmallThreads)
SMALL_BLOCKS = 132 * 2    # at most two blocks per H100 SM, one wave at C <= 10
TILE = 16       # output tile edge of the tiled route (kTile)
COLS = 64       # contraction columns staged per step (kCols)
TARGET_BLOCKS = 132 * 8  # about eight tiled blocks per H100 SM

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_SMALL_ARGS = (_P, _LL, _LL, _LL, _LL, _LL, _P, _P, _P)
_TILED_ARGS = (_P, _LL, _LL, _LL, _LL, _P, _P, _P)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def route(C: int) -> str:
    """The kernel a (C, D) stack takes: ``small`` or ``tiled``."""
    return "small" if C <= SMALL_MAX_C else "tiled"


def small_plan(D: int) -> Tuple[int, int, int]:
    """(nbody, per_block, nblocks) of the small route: columns [0, 4 nbody)
    go in groups of four, ``per_block`` groups to a block; the 4..7 columns
    past them (all of D below 8) go to the last block one by one."""
    nbody = (D - 4) // 4 if D >= 8 else 0
    if nbody == 0:
        return 0, 0, 1
    per_block = _cdiv(nbody, min(SMALL_BLOCKS, _cdiv(nbody, SMALL_THREADS)))
    return nbody, per_block, _cdiv(nbody, per_block)


def split_plan(C: int, D: int) -> Tuple[int, int]:
    """(span, splits) of the tiled route: the contraction is cut into
    ``splits`` column spans of ``span`` (a multiple of COLS) so that tiles x
    tiles x splits fills the card even when the (C, C) output has few
    tiles."""
    tiles = _cdiv(C, TILE)
    splits = min(max(1, _cdiv(TARGET_BLOCKS, tiles * tiles)), _cdiv(D, COLS), 65535)
    span = _cdiv(_cdiv(D, splits), COLS) * COLS
    return span, _cdiv(D, span)


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
    out = torch.empty((C, C), dtype=torch.float32, device=flat.device)
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    kind = route(C)
    if kind == "small":
        if flat.data_ptr() % 16:
            flat = flat.clone()  # the kernel's 16-byte loads start at the stack's first byte
        nbody, per_block, nblocks = small_plan(D)
        partial = torch.empty((C * (C + 1) // 2, nblocks), dtype=torch.float32,
                              device=flat.device)
        fn = _build.function("agg_robust", "fedml_gram_small", _SMALL_ARGS)
        err = fn(flat.data_ptr(), C, D, nbody, per_block, nblocks, partial.data_ptr(),
                 out.data_ptr(), stream)
    else:
        span, splits = split_plan(C, D)
        partial = torch.empty((splits, C, C) if splits > 1 else (0,), dtype=torch.float32,
                              device=flat.device)
        fn = _build.function("agg_robust", "fedml_gram", _TILED_ARGS)
        err = fn(flat.data_ptr(), C, D, span, splits, partial.data_ptr(), out.data_ptr(),
                 stream)
    _build.check(err, f"fedml_gram ({kind})")
    gram.launches += 1
    gram.route_launches[kind] += 1
    return out


gram.launches = 0
gram.route_launches = {"small": 0, "tiled": 0}
