"""Fused stochastic quantize + wire pack + decode (kernel 1 of the slice).

Port of ``fedml_tpu/ops/pallas/agg_quant.py::fused_quantize_pack``. On a
CUDA tensor :func:`quantize_pack` launches the hand-written kernel in
``csrc/agg_quant.cu`` (or raises); on a CPU tensor it runs
:func:`quantize_pack_plain`, the same arithmetic in plain PyTorch.

The contract is exactness: the packed bytes and scales equal the JAX
kernel's and the numpy wire path's (``codec.stochastic_quantize`` +
``pack_int4``) byte for byte, and the decoded stack equals the JAX
reference bit for bit. Pow2 scales make every step exact except the one
``floor(v / s + u)``, which is IEEE-rounded on both sides. Chunks whose
absmax is subnormal are outside the contract, as in the JAX module.

torch's uint32 arithmetic is limited, so the plain version hashes in int64
and masks to 32 bits after every multiply (an int64 product wraps mod 2^64,
which keeps the low 32 bits right) and before every right shift.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

QCHUNK = 256
_EB = {8: 6, 4: 2}
_BOUND = {8: 127, 4: 7}
_MIX_C1 = 0x7FEB352D
_MIX_C2 = 0x846CA68B
_KEY_SALT = 0x9E3779B9
_U32 = 0xFFFFFFFF


def _mix32_py(x: int) -> int:
    """lowbias32 finalizer on a Python int (``codec._mix32_py``)."""
    x &= _U32
    x ^= x >> 16
    x = (x * _MIX_C1) & _U32
    x ^= x >> 15
    x = (x * _MIX_C2) & _U32
    x ^= x >> 16
    return x


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on an int64 tensor holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * _MIX_C1) & _U32
    x = x ^ (x >> 15)
    x = (x * _MIX_C2) & _U32
    return x ^ (x >> 16)


def round_key(seed: int, round_idx: int) -> int:
    """The first two links of ``codec.stochastic_key``: salt the seed, mix
    in the round. Rows then mix in their client id and the leaf hash."""
    return _mix32_py(((int(seed) ^ _KEY_SALT) & _U32) ^ (int(round_idx) & _U32))


def _check(vals: torch.Tensor, cids: torch.Tensor, bits: int) -> Tuple[int, int]:
    if bits not in (8, 4):
        raise ValueError(f"bits={bits} (expected 8 or 4)")
    if vals.dtype != torch.float32 or vals.dim() != 2:
        raise ValueError(f"vals must be a 2-D float32 tensor, got {vals.dtype} {tuple(vals.shape)}")
    C, m = vals.shape
    if C < 1 or m < 1:
        raise ValueError(f"empty value stack {tuple(vals.shape)}")
    if cids.dtype != torch.int32 or tuple(cids.shape) != (C,):
        raise ValueError(f"cids must be an int32 tensor of shape ({C},)")
    if cids.device != vals.device:
        raise ValueError("vals and cids must be on the same device")
    return C, m


def quantize_pack_plain(vals: torch.Tensor, bits: int, seed: int, round_idx: int,
                        cids: torch.Tensor, leaf_hash: int = 0):
    """Plain PyTorch version of the kernel: ``(packed, scales, dec)`` —
    (C, m) int8 [q8] or (C, ceil(m/2)) uint8 [q4], (C, ceil(m/256)) f32,
    (C, m) f32 (``agg_quant.py:247 _reference_quantize_pack``)."""
    C, m = _check(vals, cids, bits)
    dev = vals.device
    mpad = -(-m // QCHUNK) * QCHUNK
    nc = mpad // QCHUNK
    key = _mix32(_mix32(round_key(seed, round_idx) ^ (cids.to(torch.int64) & _U32))
                 ^ (int(leaf_hash) & _U32))
    idx = torch.arange(mpad, dtype=torch.int64, device=dev)
    h = _mix32(idx[None, :] ^ key[:, None])
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    vp = torch.zeros((C, mpad), dtype=torch.float32, device=dev)
    vp[:, :m] = vals
    blk = vp.reshape(C, nc, QCHUNK)
    amax = blk.abs().amax(dim=-1)
    # 2^(frexp_exp(amax) - eb) from the exponent bits (_pow2_scale_bits)
    be = (amax.view(torch.int32) >> 23) & 0xFF
    ea = torch.where(be == 255, 0, torch.where(be == 0, -149, be - 126))
    e2 = ea - _EB[bits]
    s_norm = ((e2 + 127).clamp(min=0) << 23).to(torch.int32).view(torch.float32)
    s = torch.where(e2 >= -126, s_norm, 0.0)
    s = torch.where(amax > 0, s, 1.0)
    bound = float(_BOUND[bits])
    t = torch.floor(blk / s[..., None] + u.reshape(C, nc, QCHUNK))
    # XLA converts NaN to integer 0; clamp would keep it NaN
    q = torch.nan_to_num(t.clamp(-bound, bound), nan=0.0).to(torch.int8).reshape(C, mpad)
    dec = (q.to(torch.float32).reshape(C, nc, QCHUNK) * s[..., None]).reshape(C, mpad)[:, :m]
    if bits == 8:
        return q[:, :m], s, dec
    b = q.to(torch.int32) + 8
    packed = ((b[:, 0::2] << 4) | b[:, 1::2]).to(torch.uint8)
    return packed[:, : (m + 1) // 2], s, dec


def quantize_pack(vals: torch.Tensor, bits: int, seed: int, round_idx: int,
                  cids: torch.Tensor, leaf_hash: int = 0):
    """One-pass stochastic quantize + pack + decode of a (C, m) cohort
    stack; row ``i`` is keyed by client ``cids[i]``. CUDA tensors launch
    ``csrc/agg_quant.cu``; CPU tensors take :func:`quantize_pack_plain`."""
    if vals.device.type == "cpu":
        return quantize_pack_plain(vals, bits, seed, round_idx, cids, leaf_hash)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}")
    C, m = _check(vals, cids, bits)
    if not (vals.is_contiguous() and cids.is_contiguous()):
        raise ValueError("vals and cids must be contiguous")
    lib = _build.load("agg_quant")
    fn = lib.fedml_quantize_pack
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nc = -(-m // QCHUNK)
    if bits == 8:
        packed = torch.empty((C, m), dtype=torch.int8, device=vals.device)
    else:
        packed = torch.empty((C, (m + 1) // 2), dtype=torch.uint8, device=vals.device)
    scales = torch.empty((C, nc), dtype=torch.float32, device=vals.device)
    dec = torch.empty((C, m), dtype=torch.float32, device=vals.device)
    err = fn(vals.data_ptr(), cids.data_ptr(), C, m, bits, round_key(seed, round_idx),
             int(leaf_hash) & _U32, packed.data_ptr(), scales.data_ptr(), dec.data_ptr(),
             torch.cuda.current_stream(vals.device).cuda_stream)
    _build.check(err, "fedml_quantize_pack")
    quantize_pack.launches += 1
    return packed, scales, dec


quantize_pack.launches = 0
