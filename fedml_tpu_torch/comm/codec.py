"""Update codec, quantization stages (port of ``fedml_tpu/comm/codec.py``).

Two paths, as in the JAX package:

- the **numpy wire path** (:func:`stochastic_quantize`, :func:`pack_int4`):
  what a cross-silo client puts on the wire, one leaf of one client;
- the **simulator roundtrip** (:func:`build_stacked_roundtrip`): encode +
  decode of every client's update inside the round, per leaf over the
  stacked cohort, through the fused kernel ``ops.agg_quant.quantize_pack``.

Rounding noise comes from a counter hash keyed by (seed, round, client,
leaf, element); the leaf key is the CRC32 of the flax path
(``params/Conv_0/kernel``) and the 256-chunks run over the leaf flattened
in flax layout, so the port's streams are the JAX package's streams.
The ``topk`` stage (with its error-feedback residuals) is not ported yet.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import agg_quant
from ..ops.agg_quant import _mix32_py
from ..utils.convert import flatten_paths

_QCHUNK = 256
# leaves smaller than this ship raw (scales would dominate)
_MIN_LEAF = 64
_KEY_SALT = 0x9E3779B9
_U32 = 0xFFFFFFFF
_EB = {8: 6, 4: 2}


@dataclass(frozen=True)
class CodecSpec:
    """Parsed ``comm_codec`` spec: delta -> topk -> quant, each optional."""

    text: str
    delta: bool = False
    topk: Optional[float] = None
    bits: Optional[int] = None


def parse_codec_spec(spec: str) -> CodecSpec:
    """Parse and validate a spec string like ``delta|topk:0.01|q8``
    (codec.py:99): unknown, duplicate or out-of-order stages raise."""
    text = str(spec).strip()
    if not text:
        raise ValueError("empty codec spec")
    delta = False
    topk: Optional[float] = None
    bits: Optional[int] = None
    last_pos = -1
    for stage in text.split("|"):
        stage = stage.strip()
        if stage == "delta":
            pos = 0
            if delta:
                raise ValueError(f"duplicate stage 'delta' in codec spec {text!r}")
            delta = True
        elif stage.startswith("topk:"):
            pos = 1
            if topk is not None:
                raise ValueError(f"duplicate stage 'topk' in codec spec {text!r}")
            try:
                topk = float(stage.split(":", 1)[1])
            except (IndexError, ValueError):
                raise ValueError(f"bad top-k fraction in codec spec {text!r}")
            if not (0.0 < topk <= 1.0):
                raise ValueError(
                    f"top-k fraction must be in (0, 1], got {topk} in {text!r}")
        elif stage in ("q8", "q4"):
            pos = 2
            if bits is not None:
                raise ValueError(f"duplicate quant stage in codec spec {text!r}")
            bits = 8 if stage == "q8" else 4
        else:
            raise ValueError(
                f"unknown codec stage {stage!r} in spec {text!r} "
                "(expected delta, topk:<frac>, q8, or q4)")
        if pos < last_pos:
            raise ValueError(
                f"codec stages out of order in {text!r}: "
                "canonical order is delta|topk:<frac>|q8")
        last_pos = pos
    return CodecSpec(text=text, delta=delta, topk=topk, bits=bits)


# --------------------------------------------------------------------------
# counter-based RNG (shared constants with ops/agg_quant.py)
# --------------------------------------------------------------------------

def _mix32_arr(x: np.ndarray) -> np.ndarray:
    """lowbias32 on a uint32 numpy array (silent wraparound)."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x7FEB352D)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _leaf_hash(path: str) -> int:
    return zlib.crc32(path.encode("utf-8")) & _U32


def stochastic_key(seed: int, round_idx: int, client_id: int, leaf_hash: int = 0) -> int:
    """Per-(seed, round, client, leaf) base key for stochastic rounding."""
    h = (int(seed) ^ _KEY_SALT) & _U32
    for t in (round_idx, client_id, leaf_hash):
        h = _mix32_py(h ^ (int(t) & _U32))
    return h


def _pow2_scales(amax: np.ndarray, eb: int) -> np.ndarray:
    _, ea = np.frexp(amax)
    s = np.ldexp(np.float32(1.0), ea - eb)
    return np.where(amax > 0, s, np.float32(1.0)).astype(np.float32)


def stochastic_quantize(vals: np.ndarray, bits: int, seed: int, round_idx: int,
                        client_id: int, leaf_hash: int = 0,
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Numpy wire path: one client's leaf -> (q int8, scales f32, decoded
    f32), per-256 pow2 scales (codec.py:295)."""
    bound = np.float32({8: 127, 4: 7}[bits])
    vals = np.ascontiguousarray(vals, np.float32).ravel()
    m = vals.size
    mpad = -(-m // _QCHUNK) * _QCHUNK
    nc = mpad // _QCHUNK
    base = np.uint32(stochastic_key(seed, round_idx, client_id, leaf_hash))
    h = _mix32_arr(np.arange(mpad, dtype=np.uint32) ^ base)
    u = (h >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))
    vp = np.zeros(mpad, np.float32)
    vp[:m] = vals
    blk = vp.reshape(nc, _QCHUNK)
    s = _pow2_scales(np.abs(blk).max(axis=1), _EB[bits])
    q = np.clip(np.floor(blk / s[:, None] + u.reshape(nc, _QCHUNK)),
                -bound, bound).astype(np.int8)
    dec = (q.astype(np.float32) * s[:, None]).reshape(-1)[:m]
    return q.reshape(-1)[:m], s, dec


def pack_int4(q: np.ndarray) -> np.ndarray:
    """Pack int8 levels in [-7, 7] two per byte (bias +8, first element in
    the high nibble); an odd length pads with the zero level."""
    b = (np.ascontiguousarray(q, np.int8).astype(np.int16) + 8).astype(np.uint8)
    if b.size % 2:
        b = np.concatenate([b, np.uint8([8])])
    return ((b[0::2] << 4) | b[1::2]).astype(np.uint8)


# --------------------------------------------------------------------------
# stacked roundtrip (simulator path)
# --------------------------------------------------------------------------

def _flatten_with_paths(tree) -> Tuple[List[str], List[Any]]:
    """("/"-joined paths, leaves) of a path-keyed dict or a nested dict, in
    ``jax.tree_util`` leaf order — the keys the leaf hashes come from."""
    flat = flatten_paths(tree)
    return list(flat), list(flat.values())


def build_stacked_roundtrip(spec, seed: int):
    """The simulator-side codec: ``fn(update, cids, round_idx) -> decoded``
    applies encode+decode per client along the leading cohort axis of every
    leaf (codec.py:591). ``cids`` is the (C,) int32 client-id tensor that
    keys each row's stream. Leaves below 64 elements pass through; delta
    is a passthrough, as on the JAX side (updates already are deltas). The
    quant stage always runs ``ops.agg_quant.quantize_pack`` — the CUDA
    kernel on the card — whose output is bit-identical to the unfused
    arithmetic, so the JAX ``agg_kernels`` switch has no numeric effect
    here."""
    cs = spec if isinstance(spec, CodecSpec) else parse_codec_spec(spec)
    if cs.topk is not None:
        raise NotImplementedError(
            "the topk codec stage (error-feedback residuals in a client-state "
            "arena) is not ported yet (ROADMAP.md Queue 1, item 6)")

    def roundtrip(update: Dict[str, torch.Tensor], cids: torch.Tensor, round_idx: int):
        paths, leaves = _flatten_with_paths(update)
        out = {}
        for path, leaf in zip(paths, leaves):
            C = leaf.shape[0]
            n = leaf[0].numel()
            if cs.bits is None or n < _MIN_LEAF or not leaf.is_floating_point():
                out[path] = leaf
                continue
            x = leaf.float().reshape(C, n).contiguous()
            _, _, dec = agg_quant.quantize_pack(x, cs.bits, seed, round_idx, cids,
                                                _leaf_hash(path))
            out[path] = dec.reshape(leaf.shape).to(leaf.dtype)
        return out

    return roundtrip
