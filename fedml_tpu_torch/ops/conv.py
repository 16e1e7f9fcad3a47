"""Multi-weight 2D convolution (port of ``fedml_tpu/ops/conv.py``).

The simulator runs ``torch.func.vmap`` of the local update over the cohort,
so every conv of a client sees that client's own weights. Left to
``F.conv2d``, vmap lowers such a call to a grouped convolution. The JAX
package met the same problem on the TPU and wrote ``conv2d_pallas``; here
the same op is hand-written CUDA: the forward (also dx) on the tensor cores
in three TF32 products for ResNet's block convs (Ci = Co in {16, 32, 64},
``csrc/conv3x3_sm90.cu``), else on the CUDA cores (``csrc/conv3x3.cu``),
except the stem (3 -> 16), which has tensor-core kernels of its own in
``csrc/conv3x3_sm90.cu``, in bfloat16 and in float32; :func:`fwd_route`
picks by channels and dtype. The weight gradient runs on
the CUDA cores of ``csrc/conv3x3.cu``, except bfloat16 at those block
widths, which runs on the tensor cores of ``csrc/conv3x3_sm90.cu``
(:func:`dw_route`). Each kernel takes float32 or bfloat16 operands (the
JAX package's ``use_bf16``): bfloat16 products are summed in float32 and
the result rounded once to bfloat16, one ``mma.sync`` bf16 product on the
tensor cores in place of three TF32 ones:

- :func:`conv3x3` — the differentiable 3x3 / stride-1 / SAME conv, NHWC
  activations with HWIO weights, the counterpart of ``conv2d_pallas``. It
  is a ``torch.autograd.Function`` with a ``vmap`` rule, so it runs under
  ``vmap(grad(...))``: the rule folds the vmapped axis into the kernels'
  leading lane axis, with one weight set per lane. Its gradient is dx =
  :func:`conv3x3` of dy with the spatially flipped, channel-transposed
  kernel, and dw from the weight-gradient kernel. Under more than one vmap
  level (DP-SGD's per-example gradients inside the cohort ``vmap``) the
  rule re-enters through a lane-level ``autograd.Function`` whose own vmap
  rule folds each outer axis into the lane axis too (L = L_outer ·
  L_inner), so the kernel still sees one plain lane-stacked tensor.
- :func:`conv3x3_lanes` / :func:`conv3x3_dw_lanes` — the kernel wrappers on
  lane-stacked tensors, each with a ``.launches`` counter. On a CUDA tensor
  they launch the kernel (or raise); on a CPU tensor they run the plain
  versions :func:`conv3x3_plain` / :func:`conv3x3_dw_plain`.
- :func:`conv2d_im2col` — conv as patches @ weights (1x1 convs, the stride-2
  3x3 convs and ``impl="im2col"``); its product is ``torch.matmul``, as the
  JAX package leaves it to XLA outside any Pallas kernel.
- :class:`Conv` — the ``nn.Module`` counterpart of the JAX ``Conv``, with the
  same ``kernel`` leaf and the same dispatch by ``impl`` and shape.

The contract is a tolerance, not bits: the kernels sum in another order
than the plain versions (in bfloat16, at most one bfloat16 step apart
after the rounding). Every kernel repeats bit for bit (no atomics; the
weight gradient reduces its partial sums in a fixed order).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from . import _build

# --- im2col ------------------------------------------------------------------


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-size // s)  # ceil
    pad = max(0, (out - 1) * s + k - size)
    return pad // 2, pad - pad // 2


def extract_patches(x: torch.Tensor, kh: int, kw: int, stride: int,
                    padding: str) -> torch.Tensor:
    """[B, H, W, C] -> [B, Ho, Wo, kh*kw*C] by strided slices and a concat,
    feature order (dy, dx, ci), which matches ``w.reshape(kh*kw*ci, co)``
    for ``w`` of shape [kh, kw, ci, co]."""
    b, h, w, c = x.shape
    if padding == "SAME":
        (pt, pb), (pl, pr) = _same_pads(h, kh, stride), _same_pads(w, kw, stride)
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        h, w = h + pt + pb, w + pl + pr
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    ho, wo = (h - kh) // stride + 1, (w - kw) // stride + 1
    taps = [x[:, dy:dy + (ho - 1) * stride + 1:stride, dx:dx + (wo - 1) * stride + 1:stride, :]
            for dy in range(kh) for dx in range(kw)]
    return torch.cat(taps, dim=-1)


def conv2d_im2col(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                  padding: str = "SAME") -> torch.Tensor:
    """Conv as patches @ weight matrix: [B, H, W, Ci] x [kh, kw, Ci, Co]."""
    kh, kw, ci, co = w.shape
    if kh == kw == 1:
        if stride > 1:
            x = x[:, ::stride, ::stride, :]
        return torch.matmul(x, w[0, 0])
    p = extract_patches(x, kh, kw, stride, padding)
    return torch.matmul(p, w.reshape(kh * kw * ci, co))


# --- the plain versions of the two kernels ----------------------------------


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: per lane, 3x3 SAME
    patches of x (L, B, H, W, Ci) @ w (L, 3, 3, Ci, Co) viewed as
    (9 Ci, Co) -> (L, B, H, W, Co). bfloat16 operands are multiplied and
    summed in float32 and the result rounded once to bfloat16, the TPU
    kernel's ``preferred_element_type=float32`` contract."""
    L, B, H, W, Ci = x.shape
    p = extract_patches(x.float().reshape(L * B, H, W, Ci), 3, 3, 1, "SAME")
    y = torch.matmul(p.reshape(L, B * H * W, 9 * Ci),
                     w.float().reshape(L, 9 * Ci, w.shape[-1]))
    return y.reshape(L, B, H, W, -1).to(x.dtype)


def conv3x3_dw_plain(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the weight-gradient kernel: per lane,
    patches(x)^T @ dy summed over (B, H, W) -> (L, 3, 3, Ci, Co); bfloat16
    operands summed in float32 and rounded once to bfloat16 (the TPU
    kernel's float32 grid accumulation, then ``.astype(w.dtype)``)."""
    L, B, H, W, Ci = x.shape
    Co = dy.shape[-1]
    p = extract_patches(x.float().reshape(L * B, H, W, Ci), 3, 3, 1, "SAME")
    dw = torch.matmul(p.reshape(L, B * H * W, 9 * Ci).transpose(1, 2),
                      dy.float().reshape(L, B * H * W, Co))
    return dw.reshape(L, 3, 3, Ci, Co).to(x.dtype)


# --- the kernel wrappers ------------------------------------------------------

SLICE = 16                # the forward's contraction elements per step (csrc kSlice)
GROUP_PIXELS = 16         # pixels of a dw slice one thread group sums (kGroupPixels)
TARGET_BLOCKS = 132 * 2   # dw blocks: two per H100 SM, one wave
DW_SLOTS = 128            # pixel slots of a tensor-core dw tile (csrc kDwSlots)
# (16-row tiles per warp, warps) of the tensor-core dw block by Ci (csrc
# fedml_conv3x3_dw_sm90_bf16's dispatch)
DW_TC_WARPS = {16: (3, 3), 32: (3, 6), 64: (2, 6)}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_cols(co: int) -> int:
    """Output channels of one block's tile (csrc ``block_cols``)."""
    return 16 if co <= 16 else 32 if co <= 32 else 64


def dw_tile(ci: int, co: int, route: str = "fma") -> Tuple[int, int, int, int]:
    """(rows, columns, threads, slice pixels) of the weight-gradient block
    of ``route``. FMA routes (csrc ``dw_rows``, ``block_cols``,
    ``dw_groups`` and ``kGroupPixels``): rows sized to the contraction K =
    9 Ci — all of K <= 32 (the stem's 27), 144 where they divide K, else 64
    — and groups of ``rows`` threads, 256 or 288 in all, each summing 16
    pixels of a slice. "bf16_tc" (csrc ``DwCfg``): warps of 16-row mma tiles
    over all Co columns, a slice one pixel tile of up to DW_SLOTS slots."""
    if route == "bf16_tc":
        mt, nw = DW_TC_WARPS[ci]
        return 16 * mt * nw, co, 32 * nw, DW_SLOTS
    k = 9 * ci
    rows = 32 if k <= 32 else 144 if k % 144 == 0 else 64
    groups = 2 if rows == 144 else 256 // rows
    return rows, block_cols(co), groups * rows, groups * GROUP_PIXELS


def dw_tc_geometry(B: int, H: int, W: int) -> Tuple[int, int, int]:
    """(rows, columns, tiles) of the tensor-core dw's pixel tiles (csrc
    ``dw_geometry``): whole image rows, as many as DW_SLOTS slots hold, or
    DW_SLOTS columns of a wider row; tiles never cross an image."""
    cb = min(W, DW_SLOTS)
    rb = 1 if cb < W else min(H, DW_SLOTS // W)
    return rb, cb, B * _cdiv(H, rb) * _cdiv(W, cb)


def dw_split_plan(L: int, P: int, ci: int, co: int, route: str = "fma") -> Tuple[int, int]:
    """(span, splits): each lane's contraction of P units — pixels on the
    FMA routes, pixel tiles (:func:`dw_tc_geometry`) on "bf16_tc" — is cut
    into ``splits`` spans of ``span`` (on the FMA routes a multiple of the
    block's slice) so that lanes x tiles x splits is at most
    TARGET_BLOCKS, one wave of blocks."""
    rows, cols, _, sl = dw_tile(ci, co, route)
    if route == "bf16_tc":
        sl = 1
    tiles = _cdiv(9 * ci, rows) * _cdiv(co, cols)
    splits = min(max(1, TARGET_BLOCKS // (tiles * L)), _cdiv(P, sl), 65535)
    span = _cdiv(_cdiv(P, splits), sl) * sl
    return span, _cdiv(P, span)


DTYPES = (torch.float32, torch.bfloat16)


def _lane_stride(t: torch.Tensor, name: str) -> int:
    """Elements between lanes of a (L, ...) tensor: 0 where one lane is
    broadcast (an ``expand``), else the per-lane size. Raises on layouts
    the kernels do not take."""
    if t.dtype not in DTYPES:
        raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.shape[0] > 1 and t.stride(0) == 0 and t[0].is_contiguous():
        return 0
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous or a lane broadcast")
    return t[0].numel() if t.shape[0] > 1 else 0


def _check_lanes(x: torch.Tensor, other: torch.Tensor, x_name: str, o_name: str,
                 align_other: bool = False) -> None:
    if x.dim() != 5 or other.dim() != 5 or x.shape[0] != other.shape[0] or x.shape[0] < 1:
        raise ValueError(f"{x_name} and {o_name} must be 5-D with the same lane count, got "
                         f"{tuple(x.shape)} and {tuple(other.shape)}")
    if x.device != other.device:
        raise ValueError(f"{x_name} and {o_name} lie on {x.device} and {other.device}")
    if x.dtype != other.dtype or x.dtype not in DTYPES:
        raise ValueError(f"{x_name} and {o_name} must both be float32 or both bfloat16, got "
                         f"{x.dtype} and {other.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    # the kernels read such x (and the weight gradient such dy) with 16-byte loads
    read16 = [(x, x_name), (other, o_name)] if align_other else [(x, x_name)]
    for t, name in read16:
        if t.device.type == "cuda" and t.shape[-1] % SLICE == 0 and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


# (kernel library, C entry point) of each forward route; all take the same
# arguments, pointers to the route's element type
FWD_ROUTES = {"tf32x3": ("conv3x3_sm90", "fedml_conv3x3_fwd_sm90"),
              "fma": ("conv3x3", "fedml_conv3x3_fwd"),
              "bf16_tc": ("conv3x3_sm90", "fedml_conv3x3_fwd_sm90_bf16"),
              "stem_bf16": ("conv3x3_sm90", "fedml_conv3x3_stem_sm90_bf16"),
              "stem_tf32x3": ("conv3x3_sm90", "fedml_conv3x3_stem_sm90"),
              "fma_bf16": ("conv3x3", "fedml_conv3x3_fwd_bf16")}
ROUTE_DTYPE = {"tf32x3": torch.float32, "fma": torch.float32, "bf16_tc": torch.bfloat16,
               "stem_bf16": torch.bfloat16, "stem_tf32x3": torch.float32,
               "fma_bf16": torch.bfloat16}
# the stem's routes by dtype (tensor-core kernels of conv3x3_sm90.cu)
STEM_ROUTES = {torch.bfloat16: "stem_bf16", torch.float32: "stem_tf32x3"}
TC_CHANNELS = (16, 32, 64)  # csrc conv3x3_sm90.cu tc_channels
STEM_CHANNELS = (3, 16)     # csrc kStemCI, kStemCO
# (kernel library, C entry point) of each weight-gradient route; all take the
# same arguments (the contraction's span in the route's units, dw_split_plan)
DW_ROUTES = {"fma": ("conv3x3", "fedml_conv3x3_dw"),
             "bf16_tc": ("conv3x3_sm90", "fedml_conv3x3_dw_sm90_bf16"),
             "fma_bf16": ("conv3x3", "fedml_conv3x3_dw_bf16")}
_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2 + \
    [ctypes.c_void_p]
_DW_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2 + \
    [ctypes.c_int, ctypes.c_void_p]


def fwd_route(ci: int, co: int, dtype: torch.dtype = torch.float32) -> str:
    """The forward kernel for Ci -> Co channels of ``dtype``. Where Ci = Co
    in {16, 32, 64}, ResNet's block convs and their dx, the tensor cores
    of ``conv3x3_sm90.cu``: "tf32x3" (float32, three TF32 products) or
    "bf16_tc" (bfloat16, one product, float32 sums); the stem (3 -> 16)
    its own tensor-core kernels there, "stem_bf16" (the 27-deep contraction
    padded to two 16-deep products) and "stem_tf32x3" (padded to four
    8-deep k-steps of three TF32 products each), at every lane count and
    batch; else the CUDA cores of ``conv3x3.cu``: "fma" (float32) or
    "fma_bf16" (bfloat16), the ragged channels."""
    if ci == co and ci in TC_CHANNELS:
        return "bf16_tc" if dtype == torch.bfloat16 else "tf32x3"
    if (ci, co) == STEM_CHANNELS:
        return STEM_ROUTES[dtype]
    return "fma_bf16" if dtype == torch.bfloat16 else "fma"


# The bf16 tensor-core forwards' tiles by Ci (csrc CfgBf16 at 16 and 32,
# CfgCut at 64): (pixel slots of a tile, elements between halo pixels,
# elements of w a block stages, column slices of a lane). At Ci 64 a block
# takes 32 of the 64 output columns and tiles of 64 slots.
FWD_TC_TILES = {16: (128, 16, 9 * 16 * 16, 1), 32: (128, 48, 9 * 32 * 48, 1),
                64: (64, 72, 9 * 64 * 40, 2)}
# the stem's (csrc kStemBM, kStemHalo, kStemSmem, kStemSmemF32): tile
# slots, halo pixels at most, shared-memory bytes by dtype (two halos of 8-
# or 16-byte pixels, w as 32 x 16)
STEM_SLOTS, STEM_HALO = 128, 256
STEM_SMEM = {torch.bfloat16: 2 * STEM_HALO * 8 + 32 * 16 * 2,
             torch.float32: 2 * STEM_HALO * 16 + 32 * 16 * 4}
MAX_SMEM = 232448  # bytes of shared memory a block may use (csrc kMaxSmem)


def fwd_tc_geometry(B: int, H: int, W: int, ci: int, co: int,
                    dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int, int, int, int]:
    """(images, rows, columns, tiles, shared-memory bytes) of a tile of the
    bf16 tensor-core forward at Ci -> Co (csrc ``geometry`` on
    ``FWD_TC_TILES``), or of the stem in ``dtype`` (``stem_geometry``):
    whole rows of as many images as the slots hold, or the slots' worth of
    columns of one row; fewer images, rows or columns where the shared
    memory (the stem: its halo's pixels) would overflow."""
    stem = (ci, co) == STEM_CHANNELS
    bm, xs, wel, _ = (STEM_SLOTS, 0, 0, 1) if stem else FWD_TC_TILES[ci]
    cb = min(W, bm)
    rb = 1 if cb < W else min(H, bm // W)
    imgs = 1 if rb < H else max(1, min(B, bm // (H * W)))

    def over():
        px = imgs * (rb + 2) * (cb + 2)
        return px > STEM_HALO if stem else 2 * (2 * px * xs + wel) > MAX_SMEM

    while over() and imgs > 1:
        imgs -= 1
    while over() and rb > 1:
        rb -= 1
    while over() and cb > 1:
        cb = (cb + 1) // 2
    tiles = _cdiv(B, imgs) * _cdiv(H, rb) * _cdiv(W, cb)
    nbytes = STEM_SMEM[dtype] if stem else 2 * (2 * imgs * (rb + 2) * (cb + 2) * xs + wel)
    return imgs, rb, cb, tiles, nbytes


def fwd_tc_plan(L: int, B: int, H: int, W: int, ci: int, co: int, sms: int,
                per_sm: int, dtype: torch.dtype = torch.bfloat16) -> Tuple[int, int, int]:
    """(blocks, tiles a block walks at most, shared-memory bytes) of the
    bf16 tensor-core forward (or the stem in ``dtype``) on a card of
    ``sms`` SMs holding ``per_sm`` blocks each (csrc ``plan_blocks``, which
    asks the card for both): each unit (a lane, or one column slice of a
    lane) gets its share of the SM slots, then as few blocks as give every
    block the same tile count; a unit's block j takes tiles j, j + blocks,
    ... ."""
    tiles, nbytes = fwd_tc_geometry(B, H, W, ci, co, dtype)[3:]
    units = L * (1 if (ci, co) == STEM_CHANNELS else FWD_TC_TILES[ci][3])
    slots = _cdiv(sms * per_sm, units)
    rounds = _cdiv(tiles, slots)
    return _cdiv(tiles, rounds) * units, rounds, nbytes


def fwd_tc_plan_on_card(L: int, B: int, H: int, W: int, ci: int, co: int,
                        device: Optional[torch.device] = None,
                        dtype: torch.dtype = torch.bfloat16) -> Tuple[int, ...]:
    """(blocks, tiles a block, shared-memory bytes, SMs, blocks an SM
    holds) of the plan the kernel launches on the current card (csrc
    ``fedml_conv3x3_fwd_sm90_bf16_plan``; the float32 stem's
    ``fedml_conv3x3_stem_sm90_plan``): what :func:`fwd_tc_plan` mirrors,
    read back for a check on the card."""
    out = (ctypes.c_int * 5)()
    entry = "fedml_conv3x3_stem_sm90_plan" if dtype == torch.float32 else \
        "fedml_conv3x3_fwd_sm90_bf16_plan"
    fn = _build.function("conv3x3_sm90", entry, [ctypes.c_int] * 6 + [ctypes.c_void_p])
    with torch.cuda.device(device):
        _build.check(fn(L, B, H, W, ci, co, ctypes.addressof(out)), entry)
    return tuple(out)


def dw_route(ci: int, co: int, dtype: torch.dtype = torch.float32) -> str:
    """The weight-gradient kernel for Ci -> Co channels of ``dtype``: bf16
    with Ci = Co in {16, 32, 64} (ResNet's block convs) on the tensor cores
    of ``conv3x3_sm90.cu`` ("bf16_tc", one bf16 mma.sync product per 16
    pixels, float32 sums); other bf16 convs (the stem's 3 -> 16, ragged
    channels) on the CUDA cores of ``conv3x3.cu`` ("fma_bf16"); float32
    there too ("fma")."""
    if dtype == torch.bfloat16:
        return "bf16_tc" if ci == co and ci in TC_CHANNELS else "fma_bf16"
    return "fma"


def conv3x3_fwd_route(x: torch.Tensor, w: torch.Tensor, route: str) -> torch.Tensor:
    """The forward kernel named by ``route`` on CUDA lane-stacked x, w (as
    :func:`conv3x3_lanes` takes them); counts no launch. :func:`conv3x3_lanes`
    calls it with :func:`fwd_route`; a benchmark may name another route of
    the same dtype where it takes the shape."""
    L, B, H, W, Ci = x.shape
    x_lane, w_lane = _lane_stride(x, "x"), _lane_stride(w, "w")
    Co = w.shape[-1]
    if ROUTE_DTYPE[route] != x.dtype:
        raise ValueError(f"route {route} takes {ROUTE_DTYPE[route]}, not {x.dtype}")
    if route in ("tf32x3", "bf16_tc") and (w.data_ptr() % 16 or
                                           fwd_route(Ci, Co, x.dtype) != route):
        raise ValueError(f"the {route} kernel takes Ci = Co in {TC_CHANNELS} and a 16-byte "
                         f"aligned w, got {Ci} -> {Co}")
    if route in STEM_ROUTES.values() and (Ci, Co) != STEM_CHANNELS:
        raise ValueError(f"the {route} kernel takes {STEM_CHANNELS[0]} -> {STEM_CHANNELS[1]} "
                         f"channels, got {Ci} -> {Co}")
    lib, entry = FWD_ROUTES[route]
    y = torch.empty((L, B, H, W, Co), dtype=x.dtype, device=x.device)
    fn = _build.function(lib, entry, _FWD_ARGS)
    err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), L, B, H, W, Ci, Co, x_lane, w_lane,
             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, entry)
    return y


def conv3x3_lanes(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Forward kernel: x (L, B, H, W, Ci), w (L, 3, 3, Ci, Co), both float32
    or both bfloat16 -> (L, B, H, W, Co) of their dtype, on the kernel
    :func:`fwd_route` names. Either operand may be one lane broadcast over
    L. ``.launches`` counts every launch, ``.route_launches`` each route's."""
    _check_lanes(x, w, "x", "w")
    L, B, H, W, Ci = x.shape
    if tuple(w.shape[1:4]) != (3, 3, Ci):
        raise ValueError(f"w must be (L, 3, 3, {Ci}, Co), got {tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    route = fwd_route(Ci, w.shape[-1], x.dtype)
    y = conv3x3_fwd_route(x, w, route)
    conv3x3_lanes.launches += 1
    conv3x3_lanes.route_launches[route] += 1
    return y


conv3x3_lanes.launches = 0
conv3x3_lanes.route_launches = dict.fromkeys(FWD_ROUTES, 0)


def conv3x3_dw_route(x: torch.Tensor, dy: torch.Tensor, route: str) -> torch.Tensor:
    """The weight-gradient kernel named by ``route`` on CUDA lane-stacked
    x, dy (as :func:`conv3x3_dw_lanes` takes them); counts no launch.
    :func:`conv3x3_dw_lanes` calls it with :func:`dw_route`; a benchmark may
    name another route of the same dtype where it takes the shape."""
    L, B, H, W, Ci = x.shape
    Co = dy.shape[-1]
    if ROUTE_DTYPE[route] != x.dtype:
        raise ValueError(f"route {route} takes {ROUTE_DTYPE[route]}, not {x.dtype}")
    x_lane = _lane_stride(x, "x")
    if _lane_stride(dy, "dy") == 0 and L > 1:
        dy = dy.contiguous()
    if route == "bf16_tc":
        if dw_route(Ci, Co, x.dtype) != route:
            raise ValueError(f"the {route} kernel takes Ci = Co in {TC_CHANNELS}, got "
                             f"{Ci} -> {Co}")
        span, splits = dw_split_plan(L, dw_tc_geometry(B, H, W)[2], Ci, Co, route)
    else:
        span, splits = dw_split_plan(L, B * H * W, Ci, Co, route)
    part = torch.empty((L, splits, 9 * Ci, Co), dtype=torch.float32, device=x.device)
    dw = torch.empty((L, 3, 3, Ci, Co), dtype=x.dtype, device=x.device)
    lib, entry = DW_ROUTES[route]
    fn = _build.function(lib, entry, _DW_ARGS)
    err = fn(x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(), L, B, H, W, Ci, Co,
             x_lane, span, splits, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, entry)
    return dw


def conv3x3_dw_lanes(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight-gradient kernel: x (L, B, H, W, Ci), dy (L, B, H, W, Co),
    both float32 or both bfloat16 -> dw (L, 3, 3, Ci, Co) of their dtype,
    summed in float32 (and rounded once to bfloat16) on the kernel
    :func:`dw_route` names. x may be one lane broadcast over L.
    ``.launches`` counts every launch, ``.route_launches`` each route's."""
    _check_lanes(x, dy, "x", "dy", align_other=True)
    L, B, H, W, Ci = x.shape
    if tuple(dy.shape[1:4]) != (B, H, W):
        raise ValueError(f"dy must be (L, {B}, {H}, {W}, Co), got {tuple(dy.shape)}")
    if x.device.type == "cpu":
        return conv3x3_dw_plain(x, dy)
    route = dw_route(Ci, dy.shape[-1], x.dtype)
    dw = conv3x3_dw_route(x, dy, route)
    conv3x3_dw_lanes.launches += 1
    conv3x3_dw_lanes.route_launches[route] += 1
    return dw


conv3x3_dw_lanes.launches = 0
conv3x3_dw_lanes.route_launches = dict.fromkeys(DW_ROUTES, 0)


# --- the differentiable, vmappable op ----------------------------------------


def _fold(batch_size: int, in_dims, *ts):
    """The vmap rules' view of their operands: the vmapped axis moved to the
    front as the kernels' lane axis; an operand that is not vmapped becomes
    one lane broadcast over the batch."""
    out = []
    for t, d in zip(ts, in_dims):
        if d is None:
            t = t.contiguous().expand(batch_size, *t.shape)
        else:
            t = t.movedim(d, 0).contiguous()
        out.append(t)
    return out


def _flip(w: torch.Tensor) -> torch.Tensor:
    """The kernel whose conv of dy is dx: spatially flipped, channels
    transposed (conv.py:232)."""
    return w.flip(0, 1).transpose(2, 3)


def _fold_lanes(batch_size: int, in_dims, *ts):
    """The lane-level vmap rules' view of their (L, ...) operands: an outer
    vmapped axis folded into the lane axis, (L_outer, L, ...) -> (L_outer L,
    ...); an operand that is not vmapped is broadcast first. A lane
    broadcast stays a broadcast where the layout allows, else is copied
    contiguous."""
    out = []
    for t, d in zip(ts, in_dims):
        t = t.expand(batch_size, *t.shape) if d is None else t.movedim(d, 0)
        t = t.reshape(batch_size * t.shape[1], *t.shape[2:])
        if not (t.shape[0] > 1 and t.stride(0) == 0 and t[0].is_contiguous()):
            t = t.contiguous()
        out.append(t)
    return out


class _LaneOp(torch.autograd.Function):
    """A kernel wrapper on lane-stacked operands as a function that vmap can
    see: under a further vmap level its rule folds that level into the lane
    axis and re-enters, so any nesting ends in one kernel launch. Its
    gradient is taken a level above, by :class:`_Conv3x3`."""

    kernel = None

    @classmethod
    def forward(cls, a, b):
        return cls.kernel(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("the lane-level conv ops are differentiated through conv3x3")

    @classmethod
    def vmap(cls, info, in_dims, a, b):
        y = cls.apply(*_fold_lanes(info.batch_size, in_dims, a, b))
        return y.reshape(info.batch_size, y.shape[0] // info.batch_size, *y.shape[1:]), 0


class _Conv3x3Lanes(_LaneOp):
    kernel = staticmethod(conv3x3_lanes)


class _Conv3x3DwLanes(_LaneOp):
    kernel = staticmethod(conv3x3_dw_lanes)


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(x, w):
        return conv3x3_lanes(x.contiguous()[None], w.contiguous()[None])[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = _Conv3x3.apply(g, _flip(w)) if ctx.needs_input_grad[0] else None
        dw = _Conv3x3Dw.apply(x, g) if ctx.needs_input_grad[1] else None
        return dx, dw

    @staticmethod
    def vmap(info, in_dims, x, w):
        return _Conv3x3Lanes.apply(*_fold(info.batch_size, in_dims, x, w)), 0


class _Conv3x3Dw(torch.autograd.Function):
    @staticmethod
    def forward(x, g):
        return conv3x3_dw_lanes(x.contiguous()[None], g.contiguous()[None])[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, gw):
        raise NotImplementedError("conv3x3 has no second derivative")

    @staticmethod
    def vmap(info, in_dims, x, g):
        return _Conv3x3DwLanes.apply(*_fold(info.batch_size, in_dims, x, g)), 0


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-1 / SAME conv of x (B, H, W, Ci) with w (3, 3, Ci, Co)
    -> (B, H, W, Co); differentiable and vmappable (see module docstring)."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f"conv3x3 takes x (B, H, W, Ci) and w (3, 3, Ci, Co), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    return _Conv3x3.apply(x, w)


# --- module -------------------------------------------------------------------

IMPLS = ("xla", "im2col", "pallas")


def _supported(x_shape, w_shape, stride: int, padding: str) -> bool:
    return (padding == "SAME" and stride == 1 and tuple(w_shape[:2]) == (3, 3)
            and len(x_shape) == 4)


def _conv_cudnn(x: torch.Tensor, w: torch.Tensor, s: int, padding: str) -> torch.Tensor:
    """``lax.conv_general_dilated`` on NHWC/HWIO: ``F.conv2d`` (cuDNN on the
    card) with the SAME pads computed as XLA does, asymmetric at stride 2."""
    kh, kw = w.shape[:2]
    x = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        (pt, pb), (pl, pr) = _same_pads(x.shape[2], kh, s), _same_pads(x.shape[3], kw, s)
        x = F.pad(x, (pl, pr, pt, pb))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    return F.conv2d(x, w.permute(3, 2, 0, 1), stride=s).permute(0, 2, 3, 1)


class Conv(nn.Module):
    """The JAX ``Conv`` module (no bias, NHWC, no dilation) with a
    selectable compute path; its one leaf is ``kernel`` (kh, kw, ci, co).
    With ``dtype`` set (``use_bf16``: bfloat16) the input and the float32
    kernel are cast to it first, as the JAX module's ``dtype`` does.

    impl:
      - "xla":    ``F.conv2d`` (cuDNN), the counterpart of
                  ``lax.conv_general_dilated``; a grouped conv under
                  per-lane weight vmap
      - "im2col": patches + matmul
      - "pallas": the CUDA kernels (:func:`conv3x3`) for 3x3/s1/SAME; other
                  shapes take im2col
    1x1 convs always take the matmul path.
    """

    def __init__(self, features_in: int, features: int,
                 kernel_size: Sequence[int] = (3, 3),
                 strides: Union[int, Sequence[int]] = 1, padding: str = "SAME",
                 impl: str = "xla", dtype: Optional[torch.dtype] = None):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        if not isinstance(strides, int):
            if len(set(strides)) != 1:
                raise ValueError(f"Conv supports only isotropic strides, got {strides}")
            strides = strides[0]
        kh, kw = kernel_size
        self.stride, self.padding, self.impl, self.dtype = int(strides), padding, impl, dtype
        self.kernel = nn.Parameter(torch.empty(kh, kw, features_in, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, s = self.kernel, self.stride
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
        if tuple(w.shape[:2]) == (1, 1):
            return conv2d_im2col(x, w, s, self.padding)  # 1x1 == matmul
        if self.impl == "pallas" and _supported(x.shape, w.shape, s, self.padding):
            return conv3x3(x, w)
        if self.impl in ("im2col", "pallas"):
            return conv2d_im2col(x, w, s, self.padding)
        return _conv_cudnn(x, w, s, self.padding)
