"""Flash attention (port of ``fedml_tpu/ops/pallas/flash_attention.py``).

Hand-written CUDA kernels on (B, T, H, Dh) tensors, causal or not: bf16
with Dh 64, 128, 256, 384 or any multiple of 128 from 512 to 1536, float32
with Dh 64, 128, 256, 384 or any multiple of 128 from 512 to 896
(:data:`HEAD_DIMS`): every head dim the dispatch guard admits. bf16 inputs run on the
tensor cores (wgmma, exact to float32 through a three-term bf16 split of p
and ds): at Dh 64 and 128 in ``csrc/flash_attention_sm90.cu``, at Dh 256 in
``csrc/flash_dh256_sm90.cu`` and at Dh 384 in ``csrc/flash_dh384_sm90.cu``
(score products once per block, tiles by TMA; at Dh 384 two warpgroups
split the output columns and share the scores through shared memory), at
Dh 512-1536 in ``csrc/flash_wide_sm90.cu`` (a block per slice of 128 or
256 output columns, the scores recomputed per slice from 64-column
chunks). Float32 inputs run on the tensor cores too, in
``csrc/flash_f32_sm90.cu`` (``mma.sync`` as three TF32 products, exact to
float32), for the forward, dq and dk/dv at Dh 256 and the forward at Dh
128 and 384 (at Dh 384 three warps split each row group's columns and add
their partial scores in one fixed order), in ``csrc/flash_f32_wgmma_sm90.cu``
for dq and dk/dv at Dh 128 (the same arithmetic with every product on
wgmma: two warpgroups, one a score product, hi terms in registers), for dq
at Dh 384 and all three at Dh 512 (that block on each 128-column slice, a
cluster of three or four blocks on as many SMs adding their partial scores
through distributed shared memory; the forward's rows' owner block takes
the online-softmax step and sends p to all four),
and all three at Dh 640-896 in
``csrc/flash_wide_f32_sm90.cu`` (the same arithmetic on ``mma.sync``, Dh
/ 128 warps a row group, their number set at launch); every float32 kernel at
Dh 64 runs the FMA kernels of ``csrc/flash_attention.cu`` (:func:`route`):

- :func:`flash_forward` — online-softmax attention; returns ``out`` in q's
  dtype and the per-row logsumexp ``lse`` (B*H, 1, T) float32, the TPU
  kernel's layout;
- :func:`flash_dq` and :func:`flash_dkv` — the backward, with p recomputed
  from q, k and ``lse`` and ``delta = rowsum(dO * O)`` (B*H, 1, T) from the
  caller.

Each wrapper has a ``.launches`` counter. On a CUDA tensor it launches its
kernel (or raises); on a CPU tensor it runs its plain version
(:func:`flash_forward_plain`, :func:`flash_dq_plain`,
:func:`flash_dkv_plain`), the direct formula in float32. :func:`flash_attention`
is the differentiable entry point: a ``torch.autograd.Function`` whose
forward saves ``out`` and ``lse`` and whose backward computes ``delta`` and
launches dq and dk/dv, as the JAX ``custom_vjp`` does.

The dispatch guards (:func:`auto_block`, :func:`flash_vmem_ok`,
:func:`flash_shapes_ok`, :func:`_resolve_blocks`, ``BLOCK_TABLE``) are the
JAX package's, unchanged, so both packages decide flash against dense
alike. Their thresholds were measured on a TPU v5e (VMEM budget, block
knees) and are to be re-derived on the H100 (ROADMAP.md Queue 1 item 13).
The TPU block sizes do not set the CUDA kernels' tiles: those are 64 rows,
with ragged edges masked in the kernel, so the kernel wrappers take any T.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build

# --- the JAX package's dispatch guards (TPU v5e thresholds) -------------------

MAX_BLOCK = 1024
MIN_BLOCK = 128
NEG_INF = float(torch.finfo(torch.float32).min)

# scoped-VMEM budget of one TPU kernel instance (the v5e's measured line)
_VMEM_BUDGET = (1536 + 2 * 2 * 1536) * 64 * 2 + (2 * 128 + 64) * 1536 * 4


def auto_block(T: int) -> Optional[int]:
    """Largest power-of-two block in [128, 1024] dividing T; at T <= 1024
    prefer T//2. None if no candidate divides T."""
    if T <= MAX_BLOCK:
        half = T // 2
        if half >= MIN_BLOCK and half % MIN_BLOCK == 0 and T % half == 0:
            return half
    for b in (MAX_BLOCK, 512, 256, MIN_BLOCK):
        if b <= T and T % b == 0:
            return b
    return None


# measured-fastest (block_q, block_k) per T on the TPU: empty, as in JAX
BLOCK_TABLE: dict = {}
BLOCK_TABLE_SWEPT_SHAPE = (64, 2)


def flash_vmem_ok(T: int, Dh: int, itemsize: int = 2, block: Optional[int] = None) -> bool:
    """The TPU kernel's working set (q + double-buffered k/v tiles, f32
    m/l/acc scratch) within the v5e's scoped-VMEM budget."""
    block = block or auto_block(T) or MIN_BLOCK
    per_block = (block + 2 * 2 * block) * Dh * itemsize
    scratch = (2 * 128 + Dh) * block * 4
    return per_block + scratch <= _VMEM_BUDGET


def flash_shapes_ok(T: int, Dh: int, itemsize: int = 2) -> bool:
    """The dispatch guard of ``ops.attention.multihead_attention``: T tiles
    into whole 128-multiple automatic blocks, Dh is 64 or a multiple of 128,
    and the blocks fit the VMEM budget."""
    blk = auto_block(T)
    return (blk is not None and (Dh % 128 == 0 or Dh == 64)
            and flash_vmem_ok(T, Dh, itemsize, block=blk))


def _resolve_blocks(T: int, Dh: int = 64, itemsize: int = 2):
    """The TPU kernel's (block_q, block_k) at T: ``BLOCK_TABLE``'s entry
    where it applies, else the automatic block; raises if T has none."""
    table = BLOCK_TABLE.get(T)
    if table is not None:
        bq, bk = table
        if ((Dh, itemsize) == BLOCK_TABLE_SWEPT_SHAPE
                and T % bq == 0 and T % bk == 0
                and bq % MIN_BLOCK == 0 and bk % MIN_BLOCK == 0
                and flash_vmem_ok(T, Dh, itemsize, block=max(bq, bk))):
            return bq, bk
    bq = bk = auto_block(T)
    if bq is None:
        raise ValueError(
            f"flash_attention: T={T} has no block tiling (callers should "
            "gate on flash_shapes_ok and fall back to dense)")
    return bq, bk


# --- the plain versions -------------------------------------------------------

PLAIN_ROWS = 1024  # query rows per step of the plain versions: bounds their (rows, T) scores


def _bh(t: torch.Tensor) -> torch.Tensor:
    """(B, T, H, Dh) -> (B*H, T, Dh) float32."""
    B, T, H, Dh = t.shape
    return t.float().permute(0, 2, 1, 3).reshape(B * H, T, Dh)


def _from_bh(t: torch.Tensor, B: int, H: int, dtype: torch.dtype) -> torch.Tensor:
    BH, T, Dh = t.shape
    return t.reshape(B, H, T, Dh).permute(0, 2, 1, 3).contiguous().to(dtype)


def _masked(s: torch.Tensor, r0: int, causal: bool) -> torch.Tensor:
    """Scores of query rows r0.. against every key, NEG_INF above the diagonal."""
    if not causal:
        return s
    rows = torch.arange(r0, r0 + s.shape[1], device=s.device)[:, None]
    cols = torch.arange(s.shape[2], device=s.device)[None, :]
    return s.masked_fill(cols > rows, NEG_INF)


def flash_forward_plain(q, k, v, causal: bool):
    """The forward kernel's function, directly: softmax(q k^T / sqrt(Dh)) v
    in float32 -> (out in q's dtype, lse (B*H, 1, T) float32)."""
    B, T, H, Dh = q.shape
    qb = _bh(q) * (1.0 / math.sqrt(Dh))
    kb, vb = _bh(k), _bh(v)
    outs, lses = [], []
    for r0 in range(0, T, PLAIN_ROWS):
        s = _masked(qb[:, r0:r0 + PLAIN_ROWS] @ kb.transpose(1, 2), r0, causal)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        outs.append((p @ vb) / l)
        lses.append((m + torch.log(l))[..., 0])
    return _from_bh(torch.cat(outs, 1), B, H, q.dtype), torch.cat(lses, 1)[:, None, :]


def _probs(qb, kb, dob, vb, lse, delta, r0, causal, scale):
    """p and ds = p * (dO v^T - delta) of query rows r0.. (backward's recompute)."""
    rows = slice(r0, r0 + PLAIN_ROWS)
    s = _masked(scale * (qb[:, rows] @ kb.transpose(1, 2)), r0, causal)
    p = torch.exp(s - lse[:, 0, rows, None])
    ds = p * (dob[:, rows] @ vb.transpose(1, 2) - delta[:, 0, rows, None])
    return p, ds


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool):
    """dq = scale * sum_k [p * (dO v^T - delta)] k, in float32 -> q's dtype."""
    B, T, H, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh)
    qb, kb, vb, dob = _bh(q), _bh(k), _bh(v), _bh(do)
    dq = [scale * (_probs(qb, kb, dob, vb, lse, delta, r0, causal, scale)[1] @ kb)
          for r0 in range(0, T, PLAIN_ROWS)]
    return _from_bh(torch.cat(dq, 1), B, H, q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool):
    """dk = scale * sum_q ds^T q and dv = sum_q p^T dO, in float32 -> the
    dtypes of k and v."""
    B, T, H, Dh = q.shape
    scale = 1.0 / math.sqrt(Dh)
    qb, kb, vb, dob = _bh(q), _bh(k), _bh(v), _bh(do)
    dk, dv = torch.zeros_like(kb), torch.zeros_like(vb)
    for r0 in range(0, T, PLAIN_ROWS):
        p, ds = _probs(qb, kb, dob, vb, lse, delta, r0, causal, scale)
        dv += p.transpose(1, 2) @ dob[:, r0:r0 + PLAIN_ROWS]
        dk += scale * (ds.transpose(1, 2) @ qb[:, r0:r0 + PLAIN_ROWS])
    return _from_bh(dk, B, H, k.dtype), _from_bh(dv, B, H, v.dtype)


# --- the kernel wrappers ------------------------------------------------------

# the bf16 head dims of csrc/flash_wide_sm90.cu: 128 n, 4 <= n <= 12
BF16_WIDE = tuple(range(512, 1537, 128))
# the float32 head dims of csrc/flash_wide_f32_sm90.cu: 128 n, 4 <= n <= 7
F32_WIDE = tuple(range(512, 897, 128))
# the head dims the CUDA kernels take, by dtype
HEAD_DIMS = {torch.float32: (64, 128, 256, 384) + F32_WIDE,
             torch.bfloat16: (64, 128, 256, 384) + BF16_WIDE}
DTYPES = tuple(HEAD_DIMS)


def _check(q, k, v, *more) -> str:
    """Validates q/k/v (and dO etc.) for the kernels; returns the device type."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be (B, T, H, Dh) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    ts = (q, k, v) + more
    dev = q.device
    if any(t.device != dev for t in ts):
        raise ValueError(f"flash attention operands lie on {[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dev.type == "cuda":
        check_head_dim(q.shape[-1], q.dtype)
    return dev.type


def check_head_dim(Dh: int, dtype: torch.dtype) -> None:
    """Raises unless the CUDA kernels take head dim ``Dh`` in ``dtype``."""
    dims = HEAD_DIMS[dtype]
    if Dh not in dims:
        raise ValueError(
            f"the {dtype} flash kernels take Dh in {dims}, got {Dh}: no kernel takes it, "
            "and flash_shapes_ok admits this head dim at no T")


def _strided(q, k, v):
    """q, k, v as the kernels read them: one set of (B, T, H) element strides,
    Dh contiguous, 16-byte aligned rows (the qkv projection's split views
    qualify as they are); anything else is copied to contiguous."""
    align = 16 // q.element_size()

    def ok(t):
        return (t.stride(-1) == 1 and t.stride() == q.stride() and t.data_ptr() % 16 == 0
                and all(s % align == 0 for s in t.stride()[:3]))

    if not all(ok(t) for t in (q, k, v)):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return q, k, v


def _row_vec(t: torch.Tensor, B: int, H: int, T: int, name: str) -> torch.Tensor:
    if t.dtype != torch.float32 or t.numel() != B * H * T:
        raise ValueError(f"{name} must be float32 (B*H, 1, T), got {t.dtype} {tuple(t.shape)}")
    return t.contiguous()


def _argtypes(n_ptrs):
    """ctypes argument types of an entry point with ``n_ptrs`` pointers."""
    return [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6 + \
        [ctypes.c_longlong] * 3 + [ctypes.c_float, ctypes.c_void_p]


# entry points with a tensor-core (wgmma) version for bf16 inputs
TENSOR_CORE = ("fedml_flash_fwd", "fedml_flash_dq", "fedml_flash_dkv")
# the bf16 head dims with a design of their own (scores once per block,
# tiles by TMA), and its library
BF16_TMA = {256: "flash_dh256_sm90", 384: "flash_dh384_sm90"}
# the head dims at which each entry point has a tensor-core (3xTF32
# mma.sync) version for float32 inputs
F32_TENSOR_CORE = {"fedml_flash_fwd": (128, 256, 384), "fedml_flash_dq": (256,),
                   "fedml_flash_dkv": (256, 384)}
# the head dims at which each float32 entry point has a version with its
# products on wgmma (three TF32 products), and its library: dq at Dh 384 as
# a cluster of three blocks, the forward, dq and dk/dv at Dh 512 as a
# cluster of four, one block per 128-column slice
F32_WGMMA = {"fedml_flash_fwd": (512,), "fedml_flash_dq": (128, 384, 512),
             "fedml_flash_dkv": (128, 512)}


def route(name: str, dtype: torch.dtype, Dh: int) -> Tuple[str, str]:
    """(kernel library, C entry point) that runs ``name`` on inputs of
    ``dtype`` and head dim ``Dh``: bf16 calls at Dh 256 go to
    ``flash_dh256_sm90``, at Dh 384 to ``flash_dh384_sm90``, at Dh 512-1536
    to ``flash_wide_sm90``, other bf16 calls to ``flash_attention_sm90``,
    the float32 forward at Dh 128, 256 and 384, dq at Dh 256 and dk/dv at
    Dh 256 and 384 to ``flash_f32_sm90``, the float32 forward at Dh 512, dq
    at Dh 128, 384 and 512 and dk/dv at Dh 128 and 512 to
    ``flash_f32_wgmma_sm90`` (at 384 and 512 as clusters of three and four
    blocks), all three at Dh 640-896 to ``flash_wide_f32_sm90``, the rest of
    float32 (Dh 64) to the FMA kernels of ``flash_attention``. All take the
    same arguments."""
    if dtype == torch.bfloat16 and name in TENSOR_CORE:
        if Dh in BF16_TMA:
            return BF16_TMA[Dh], f"{name}_dh{Dh}_sm90"
        if Dh in BF16_WIDE:
            return "flash_wide_sm90", name + "_wide_sm90"
        return "flash_attention_sm90", name + "_sm90"
    if dtype == torch.float32 and Dh in F32_WGMMA.get(name, ()):
        return "flash_f32_wgmma_sm90", name + "_f32wg_sm90"
    if dtype == torch.float32 and name in TENSOR_CORE and Dh in F32_WIDE:
        return "flash_wide_f32_sm90", name + "_wide_f32_sm90"
    if dtype == torch.float32 and Dh in F32_TENSOR_CORE.get(name, ()):
        return "flash_f32_sm90", name + "_f32_sm90"
    return "flash_attention", name


def _launch(name, ptrs, q, causal):
    B, T, H, Dh = q.shape
    lib, entry = route(name, q.dtype, Dh)
    fn = _build.function(lib, entry, _argtypes(len(ptrs)))
    err = fn(*ptrs, B, H, T, Dh, int(q.dtype == torch.bfloat16), int(bool(causal)),
             *q.stride()[:3], 1.0 / math.sqrt(Dh), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)


def flash_forward(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: q, k, v (B, T, H, Dh) -> (out (B, T, H, Dh) in q's
    dtype, lse (B*H, 1, T) float32)."""
    if _check(q, k, v) == "cpu":
        return flash_forward_plain(q, k, v, causal)
    q, k, v = _strided(q, k, v)
    B, T, H, Dh = q.shape
    out = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, 1, T), dtype=torch.float32, device=q.device)
    _launch("fedml_flash_fwd", [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                lse.data_ptr()], q, causal)
    flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def flash_dq(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """dq kernel: from q, k, v and dO (B, T, H, Dh), the forward's lse and
    delta = rowsum(dO * O), both (B*H, 1, T) float32 -> dq in q's dtype."""
    if _check(q, k, v, do, lse, delta) == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal)
    q, k, v = _strided(q, k, v)
    B, T, H, Dh = q.shape
    do = do.to(q.dtype).contiguous()
    lse, delta = _row_vec(lse, B, H, T, "lse"), _row_vec(delta, B, H, T, "delta")
    dq = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    _launch("fedml_flash_dq", [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                               lse.data_ptr(), delta.data_ptr(), dq.data_ptr()], q, causal)
    flash_dq.launches += 1
    return dq


flash_dq.launches = 0


def flash_dkv(q, k, v, do, lse, delta, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv kernel: the same inputs as :func:`flash_dq` -> (dk, dv)."""
    if _check(q, k, v, do, lse, delta) == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal)
    q, k, v = _strided(q, k, v)
    B, T, H, Dh = q.shape
    do = do.to(q.dtype).contiguous()
    lse, delta = _row_vec(lse, B, H, T, "lse"), _row_vec(delta, B, H, T, "delta")
    dk = torch.empty((B, T, H, Dh), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _launch("fedml_flash_dkv",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr()], q, causal)
    flash_dkv.launches += 1
    return dk, dv


flash_dkv.launches = 0


def attention_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32, (B*H, 1, T) — lse's layout."""
    B, T, H, _ = out.shape
    d = (do.float() * out.float()).sum(-1)  # (B, T, H)
    return d.permute(0, 2, 1).reshape(B * H, 1, T).contiguous()


# --- the differentiable op ----------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        delta = attention_delta(g, out)
        dq = flash_dq(q, k, v, g, lse, delta, ctx.causal)
        dk, dv = flash_dkv(q, k, v, g, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Differentiable flash attention on q/k/v (B, T, H, Dh). As in the JAX
    package, T must have a block tiling (``_resolve_blocks`` raises
    otherwise; callers gate on :func:`flash_shapes_ok`); the blocks do not
    set the CUDA kernels' tiles."""
    _resolve_blocks(q.shape[1], Dh=q.shape[-1], itemsize=q.element_size())
    return _FlashAttention.apply(q, k, v, causal)
