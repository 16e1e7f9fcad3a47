// Staging and exchange helpers shared by the bf16 flash kernels that take
// their tiles by TMA (flash_dh256_sm90.cu at Dh 256, flash_dh384_sm90.cu at
// Dh 384, flash_wide_sm90.cu at Dh 512-1536): mbarriers, TMA copies of
// 64-row tiles and of lse/delta boxes, named barriers, the float32 exchange
// tile between two warpgroups and its protocol, the split-term P V style
// product of one
// 64-column group, the score product, the plain float32 dot products of a
// causal diagonal tile, and the host's tensor maps.

#pragma once

#include <cuda.h>

#include "flash_sm90.cuh"

namespace {

constexpr int kGroupBytes = kTile * kRowBytes;  // 64 columns of a 64-row tile: 8 KB
constexpr int kXFloats = kTile * kTile;         // one exchange tile
// lse and delta of a q tile: a box of 68 floats from the 16-byte boundary at
// or below the tile's first (TMA copies start on one), 384 bytes apart
constexpr int kVecBox = kTile + 4;
constexpr int kVecSlot = 384;

// --- mbarriers and TMA -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the one arrival of this phase, expecting `bytes` of copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// the phase of `parity` has completed; the loop stays inside one asm block,
// so the warp leaves it converged, as the .aligned wgmma instructions after
// it require
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                       int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// rows t0 .. t0 + 63 of head h of batch b, all DH columns, as DH / 64
// swizzled 64-column groups
template <int DH>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int h,
                                         int t0, int b) {
#pragma unroll
  for (int g = 0; g < DH / 64; ++g) tma_4d(dst + g * kGroupBytes, map, bar, 64 * g, h, t0, b);
}

// named barriers among N threads (id 0 is __syncthreads)
template <int N>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// --- products and the exchange tile -------------------------------------------

// d = A B^T of two 64-row tiles over NKK k steps (16 columns each) from k
// step kk0 on (issued, not waited)
template <int NKK>
__device__ __forceinline__ void scores(float (&d)[32], uint32_t a_tile, uint32_t b_tile,
                                       int kk0 = 0) {
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk)
    wgmma_ss(d, desc_k<kTile>(a_tile, kk0 + kk), desc_k<kTile>(b_tile, kk0 + kk), kk);
}

// element (r, c) of an exchange tile: row r's columns XOR-swizzled by
// 8 (r % 4), so a warp's float2 accesses (4 rows x 4 lanes per half warp)
// hit 32 distinct banks
__device__ __forceinline__ int xat(int r, int c) { return r * kTile + (c ^ ((r & 3) << 3)); }

// the whole exchange tile from the m64n64 accumulator layout
__device__ __forceinline__ void put_tile(float* X, const float (&s)[32], int r, int c2) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(X + xat(r + 8 * hh, 8 * j + c2)) =
          make_float2(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]);
}

// the whole exchange tile in the m64n64 accumulator layout
__device__ __forceinline__ void get_tile(const float* X, float (&s)[32], int r, int c2) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(X + xat(r + 8 * hh, 8 * j + c2));
      s[4 * j + 2 * hh] = x.x;
      s[4 * j + 2 * hh + 1] = x.y;
    }
}

// named barriers of exchange() (0 is __syncthreads): both exchange tiles
// written (kWritten); warpgroup 1 - w has read tile w (kRead + w)
constexpr int kWritten = 1, kRead = 2;

// the exchange of k tile kt of nk between two warpgroups (the forward's and
// dq's at Dh 384 and 512-1536): this warpgroup's tile x into its exchange
// tile, X + wg kXFloats, once the other has read it for tile kt - 1; the
// other's into y, once both are written
__device__ __forceinline__ void exchange(float* X, const float (&x)[32], float (&y)[32], int wg,
                                         int kt, int nk, int r, int c2) {
  if (kt > 0) named_sync<2 * kWG>(kRead + wg);
  put_tile(X + wg * kXFloats, x, r, c2);
  named_sync<2 * kWG>(kWritten);
  get_tile(X + (1 - wg) * kXFloats, y, r, c2);
  if (kt + 1 < nk) named_arrive<2 * kWG>(kRead + 1 - wg);  // I have read the other's
}

// d = A B for 64-column group g of B: A 64 x 64 in three register terms, B
// the 64-row `tile` MN-major. Per k step lo, mid, hi: flash_attention_sm90.cu's
// order (issued, not waited)
__device__ __forceinline__ void mma_split_group(float (&d)[32], const uint32_t (&a)[4][3][4],
                                                uint32_t tile, int g) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int t = 2; t >= 0; --t)
      wgmma_rs(d, a[kk][t], desc_mn<kTile>(tile, kk, g), kk > 0 || t < 2);
}

// eight bf16 (one 16-byte chunk) as float32, exactly
__device__ __forceinline__ void unpack8(const uint4 u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// flash_attention_sm90.cu's dots_fma (d = A B^T of two 64-row tiles of DH
// columns for this thread's rows r, r + 8 and columns, each output a chain
// of fmaf over the DH columns in increasing order from zero: the bits of a
// plain float32 product) with 16-byte loads, one chunk of 8 columns of a
// row each: a quarter of the loads and of their address work, ~0.4 ms of
// the wide LM's Dh-256 dq, where the diagonal's warps wait on their loads.
// The Dh 64/128 dq keeps dots_fma: under its 3-block register cap (168)
// these loads spilled 128 bytes at Dh 64 and its dq ran ~1% slower (2.525
// against 2.492-2.505 ms, H100 80GB HBM3 at 700 W).
template <int DH>
__device__ __forceinline__ void dots_plain(float (&d)[32], const uint8_t* a_tile,
                                           const uint8_t* b_tile, int r, int c2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
#pragma unroll 1
  for (int c = 0; c < DH / 8; ++c) {
    float a[2][8];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      unpack8(*reinterpret_cast<const uint4*>(a_tile + swz<kTile>(r + 8 * hh, c)), a[hh]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(b_tile + swz<kTile>(8 * j + c2 + e, c)), f);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int x = 0; x < 8; ++x)
            d[4 * j + 2 * hh + e] = fmaf(a[hh][x], f[x], d[4 * j + 2 * hh + e]);
      }
  }
}

// --- tensor maps and launch shapes ---------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (Dh, H, T, B) bf16 at element strides (sh, st, sb), 64 x 64 boxes of one
// (b, h) in the 128-byte swizzle
bool map_heads(CUtensorMap* map, const void* p, int Dh, int B, int H, int T, int64_t sb,
               int64_t st, int64_t sh) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kTile, 1}, unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
bool map_rows(CUtensorMap* map, const void* p, int B, int H, int T, int64_t sb, int64_t st,
              int64_t sh) {
  return map_heads(map, p, DH, B, H, T, sb, st, sh);
}

// a float32 vector of n, boxes of kVecBox
bool map_vec(CUtensorMap* map, const float* p, int64_t n) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n}, strides[1] = {4};
  const cuuint32_t box[1] = {(cuuint32_t)kVecBox}, unit[1] = {1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(p), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the entry points take bf16 (is_bf16 = 1) at head dim DH only
template <int DH>
bool args_ok(int B, int H, int T, int Dh, int is_bf16) {
  return B > 0 && H > 0 && T > 0 && Dh == DH && is_bf16 && (int64_t)B * H * T <= 0x7fffffffLL &&
         (T + kTile - 1) / kTile <= 65535;
}

// one block per (b, h, `rows`-row tile) times `split`, (b, h) outermost
dim3 grid(int B, int H, int T, int rows, int split = 1) {
  return dim3((unsigned)(B * H * ((T + rows - 1) / rows) * split));
}

}  // namespace
