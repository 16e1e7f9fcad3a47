// Building blocks shared by the bf16 flash kernels on the Hopper tensor cores
// (flash_attention_sm90.cu: Dh 64 and 128; flash_dh256_sm90.cu: Dh 256): the
// 128-byte-swizzled tile layout and its shared-memory descriptors, wgmma,
// the three-term split of a float32 operand, the online softmax of one
// 64-key tile, and dq's ds.
// flash_attention_sm90.cu's header states the arithmetic they implement.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWG = 128;        // threads of one warpgroup
constexpr int kTile = 64;       // rows of every tile: q, k, v, dO
constexpr int kRowBytes = 128;  // one swizzled row: 64 bf16
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

// Byte offset of 16-byte chunk c (8 bf16) of row r in an R-row tile. The
// tile is Dh/64 column groups of R rows x 128 bytes; each 8-row group is one
// 1024-byte atom of the 128-byte swizzle (chunk ^ row % 8), as wgmma reads it.
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (R * kRowBytes) + r * kRowBytes + (((c & 7) ^ (r & 7)) << 4);
}

// --- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (all >> 4), layout 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// k step kk (16 of the Dh columns) of the rows from `tile` on of an R-row
// tile (Dh/64 column groups of R rows x 128 bytes), K-major: 8-row atoms 1024
// bytes apart; within a 128-byte row the step moves the start by 32 bytes (the
// swizzle is applied to the address).
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc(tile + (kk >> 2) * (R * kRowBytes) + (kk & 3) * 32, 16, 1024);
}

// k step kk (16 rows) of 64-column half g of an R-row tile, MN-major (the
// product's N is Dh, contiguous in a row): 8-row atoms 1024 bytes apart
// along K. One instruction covers one 64-wide half, so the offset between
// halves is never read and both offsets can be 1024.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int g) {
  return desc(tile + g * (R * kRowBytes) + kk * 16 * kRowBytes, 1024, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// all but the newest N groups of products are done
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator values around the async products
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_F8(i)                                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64) = (acc ? d : 0) + A B^T over 16 columns, A and B K-major in
// shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32 ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64) = (acc ? d : 0) + A B over 16 rows of B, A (64 x 16) in
// registers, B MN-major in shared memory (trans-b)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                         int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

#undef WG_D32
#undef WG_F8

// (x, y) = hi + mid + lo exactly, each a pair of bf16: hi keeps x's top 16
// bits (sign, exponent and 7 mantissa bits: bf16(x) rounded toward zero),
// mid the top 16 bits of x - hi, and lo = x - hi - mid has at most 8
// significant bits, so it is a bf16 value. Both differences are exact in
// float32. Bit masks and byte permutes, no conversions.
__device__ __forceinline__ float top16(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const float rx = x - top16(x), ry = y - top16(y);
  const float lx = rx - top16(rx), ly = ry - top16(ry);
  hi = __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
  mid = __byte_perm(__float_as_uint(rx), __float_as_uint(ry), 0x7632);
  lo = __byte_perm(__float_as_uint(lx), __float_as_uint(ly), 0x7632);
}

// The 64 x 64 accumulator s as the register A operand of four k steps, each
// in three terms (a[kk][0] hi, [1] mid, [2] lo). In the m64nNk16 accumulator
// a thread holds (row, 8j + 2c + e) in s[4j + e] and (row + 8, ...) in
// s[4j + 2 + e]; the A fragment of k step kk is the same thread's values of
// columns 16kk .. 16kk + 15, i.e. s[8kk .. 8kk + 7] paired in order.
__device__ __forceinline__ void split_frags(const float (&s)[32], uint32_t (&a)[4][3][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], a[kk][0][r], a[kk][1][r], a[kk][2][r]);
}

// Online softmax of one 64-key tile at k0 for this thread's two rows (row0,
// row0 + 8; q0 is the block's first row): s becomes p = exp(scale s - m),
// m and l move on, and corr = exp(m_old - m_new) per row.
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0, int q0, int row0, int c2,
                                             int Tn, int causal, float scale) {
  // only a tile across T or on the diagonal needs the mask
  const bool edge = k0 + kTile > Tn || (causal && k0 + kTile - 1 > q0);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    float bm = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + c2 + e;
        float x = s[4 * j + 2 * hh + e] * scale;
        if (edge && (col >= Tn || (causal && col > row))) x = kNegInf;
        s[4 * j + 2 * hh + e] = x;
        bm = fmaxf(bm, x);
      }
    bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 1));
    bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, 2));
    const float nm = fmaxf(m[hh], bm);
    corr[hh] = expf(m[hh] - nm);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = expf(s[4 * j + 2 * hh + e] - nm);
        s[4 * j + 2 * hh + e] = p;
        ps += p;
      }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    ps += __shfl_xor_sync(0xffffffffu, ps, 2);
    l[hh] = l[hh] * corr[hh] + ps;
    m[hh] = nm;
  }
}

// --- the backward's dq: ds ---------------------------------------------------

// ds = p * (dp - delta) of one 64-key tile at k0 for this thread's two q
// rows (row0, row0 + 8), p = exp(scale s - lse), in dp; keys at or past T
// give p = 0 (their rows of K and V are zero-filled)
__device__ __forceinline__ void ds_tile(const float (&s)[32], float (&dp)[32],
                                        const float (&lr)[2], const float (&dr)[2], int k0,
                                        int q0, int row0, int c2, int Tn, int causal,
                                        float scale) {
  // only a tile across T or on the diagonal needs the mask
  const bool edge = k0 + kTile > Tn || (causal && k0 + kTile - 1 > q0);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + 8 * j + c2 + e;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int at = 4 * j + 2 * hh + e;
        float x = scale * s[at];
        if (edge && causal && col > row0 + 8 * hh) x = kNegInf;
        const float p = !edge || col < Tn ? expf(x - lr[hh]) : 0.f;
        dp[at] = p * (dp[at] - dr[hh]);
      }
    }
}

}  // namespace
