// 3x3 / stride-1 / SAME convolution over a leading lane axis (one weight set
// per client lane): the forward (which also gives dx) and the weight gradient.
// Activations NHWC, weights HWIO, float32 or bfloat16 (the JAX package's
// use_bf16: conv.py:297-299 casts x and w to the model's dtype).
//
// Replaces: fedml_tpu/ops/conv.py::conv2d_pallas — the forward Pallas kernel
// _fwd_kernel (reused for dx on the spatially flipped, channel-transposed
// kernel) and the weight-gradient kernel _dw_kernel of _conv2d_pallas_bwd.
// Under jax.vmap the Pallas grid gains the lane axis; here it is blockIdx.z.
//
// Both are GEMMs over an implicit patch matrix A_l[m, k], with m = (b, h, w)
// a pixel, k = (dy, dx, ci) a row of the weights viewed as (9 Ci, Co), and
// A_l[m, k] = x[l, b, h + dy - 1, w + dx - 1, ci] (zero outside the image):
//   forward  y[l, m, n]  = sum_k A_l[m, k] * w[l, k, n]
//   dw       dw[l, k, n] = sum_m A_l[m, k] * dy[l, m, n]
//
// Bound on the H100: at the main path's block shape (L = 10 lanes, B = 64,
// 32x32, 16 -> 16 channels) each is 3.0 GFLOP of fp32 FMAs (~45 us at
// 67 TFLOP/s) against ~84 MB of activations (~25 us at 3.35 TB/s):
// operations. The network's stem (3 -> 16 channels) is bytes (~15 us against
// ~8 us of operations).
//
// Design: the patch matrix never reaches device memory, as in the TPU kernel,
// where it lives in VMEM. Arithmetic is IEEE fp32 on the CUDA cores (no
// TF32): the ResNet path is float32, and a tensor-core split (3xTF32 or three
// bf16 terms, as the flash kernels do) would need its own exactness argument.
//
// Forward: each block stages a 16-deep slice of A, gathered from x with the
// tap's shift and the image edge masked, and the matching slice of w in
// shared memory; 256 threads each keep a 4x4 register tile of the block's
// 4096 outputs, fed by two float4 reads of shared memory per 16 FMAs. Where
// Ci is a multiple of 16 a slice lies in one tap and is read with float4
// loads; otherwise element by element. Tiles are 256x16, 128x32 or 64x64 by
// Co, so narrow layers waste no columns. A sequential fmaf chain per output
// in increasing k.
//
// Weight gradient: it contracts over all B*H*W pixels of a lane (65,536 at
// the first stage) into a small (9 Ci, Co) output. A block's tile covers the
// rows of the contraction it needs, not a fixed count: all 27 of the stem's
// rows (a 32-row tile), 144 rows where they divide 9 Ci (Ci = 16, 32, 64:
// whole tiles, no padding), else 64; columns 16, 32 or 64 by Co. PG groups
// of TK threads (PG = 8, 2 or 4: 256 or 288 threads) each sum the whole
// tile, a 4 x BN/4 register tile per thread fed by one float4 of the patch
// and BN/16 float4s of dy per pixel, over their own 16 pixels of every
// slice; at the end the groups' sums are added in shared memory in group
// order. Slices (16 PG pixels: the patch rows of the tile and the pixels' dy
// rows) stream through a three-stage cp.async ring, two slices ahead of the
// FMAs, one barrier per slice: 16-byte copies where Ci (x) or Co (dy) is a
// multiple of 4, else 4-byte ones, with taps outside the image zero-filled
// by the copy itself. Each thread stages one pixel's rows of a slice, with
// the rows' taps and offsets computed once. The contraction is cut into
// pixel spans across blocks as in agg_robust.cu (the wrapper picks the
// count: at most two blocks per SM, one wave, which keeps the partials
// small and leaves no SM a block more than the others), each writing a
// partial tile, and a second kernel (conv_dw_reduce.cuh) sums the partials
// of each element in the fixed order s = 0..S-1: no float atomics, so dw
// repeats bit for bit.
//
// Inputs may broadcast over lanes (lane stride 0): the first local step,
// where every client still holds the global weights.
//
// bfloat16 (the _bf16 entry points): the same kernels instantiated for
// __nv_bfloat16 operands, converted to float32 as they are read, so every
// product and sum is float32 as in the TPU kernel (preferred_element_type
// float32, conv.py:147 and :251); the forward rounds each output once to
// bfloat16 (round to nearest even) on store, the weight gradient sums its
// float32 partials in the fixed split order and rounds once. The bf16
// forward serves only ragged widths (neither Ci = Co in {16, 32, 64} nor
// the stem's 3 -> 16), the bf16 weight gradient those and the stem:
// ResNet's block convs (Ci = Co in {16, 32, 64}) run their bf16 forward, dx
// and weight gradient on conv3x3_sm90.cu's tensor-core kernels, and the
// stem its bf16 forward there too (ops/conv.py::fwd_route and dw_route).
// Copies of 2-byte elements (Ci or
// Co not a multiple of 4: the stem's x) have no cp.async form and are plain
// loads and shared-memory stores into the same ring; 4-element chunks are
// 8-byte cp.async copies. Bound: half the bytes of float32, the same FMA
// operations (the CUDA cores have no faster bf16 multiply-add into float32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_dw_reduce.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <class T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// four consecutive elements (16-byte aligned floats, 8-byte aligned bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// the forward
constexpr int kThreads = 256;  // a 4x4 register tile each
constexpr int kTile = 4096;    // outputs of one block
constexpr int kSlice = 16;     // contraction elements staged per step

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

struct Pixel {
  int b, h, w;
};

__device__ __forceinline__ Pixel decode(int64_t m, int64_t HW, int W) {
  Pixel p;
  p.b = (int)(m / HW);
  const int r = (int)(m - (int64_t)p.b * HW);
  p.h = r / W;
  p.w = r - p.h * W;
  return p;
}

// x[l, b, h + dy - 1, w + dx - 1, ci] for k = (dy, dx, ci), or null outside
template <class T>
__device__ __forceinline__ const T* tap_ptr(const T* xl, Pixel p, int tap, int ci, int H, int W,
                                            int Ci) {
  const int hs = p.h + tap / 3 - 1, ws = p.w + tap % 3 - 1;
  if (hs < 0 || hs >= H || ws < 0 || ws >= W) return nullptr;
  return xl + (((int64_t)p.b * H + hs) * W + ws) * Ci + ci;
}

template <int BN, bool VEC, class T>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ y, int B,
                   int H, int W, int Ci, int Co, int64_t x_lane, int64_t w_lane) {
  constexpr int BM = kTile / BN;               // output pixels of the block
  constexpr int TN = BN / 4;                   // threads along the channels
  constexpr int APT = BM * kSlice / kThreads;  // A elements one thread stages
  constexpr int TPP = kSlice / APT;            // threads staging one pixel
  __shared__ __align__(16) float As[kSlice][BM + 4];
  __shared__ __align__(16) float Bs[kSlice][BN];

  const int t = threadIdx.x;
  const int64_t HW = (int64_t)H * W, M = (int64_t)B * HW;
  const int K = 9 * Ci;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const T* xl = x + (int64_t)blockIdx.z * x_lane;
  const T* wl = w + (int64_t)blockIdx.z * w_lane;
  T* yl = y + (int64_t)blockIdx.z * M * Co;

  // the pixel whose patch row this thread stages, decoded once
  const int am = t / TPP, ak = (t % TPP) * APT;
  const bool m_in = m0 + am < M;
  const Pixel px = m_in ? decode(m0 + am, HW, W) : Pixel{0, 0, 0};
  const int tm = t / TN, tn = t % TN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kSlice) {
    if (VEC) {  // Ci % 16 == 0: the slice is one tap's contiguous channels
      const int tap = k0 / Ci;
      const T* src = m_in ? tap_ptr(xl, px, tap, k0 - tap * Ci + ak, H, W, Ci) : nullptr;
#pragma unroll
      for (int j = 0; j < APT; j += 4) {
        const float4 v = src ? load4(src + j) : make_float4(0.f, 0.f, 0.f, 0.f);
        As[ak + j][am] = v.x;
        As[ak + j + 1][am] = v.y;
        As[ak + j + 2][am] = v.z;
        As[ak + j + 3][am] = v.w;
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < APT; ++j) {
        const int k = k0 + ak + j;
        float v = 0.f;
        if (m_in && k < K) {
          const int tap = k / Ci;
          const T* src = tap_ptr(xl, px, tap, k - tap * Ci, H, W, Ci);
          if (src) v = to_f(*src);
        }
        As[ak + j][am] = v;
      }
    }
    for (int i = t; i < kSlice * BN; i += kThreads) {
      const int kk = i / BN, nn = i % BN;
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < Co) ? to_f(wl[(int64_t)k * Co + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlice; ++kk)
      fma4x4(acc, *reinterpret_cast<const float4*>(&As[kk][tm * 4]),
             *reinterpret_cast<const float4*>(&Bs[kk][tn * 4]));
    __syncthreads();
  }

  const int n = n0 + tn * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + tm * 4 + i;
    if (m >= M) continue;
    T* dst = yl + m * Co + n;
    if ((Co & 3) == 0) {  // n and Co are multiples of 4: all four or none
      if (n < Co) store4(dst, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < Co) dst[j] = from_f<T>(acc[i][j]);
    }
  }
}

// --- the weight gradient -----------------------------------------------------

constexpr int kGroupPixels = 16;  // pixels of a slice one thread group sums
constexpr int kStages = 3;        // ring depth of the staged slices
constexpr int kDwBlocks = 2;      // blocks per SM the registers are cut for

// Rows of dw one block covers, from the contraction's length K = 9 Ci (the
// wrapper's dw_tile mirrors it): all of K = 9 Ci <= 32 (the stem's 27), 144
// rows where they divide K (every Ci that is a multiple of 16), else 64.
int dw_rows(int K) { return K <= 32 ? 32 : (K % 144 == 0 ? 144 : 64); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes (x rows, kept in L1 for the neighbouring taps) or 4 bytes, zero
// when !valid (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16_stream(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 8 bytes (four bf16), zero when !valid
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// Copies into the dw ring by element type: four elements of a patch row
// (kept in L1), four of dy (streamed), one element
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  cp_async16(dst, src, ok);
}
__device__ __forceinline__ void copy4(bf16* dst, const bf16* src, bool ok) {
  cp_async8(dst, src, ok);
}
__device__ __forceinline__ void copy4_stream(float* dst, const float* src, bool ok) {
  cp_async16_stream(dst, src, ok);
}
__device__ __forceinline__ void copy4_stream(bf16* dst, const bf16* src, bool ok) {
  cp_async8(dst, src, ok);
}
__device__ __forceinline__ void copy1(float* dst, const float* src, bool ok) {
  cp_async4(dst, src, ok);
}
// cp.async copies no 2-byte element: a load and a shared-memory store, in
// the ring slot the barrier of the iteration that reads it publishes
__device__ __forceinline__ void copy1(bf16* dst, const bf16* src, bool ok) {
  *dst = ok ? *src : __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One block per (pixel span s, (k, n) tile, lane): the TK x BN tile of dw
// summed over the span's pixels into part[lane, s]. PG groups of TK threads
// each sum the whole tile over their own 16 pixels of every slice (a thread
// a 4 x BN/4 register tile: rows 4 tk.., columns 4 tn + 16 j), and the
// groups' sums are added in shared memory in group order at the end.
template <int TK, int BN, int PG, bool XV, class T>
__global__ void __launch_bounds__(PG * TK, kDwBlocks)
conv3x3_dw_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          float* __restrict__ part, int B, int H, int W, int Ci, int Co,
                          int64_t x_lane, int64_t span, int splits) {
  constexpr int NT = PG * TK;              // threads
  constexpr int SP = kGroupPixels * PG;    // pixels of one slice
  constexpr int TPP = NT / SP;             // threads staging one pixel's patch row: TK / 16
  constexpr int RN = BN / 4;               // columns of a thread
  constexpr int STAGE = SP * (TK + BN);    // elements of one stage: patch rows, then dy rows
  constexpr int NX = XV ? 4 : 16;          // copies of a patch row one thread makes
  static_assert(TK % 16 == 0 && BN % 16 == 0, "tiles are whole 16-row, 16-column blocks");
  extern __shared__ float4 smem4[];
  T* smem = reinterpret_cast<T*>(smem4);

  const int t = threadIdx.x;
  const int64_t HW = (int64_t)H * W, P = (int64_t)B * HW;
  const int K = 9 * Ci;
  const int n_tiles = (Co + BN - 1) / BN;
  const int s = blockIdx.x;
  const int k0 = (blockIdx.y / n_tiles) * TK;
  const int n0 = (blockIdx.y % n_tiles) * BN;
  const int lane = blockIdx.z;
  const T* xl = x + (int64_t)lane * x_lane;
  const T* gl = dy + (int64_t)lane * P * Co;
  const int64_t p_begin = (int64_t)s * span;
  const int64_t p_end = p_begin + span < P ? p_begin + span : P;
  const int slices = (int)((p_end - p_begin + SP - 1) / SP);
  // 4-element dy copies where Co is a multiple of 4 and dy aligned to them
  const bool g_vec = Co % 4 == 0 && ((uintptr_t)dy & (4 * sizeof(T) - 1)) == 0;

  // The patch rows this thread stages: pixel lp of every slice, rows lr +
  // TPP j of the tile (XV: 4-float chunks at rows 4 (lr + TPP j)), each
  // packed as (offset from the pixel's own channels) * 16 + tap, tap 15
  // past K
  const int lp = t / TPP, lr = t % TPP;
  int rows[NX];
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const int k = k0 + (XV ? 4 * (lr + TPP * j) : lr + TPP * j);
    const int tap = k / Ci, ci = k - tap * Ci;
    rows[j] = k < K ? (((tap / 3 - 1) * W + (tap % 3 - 1)) * Ci + ci) * 16 + tap : 15;
  }

  const int g = t / TK, u = t % TK, tk = u / 4, tn = u % 4;
  float acc[4][RN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  // Iteration i stages slice i + kStages - 1 (one cp.async group, maybe
  // empty) and sums slice i; the first kStages - 1 only stage.
  for (int i = 1 - kStages; i < slices; ++i) {
    if (i >= 0) {
      cp_async_wait<kStages - 2>();  // slice i has landed
      __syncthreads();               // ... for every thread, and slice i-1's stage is free
    }
    const int ns = i + kStages - 1;
    if (ns < slices) {
      T* As = smem + (ns % kStages) * STAGE;
      T* Gs = As + SP * TK;
      const int64_t p0 = p_begin + (int64_t)ns * SP;
      const bool p_in = p0 + lp < p_end;
      const int p = p_in ? (int)(p0 + lp) : 0;  // P < 2^31 (fedml_conv3x3_dw)
      const int r = p % (int)HW, h = r / W, w = r - h * W;
      const T* xc = xl + (int64_t)p * Ci;
      T* arow = As + lp * TK;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        const int tap = rows[j] & 15, hs = h + tap / 3 - 1, ws = w + tap % 3 - 1;
        const bool ok = p_in && tap < 9 && hs >= 0 && hs < H && ws >= 0 && ws < W;
        const T* src = ok ? xc + (rows[j] >> 4) : xl;
        if (XV)
          copy4(arow + 4 * (lr + TPP * j), src, ok);
        else
          copy1(arow + lr + TPP * j, src, ok);
      }
      if (g_vec) {
        for (int e = t; e < SP * BN / 4; e += NT) {
          const int pp = e / (BN / 4), c = 4 * (e % (BN / 4));
          const bool ok = p0 + pp < p_end && n0 + c < Co;
          copy4_stream(Gs + pp * BN + c, ok ? gl + (p0 + pp) * Co + n0 + c : gl, ok);
        }
      } else {
        for (int e = t; e < SP * BN; e += NT) {
          const int pp = e / BN, c = e % BN;
          const bool ok = p0 + pp < p_end && n0 + c < Co;
          copy1(Gs + pp * BN + c, ok ? gl + (p0 + pp) * Co + n0 + c : gl, ok);
        }
      }
    }
    cp_async_commit();
    if (i < 0) continue;
    const T* As = smem + (i % kStages) * STAGE + g * kGroupPixels * TK;
    const T* Gs = smem + (i % kStages) * STAGE + SP * TK + g * kGroupPixels * BN;
#pragma unroll 4
    for (int pp = 0; pp < kGroupPixels; ++pp) {
      const float4 a = load4(As + pp * TK + 4 * tk);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int jj = 0; jj < RN / 4; ++jj) {
        const float4 b = load4(Gs + pp * BN + 16 * jj + 4 * tn);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][4 * jj + e] = fmaf(av[r], bv[e], acc[r][4 * jj + e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the groups' sums now

  float* red = reinterpret_cast<float*>(smem4);  // [PG][TK][BN]
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int jj = 0; jj < RN / 4; ++jj)
      *reinterpret_cast<float4*>(red + (g * TK + 4 * tk + r) * BN + 16 * jj + 4 * tn) =
          make_float4(acc[r][4 * jj], acc[r][4 * jj + 1], acc[r][4 * jj + 2],
                      acc[r][4 * jj + 3]);
  __syncthreads();
  float* out = part + ((int64_t)lane * splits + s) * K * Co;
  for (int e = t; e < TK * BN; e += NT) {
    const int k = k0 + e / BN, n = n0 + e % BN;
    if (k >= K || n >= Co) continue;
    float sum = red[e];
#pragma unroll
    for (int gg = 1; gg < PG; ++gg) sum += red[gg * TK * BN + e];
    out[(int64_t)k * Co + n] = sum;
  }
}

int block_cols(int Co) { return Co <= 16 ? 16 : (Co <= 32 ? 32 : 64); }

bool shapes_ok(int L, int B, int H, int W, int Ci, int Co) {
  return L > 0 && L <= 65535 && B > 0 && H > 0 && W > 0 && Ci > 0 && Co > 0 &&
         (int64_t)H * W <= (1LL << 30) && 9LL * Ci <= (1LL << 30);
}

template <int BN, bool VEC, class T>
cudaError_t launch_fwd(const T* x, const T* w, T* y, int L, int B, int H, int W, int Ci, int Co,
                       int64_t x_lane, int64_t w_lane, cudaStream_t st) {
  const int64_t M = (int64_t)B * H * W;
  const int64_t mt = (M + kTile / BN - 1) / (kTile / BN);
  const int nt = (Co + BN - 1) / BN;
  if (mt > 0x7fffffff || nt > 65535) return cudaErrorInvalidValue;
  conv3x3_fwd_kernel<BN, VEC, T><<<dim3((unsigned)mt, (unsigned)nt, (unsigned)L), kThreads, 0,
                                   st>>>(x, w, y, B, H, W, Ci, Co, x_lane, w_lane);
  return cudaGetLastError();
}

template <class T>
int fwd(const T* x, const T* w, T* y, int L, int B, int H, int W, int Ci, int Co,
        long long x_lane, long long w_lane, void* stream) {
  if (!shapes_ok(L, B, H, W, Ci, Co) || x_lane < 0 || w_lane < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = Ci % kSlice == 0;
  switch (block_cols(Co) * 2 + (vec ? 1 : 0)) {
    case 32: return (int)launch_fwd<16, false>(x, w, y, L, B, H, W, Ci, Co, x_lane, w_lane, st);
    case 33: return (int)launch_fwd<16, true>(x, w, y, L, B, H, W, Ci, Co, x_lane, w_lane, st);
    case 64: return (int)launch_fwd<32, false>(x, w, y, L, B, H, W, Ci, Co, x_lane, w_lane, st);
    case 65: return (int)launch_fwd<32, true>(x, w, y, L, B, H, W, Ci, Co, x_lane, w_lane, st);
    case 128: return (int)launch_fwd<64, false>(x, w, y, L, B, H, W, Ci, Co, x_lane, w_lane, st);
    default: return (int)launch_fwd<64, true>(x, w, y, L, B, H, W, Ci, Co, x_lane, w_lane, st);
  }
}

// groups of TK threads: 256 threads, 288 at 144 rows
constexpr int dw_groups(int TK) { return TK == 144 ? 2 : 256 / TK; }

template <int TK, int BN, bool XV, class T>
cudaError_t launch_dw(const T* x, const T* dy, float* part, int L, int B, int H, int W, int Ci,
                      int Co, int64_t x_lane, int64_t span, int splits, cudaStream_t st) {
  constexpr int PG = dw_groups(TK);
  const int64_t tiles = (9LL * Ci + TK - 1) / TK * ((Co + BN - 1) / BN);
  if (tiles > 65535) return cudaErrorInvalidValue;
  // the ring of staged slices, then (reused) the groups' float32 sums
  constexpr int ring = kStages * kGroupPixels * PG * (TK + BN) * (int)sizeof(T);
  constexpr int sums = PG * TK * BN * (int)sizeof(float);
  constexpr int bytes = ring > sums ? ring : sums;
  auto kernel = conv3x3_dw_partial_kernel<TK, BN, PG, XV, T>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((unsigned)splits, (unsigned)tiles, (unsigned)L), PG * TK, bytes, st>>>(
      x, dy, part, B, H, W, Ci, Co, x_lane, span, splits);
  return cudaGetLastError();
}

// a tile of TK = dw_rows(9 Ci) rows and block_cols(Co) columns; 4-element
// patch copies (XV) where Ci is a multiple of 4 and x aligned to them
template <int TK, bool XV, class T>
cudaError_t launch_dw_cols(const T* x, const T* dy, float* part, int L, int B, int H, int W,
                           int Ci, int Co, int64_t x_lane, int64_t span, int splits,
                           cudaStream_t st) {
  switch (block_cols(Co)) {
    case 16:
      return launch_dw<TK, 16, XV>(x, dy, part, L, B, H, W, Ci, Co, x_lane, span, splits, st);
    case 32:
      return launch_dw<TK, 32, XV>(x, dy, part, L, B, H, W, Ci, Co, x_lane, span, splits, st);
    default:
      return launch_dw<TK, 64, XV>(x, dy, part, L, B, H, W, Ci, Co, x_lane, span, splits, st);
  }
}

template <class T>
int dw(const T* x, const T* dy, float* part, T* out, int L, int B, int H, int W, int Ci, int Co,
       long long x_lane, long long span, int splits, void* stream) {
  const int64_t P = (int64_t)B * H * W;
  // pixel indices and packed tap offsets ((W + 2) Ci * 16) are 32-bit
  if (!shapes_ok(L, B, H, W, Ci, Co) || P >= (1LL << 31) || (W + 2LL) * Ci >= (1LL << 26) ||
      x_lane < 0 || span <= 0 || splits <= 0 || (int64_t)(splits - 1) * span >= P ||
      (int64_t)splits * span < P)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  const bool xv = Ci % 4 == 0 && ((uintptr_t)x & (4 * sizeof(T) - 1)) == 0;
  switch (dw_rows(9 * Ci) * 2 + (xv ? 1 : 0)) {
    case 64:  // Ci <= 3: never a multiple of 4
      err = launch_dw_cols<32, false>(x, dy, part, L, B, H, W, Ci, Co, x_lane, span, splits, st);
      break;
    case 288:
      err = launch_dw_cols<144, false>(x, dy, part, L, B, H, W, Ci, Co, x_lane, span, splits, st);
      break;
    case 289:
      err = launch_dw_cols<144, true>(x, dy, part, L, B, H, W, Ci, Co, x_lane, span, splits, st);
      break;
    case 128:
      err = launch_dw_cols<64, false>(x, dy, part, L, B, H, W, Ci, Co, x_lane, span, splits, st);
      break;
    default:
      err = launch_dw_cols<64, true>(x, dy, part, L, B, H, W, Ci, Co, x_lane, span, splits, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dw_reduce<T>(part, 9LL * Ci * Co, splits, L, out, st);
}

}  // namespace

// y (L, B, H, W, Co) = conv3x3(x (L | 1, B, H, W, Ci), w (L | 1, 3, 3, Ci, Co)),
// contiguous per lane; x_lane / w_lane are the lane strides in elements (0
// to broadcast one lane). Returns the cudaError_t of the launch.
extern "C" int fedml_conv3x3_fwd(const float* x, const float* w, float* y, int L, int B, int H,
                                 int W, int Ci, int Co, long long x_lane, long long w_lane,
                                 void* stream) {
  return fwd(x, w, y, L, B, H, W, Ci, Co, x_lane, w_lane, stream);
}

// The same for bfloat16 x, w and y: float32 products and sums, y rounded
// once to bfloat16.
extern "C" int fedml_conv3x3_fwd_bf16(const bf16* x, const bf16* w, bf16* y, int L, int B, int H,
                                      int W, int Ci, int Co, long long x_lane, long long w_lane,
                                      void* stream) {
  return fwd(x, w, y, L, B, H, W, Ci, Co, x_lane, w_lane, stream);
}

// dw (L, 3, 3, Ci, Co) = sum over (B, H, W) of patches(x)^T dy per lane, for
// x (L | 1, B, H, W, Ci) (lane stride x_lane elements, 0 to broadcast) and
// dy (L, B, H, W, Co). The B*H*W pixels are cut into `splits` spans of
// `span`; part is (L, splits, 9 Ci, Co) float32 scratch. Returns the
// cudaError_t.
extern "C" int fedml_conv3x3_dw(const float* x, const float* dy, float* part, float* dw_out,
                                int L, int B, int H, int W, int Ci, int Co, long long x_lane,
                                long long span, int splits, void* stream) {
  return dw(x, dy, part, dw_out, L, B, H, W, Ci, Co, x_lane, span, splits, stream);
}

// The same for bfloat16 x, dy and dw: float32 partials and sums, dw rounded
// once to bfloat16 (the TPU kernel's f32 accumulation and .astype(w.dtype)).
extern "C" int fedml_conv3x3_dw_bf16(const bf16* x, const bf16* dy, float* part, bf16* dw_out,
                                     int L, int B, int H, int W, int Ci, int Co,
                                     long long x_lane, long long span, int splits,
                                     void* stream) {
  return dw(x, dy, part, dw_out, L, B, H, W, Ci, Co, x_lane, span, splits, stream);
}
