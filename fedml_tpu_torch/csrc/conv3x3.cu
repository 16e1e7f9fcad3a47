// 3x3 / stride-1 / SAME convolution over a leading lane axis (one weight set
// per client lane): the forward (which also gives dx) and the weight gradient.
// Activations NHWC, weights HWIO, float32.
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
// ~8.5 us of operations).
//
// Design: the patch matrix never reaches device memory, as in the TPU kernel,
// where it lives in VMEM. Each block stages a 16-deep slice of A, gathered
// from x with the tap's shift and the image edge masked, and the matching
// slice of the other operand in shared memory; 256 threads each keep a 4x4
// register tile of the block's 4096 outputs, fed by two float4 reads of
// shared memory per 16 FMAs. Where Ci is a multiple of 16 a slice lies in one
// tap and is read with float4 loads; otherwise (the stem's Ci = 3, ragged
// shapes) element by element. Tiles are 256x16, 128x32 or 64x64 by Co, so
// narrow layers waste no columns. Arithmetic is IEEE fp32 on the CUDA cores
// (no TF32), a sequential fmaf chain per output in increasing k (forward) or
// pixel (dw) order.
//
// The weight gradient contracts over all B*H*W pixels of a lane (65,536 at
// the first stage) into a small (9 Ci, Co) output, so one block per output
// tile would leave the card idle. As in agg_robust.cu the contraction is cut
// into spans across blocks (the wrapper picks the count: about eight blocks
// per SM), each writing a partial tile, and a second kernel sums the partials
// of each element in the fixed order s = 0..S-1: no float atomics, so dw
// repeats bit for bit. Inputs may broadcast over lanes (lane stride 0): the
// first local step, where every client still holds the global weights.
// Speed beyond this (wgmma, TMA, a pipelined ring of slices) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
__device__ __forceinline__ const float* tap_ptr(const float* xl, Pixel p, int tap, int ci,
                                                int H, int W, int Ci) {
  const int hs = p.h + tap / 3 - 1, ws = p.w + tap % 3 - 1;
  if (hs < 0 || hs >= H || ws < 0 || ws >= W) return nullptr;
  return xl + (((int64_t)p.b * H + hs) * W + ws) * Ci + ci;
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, int B, int H, int W, int Ci, int Co,
                   int64_t x_lane, int64_t w_lane) {
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
  const float* xl = x + (int64_t)blockIdx.z * x_lane;
  const float* wl = w + (int64_t)blockIdx.z * w_lane;
  float* yl = y + (int64_t)blockIdx.z * M * Co;

  // the pixel whose patch row this thread stages, decoded once
  const int am = t / TPP, ak = (t % TPP) * APT;
  const bool m_in = m0 + am < M;
  const Pixel px = m_in ? decode(m0 + am, HW, W) : Pixel{0, 0, 0};
  const int tm = t / TN, tn = t % TN;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += kSlice) {
    if (VEC) {  // Ci % 16 == 0: the slice is one tap's contiguous channels
      const int tap = k0 / Ci;
      const float* src = m_in ? tap_ptr(xl, px, tap, k0 - tap * Ci + ak, H, W, Ci) : nullptr;
#pragma unroll
      for (int j = 0; j < APT; j += 4) {
        const float4 v = src ? *reinterpret_cast<const float4*>(src + j)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
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
          const float* src = tap_ptr(xl, px, tap, k - tap * Ci, H, W, Ci);
          if (src) v = *src;
        }
        As[ak + j][am] = v;
      }
    }
    for (int i = t; i < kSlice * BN; i += kThreads) {
      const int kk = i / BN, nn = i % BN;
      const int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < Co) ? wl[(int64_t)k * Co + n] : 0.f;
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
    float* dst = yl + m * Co + n;
    if ((Co & 3) == 0) {  // n and Co are multiples of 4: all four or none
      if (n < Co) *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < Co) dst[j] = acc[i][j];
    }
  }
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
conv3x3_dw_partial_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                          float* __restrict__ part, int B, int H, int W, int Ci, int Co,
                          int64_t x_lane, int64_t span, int splits) {
  constexpr int TK = kTile / BN;               // rows (k) of dw of the block
  constexpr int TN = BN / 4;
  constexpr int TPR = kThreads / kSlice;       // threads staging one pixel: 16
  constexpr int APT = TK / TPR;                // A elements one thread stages
  __shared__ __align__(16) float As[kSlice][TK + 4];
  __shared__ __align__(16) float Gs[kSlice][BN];

  const int t = threadIdx.x;
  const int64_t HW = (int64_t)H * W, P = (int64_t)B * HW;
  const int K = 9 * Ci;
  const int n_tiles = (Co + BN - 1) / BN;
  const int s = blockIdx.x;
  const int k0 = (blockIdx.y / n_tiles) * TK;
  const int n0 = (blockIdx.y % n_tiles) * BN;
  const int lane = blockIdx.z;
  const float* xl = x + (int64_t)lane * x_lane;
  const float* gl = dy + (int64_t)lane * P * Co;
  const int64_t p_begin = (int64_t)s * span;
  const int64_t p_end = p_begin + span < P ? p_begin + span : P;

  const int ap = t / TPR;              // pixel of the slice this thread stages
  const int kb = k0 + (t % TPR) * APT; // first k of its run
  const int tk = t / TN, tn = t % TN;
  float acc[4][4] = {};

  for (int64_t p0 = p_begin; p0 < p_end; p0 += kSlice) {
    const bool p_in = p0 + ap < p_end;
    const Pixel px = p_in ? decode(p0 + ap, HW, W) : Pixel{0, 0, 0};
    float* arow = &As[ap][kb - k0];
    if (VEC) {  // Ci % 16 == 0 and APT | 16: the run is one tap's channels
      const float* src = nullptr;
      if (p_in && kb < K) {
        const int tap = kb / Ci;
        src = tap_ptr(xl, px, tap, kb - tap * Ci, H, W, Ci);
      }
#pragma unroll
      for (int j = 0; j < APT; j += 4)
        *reinterpret_cast<float4*>(arow + j) =
            src ? *reinterpret_cast<const float4*>(src + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll 4
      for (int j = 0; j < APT; ++j) {
        const int k = kb + j;
        float v = 0.f;
        if (p_in && k < K) {
          const int tap = k / Ci;
          const float* src = tap_ptr(xl, px, tap, k - tap * Ci, H, W, Ci);
          if (src) v = *src;
        }
        arow[j] = v;
      }
    }
    for (int i = t; i < kSlice * BN; i += kThreads) {
      const int pp = i / BN, nn = i % BN;
      const int64_t p = p0 + pp;
      const int n = n0 + nn;
      Gs[pp][nn] = (p < p_end && n < Co) ? gl[p * Co + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int pp = 0; pp < kSlice; ++pp)
      fma4x4(acc, *reinterpret_cast<const float4*>(&As[pp][tk * 4]),
             *reinterpret_cast<const float4*>(&Gs[pp][tn * 4]));
    __syncthreads();
  }

  float* out = part + ((int64_t)lane * splits + s) * K * Co;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + tk * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n < Co) out[(int64_t)k * Co + n] = acc[i][j];
    }
  }
}

// dw[l, e] = sum over s = 0..splits-1 of part[l, s, e], in that order
__global__ void conv3x3_dw_reduce_kernel(const float* __restrict__ part, int64_t kn,
                                         int splits, int64_t total, float* __restrict__ dw) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t lane = e / kn, r = e - lane * kn;
  const float* src = part + lane * splits * kn + r;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += src[(int64_t)s * kn];
  dw[e] = acc;
}

int block_cols(int Co) { return Co <= 16 ? 16 : (Co <= 32 ? 32 : 64); }

bool shapes_ok(int L, int B, int H, int W, int Ci, int Co) {
  return L > 0 && L <= 65535 && B > 0 && H > 0 && W > 0 && Ci > 0 && Co > 0 &&
         (int64_t)H * W <= (1LL << 30) && 9LL * Ci <= (1LL << 30);
}

template <int BN, bool VEC>
cudaError_t launch_fwd(const float* x, const float* w, float* y, int L, int B, int H, int W,
                       int Ci, int Co, int64_t x_lane, int64_t w_lane, cudaStream_t st) {
  const int64_t M = (int64_t)B * H * W;
  const int64_t mt = (M + kTile / BN - 1) / (kTile / BN);
  const int nt = (Co + BN - 1) / BN;
  if (mt > 0x7fffffff || nt > 65535) return cudaErrorInvalidValue;
  conv3x3_fwd_kernel<BN, VEC><<<dim3((unsigned)mt, (unsigned)nt, (unsigned)L), kThreads, 0, st>>>(
      x, w, y, B, H, W, Ci, Co, x_lane, w_lane);
  return cudaGetLastError();
}

template <int BN, bool VEC>
cudaError_t launch_dw(const float* x, const float* dy, float* part, int L, int B, int H, int W,
                      int Ci, int Co, int64_t x_lane, int64_t span, int splits,
                      cudaStream_t st) {
  const int64_t kt = (9LL * Ci + kTile / BN - 1) / (kTile / BN);
  const int64_t tiles = kt * ((Co + BN - 1) / BN);
  if (tiles > 65535) return cudaErrorInvalidValue;
  conv3x3_dw_partial_kernel<BN, VEC>
      <<<dim3((unsigned)splits, (unsigned)tiles, (unsigned)L), kThreads, 0, st>>>(
          x, dy, part, B, H, W, Ci, Co, x_lane, span, splits);
  return cudaGetLastError();
}

}  // namespace

// y (L, B, H, W, Co) = conv3x3(x (L | 1, B, H, W, Ci), w (L | 1, 3, 3, Ci, Co)),
// contiguous per lane; x_lane / w_lane are the lane strides in floats (0 to
// broadcast one lane). Returns the cudaError_t of the launch.
extern "C" int fedml_conv3x3_fwd(const float* x, const float* w, float* y, int L, int B, int H,
                                 int W, int Ci, int Co, long long x_lane, long long w_lane,
                                 void* stream) {
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

// dw (L, 3, 3, Ci, Co) = sum over (B, H, W) of patches(x)^T dy per lane, for
// x (L | 1, B, H, W, Ci) (lane stride x_lane floats, 0 to broadcast) and dy
// (L, B, H, W, Co). The B*H*W pixels are cut into `splits` spans of `span`;
// part is (L, splits, 9 Ci, Co) scratch. Returns the cudaError_t.
extern "C" int fedml_conv3x3_dw(const float* x, const float* dy, float* part, float* dw, int L,
                                int B, int H, int W, int Ci, int Co, long long x_lane,
                                long long span, int splits, void* stream) {
  const int64_t P = (int64_t)B * H * W;
  if (!shapes_ok(L, B, H, W, Ci, Co) || x_lane < 0 || span <= 0 || splits <= 0 ||
      (int64_t)(splits - 1) * span >= P || (int64_t)splits * span < P)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = Ci % kSlice == 0;
  cudaError_t err;
  switch (block_cols(Co) * 2 + (vec ? 1 : 0)) {
    case 32: err = launch_dw<16, false>(x, dy, part, L, B, H, W, Ci, Co, x_lane, span, splits, st); break;
    case 33: err = launch_dw<16, true>(x, dy, part, L, B, H, W, Ci, Co, x_lane, span, splits, st); break;
    case 64: err = launch_dw<32, false>(x, dy, part, L, B, H, W, Ci, Co, x_lane, span, splits, st); break;
    case 65: err = launch_dw<32, true>(x, dy, part, L, B, H, W, Ci, Co, x_lane, span, splits, st); break;
    case 128: err = launch_dw<64, false>(x, dy, part, L, B, H, W, Ci, Co, x_lane, span, splits, st); break;
    default: err = launch_dw<64, true>(x, dy, part, L, B, H, W, Ci, Co, x_lane, span, splits, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t kn = 9LL * Ci * Co, total = kn * L;
  conv3x3_dw_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, kn, splits,
                                                                            total, dw);
  return (int)cudaGetLastError();
}
