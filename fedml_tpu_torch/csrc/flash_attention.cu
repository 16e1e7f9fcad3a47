// Flash attention on (B, T, H, Dh), causal or full: the forward with its
// per-row logsumexp, and the two backward kernels (dq; dk and dv), all
// products as float32 FMA, for float32 inputs at Dh 64. Every other head
// dim, and bfloat16 inputs, run on the tensor cores in kernels of their own
// (ops/flash_attention.py's route); all arithmetic here is float32.
//
// Replaces: fedml_tpu/ops/pallas/flash_attention.py — _flash_kernel (the
// forward, called from _flash_forward), _dq_kernel and _dkv_kernel (both
// called from _flash_backward). The TPU kernels walk a sequential
// (bh, q block, k block) grid and carry the softmax state in VMEM scratch
// from one k step to the next; here one block owns one 64-row tile and walks
// the other axis in a loop, with that state in registers.
//
// Arithmetic, as the TPU kernels do it: inputs are cast to float32; the
// forward scales q before Q K^T and the backward scales the product after
// it; masked scores are finfo(float32).min, not -inf; o = acc / max(l,
// 1e-30) and lse = m + log(max(l, 1e-30)); the backward recomputes
// p = exp(scale * q.k - lse) and ds = p * (dO.v - delta), with delta =
// rowsum(dO * O) computed by the caller (XLA computes it outside the Pallas
// kernels too).
//
// Bound on the H100: at small_lm's shape (B 1, T 4096, H 1, Dh 64, causal)
// each (q, k) pair below the diagonal costs 2 Dh operations per product:
// the forward does two products (Q K^T, P V), dq three (Q K^T, dO V^T, dS K)
// and dk/dv four (K Q^T, V dO^T, P^T dO, dS^T Q), each 1.07 GFLOP, against
// ~5 MB of inputs and outputs. At the float32 FMA rate (67 TFLOP/s) that is
// 0.032, 0.048 and 0.064 ms, bound by operations.
//
// Design (simple and right first): 256 threads as 16 x 16. Each thread holds
// a 4 x 4 register tile of a 64 x 64 score tile (rows ty*4 + i, columns
// tx + 16 j) and a 4 x Dh/16 tile of the (64, Dh) accumulators (columns
// tx*4 + 64 g + e). Tiles of q, k, v and dO are staged in shared memory as
// float32, rows padded to Dh + 4 floats so that the float4 reads of both
// products are free of bank conflicts; each product reads two float4s of
// shared memory per 16 fmaf. A row's max and sum are shuffles within the
// half-warp that holds the row. Causal tiles past the diagonal are skipped
// whole and the diagonal tile is masked; rows and columns at or past T are
// masked too, so T need not be a multiple of 64. Blocks of the longest
// causal rows are launched first. dq, dk and dv each sum in one fixed order
// and use no atomics, so all three repeat bit for bit. On the main paths
// these kernels run in chip_smoke.py's one-head card-against-CPU check at
// Dh 64 (small_lm).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // rows of a q tile and of a k tile
constexpr int kLP = kTile + 4; // row stride of a 64 x 64 probability tile
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

template <int DH>
struct Shape {
  static constexpr int LD = DH + 4;   // row stride of a (64, Dh) tile in shared memory
  static constexpr int NJ = DH / 16;  // accumulator columns of one thread
  static constexpr int G = DH / 64;   // 64-wide column groups
  static constexpr int LP = kLP;      // row stride of dq's and dk/dv's probability tiles
  static constexpr int NS = kTile / 16;  // score columns of one thread in those tiles
};

__device__ __forceinline__ float at(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows r0 .. r0+R-1 of one (b, h) slice (row stride st elements, Dh
// contiguous) into a float tile of row stride LD, times mul; rows at or past
// T read as zero. Eight consecutive elements per thread, 16-byte loads.
template <int DH, int R = kTile>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t st, int r0, int Tn,
                                          float mul) {
  constexpr int CH = DH / 8, LD = Shape<DH>::LD;
  for (int idx = threadIdx.x; idx < R * CH; idx += kThreads) {
    const int row = idx / CH, c = idx % CH;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r0 + row < Tn) load8(src + (int64_t)(r0 + row) * st + c * 8, v);
    float* d = dst + row * LD + c * 8;
    store4(d, v[0] * mul, v[1] * mul, v[2] * mul, v[3] * mul);
    store4(d + 4, v[4] * mul, v[5] * mul, v[6] * mul, v[7] * mul);
  }
}

// s[i][j] = sum over d (in increasing order) of a[ty*4 + i][d] * b[tx + 16 j][d]
template <int DH, int NS = 4>
__device__ __forceinline__ void dot_rows(float (&s)[4][NS], const float* a, const float* b, int ty,
                                         int tx) {
  constexpr int LD = Shape<DH>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NS; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    float4 av[4], bv[NS];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < NS; ++j) bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float acc = s[i][j];
        acc = fmaf(av[i].x, bv[j].x, acc);
        acc = fmaf(av[i].y, bv[j].y, acc);
        acc = fmaf(av[i].z, bv[j].z, acc);
        acc = fmaf(av[i].w, bv[j].w, acc);
        s[i][j] = acc;
      }
  }
}

// out[i][4 g + e] = sum over c < KR (in increasing order) of p[ty*4 + i][c] *
// x[c][64 (g0 + g) + tx*4 + e], for the GN column groups from g0; p has row
// stride KR + 4
template <int DH, int KR, int GN>
__device__ __forceinline__ void prob_times(float (&out)[4][4 * GN], const float* p,
                                           const float* x, int g0, int ty, int tx) {
  constexpr int LD = Shape<DH>::LD, LP = KR + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < 4 * GN; ++n) out[i][n] = 0.f;
#pragma unroll 2
  for (int c = 0; c < KR; c += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(p + (ty * 4 + i) * LP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
#pragma unroll
      for (int g = 0; g < GN; ++g) {
        const float4 xv =
            *reinterpret_cast<const float4*>(x + (c + cc) * LD + 64 * (g0 + g) + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pc = at(pv[i], cc);
          out[i][4 * g + 0] = fmaf(pc, xv.x, out[i][4 * g + 0]);
          out[i][4 * g + 1] = fmaf(pc, xv.y, out[i][4 * g + 1]);
          out[i][4 * g + 2] = fmaf(pc, xv.z, out[i][4 * g + 2]);
          out[i][4 * g + 3] = fmaf(pc, xv.w, out[i][4 * g + 3]);
        }
      }
  }
}

// Rows ty*4 + i of a (64, Dh) accumulator tile into a contiguous (B, T, H, Dh)
// output at rows r0 + ..., skipping rows at or past T.
template <int DH>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[4][Shape<DH>::NJ],
                                           const float (&div)[4], int b, int h, int H, int Tn,
                                           int r0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= Tn) continue;
    float* dst = out + (((int64_t)b * Tn + row) * H + h) * DH + tx * 4;
#pragma unroll
    for (int g = 0; g < Shape<DH>::G; ++g)
      store4(dst + 64 * g, acc[i][4 * g] / div[i], acc[i][4 * g + 1] / div[i],
             acc[i][4 * g + 2] / div[i], acc[i][4 * g + 3] / div[i]);
  }
}

// One block per (bh, q tile): o (B, T, H, Dh) contiguous, lse (B*H, T).
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int H, int Tn, int64_t sb, int64_t st, int64_t sh, float scale, int causal) {
  constexpr int LD = Shape<DH>::LD, NJ = Shape<DH>::NJ, G = Shape<DH>::G;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nt = (Tn + kTile - 1) / kTile;
  const int q0 = (nt - 1 - (int)blockIdx.y) * kTile;  // the longest causal rows first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  load_tile<DH>(Qs, q + off, st, q0, Tn, scale);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NJ; ++n) acc[i][n] = 0.f;
  }
  // causal: no row of this tile sees a k tile past the diagonal
  const int nk = causal ? q0 / kTile + 1 : nt;
  for (int ki = 0; ki < nk; ++ki) {
    const int k0 = ki * kTile;
    __syncthreads();  // the previous step is done with Ks, Vs and Ps
    load_tile<DH>(Ks, k + off, st, k0, Tn, 1.f);
    load_tile<DH>(Vs, v + off, st, k0, Tn, 1.f);
    __syncthreads();
    float s[4][4];
    dot_rows<DH>(s, Qs, Ks, ty, tx);
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float bm = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= Tn || (causal && col > row)) s[i][j] = kNegInf;
        bm = fmaxf(bm, s[i][j]);
      }
      const float nm = fmaxf(m[i], half_max(bm));
      corr[i] = expf(m[i] - nm);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - nm);
        ps += s[i][j];
      }
      l[i] = l[i] * corr[i] + half_sum(ps);
      m[i] = nm;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * kLP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    {  // one pass over all G column groups
      float pv[4][4 * G];
      prob_times<DH, kTile, G>(pv, Ps, Vs, 0, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4 * G; ++n)
          acc[i][n] = acc[i][n] * corr[i] + pv[i][n];
    }
  }

  float ls[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ls[i] = fmaxf(l[i], 1e-30f);
    const int row = q0 + ty * 4 + i;
    if (tx == 0 && row < Tn) lse[(int64_t)bh * Tn + row] = m[i] + logf(ls[i]);
  }
  store_rows<DH>(o, acc, ls, b, h, H, Tn, q0, ty, tx);
}

// One block per (bh, q tile): dq (B, T, H, Dh) contiguous. dout is
// contiguous; lse and delta are (B*H, T). k and v stream in kTile-row tiles.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int H, int Tn, int64_t sb, int64_t st, int64_t sh,
                float scale, int causal) {
  using S = Shape<DH>;
  constexpr int LD = S::LD, NJ = S::NJ, LP = S::LP, NS = S::NS, G = S::G;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + kTile * LD;  // dO
  float* Ks = Os + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ds = Vs + kTile * LD;  // dS
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nt = (Tn + kTile - 1) / kTile;
  const int q0 = (nt - 1 - (int)blockIdx.y) * kTile;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  const int64_t doff = ((int64_t)b * Tn * H + h) * DH;
  load_tile<DH>(Qs, q + off, st, q0, Tn, 1.f);
  load_tile<DH>(Os, dout + doff, (int64_t)H * DH, q0, Tn, 1.f);
  float lr[4], dr[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lr[i] = row < Tn ? lse[(int64_t)bh * Tn + row] : 0.f;
    dr[i] = row < Tn ? delta[(int64_t)bh * Tn + row] : 0.f;
#pragma unroll
    for (int n = 0; n < NJ; ++n) acc[i][n] = 0.f;
  }
  // causal: no k tile past the q tile's last row
  const int ntk = (Tn + kTile - 1) / kTile;
  const int nk = causal ? min((q0 + kTile) / kTile, ntk) : ntk;
  for (int ki = 0; ki < nk; ++ki) {
    const int k0 = ki * kTile;
    __syncthreads();
    load_tile<DH, kTile>(Ks, k + off, st, k0, Tn, 1.f);
    load_tile<DH, kTile>(Vs, v + off, st, k0, Tn, 1.f);
    __syncthreads();
    float s[4][NS], dp[4][NS];
    dot_rows<DH, NS>(s, Qs, Ks, ty, tx);
    dot_rows<DH, NS>(dp, Os, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = scale * s[i][j];
        if (col >= Tn || (causal && col > row)) x = kNegInf;
        const float p = expf(x - lr[i]);
        Ds[(ty * 4 + i) * LP + tx + 16 * j] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();
    {  // one pass over all G column groups
      float t[4][4 * G];
      prob_times<DH, kTile, G>(t, Ds, Ks, 0, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4 * G; ++n) acc[i][n] = acc[i][n] + scale * t[i][n];
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<DH>(dq, acc, one, b, h, H, Tn, q0, ty, tx);
}

// One block per (bh, k tile): dk and dv (B, T, H, Dh) contiguous. q and dO
// stream in kTile-row tiles.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int H, int Tn, int64_t sb,
                 int64_t st, int64_t sh, float scale, int causal) {
  using S = Shape<DH>;
  constexpr int LD = S::LD, NJ = S::NJ, LP = S::LP, NS = S::NS, G = S::G;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* Os = Qs + kTile * LD;  // dO
  float* Ps = Os + kTile * LD;  // P^T: rows are keys, columns queries
  float* Ds = Ps + kTile * LP; // dS^T
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int ntq = (Tn + kTile - 1) / kTile;
  const int ki = blockIdx.y;  // the keys seen by the most causal rows first
  const int k0 = ki * kTile;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  const int64_t doff = ((int64_t)b * Tn * H + h) * DH;
  load_tile<DH>(Ks, k + off, st, k0, Tn, 1.f);
  load_tile<DH>(Vs, v + off, st, k0, Tn, 1.f);
  float dka[4][NJ], dva[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < NJ; ++n) dka[i][n] = dva[i][n] = 0.f;
  // causal: q tiles before the diagonal see none of these keys
  for (int qi = causal ? k0 / kTile : 0; qi < ntq; ++qi) {
    const int q0 = qi * kTile;
    __syncthreads();
    load_tile<DH, kTile>(Qs, q + off, st, q0, Tn, 1.f);
    load_tile<DH, kTile>(Os, dout + doff, (int64_t)H * DH, q0, Tn, 1.f);
    float lc[NS], dc[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int col = q0 + tx + 16 * j;
      lc[j] = col < Tn ? lse[(int64_t)bh * Tn + col] : 0.f;
      dc[j] = col < Tn ? delta[(int64_t)bh * Tn + col] : 0.f;
    }
    __syncthreads();
    float s[4][NS], dp[4][NS];
    dot_rows<DH, NS>(s, Ks, Qs, ty, tx);
    dot_rows<DH, NS>(dp, Vs, Os, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int col = q0 + tx + 16 * j;
        float x = scale * s[i][j];
        if (causal && row > col) x = kNegInf;
        const float p = col < Tn ? expf(x - lc[j]) : 0.f;
        Ps[(ty * 4 + i) * LP + tx + 16 * j] = p;
        Ds[(ty * 4 + i) * LP + tx + 16 * j] = p * (dp[i][j] - dc[j]);
      }
    }
    __syncthreads();
    {  // one pass over all G column groups
      float t[4][4 * G];
      prob_times<DH, kTile, G>(t, Ps, Os, 0, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4 * G; ++n) dva[i][n] = dva[i][n] + t[i][n];
    }
    {  // one pass over all G column groups
      float t[4][4 * G];
      prob_times<DH, kTile, G>(t, Ds, Qs, 0, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4 * G; ++n)
          dka[i][n] = dka[i][n] + scale * t[i][n];
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<DH>(dk, dka, one, b, h, H, Tn, k0, ty, tx);
  store_rows<DH>(dv, dva, one, b, h, H, Tn, k0, ty, tx);
}

struct Args {
  int B, H, T;
  int64_t sb, st, sh;
  float scale;
  int causal;
};

bool args_ok(int B, int H, int T) {
  return B > 0 && H > 0 && T > 0 && (int64_t)B * H <= 0x7fffffffLL &&
         (T + kTile - 1) / kTile <= 65535;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

dim3 grid(const Args& a) { return dim3((unsigned)(a.B * a.H), (unsigned)((a.T + kTile - 1) / kTile)); }

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       const Args& a, cudaStream_t st) {
  const int floats = 3 * kTile * Shape<DH>::LD + kTile * kLP;
  cudaError_t e = prepare(flash_fwd_kernel<DH>, floats);
  if (e != cudaSuccess) return e;
  flash_fwd_kernel<DH><<<grid(a), kThreads, floats * sizeof(float), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, a.H, a.T, a.sb, a.st,
      a.sh, a.scale, a.causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, const Args& a,
                      cudaStream_t st) {
  using S = Shape<DH>;  // resident q and dO, streamed k and v, dS
  const int floats = 4 * kTile * S::LD + kTile * S::LP;
  cudaError_t e = prepare(flash_dq_kernel<DH>, floats);
  if (e != cudaSuccess) return e;
  flash_dq_kernel<DH><<<grid(a), kThreads, floats * sizeof(float), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dq, a.H, a.T, a.sb, a.st, a.sh, a.scale, a.causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, const Args& a,
                       cudaStream_t st) {
  using S = Shape<DH>;  // resident k and v, streamed q and dO, P^T and dS^T
  const int floats = 4 * kTile * S::LD + 2 * kTile * S::LP;
  cudaError_t e = prepare(flash_dkv_kernel<DH>, floats);
  if (e != cudaSuccess) return e;
  flash_dkv_kernel<DH><<<grid(a), kThreads, floats * sizeof(float), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, a.H, a.T, a.sb, a.st, a.sh, a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v (B, T, H, Dh) share the element strides (sb, st, sh) with Dh
// contiguous and 16-byte aligned rows; o (B, T, H, Dh) and lse (B*H, T) are
// contiguous outputs. Float32 at Dh 64 only (is_bf16 = 0): every other
// head dim and bfloat16 have kernels of their own (ops/flash_attention.py's
// route). Returns the cudaError_t of the launch.
extern "C" int fedml_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                               int B, int H, int T, int Dh, int is_bf16, int causal, long long sb,
                               long long st, long long sh, float scale, void* stream) {
  if (!args_ok(B, H, T) || Dh != 64 || is_bf16) return (int)cudaErrorInvalidValue;
  const Args a{B, H, T, sb, st, sh, scale, causal};
  return (int)launch_fwd<64>(q, k, v, o, lse, a, (cudaStream_t)stream);
}

// dq (B, T, H, Dh) contiguous from q, k, v (strided as for the forward), dout
// (B, T, H, Dh) contiguous, and the forward's lse and delta = rowsum(dO * O),
// both (B*H, T) float32. Float32 at Dh 64 only (is_bf16 = 0).
extern "C" int fedml_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                              const float* lse, const float* delta, void* dq, int B, int H, int T,
                              int Dh, int is_bf16, int causal, long long sb, long long st,
                              long long sh, float scale, void* stream) {
  if (!args_ok(B, H, T) || Dh != 64 || is_bf16) return (int)cudaErrorInvalidValue;
  const Args a{B, H, T, sb, st, sh, scale, causal};
  return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, a, (cudaStream_t)stream);
}

// dk and dv (B, T, H, Dh) contiguous, from the same inputs as dq. Float32
// at Dh 64 only (is_bf16 = 0).
extern "C" int fedml_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, void* dk, void* dv, int B,
                               int H, int T, int Dh, int is_bf16, int causal, long long sb,
                               long long st, long long sh, float scale, void* stream) {
  if (!args_ok(B, H, T) || Dh != 64 || is_bf16) return (int)cudaErrorInvalidValue;
  const Args a{B, H, T, sb, st, sh, scale, causal};
  return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, a, (cudaStream_t)stream);
}
