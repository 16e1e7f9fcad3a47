// Gram matrix Z @ Z^T of the flat cohort stack, for the fused sanitize+Krum.
//
// Replaces: fedml_tpu/ops/pallas/agg_robust.py::fused_gram (Pallas kernel
// _gram_kernel), which tiles only the (C, C) output and contracts over the
// full D per tile.
//
// Bound on the H100: at the main path's shape, C = 10 clients and D = 1.66 M
// parameters, the output is 100 floats and the work is one 66.5 MB read: bytes
// (~20 us at 3.35 TB/s; the 0.33 GFLOP of fp32 FMAs take ~5 us at 67 TFLOP/s).
// At C = 1000 the 2*C^2*D fp32 operations bound it instead.
//
// Two routes, both IEEE fp32 on the CUDA cores (no TF32: the Gram feeds
// Krum's distances), both without atomics, so a result repeats bit for bit:
//
// Small cohorts, 1 <= C <= 16 (gram_small_partial_kernel<C>): the kernel
// must read each element once at the memory's rate. A block walks a span of
// column groups of all C rows in tiles of 256 groups (1024 columns). A
// two-stage ring in shared memory keeps the next tile's loads in flight
// (cp.async, 16 bytes each, no registers held) while the threads multiply the
// current one: a thread takes one group of 4 consecutive columns per tile,
// reads its C rows' values from shared memory and keeps the C(C+1)/2
// upper-triangle sums in registers (the kernel is a template on C),
// multiplied in a fixed order: column, then row i, then row j >= i. A row
// whose start is not 16-byte aligned (D mod 4 != 0) is copied in the aligned
// 16-byte pieces that cover the tile, and read back from its offset. The 4..7
// columns past the last whole group are read one by one by the grid's last
// block. Each block then sums its threads in a fixed tree (warp shuffles,
// then its eight warps through shared memory) into one partial per triangle
// entry, and gram_small_reduce_kernel sums the blocks' partials with one warp
// per entry in a fixed tree and writes it to both mirror positions, so G is
// exactly symmetric.
//
// Larger cohorts (gram_partial_kernel): block (ti, tj, s) computes the 16x16
// output tile (ti, tj) over the s-th column span of D, staging 16 rows of each
// operand, 64 columns at a time, in shared memory, one output element per
// thread with a sequential fmaf chain. gram_tiled_reduce_kernel sums the S
// partial tiles of an element with one warp in a fixed tree (with S = 1 the
// partial kernel writes G itself). G[i][j] and G[j][i] multiply the same pairs
// in the same order, so G is exactly symmetric here too.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;

// ---------------------------------------------------------------- small C

constexpr int kSmallMaxC = 16;
constexpr int kSmallThreads = 256;
constexpr int kSmallWarps = kSmallThreads / 32;

constexpr int kTileGroups = kSmallThreads;  // one group of 4 columns per thread
constexpr int kPieces = kTileGroups + 1;      // 16-byte pieces per row and tile
constexpr int kRowFloats = 4 * kPieces;       // a row's slot in a stage

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the first float of row r's slot sits this many floats before column 4 g0:
// the row's offset from 16-byte alignment, the same for every column group
__device__ __forceinline__ int row_shift(const float* row) {
  return (int)(((uintptr_t)row >> 2) & 3);
}

// Stage the groups [g0, g1) of all C rows: piece k of row r holds the
// floats at row + 4 g0 - s + 4k. Pieces from column 4 g1 on are not needed.
// Every piece read lies inside x: 4 g1 <= 4 nbody <= D - 4, and a row's
// first piece reaches back only into the row before (row 0 has s = 0).
template <int C>
__device__ __forceinline__ void stage_tile(float* stage, const float* __restrict__ x, int64_t D,
                                           int64_t g0, int64_t g1) {
  for (int idx = threadIdx.x; idx < C * kPieces; idx += kSmallThreads) {
    const int r = idx / kPieces, k = idx - r * kPieces;
    const float* row = x + r * D;
    const int64_t col = 4 * g0 - row_shift(row) + 4 * k;
    if (col < 4 * g1) cp_async16(stage + r * kRowFloats + 4 * k, row + col);
  }
}

template <int C>
__device__ __forceinline__ void accumulate(float (&acc)[C * (C + 1) / 2],
                                           const float (&v)[C]) {
  int p = 0;
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int j = i; j < C; ++j, ++p) acc[p] = fmaf(v[i], v[j], acc[p]);
}

template <int C>
constexpr size_t small_smem_bytes() {
  return 2 * (size_t)C * kRowFloats * sizeof(float);
}

// x (C, D), 16-byte aligned. Column groups [4q, 4q + 4) for q < nbody (4 *
// nbody + 4 <= D); block b takes groups [b * per_block, (b + 1) *
// per_block), the last block also the tail columns [4 * nbody, D). partial
// is (P, gridDim.x), P = C(C+1)/2. Dynamic shared memory: the two stages.
// Up to C = 10 the P + 4C live floats fit in 128 registers: two blocks per SM.
template <int C>
__global__ void __launch_bounds__(kSmallThreads, C <= 10 ? 2 : 1)
gram_small_partial_kernel(const float* __restrict__ x, int64_t D, int64_t nbody,
                          int64_t per_block, float* __restrict__ partial) {
  constexpr int P = C * (C + 1) / 2;
  extern __shared__ float4 ring4[];
  float* ring = reinterpret_cast<float*>(ring4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[P];
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0.0f;

  const int64_t q0 = (int64_t)blockIdx.x * per_block;
  const int64_t q1 = q0 + per_block < nbody ? q0 + per_block : nbody;
  const int tiles = q1 > q0 ? (int)((q1 - q0 + kTileGroups - 1) / kTileGroups) : 0;
  if (tiles > 0) stage_tile<C>(ring, x, D, q0, q0 + kTileGroups < q1 ? q0 + kTileGroups : q1);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int64_t g0 = q0 + (int64_t)t * kTileGroups;
    const int64_t g1 = g0 + kTileGroups < q1 ? g0 + kTileGroups : q1;
    if (t + 1 < tiles)  // the next tile goes to the stage read two tiles ago
      stage_tile<C>(ring + ((t + 1) & 1) * C * kRowFloats, x, D, g1,
                    g1 + kTileGroups < q1 ? g1 + kTileGroups : q1);
    cp_async_commit();      // an empty group on the last tile: the wait below
    cp_async_wait_prior();  // still means "this tile's pieces have landed"
    __syncthreads();
    if (g0 + threadIdx.x < g1) {
      const float* stage = ring + (t & 1) * C * kRowFloats + 4 * threadIdx.x;
      float v[4][C];
#pragma unroll
      for (int r = 0; r < C; ++r) {
        const int s = row_shift(x + r * D);  // uniform: aligned rows read 16 bytes
        const float* at = stage + r * kRowFloats + s;
        float4 a;
        if (s == 0) {
          a = *reinterpret_cast<const float4*>(at);
        } else if (s == 2) {
          const float2 lo = *reinterpret_cast<const float2*>(at);
          const float2 hi = *reinterpret_cast<const float2*>(at + 2);
          a = make_float4(lo.x, lo.y, hi.x, hi.y);
        } else {
          a = make_float4(at[0], at[1], at[2], at[3]);
        }
        v[0][r] = a.x;
        v[1][r] = a.y;
        v[2][r] = a.z;
        v[3][r] = a.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) accumulate<C>(acc, v[c]);
    }
    __syncthreads();  // the stage is free for the tile after next
  }
  if (blockIdx.x == gridDim.x - 1) {
    for (int64_t k = 4 * nbody + threadIdx.x; k < D; k += kSmallThreads) {
      float v[C];
#pragma unroll
      for (int r = 0; r < C; ++r) v[r] = x[r * D + k];
      accumulate<C>(acc, v);
    }
  }

  __shared__ float red[kSmallWarps][P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    float t = acc[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(kFull, t, off);
    if (lane == 0) red[warp][p] = t;
  }
  __syncthreads();
  static_assert(kSmallWarps == 8, "the block tree below sums eight warps");
  for (int p = threadIdx.x; p < P; p += kSmallThreads)
    partial[(int64_t)p * gridDim.x + blockIdx.x] =
        ((red[0][p] + red[1][p]) + (red[2][p] + red[3][p])) +
        ((red[4][p] + red[5][p]) + (red[6][p] + red[7][p]));
}

// one warp per triangle entry p: lane l sums blocks l, l + 32, ... in order,
// then a shuffle tree; the entry goes to G[i][j] and G[j][i]
__global__ void gram_small_reduce_kernel(const float* __restrict__ partial, int C,
                                         int nblocks, float* __restrict__ out) {
  const int p = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (p >= C * (C + 1) / 2) return;  // uniform across the warp
  const float* src = partial + (int64_t)p * nblocks;
  float t = 0.0f;
  for (int b = lane; b < nblocks; b += 32) t += src[b];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(kFull, t, off);
  if (lane == 0) {
    int i = 0, k = p;  // p = (entries of rows < i) + (j - i)
    while (k >= C - i) {
      k -= C - i;
      ++i;
    }
    const int j = i + k;
    out[i * C + j] = t;
    out[j * C + i] = t;
  }
}

template <int C>
cudaError_t launch_small(const float* x, int64_t D, int64_t nbody, int64_t per_block,
                         int nblocks, float* partial, float* out, cudaStream_t st) {
  constexpr size_t smem = small_smem_bytes<C>();
  cudaError_t err = cudaFuncSetAttribute(gram_small_partial_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  gram_small_partial_kernel<C><<<nblocks, kSmallThreads, smem, st>>>(x, D, nbody, per_block,
                                                                     partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int P = C * (C + 1) / 2;
  gram_small_reduce_kernel<<<(P * 32 + 255) / 256, 256, 0, st>>>(partial, C, nblocks, out);
  return cudaGetLastError();
}

using SmallLaunch = cudaError_t (*)(const float*, int64_t, int64_t, int64_t, int, float*,
                                    float*, cudaStream_t);

constexpr SmallLaunch kSmall[kSmallMaxC] = {
    &launch_small<1>,  &launch_small<2>,  &launch_small<3>,  &launch_small<4>,
    &launch_small<5>,  &launch_small<6>,  &launch_small<7>,  &launch_small<8>,
    &launch_small<9>,  &launch_small<10>, &launch_small<11>, &launch_small<12>,
    &launch_small<13>, &launch_small<14>, &launch_small<15>, &launch_small<16>};

// ---------------------------------------------------------------- tiled

constexpr int kTile = 16;
constexpr int kCols = 64;

__global__ void __launch_bounds__(kTile * kTile)
gram_partial_kernel(const float* __restrict__ x, int64_t C, int64_t D, int64_t span,
                    float* __restrict__ partial) {
  __shared__ float a[kTile][kCols + 1];
  __shared__ float b[kTile][kCols + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int64_t i0 = (int64_t)blockIdx.x * kTile;
  const int64_t j0 = (int64_t)blockIdx.y * kTile;
  const int64_t k0 = (int64_t)blockIdx.z * span;
  const int64_t k1 = k0 + span < D ? k0 + span : D;
  float acc = 0.0f;
  for (int64_t kb = k0; kb < k1; kb += kCols) {
    for (int idx = tid; idx < kTile * kCols; idx += kTile * kTile) {
      const int r = idx / kCols, c = idx % kCols;
      const int64_t col = kb + c;
      const bool in = col < k1;
      a[r][c] = (in && i0 + r < C) ? x[(i0 + r) * D + col] : 0.0f;
      b[r][c] = (in && j0 + r < C) ? x[(j0 + r) * D + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll 16
    for (int c = 0; c < kCols; ++c) acc = fmaf(a[ty][c], b[tx][c], acc);
    __syncthreads();
  }
  const int64_t i = i0 + ty, j = j0 + tx;
  if (i < C && j < C) partial[((int64_t)blockIdx.z * C + i) * C + j] = acc;
}

// one warp per output element: lane l sums spans l, l + 32, ... in order,
// then a shuffle tree
__global__ void gram_tiled_reduce_kernel(const float* __restrict__ partial, int64_t cc,
                                         int64_t splits, float* __restrict__ out) {
  const int64_t e = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (e >= cc) return;  // uniform across the warp
  float t = 0.0f;
  for (int64_t s = lane; s < splits; s += 32) t += partial[s * cc + e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_down_sync(kFull, t, off);
  if (lane == 0) out[e] = t;
}

}  // namespace

// Small route, 1 <= C <= 16. x (C, D) f32, 16-byte aligned; partial (C(C+1)/2,
// nblocks) f32 scratch; out (C, C) f32; all contiguous on the device. nbody =
// (D - 4) / 4 for D >= 8, else 0; nblocks * per_block >= nbody, with no block
// empty. Returns the cudaError_t of the launches.
extern "C" int fedml_gram_small(const float* x, long long C, long long D, long long nbody,
                                long long per_block, long long nblocks, float* partial,
                                float* out, void* stream) {
  if (C < 1 || C > kSmallMaxC || D < 1 || nbody != (D >= 8 ? (D - 4) / 4 : 0) ||
      nblocks < 1 || nblocks > 0x7FFFFFFFLL || per_block < 0 || nblocks * per_block < nbody ||
      (nbody > 0 && (nblocks - 1) * per_block >= nbody) || ((uintptr_t)x & 15) != 0)
    return (int)cudaErrorInvalidValue;
  return (int)kSmall[C - 1](x, D, nbody, per_block, (int)nblocks, partial, out,
                            (cudaStream_t)stream);
}

// Tiled route. x (C, D) f32, partial (splits, C, C) f32 scratch (unused when
// splits is 1), out (C, C) f32, all contiguous on the device; span is a
// multiple of 64 with splits = ceil(D / span) <= 65535. Returns the
// cudaError_t of the launches.
extern "C" int fedml_gram(const float* x, long long C, long long D, long long span,
                          long long splits, float* partial, float* out, void* stream) {
  if (C <= 0 || D <= 0 || span <= 0 || splits <= 0 || splits > 65535 ||
      (splits - 1) * span >= D)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (C + kTile - 1) / kTile;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  gram_partial_kernel<<<dim3((unsigned)tiles, (unsigned)tiles, (unsigned)splits),
                        dim3(kTile, kTile), 0, st>>>(x, C, D, span,
                                                     splits == 1 ? out : partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t cc = C * C;
  const int64_t blocks = (cc * 32 + 255) / 256;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  gram_tiled_reduce_kernel<<<(unsigned)blocks, 256, 0, st>>>(partial, cc, splits, out);
  return (int)cudaGetLastError();
}
