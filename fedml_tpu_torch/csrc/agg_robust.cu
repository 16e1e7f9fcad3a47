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
// Design: a kernel that tiled only the output would run one or two blocks at
// C = 10. So the contraction is split as well: block (ti, tj, s) computes the
// 16x16 output tile (ti, tj) over the s-th column span of D, staging 16 rows
// of each operand, 64 columns at a time, in shared memory, one output element
// per thread with a sequential fmaf chain. The wrapper picks the number of
// spans so that the grid holds about 8 blocks per SM. A second kernel sums the
// S partial tiles of each element in the fixed order s = 0..S-1: no atomics,
// so a result repeats bit for bit from run to run. Tiles and spans are
// masked at their ragged edges (any C >= 1, any D >= 1). The arithmetic is
// IEEE fp32 on the CUDA cores; no TF32. G[i][j] and G[j][i] multiply the same
// pairs in the same order, so G is exactly symmetric.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__global__ void gram_reduce_kernel(const float* __restrict__ partial, int64_t cc,
                                   int64_t splits, float* __restrict__ out) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cc) return;
  float acc = 0.0f;
  for (int64_t s = 0; s < splits; ++s) acc += partial[s * cc + e];
  out[e] = acc;
}

}  // namespace

// x (C, D) f32, partial (splits, C, C) f32 scratch, out (C, C) f32, all
// contiguous on the device; span is a multiple of 64 with
// splits = ceil(D / span) <= 65535. Returns the cudaError_t of the launches.
extern "C" int fedml_gram(const float* x, long long C, long long D, long long span,
                          long long splits, float* partial, float* out, void* stream) {
  if (C <= 0 || D <= 0 || span <= 0 || splits <= 0 || splits > 65535 ||
      (splits - 1) * span >= D)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (C + kTile - 1) / kTile;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  gram_partial_kernel<<<dim3((unsigned)tiles, (unsigned)tiles, (unsigned)splits),
                        dim3(kTile, kTile), 0, st>>>(x, C, D, span, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t cc = C * C;
  gram_reduce_kernel<<<(unsigned)((cc + 255) / 256), 256, 0, st>>>(partial, cc, splits, out);
  return (int)cudaGetLastError();
}
