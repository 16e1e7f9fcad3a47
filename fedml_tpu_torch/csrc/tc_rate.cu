// Calibration, not a kernel of the port: the rate at which this card runs
// mma.sync.m16n8k8 with TF32 operands and float32 sums, the instruction of
// conv3x3_sm90.cu, against the dense TF32 peak (wgmma's) that chip_smoke.py
// counts in the conv's bound. Each warp issues `iters` rounds of kChains
// independent accumulator chains, three mma in a row on each (as the conv
// issues lo hi, hi lo, hi hi), from registers: no memory traffic. The bf16
// probe does the same with mma.sync.m16n8k16 on bf16 operands, the
// instruction of the bf16 conv kernel, against the dense bf16 peak.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;

// BF16: mma.sync.m16n8k16 on bf16 operands, else m16n8k8 on TF32 ones
template <bool BF16>
__global__ void tc_rate_kernel(float* out, int iters) {
  float acc[kChains][4] = {};
  const uint32_t a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {5u, 7u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        if constexpr (BF16)
          asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
              "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
              : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
        else
          asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
              "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
              : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
              : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      }
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kChains; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// Launches blocks x threads; out holds blocks * threads floats. Operations:
// blocks * threads / 32 * iters * 3 * kChains mma of 2 * 16 * 8 * 8 each.
extern "C" int fedml_tc_rate(float* out, int blocks, int threads, int iters, void* stream) {
  if (blocks <= 0 || threads <= 0 || threads % 32 || iters <= 0) return (int)cudaErrorInvalidValue;
  tc_rate_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}

// operations one call does
extern "C" long long fedml_tc_rate_ops(int blocks, int threads, int iters) {
  return (long long)blocks * threads / 32 * iters * 3 * kChains * (2LL * 16 * 8 * 8);
}

// The bf16 probe: the same launch, mma of 2 * 16 * 8 * 16 operations each.
extern "C" int fedml_tc_rate_bf16(float* out, int blocks, int threads, int iters,
                                  void* stream) {
  if (blocks <= 0 || threads <= 0 || threads % 32 || iters <= 0) return (int)cudaErrorInvalidValue;
  tc_rate_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters);
  return (int)cudaGetLastError();
}

extern "C" long long fedml_tc_rate_bf16_ops(int blocks, int threads, int iters) {
  return 2 * fedml_tc_rate_ops(blocks, threads, iters);
}
