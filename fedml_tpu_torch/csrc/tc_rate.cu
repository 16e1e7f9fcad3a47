// Calibration, not a kernel of the port: the rate at which this card runs
// mma.sync.m16n8k8 with TF32 operands and float32 sums, the instruction of
// conv3x3_sm90.cu, against the dense TF32 peak (wgmma's) that chip_smoke.py
// counts in the conv's bound. Each warp issues `iters` rounds of kChains
// independent accumulator chains, three mma in a row on each (as the conv
// issues lo hi, hi lo, hi hi), from registers: no memory traffic. The bf16
// probe does the same with mma.sync.m16n8k16 on bf16 operands, the
// instruction of the bf16 conv kernel, against the dense bf16 peak. The
// wgmma probe issues TF32 wgmma.m64nNk8 (flash_f32_wgmma_sm90.cu's score
// products) with B, and A too unless it comes from registers, read from a
// 128-byte-swizzled K-major tile in shared memory: one warpgroup a block,
// two blocks an SM, 48 products a commit group, three a k step as the
// three TF32 products issue them.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"
#include "wgmma_tf32.cuh"

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

constexpr int kWgmmaGroup = 48;  // products a commit group: 4 k steps x 3 terms x 4

template <int N, bool RS>
__global__ void __launch_bounds__(128) wgmma_rate_kernel(float* out, int iters) {
  extern __shared__ uint8_t wg_smem[];
  uint8_t* base = align1024(wg_smem);  // A: 64 rows x 128 bytes, then B: N rows
  for (int i = threadIdx.x; i < (64 + N) * 32; i += 128) reinterpret_cast<float*>(base)[i] = 0.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t a = smem_addr(base), b = a + 64 * kRowBytes;
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  const uint32_t ar[4] = {0u, 0u, 0u, 0u};
  for (int it = 0; it < iters; ++it) {
    wg_fence();
#pragma unroll
    for (int rep = 0; rep < kWgmmaGroup / 12; ++rep)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          if constexpr (RS)
            WgTf32<N>::rs(d, ar, desc_k<N>(b, kk), 1);
          else
            WgTf32<N>::ss(d, desc_k<64>(a, kk), desc_k<N>(b, kk), 1);
        }
    wg_commit();
    wg_wait<0>();
    pin(d);
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s += d[i];
  out[blockIdx.x * 128 + threadIdx.x] = s;
}

template <int N, bool RS>
cudaError_t launch_wgmma_rate(float* out, int blocks, int iters, cudaStream_t s) {
  wgmma_rate_kernel<N, RS><<<blocks, 128, (64 + N) * kRowBytes + 1024, s>>>(out, iters);
  return cudaGetLastError();
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

// The wgmma probe: blocks of one warpgroup (out holds blocks * 128 floats),
// TF32 wgmma.m64nNk8 at n = 16, 32 or 64, A from registers when rs != 0.
extern "C" int fedml_wgmma_tf32_rate(float* out, int blocks, int n, int rs, int iters,
                                     void* stream) {
  if (blocks <= 0 || iters <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n * 2 + (rs ? 1 : 0)) {
    case 32: return (int)launch_wgmma_rate<16, false>(out, blocks, iters, s);
    case 33: return (int)launch_wgmma_rate<16, true>(out, blocks, iters, s);
    case 64: return (int)launch_wgmma_rate<32, false>(out, blocks, iters, s);
    case 65: return (int)launch_wgmma_rate<32, true>(out, blocks, iters, s);
    case 128: return (int)launch_wgmma_rate<64, false>(out, blocks, iters, s);
    case 129: return (int)launch_wgmma_rate<64, true>(out, blocks, iters, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" long long fedml_wgmma_tf32_rate_ops(int blocks, int n, int iters) {
  return (long long)blocks * iters * kWgmmaGroup * (2LL * 64 * n * 8);
}
