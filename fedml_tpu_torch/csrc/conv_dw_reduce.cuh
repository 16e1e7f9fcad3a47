// The second pass of the 3x3 conv's weight gradient, shared by its FMA
// kernel (conv3x3.cu) and its bf16 tensor-core kernel (conv3x3_sm90.cu):
// the float32 partials of a lane's pixel spans are added in the fixed order
// s = 0..S-1 and rounded once to the weights' dtype. The order is part of
// the dw contract: no atomics, so dw repeats bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void round_to(float v, float* p) { *p = v; }
__device__ __forceinline__ void round_to(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}

// dw[l, e] = sum over s = 0..splits-1 of part[l, s, e], in that order, in
// float32, rounded once to T
template <class T>
__global__ void conv3x3_dw_reduce_kernel(const float* __restrict__ part, int64_t kn,
                                         int splits, int64_t total, T* __restrict__ dw) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t lane = e / kn, r = e - lane * kn;
  const float* src = part + lane * splits * kn + r;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += src[(int64_t)s * kn];
  round_to(acc, dw + e);
}

// launches it over L lanes of kn weights each
template <class T>
cudaError_t launch_dw_reduce(const float* part, int64_t kn, int splits, int L, T* dw,
                             cudaStream_t st) {
  const int64_t total = kn * L;
  conv3x3_dw_reduce_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(part, kn, splits,
                                                                               total, dw);
  return cudaGetLastError();
}

}  // namespace
