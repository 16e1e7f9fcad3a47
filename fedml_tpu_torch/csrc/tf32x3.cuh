// Float32 products on the Hopper tensor cores as three TF32 products
// (3xTF32), shared by the float32 conv forward (conv3x3_sm90.cu) and the
// float32 flash kernels (flash_f32_sm90.cu, flash_wide_f32_sm90.cu; split4
// and mma3 are theirs). conv3x3_sm90.cu's header states the error analysis:
// a_lo b_hi + a_hi b_lo + a_hi b_hi differs from a b by at most ~1.2e-6 of
// the magnitudes.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// v = hi + lo: hi = cvt.rna.tf32.f32(v), computed on the integer units
// (round the float32 bits at mantissa bit 13, ties away from zero: the same
// bits for every finite v), and lo = v - hi, exact in float32, which the
// tensor core reads as TF32 by dropping its low 13 bits
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the splits of four registers that ldmatrix loaded (float32 bits)
__device__ __forceinline__ void split4(const uint32_t (&r)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), hi[i], lo[i]);
}

// x += a b in three TF32 products, small terms first
__device__ __forceinline__ void mma3(float (&x)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(x, al, bh);
  mma_tf32(x, ah, bl);
  mma_tf32(x, ah, bh);
}

}  // namespace
