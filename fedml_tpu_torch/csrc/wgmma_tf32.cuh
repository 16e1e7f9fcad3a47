// TF32 wgmma (m64nNk8, float32 sums) for N = 16, 32 and 64, shared by the
// float32 flash backward on wgmma (flash_f32_wgmma_sm90.cu) and the rate
// probe (tc_rate.cu). TF32 wgmma takes K-major operands only: B from
// shared memory through a descriptor, A from shared memory (ss) or from
// registers (rs: the m16n8k8 A fragment of the warp's 16 rows). The
// accumulator is the m64nN float32 layout: warp w holds rows 16 w + g and
// 16 w + g + 8, and d[4 j + e] is row g (e < 2) or g + 8 at column 8 j + 2 t
// + (e & 1).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#define WGT_F8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define WGT_D8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define WGT_D16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WGT_D32                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

template <int N>
struct WgTf32;

// d (64 x N) = (acc ? d : 0) + A B^T over 8 columns of K
template <>
struct WgTf32<16> {
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " WGT_D8 ", %8, %9, p, 1, 1;\n"
        "}\n"
        : WGT_F8(0)
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 " WGT_D8
        ", {%8, %9, %10, %11}, %12, p, 1, 1;\n"
        "}\n"
        : WGT_F8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct WgTf32<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WGT_D16 ", %16, %17, p, 1, 1;\n"
        "}\n"
        : WGT_F8(0), WGT_F8(8)
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WGT_D16
        ", {%16, %17, %18, %19}, %20, p, 1, 1;\n"
        "}\n"
        : WGT_F8(0), WGT_F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <>
struct WgTf32<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WGT_D32 ", %32, %33, p, 1, 1;\n"
        "}\n"
        : WGT_F8(0), WGT_F8(8), WGT_F8(16), WGT_F8(24)
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WGT_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
        "}\n"
        : WGT_F8(0), WGT_F8(8), WGT_F8(16), WGT_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

#undef WGT_F8
#undef WGT_D8
#undef WGT_D16
#undef WGT_D32

}  // namespace
