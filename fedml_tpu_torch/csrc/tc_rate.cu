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
// three TF32 products issue them. The cluster probe times the exchange of
// flash_f32_wgmma_sm90.cu's Dh-512 clusters alone: clusters of four blocks
// of 256 threads, each block with 226 KB of dynamic shared memory (one a
// SM, as the kernels run), each thread holding 16 floats of two 64 x 32
// float32 tiles in the accumulator's thread order, one exchange an
// iteration in one of the forms of fedml_cluster_exchange's `mode`.

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

constexpr int kClusterBlocks = 4;                // blocks of a cluster
constexpr int kClusterSmem = 226 * 1024;         // dynamic shared memory of a block
constexpr int kExchangeThreads = 256;            // two warpgroups
constexpr int kExchangeChunks = 4;               // 16-byte chunks a thread stores: 16 floats

__device__ __forceinline__ void cl_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cl_map(uint32_t a, uint32_t r) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(r));
  return d;
}

__device__ __forceinline__ float4 cl_ld(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_local(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_local(uint32_t a, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void st_async(uint32_t a, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(a),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// MODE 0 (pull): each thread stores its 16 floats locally, the cluster
// meets, each thread reads the same 16 floats of its three peers (mapa,
// ld.shared::cluster), the cluster meets again. MODE 1 and 2 (the kernels'
// exchange): a reduce-scatter and a gather of MODE tiles on mbarriers. Warp
// w of each warpgroup sends its 16 x 32 rows to block w % 4 (slot rank) by
// st.async, counted on that block's mbarrier full_r; block c's warps c add
// the four parts locally and send the sums of one tile (role 0) or of both
// (MODE 2: role 1 too) to every block, counted on each one's full_g; every
// warp waits on its own block's full_g and reads its rows' sums locally.
template <int MODE>
__global__ void __launch_bounds__(kExchangeThreads, 1)
cluster_exchange_kernel(float* out, int iters) {
  extern __shared__ uint8_t cx_smem[];
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, role = warp / 4, wr = warp % 4;
  const uint32_t base = smem_addr(cx_smem);
  // thread i's slot: chunk j at 16 (i + 256 j), a warp's accesses 512 contiguous bytes
  const uint32_t slot = base + 16 * tid;
  // MODE > 0: receive buffer [src rank][role][chunk][lane] x 16 bytes (16
  // KB); gather buffer after it: [role][row warp][chunk][lane] x 16 bytes
  const uint32_t recv = base, gath = base + 16384, full_r = base + 32768, full_g = full_r + 8;
  if constexpr (MODE > 0) {
    if (tid == 0) {
      mbar_init(full_r, 1);
      mbar_init(full_g, 1);
      mbar_expect(full_r, 16384);
      mbar_expect(full_g, MODE * 8192);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cl_sync();
  }
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    float4 x[kExchangeChunks];
#pragma unroll
    for (int j = 0; j < kExchangeChunks; ++j) {
      const float y = (float)(it + j + tid);
      x[j] = make_float4(y, y + 1.f, y + 2.f, y + 3.f);
    }
    if constexpr (MODE == 0) {
#pragma unroll
      for (int j = 0; j < kExchangeChunks; ++j) st_local(slot + 16 * kExchangeThreads * j, x[j]);
      cl_sync();
#pragma unroll
      for (int r = 1; r < kClusterBlocks; ++r) {
        const uint32_t at = cl_map(slot, (rank + r) % kClusterBlocks);
#pragma unroll
        for (int j = 0; j < kExchangeChunks; ++j) {
          const float4 v = cl_ld(at + 16 * kExchangeThreads * j);
          acc += (v.x + v.y) + (v.z + v.w);
        }
      }
      cl_sync();
    } else {
      const uint32_t to = cl_map(recv + 16 * (((rank * 2 + role) * 4) * 32 + lane), wr);
      const uint32_t rbar = cl_map(full_r, wr);
#pragma unroll
      for (int j = 0; j < kExchangeChunks; ++j) st_async(to + 16 * 32 * j, x[j], rbar);
      if (wr == (int)rank) {
        mbar_wait(full_r, it & 1);
        if (lane == 0 && role == 0) mbar_expect(full_r, 16384);
        float4 sum[kExchangeChunks];
#pragma unroll
        for (int r = 0; r < kClusterBlocks; ++r)
#pragma unroll
          for (int j = 0; j < kExchangeChunks; ++j) {
            const float4 v = ld_local(recv + 16 * (((r * 2 + role) * 4 + j) * 32 + lane));
            if (r == 0) sum[j] = v;
            else sum[j] = make_float4(sum[j].x + v.x, sum[j].y + v.y, sum[j].z + v.z,
                                      sum[j].w + v.w);
          }
        asm volatile("bar.sync 1, 64;\n" ::: "memory");  // the two owner warps meet
        if (MODE == 2 || role == 0) {
#pragma unroll
          for (int r = 0; r < kClusterBlocks; ++r) {
            const uint32_t at = cl_map(gath + 16 * (((role * 4 + wr) * 4) * 32 + lane), r);
            const uint32_t gbar = cl_map(full_g, r);
#pragma unroll
            for (int j = 0; j < kExchangeChunks; ++j) st_async(at + 16 * 32 * j, sum[j], gbar);
          }
        }
      }
      mbar_wait(full_g, it & 1);
      if (tid == 0) mbar_expect(full_g, MODE * 8192);
      const int gr = MODE == 2 ? role : 0;
#pragma unroll
      for (int j = 0; j < kExchangeChunks; ++j) {
        const float4 v = ld_local(gath + 16 * (((gr * 4 + wr) * 4 + j) * 32 + lane));
        acc += (v.x + v.y) + (v.z + v.w);
      }
    }
  }
  if constexpr (MODE > 0) cl_sync();  // no block leaves while its peers may still send
  out[blockIdx.x * kExchangeThreads + threadIdx.x] = acc;
}

// the cluster probe's launch configuration: clusters of four along x
struct ExchangeLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ExchangeLaunch(int clusters, cudaStream_t s) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kClusterBlocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(clusters * kClusterBlocks);
    cfg.blockDim = dim3(kExchangeThreads);
    cfg.dynamicSmemBytes = kClusterSmem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename Kernel>
int launch_exchange(Kernel kernel, const ExchangeLaunch& l, float* out, int iters) {
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterSmem);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&l.cfg, kernel, out, iters);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
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

// The cluster probe: `clusters` clusters of four blocks, `iters` exchanges
// each; out holds clusters * 4 * 256 floats. mode: 0 pull, 1 and 2
// reduce-scatter and gather of one or two tiles on mbarriers (MODE above).
extern "C" int fedml_cluster_exchange(float* out, int clusters, int iters, int mode,
                                      void* stream) {
  if (clusters <= 0 || iters <= 0) return (int)cudaErrorInvalidValue;
  ExchangeLaunch l(clusters, (cudaStream_t)stream);
  switch (mode) {
    case 0: return launch_exchange(cluster_exchange_kernel<0>, l, out, iters);
    case 1: return launch_exchange(cluster_exchange_kernel<1>, l, out, iters);
    case 2: return launch_exchange(cluster_exchange_kernel<2>, l, out, iters);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The probe's clusters the card holds at once (cudaOccupancyMaxActiveClusters
// at 226 KB a block), or minus the cudaError_t of the query.
extern "C" int fedml_cluster_exchange_clusters(void) {
  cudaError_t e = cudaFuncSetAttribute(cluster_exchange_kernel<0>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterSmem);
  if (e != cudaSuccess) return -(int)e;
  ExchangeLaunch l(1, 0);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)cluster_exchange_kernel<0>, &l.cfg);
  return e == cudaSuccess ? n : -(int)e;
}
