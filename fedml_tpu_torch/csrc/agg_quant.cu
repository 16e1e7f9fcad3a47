// Fused stochastic quantize + wire pack + decode for the codec's q8/q4 stage.
//
// Replaces: fedml_tpu/ops/pallas/agg_quant.py::fused_quantize_pack (Pallas
// kernel _quantize_pack_kernel). It computes exactly _reference_quantize_pack
// of that module: per row (client) r and element e of a (C, m) f32 stack,
//   u   = (lowbias32(e ^ key_r) >> 8) * 2^-24,   key_r from (seed, round,
//         client id, leaf hash) by the codec.stochastic_key chain,
//   s   = 2^(frexp_exp(absmax of the 256-chunk) - eb), eb = 6 (q8) / 2 (q4),
//         built from the exponent bits (_pow2_scale_bits),
//   q   = clip(floor(v / s + u), -bound, bound), NaN -> 0 (XLA's f32->int),
//   dec = q * s,
// and writes the int8 bytes (q8) or nibble-packed bytes (q4: first element in
// the high nibble, bias +8), the per-chunk scales and the decoded stack.
//
// Bound on the H100: bytes. Per element it reads 4 bytes and writes 5 (q8) or
// 4.5 (q4) bytes, with ~25 integer/float operations; at 3.35 TB/s the memory
// is the limit by a wide margin.
//
// Design: a warp takes one (row, 256-chunk) at a time, blocks of eight warps
// walk a row's chunks in a grid-stride loop (blockIdx.y picks the row, so the
// row's key is mixed once per warp, outside the loop). Lane l owns the eight
// consecutive elements chunk*256 + 8l .. 8l+7: it loads them as two 16-byte
// loads, stores its decoded values as two 16-byte stores and its bytes as one
// 8-byte word (q8) or one 4-byte word of nibbles (q4; the pairs of a byte are
// the lane's own). A row of m elements, m not a multiple of 8, takes the same
// ownership with one-element loads and stores (VEC = false). The chunk absmax
// is a NaN-propagating shuffle reduction inside the warp. Elements past m are
// zeros, which floor to level 0 (nibble 8) exactly as the reference's zero
// padding. The hash takes the element's index in its row, so which lane owns
// an element changes no value.
//
// v / s is computed as v * (1 / s): every scale is a power of two 2^e2 with
// -126 <= e2 <= 126, or 0 (a flushed subnormal absmax), or 1.0, so 1 / s is
// exact (2^-e2, +inf for 0) and both sides are the correctly rounded value of
// the same exact quotient (+inf gives the division's +-inf and NaN). The file
// is built without fast-math (no flush to zero, no contraction of the
// __fmul_rn/__fadd_rn pair): the output equals the reference byte for byte.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kChunk = 256;
constexpr int kWarpsPerBlock = 8;
constexpr int64_t kTargetBlocks = 132 * 8;  // eight 256-thread blocks fill an H100 SM
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// max that propagates NaN, as jnp.max does
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float pow2_scale(float amax, int eb) {
  const uint32_t bits = __float_as_uint(amax);
  const int be = (bits >> 23) & 0xFF;
  const int ea = be == 255 ? 0 : (be == 0 ? -149 : be - 126);
  const int e2 = ea - eb;
  const float s = e2 >= -126 ? __uint_as_float((uint32_t)(e2 + 127) << 23) : 0.0f;
  return amax > 0.0f ? s : 1.0f;
}

template <int BITS, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
quantize_pack_kernel(const float* __restrict__ vals, const uint32_t* __restrict__ cids,
                     int64_t C, int64_t m, int64_t nchunk, uint32_t h_round,
                     uint32_t leaf_hash, uint8_t* __restrict__ packed,
                     float* __restrict__ scales, float* __restrict__ dec) {
  const int lane = threadIdx.x & 31;
  const int64_t warp0 = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t nbytes = BITS == 8 ? m : (m + 1) / 2;
  const float bound = BITS == 8 ? 127.0f : 7.0f;
  for (int64_t row = blockIdx.y; row < C; row += gridDim.y) {
    const uint32_t key = mix32(mix32(h_round ^ cids[row]) ^ leaf_hash);
    const float* v_row = vals + row * m;
    for (int64_t chunk = warp0; chunk < nchunk; chunk += warps) {  // uniform across the warp
      const int64_t e0 = chunk * kChunk + 8 * lane;
      float v[8];
      if (VEC) {  // m % 8 == 0: the lane's eight elements are all in or all out
        float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
        if (e0 < m) {
          lo = __ldg(reinterpret_cast<const float4*>(v_row + e0));
          hi = __ldg(reinterpret_cast<const float4*>(v_row + e0 + 4));
        }
        v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
        v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = e0 + k < m ? v_row[e0 + k] : 0.0f;
      }
      float amax = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; ++k) amax = nanmax(amax, fabsf(v[k]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        amax = nanmax(amax, __shfl_xor_sync(kFull, amax, off));

      const float s = pow2_scale(amax, BITS == 8 ? 6 : 2);
      const float inv = __frcp_rn(s);  // exact: s is a power of two or 0
      if (lane == 0) scales[row * nchunk + chunk] = s;

      int q[8];
      float d[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint32_t h = mix32((uint32_t)(e0 + k) ^ key);
        const float u = __fmul_rn((float)(h >> 8), 1.0f / 16777216.0f);
        const float t = floorf(__fadd_rn(__fmul_rn(v[k], inv), u));
        const float qf = isnan(t) ? 0.0f : fminf(fmaxf(t, -bound), bound);
        q[k] = (int)qf;
        d[k] = __fmul_rn((float)q[k], s);
      }

      float* d_row = dec + row * m;
      uint8_t* p_row = packed + row * nbytes;
      if (VEC) {
        if (e0 < m) {
          *reinterpret_cast<float4*>(d_row + e0) = make_float4(d[0], d[1], d[2], d[3]);
          *reinterpret_cast<float4*>(d_row + e0 + 4) = make_float4(d[4], d[5], d[6], d[7]);
          if (BITS == 8) {
            uint32_t w[2];
#pragma unroll
            for (int half = 0; half < 2; ++half)
              w[half] = (uint32_t)(uint8_t)q[4 * half] | (uint32_t)(uint8_t)q[4 * half + 1] << 8 |
                        (uint32_t)(uint8_t)q[4 * half + 2] << 16 |
                        (uint32_t)(uint8_t)q[4 * half + 3] << 24;
            *reinterpret_cast<uint2*>(p_row + e0) = make_uint2(w[0], w[1]);
          } else {
            uint32_t w = 0;
#pragma unroll
            for (int b = 0; b < 4; ++b)
              w |= (uint32_t)(((q[2 * b] + 8) << 4) | (q[2 * b + 1] + 8)) << (8 * b);
            *reinterpret_cast<uint32_t*>(p_row + e0 / 2) = w;
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int64_t e = e0 + k;
          if (e < m) d_row[e] = d[k];
          if (BITS == 8) {
            if (e < m) p_row[e] = (uint8_t)(int8_t)q[k];
          } else if (k % 2 == 0 && e < m) {  // e is even; its partner is past m or in the lane
            p_row[e / 2] = (uint8_t)(((q[k] + 8) << 4) | (q[k + 1] + 8));
          }
        }
      }
    }
  }
}

template <int BITS, bool VEC>
void launch(dim3 grid, cudaStream_t st, const float* vals, const uint32_t* cids, int64_t C,
            int64_t m, int64_t nchunk, uint32_t h_round, uint32_t leaf_hash, void* packed,
            float* scales, float* dec) {
  quantize_pack_kernel<BITS, VEC><<<grid, kWarpsPerBlock * 32, 0, st>>>(
      vals, cids, C, m, nchunk, h_round, leaf_hash, (uint8_t*)packed, scales, dec);
}

}  // namespace

// vals (C, m) f32, cids (C,) uint32, packed (C, m) int8 [q8] or
// (C, ceil(m/2)) uint8 [q4], scales (C, ceil(m/256)) f32, dec (C, m) f32, all
// contiguous on the device. h_round = mix32((seed ^ 0x9E3779B9) ^ round).
// Returns the cudaError_t of the launch.
extern "C" int fedml_quantize_pack(const float* vals, const uint32_t* cids, long long C,
                                   long long m, int bits, unsigned int h_round,
                                   unsigned int leaf_hash, void* packed, float* scales,
                                   float* dec, void* stream) {
  if (C <= 0 || m <= 0 || (bits != 8 && bits != 4)) return (int)cudaErrorInvalidValue;
  const int64_t nchunk = (m + kChunk - 1) / kChunk;
  // about eight blocks per SM over the whole stack; a warp then walks ~nchunk
  // / (grid.x * 8) chunks of its row
  const int64_t per_row = (kTargetBlocks + C - 1) / C;
  const int64_t gx = std::min<int64_t>((nchunk + kWarpsPerBlock - 1) / kWarpsPerBlock, per_row);
  const dim3 grid((unsigned)gx, (unsigned)std::min<int64_t>(C, 65535));
  const bool vec = m % 8 == 0 && ((uintptr_t)vals & 15) == 0 && ((uintptr_t)dec & 15) == 0 &&
                   ((uintptr_t)packed & 7) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (bits == 8 && vec)
    launch<8, true>(grid, st, vals, cids, C, m, nchunk, h_round, leaf_hash, packed, scales, dec);
  else if (bits == 8)
    launch<8, false>(grid, st, vals, cids, C, m, nchunk, h_round, leaf_hash, packed, scales, dec);
  else if (vec)
    launch<4, true>(grid, st, vals, cids, C, m, nchunk, h_round, leaf_hash, packed, scales, dec);
  else
    launch<4, false>(grid, st, vals, cids, C, m, nchunk, h_round, leaf_hash, packed, scales, dec);
  return (int)cudaGetLastError();
}
