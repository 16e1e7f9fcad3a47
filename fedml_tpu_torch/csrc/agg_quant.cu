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
// Design: one warp per (row, 256-chunk), eight warps per block. Lane l owns
// elements chunk*256 + k*32 + l, k = 0..7, so every load and every f32/int8
// store of the warp is one contiguous, coalesced segment. The chunk absmax is
// a NaN-propagating shuffle reduction inside the warp, so no shared memory
// and no second pass are needed. For q4, the partner element of a byte sits in
// the neighbouring lane and arrives by one shuffle. Elements past m are zeros,
// which floor to level 0 (nibble 8) exactly as the reference's zero padding.
// Division is __fdiv_rn (IEEE) and the file is built without fast-math: the
// output must equal the reference byte for byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;
constexpr int kWarpsPerBlock = 8;
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

template <int BITS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
quantize_pack_kernel(const float* __restrict__ vals, const uint32_t* __restrict__ cids,
                     int64_t C, int64_t m, int64_t nchunk, uint32_t h_round,
                     uint32_t leaf_hash, uint8_t* __restrict__ packed,
                     float* __restrict__ scales, float* __restrict__ dec) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp >= C * nchunk) return;  // uniform across the warp
  const int64_t row = warp / nchunk;
  const int64_t chunk = warp - row * nchunk;
  const uint32_t key = mix32(mix32(h_round ^ cids[row]) ^ leaf_hash);
  const float* v_row = vals + row * m;
  const int64_t base = chunk * kChunk + lane;

  float v[8];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t e = base + k * 32;
    v[k] = e < m ? v_row[e] : 0.0f;
    amax = nanmax(amax, fabsf(v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = nanmax(amax, __shfl_xor_sync(kFull, amax, off));

  const float bound = BITS == 8 ? 127.0f : 7.0f;
  const float s = pow2_scale(amax, BITS == 8 ? 6 : 2);
  if (lane == 0) scales[row * nchunk + chunk] = s;

  const int64_t nbytes = BITS == 8 ? m : (m + 1) / 2;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t e = base + k * 32;
    const uint32_t h = mix32((uint32_t)e ^ key);
    const float u = __fmul_rn((float)(h >> 8), 1.0f / 16777216.0f);
    const float t = floorf(__fadd_rn(__fdiv_rn(v[k], s), u));
    const float qf = isnan(t) ? 0.0f : fminf(fmaxf(t, -bound), bound);
    const int q = (int)qf;
    if (e < m) dec[row * m + e] = __fmul_rn((float)q, s);
    if (BITS == 8) {
      if (e < m) packed[row * nbytes + e] = (uint8_t)(int8_t)q;
    } else {
      const int partner = __shfl_xor_sync(kFull, q, 1);
      const int64_t b = e >> 1;  // e is even on even lanes
      if (!(lane & 1) && b < nbytes)
        packed[row * nbytes + b] = (uint8_t)(((q + 8) << 4) | (partner + 8));
    }
  }
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
  const int64_t blocks = (C * nchunk + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bits == 8)
    quantize_pack_kernel<8><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, st>>>(
        vals, cids, C, m, nchunk, h_round, leaf_hash, (uint8_t*)packed, scales, dec);
  else
    quantize_pack_kernel<4><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, st>>>(
        vals, cids, C, m, nchunk, h_round, leaf_hash, (uint8_t*)packed, scales, dec);
  return (int)cudaGetLastError();
}
