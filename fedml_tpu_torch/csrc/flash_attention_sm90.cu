// Flash attention's forward and its backward (dq; dk and dv) on the Hopper
// tensor cores (wgmma), for bfloat16 (B, T, H, Dh) inputs, causal or full,
// any T, at Dh 64 and 128. All three at Dh 256 are flash_dh256_sm90.cu's;
// float32 inputs keep the FMA kernels of flash_attention.cu.
//
// Replaces: fedml_tpu/ops/pallas/flash_attention.py — _flash_kernel (:66,
// the forward), _dq_kernel (:167, dq) and _dkv_kernel (:213, dk and dv).
// The arithmetic is the TPU kernels', which flash_attention.cu lists:
// finfo(float32).min masking, expf, l clamped at 1e-30, o = acc / l, lse =
// m + log l, p = exp(scale * q.k - lse), ds = p * (dO.v - delta).
//
// Exact to float32 through a three-term split. Every product runs as bf16
// x bf16 -> f32 wgmma. Q K^T and dO V^T multiply the bf16 inputs, which the
// tensor cores do exactly with float32 sums. P V, dS K, P^T dO and dS^T Q
// have a float32 operand (p or ds); it goes in as three bf16 terms, hi =
// bf16(x), mid = bf16(x - hi), lo = x - hi - mid, each bf16() rounding
// toward zero (split3 below). bf16 keeps float32's exponent range and three
// 8-bit significands cover float32's 24, so hi + mid + lo is exactly x, and
// the three products, issued lo, mid, hi into one accumulator, sum to the
// float32 product up to summation order. Rounding p once to bf16, as
// FlashAttention-3 does, moves far more bf16 outputs off the exactly
// rounded value than chip_smoke.py allows; tests/test_torch_flash.py
// emulates both on the CPU. The tensor cores' float32 sums are not
// round-to-nearest: their errors lean one way, so over a row of T keys in
// one accumulator they add up, past chip_smoke.py's gate at T 8192. So each
// 64-key (or 64-query) tile's products start from a zero accumulator, and
// the tiles are added in float32 registers, rounded to nearest, as the TPU
// kernels add their blocks. The score is scaled after Q K^T: at Dh 64 and
// 256 the scales 2^-3 and 2^-4 are powers of two, which makes that
// identical to the TPU kernel's q * scale before the product; at Dh 128
// (1/sqrt(128)) it rounds once in float32 after the exact product instead
// of once on q. dq adds scale * (dS K) per key tile,
// as the TPU kernel does; dk sums ds^T q and is scaled at the end.
//
// Bound on the H100 at the LM slice's shape (B 2, T 8192, H 16, Dh 64,
// causal): 1.0739e9 unmasked (q, k) pairs x 2 Dh operations per product =
// 0.1375 TFLOP per product. The forward does one bf16 product and one split
// product (1 + 3 tensor-core products), dq two and one (2 + 3), dk/dv two
// and two (2 + 6): 0.556, 0.695 and 1.112 ms at 989 TFLOP/s, against
// ~0.05 ms of bytes at 3.35 TB/s. So all three are bound by operations. At
// the wide LM's shape (B 8, T 4608, H 8, Dh 256, causal) the pairs are
// 6.796e8 and a product 0.348 TFLOP: 1.41, 1.76 and 2.82 ms, against ~0.2 ms
// of bytes; bound by operations too.
//
// Design. One warpgroup (128 threads) per block and 64-row tiles. Forward
// and dq: a block owns a q tile (dq: with its dO tile, lse and delta) and
// walks the k/v tiles up to the diagonal; dk/dv: a block owns a k tile and
// walks the q/dO tiles (with their lse and delta) from the diagonal on. The
// streamed tiles go through a three-stage ring in shared memory, filled by
// cp.async from all threads two tiles ahead, at addresses built from the
// caller's strides (q, k, v are views of one projection); rows at or past T
// are zero-filled. Tiles are stored in wgmma's 128-byte-swizzled layout, 64
// columns per row; each operand is read K-major (the score products) or
// MN-major (the split products, with the trans-b flag) from the same tile.
// The scores stay in the wgmma accumulator registers, whose layout is the
// register A operand's, so p and ds go from softmax to the next product
// without shared memory. The forward is pipelined: tile kt's P V and tile
// kt+1's Q K^T run on the tensor cores while the warpgroup computes tile
// kt+1's softmax. dq and dk/dv are not: dq's pipeline (a second set of
// scores in flight) took enough registers to drop to 2 blocks per SM and
// ran slower than 3 blocks without it. Registers decide occupancy at Dh 64
// and 128 (kFwdBlocks, dq_blocks, kDkvBlocks): the blocks of an SM interleave one's
// softmax with another's products. On the causal diagonal dq sums dO V^T
// on the CUDA cores instead (dots_fma), in a plain float32 product's order:
// there row 0's dq is pure rounding noise of dp - delta, which only that
// order repeats. Causal tiles past the diagonal are skipped, the mask is
// applied only on the diagonal and ragged tiles, blocks of the longest
// causal rows start first, and every sum runs in one fixed order without
// atomics, so dq, dk and dv repeat bit for bit.
//
// Left for later: a producer warp with TMA and setmaxnreg (warp
// specialisation, as flash_dh256_sm90.cu has it), persistent blocks, the
// dk/dv pipeline (its registers do not fit the forward's scheme), and
// 16-byte stores of the outputs.

#include "flash_sm90.cuh"

namespace {

// blocks per SM the register budget is cut for: the forward keeps its
// pipeline without spills (2 blocks); dk/dv spills a little at 3 blocks,
// which ran faster than 2 blocks without spills; dq fits 3 blocks at Dh 64
// and 2 without spills at Dh 128.
constexpr int kFwdBlocks = 2;
template <int DH>
__host__ __device__ constexpr int dq_blocks() { return DH == 64 ? 3 : 2; }
constexpr int kDkvBlocks = 3;
// ring depth of the streamed tiles
constexpr int kFwdStages = 3;
constexpr int kBwdStages = 3;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// this thread's cp.async groups but the newest N have landed; then made
// visible to the tensor cores (the async proxy)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows r0 .. r0+R-1 of one (b, h) slice (row stride st elements, Dh
// contiguous) into a swizzled tile; rows at or past T read as zero.
template <int R, int DH>
__device__ __forceinline__ void load_tile(uint8_t* dst, const bf16* src, int64_t st, int r0,
                                          int Tn) {
  constexpr int CH = DH / 8;
  const uint32_t base = smem_addr(dst);
  for (int i = threadIdx.x; i < R * CH; i += kWG) {
    const int r = i / CH, c = i % CH;
    const bool ok = r0 + r < Tn;
    cp_async16(base + swz<R>(r, c), src + (int64_t)(ok ? r0 + r : 0) * st + c * 8, ok);
  }
}

// kTile floats of a (B*H, T) row vector from column c0; zero at or past T
__device__ __forceinline__ void load_vec(float* dst, const float* src, int c0, int Tn, int tid) {
  const bool ok = c0 + tid < Tn;
  cp_async4(smem_addr(dst + tid), src + (ok ? c0 + tid : 0), ok);
}

// d[g] = A B: A 64 x 64 in three register terms, B the 64-row `tile`
// MN-major, Dh = 64 G columns. Per k step lo, mid, hi: one fixed order.
template <int G>
__device__ __forceinline__ void mma_split(float (&d)[G][32], const uint32_t (&a)[4][3][4],
                                          uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int t = 2; t >= 0; --t)
        wgmma_rs(d[g], a[kk][t], desc_mn<kTile>(tile, kk, g), kk > 0 || t < 2);
}

// acc = acc * corr (per row) + pv, after the products into pv are done
template <int G>
__device__ __forceinline__ void add_scaled(float (&acc)[G][32], float (&pv)[G][32],
                                           const float (&corr)[2]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    pin(pv[g]);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = acc[g][i] * corr[(i >> 1) & 1] + pv[g][i];
  }
}

// --- the kernels ---------------------------------------------------------------

// s = A B^T of two 64-row tiles, both K-major (issued, not waited)
template <int DH>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    wgmma_ss(s, desc_k<kTile>(a_tile, kk), desc_k<kTile>(b_tile, kk), kk);
}

// One block (one warpgroup) per (bh, 64-row q tile): o (B, T,
// H, Dh) contiguous, lse (B*H, T). Pipelined: while tile kt's P V and tile
// kt+1's Q K^T run on the tensor cores, the warpgroup computes tile kt+1's
// softmax.
template <int DH>
__global__ void __launch_bounds__(kWG, kFwdBlocks)
flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                       int H, int Tn, int64_t sb, int64_t st, int64_t sh, float scale,
                       int causal) {
  constexpr int G = DH / 64;  // 64-column groups
  constexpr int kBytes = kTile * DH * 2;  // one tile
  constexpr int kStages = kFwdStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* ring = Qs + kBytes;  // stage s: K at ring + 2 s kBytes, V after it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nt = (Tn + kTile - 1) / kTile;
  const int q0 = (nt - 1 - (int)blockIdx.y) * kTile;  // the longest causal rows first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  const int nk = causal ? q0 / kTile + 1 : nt;  // causal: no k tile past the diagonal
  const int row0 = q0 + 16 * warp + lane / 4;   // this thread's rows: row0, row0 + 8
  const int c2 = 2 * (lane % 4);
  auto stage = [&](int t) { return smem_addr(ring + (t % kStages) * 2 * kBytes); };
  auto load_kv = [&](int t) {  // k/v tile t into its stage: one cp.async group, maybe empty
    if (t < nk) {
      uint8_t* d = ring + (t % kStages) * 2 * kBytes;
      load_tile<kTile, DH>(d, k + off, st, t * kTile, Tn);
      load_tile<kTile, DH>(d + kBytes, v + off, st, t * kTile, Tn);
    }
    cp_async_commit();
  };

  load_tile<kTile, DH>(Qs, q + off, st, q0, Tn);
#pragma unroll
  for (int t = 0; t < kStages; ++t) load_kv(t);
  float acc[G][32];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  const uint32_t q_tile = smem_addr(Qs);
  float s[32];
  cp_async_wait<kStages - 1>();
  __syncthreads();
  wg_fence();
  scores<DH>(s, q_tile, stage(0));
  wg_commit();
  wg_wait<0>();
  pin(s);
  softmax_tile(s, m, l, corr, 0, q0, row0, c2, Tn, causal, scale);

  float pv[G][32];
  uint32_t a[4][3][4];
  for (int kt = 0; kt + 1 < nk; ++kt) {
    split_frags(s, a);
    cp_async_wait<kStages - 2>();  // tile kt+1 has landed
    __syncthreads();
    wg_fence();
    scores<DH>(s, q_tile, stage(kt + 1));
    wg_commit();
    mma_split<G>(pv, a, stage(kt) + kBytes);
    wg_commit();
    wg_wait<1>();
    pin(s);
    float cn[2];
    softmax_tile(s, m, l, cn, (kt + 1) * kTile, q0, row0, c2, Tn, causal, scale);
    wg_wait<0>();
    add_scaled(acc, pv, corr);
    corr[0] = cn[0];
    corr[1] = cn[1];
    __syncthreads();  // tile kt's stage is read: refill it
    load_kv(kt + kStages);
  }
  split_frags(s, a);  // the last tile
  wg_fence();
  mma_split<G>(pv, a, stage(nk - 1) + kBytes);
  wg_commit();
  wg_wait<0>();
  add_scaled(acc, pv, corr);

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= Tn) continue;
    const float ls = fmaxf(l[hh], 1e-30f);
    if (lane % 4 == 0) lse[(int64_t)bh * Tn + row] = m[hh] + logf(ls);
    bf16* dst = o + (((int64_t)b * Tn + row) * H + h) * DH + c2;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 64 * g + 8 * j) = __floats2bfloat162_rn(
            acc[g][4 * j + 2 * hh] / ls, acc[g][4 * j + 2 * hh + 1] / ls);
  }
}

// dqa += scale * t, once the products into t are done
template <int G>
__device__ __forceinline__ void add_dq(float (&dqa)[G][32], float (&t)[G][32], float scale) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    pin(t[g]);
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[g][i] += scale * t[g][i];
  }
}

// d = A B^T of two 64-row swizzled bf16 tiles for this thread's rows (r,
// r + 8 of A) and columns (8 j + c2 + e of B), each a chain of fmaf over
// the Dh columns in increasing order from zero: the order of a plain
// float32 product (cuBLAS, or the FMA kernels of flash_attention.cu). On the
// causal diagonal dq needs it: in row 0 (and rows like it) p = 1 on one key
// and dp - delta cancels to rounding noise, so dq there is noise, and only
// a dp summed in the plain product's order gives the plain product's noise.
template <int DH>
__device__ __forceinline__ void dots_fma(float (&d)[32], const uint8_t* a_tile,
                                         const uint8_t* b_tile, int r, int c2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
#pragma unroll 1
  for (int c = 0; c < DH / 8; ++c)  // 16-byte chunks: 8 columns each
#pragma unroll
    for (int x = 0; x < 4; ++x) {  // two columns at a time, in order
      float2 a[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        a[hh] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            a_tile + swz<kTile>(r + 8 * hh, c) + 4 * x));
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              b_tile + swz<kTile>(8 * j + c2 + e, c) + 4 * x));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float& acc = d[4 * j + 2 * hh + e];
            acc = fmaf(a[hh].x, f.x, acc);
            acc = fmaf(a[hh].y, f.y, acc);
          }
        }
    }
}

// One block (one warpgroup) per (bh, 64-row q tile): dq (B, T, H, Dh)
// contiguous. dout is contiguous; lse and delta are (B*H, T).
template <int DH>
__global__ void __launch_bounds__(kWG, dq_blocks<DH>())
flash_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dq, int H, int Tn, int64_t sb, int64_t st, int64_t sh,
                      float scale, int causal) {
  constexpr int G = DH / 64;  // 64-column groups
  constexpr int kBytes = kTile * DH * 2;  // one tile
  constexpr int kStages = kBwdStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Os = Qs + kBytes;    // dO
  uint8_t* ring = Os + kBytes;  // stage s: K at ring + 2 s kBytes, V after it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nt = (Tn + kTile - 1) / kTile;
  const int q0 = (nt - 1 - (int)blockIdx.y) * kTile;  // the longest causal rows first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  const int64_t doff = ((int64_t)b * Tn * H + h) * DH;
  const int nk = causal ? q0 / kTile + 1 : nt;  // causal: no k tile past the diagonal
  const int row0 = q0 + 16 * warp + lane / 4;   // this thread's rows: row0, row0 + 8
  const int c2 = 2 * (lane % 4);
  auto stage = [&](int t) { return smem_addr(ring + (t % kStages) * 2 * kBytes); };
  auto load_kv = [&](int t) {  // k/v tile t into its stage: one cp.async group, maybe empty
    if (t < nk) {
      uint8_t* d = ring + (t % kStages) * 2 * kBytes;
      load_tile<kTile, DH>(d, k + off, st, t * kTile, Tn);
      load_tile<kTile, DH>(d + kBytes, v + off, st, t * kTile, Tn);
    }
    cp_async_commit();
  };

  load_tile<kTile, DH>(Qs, q + off, st, q0, Tn);
  load_tile<kTile, DH>(Os, dout + doff, (int64_t)H * DH, q0, Tn);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) load_kv(t);
  float lr[2], dr[2];  // lse and delta of this thread's rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    lr[hh] = row < Tn ? lse[(int64_t)bh * Tn + row] : 0.f;
    dr[hh] = row < Tn ? delta[(int64_t)bh * Tn + row] : 0.f;
  }
  float dqa[G][32];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[g][i] = 0.f;
  const uint32_t q_tile = smem_addr(Qs), o_tile = smem_addr(Os);
  float s[32], dp[32], t[G][32];
  uint32_t a[4][3][4];
  for (int kt = 0; kt < nk; ++kt) {
    load_kv(kt + kStages - 1);
    cp_async_wait<kStages - 1>();  // tile kt has landed
    __syncthreads();
    wg_fence();
    scores<DH>(s, q_tile, stage(kt));
    scores<DH>(dp, o_tile, stage(kt) + kBytes);
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);
    if (causal && kt == nk - 1)  // the diagonal: dp as a plain float32 product sums it
      dots_fma<DH>(dp, Os, ring + (kt % kStages) * 2 * kBytes + kBytes, row0 - q0, c2);
    ds_tile(s, dp, lr, dr, kt * kTile, q0, row0, c2, Tn, causal, scale);
    split_frags(dp, a);
    wg_fence();
    mma_split<G>(t, a, stage(kt));  // dS K
    wg_commit();
    wg_wait<0>();
    add_dq(dqa, t, scale);
    __syncthreads();  // this stage is read: the next round refills it
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= Tn) continue;
    bf16* dst = dq + (((int64_t)b * Tn + row) * H + h) * DH + c2;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 64 * g + 8 * j) = __floats2bfloat162_rn(
            dqa[g][4 * j + 2 * hh], dqa[g][4 * j + 2 * hh + 1]);
  }
}

// One block (one warpgroup) per (bh, 64-row k tile): dk and dv
// (B, T, H, Dh) contiguous. dout is contiguous; lse and delta are (B*H, T).
template <int DH>
__global__ void __launch_bounds__(kWG, kDkvBlocks)
flash_dkv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Tn, int64_t sb,
                       int64_t st, int64_t sh, float scale, int causal) {
  constexpr int G = DH / 64;  // 64-column groups
  constexpr int kBytes = kTile * DH * 2;  // one tile
  constexpr int kStages = kBwdStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + kBytes;
  uint8_t* ring = Vs + kBytes;  // stage s: Q at ring + 2 s kBytes, dO after it
  float* vecs = reinterpret_cast<float*>(ring + kStages * 2 * kBytes);  // stage s: lse, delta
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nq = (Tn + kTile - 1) / kTile;
  const int k0 = (int)blockIdx.y * kTile;  // the keys seen by the most causal rows first
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  const int64_t doff = ((int64_t)b * Tn * H + h) * DH;
  const int64_t dstride = (int64_t)H * DH;  // dO rows
  const float* lrow = lse + (int64_t)bh * Tn;
  const float* drow = delta + (int64_t)bh * Tn;
  const int first = causal ? k0 / kTile : 0;  // causal: earlier q tiles see none of these keys
  const int row0 = k0 + 16 * warp + lane / 4;  // this thread's keys: row0, row0 + 8
  const int c2 = 2 * (lane % 4);
  auto load_q = [&](int i) {  // the i-th q tile into its stage: one cp.async group, maybe empty
    const int qt = first + i;
    if (qt < nq) {
      uint8_t* d = ring + (i % kStages) * 2 * kBytes;
      load_tile<kTile, DH>(d, q + off, st, qt * kTile, Tn);
      load_tile<kTile, DH>(d + kBytes, dout + doff, dstride, qt * kTile, Tn);
      float* vl = vecs + (i % kStages) * 2 * kTile;
      if (threadIdx.x < 2 * kTile)  // the first 64 threads load lse, the next delta
        load_vec(vl + (threadIdx.x / kTile) * kTile, threadIdx.x < kTile ? lrow : drow,
                 qt * kTile, Tn, threadIdx.x % kTile);
    }
    cp_async_commit();
  };

  load_tile<kTile, DH>(Ks, k + off, st, k0, Tn);
  load_tile<kTile, DH>(Vs, v + off, st, k0, Tn);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_q(i);
  float dva[G][32], dka[G][32];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) dva[g][i] = dka[g][i] = 0.f;
  const uint32_t k_tile = smem_addr(Ks), v_tile = smem_addr(Vs);

  for (int i = 0; first + i < nq; ++i) {
    load_q(i + kStages - 1);
    cp_async_wait<kStages - 1>();  // the i-th q tile has landed
    __syncthreads();
    const uint32_t q_tile = smem_addr(ring + (i % kStages) * 2 * kBytes), o_tile = q_tile + kBytes;
    const float* lv = vecs + (i % kStages) * 2 * kTile;
    const float* dl = lv + kTile;
    float s[32], dp[32];
    wg_fence();
    scores<DH>(s, k_tile, q_tile);   // S^T = K Q^T
    scores<DH>(dp, v_tile, o_tile);  // dP^T = V dO^T
    wg_commit();
    wg_wait<0>();
    pin(s);
    pin(dp);
    const int q0 = (first + i) * kTile;
    // only a tile across T or on the diagonal needs the mask
    const bool edge = q0 + kTile > Tn || (causal && q0 == k0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + c2 + e, col = q0 + c;
        const float lc = lv[c], dc = dl[c];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int x_at = 4 * j + 2 * hh + e;
          float x = scale * s[x_at];
          if (edge && causal && row0 + 8 * hh > col) x = kNegInf;
          const float p = !edge || col < Tn ? expf(x - lc) : 0.f;
          s[x_at] = p;
          dp[x_at] = p * (dp[x_at] - dc);
        }
      }
    uint32_t a[4][3][4];
    float t[G][32];
    split_frags(s, a);
    wg_fence();
    mma_split<G>(t, a, o_tile);  // P^T dO
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      pin(t[g]);
#pragma unroll
      for (int r = 0; r < 32; ++r) dva[g][r] += t[g][r];
    }
    split_frags(dp, a);
    wg_fence();
    mma_split<G>(t, a, q_tile);  // dS^T Q (dk is scaled at the end)
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      pin(t[g]);
#pragma unroll
      for (int r = 0; r < 32; ++r) dka[g][r] += t[g][r];
    }
    __syncthreads();  // this stage is read: the next round refills it
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= Tn) continue;
    const int64_t at = (((int64_t)b * Tn + row) * H + h) * DH + c2;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = 4 * j + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(dk + at + 64 * g + 8 * j) =
            __floats2bfloat162_rn(scale * dka[g][r], scale * dka[g][r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + 64 * g + 8 * j) =
            __floats2bfloat162_rn(dva[g][r], dva[g][r + 1]);
      }
  }
}

struct Args {
  int B, H, T;
  int64_t sb, st, sh;
  float scale;
  int causal;
};

bool args_ok(int B, int H, int T) {
  return B > 0 && H > 0 && T > 0 && (int64_t)B * H <= 0x7fffffffLL &&
         (T + kTile - 1) / kTile <= 65535;
}

dim3 grid(const Args& a) {
  return dim3((unsigned)(a.B * a.H), (unsigned)((a.T + kTile - 1) / kTile));
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       const Args& a, cudaStream_t st) {
  // q tile and the k/v ring, + alignment slack
  constexpr int bytes = (1 + 2 * kFwdStages) * kTile * DH * 2 + 1024;
  cudaError_t e = prepare(flash_fwd_wgmma_kernel<DH>, bytes);
  if (e != cudaSuccess) return e;
  flash_fwd_wgmma_kernel<DH><<<grid(a), kWG, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, a.H, a.T, a.sb, a.st, a.sh,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, const Args& a,
                      cudaStream_t st) {
  // q and dO tiles, the k/v ring, + alignment slack
  constexpr int bytes = (2 + 2 * kBwdStages) * kTile * DH * 2 + 1024;
  cudaError_t e = prepare(flash_dq_wgmma_kernel<DH>, bytes);
  if (e != cudaSuccess) return e;
  flash_dq_wgmma_kernel<DH><<<grid(a), kWG, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, (bf16*)dq,
      a.H, a.T, a.sb, a.st, a.sh, a.scale, a.causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv, const Args& a,
                       cudaStream_t st) {
  // k and v tiles, the q/dO ring with its lse and delta, + alignment slack
  constexpr int S = kBwdStages;
  constexpr int bytes = (2 + 2 * S) * kTile * DH * 2 + S * 2 * kTile * 4 + 1024;
  cudaError_t e = prepare(flash_dkv_wgmma_kernel<DH>, bytes);
  if (e != cudaSuccess) return e;
  flash_dkv_wgmma_kernel<DH><<<grid(a), kWG, bytes, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse, delta, (bf16*)dk,
      (bf16*)dv, a.H, a.T, a.sb, a.st, a.sh, a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace

// The entry points take the arguments of fedml_flash_fwd, fedml_flash_dq and
// fedml_flash_dkv (flash_attention.cu) and only bfloat16 (is_bf16 = 1): q, k, v (B, T, H,
// Dh) share the element strides (sb, st, sh) with Dh contiguous and 16-byte
// aligned rows; the outputs are contiguous. Return the launch's cudaError_t.
extern "C" int fedml_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int B, int H, int T, int Dh, int is_bf16,
                                    int causal, long long sb, long long st, long long sh,
                                    float scale, void* stream) {
  if (!args_ok(B, H, T) || !is_bf16) return (int)cudaErrorInvalidValue;
  const Args a{B, H, T, sb, st, sh, scale, causal};
  cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 64: return (int)launch_fwd<64>(q, k, v, o, lse, a, s);
    case 128: return (int)launch_fwd<128>(q, k, v, o, lse, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fedml_flash_dq_sm90(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   void* dq, int B, int H, int T, int Dh, int is_bf16, int causal,
                                   long long sb, long long st, long long sh, float scale,
                                   void* stream) {
  if (!args_ok(B, H, T) || !is_bf16) return (int)cudaErrorInvalidValue;
  const Args a{B, H, T, sb, st, sh, scale, causal};
  cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 64: return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, a, s);
    case 128: return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int fedml_flash_dkv_sm90(const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse, const float* delta,
                                    void* dk, void* dv, int B, int H, int T, int Dh, int is_bf16,
                                    int causal, long long sb, long long st, long long sh,
                                    float scale, void* stream) {
  if (!args_ok(B, H, T) || !is_bf16) return (int)cudaErrorInvalidValue;
  const Args a{B, H, T, sb, st, sh, scale, causal};
  cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 64: return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, a, s);
    case 128: return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
