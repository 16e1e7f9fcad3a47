// Flash attention's forward and dq at head dim 256 for float32 inputs, on
// the Hopper tensor cores, exact to float32 through three TF32 products
// (3xTF32, tf32x3.cuh). dk/dv at Dh 256 and every float32 kernel at Dh 64
// and 128 keep the FMA kernels of flash_attention.cu; bf16 inputs run the
// wgmma kernels (flash_dh256_sm90.cu at Dh 256). ops/flash_attention.py's
// route() picks.
//
// Replaces: fedml_tpu/ops/pallas/flash_attention.py — _flash_kernel (:66,
// the forward, pallas_call :140) and _dq_kernel (:167, pallas_call :287)
// at Dh 256 on float32 inputs. The TPU kernels walk a sequential (bh, q
// block, k block) grid and carry m, l and the accumulator in VMEM scratch;
// here one block owns 64 q rows and walks the k tiles in a loop, with that
// state in registers.
//
// Arithmetic (the contract of flash_attention.cu, unchanged): float32
// inputs and outputs; the forward scales q before Q K^T, dq scales the
// product after it; masked scores are finfo(float32).min; the online
// softmax keeps m, l and corr per row, o = acc / max(l, 1e-30) and lse =
// m + log(max(l, 1e-30)); dq recomputes p = exp(scale q.k - lse), ds = p
// (dO.v - delta) and adds scale (dS K) per k tile. Every product is three
// mma.sync.m16n8k8 TF32 products (a_lo b_hi, a_hi b_lo, a_hi b_hi, small
// terms first), each operand split where it is loaded (split_tf32); the
// dropped a_lo b_lo and the tensor core's read of lo leave ~1.2e-6 of the
// magnitudes (conv3x3_sm90.cu's analysis). The tensor cores' float32 sums
// lean one way over long runs, so each k tile's P V (dS K) starts from a
// zero accumulator and is added to the running registers in float32,
// rescaled by corr (times scale in dq); a score (and dq's dP) is the float32
// sum of two accumulators, one per half of the 256 columns. Each output is
// summed in one fixed order with no atomics: runs repeat bit for bit.
// Blocks of the longest causal rows launch first; rows and columns at or
// past T are zero-filled and masked, so T need not be a multiple of a tile.
//
// Design. 256 threads, eight warps in four pairs; pair p owns q rows 16 p ..
// 16 p + 15 of the block's 64. The two warps of a pair split the work by
// halves of Dh: warp half h sums the score products (Q K^T, and dO V^T in
// dq) over columns 128 h .. 128 h + 127 and the output (P V, dS K) over the
// same 128 output columns. Its (16, 128) float32 accumulator is 16 m16n8
// tiles, 64 registers a thread: with two warps per scheduler the products'
// and loads' latencies overlap, which one warp of 16 x 256 (128 registers,
// 255 in all) could not do. The partial scores cross shared memory once a
// tile (each lane writes its 16 values, a pair barrier, each adds its
// partner's: a + b is b + a, so both warps hold the same score, softmax and
// P without a second exchange). q (and dO) stay resident in shared memory,
// rows 260 floats apart; k and v stream through a two-stage cp.async ring,
// the next tile in flight during this tile's products, one block barrier a
// tile. The forward's k/v tiles are 32 rows (64 q rows + 2 x (32 + 32)
// rows + the exchange: 211 KB); dq's resident q and dO leave room for
// 16-row k/v tiles (also 211 KB). Q K^T's and dO V^T's fragments load with
// ldmatrix (four 8 x 4 float matrices: an A fragment, or the B fragments of
// two 8-key tiles); row padding 260 (4 mod 32 banks) keeps those reads and
// P V's (rows 2 t and 2 t + 1 at column g: bank 8 t + g, 8 t + 4 + g) free
// of bank conflicts. S's accumulator holds columns 2 t and 2 t + 1 of rows
// g and g + 8; read as the k index t and t + 4 of the next product's A
// fragment, it is P's A fragment as it stands, once the B operand's rows
// are taken in the same order (keys 2 t and 2 t + 1): no shuffle. P V (dS
// K) runs in two passes of 64 output columns, each pass's zero-started sums
// in 32 registers. On an H100 at the shape below (chip_smoke.py flash,
// PERF.md): a first design, four warps of 16 rows x 256 columns with scalar
// fragment loads (one warp a scheduler, 255 registers), took 20.3 ms for
// the forward and 25.8 for dq; this one takes 12.5 and 18.8. Builds with
// phases removed showed the products themselves taking most of the time,
// below the rate mma.sync reaches, and the k/v staging and the exchange and
// softmax adding to them rather than hiding behind them. No faster: pairs
// on two schedulers, an unroll of 8, 64-key forward tiles each loaded one
// phase ahead, one bulk copy (cp.async.bulk) a row issued by one warp.
//
// Bound on the H100 at the wide float32 LM's shape (B 8, T 4352, H 8, Dh
// 256, causal): 606,216,192 unmasked (q, k) pairs, 512 operations per pair
// and product; the forward's two products as three TF32 products each at
// 495 TFLOP/s take 3.762 ms, dq's three 5.643 ms (at the float32 FMA rate,
// 67 TFLOP/s, 9.265 and 13.90 ms); bytes (q, k, v, o once: 0.29 GB) take
// 0.09 ms. Bound by operations. mma.sync reaches ~64% of the TF32 peak the
// bound counts (chip_smoke.py's tc_rate); the splits and fragment loads
// share the warps' issue slots with the products.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kDh = 256;
constexpr int kHalf = kDh / 2;      // columns of one warp's half
constexpr int kLD = kDh + 4;        // floats between rows of a tile in shared memory
constexpr int kRows = 64;           // q rows of a block
constexpr int kThreads = 256;       // four pairs of warps, 16 q rows a pair
constexpr int kFwdKeys = 32;        // rows of the forward's k and v tiles
constexpr int kDqKeys = 16;         // rows of dq's k and v tiles
constexpr int kPass = 8;            // 8-column tiles of one P V (dS K) pass: 64 columns
constexpr int kExchange = 16 * 32;  // floats of one warp's partial scores
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, zero when !valid (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the two warps of pair p (warps p and p + 4) meet at barrier 1 + p
__device__ __forceinline__ void pair_sync(int p) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + p) : "memory");
}

// Four 8 x 4 float matrices, one row address a lane (lanes 8 i .. 8 i + 7
// give matrix i's rows); register i of lane (g, t) is row g, column t of
// matrix i.
__device__ __forceinline__ void ldsm_x4(const float* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// rows r0 .. r0 + R - 1 of one (b, h) slice (row stride st floats, Dh
// contiguous) into a tile of row stride kLD; rows at or past T zero-filled.
// A thread copies 16-byte chunk tid % 64 of rows tid / 64 + 4 j: a pointer
// step per copy (a generic index loop spent ~28 integer instructions on
// each copy's division and 64-bit address)
template <int R>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int64_t st, int r0,
                                           int Tn) {
  constexpr unsigned kChunks = kDh / 4, kStep = kThreads / kChunks;  // 64 chunks, 4 rows a pass
  static_assert(R % kStep == 0, "whole passes");
  const unsigned c = 4 * (threadIdx.x % kChunks), row = threadIdx.x / kChunks;
  const float* s = src + (int64_t)(r0 + (int)row) * st + c;
  float* d = dst + row * kLD + c;
#pragma unroll
  for (int j = 0; j < R / (int)kStep; ++j) {
    const bool valid = r0 + (int)row + (int)kStep * j < Tn;
    cp_async16(d + kStep * j * kLD, valid ? s : src, valid);
    s += kStep * st;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

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

// This lane's ldmatrix row addresses into a tile (row stride kLD): for the
// A fragment of rows r0 .. r0 + 15 (matrices: rows 0-7 and 8-15 at columns
// 0-3, then both at 4-7), and for the B fragments of two 8-row groups of b
// (matrices: group 0 at columns 0-3 and 4-7, then group 1)
__device__ __forceinline__ const float* a_lane(const float* a, int r0, int lane) {
  return a + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLD + 4 * (lane >> 4);
}
__device__ __forceinline__ const float* b_lane(const float* b, int lane) {
  return b + ((lane & 7) + 8 * (lane >> 4)) * kLD + 4 * ((lane >> 3) & 1);
}

// s[n] += (16 rows of a) (rows 8 n .. 8 n + 7 of b)^T over the 128 columns
// from d0, for N 8-row groups of b (N even); al and bl are a_lane / b_lane
// addresses
template <int N>
__device__ __forceinline__ void half_scores(float (&s)[N][4], const float* al_, const float* bl_,
                                            int d0) {
#pragma unroll 4
  for (int d = d0; d < d0 + kHalf; d += 8) {
    uint32_t r[4], ah[4], al[4];
    ldsm_x4(al_ + d, r);
    split4(r, ah, al);
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      uint32_t bh[4], bl[4];
      ldsm_x4(bl_ + n * 8 * kLD + d, r);
      split4(r, bh, bl);
      const uint32_t b0h[2] = {bh[0], bh[1]}, b0l[2] = {bl[0], bl[1]};
      const uint32_t b1h[2] = {bh[2], bh[3]}, b1l[2] = {bl[2], bl[3]};
      mma3(s[n], ah, al, b0h, b0l);
      mma3(s[n + 1], ah, al, b1h, b1l);
    }
  }
}

// P's (or dS's) A fragments from the score accumulators: key step kk
// covers keys 8 kk .. 8 kk + 7, its k index t being key 2 t and t + 4 key
// 2 t + 1 (the B operand reads its rows in the same order)
template <int N>
__device__ __forceinline__ void prob_fragments(const float (&p)[N][4], uint32_t (&hi)[N][4],
                                               uint32_t (&lo)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    split_tf32(p[kk][0], hi[kk][0], lo[kk][0]);  // row g, key 2 t
    split_tf32(p[kk][2], hi[kk][1], lo[kk][1]);  // row g + 8, key 2 t
    split_tf32(p[kk][1], hi[kk][2], lo[kk][2]);  // row g, key 2 t + 1
    split_tf32(p[kk][3], hi[kk][3], lo[kk][3]);  // row g + 8, key 2 t + 1
  }
}

// out[n] = P (rows 8 kk + 2 t, + 1 of x at columns c0 + 8 n + g), over the
// N key steps, from zero: one 64-column pass of P V or dS K
template <int N>
__device__ __forceinline__ void prob_pass(float (&out)[kPass][4], const uint32_t (&ph)[N][4],
                                          const uint32_t (&pl)[N][4], const float* x, int c0,
                                          int g, int t) {
#pragma unroll
  for (int n = 0; n < kPass; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    const float* xr = x + (8 * kk + 2 * t) * kLD + c0 + g;
#pragma unroll
    for (int n = 0; n < kPass; ++n) {
      uint32_t bh[2], bl[2];
      split_tf32(xr[8 * n], bh[0], bl[0]);
      split_tf32(xr[kLD + 8 * n], bh[1], bl[1]);
      mma3(out[n], ph[kk], pl[kk], bh, bl);
    }
  }
}

// Adds the pair partner's partial sums to this warp's N accumulator tiles:
// each lane writes its 4 N values to its warp's exchange slot, the pair
// meets, each lane adds the partner's values at its own position
template <int N>
__device__ __forceinline__ void pair_add(float (&v)[N][4], float* xs, int warp, int lane) {
  static_assert(4 * N * 32 <= kExchange, "exchange slot");
  float* mine = xs + warp * kExchange;
  const float* other = xs + (warp ^ 4) * kExchange;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(4 * i + e) * 32 + lane] = v[i][e];
  pair_sync(warp & 3);
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[i][e] += other[(4 * i + e) * 32 + lane];
}

// rows row0 (values e = 0, 1) and row0 + 8 (e = 2, 3) of a warp's (16, 128)
// accumulator, divided by div0 / div1, into columns c0 .. c0 + 127 of a
// contiguous (B, T, H, Dh) output
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[16][4], float div0,
                                           float div1, int b, int h, int H, int Tn, int row0,
                                           int c0, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= Tn) continue;
    const float div = half ? div1 : div0;
    float* dst = out + (((int64_t)b * Tn + row) * H + h) * kDh + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc[n][2 * half] / div, acc[n][2 * half + 1] / div);
  }
}

// One block per (bh, 64 q rows): o (B, T, H, Dh) contiguous, lse (B*H, T).
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int H, int Tn, int64_t sb, int64_t st,
                       int64_t sh, float scale, int causal) {
  constexpr int KT = kFwdKeys, NS = KT / 8, STAGE = 2 * KT * kLD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* ring = Qs + kRows * kLD;  // stage s: k tile at ring + s STAGE, v tile after it
  float* xs = ring + 2 * STAGE;    // the partial scores' exchange, one slot a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int pr = warp & 3, half = warp >> 2, c0 = half * kHalf;
  const int nt = (Tn + kRows - 1) / kRows;
  // the q tiles of one (b, h) in a row, its longest causal rows first
  const int bh = (int)blockIdx.x / nt, b = bh / H, h = bh % H;
  const int q0 = (nt - 1 - (int)blockIdx.x % nt) * kRows;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  const float *kg = k + off, *vg = v + off;
  const int ntk = (Tn + KT - 1) / KT;
  // causal: no row of this block sees a k tile past q0 + 63
  const int nk = causal ? min((q0 + kRows + KT - 1) / KT, ntk) : ntk;
  auto stage_kv = [&](int i) {
    float* dst = ring + (i & 1) * STAGE;
    stage_rows<KT>(dst, kg, st, i * KT, Tn);
    stage_rows<KT>(dst + KT * kLD, vg, st, i * KT, Tn);
    cp_async_commit();
  };
  stage_kv(0);
  // q, scaled before the product as the TPU kernel does (:92); rows past T zero
  for (int idx = threadIdx.x; idx < kRows * (kDh / 4); idx += kThreads) {
    const int row = idx / (kDh / 4), c = 4 * (idx % (kDh / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < Tn) x = *reinterpret_cast<const float4*>(q + off + (int64_t)(q0 + row) * st + c);
    *reinterpret_cast<float4*>(Qs + row * kLD + c) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  const float* qa = a_lane(Qs, 16 * pr, lane);
  const int row0 = q0 + 16 * pr + g;  // this thread's rows: row0 and row0 + 8
  float acc[16][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait_all();
    __syncthreads();  // tile i has landed, and every warp is done with tile i - 1
    if (i + 1 < nk) stage_kv(i + 1);
    const float* Ks = ring + (i & 1) * STAGE;
    const float* Vs = Ks + KT * kLD;
    const int k0 = i * KT;
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    half_scores<NS>(s, qa, b_lane(Ks, lane), c0);
    pair_add<NS>(s, xs, warp, lane);
    if (k0 + KT > Tn || (causal && k0 + KT - 1 > q0)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * n + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
          if (col >= Tn || (causal && col > row)) s[n][e] = kNegInf;
        }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float bm = kNegInf;
#pragma unroll
      for (int n = 0; n < NS; ++n) bm = fmaxf(bm, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float nm = fmaxf(m[r], quad_max(bm));
      corr[r] = expf(m[r] - nm);
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][2 * r] = expf(s[n][2 * r] - nm);
        s[n][2 * r + 1] = expf(s[n][2 * r + 1] - nm);
        ps += s[n][2 * r];
        ps += s[n][2 * r + 1];
      }
      l[r] = l[r] * corr[r] + quad_sum(ps);
      m[r] = nm;
    }
    uint32_t ph[NS][4], pl[NS][4];
    prob_fragments<NS>(s, ph, pl);
#pragma unroll
    for (int c = 0; c < 16 / kPass; ++c) {
      float pv[kPass][4];
      prob_pass<NS>(pv, ph, pl, Vs, c0 + 8 * kPass * c, g, t);
#pragma unroll
      for (int n = 0; n < kPass; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[kPass * c + n][e] = acc[kPass * c + n][e] * corr[e >> 1] + pv[n][e];
    }
  }

  const float ls0 = fmaxf(l[0], 1e-30f), ls1 = fmaxf(l[1], 1e-30f);
  if (half == 0 && t == 0) {
    if (row0 < Tn) lse[(int64_t)bh * Tn + row0] = m[0] + logf(ls0);
    if (row0 + 8 < Tn) lse[(int64_t)bh * Tn + row0 + 8] = m[1] + logf(ls1);
  }
  store_rows(o, acc, ls0, ls1, b, h, H, Tn, row0, c0, t);
}

// One block per (bh, 64 q rows): dq (B, T, H, Dh) contiguous. dout is
// contiguous; lse and delta are (B*H, T). k and v stream in 16-row tiles.
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dq, int H, int Tn, int64_t sb, int64_t st,
                      int64_t sh, float scale, int causal) {
  constexpr int KT = kDqKeys, NS = KT / 8, STAGE = 2 * KT * kLD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + kRows * kLD;    // dO
  float* ring = Os + kRows * kLD;  // stage s: k tile at ring + s STAGE, v tile after it
  float* xs = ring + 2 * STAGE;    // the partial products' exchange, one slot a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int pr = warp & 3, half = warp >> 2, c0 = half * kHalf;
  const int nt = (Tn + kRows - 1) / kRows;
  const int bh = (int)blockIdx.x / nt, b = bh / H, h = bh % H;
  const int q0 = (nt - 1 - (int)blockIdx.x % nt) * kRows;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  const int64_t doff = ((int64_t)b * Tn * H + h) * kDh;
  const float *kg = k + off, *vg = v + off;
  const int ntk = (Tn + KT - 1) / KT;
  // causal: no k tile past the block's last row
  const int nk = causal ? min((q0 + kRows) / KT, ntk) : ntk;
  auto stage_kv = [&](int i) {
    float* dst = ring + (i & 1) * STAGE;
    stage_rows<KT>(dst, kg, st, i * KT, Tn);
    stage_rows<KT>(dst + KT * kLD, vg, st, i * KT, Tn);
    cp_async_commit();
  };
  stage_rows<kRows>(Qs, q + off, st, q0, Tn);
  stage_rows<kRows>(Os, dout + doff, (int64_t)H * kDh, q0, Tn);
  stage_kv(0);  // one group with q and dO

  const float* qa = a_lane(Qs, 16 * pr, lane);
  const float* oa = a_lane(Os, 16 * pr, lane);
  const int row0 = q0 + 16 * pr + g;
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lr[r] = row < Tn ? lse[(int64_t)bh * Tn + row] : 0.f;
    dr[r] = row < Tn ? delta[(int64_t)bh * Tn + row] : 0.f;
  }
  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < nk) stage_kv(i + 1);
    const float* Ks = ring + (i & 1) * STAGE;
    const float* Vs = Ks + KT * kLD;
    const int k0 = i * KT;
    // S = Q K^T and dP = dO V^T: this warp's half of the columns, then the
    // partner's half added
    float sp[2 * NS][4];
#pragma unroll
    for (int n = 0; n < 2 * NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[n][e] = 0.f;
    {
      const float *kb = b_lane(Ks, lane), *vb = b_lane(Vs, lane);
#pragma unroll 4
      for (int d = c0; d < c0 + kHalf; d += 8) {
        uint32_t r[4], qh[4], ql[4], oh[4], ol[4], kh[4], kl[4], vh[4], vl[4];
        ldsm_x4(qa + d, r);
        split4(r, qh, ql);
        ldsm_x4(oa + d, r);
        split4(r, oh, ol);
        ldsm_x4(kb + d, r);
        split4(r, kh, kl);
        ldsm_x4(vb + d, r);
        split4(r, vh, vl);
        const uint32_t k0h[2] = {kh[0], kh[1]}, k0l[2] = {kl[0], kl[1]};
        const uint32_t k1h[2] = {kh[2], kh[3]}, k1l[2] = {kl[2], kl[3]};
        const uint32_t v0h[2] = {vh[0], vh[1]}, v0l[2] = {vl[0], vl[1]};
        const uint32_t v1h[2] = {vh[2], vh[3]}, v1l[2] = {vl[2], vl[3]};
        mma3(sp[0], qh, ql, k0h, k0l);
        mma3(sp[1], qh, ql, k1h, k1l);
        mma3(sp[2], oh, ol, v0h, v0l);
        mma3(sp[3], oh, ol, v1h, v1l);
      }
    }
    pair_add<2 * NS>(sp, xs, warp, lane);
    // ds = p (dp - delta), p = exp(scale s - lse), masked entries p = 0
    float ds[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
        float x = scale * sp[n][e];
        if (col >= Tn || (causal && col > row)) x = kNegInf;
        const float p = expf(x - lr[e >> 1]);
        ds[n][e] = p * (sp[NS + n][e] - dr[e >> 1]);
      }
    uint32_t dh[NS][4], dl[NS][4];
    prob_fragments<NS>(ds, dh, dl);
#pragma unroll
    for (int c = 0; c < 16 / kPass; ++c) {
      float tk[kPass][4];
      prob_pass<NS>(tk, dh, dl, Ks, c0 + 8 * kPass * c, g, t);
#pragma unroll
      for (int n = 0; n < kPass; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[kPass * c + n][e] = acc[kPass * c + n][e] + scale * tk[n][e];
    }
  }
  store_rows(dq, acc, 1.f, 1.f, b, h, H, Tn, row0, c0, t);
}

struct Args {
  int B, H, T;
  int64_t sb, st, sh;
  float scale;
  int causal;
};

bool args_ok(int B, int H, int T, int Dh, int is_bf16) {
  return Dh == kDh && !is_bf16 && B > 0 && H > 0 && T > 0 &&
         (int64_t)B * H * ((T + kRows - 1) / kRows) <= 0x7fffffffLL;
}

// one block per (bh, q tile), the q tiles of one bh consecutive (the
// blocks on the card at once share one or two heads' k and v; a bh-fastest
// order measured the same at the wide shape)
dim3 grid(const Args& a) { return dim3((unsigned)(a.B * a.H * ((a.T + kRows - 1) / kRows))); }

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

}  // namespace

// q, k, v (B, T, H, 256) float32 sharing the element strides (sb, st, sh),
// Dh contiguous, 16-byte aligned rows; o (B, T, H, 256) and lse (B*H, T)
// contiguous outputs. Takes Dh 256 and is_bf16 = 0 only. Returns the
// cudaError_t of the launch.
extern "C" int fedml_flash_fwd_f32_sm90(const void* q, const void* k, const void* v, void* o,
                                        float* lse, int B, int H, int T, int Dh, int is_bf16,
                                        int causal, long long sb, long long st, long long sh,
                                        float scale, void* stream) {
  if (!args_ok(B, H, T, Dh, is_bf16)) return (int)cudaErrorInvalidValue;
  const Args a{B, H, T, sb, st, sh, scale, causal};
  const int floats = kRows * kLD + 2 * 2 * kFwdKeys * kLD + 8 * kExchange;
  cudaError_t e = prepare(flash_fwd_f32tc_kernel, floats);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_f32tc_kernel<<<grid(a), kThreads, floats * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, a.H, a.T, a.sb, a.st,
      a.sh, a.scale, a.causal);
  return (int)cudaGetLastError();
}

// dq (B, T, H, 256) contiguous from q, k, v (strided as for the forward),
// dout (B, T, H, 256) contiguous, and the forward's lse and delta =
// rowsum(dO * O), both (B*H, T) float32. Takes Dh 256 and is_bf16 = 0 only.
extern "C" int fedml_flash_dq_f32_sm90(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dq, int B, int H, int T, int Dh, int is_bf16,
                                       int causal, long long sb, long long st, long long sh,
                                       float scale, void* stream) {
  if (!args_ok(B, H, T, Dh, is_bf16)) return (int)cudaErrorInvalidValue;
  const Args a{B, H, T, sb, st, sh, scale, causal};
  const int floats = 2 * kRows * kLD + 2 * 2 * kDqKeys * kLD + 8 * kExchange;
  cudaError_t e = prepare(flash_dq_f32tc_kernel, floats);
  if (e != cudaSuccess) return (int)e;
  flash_dq_f32tc_kernel<<<grid(a), kThreads, floats * sizeof(float), (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dq, a.H, a.T, a.sb, a.st, a.sh, a.scale, a.causal);
  return (int)cudaGetLastError();
}
