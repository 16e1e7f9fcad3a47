// Flash attention's forward for float32 (B, T, H, Dh) inputs at the head
// dims Dh = 128 n, 4 <= n <= 7 (512, 640, 768, 896), and its dq and dk/dv at
// Dh 640-896, on the Hopper tensor cores, exact to float32 through three
// TF32 products, causal or full, any T: the forward of the Cheetah
// example's attention trained in float32 at --dim 4096 (8 heads of 512) and
// the wider float32 head dims the dispatch guard admits (past 896 its
// budget refuses float32 at every T). On the route the float32 forward, dq
// and dk/dv at Dh 512 are flash_f32_wgmma_sm90.cu's four-block clusters;
// this forward's Dh-512 entry stays, timed beside them (chip_smoke.py's
// was_ms).
//
// Replaces: fedml_tpu/ops/pallas/flash_attention.py on float32 inputs —
// _flash_kernel (:66, the forward of _flash_forward :129, call :140) at Dh
// 512-896, _dq_kernel (:167, call :287) and _dkv_kernel (:213, call :299)
// at Dh 640-896.
//
// Arithmetic (flash_f32_sm90.cu's, unchanged): every product is three
// mma.sync.m16n8k8 TF32 products (a_lo b_hi, a_hi b_lo, a_hi b_hi, small
// terms first), each operand split where it is loaded (tf32x3.cuh); the
// forward scales q before Q K^T, the backward scales the product after it;
// each streamed tile's product (P V, dS K, P^T dO, dS^T Q) starts from a
// zero accumulator and is added to the running registers in float32
// (rescaled by corr in the forward, times scale in dq and dk); masked
// scores are finfo(float32).min, l is clamped at 1e-30. One fixed order of
// every sum and no atomics: dq, dk and dv repeat bit for bit. Rows and
// columns at or past T are zero-filled and masked.
//
// Layout: Dh split across warps inside the block, so that no score is
// computed twice. A row group is 16 rows (16 keys in dk/dv) and P = Dh / 128
// warps; each warp sums the score products over its own 128 columns (the
// even and odd 8-column steps in two mma chains, added at the end) and owns
// those 128 output columns: a (16, 128) float32 accumulator, 64 registers a
// thread, whatever Dh is. The group's warps write their partial scores to
// shared memory, meet, and each adds part 0 + part 1 + ... + part P - 1 in
// that order, so every warp holds the same bits of S (and dP), p and ds
// (group_add). P is a run-time count (a block is 32 G P threads, G row
// groups, set at launch), so one instantiation of each kernel per
// shared-memory plan covers several head dims: what Dh sets is how many
// row groups stay resident. Every streamed tile is 8 rows (m16n8k8's 8
// keys); rows are Dh + 4 floats apart (4 mod 32 banks: ldmatrix and the P V
// reads are free of bank conflicts); tiles stream through a cp.async ring,
// the next tile in flight during this tile's products. Shared memory at 4
// bytes a float, against the 227 KB a block may take:
//   forward  64 q rows at Dh 512 (16 warps), 32 at 640 and 768 (10, 12), 16
//            at 896 (7), two stages of k and v: 202 / 166 / 199 / 172 KB.
//   dq       16 q and dO rows (one row group, the block), two stages of k
//            and one of v, refilled as soon as the block has added its
//            scores: at Dh 896 two v stages and the resident rows would
//            take 225 KB before the exchange. 146 / 175 / 204 KB at 640 /
//            768 / 896.
//   dk/dv    16 key rows of k and v resident, two stages of q and dO; the
//            exchange lives in the ring stage that the next tile will fill,
//            and that tile is issued once the exchange is read (at Dh 896
//            the resident rows and the ring alone take 225 KB): 161 / 193 /
//            225 KB.
// At Dh 512 the forward's plan measured faster than 32 q rows with 16-row
// k/v tiles, 8 warps, on an H100: twice the warps an SM hide more of
// mma.sync's latency. (Until the clusters, dq and dk/dv at Dh 512 ran here
// too, as 32 resident rows: 53.35 and 75.14 ms at the shape below, PERF.md.)
// dk/dv's warps: a group's P warps sum dv (role 0) and P sum dk (role 1),
// each over its 128 columns; role 0 writes its partial of S = K Q^T, role 1
// its partial of dP = V dO^T, and after one barrier every warp adds the S
// parts in the fixed order (role 1 the dP parts too), so both roles form
// the same p without a hand-over.
//
// Bound on the H100 at the example's shape (B 8, T 4224, H 8, Dh 512,
// causal): 571,084,800 unmasked (q, k) pairs x 2 x 512 operations = 0.5848
// TFLOP a product. The forward does 2 products, dq 3 and dk/dv 4, each as
// three TF32 products at 495 TFLOP/s: 7.088, 10.63 and 14.18 ms (at the
// float32 FMA rate of 67 TFLOP/s 17.46, 26.18 and 34.91), against ~0.5 ms
// of bytes at 3.35 TB/s. Bound by operations. mma.sync reaches ~64% of the
// TF32 peak the bound counts (chip_smoke.py's tc_rate).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kWarpCols = 128;          // score and output columns of a warp
constexpr int kNT = kWarpCols / 8;      // 8-column output tiles of a warp
constexpr int kPass = 8;                // output tiles of one pass: 64 columns
constexpr int kTile = 8;                // rows of every streamed tile
constexpr int kMinParts = 4, kMaxParts = 7;
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

// the ``threads`` threads of a row group meet at barrier ``id`` (1 + group)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Four 8 x 4 float matrices, one row address a lane (lanes 8 i .. 8 i + 7
// give matrix i's rows); register i of lane (g, t) is row g, column t of
// matrix i.
__device__ __forceinline__ void ldsm_x4(const float* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A warp's share of a copy into shared memory: 16 bytes at column c of rows
// r, r + step, ... (a warp covers 128 columns of a row: 32 lanes x 4 floats)
struct Share {
  int r, step, c;
};

// rows r0 .. r0 + R - 1 of one (b, h) slice (row stride st floats) into a
// tile of row stride ld; rows at or past T zero-filled
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int64_t st, int r0,
                                           int R, int Tn, int ld, Share s) {
  for (int r = s.r; r < R; r += s.step) {
    const bool valid = r0 + r < Tn;
    cp_async16(dst + r * ld + s.c, valid ? src + (int64_t)(r0 + r) * st + s.c : src, valid);
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

// This lane's ldmatrix row address for the A fragment of rows r0 .. r0 + 15
// of a tile of row stride ld (matrices: rows 0-7 and 8-15 at columns 0-3,
// then both at 4-7)
__device__ __forceinline__ const float* a_lane(const float* a, int r0, int lane, int ld) {
  return a + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 4 * (lane >> 4);
}

// ... and for the B fragments of an 8-row tile over two 8-column steps
// (matrices: its rows at columns 0-3, 4-7, 8-11 and 12-15)
__device__ __forceinline__ const float* b_lane(const float* b, int lane, int ld) {
  return b + (lane & 7) * ld + 4 * (lane >> 3);
}

// The two B fragments (hi and lo) of the 8-column steps d and d + 8 of an
// 8-row tile, from one ldmatrix at its b_lane address + d
struct BPair {
  uint32_t h0[2], l0[2], h1[2], l1[2];
};

__device__ __forceinline__ BPair load_b(const float* bl_) {
  uint32_t r[4], h[4], l[4];
  ldsm_x4(bl_, r);
  split4(r, h, l);
  return BPair{{h[0], h[1]}, {l[0], l[1]}, {h[2], h[3]}, {l[2], l[3]}};
}

// s = (16 rows of a) (8 rows of b)^T over the 128 columns from d0; al_ and
// bl_ are a_lane / b_lane addresses. The even and odd 8-column steps sum in
// separate chains, added at the end.
__device__ __forceinline__ void scores(float (&s)[4], const float* al_, const float* bl_,
                                       int d0) {
  float odd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int d = d0; d < d0 + kWarpCols; d += 16) {
    uint32_t r[4], ah[4], al[4], ch[4], cl[4];
    ldsm_x4(al_ + d, r);
    split4(r, ah, al);
    ldsm_x4(al_ + d + 8, r);
    split4(r, ch, cl);
    const BPair b = load_b(bl_ + d);
    mma3(s, ah, al, b.h0, b.l0);
    mma3(odd, ch, cl, b.h1, b.l1);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] += odd[e];
}

// P's (or dS's) A fragment from a score accumulator: its k index t is key
// 2 t and t + 4 key 2 t + 1 (the B operand reads its rows in the same order)
__device__ __forceinline__ void prob_fragment(const float (&p)[4], uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
  split_tf32(p[0], hi[0], lo[0]);  // row g, key 2 t
  split_tf32(p[2], hi[1], lo[1]);  // row g + 8, key 2 t
  split_tf32(p[1], hi[2], lo[2]);  // row g, key 2 t + 1
  split_tf32(p[3], hi[3], lo[3]);  // row g + 8, key 2 t + 1
}

// acc[n] = acc[n] * mul_r + fac * (P x)[n] over the warp's 128 columns from
// c0, in two passes of 64 columns, each pass's product over the tile's 8
// keys from zero (rows 2 t and 2 t + 1 of x at columns c0 + 8 n + g); mul_r
// is the forward's corr of the lane's row (e >> 1), 1 elsewhere
__device__ __forceinline__ void add_product(float (&acc)[kNT][4], const uint32_t (&ph)[4],
                                            const uint32_t (&pl)[4], const float* x, int ld,
                                            int c0, int g, int t, const float (&mul)[2],
                                            float fac) {
#pragma unroll
  for (int c = 0; c < kNT / kPass; ++c) {
    const float* xr = x + 2 * t * ld + c0 + 8 * kPass * c + g;
    float out[kPass][4];
#pragma unroll
    for (int n = 0; n < kPass; ++n) {
      uint32_t bh[2], bl[2];
      split_tf32(xr[8 * n], bh[0], bl[0]);
      split_tf32(xr[ld + 8 * n], bh[1], bl[1]);
#pragma unroll
      for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
      mma3(out[n], ph, pl, bh, bl);
    }
#pragma unroll
    for (int n = 0; n < kPass; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[kPass * c + n][e] = acc[kPass * c + n][e] * mul[e >> 1] + fac * out[n][e];
  }
}

// A row group's sum of its P warps' partials of N score tiles: each lane
// writes its values to its warp's slot (4 N x 32 floats; part j's slot at xs
// + j * stride), the group meets, and every warp adds part 0 + part 1 + ...
// + part P - 1 in that order, each read from shared memory, so every warp
// of the group holds the same bits.
template <int N>
__device__ __forceinline__ void write_part(float* mine, const float (&v)[N][4], int lane) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(4 * i + e) * 32 + lane] = v[i][e];
}

template <int N>
__device__ __forceinline__ void sum_parts(float (&v)[N][4], const float* xs, int stride, int P,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = (4 * i + e) * 32 + lane;
      float sum = xs[at];
      for (int j = 1; j < P; ++j) sum += xs[j * stride + at];
      v[i][e] = sum;
    }
}

// ... for the forward and dq, whose warp w serves row group w % G: its P
// warps (w, w + G, ...) meet at barrier 1 + w % G
template <int N>
__device__ __forceinline__ void group_add(float (&v)[N][4], float* xs, int warp, int pr, int G,
                                          int P, int lane) {
  constexpr int kSlot = 4 * N * 32;
  write_part<N>(xs + warp * kSlot, v, lane);
  bar_sync(1 + pr, 32 * P);
  sum_parts<N>(v, xs + pr * kSlot, G * kSlot, P, lane);
}

// rows row0 (values e = 0, 1) and row0 + 8 (e = 2, 3) of a warp's (16, 128)
// accumulator, divided by div0 / div1, into columns c0 .. c0 + 127 of a
// contiguous (B, T, H, Dh) output
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[kNT][4], float div0,
                                           float div1, int b, int h, int H, int Tn, int Dh,
                                           int row0, int c0, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= Tn) continue;
    const float div = half ? div1 : div0;
    float* dst = out + (((int64_t)b * Tn + row) * H + h) * Dh + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc[n][2 * half] / div, acc[n][2 * half + 1] / div);
  }
}

__device__ __forceinline__ void zero(float (&a)[kNT][4]) {
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[n][e] = 0.f;
}

// --- the forward ---------------------------------------------------------------

// G row groups of 16 q rows resident, two stages of k and v tiles, the
// partial scores' exchange (one slot a warp)
template <int G>
int fwd_floats(int P) {
  const int ld = kWarpCols * P + 4;
  return 16 * G * ld + 2 * 2 * kTile * ld + G * P * 4 * 32;
}

// One block per (bh, 16 G q rows), 32 G P threads: o (B, T, H, Dh)
// contiguous, lse (B*H, T). Warp w serves row group w % G, columns 128 (w /
// G) ...
template <int G, int MAXP>
__global__ void __launch_bounds__(32 * G * MAXP, 1)
flash_fwd_wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int H, int Tn, int64_t sb, int64_t st,
                          int64_t sh, float scale, int causal, int P) {
  constexpr int R = 16 * G, KT = kTile;
  const int Dh = kWarpCols * P, LD = Dh + 4, STAGE = 2 * KT * LD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* ring = Qs + R * LD;     // stage s: k tile at ring + s STAGE, v tile after it
  float* xs = ring + 2 * STAGE;  // the partial scores, one slot a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int pr = warp % G, c0 = (warp / G) * kWarpCols;
  const Share share{pr, G, c0 + 4 * lane};
  const int nt = (Tn + R - 1) / R;
  // the q tiles of one (b, h) in a row, its longest causal rows first
  const int bh = (int)blockIdx.x / nt, b = bh / H, h = bh % H;
  const int q0 = (nt - 1 - (int)blockIdx.x % nt) * R;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  const float *kg = k + off, *vg = v + off;
  const int ntk = (Tn + KT - 1) / KT;
  // causal: no row of this block sees a k tile past q0 + R - 1
  const int nk = causal ? min((q0 + R) / KT, ntk) : ntk;
  auto stage_kv = [&](int i) {
    float* dst = ring + (i & 1) * STAGE;
    stage_rows(dst, kg, st, i * KT, KT, Tn, LD, share);
    stage_rows(dst + KT * LD, vg, st, i * KT, KT, Tn, LD, share);
    cp_async_commit();
  };
  stage_kv(0);
  // q, scaled before the product as the TPU kernel does (:92); rows past T zero
  for (int r = pr; r < R; r += G) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Tn)
      x = *reinterpret_cast<const float4*>(q + off + (int64_t)(q0 + r) * st + share.c);
    *reinterpret_cast<float4*>(Qs + r * LD + share.c) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  const float* qa = a_lane(Qs, 16 * pr, lane, LD);
  const int row0 = q0 + 16 * pr + g;  // this thread's rows: row0 and row0 + 8
  float acc[kNT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  zero(acc);

  for (int i = 0; i < nk; ++i) {
    cp_async_wait_all();
    __syncthreads();  // tile i has landed, and every warp is done with tile i - 1
    if (i + 1 < nk) stage_kv(i + 1);
    const float* Ks = ring + (i & 1) * STAGE;
    const float* Vs = Ks + KT * LD;
    const int k0 = i * KT;
    float s[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    scores(s[0], qa, b_lane(Ks, lane, LD), c0);
    group_add<1>(s, xs, warp, pr, G, P, lane);
    if (k0 + KT > Tn || (causal && k0 + KT - 1 > q0)) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
        if (col >= Tn || (causal && col > row)) s[0][e] = kNegInf;
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float nm = fmaxf(m[r], quad_max(fmaxf(s[0][2 * r], s[0][2 * r + 1])));
      corr[r] = expf(m[r] - nm);
      s[0][2 * r] = expf(s[0][2 * r] - nm);
      s[0][2 * r + 1] = expf(s[0][2 * r + 1] - nm);
      l[r] = l[r] * corr[r] + quad_sum(s[0][2 * r] + s[0][2 * r + 1]);
      m[r] = nm;
    }
    uint32_t ph[4], pl[4];
    prob_fragment(s[0], ph, pl);
    add_product(acc, ph, pl, Vs, LD, c0, g, t, corr, 1.f);
  }

  const float ls0 = fmaxf(l[0], 1e-30f), ls1 = fmaxf(l[1], 1e-30f);
  if (c0 == 0 && t == 0) {
    if (row0 < Tn) lse[(int64_t)bh * Tn + row0] = m[0] + logf(ls0);
    if (row0 + 8 < Tn) lse[(int64_t)bh * Tn + row0 + 8] = m[1] + logf(ls1);
  }
  store_rows(o, acc, ls0, ls1, b, h, H, Tn, Dh, row0, c0, t);
}

// --- dq ------------------------------------------------------------------------

// 16 q and dO rows resident, two stages of k tiles, one of v tiles
// (refilled once the block has added its scores), the partial scores S and
// dP (one slot a warp)
int dq_floats(int P) {
  const int ld = kWarpCols * P + 4;
  return 2 * 16 * ld + 3 * kTile * ld + P * 2 * 4 * 32;
}

// One block per (bh, 16 q rows), 32 P threads: dq (B, T, H, Dh)
// contiguous. dout is contiguous; lse and delta are (B*H, T).
template <int MAXP>
__global__ void __launch_bounds__(32 * MAXP, 1)
flash_dq_wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, int H, int Tn, int64_t sb, int64_t st,
                         int64_t sh, float scale, int causal, int P) {
  constexpr int G = 1, R = 16 * G, KT = kTile;
  const int Dh = kWarpCols * P, LD = Dh + 4, TILE = KT * LD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + R * LD;     // dO
  float* kr = Os + R * LD;     // k tiles, two stages
  float* vr = kr + 2 * TILE;   // the v tile, one stage
  float* xs = vr + TILE;       // the partial scores S and dP, one slot a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int pr = warp % G, c0 = (warp / G) * kWarpCols;
  const Share share{pr, G, c0 + 4 * lane};
  const int nt = (Tn + R - 1) / R;
  const int bh = (int)blockIdx.x / nt, b = bh / H, h = bh % H;
  const int q0 = (nt - 1 - (int)blockIdx.x % nt) * R;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  const int64_t doff = ((int64_t)b * Tn * H + h) * Dh;
  const float *kg = k + off, *vg = v + off;
  const int ntk = (Tn + KT - 1) / KT;
  // causal: no k tile past the block's last row
  const int nk = causal ? min((q0 + R) / KT, ntk) : ntk;
  stage_rows(Qs, q + off, st, q0, R, Tn, LD, share);
  stage_rows(Os, dout + doff, (int64_t)H * Dh, q0, R, Tn, LD, share);
  stage_rows(kr, kg, st, 0, KT, Tn, LD, share);
  stage_rows(vr, vg, st, 0, KT, Tn, LD, share);
  cp_async_commit();

  const float* qa = a_lane(Qs, 16 * pr, lane, LD);
  const float* oa = a_lane(Os, 16 * pr, lane, LD);
  const int row0 = q0 + 16 * pr + g;
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lr[r] = row < Tn ? lse[(int64_t)bh * Tn + row] : 0.f;
    dr[r] = row < Tn ? delta[(int64_t)bh * Tn + row] : 0.f;
  }
  float acc[kNT][4];
  zero(acc);
  const float one[2] = {1.f, 1.f};

  for (int i = 0; i < nk; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < nk) {
      stage_rows(kr + ((i + 1) & 1) * TILE, kg, st, (i + 1) * KT, KT, Tn, LD, share);
      cp_async_commit();
    }
    const float* Ks = kr + (i & 1) * TILE;
    const float* Vs = vr;
    const int k0 = i * KT;
    // S = Q K^T (sp[0]) and dP = dO V^T (sp[1]) over this warp's 128
    // columns, each in two chains (even and odd 8-column steps) as scores()
    float sp[2][4], odd[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[n][e] = odd[n][e] = 0.f;
    {
      const float *kb = b_lane(Ks, lane, LD), *vb = b_lane(Vs, lane, LD);
#pragma unroll 2
      for (int d = c0; d < c0 + kWarpCols; d += 16) {
        uint32_t r[4], qh[4], ql[4], q2h[4], q2l[4], oh[4], ol[4], o2h[4], o2l[4];
        ldsm_x4(qa + d, r);
        split4(r, qh, ql);
        ldsm_x4(qa + d + 8, r);
        split4(r, q2h, q2l);
        ldsm_x4(oa + d, r);
        split4(r, oh, ol);
        ldsm_x4(oa + d + 8, r);
        split4(r, o2h, o2l);
        const BPair kf = load_b(kb + d), vf = load_b(vb + d);
        mma3(sp[0], qh, ql, kf.h0, kf.l0);
        mma3(odd[0], q2h, q2l, kf.h1, kf.l1);
        mma3(sp[1], oh, ol, vf.h0, vf.l0);
        mma3(odd[1], o2h, o2l, vf.h1, vf.l1);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[n][e] += odd[n][e];
    group_add<2>(sp, xs, warp, pr, G, P, lane);
    // one v stage: the block has read this tile's v (the group is the block)
    if (i + 1 < nk) {
      stage_rows(vr, vg, st, (i + 1) * KT, KT, Tn, LD, share);
      cp_async_commit();
    }
    // ds = p (dp - delta), p = exp(scale s - lse), masked entries p = 0
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
      float x = scale * sp[0][e];
      if (col >= Tn || (causal && col > row)) x = kNegInf;
      const float p = expf(x - lr[e >> 1]);
      ds[e] = p * (sp[1][e] - dr[e >> 1]);
    }
    uint32_t dh[4], dl[4];
    prob_fragment(ds, dh, dl);
    add_product(acc, dh, dl, Ks, LD, c0, g, t, one, scale);
  }
  store_rows(dq, acc, 1.f, 1.f, b, h, H, Tn, Dh, row0, c0, t);
}

// --- dk/dv ---------------------------------------------------------------------

// 16 key rows of k and v resident, two stages of q and dO tiles; the
// partial scores in the ring stage the next tile will fill, which is issued
// once they are read
int dkv_floats(int P) {
  const int ld = kWarpCols * P + 4;
  return 2 * 16 * ld + 2 * 2 * kTile * ld;
}

// One block per (bh, 16 key rows), 64 P threads: dk and dv (B, T, H, Dh)
// contiguous. dout is contiguous; lse and delta are (B*H, T). Warp w is
// role * P + part: role 0 sums dv, role 1 dk, over columns 128 part ...
template <int MAXP>
__global__ void __launch_bounds__(64 * MAXP, 1)
flash_dkv_wide_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int H, int Tn,
                          int64_t sb, int64_t st, int64_t sh, float scale, int causal, int P) {
  constexpr int G = 1, R = 16 * G, QT = kTile, kSlot = 4 * 32;
  const int Dh = kWarpCols * P, LD = Dh + 4, STAGE = 2 * QT * LD;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + R * LD;
  float* ring = Vs + R * LD;  // stage s: q tile at ring + s STAGE, dO tile after it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int pr = warp % G, role = warp / (G * P), c0 = (warp / G % P) * kWarpCols;
  // a copy's rows are shared by the block's 2 G warps of one column part
  const Share share{warp / P, 2 * G, (warp % P) * kWarpCols + 4 * lane};
  const int nt = (Tn + R - 1) / R;
  // the key tiles of one (b, h) in a row, the keys the most causal rows see first
  const int bh = (int)blockIdx.x / nt, b = bh / H, h = bh % H;
  const int k0 = ((int)blockIdx.x % nt) * R;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  const int64_t doff = ((int64_t)b * Tn * H + h) * Dh;
  const float *qg = q + off, *og = dout + doff;
  const int ntq = (Tn + QT - 1) / QT;
  // causal: no row of an earlier q tile sees these keys
  const int first = causal ? k0 / QT : 0;
  auto stage_qo = [&](int j) {
    float* dst = ring + (j & 1) * STAGE;
    stage_rows(dst, qg, st, j * QT, QT, Tn, LD, share);
    stage_rows(dst + QT * LD, og, (int64_t)H * Dh, j * QT, QT, Tn, LD, share);
    cp_async_commit();
  };
  stage_rows(Ks, k + off, st, k0, R, Tn, LD, share);
  stage_rows(Vs, v + off, st, k0, R, Tn, LD, share);
  stage_qo(first);  // one group with k and v

  // role 0: S = K Q^T and P^T dO; role 1: dP = V dO^T and dS^T Q
  const float* ra = a_lane(role ? Vs : Ks, 16 * pr, lane, LD);
  const float* lq = lse + (int64_t)bh * Tn;
  const float* dlq = delta + (int64_t)bh * Tn;
  const int row0 = k0 + 16 * pr + g;  // this thread's keys: row0 and row0 + 8
  const float one[2] = {1.f, 1.f};
  const float fac = role ? scale : 1.f;
  float acc[kNT][4];
  zero(acc);

  for (int j = first; j < ntq; ++j) {
    const int q0 = j * QT;
    // lse and delta of this lane's queries q0 + 2 t + e; 0 past T
    float lv[2], dlv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = q0 + 2 * t + e;
      lv[e] = col < Tn ? lq[col] : 0.f;
      dlv[e] = col < Tn ? dlq[col] : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();  // tile j has landed, and every warp is done with tile j - 1
    const float* Qt = ring + (j & 1) * STAGE;
    const float* Ot = Qt + QT * LD;
    float* xs = ring + ((j + 1) & 1) * STAGE;  // the exchange, in the next tile's stage
    // this warp's partial of S = K Q^T (role 0) or dP = V dO^T (role 1)
    float s[1][4] = {{0.f, 0.f, 0.f, 0.f}}, dp[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    scores(s[0], ra, b_lane(role ? Ot : Qt, lane, LD), c0);
    write_part<1>(xs + warp * kSlot, s, lane);
    bar_sync(1 + pr, 64 * P);  // the group's 2 P warps
    // S in the fixed order (both roles: the same bits), dP (role 1)
    sum_parts<1>(s, xs + pr * kSlot, G * kSlot, P, lane);
    if (role) sum_parts<1>(dp, xs + (G * P + pr) * kSlot, G * kSlot, P, lane);
    __syncthreads();  // the exchange is read: the next tile may fill its stage
    if (j + 1 < ntq) stage_qo(j + 1);
    // p = exp(scale s - lse), 0 where causal masks (key > query) and past T;
    // role 1 forms ds = p (dp - delta)
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = q0 + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
      float x = scale * s[0][e];
      if (causal && row > col) x = kNegInf;
      const float p = col < Tn ? expf(x - lv[e & 1]) : 0.f;
      f[e] = role ? p * (dp[0][e] - dlv[e & 1]) : p;
    }
    uint32_t fh[4], fl[4];
    prob_fragment(f, fh, fl);
    add_product(acc, fh, fl, role ? Qt : Ot, LD, c0, g, t, one, fac);
  }
  store_rows(role ? dk : dv, acc, 1.f, 1.f, b, h, H, Tn, Dh, row0, c0, t);
}

// --- launches ------------------------------------------------------------------

struct Args {
  int B, H, T, P;
  int64_t sb, st, sh;
  float scale;
  int causal;
};

// one block per (bh, tile of ``rows``), the tiles of one bh consecutive
dim3 grid(const Args& a, int rows) {
  return dim3((unsigned)(a.B * a.H * ((a.T + rows - 1) / rows)));
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

template <int G, int MAXP>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       const Args& a, cudaStream_t s) {
  const int floats = fwd_floats<G>(a.P);
  cudaError_t e = prepare(flash_fwd_wide_f32_kernel<G, MAXP>, floats);
  if (e != cudaSuccess) return e;
  flash_fwd_wide_f32_kernel<G, MAXP><<<grid(a, 16 * G), 32 * G * a.P,
                                       floats * sizeof(float), s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, a.H, a.T, a.sb, a.st,
      a.sh, a.scale, a.causal, a.P);
  return cudaGetLastError();
}

template <int MAXP>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, const Args& a,
                      cudaStream_t s) {
  const int floats = dq_floats(a.P);
  cudaError_t e = prepare(flash_dq_wide_f32_kernel<MAXP>, floats);
  if (e != cudaSuccess) return e;
  flash_dq_wide_f32_kernel<MAXP><<<grid(a, 16), 32 * a.P, floats * sizeof(float), s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dq, a.H, a.T, a.sb, a.st, a.sh, a.scale, a.causal, a.P);
  return cudaGetLastError();
}

template <int MAXP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       const Args& a, cudaStream_t s) {
  const int floats = dkv_floats(a.P);
  cudaError_t e = prepare(flash_dkv_wide_f32_kernel<MAXP>, floats);
  if (e != cudaSuccess) return e;
  flash_dkv_wide_f32_kernel<MAXP><<<grid(a, 16), 64 * a.P, floats * sizeof(float), s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, a.H, a.T, a.sb, a.st, a.sh, a.scale, a.causal, a.P);
  return cudaGetLastError();
}

// the arguments, or false where no kernel here takes them: Dh 512-896 (the
// backward's entry points from `min_parts` parts, Dh 640)
bool make_args(Args* a, int B, int H, int T, int Dh, int is_bf16, long long sb, long long st,
               long long sh, float scale, int causal, int min_parts = kMinParts) {
  const int P = Dh / kWarpCols;
  if (is_bf16 || B <= 0 || H <= 0 || T <= 0 || Dh % kWarpCols || P < min_parts ||
      P > kMaxParts || (int64_t)B * H * ((T + 15) / 16) > 0x7fffffffLL)
    return false;
  *a = Args{B, H, T, P, sb, st, sh, scale, causal};
  return true;
}

}  // namespace

// q, k, v (B, T, H, Dh) float32 sharing the element strides (sb, st, sh),
// Dh contiguous, 16-byte aligned rows; o (B, T, H, Dh) and lse (B*H, T)
// contiguous outputs. Takes Dh 512, 640, 768 and 896 with is_bf16 = 0 only.
// Returns the cudaError_t of the launch.
extern "C" int fedml_flash_fwd_wide_f32_sm90(const void* q, const void* k, const void* v,
                                             void* o, float* lse, int B, int H, int T, int Dh,
                                             int is_bf16, int causal, long long sb,
                                             long long st, long long sh, float scale,
                                             void* stream) {
  Args a;
  if (!make_args(&a, B, H, T, Dh, is_bf16, sb, st, sh, scale, causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.P == 4) return (int)launch_fwd<4, 4>(q, k, v, o, lse, a, s);
  if (a.P <= 6) return (int)launch_fwd<2, 6>(q, k, v, o, lse, a, s);
  return (int)launch_fwd<1, 7>(q, k, v, o, lse, a, s);
}

// dq (B, T, H, Dh) contiguous from q, k, v (strided as for the forward),
// dout (B, T, H, Dh) contiguous, and the forward's lse and delta =
// rowsum(dO * O), both (B*H, T) float32. Takes Dh 640-896 with is_bf16 = 0.
extern "C" int fedml_flash_dq_wide_f32_sm90(const void* q, const void* k, const void* v,
                                            const void* dout, const float* lse,
                                            const float* delta, void* dq, int B, int H, int T,
                                            int Dh, int is_bf16, int causal, long long sb,
                                            long long st, long long sh, float scale,
                                            void* stream) {
  Args a;
  if (!make_args(&a, B, H, T, Dh, is_bf16, sb, st, sh, scale, causal, kMinParts + 1))
    return (int)cudaErrorInvalidValue;
  return (int)launch_dq<kMaxParts>(q, k, v, dout, lse, delta, dq, a, (cudaStream_t)stream);
}

// dk and dv (B, T, H, Dh) contiguous, from the same inputs as dq. Takes Dh
// 640-896 as dq.
extern "C" int fedml_flash_dkv_wide_f32_sm90(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse,
                                             const float* delta, void* dk, void* dv, int B,
                                             int H, int T, int Dh, int is_bf16, int causal,
                                             long long sb, long long st, long long sh,
                                             float scale, void* stream) {
  Args a;
  if (!make_args(&a, B, H, T, Dh, is_bf16, sb, st, sh, scale, causal, kMinParts + 1))
    return (int)cudaErrorInvalidValue;
  return (int)launch_dkv<kMaxParts>(q, k, v, dout, lse, delta, dk, dv, a,
                                    (cudaStream_t)stream);
}
