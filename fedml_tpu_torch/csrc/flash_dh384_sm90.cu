// Flash attention's forward, dq and dk/dv at head dim 384 for bfloat16 (B,
// T, H, 384) inputs on the Hopper tensor cores, causal or full, any T: the
// Cheetah example's attention at --dim 3072 (8 heads of 384).
//
// Replaces: fedml_tpu/ops/pallas/flash_attention.py at Dh 384 —
// _flash_kernel (:66, the forward of _flash_forward :129, call :140: o =
// softmax(scale q k^T, causal mask) v and lse = m + log l), _dq_kernel
// (:167, call :287: p = exp(scale q k^T - lse), ds = p (dO v^T - delta), dq
// = sum scale ds k) and _dkv_kernel (:213, call :299: dv = sum p^T dO, dk =
// scale sum ds^T q). The arithmetic is flash_attention_sm90.cu's: bf16 x
// bf16 score products exact with float32 sums, p and ds as three bf16 terms
// (exact to float32), each 64-row tile's products from a zero accumulator
// added in float32, finfo(float32).min masking, l clamped at 1e-30, the
// scale 1/sqrt(384) applied after Q K^T.
//
// Bound on the H100 at the example's shape (B 8, T 4352, H 8, causal):
// 606,216,192 unmasked (q, k) pairs x 2 x 384 operations = 0.4656 TFLOP a
// product. The forward does one bf16 product and one split product (1 + 3
// tensor-core products), dq two and one (2 + 3), dk/dv two and two (2 +
// 6): 1.883, 2.354 and 3.766 ms at 989 TFLOP/s, against ~0.3 ms of bytes at
// 3.35 TB/s. Bound by operations.
//
// What Dh 384 changes against flash_dh256_sm90.cu: a 64 x 384 bf16 tile is
// 48 KB, and a 64 x 384 float32 accumulator is 192 registers a thread, so
// no warpgroup can hold a whole output row beside its scores and split
// terms, and neither the Dh-256 forward's 128 q rows with a two-stage k/v
// ring (288 KB) nor its dk/dv's two q/dO stages fit 227 KB. Here each of
// two warpgroups owns half of the output columns (three 64-column groups,
// a 96-register accumulator), and the score products are shared between
// them through 64 x 64 float32 exchange tiles in shared memory (row r's
// columns XOR-swizzled by 8 (r % 4)): no score product is computed twice
// in the forward and dq.
//
// Forward. A block takes 64 q rows. Warpgroup w computes the partial
// scores of its half of the 384 columns (12 k steps of wgmma m64n64k16),
// writes them to its exchange tile and adds the other's (one float32
// addition, commutative, so both hold the same bits of S = Q K^T); both
// run the same online softmax and split, then P V for their own three
// 64-column groups, one at a time into a 32-register accumulator from zero,
// added to the output in float32. Warpgroup 2 only issues copies
// (setmaxnreg gives its registers to the other two: 240 each). Shared
// memory: q (48 KB), two k stages, one v stage, two exchange tiles: 224 KB.
// Named barriers: both tiles written (kWritten); the other warpgroup has
// read my tile (kRead + w), before I overwrite it.
//
// dq. The forward's layout: a block takes 64 q rows, warpgroup 0 computes
// S = Q K^T and p = exp(scale S - lse), warpgroup 1 dP = dO V^T (each over
// all 384 columns), they exchange p and dP and both form ds = p (dP -
// delta) with the same bits, then run dS K for their own three column
// groups. q and dO stay resident; one k stage and one v stage (v is read
// only by dP, so it refills while dS K runs): 224 KB. On the causal
// diagonal both products are summed on the CUDA cores in a plain float32
// product's order (dots_plain), which repeats the plain version's rounding
// noise of dP - delta in row 0, where p = 1 on one key; that tile is a
// separate instance after the loop, with no wgmma, so no branch defines a
// wgmma accumulator (ptxas serializes every wgmma when one does, C7520).
// The operands of each warpgroup's product are chosen by address, not by a
// branch, for the same reason.
//
// dk/dv. A block takes a 64-row k tile with its v tile and one half of the
// dk and dv columns, and walks the q/dO tiles (with their lse and delta)
// from the diagonal on; the two halves are neighbouring blocks, so they
// meet the same q and dO tiles in L2. Warpgroup 0 computes S^T = K Q^T,
// forms p and sums dv = P^T dO over its half, warpgroup 1 computes dP^T = V
// dO^T, takes p from the exchange tile, forms ds and sums dk = dS^T Q: the
// score products are computed once per half (10 product units for the
// 8 of one block holding both halves, which would need 384 accumulator
// registers a thread). Shared memory: k and v (96 KB), one q/dO stage with
// its lse and delta (96.75 KB), one p tile (16 KB): 209 KB. Thread 0 of
// warpgroup 1 refills the stage once all 256 threads have arrived on its
// empty mbarrier.
//
// All three. Blocks go by (b, h), and within one the longest causal rows
// (dk/dv: the keys seen by the most rows) first. Tiles arrive by TMA: one
// 4-D tensor map per operand, (Dh, H, T, B) with the caller's element
// strides (q, k, v are strided views of one projection, rows 9,216 elements
// apart at 8 heads), six boxes of 64 columns x 64 rows a tile in the
// 128-byte swizzle; the hardware zero-fills rows at or past T. No atomics
// and one fixed order of every sum: dq, dk and dv repeat bit for bit. This
// is the first, simple form: one v stage (forward, dq) and one q/dO stage
// (dk/dv) leave copies exposed between tiles.

#include <type_traits>

#include "flash_tma_sm90.cuh"

namespace {

constexpr int kDh = 384;
constexpr int kGroups = kDh / 64;                  // 64-column groups of a row: 6
constexpr int kOwn = kGroups / 2;                  // a warpgroup's output groups: 3
constexpr int kTileBytes = kGroups * kGroupBytes;  // a 64 x 384 bf16 tile: 48 KB
constexpr int kXBytes = kXFloats * 4;              // one exchange tile: 16 KB
constexpr int kThreads = 2 * kWG;                  // the two warpgroups that compute
// forward and dq: a producer warpgroup besides, whose registers go to the
// other two (2 x 128 x 240 + 128 x 24 <= 65,536)
constexpr int kFwdThreads = 3 * kWG;
constexpr int kConsumerRegs = 240, kProducerRegs = 24;

// forward: q, two k stages, one v stage, two exchange tiles, 7 barriers (+
// alignment slack): 196,608 + 32,768 + 56 + 1,024 = 230,456 bytes; dq: q,
// dO, k, v, two exchange tiles, 5 barriers
constexpr int kFwdSmem = 4 * kTileBytes + 2 * kXBytes + 7 * 8 + 1024;
constexpr int kDqSmem = 4 * kTileBytes + 2 * kXBytes + 5 * 8 + 1024;
// dk/dv: k, v, q and dO, one p tile, lse and delta, 3 barriers
constexpr int kDkvSmem = 4 * kTileBytes + kXBytes + 2 * kVecSlot + 3 * 8 + 1024;
static_assert(kFwdSmem <= 232448 && kDqSmem <= 232448 && kDkvSmem <= 232448,
              "shared memory of one H100 block");

// named barriers of dk/dv (0 is __syncthreads; the forward's and dq's are
// exchange()'s): the p tile written, and read
constexpr int kPFull = 1, kPEmpty = 2;

__device__ __forceinline__ void zero(float (&acc)[kOwn][32]) {
#pragma unroll
  for (int g = 0; g < kOwn; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;
}

// rows row0, row0 + 8 of a (B, T, H, 384) output: this warpgroup's three
// column groups (from column 64 g0) of f(acc, row half), rounded to bf16
template <class F>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[kOwn][32], F f,
                                           int64_t b, int row0, int H, int h, int Tn, int g0,
                                           int c2) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= Tn) continue;
    bf16* dst = out + ((b * Tn + row) * H + h) * kDh + 64 * g0 + c2;
#pragma unroll
    for (int g = 0; g < kOwn; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 64 * g + 8 * j) = __floats2bfloat162_rn(
            f(acc[g][4 * j + 2 * hh], hh), f(acc[g][4 * j + 2 * hh + 1], hh));
  }
}

// --- the kernels ---------------------------------------------------------------

// One block per (bh, 64-row q tile): o (B, T, H, 384) contiguous, lse (B*H,
// T). Warpgroups 0 and 1 each own three of the six column groups; warpgroup
// 2 issues the copies.
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_dh384_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                       float* __restrict__ lse, int H, int Tn, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const uint32_t Qs = smem_addr(base);      // the block's q rows
  const uint32_t Ks = Qs + kTileBytes;      // k stage s at Ks + s kTileBytes
  const uint32_t Vs = Ks + 2 * kTileBytes;  // the v stage
  float* X = reinterpret_cast<float*>(base + 4 * kTileBytes);  // warpgroup w's at + w kXFloats
  // barriers: q; k stage s full (+ 8 s); v full; k stage s read by both
  // warpgroups (empty, + 8 s); v read
  const uint32_t qbar = smem_addr(base + 4 * kTileBytes + 2 * kXBytes);
  const uint32_t kfull = qbar + 8, vfull = qbar + 24, kempty = qbar + 32, vempty = qbar + 48;
  const int tid = threadIdx.x, warp = tid % kWG / 32, lane = tid % 32;
  // the warpgroup, through a shuffle, so that ptxas knows it is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  const int nt = (Tn + kTile - 1) / kTile;
  // blocks by (b, h), and within one the longest causal rows first
  const int bh = (int)blockIdx.x / nt, b = bh / H, h = bh % H;
  const int q0 = (nt - 1 - (int)blockIdx.x % nt) * kTile;
  const int nk = causal ? q0 / kTile + 1 : nt;  // k tiles: causal, none past the diagonal

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mbar_init(qbar + 8 * i, 1);
#pragma unroll
    for (int i = 4; i < 7; ++i) mbar_init(qbar + 8 * i, kThreads);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: q, then k tile t once tile t - 2 is read, v once t - 1 is
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 2 * kWG) {
      mbar_expect(qbar, kTileBytes);
      tma_tile<kDh>(Qs, &qmap, qbar, h, q0, b);
      for (int t = 0; t < nk; ++t) {
        const int s = t % 2;
        if (t >= 2) mbar_wait(kempty + 8 * s, (t / 2 - 1) & 1);
        mbar_expect(kfull + 8 * s, kTileBytes);
        tma_tile<kDh>(Ks + s * kTileBytes, &kmap, kfull + 8 * s, h, t * kTile, b);
        if (t >= 1) mbar_wait(vempty, (t - 1) & 1);
        mbar_expect(vfull, kTileBytes);
        tma_tile<kDh>(Vs, &vmap, vfull, h, t * kTile, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int r = 16 * warp + lane / 4;  // this thread's rows of the tile: r, r + 8
  const int row0 = q0 + r, c2 = 2 * (lane % 4);
  float acc[kOwn][32];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % 2;
    float x[32], y[32], corr[2];
    mbar_wait(kfull + 8 * s, (kt / 2) & 1);
    wg_fence();
    scores<kDh / 32>(x, Qs, Ks + s * kTileBytes, wg * (kDh / 32));  // this half's columns
    wg_commit();
    wg_wait<0>();
    pin(x);
    mbar_arrive(kempty + 8 * s);
    exchange(X, x, y, wg, kt, nk, r, c2);
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] += y[i];  // S, the same bits in both warpgroups
    softmax_tile(x, m, l, corr, kt * kTile, q0, row0, c2, Tn, causal, scale);
    uint32_t a[4][3][4];
    split_frags(x, a);
    mbar_wait(vfull, kt & 1);
#pragma unroll
    for (int g = 0; g < kOwn; ++g) {  // P V, one 64-column group at a time
      float pv[32];
      wg_fence();
      mma_split_group(pv, a, Vs, kOwn * wg + g);
      wg_commit();
      wg_wait<0>();
      pin(pv);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[g][i] = acc[g][i] * corr[(i >> 1) & 1] + pv[i];
    }
    mbar_arrive(vempty);
  }

  float ls[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    ls[hh] = fmaxf(l[hh], 1e-30f);
    const int row = row0 + 8 * hh;
    if (wg == 0 && lane % 4 == 0 && row < Tn) lse[(int64_t)bh * Tn + row] = m[hh] + logf(ls[hh]);
  }
  store_rows(o, acc, [&](float v, int hh) { return v / ls[hh]; }, b, row0, H, h, Tn, kOwn * wg,
             c2);
}

// One block per (bh, 64-row q tile): dq (B, T, H, 384) contiguous. dO is
// contiguous; lse and delta are (B*H, T). Warpgroup 0 forms p, warpgroup 1
// dP; each sums dq over three of the six column groups; warpgroup 2 issues
// the copies.
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_dq_dh384_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Tn,
                      float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const uint32_t Qs = smem_addr(base), Os = Qs + kTileBytes;  // the block's q and dO rows
  const uint32_t Ks = Os + kTileBytes, Vs = Ks + kTileBytes;  // the k and v stages
  float* X = reinterpret_cast<float*>(base + 4 * kTileBytes);  // p at X, dP at X + kXFloats
  // barriers: q and dO; k full; v full; k read by both warpgroups (empty);
  // v read (by warpgroup 1; warpgroup 0 arrives unread)
  const uint32_t qbar = smem_addr(base + 4 * kTileBytes + 2 * kXBytes);
  const uint32_t kfull = qbar + 8, vfull = qbar + 16, kempty = qbar + 24, vempty = qbar + 32;
  const int tid = threadIdx.x, warp = tid % kWG / 32, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  const int nt = (Tn + kTile - 1) / kTile;
  const int bh = (int)blockIdx.x / nt, b = bh / H, h = bh % H;
  const int q0 = (nt - 1 - (int)blockIdx.x % nt) * kTile;
  const int nk = causal ? q0 / kTile + 1 : nt;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(qbar + 8 * i, 1);
    mbar_init(kempty, kThreads);
    mbar_init(vempty, kThreads);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: v tile t once t - 1 is read, then k tile t likewise
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 2 * kWG) {
      mbar_expect(qbar, 2 * kTileBytes);
      tma_tile<kDh>(Qs, &qmap, qbar, h, q0, b);
      tma_tile<kDh>(Os, &omap, qbar, h, q0, b);
      for (int t = 0; t < nk; ++t) {
        if (t >= 1) mbar_wait(vempty, (t - 1) & 1);
        mbar_expect(vfull, kTileBytes);
        tma_tile<kDh>(Vs, &vmap, vfull, h, t * kTile, b);
        if (t >= 1) mbar_wait(kempty, (t - 1) & 1);
        mbar_expect(kfull, kTileBytes);
        tma_tile<kDh>(Ks, &kmap, kfull, h, t * kTile, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int r = 16 * warp + lane / 4;  // this thread's rows of the tile: r, r + 8
  const int row0 = q0 + r, c2 = 2 * (lane % 4);
  float lr[2], dr[2];  // lse and delta of this thread's rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    lr[hh] = row < Tn ? lse[(int64_t)bh * Tn + row] : 0.f;
    dr[hh] = row < Tn ? delta[(int64_t)bh * Tn + row] : 0.f;
  }
  float dqa[kOwn][32];
  zero(dqa);
  // this warpgroup's score product (S = Q K^T or dP = dO V^T) and the
  // barrier of its right-hand tile, chosen by address
  const uint32_t lhs = wg == 0 ? Qs : Os, rhs = wg == 0 ? Ks : Vs;
  const uint32_t rfull = wg == 0 ? kfull : vfull;
  // k tile kt: the score product, on the causal diagonal (DIAG) summed by
  // dots_plain in a plain float32 product's order instead; p (warpgroup 0);
  // the exchange; ds; dS K for this warpgroup's column groups
  auto tile = [&](int kt, auto diag) {
    constexpr bool DIAG = decltype(diag)::value;
    const int k0 = kt * kTile;
    float x[32], y[32];
    mbar_wait(rfull, kt & 1);
    if constexpr (DIAG) {
      dots_plain<kDh>(x, base + (lhs - Qs), base + (rhs - Qs), r, c2);
    } else {
      wg_fence();
      scores<kDh / 16>(x, lhs, rhs);
      wg_commit();
      wg_wait<0>();
      pin(x);
    }
    mbar_arrive(vempty);
    if (wg == 0) {  // p = exp(scale s - lse); keys at or past T give p = 0
      // only a tile across T or on the diagonal needs the mask
      const bool edge = k0 + kTile > Tn || (causal && k0 + kTile - 1 > q0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + c2 + e;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int at = 4 * j + 2 * hh + e;
            float sc = scale * x[at];
            if (edge && causal && col > row0 + 8 * hh) sc = kNegInf;
            x[at] = !edge || col < Tn ? expf(sc - lr[hh]) : 0.f;
          }
        }
    }
    exchange(X, x, y, wg, kt, nk, r, c2);
#pragma unroll
    for (int i = 0; i < 32; ++i) {  // ds = p (dP - delta), the same bits in both
      const float p = wg == 0 ? x[i] : y[i], dp = wg == 0 ? y[i] : x[i];
      x[i] = p * (dp - dr[(i >> 1) & 1]);
    }
    uint32_t a[4][3][4];
    split_frags(x, a);
    mbar_wait(kfull, kt & 1);
#pragma unroll
    for (int g = 0; g < kOwn; ++g) {
      float t[32];
      wg_fence();
      mma_split_group(t, a, Ks, kOwn * wg + g);
      wg_commit();
      wg_wait<0>();
      pin(t);
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[g][i] += scale * t[i];
    }
    mbar_arrive(kempty);
  };
  mbar_wait(qbar, 0);
  const int nfull = causal ? nk - 1 : nk;  // causal: the last k tile is the diagonal
  for (int kt = 0; kt < nfull; ++kt) tile(kt, std::false_type());
  if (causal) tile(nk - 1, std::true_type());

  store_rows(dq, dqa, [](float v, int) { return v; }, b, row0, H, h, Tn, kOwn * wg, c2);
}

// One block per (bh, 64-row k tile, column half): dk and dv (B, T, H, 384)
// contiguous. dO is contiguous; lse and delta are (B*H, T). Warpgroup 0
// forms p and sums dv, warpgroup 1 forms ds from that p and sums dk, both
// over the block's three column groups.
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_dh384_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap,
                       const __grid_constant__ CUtensorMap lmap,
                       const __grid_constant__ CUtensorMap dmap, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int H, int Tn, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const uint32_t Ks = smem_addr(base), Vs = Ks + kTileBytes;  // the block's keys
  const uint32_t Qs = Vs + kTileBytes, Os = Qs + kTileBytes;  // the q/dO stage
  float* P = reinterpret_cast<float*>(base + 4 * kTileBytes);  // p of the stage's q tile
  uint8_t* vecs = base + 4 * kTileBytes + kXBytes;  // its lse, delta kVecSlot after it
  // barriers: k and v; the stage full; the stage read by all 256 threads (empty)
  const uint32_t kvbar = smem_addr(vecs + 2 * kVecSlot), full = kvbar + 8, empty = kvbar + 16;
  const int tid = threadIdx.x, warp = tid % kWG / 32, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  const int nq = (Tn + kTile - 1) / kTile;
  // blocks by (b, h), within one the keys seen by the most causal rows
  // first, the two column halves of a k tile side by side
  const int half = (int)blockIdx.x % 2, kb = (int)blockIdx.x / 2;
  const int bh = kb / nq, b = bh / H, h = bh % H;
  const int k0 = kb % nq * kTile;
  const int first = causal ? k0 / kTile : 0;  // causal: earlier q tiles see none of these keys
  const int n = nq - first;                   // q tiles of this block
  const int r = 16 * warp + lane / 4;         // this thread's keys of the tile: r, r + 8
  const int row0 = k0 + r, c2 = 2 * (lane % 4);
  const bool issuer = tid == kWG;  // warpgroup 1, which reads each stage last, refills it
  // where the q tile at q0 starts in its lse and delta boxes
  auto vec_skip = [&](int q0) { return (bh * Tn + q0) & 3; };
  // issuer only: the i-th q tile, its dO tile, lse and delta
  auto load_q = [&](int i) {
    if (i < n) {
      const int q0 = (first + i) * kTile;
      const int v0 = bh * Tn + q0 - vec_skip(q0);
      mbar_expect(full, 2 * kTileBytes + 2 * kVecBox * 4);
      tma_tile<kDh>(Qs, &qmap, full, h, q0, b);
      tma_tile<kDh>(Os, &omap, full, h, q0, b);
      tma_1d(smem_addr(vecs), &lmap, full, v0);
      tma_1d(smem_addr(vecs + kVecSlot), &dmap, full, v0);
    }
  };

  if (tid == 0) {
    mbar_init(kvbar, 1);
    mbar_init(full, 1);
    mbar_init(empty, kThreads);
    mbar_init_fence();
  }
  __syncthreads();
  if (issuer) {
    mbar_expect(kvbar, 2 * kTileBytes);
    tma_tile<kDh>(Ks, &kmap, kvbar, h, k0, b);
    tma_tile<kDh>(Vs, &vmap, kvbar, h, k0, b);
    load_q(0);
  }
  __syncwarp();
  float acc[kOwn][32];  // warpgroup 0: dv, warpgroup 1: dk (scaled at the end)
  zero(acc);
  // S^T = K Q^T then P^T dO (warpgroup 0), or dP^T = V dO^T then dS^T Q
  const uint32_t lhs = wg == 0 ? Ks : Vs, rhs = wg == 0 ? Qs : Os, right = wg == 0 ? Os : Qs;
  mbar_wait(kvbar, 0);

  for (int i = 0; i < n; ++i) {
    mbar_wait(full, i & 1);
    const int q0 = (first + i) * kTile;
    const float* lv = reinterpret_cast<const float*>(vecs) + vec_skip(q0);
    float x[32];
    wg_fence();
    scores<kDh / 16>(x, lhs, rhs);
    wg_commit();
    wg_wait<0>();
    pin(x);
    if (wg == 0) {
      // only a tile across T or on the diagonal needs the mask
      const bool edge = q0 + kTile > Tn || (causal && q0 == k0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + c2 + e, col = q0 + c;
          const float lc = lv[c];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int at = 4 * j + 2 * hh + e;
            float s = scale * x[at];
            if (edge && causal && row0 + 8 * hh > col) s = kNegInf;
            x[at] = !edge || col < Tn ? expf(s - lc) : 0.f;
          }
        }
      if (i >= 1) named_sync<kThreads>(kPEmpty);  // warpgroup 1 has read p of tile i - 1
      put_tile(P, x, r, c2);
      named_arrive<kThreads>(kPFull);
    } else {
      const float* dl = lv + kVecSlot / 4;
      named_sync<kThreads>(kPFull);  // p of tile i is in P
      float p[32];
      get_tile(P, p, r, c2);
      if (i + 1 < n) named_arrive<kThreads>(kPEmpty);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dc = dl[8 * j + c2 + e];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int at = 4 * j + 2 * hh + e;
            x[at] = p[at] * (x[at] - dc);  // ds
          }
        }
    }
    uint32_t a[4][3][4];
    split_frags(x, a);
#pragma unroll
    for (int g = 0; g < kOwn; ++g) {
      float t[32];
      wg_fence();
      mma_split_group(t, a, right, kOwn * half + g);
      wg_commit();
      wg_wait<0>();
      pin(t);
#pragma unroll
      for (int m = 0; m < 32; ++m) acc[g][m] += t[m];
    }
    mbar_arrive(empty);  // this thread is done with the stage
    if (issuer) {
      mbar_wait(empty, i & 1);
      load_q(i + 1);
    }
    __syncwarp();
  }

  const float mul = wg == 0 ? 1.f : scale;
  store_rows(wg == 0 ? dv : dk, acc, [&](float v, int) { return mul * v; }, b, row0, H, h, Tn,
             kOwn * half, c2);
}

}  // namespace

// The entry points take the arguments of fedml_flash_fwd_sm90,
// fedml_flash_dq_sm90 and fedml_flash_dkv_sm90 (flash_attention_sm90.cu)
// and only Dh 384 bfloat16 (is_bf16 = 1): q, k, v (B, T, H, 384) share the
// element strides (sb, st, sh) with Dh contiguous and 16-byte aligned rows;
// dO, lse and delta and the outputs are contiguous. Return the launch's
// cudaError_t (cudaErrorInvalidValue when a tensor map cannot be made).
extern "C" int fedml_flash_fwd_dh384_sm90(const void* q, const void* k, const void* v, void* o,
                                          float* lse, int B, int H, int T, int Dh, int is_bf16,
                                          int causal, long long sb, long long st, long long sh,
                                          float scale, void* stream) {
  CUtensorMap qm, km, vm;
  if (!args_ok<kDh>(B, H, T, Dh, is_bf16) || !map_rows<kDh>(&qm, q, B, H, T, sb, st, sh) ||
      !map_rows<kDh>(&km, k, B, H, T, sb, st, sh) || !map_rows<kDh>(&vm, v, B, H, T, sb, st, sh))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_dh384_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_dh384_kernel<<<grid(B, H, T, kTile), kFwdThreads, kFwdSmem, (cudaStream_t)stream>>>(
      qm, km, vm, (bf16*)o, lse, H, T, scale, causal);
  return (int)cudaGetLastError();
}

extern "C" int fedml_flash_dq_dh384_sm90(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse, const float* delta,
                                         void* dq, int B, int H, int T, int Dh, int is_bf16,
                                         int causal, long long sb, long long st, long long sh,
                                         float scale, void* stream) {
  CUtensorMap qm, km, vm, om;
  const int64_t hd = (int64_t)H * kDh;  // dO's row stride
  if (!args_ok<kDh>(B, H, T, Dh, is_bf16) || !map_rows<kDh>(&qm, q, B, H, T, sb, st, sh) ||
      !map_rows<kDh>(&km, k, B, H, T, sb, st, sh) || !map_rows<kDh>(&vm, v, B, H, T, sb, st, sh) ||
      !map_rows<kDh>(&om, dout, B, H, T, T * hd, hd, kDh))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_dq_dh384_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (e != cudaSuccess) return (int)e;
  flash_dq_dh384_kernel<<<grid(B, H, T, kTile), kFwdThreads, kDqSmem, (cudaStream_t)stream>>>(
      qm, km, vm, om, lse, delta, (bf16*)dq, H, T, scale, causal);
  return (int)cudaGetLastError();
}

extern "C" int fedml_flash_dkv_dh384_sm90(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse, const float* delta,
                                          void* dk, void* dv, int B, int H, int T, int Dh,
                                          int is_bf16, int causal, long long sb, long long st,
                                          long long sh, float scale, void* stream) {
  CUtensorMap qm, km, vm, om, lm, dm;
  const int64_t hd = (int64_t)H * kDh;  // dO's row stride
  if (!args_ok<kDh>(B, H, T, Dh, is_bf16) || !map_rows<kDh>(&qm, q, B, H, T, sb, st, sh) ||
      !map_rows<kDh>(&km, k, B, H, T, sb, st, sh) || !map_rows<kDh>(&vm, v, B, H, T, sb, st, sh) ||
      !map_rows<kDh>(&om, dout, B, H, T, T * hd, hd, kDh) ||
      !map_vec(&lm, lse, (int64_t)B * H * T) || !map_vec(&dm, delta, (int64_t)B * H * T))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_dkv_dh384_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (e != cudaSuccess) return (int)e;
  flash_dkv_dh384_kernel<<<grid(B, H, T, kTile, 2), kThreads, kDkvSmem, (cudaStream_t)stream>>>(
      qm, km, vm, om, lm, dm, (bf16*)dk, (bf16*)dv, H, T, scale, causal);
  return (int)cudaGetLastError();
}
