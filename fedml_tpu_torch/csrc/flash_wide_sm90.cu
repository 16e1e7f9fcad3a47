// Flash attention's forward, dq and dk/dv for bfloat16 (B, T, H, Dh) inputs
// at every head dim Dh = 128 n, 4 <= n <= 12 (512 ... 1536), on the Hopper
// tensor cores, causal or full, any T: the Cheetah example's attention at
// --dim 4096 (8 heads of 512) and the wider head dims the dispatch guard
// admits.
//
// Replaces: fedml_tpu/ops/pallas/flash_attention.py at Dh >= 512 —
// _flash_kernel (:66, the forward of _flash_forward :129, call :140: o =
// softmax(scale q k^T, causal mask) v and lse = m + log l), _dq_kernel
// (:167, call :287: p = exp(scale q k^T - lse), ds = p (dO v^T - delta), dq
// = sum scale ds k) and _dkv_kernel (:213, call :299: dv = sum p^T dO, dk =
// scale sum ds^T q). The arithmetic is flash_dh384_sm90.cu's: bf16 x bf16
// score products exact with float32 sums, p and ds as three bf16 terms
// (exact to float32), each 64-row tile's products from a zero accumulator
// added in float32, finfo(float32).min masking, l clamped at 1e-30, the
// scale 1/sqrt(Dh) applied after Q K^T.
//
// Bound on the H100 at the example's shape (B 8, T 4352, H 8, Dh 512,
// causal): 606,216,192 unmasked (q, k) pairs x 2 x 512 operations = 0.6208
// TFLOP a product. The forward does one bf16 product and one split product
// (1 + 3 tensor-core products), dq two and one (2 + 3), dk/dv two and two
// (2 + 6): 2.511, 3.138 and 5.021 ms at 989 TFLOP/s, against ~0.35 ms of
// bytes at 3.35 TB/s. Bound by operations.
//
// Why the output columns are split across blocks. Past Dh 384 a whole row
// no longer fits one block: a 64 x Dh bf16 tile is Dh/8 KB (64 KB at 512,
// 192 KB at 1536), and a 64-row float32 output over all Dh columns would
// cost Dh/2 registers a thread in one warpgroup. So a block owns one slice
// of W output columns, W = 256 where Dh % 256 == 0 and 128 otherwise (a
// template parameter; Dh itself is a run-time loop count, so two
// instantiations of each kernel cover all nine head dims), and recomputes
// the scores over the whole Dh, streaming q and k (dO and v) through
// shared memory in 64-column chunks. Every slice runs the same chunk order
// with the same instructions, so every slice forms the same bits of the
// scores, p and ds. The recomputation is the price: with Dh / W slices,
// each score product runs Dh / W times. Per unmasked pair, in tensor-core
// products of 2 Dh operations, against the bound's 4 / 5 / 8:
//   forward  Dh / W + 3       (Dh 512: 5; 640: 8; 1536: 9; 1408: 14)
//   dq       2 Dh / W + 3     (Dh 512: 7; 640: 13; 1536: 15; 1408: 25)
//   dk/dv    2 Dh / W + 6     (Dh 512: 10; 640: 16; 1536: 18; 1408: 28)
// so at Dh 512 the bound's share can reach at most 80% / 71% / 80%. A
// faster form (a thread-block cluster that computes each partial score
// once and hands it to the other slices through distributed shared
// memory) is a lever for later work.
//
// All three kernels: 384 threads, two consumer warpgroups and a producer
// warpgroup that only issues TMA copies (setmaxnreg gives its registers to
// the consumers: 240 each). Each consumer has a ring of four stages, each
// stage one 64 x 64 chunk of two operands (16 KB), refilled by the
// producer as the consumer releases it; each chunk's score products start
// from zero and are added in float32 (ring_scores). Blocks go by (b, h), within
// one the longest causal rows first, the slices of one tile side by side
// (they read the same chunks, so the second finds them in L2). Tiles
// arrive by TMA from one 4-D tensor map per operand, (Dh, H, T, B) with
// the caller's element strides, 64-column boxes in the 128-byte swizzle;
// the hardware zero-fills rows at or past T. No atomics and one fixed order
// of every sum: dq, dk and dv repeat bit for bit.
//
// Forward. A block takes 64 q rows and one slice. Per k tile, consumer w
// sums the partial scores of its half of the chunks (w Dh/2 .. (w + 1)
// Dh/2 - 1), the two exchange them through 64 x 64 float32 tiles in shared
// memory and add them (one float32 addition, commutative: both hold the
// same bits of S = Q K^T), run the same online softmax and split, then
// each runs P V for its half of the slice (W / 128 column groups) from the
// slice's v tile. Shared memory: two rings (128 KB), the v slice (up to 32
// KB), two exchange tiles (32 KB).
//
// dq. A block takes 64 q rows and one slice. Per k tile, consumer 0 sums S
// = Q K^T and forms p = exp(scale S - lse), consumer 1 dP = dO V^T, each
// over all chunks; they exchange p and dP, both form ds = p (dP - delta)
// with the same bits, then run dS K for their half of the slice from the
// k tile's slice. The causal diagonal tile takes the tensor cores too:
// flash_dh384_sm90.cu sums its two score products on the CUDA cores in a
// plain float32 product's order, which repeats the plain version's rounding
// noise in causal row 0 (p = 1 on one key, so dq there is rounding noise of
// dP - delta); over Dh 512 columns that cost 19% of dq's time at lm_xxl's
// shape (15.30 against 12.43 ms, H100 80GB HBM3 at 700 W). Here row 0, 1/T
// of dq's outputs, is that noise in another order than the plain version's.
//
// dk/dv. A block takes a 64-row k tile and one slice of the dk and dv
// columns, and walks the q/dO tiles from the diagonal on. Per q tile,
// consumer 0 sums S^T = K Q^T, forms p and adds P^T dO over the slice's
// columns to dv; consumer 1 sums dP^T = V dO^T, takes p through a shared
// 64 x 64 tile, forms ds and adds dS^T Q to dk. The q tile's slice of q
// and of dO and its lse and delta come in one stage with one barrier.
// Shared memory: two rings (128 KB), q and dO slices (up to 64 KB), the p
// tile (16 KB), lse and delta.

#include "flash_tma_sm90.cuh"

namespace {

constexpr int kMinDh = 512, kMaxDh = 1536;
constexpr int kStages = 4;                         // stages of each consumer's ring
constexpr int kStageBytes = 2 * kGroupBytes;       // one 64 x 64 chunk of two operands
constexpr int kRingBytes = kStages * kStageBytes;  // 64 KB
constexpr int kXBytes = kXFloats * 4;              // one exchange tile: 16 KB
constexpr int kThreads = 2 * kWG;                  // the two consumer warpgroups
constexpr int kAllThreads = 3 * kWG;               // and the producer
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
// named barriers of dk/dv (0 is __syncthreads; the forward's and dq's are
// exchange()'s): the p tile written, and read
constexpr int kPFull = 1, kPEmpty = 2;
// the rings' barriers: full of ring w stage s at + 8 (w kStages + s), empty
// 2 kStages x 8 bytes after; then the slice stage's full and empty
constexpr int kRingBars = 4 * kStages;
constexpr int kBarBytes = (kRingBars + 2) * 8;

// a block's slice of W output columns
template <int W>
struct Slice {
  static constexpr int kGroups = W / 64;                 // 64-column groups
  static constexpr int kOwn = kGroups / 2;               // a consumer's, forward and dq
  static constexpr int kBytes = kGroups * kGroupBytes;  // a 64-row tile of the slice
  // forward and dq: two rings, a slice tile, two exchange tiles; dk/dv: two
  // rings, the q and dO slices, the p tile, lse and delta
  static constexpr int kFwdSmem = 2 * kRingBytes + kBytes + 2 * kXBytes + kBarBytes + 1024;
  static constexpr int kDkvSmem =
      2 * kRingBytes + 2 * kBytes + kXBytes + 2 * kVecSlot + kBarBytes + 1024;
  static_assert(kFwdSmem <= 232448 && kDkvSmem <= 232448, "shared memory of one H100 block");
};

// x, as a value the compiler cannot see through: what is derived from it is
// computed where it is used, not hoisted out of a loop and kept in registers
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// One consumer's ring: kStages stages of two 64 x 64 chunks (A at the
// stage, B kGroupBytes after), each with a full barrier (one arrival with
// the bytes) and an empty one (the consumer's 128 threads are done)
struct Ring {
  uint32_t stages, full, empty;
  __device__ __forceinline__ uint32_t a(int s) const { return stages + s * kStageBytes; }
  __device__ __forceinline__ uint32_t b(int s) const { return a(s) + kGroupBytes; }
};

__device__ __forceinline__ Ring ring(uint32_t rings, uint32_t bars, int w) {
  return {rings + w * kRingBytes, bars + 8 * w * kStages, bars + 8 * (2 + w) * kStages};
}

__device__ __forceinline__ void init_bars(uint32_t bars, uint32_t slice_readers) {
#pragma unroll
  for (int i = 0; i < 2 * kStages; ++i) {
    mbar_init(bars + 8 * i, 1);
    mbar_init(bars + 8 * (2 * kStages + i), kWG);
  }
  mbar_init(bars + 8 * kRingBars, 1);
  mbar_init(bars + 8 * kRingBars + 8, slice_readers);
  mbar_init_fence();
}

// producer: chunk `seq` of ring R, columns col .. col + 63 of rows ta .. ta +
// 63 of amap and tb .. tb + 63 of bmap, once the chunk kStages before it
// in the ring is released
__device__ __forceinline__ void put_chunk(const Ring& R, int seq, const CUtensorMap* amap, int ta,
                                          const CUtensorMap* bmap, int tb, int col, int h,
                                          int b) {
  const int s = seq % kStages;
  if (seq >= kStages) mbar_wait(R.empty + 8 * s, (seq / kStages - 1) & 1);
  mbar_expect(R.full + 8 * s, kStageBytes);
  tma_4d(R.a(s), amap, R.full + 8 * s, col, h, ta, b);
  tma_4d(R.b(s), bmap, R.full + 8 * s, col, h, tb, b);
}

// chunk i of ring R: its four k steps from a zero accumulator (issued, not
// waited)
__device__ __forceinline__ void issue_chunk(float (&c)[32], const Ring& R, int i) {
  const int s = i % kStages;
  mbar_wait(R.full + 8 * s, (i / kStages) & 1);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(c, desc_k<kTile>(R.a(s), kk), desc_k<kTile>(R.b(s), kk), kk);
  wg_commit();
}

// chunk i's products are done: release its stage, add them to d
__device__ __forceinline__ void add_chunk(float (&d)[32], float (&c)[32], const Ring& R, int i) {
  pin(c);
  mbar_arrive(R.empty + 8 * (i % kStages));
#pragma unroll
  for (int m = 0; m < 32; ++m) d[m] += c[m];
}

// d = the sum over the next n chunks of ring R (from seq on) of A B^T: each
// chunk's four k steps summed on the tensor cores from zero, waited, the
// chunks added in float32 in order. The tensor cores' float32 sums lean one
// way over long chains: summed in one chain of Dh / 16 k steps, dq at (1,
// 4224, 1, 1536) put 0.24% of its bf16 outputs off the rounded plain value
// (the gate allows 0.25%), per chunk 0.09%, for ~5% more time at lm_xxl's
// shape (H100 80GB HBM3 at 700 W). One chunk accumulator: two taking turns
// cost dk/dv at W = 256 a spill and were no faster.
__device__ __forceinline__ void ring_scores(float (&d)[32], const Ring& R, int& seq, int n) {
  float c[32];
#pragma unroll
  for (int m = 0; m < 32; ++m) d[m] = 0.f;
  for (int j = 0; j < n; ++j) {
    issue_chunk(c, R, seq + j);
    wg_wait<0>();
    add_chunk(d, c, R, seq + j);
  }
  seq += n;
}

// d = A B for 64-column group g of the slice tile `tile` (A the split p or
// ds in registers), from a zero accumulator, waited
__device__ __forceinline__ void split_product(float (&d)[32], const uint32_t (&a)[4][3][4],
                                              uint32_t tile, int g) {
  wg_fence();
  mma_split_group(d, a, tile, g);
  wg_commit();
  wg_wait<0>();
  pin(d);
}

template <int NG>
__device__ __forceinline__ void zero(float (&acc)[NG][32]) {
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;
}

// rows row0, row0 + 8 of a (B, T, H, Dh) output: NG column groups from
// column col of f(acc, row half), rounded to bf16
template <int NG, class F>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[NG][32], F f, int64_t b,
                                           int row0, int H, int h, int Tn, int Dh, int col,
                                           int c2) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= Tn) continue;
    bf16* dst = out + ((b * Tn + row) * H + h) * (int64_t)Dh + col + c2;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 64 * g + 8 * j) = __floats2bfloat162_rn(
            f(acc[g][4 * j + 2 * hh], hh), f(acc[g][4 * j + 2 * hh + 1], hh));
  }
}

// --- the kernels ---------------------------------------------------------------

// One block per (bh, 64-row q tile, slice): o (B, T, H, Dh) contiguous, lse
// (B*H, T), written by slice 0.
template <int W>
__global__ void __launch_bounds__(kAllThreads, 1)
flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                      float* __restrict__ lse, int H, int Tn, int Dh, float scale, int causal) {
  using S = Slice<W>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const uint32_t rings = smem_addr(base), Vs = rings + 2 * kRingBytes;  // v's slice
  float* X = reinterpret_cast<float*>(base + 2 * kRingBytes + S::kBytes);
  const uint32_t bars = smem_addr(base + 2 * kRingBytes + S::kBytes + 2 * kXBytes);
  const uint32_t vfull = bars + 8 * kRingBars, vempty = vfull + 8;
  const int tid = threadIdx.x, warp = tid % kWG / 32, lane = tid % 32;
  // the warpgroup, through a shuffle, so that ptxas knows it is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  const int nt = (Tn + kTile - 1) / kTile, ns = Dh / W;
  const int slice = (int)blockIdx.x % ns, tile = (int)blockIdx.x / ns;
  const int bh = tile / nt, b = bh / H, h = bh % H;
  const int q0 = (nt - 1 - tile % nt) * kTile;  // the longest causal rows first
  const int nk = causal ? q0 / kTile + 1 : nt;  // k tiles: causal, none past the diagonal
  const int half = Dh / 128;                    // chunks of each consumer's partial scores
  const int col0 = slice * W;

  if (tid == 0) init_bars(bars, kThreads);
  __syncthreads();

  if (wg == 2) {  // the producer: per k tile both rings' chunks in turn, then v's slice
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 2 * kWG) {
      const Ring R0 = ring(rings, bars, 0), R1 = ring(rings, bars, 1);
      int seq = 0;
      for (int t = 0; t < nk; ++t) {
        for (int j = 0; j < half; ++j, ++seq) {
          put_chunk(R0, seq, &qmap, q0, &kmap, t * kTile, 64 * j, h, b);
          put_chunk(R1, seq, &qmap, q0, &kmap, t * kTile, 64 * (half + j), h, b);
        }
        if (t >= 1) mbar_wait(vempty, (t - 1) & 1);
        mbar_expect(vfull, S::kBytes);
        for (int g = 0; g < S::kGroups; ++g)
          tma_4d(Vs + g * kGroupBytes, &vmap, vfull, col0 + 64 * g, h, t * kTile, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const Ring R = ring(rings, bars, wg);
  const int r = 16 * warp + lane / 4;  // this thread's rows of the tile: r, r + 8
  const int row0 = q0 + r, c2 = 2 * (lane % 4);
  float acc[S::kOwn][32];
  zero(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  int seq = 0;
  for (int kt = 0; kt < nk; ++kt) {
    float x[32], y[32], corr[2];
    ring_scores(x, R, seq, half);  // this consumer's half of the columns
    exchange(X, x, y, wg, kt, nk, r, c2);
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] += y[i];  // S, the same bits in both consumers
    softmax_tile(x, m, l, corr, kt * kTile, q0, row0, c2, Tn, causal, scale);
    uint32_t a[4][3][4];
    split_frags(x, a);
    mbar_wait(vfull, kt & 1);
#pragma unroll
    for (int g = 0; g < S::kOwn; ++g) {  // P V, one 64-column group at a time
      float pv[32];
      split_product(pv, a, Vs, S::kOwn * wg + g);
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
    if (slice == 0 && wg == 0 && lane % 4 == 0 && row < Tn)
      lse[(int64_t)bh * Tn + row] = m[hh] + logf(ls[hh]);
  }
  store_rows(o, acc, [&](float v, int hh) { return v / ls[hh]; }, b, row0, H, h, Tn, Dh,
             col0 + 64 * S::kOwn * wg, c2);
}

// One block per (bh, 64-row q tile, slice): dq (B, T, H, Dh) contiguous. dO
// is contiguous; lse and delta are (B*H, T). Consumer 0 forms p, consumer 1
// dP; each sums dq over half of the slice.
template <int W>
__global__ void __launch_bounds__(kAllThreads, 1)
flash_dq_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Tn, int Dh,
                     float scale, int causal) {
  using S = Slice<W>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const uint32_t rings = smem_addr(base), Ks = rings + 2 * kRingBytes;  // k's slice
  float* X = reinterpret_cast<float*>(base + 2 * kRingBytes + S::kBytes);  // p, dP
  const uint32_t bars = smem_addr(base + 2 * kRingBytes + S::kBytes + 2 * kXBytes);
  const uint32_t kfull = bars + 8 * kRingBars, kempty = kfull + 8;
  const int tid = threadIdx.x, warp = tid % kWG / 32, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  const int nt = (Tn + kTile - 1) / kTile, ns = Dh / W, nc = Dh / 64;
  const int slice = (int)blockIdx.x % ns, tile = (int)blockIdx.x / ns;
  const int bh = tile / nt, b = bh / H, h = bh % H;
  const int q0 = (nt - 1 - tile % nt) * kTile;
  const int nk = causal ? q0 / kTile + 1 : nt;
  const int col0 = slice * W;

  if (tid == 0) init_bars(bars, kThreads);
  __syncthreads();

  if (wg == 2) {  // the producer: per k tile the q/k and dO/v chunks in turn, then k's slice
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 2 * kWG) {
      const Ring R0 = ring(rings, bars, 0), R1 = ring(rings, bars, 1);
      int seq = 0;
      for (int t = 0; t < nk; ++t) {
        for (int j = 0; j < nc; ++j, ++seq) {
          put_chunk(R0, seq, &qmap, q0, &kmap, t * kTile, 64 * j, h, b);
          put_chunk(R1, seq, &omap, q0, &vmap, t * kTile, 64 * j, h, b);
        }
        if (t >= 1) mbar_wait(kempty, (t - 1) & 1);
        mbar_expect(kfull, S::kBytes);
        for (int g = 0; g < S::kGroups; ++g)
          tma_4d(Ks + g * kGroupBytes, &kmap, kfull, col0 + 64 * g, h, t * kTile, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const Ring R = ring(rings, bars, wg);  // consumer 0: q and k chunks; 1: dO and v
  const int r = 16 * warp + lane / 4;
  const int row0 = q0 + r, c2 = 2 * (lane % 4);
  float lr[2], dr[2];  // lse and delta of this thread's rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    lr[hh] = row < Tn ? lse[(int64_t)bh * Tn + row] : 0.f;
    dr[hh] = row < Tn ? delta[(int64_t)bh * Tn + row] : 0.f;
  }
  float dqa[S::kOwn][32];
  zero(dqa);
  int seq = 0;
  // per k tile: the score product; p (consumer 0); the exchange; ds; dS K
  // for this consumer's half of the slice
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    float x[32], y[32];
    ring_scores(x, R, seq, nc);
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
    for (int g = 0; g < S::kOwn; ++g) {
      float t[32];
      split_product(t, a, Ks, S::kOwn * wg + g);
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[g][i] += scale * t[i];
    }
    mbar_arrive(kempty);
  }

  store_rows(dq, dqa, [](float v, int) { return v; }, b, row0, H, h, Tn, Dh,
             col0 + 64 * S::kOwn * wg, c2);
}

// One block per (bh, 64-row k tile, slice): dk and dv (B, T, H, Dh)
// contiguous. dO is contiguous; lse and delta are (B*H, T). Consumer 0 forms
// p and sums dv, consumer 1 forms ds from that p and sums dk, both over the
// slice's columns.
template <int W>
__global__ void __launch_bounds__(kAllThreads, 1)
flash_dkv_wide_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap,
                      const __grid_constant__ CUtensorMap lmap,
                      const __grid_constant__ CUtensorMap dmap, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int H, int Tn, int Dh, float scale, int causal) {
  using S = Slice<W>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const uint32_t rings = smem_addr(base);
  const uint32_t Qs = rings + 2 * kRingBytes, Os = Qs + S::kBytes;  // the q tile's slices
  float* P = reinterpret_cast<float*>(base + 2 * kRingBytes + 2 * S::kBytes);  // its p
  uint8_t* vecs = base + 2 * kRingBytes + 2 * S::kBytes + kXBytes;  // lse, delta kVecSlot on
  const uint32_t bars = smem_addr(vecs + 2 * kVecSlot);
  const uint32_t sfull = bars + 8 * kRingBars, sempty = sfull + 8;
  const int tid = threadIdx.x, warp = tid % kWG / 32, lane = tid % 32;
  const int wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  const int nq = (Tn + kTile - 1) / kTile, ns = Dh / W, nc = Dh / 64;
  // blocks by (b, h), within one the keys seen by the most causal rows
  // first, the slices of a k tile side by side
  const int slice = (int)blockIdx.x % ns, kb = (int)blockIdx.x / ns;
  const int bh = kb / nq, b = bh / H, h = bh % H;
  const int k0 = kb % nq * kTile;
  const int first = causal ? k0 / kTile : 0;  // causal: earlier q tiles see none of these keys
  const int n = nq - first;                   // q tiles of this block
  const int col0 = slice * W;
  // where the q tile at q0 starts in its lse and delta boxes
  auto vec_skip = [&](int q0) { return (bh * Tn + q0) & 3; };

  if (tid == 0) init_bars(bars, kThreads);
  __syncthreads();

  if (wg == 2) {  // the producer: per q tile the k/q and v/dO chunks in turn, then the slices
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 2 * kWG) {
      const Ring R0 = ring(rings, bars, 0), R1 = ring(rings, bars, 1);
      int seq = 0;
      for (int i = 0; i < n; ++i) {
        const int q0 = (first + i) * kTile;
        for (int j = 0; j < nc; ++j, ++seq) {
          put_chunk(R0, seq, &kmap, k0, &qmap, q0, 64 * j, h, b);
          put_chunk(R1, seq, &vmap, k0, &omap, q0, 64 * j, h, b);
        }
        if (i >= 1) mbar_wait(sempty, (i - 1) & 1);
        const int v0 = bh * Tn + q0 - vec_skip(q0);
        mbar_expect(sfull, 2 * S::kBytes + 2 * kVecBox * 4);
        for (int g = 0; g < S::kGroups; ++g) {
          tma_4d(Qs + g * kGroupBytes, &qmap, sfull, col0 + 64 * g, h, q0, b);
          tma_4d(Os + g * kGroupBytes, &omap, sfull, col0 + 64 * g, h, q0, b);
        }
        tma_1d(smem_addr(vecs), &lmap, sfull, v0);
        tma_1d(smem_addr(vecs + kVecSlot), &dmap, sfull, v0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const Ring R = ring(rings, bars, wg);  // consumer 0: k and q chunks; 1: v and dO
  const int r0 = 16 * warp + lane / 4;   // this thread's keys of the tile: r0, r0 + 8
  const int c20 = 2 * (lane % 4);         // and its columns of a 64-column group
  float acc[S::kGroups][32];  // consumer 0: dv, consumer 1: dk (scaled at the end)
  zero(acc);
  float t[32];  // one slice group's product, the same registers for every group
  // P^T dO (consumer 0) or dS^T Q (consumer 1)
  const uint32_t right = wg == 0 ? Os : Qs;
  int seq = 0;

  // Beside the four accumulators (128 registers at W = 256) nothing
  // loop-invariant may stay in registers: the thread's row and column
  // offsets, and the addresses and descriptors derived from them, go
  // through opaque() once per q tile and are recomputed where used
  // (hoisted, they spilled 260 bytes).
  for (int i = 0; i < n; ++i) {
    const int q0 = (first + i) * kTile;
    float x[32];
    ring_scores(x, R, seq, nc);  // S^T = K Q^T or dP^T = V dO^T
    mbar_wait(sfull, i & 1);
    const int r = (int)opaque(r0), c2 = (int)opaque(c20);
    const int row0 = k0 + r;
    const float* lv = reinterpret_cast<const float*>(vecs) + vec_skip(q0);
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
      if (i >= 1) named_sync<kThreads>(kPEmpty);  // consumer 1 has read p of tile i - 1
      put_tile(P, x, r, c2);
      named_arrive<kThreads>(kPFull);
    } else {
      const float* dl = lv + kVecSlot / 4;
      named_sync<kThreads>(kPFull);  // p of tile i is in P
      // ds = p (dP^T - delta), p read from the tile as it is used (no
      // register copy of it beside the four accumulators)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 p = *reinterpret_cast<const float2*>(P + xat(r + 8 * hh, 8 * j + c2));
          const int at = 4 * j + 2 * hh;
          x[at] = p.x * (x[at] - dl[8 * j + c2]);
          x[at + 1] = p.y * (x[at + 1] - dl[8 * j + c2 + 1]);
        }
      if (i + 1 < n) named_arrive<kThreads>(kPEmpty);
    }
    uint32_t a[4][3][4];
    split_frags(x, a);
#pragma unroll
    for (int g = 0; g < S::kGroups; ++g) {
      split_product(t, a, opaque(right), g);
#pragma unroll
      for (int m = 0; m < 32; ++m) acc[g][m] += t[m];
    }
    mbar_arrive(sempty);  // this thread is done with the slices
  }

  const float mul = wg == 0 ? 1.f : scale;
  store_rows(wg == 0 ? dv : dk, acc, [&](float v, int) { return mul * v; }, b, k0 + r0, H, h,
             Tn, Dh, col0, c20);
}

// --- launches ------------------------------------------------------------------

// bf16 (is_bf16 = 1) at Dh = 128 n, 4 <= n <= 12
bool wide_ok(int B, int H, int T, int Dh, int is_bf16) {
  return B > 0 && H > 0 && T > 0 && Dh % 128 == 0 && Dh >= kMinDh && Dh <= kMaxDh && is_bf16 &&
         (int64_t)B * H * T <= 0x7fffffffLL && (int64_t)B * H * ((T + kTile - 1) / kTile) *
                                                       (Dh / 128) <= 0x7fffffffLL;
}

template <class K>
cudaError_t set_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int W>
int launch_fwd(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm, void* o,
               float* lse, int B, int H, int T, int Dh, int causal, float scale,
               cudaStream_t stream) {
  cudaError_t e = set_smem(flash_fwd_wide_kernel<W>, Slice<W>::kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_wide_kernel<W><<<grid(B, H, T, kTile, Dh / W), kAllThreads, Slice<W>::kFwdSmem,
                             stream>>>(qm, km, vm, (bf16*)o, lse, H, T, Dh, scale, causal);
  return (int)cudaGetLastError();
}

template <int W>
int launch_dq(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
              const CUtensorMap& om, const float* lse, const float* delta, void* dq, int B, int H,
              int T, int Dh, int causal, float scale, cudaStream_t stream) {
  cudaError_t e = set_smem(flash_dq_wide_kernel<W>, Slice<W>::kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  flash_dq_wide_kernel<W><<<grid(B, H, T, kTile, Dh / W), kAllThreads, Slice<W>::kFwdSmem,
                            stream>>>(qm, km, vm, om, lse, delta, (bf16*)dq, H, T, Dh, scale,
                                      causal);
  return (int)cudaGetLastError();
}

template <int W>
int launch_dkv(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
               const CUtensorMap& om, const CUtensorMap& lm, const CUtensorMap& dm, void* dk,
               void* dv, int B, int H, int T, int Dh, int causal, float scale,
               cudaStream_t stream) {
  cudaError_t e = set_smem(flash_dkv_wide_kernel<W>, Slice<W>::kDkvSmem);
  if (e != cudaSuccess) return (int)e;
  flash_dkv_wide_kernel<W><<<grid(B, H, T, kTile, Dh / W), kAllThreads, Slice<W>::kDkvSmem,
                             stream>>>(qm, km, vm, om, lm, dm, (bf16*)dk, (bf16*)dv, H, T, Dh,
                                       scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points take the arguments of fedml_flash_fwd_sm90,
// fedml_flash_dq_sm90 and fedml_flash_dkv_sm90 (flash_attention_sm90.cu)
// and only bfloat16 (is_bf16 = 1) at Dh = 128 n, 4 <= n <= 12: q, k, v (B, T,
// H, Dh) share the element strides (sb, st, sh) with Dh contiguous and
// 16-byte aligned rows; dO, lse and delta and the outputs are contiguous.
// Slices of 256 columns where Dh % 256 == 0, else of 128. Return the
// launch's cudaError_t (cudaErrorInvalidValue when the arguments are out of
// range or a tensor map cannot be made).
extern "C" int fedml_flash_fwd_wide_sm90(const void* q, const void* k, const void* v, void* o,
                                         float* lse, int B, int H, int T, int Dh, int is_bf16,
                                         int causal, long long sb, long long st, long long sh,
                                         float scale, void* stream) {
  CUtensorMap qm, km, vm;
  if (!wide_ok(B, H, T, Dh, is_bf16) || !map_heads(&qm, q, Dh, B, H, T, sb, st, sh) ||
      !map_heads(&km, k, Dh, B, H, T, sb, st, sh) || !map_heads(&vm, v, Dh, B, H, T, sb, st, sh))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return Dh % 256 == 0 ? launch_fwd<256>(qm, km, vm, o, lse, B, H, T, Dh, causal, scale, s)
                       : launch_fwd<128>(qm, km, vm, o, lse, B, H, T, Dh, causal, scale, s);
}

extern "C" int fedml_flash_dq_wide_sm90(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* delta,
                                        void* dq, int B, int H, int T, int Dh, int is_bf16,
                                        int causal, long long sb, long long st, long long sh,
                                        float scale, void* stream) {
  CUtensorMap qm, km, vm, om;
  const int64_t hd = (int64_t)H * Dh;  // dO's row stride
  if (!wide_ok(B, H, T, Dh, is_bf16) || !map_heads(&qm, q, Dh, B, H, T, sb, st, sh) ||
      !map_heads(&km, k, Dh, B, H, T, sb, st, sh) || !map_heads(&vm, v, Dh, B, H, T, sb, st, sh) ||
      !map_heads(&om, dout, Dh, B, H, T, T * hd, hd, Dh))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return Dh % 256 == 0
             ? launch_dq<256>(qm, km, vm, om, lse, delta, dq, B, H, T, Dh, causal, scale, s)
             : launch_dq<128>(qm, km, vm, om, lse, delta, dq, B, H, T, Dh, causal, scale, s);
}

extern "C" int fedml_flash_dkv_wide_sm90(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse, const float* delta,
                                         void* dk, void* dv, int B, int H, int T, int Dh,
                                         int is_bf16, int causal, long long sb, long long st,
                                         long long sh, float scale, void* stream) {
  CUtensorMap qm, km, vm, om, lm, dm;
  const int64_t hd = (int64_t)H * Dh;  // dO's row stride
  if (!wide_ok(B, H, T, Dh, is_bf16) || !map_heads(&qm, q, Dh, B, H, T, sb, st, sh) ||
      !map_heads(&km, k, Dh, B, H, T, sb, st, sh) || !map_heads(&vm, v, Dh, B, H, T, sb, st, sh) ||
      !map_heads(&om, dout, Dh, B, H, T, T * hd, hd, Dh) ||
      !map_vec(&lm, lse, (int64_t)B * H * T) || !map_vec(&dm, delta, (int64_t)B * H * T))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return Dh % 256 == 0
             ? launch_dkv<256>(qm, km, vm, om, lm, dm, dk, dv, B, H, T, Dh, causal, scale, s)
             : launch_dkv<128>(qm, km, vm, om, lm, dm, dk, dv, B, H, T, Dh, causal, scale, s);
}
