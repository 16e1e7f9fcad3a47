// Flash attention for float32 inputs on the Hopper tensor cores, exact to
// float32 through three TF32 products (3xTF32, tf32x3.cuh): the forward at
// Dh 128, 256 and 384, dq and dk/dv at Dh 256 and 384. dq and dk/dv at Dh
// 128 are flash_f32_wgmma_sm90.cu's; every float32 kernel at Dh 64 keeps
// the FMA kernels of flash_attention.cu; bf16 inputs run the wgmma kernels
// (flash_dh256_sm90.cu at Dh 256, flash_dh384_sm90.cu at Dh 384).
// ops/flash_attention.py's route() picks.
//
// Replaces: fedml_tpu/ops/pallas/flash_attention.py — _flash_kernel (:66,
// the forward, pallas_call :140) at Dh 128, 256 and 384, _dq_kernel (:167,
// pallas_call :287) and _dkv_kernel (:213, pallas_call :299) at Dh 256 and
// 384, on float32 inputs. The TPU kernels walk a sequential (bh, q block, k
// block) grid and carry m, l and the accumulators in VMEM scratch; here one
// block owns 64 q rows (the forward, dq) or 64 key rows (dk/dv), 32 in dq
// and dk/dv at Dh 384, and walks the other axis in a loop, with that state
// in registers.
//
// Arithmetic (the contract of flash_attention.cu, unchanged): float32
// inputs and outputs; the forward scales q before Q K^T, the backward
// scales the product after it; masked scores are finfo(float32).min; the
// online softmax keeps m, l and corr per row, o = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)); the backward recomputes p = exp(scale q.k
// - lse) and ds = p (dO.v - delta); dq adds scale (dS K) per k tile, dk/dv
// add P^T dO and scale (dS^T Q) per q tile. Every product is three
// mma.sync.m16n8k8 TF32 products (a_lo b_hi, a_hi b_lo, a_hi b_hi, small
// terms first), each operand split where it is loaded (split_tf32); the
// dropped a_lo b_lo and the tensor core's read of lo leave ~1.2e-6 of the
// magnitudes (conv3x3_sm90.cu's analysis). The tensor cores' float32 sums
// lean one way over long runs, so each streamed tile's product (P V, dS K,
// P^T dO, dS^T Q) starts from a zero accumulator and is added to the
// running registers in float32 (rescaled by corr in the forward, times
// scale in dq and dk). Each output is summed in one fixed order with no
// atomics: runs repeat bit for bit. Blocks of the longest causal rows (or
// the keys the most rows see) launch first; rows and columns at or past T
// are zero-filled and masked, so T need not be a multiple of a tile.
//
// Forward and dq. Groups of 16 q rows (four in a block), each group's 16 x
// Dh output owned by Dh / 128 warps, each summing the score products (Q
// K^T, and dO V^T in dq) over its 128 columns and owning those 128 output
// columns: a (16, 128) float32 accumulator, 16 m16n8 tiles, 64 registers a
// thread. At Dh 256 and 384 the warps of a group add their partial scores
// through shared memory once a tile (group_add: each lane writes its
// values, the group meets, each adds the parts in the order part 0 + part
// 1 (+ part 2), so every warp of the group holds the same score, softmax
// and P); at Dh 128 one warp holds a row group's whole scores and a block
// is four warps, so two blocks share an SM. q (and dO) stay resident in
// shared memory, rows Dh + 4 floats apart; k and v stream through a
// two-stage cp.async ring, the next tile in flight during this tile's
// products, one block barrier a tile. The forward's k/v tiles are 32 rows
// (at Dh 256 64 q rows + 2 x (32 + 32) rows + the exchange: 211 KB; at Dh
// 128 99 KB); dq's resident q and dO leave room for 16-row k/v tiles (211
// KB). Q K^T's and dO V^T's fragments load with ldmatrix (four 8 x 4 float
// matrices: an A fragment, or the B fragments of two 8-key tiles); the row
// padding (4 mod 32 banks) keeps those reads and P V's (rows 2 t and 2 t + 1
// at column g: bank 8 t + g, 8 t + 4 + g) free of bank conflicts. S's
// accumulator holds columns 2 t and 2 t + 1 of rows g and g + 8; read as
// the k index t and t + 4 of the next product's A fragment, it is P's A
// fragment as it stands, once the B operand's rows are taken in the same
// order (keys 2 t and 2 t + 1): no shuffle. P V (dS K) runs in passes of
// 64 output columns, each pass's zero-started sums in 32 registers. On an
// H100 (PERF.md): a first Dh-256 design of four warps of 16 rows x 256
// columns (one warp a scheduler, 255 registers) took 20.3 ms for the
// forward and 25.8 for dq at the wide shape below; this layout 12.5 and
// 18.8.
//
// dk/dv (Dh 256). One block per 64 key rows: k and v resident (2 x 64 rows
// of 260 floats, 130 KB), q and dO streaming in 16-row tiles through the
// two-stage ring (65 KB), with a 4 KB hand-over slot: 199 KB, one block of
// eight warps an SM. Warps in four pairs; pair p owns keys 16 p .. 16 p +
// 15, and its two warps split the work by output: warp 0 of the pair
// computes S = K Q^T over all 256 columns, p = exp(scale S - lse) and dv
// += P^T dO; warp 1 computes dP = V dO^T, takes p from warp 0 through
// shared memory (one pair barrier a tile), forms dS = p (dP - delta) and
// dk += scale dS^T Q. Each warp holds one (16, 256) accumulator, 32 tiles,
// 128 registers, and the two do equal work: one score product and one
// output product a tile each. S (dP) has keys as rows, so it is P's (dS's)
// A fragment as it stands, and the streamed dO (Q) rows load as the B
// operand as V does in the forward. A score product has two accumulator
// tiles a warp (16 queries), so its even and odd 8-column steps sum into
// separate tiles, added at the end: twice the independent mma chains. A
// Dh split as the forward's (each warp half the columns of both score
// products and of both outputs) would trade two partial scores a tile,
// not one p. On an H100 at the wide shape below (PERF.md): 27.0 ms, against
// 42.2 for a float32 FMA kernel of the same tiles; the Dh-128 forward at
// the float32 LM's shape below 6.6 ms, against 13.2 (flash_attention.cu's
// FMA design).
//
// Dh 384 (the Cheetah example at --dim 3072). A row of 388 floats is 1,552
// B, so 64 rows are 97 KB and no Dh-256 layout fits 227 KB as it stands;
// a (16, 384) accumulator would be 192 registers. The forward keeps 64 q
// rows and three warps of 128 columns a row group (twelve warps, at most
// 168 registers a thread) and streams 16-row k/v tiles: 97 + 2 x (24 + 24)
// + 24 KB of exchange = 218 KB. dq keeps 32 q and dO rows (two row groups
// of three warps) and the 16-row k/v ring: 206 KB. dk/dv keeps 32 key rows
// (two groups) and the 16-row q/dO ring, and splits each group's dv and dk
// by columns: two warps of 192 columns (96 registers) each, the pair adding
// its partial scores once a tile (a + b, both the same bits) before the dv
// pair forms p and hands it to the dk pair: 204 KB, eight warps.
//
// Bounds on the H100, bound by operations (bytes take < 0.1 ms): at the
// wide float32 LM's shape (B 8, T 4352, H 8, Dh 256, causal), 606,216,192
// unmasked (q, k) pairs, 512 operations per pair and product; as three
// TF32 products at 495 TFLOP/s the forward's two products take 3.762 ms,
// dq's three 5.643 ms and dk/dv's four 7.524 ms (at the float32 FMA rate,
// 67 TFLOP/s, 9.265, 13.90 and 18.53 ms). At the float32 LM's Dh-128 shape
// (B 8, T 4608, H 8, Dh 128, causal), 679,624,704 pairs x 256 operations:
// the forward 2.109 ms (5.194 at the FMA rate). At the XL float32 LM's
// shape (B 8, T 4352, H 8, Dh 384, causal), the same pairs x 768
// operations: 5.643, 8.465 and 11.29 ms (13.90, 20.85, 27.80 at the FMA
// rate). mma.sync reaches ~64% of
// the TF32 peak the bound counts (chip_smoke.py's tc_rate); the splits and
// fragment loads share the warps' issue slots with the products.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kRows = 64;           // q rows of a forward block (dq, dk/dv: Dq, Dkv::kRows)
constexpr int kWarpCols = 128;      // score columns a forward or dq warp sums
constexpr int kFwdKeys = 32;        // rows of the forward's k and v tiles (Dh 384: 16)
constexpr int kDqKeys = 16;         // rows of dq's k and v tiles
constexpr int kDkvQueries = 16;     // rows of dk/dv's q and dO tiles
constexpr int kPass = 8;            // 8-column tiles of one output pass: 64 columns
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

// the THREADS threads of row group p (its warps p, p + G, p + 2 G, ...)
// meet at barrier 1 + p
template <int THREADS>
__device__ __forceinline__ void group_sync(int p) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + p), "n"(THREADS) : "memory");
}

// Four 8 x 4 float matrices, one row address a lane (lanes 8 i .. 8 i + 7
// give matrix i's rows); register i of lane (g, t) is row g, column t of
// matrix i.
__device__ __forceinline__ void ldsm_x4(const float* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// rows r0 .. r0 + R - 1 of one (b, h) slice (row stride st floats, DH
// contiguous) into a tile of row stride DH + 4, by a block of THREADS; rows
// at or past T zero-filled. A thread copies 16-byte chunk tid % (DH / 4) of
// rows tid / (DH / 4) + step j: a pointer step per copy (a generic index
// loop spent ~28 integer instructions on each copy's division and 64-bit
// address)
template <int DH, int THREADS, int R>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int64_t st, int r0,
                                           int Tn) {
  constexpr unsigned kChunks = DH / 4, kStep = THREADS / kChunks;
  static_assert(R % kStep == 0, "whole passes");
  // at Dh 384 a block of 256 threads copies with its first 192 (96 chunks a row)
  if (kStep * kChunks != THREADS && threadIdx.x >= kStep * kChunks) return;
  const unsigned c = 4 * (threadIdx.x % kChunks), row = threadIdx.x / kChunks;
  const float* s = src + (int64_t)(r0 + (int)row) * st + c;
  float* d = dst + row * (DH + 4) + c;
#pragma unroll
  for (int j = 0; j < R / (int)kStep; ++j) {
    const bool valid = r0 + (int)row + (int)kStep * j < Tn;
    cp_async16(d + kStep * j * (DH + 4), valid ? s : src, valid);
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

// This lane's ldmatrix row addresses into a tile of row stride LD: for the
// A fragment of rows r0 .. r0 + 15 (matrices: rows 0-7 and 8-15 at columns
// 0-3, then both at 4-7), and for the B fragments of two 8-row groups of b
// (matrices: group 0 at columns 0-3 and 4-7, then group 1)
template <int LD>
__device__ __forceinline__ const float* a_lane(const float* a, int r0, int lane) {
  return a + (r0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 4 * (lane >> 4);
}
template <int LD>
__device__ __forceinline__ const float* b_lane(const float* b, int lane) {
  return b + ((lane & 7) + 8 * (lane >> 4)) * LD + 4 * ((lane >> 3) & 1);
}

// s[n] += (16 rows of a) (rows 8 n .. 8 n + 7 of b)^T over the COLS columns
// from d0, for N 8-row groups of b (N even); al_ and bl_ are a_lane /
// b_lane addresses
template <int N, int LD, int COLS>
__device__ __forceinline__ void scores(float (&s)[N][4], const float* al_, const float* bl_,
                                       int d0) {
#pragma unroll 4
  for (int d = d0; d < d0 + COLS; d += 8) {
    uint32_t r[4], ah[4], al[4];
    ldsm_x4(al_ + d, r);
    split4(r, ah, al);
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      uint32_t bh[4], bl[4];
      ldsm_x4(bl_ + n * 8 * LD + d, r);
      split4(r, bh, bl);
      const uint32_t b0h[2] = {bh[0], bh[1]}, b0l[2] = {bl[0], bl[1]};
      const uint32_t b1h[2] = {bh[2], bh[3]}, b1l[2] = {bl[2], bl[3]};
      mma3(s[n], ah, al, b0h, b0l);
      mma3(s[n + 1], ah, al, b1h, b1l);
    }
  }
}

// scores() with the even and the odd k steps summed into s0 and s1: twice
// the independent mma chains, for dk/dv's two accumulator tiles a warp
template <int N, int LD, int COLS>
__device__ __forceinline__ void scores2(float (&s0)[N][4], float (&s1)[N][4], const float* al_,
                                        const float* bl_, int d0) {
#pragma unroll 2
  for (int d = d0; d < d0 + COLS; d += 16) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t r[4], ah[4], al[4];
      ldsm_x4(al_ + d + 8 * h, r);
      split4(r, ah, al);
#pragma unroll
      for (int n = 0; n < N; n += 2) {
        uint32_t bh[4], bl[4];
        ldsm_x4(bl_ + n * 8 * LD + d + 8 * h, r);
        split4(r, bh, bl);
        const uint32_t b0h[2] = {bh[0], bh[1]}, b0l[2] = {bl[0], bl[1]};
        const uint32_t b1h[2] = {bh[2], bh[3]}, b1l[2] = {bl[2], bl[3]};
        mma3(h ? s1[n] : s0[n], ah, al, b0h, b0l);
        mma3(h ? s1[n + 1] : s0[n + 1], ah, al, b1h, b1l);
      }
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
// N key steps, from zero: one 64-column pass of P V, dS K, P^T dO or dS^T Q
template <int N, int LD>
__device__ __forceinline__ void prob_pass(float (&out)[kPass][4], const uint32_t (&ph)[N][4],
                                          const uint32_t (&pl)[N][4], const float* x, int c0,
                                          int g, int t) {
#pragma unroll
  for (int n = 0; n < kPass; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    const float* xr = x + (8 * kk + 2 * t) * LD + c0 + g;
#pragma unroll
    for (int n = 0; n < kPass; ++n) {
      uint32_t bh[2], bl[2];
      split_tf32(xr[8 * n], bh[0], bl[0]);
      split_tf32(xr[LD + 8 * n], bh[1], bl[1]);
      mma3(out[n], ph[kk], pl[kk], bh, bl);
    }
  }
}

// Sums the SPLIT partial scores of one row group's warps (warp w of the
// block holds part w / G of row group w % G) into each of them: each lane
// writes its 4 N values to its warp's exchange slot, the group meets, and
// each lane adds the other parts. Every warp of the group must then hold
// the same bits. At SPLIT 2 a warp adds its partner's part to its own (a +
// b is b + a); at SPLIT 3 every warp forms (part 0 + part 1) + part 2, its
// own part from its registers: an order that started from each warp's own
// part would give the thirds of a row different softmaxes.
template <int N, int G, int SPLIT>
__device__ __forceinline__ void group_add(float (&v)[N][4], float* xs, int warp, int lane) {
  static_assert(4 * N * 32 <= kExchange, "exchange slot");
  static_assert(SPLIT == 2 || SPLIT == 3, "two or three parts");
  const int pr = warp % G;
  float* mine = xs + warp * kExchange;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(4 * i + e) * 32 + lane] = v[i][e];
  group_sync<32 * SPLIT>(pr);
  if constexpr (SPLIT == 2) {
    static_assert((G & (G - 1)) == 0, "warp ^ G is the partner");
    const float* other = xs + (warp ^ G) * kExchange;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[i][e] += other[(4 * i + e) * 32 + lane];
  } else {
    const int part = warp / G;
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (4 * i + e) * 32 + lane;
        float sum = part == 0 ? v[i][e] : xs[pr * kExchange + at];
#pragma unroll
        for (int j = 1; j < SPLIT; ++j)
          sum += part == j ? v[i][e] : xs[(j * G + pr) * kExchange + at];
        v[i][e] = sum;
      }
  }
}

// rows row0 (values e = 0, 1) and row0 + 8 (e = 2, 3) of a warp's (16, 8 N)
// accumulator, divided by div0 / div1, into columns c0 .. c0 + 8 N - 1 of a
// contiguous (B, T, H, DH) output
template <int DH, int N>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[N][4], float div0,
                                           float div1, int b, int h, int H, int Tn, int row0,
                                           int c0, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= Tn) continue;
    const float div = half ? div1 : div0;
    float* dst = out + (((int64_t)b * Tn + row) * H + h) * DH + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < N; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc[n][2 * half] / div, acc[n][2 * half + 1] / div);
  }
}

// the forward's block: 64 q rows in four groups of 16, each shared by DH /
// 128 warps; k and v tiles of 32 rows (16 at Dh 384, where 32 would not fit)
template <int DH>
struct Fwd {
  static constexpr int kSplit = DH / kWarpCols;
  static constexpr int kThreads = 128 * kSplit;
  static constexpr int kKeys = DH == 384 ? kDqKeys : kFwdKeys;
  static constexpr int kFloats = kRows * (DH + 4) + 2 * 2 * kKeys * (DH + 4) +
                                 (kSplit > 1 ? 4 * kSplit * kExchange : 0);
  static constexpr int kMinBlocks = kThreads > 256 ? 1 : 256 / kThreads;
};

// One block per (bh, 64 q rows): o (B, T, H, DH) contiguous, lse (B*H, T).
template <int DH>
__global__ void __launch_bounds__(Fwd<DH>::kThreads, Fwd<DH>::kMinBlocks)
flash_fwd_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int H, int Tn, int64_t sb, int64_t st,
                       int64_t sh, float scale, int causal) {
  constexpr int LD = DH + 4, THREADS = Fwd<DH>::kThreads, NT = kWarpCols / 8;
  constexpr int KT = Fwd<DH>::kKeys, NS = KT / 8, STAGE = 2 * KT * LD;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* ring = Qs + kRows * LD;  // stage s: k tile at ring + s STAGE, v tile after it
  float* xs = ring + 2 * STAGE;   // the partial scores' exchange, one slot a warp (Dh >= 256)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int pr = warp & 3, part = warp >> 2, c0 = part * kWarpCols;
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
    stage_rows<DH, THREADS, KT>(dst, kg, st, i * KT, Tn);
    stage_rows<DH, THREADS, KT>(dst + KT * LD, vg, st, i * KT, Tn);
    cp_async_commit();
  };
  stage_kv(0);
  // q, scaled before the product as the TPU kernel does (:92); rows past T zero
  for (int idx = threadIdx.x; idx < kRows * (DH / 4); idx += THREADS) {
    const int row = idx / (DH / 4), c = 4 * (idx % (DH / 4));
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < Tn) x = *reinterpret_cast<const float4*>(q + off + (int64_t)(q0 + row) * st + c);
    *reinterpret_cast<float4*>(Qs + row * LD + c) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }

  const float* qa = a_lane<LD>(Qs, 16 * pr, lane);
  const int row0 = q0 + 16 * pr + g;  // this thread's rows: row0 and row0 + 8
  float acc[NT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait_all();
    __syncthreads();  // tile i has landed, and every warp is done with tile i - 1
    if (i + 1 < nk) stage_kv(i + 1);
    const float* Ks = ring + (i & 1) * STAGE;
    const float* Vs = Ks + KT * LD;
    const int k0 = i * KT;
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    scores<NS, LD, kWarpCols>(s, qa, b_lane<LD>(Ks, lane), c0);
    if constexpr (Fwd<DH>::kSplit > 1) group_add<NS, 4, Fwd<DH>::kSplit>(s, xs, warp, lane);
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
    for (int c = 0; c < NT / kPass; ++c) {
      float pv[kPass][4];
      prob_pass<NS, LD>(pv, ph, pl, Vs, c0 + 8 * kPass * c, g, t);
#pragma unroll
      for (int n = 0; n < kPass; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[kPass * c + n][e] = acc[kPass * c + n][e] * corr[e >> 1] + pv[n][e];
    }
  }

  const float ls0 = fmaxf(l[0], 1e-30f), ls1 = fmaxf(l[1], 1e-30f);
  if (part == 0 && t == 0) {
    if (row0 < Tn) lse[(int64_t)bh * Tn + row0] = m[0] + logf(ls0);
    if (row0 + 8 < Tn) lse[(int64_t)bh * Tn + row0 + 8] = m[1] + logf(ls1);
  }
  store_rows<DH, NT>(o, acc, ls0, ls1, b, h, H, Tn, row0, c0, t);
}

// dq's block: 64 q rows (32 at Dh 384, where q and dO of 64 rows alone
// would fill shared memory) in groups of 16, each shared by DH / 128 warps;
// q and dO resident, k and v tiles of 16 rows
template <int DH>
struct Dq {
  static constexpr int kRows = DH == 384 ? 32 : 64;
  static constexpr int kGroups = kRows / 16;
  static constexpr int kSplit = DH / kWarpCols;
  static constexpr int kThreads = 32 * kGroups * kSplit;
  static constexpr int kFloats = 2 * kRows * (DH + 4) + 2 * 2 * kDqKeys * (DH + 4) +
                                 kGroups * kSplit * kExchange;
};

// One block per (bh, Dq::kRows q rows): dq (B, T, H, DH) contiguous. dout is
// contiguous; lse and delta are (B*H, T). k and v stream in 16-row tiles.
template <int DH>
__global__ void __launch_bounds__(Dq<DH>::kThreads, 1)
flash_dq_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dq, int H, int Tn, int64_t sb, int64_t st,
                      int64_t sh, float scale, int causal) {
  constexpr int LD = DH + 4, ROWS = Dq<DH>::kRows, G = Dq<DH>::kGroups;
  constexpr int THREADS = Dq<DH>::kThreads;
  constexpr int KT = kDqKeys, NS = KT / 8, STAGE = 2 * KT * LD, NT = kWarpCols / 8;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Os = Qs + ROWS * LD;    // dO
  float* ring = Os + ROWS * LD;  // stage s: k tile at ring + s STAGE, v tile after it
  float* xs = ring + 2 * STAGE;  // the partial products' exchange, one slot a warp
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int pr = warp % G, c0 = (warp / G) * kWarpCols;
  const int nt = (Tn + ROWS - 1) / ROWS;
  const int bh = (int)blockIdx.x / nt, b = bh / H, h = bh % H;
  const int q0 = (nt - 1 - (int)blockIdx.x % nt) * ROWS;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  const int64_t doff = ((int64_t)b * Tn * H + h) * DH;
  const float *kg = k + off, *vg = v + off;
  const int ntk = (Tn + KT - 1) / KT;
  // causal: no k tile past the block's last row
  const int nk = causal ? min((q0 + ROWS) / KT, ntk) : ntk;
  auto stage_kv = [&](int i) {
    float* dst = ring + (i & 1) * STAGE;
    stage_rows<DH, THREADS, KT>(dst, kg, st, i * KT, Tn);
    stage_rows<DH, THREADS, KT>(dst + KT * LD, vg, st, i * KT, Tn);
    cp_async_commit();
  };
  stage_rows<DH, THREADS, ROWS>(Qs, q + off, st, q0, Tn);
  stage_rows<DH, THREADS, ROWS>(Os, dout + doff, (int64_t)H * DH, q0, Tn);
  stage_kv(0);  // one group with q and dO

  const float* qa = a_lane<LD>(Qs, 16 * pr, lane);
  const float* oa = a_lane<LD>(Os, 16 * pr, lane);
  const int row0 = q0 + 16 * pr + g;
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lr[r] = row < Tn ? lse[(int64_t)bh * Tn + row] : 0.f;
    dr[r] = row < Tn ? delta[(int64_t)bh * Tn + row] : 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < nk; ++i) {
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < nk) stage_kv(i + 1);
    const float* Ks = ring + (i & 1) * STAGE;
    const float* Vs = Ks + KT * LD;
    const int k0 = i * KT;
    // S = Q K^T and dP = dO V^T: this warp's 128 columns, then the group's
    // partial sums added in their fixed order
    float sp[2 * NS][4];
#pragma unroll
    for (int n = 0; n < 2 * NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[n][e] = 0.f;
    {
      const float *kb = b_lane<LD>(Ks, lane), *vb = b_lane<LD>(Vs, lane);
#pragma unroll 4
      for (int d = c0; d < c0 + kWarpCols; d += 8) {
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
    group_add<2 * NS, G, Dq<DH>::kSplit>(sp, xs, warp, lane);
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
    for (int c = 0; c < NT / kPass; ++c) {
      float tk[kPass][4];
      prob_pass<NS, LD>(tk, dh, dl, Ks, c0 + 8 * kPass * c, g, t);
#pragma unroll
      for (int n = 0; n < kPass; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[kPass * c + n][e] = acc[kPass * c + n][e] + scale * tk[n][e];
    }
  }
  store_rows<DH, NT>(dq, acc, 1.f, 1.f, b, h, H, Tn, row0, c0, t);
}

// dk/dv's block: 64 key rows (32 at Dh 384) in groups of 16, k and v
// resident, q and dO tiles of 16 rows. A group's dv is summed by kSplit
// warps (role 0) and its dk by as many (role 1), each over kCols of the
// columns: all DH at Dh 256 (128 registers), 192 at Dh 384 (all 384 would
// be 192 registers). Split warps add their partial scores once a tile.
template <int DH>
struct Dkv {
  static constexpr int kRows = DH == 384 ? 32 : 64;
  static constexpr int kGroups = kRows / 16;
  static constexpr int kCols = DH == 384 ? 192 : DH;
  static constexpr int kSplit = DH / kCols;
  static constexpr int kGroupThreads = 32 * 2 * kSplit;
  static constexpr int kThreads = kGroups * kGroupThreads;
  // resident k and v, the q/dO ring, p's hand-over slot (one a group), the
  // partial scores' exchange (one slot a warp, when the columns are split)
  static constexpr int kFloats = 2 * kRows * (DH + 4) + 2 * 2 * kDkvQueries * (DH + 4) +
                                 kGroups * 16 * kDkvQueries +
                                 (kSplit > 1 ? 2 * kSplit * kGroups * 16 * kDkvQueries : 0);
};

// One block per (bh, Dkv::kRows key rows): dk and dv (B, T, H, DH)
// contiguous. dout is contiguous; lse and delta are (B*H, T). k and v stay
// resident; q and dO stream in 16-row tiles. Warp w of the block serves
// keys 16 (w % G) .. 16 (w % G) + 15; w / G is role * kSplit + part: role 0
// sums dv, role 1 dk, over columns part * kCols ...
template <int DH>
__global__ void __launch_bounds__(Dkv<DH>::kThreads, 1)
flash_dkv_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int H, int Tn,
                       int64_t sb, int64_t st, int64_t sh, float scale, int causal) {
  constexpr int LD = DH + 4, ROWS = Dkv<DH>::kRows, G = Dkv<DH>::kGroups;
  constexpr int COLS = Dkv<DH>::kCols, SPLIT = Dkv<DH>::kSplit, THREADS = Dkv<DH>::kThreads;
  constexpr int QT = kDkvQueries, NS = QT / 8, STAGE = 2 * QT * LD, NT = COLS / 8;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + ROWS * LD;
  float* ring = Vs + ROWS * LD;  // stage s: q tile at ring + s STAGE, dO tile after it
  float* xs = ring + 2 * STAGE;  // p, handed from each group's dv warps to its dk warps
  float* xp = xs + G * 16 * QT;  // the split warps' partial scores
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int pr = warp % G, role = warp / (G * SPLIT), part = (warp / G) % SPLIT;
  const int c0 = part * COLS;
  const int nt = (Tn + ROWS - 1) / ROWS;
  // the key tiles of one (b, h) in a row, the keys the most causal rows see first
  const int bh = (int)blockIdx.x / nt, b = bh / H, h = bh % H;
  const int k0 = ((int)blockIdx.x % nt) * ROWS;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  const int64_t doff = ((int64_t)b * Tn * H + h) * DH;
  const float *qg = q + off, *og = dout + doff;
  const int ntq = (Tn + QT - 1) / QT;
  // causal: no row of an earlier q tile sees these keys
  const int first = causal ? k0 / QT : 0;
  auto stage_qo = [&](int j) {
    float* dst = ring + (j & 1) * STAGE;
    stage_rows<DH, THREADS, QT>(dst, qg, st, j * QT, Tn);
    stage_rows<DH, THREADS, QT>(dst + QT * LD, og, (int64_t)H * DH, j * QT, Tn);
    cp_async_commit();
  };
  stage_rows<DH, THREADS, ROWS>(Ks, k + off, st, k0, Tn);
  stage_rows<DH, THREADS, ROWS>(Vs, v + off, st, k0, Tn);
  stage_qo(first);  // one group with k and v

  // role 0: S = K Q^T and P dO; role 1: dP = V dO^T and dS Q
  const float* ra = a_lane<LD>(role ? Vs : Ks, 16 * pr, lane);
  const float* rows = (role ? delta : lse) + (int64_t)bh * Tn;
  const float mul = role ? scale : 1.f;
  const int row0 = k0 + 16 * pr + g;  // this thread's keys: row0 and row0 + 8
  float* slot = xs + pr * 16 * QT;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = first; j < ntq; ++j) {
    const int q0 = j * QT;
    // lse (role 0) or delta (role 1) of this lane's queries; 0 past T
    float rv[NS][2];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = q0 + 8 * n + 2 * t + e;
        rv[n][e] = col < Tn ? rows[col] : 0.f;
      }
    cp_async_wait_all();
    __syncthreads();  // tile j has landed, and every warp is done with tile j - 1
    if (j + 1 < ntq) stage_qo(j + 1);
    const float* Qt = ring + (j & 1) * STAGE;
    const float* Ot = Qt + QT * LD;
    // S = K Q^T (role 0) or dP = V dO^T (role 1) over this warp's columns
    float s[NS][4], s1[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = s1[n][e] = 0.f;
    scores2<NS, LD, COLS>(s, s1, ra, b_lane<LD>(role ? Ot : Qt, lane), c0);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += s1[n][e];
    if constexpr (SPLIT > 1) {
      // the other part's partial score added (a + b is b + a: both hold the same bits)
      static_assert(SPLIT == 2, "two column parts");
      float* mine = xp + warp * 4 * NS * 32;
      const float* other = xp + (part ? warp - G : warp + G) * 4 * NS * 32;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * n + e) * 32 + lane] = s[n][e];
      group_sync<Dkv<DH>::kGroupThreads>(pr);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += other[(4 * n + e) * 32 + lane];
    }
    if (role == 0) {
      // p = exp(scale s - lse); 0 where causal masks (key > query) and past T
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = q0 + 8 * n + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
          float x = scale * s[n][e];
          if (causal && row > col) x = kNegInf;
          s[n][e] = col < Tn ? expf(x - rv[n][e & 1]) : 0.f;
          if (part == 0) slot[(4 * n + e) * 32 + lane] = s[n][e];
        }
      group_sync<Dkv<DH>::kGroupThreads>(pr);
    } else {
      group_sync<Dkv<DH>::kGroupThreads>(pr);  // ds = p (dp - delta)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = slot[(4 * n + e) * 32 + lane] * (s[n][e] - rv[n][e & 1]);
    }
    uint32_t fh[NS][4], fl[NS][4];
    prob_fragments<NS>(s, fh, fl);
    const float* x = role ? Qt : Ot;
#pragma unroll
    for (int c = 0; c < NT / kPass; ++c) {
      float tk[kPass][4];
      prob_pass<NS, LD>(tk, fh, fl, x, c0 + 8 * kPass * c, g, t);
#pragma unroll
      for (int n = 0; n < kPass; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[kPass * c + n][e] = acc[kPass * c + n][e] + mul * tk[n][e];
    }
  }
  store_rows<DH, NT>(role ? dk : dv, acc, 1.f, 1.f, b, h, H, Tn, row0, c0, t);
}

struct Args {
  int B, H, T;
  int64_t sb, st, sh;
  float scale;
  int causal;
};

bool args_ok(int B, int H, int T, int is_bf16, int rows) {
  return !is_bf16 && B > 0 && H > 0 && T > 0 &&
         (int64_t)B * H * ((T + rows - 1) / rows) <= 0x7fffffffLL;
}

// one block per (bh, q or key tile of ``rows``), the tiles of one bh
// consecutive (the blocks on the card at once share one or two heads' k and
// v; a bh-fastest order measured the same at the wide shape)
dim3 grid(const Args& a, int rows) {
  return dim3((unsigned)(a.B * a.H * ((a.T + rows - 1) / rows)));
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int floats) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

template <int DH>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                       const Args& a, cudaStream_t s) {
  constexpr int floats = Fwd<DH>::kFloats;
  cudaError_t e = prepare(flash_fwd_f32tc_kernel<DH>, floats);
  if (e != cudaSuccess) return e;
  flash_fwd_f32tc_kernel<DH><<<grid(a, kRows), Fwd<DH>::kThreads, floats * sizeof(float), s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, a.H, a.T, a.sb, a.st,
      a.sh, a.scale, a.causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, const Args& a,
                      cudaStream_t s) {
  constexpr int floats = Dq<DH>::kFloats;
  cudaError_t e = prepare(flash_dq_f32tc_kernel<DH>, floats);
  if (e != cudaSuccess) return e;
  flash_dq_f32tc_kernel<DH><<<grid(a, Dq<DH>::kRows), Dq<DH>::kThreads,
                              floats * sizeof(float), s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dq, a.H, a.T, a.sb, a.st, a.sh, a.scale, a.causal);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       const Args& a, cudaStream_t s) {
  constexpr int floats = Dkv<DH>::kFloats;
  cudaError_t e = prepare(flash_dkv_f32tc_kernel<DH>, floats);
  if (e != cudaSuccess) return e;
  flash_dkv_f32tc_kernel<DH><<<grid(a, Dkv<DH>::kRows), Dkv<DH>::kThreads,
                               floats * sizeof(float), s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, a.H, a.T, a.sb, a.st, a.sh, a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v (B, T, H, Dh) float32 sharing the element strides (sb, st, sh),
// Dh contiguous, 16-byte aligned rows; o (B, T, H, Dh) and lse (B*H, T)
// contiguous outputs. Takes Dh 128, 256 and 384 with is_bf16 = 0 only.
// Returns the cudaError_t of the launch.
extern "C" int fedml_flash_fwd_f32_sm90(const void* q, const void* k, const void* v, void* o,
                                        float* lse, int B, int H, int T, int Dh, int is_bf16,
                                        int causal, long long sb, long long st, long long sh,
                                        float scale, void* stream) {
  if (!args_ok(B, H, T, is_bf16, kRows)) return (int)cudaErrorInvalidValue;
  const Args a{B, H, T, sb, st, sh, scale, causal};
  cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 128: return (int)launch_fwd<128>(q, k, v, o, lse, a, s);
    case 256: return (int)launch_fwd<256>(q, k, v, o, lse, a, s);
    case 384: return (int)launch_fwd<384>(q, k, v, o, lse, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dq (B, T, H, Dh) contiguous from q, k, v (strided as for the forward),
// dout (B, T, H, Dh) contiguous, and the forward's lse and delta =
// rowsum(dO * O), both (B*H, T) float32. Takes Dh 256 and 384 with is_bf16
// = 0 only.
extern "C" int fedml_flash_dq_f32_sm90(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dq, int B, int H, int T, int Dh, int is_bf16,
                                       int causal, long long sb, long long st, long long sh,
                                       float scale, void* stream) {
  if (!args_ok(B, H, T, is_bf16, 32)) return (int)cudaErrorInvalidValue;
  const Args a{B, H, T, sb, st, sh, scale, causal};
  cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 256: return (int)launch_dq<256>(q, k, v, dout, lse, delta, dq, a, s);
    case 384: return (int)launch_dq<384>(q, k, v, dout, lse, delta, dq, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dk and dv (B, T, H, Dh) contiguous, from the same inputs as dq. Takes Dh
// 256 and 384 with is_bf16 = 0 only.
extern "C" int fedml_flash_dkv_f32_sm90(const void* q, const void* k, const void* v,
                                        const void* dout, const float* lse, const float* delta,
                                        void* dk, void* dv, int B, int H, int T, int Dh,
                                        int is_bf16, int causal, long long sb, long long st,
                                        long long sh, float scale, void* stream) {
  if (!args_ok(B, H, T, is_bf16, 32)) return (int)cudaErrorInvalidValue;
  const Args a{B, H, T, sb, st, sh, scale, causal};
  cudaStream_t s = (cudaStream_t)stream;
  switch (Dh) {
    case 256: return (int)launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, a, s);
    case 384: return (int)launch_dkv<384>(q, k, v, dout, lse, delta, dk, dv, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
