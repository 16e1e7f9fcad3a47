// Flash attention's forward, dq and dk/dv at head dim 256 for bfloat16 (B,
// T, H, 256) inputs on the Hopper tensor cores, causal or full, any T: the
// Cheetah LM's attention at --dim 2048 (8 heads of 256). Every other head
// dim stays in flash_attention_sm90.cu.
//
// Replaces: fedml_tpu/ops/pallas/flash_attention.py — _flash_kernel (:66,
// the forward: o = softmax(scale q k^T, causal mask) v and lse = m + log l),
// _dq_kernel (:167: p = exp(scale q k^T - lse), ds = p (dO v^T - delta), dq
// = sum scale ds k) and _dkv_kernel (:213: dv = sum p^T dO, dk = scale sum
// ds^T q). The arithmetic is
// flash_attention_sm90.cu's: bf16 x bf16 score products exact with float32
// sums, p and ds as three bf16 terms (exact to float32), each 64-row tile's
// products from a zero accumulator added in float32, finfo(float32).min
// masking, l clamped at 1e-30, the scale 2^-4 applied after Q K^T.
//
// Bound on the H100 at the wide LM's shape (B 8, T 4608, H 8, causal):
// 6.796e8 unmasked (q, k) pairs x 2 x 256 operations = 0.348 TFLOP a
// product. The forward does one bf16 product and one split product (1 + 3
// tensor-core products), dq two and one (2 + 3), dk/dv two and two (2 +
// 6): 1.41, 1.76 and 2.82 ms at 989 TFLOP/s, against ~0.2 ms of bytes at
// 3.35 TB/s. Bound by operations.
//
// What held flash_attention_sm90.cu's Dh-256 forms back: a 64 x 256 float32
// accumulator takes 128 registers a thread, so their two warpgroups each
// owned 128 output columns and both computed every score product (5 product
// units for the forward's 4, 7 for dq's 5, 10 for dk/dv's 8), with the
// softmax, the three-term split and every load's address work done twice,
// in lockstep, and every thread issuing cp.async and its address work.
// Here every score product, exponential and split runs once per block.
//
// Forward. A block takes 128 q rows; warpgroups 0 and 1 each own 64 of them
// over all 256 columns, with warpgroup 1's rows after warpgroup 0's, and
// walk the k/v tiles up to their diagonals; warpgroup 2 only issues copies
// (setmaxnreg gives its registers to the other two: 240 each). Per k tile a
// warpgroup computes its 64 x 64 scores (wgmma m64n64k16, 16 k steps, the
// order of flash_attention_sm90.cu), the online softmax and the split, then
// P V one 64-column group at a time into a 32-register accumulator from
// zero, added to its 128-register output in float32: the bits of the
// earlier kernel, and no exchange between warpgroups. Nothing couples the
// two warpgroups but the k/v stages, so one's softmax runs while the
// other's products do. Shared memory: q (64 KB), two k stages and two v
// stages (32 KB each): 192 KB; full and empty mbarriers per stage (k and v
// apart, so Q K^T starts before v lands).
//
// dk/dv. A block takes a 64-row k tile with its v tile and walks the q/dO
// tiles (with their lse and delta) from the diagonal on. The dk and dv
// accumulators (128 registers each) do not fit one warpgroup, so warpgroup
// 0 computes S^T = K Q^T, forms p and sums dv = P^T dO over all 256
// columns, and warpgroup 1 computes dP^T = V dO^T, takes p from a
// double-buffered exchange tile in shared memory (named barriers: written,
// read), forms ds and sums dk = dS^T Q: 8 product units, one exchange, and
// warpgroup 0 may run up to two q tiles ahead. The split products run one
// 64-column group at a time into a 32-register accumulator from zero: 0
// bytes spilled. Shared memory: k and v (64 KB), two q/dO stages (128 KB)
// with their lse and delta (1.5 KB), two p tiles (32 KB): 227 KB with
// alignment (static_assert below). Thread 0 of warpgroup 1, which reads each
// stage last, refills a stage once all 256 threads have arrived on its empty
// mbarrier. A producer warpgroup here (registers capped at 232 or 240) ran
// 1.1-2.4 ms slower.
//
// dq. The forward's layout: a block takes 128 q rows, warpgroups 0 and 1
// own 64 each over all 256 columns (a 128-register dq accumulator), and
// warpgroup 2 issues the copies (setmaxnreg: 240 and 24 registers). Per k
// tile a warpgroup computes its own S = Q K^T and dP = dO V^T (two wgmma
// m64n64k16 chains over the 256 columns), forms ds = p (dP - delta) in the
// accumulator registers, splits it into three bf16 terms as the register A
// operand, and runs dS K one 64-column group at a time into a 32-register
// accumulator from zero, adding scale times it to dq in float32: the
// bits of the earlier kernel. q and dO stay resident (128 KB); v is read
// only by dP, so its slot frees before dS K starts and one v stage beside
// two k stages suffices: 7 tiles, 230,456 bytes with barriers and
// alignment (static_assert below); two stages of both would take 256 KB.
// lse and delta are two plain loads a thread, once per block. On the
// causal diagonal dP is summed on the CUDA cores in a plain float32
// product's order (dots_plain), which repeats the plain version's rounding
// noise in row 0, where p = 1 on one key and dp - delta cancels. That tile
// is a separate instance after the loop: a branch inside the loop that
// wrote dP's accumulator made ptxas serialize every wgmma (warning C7520;
// 5.86 against 4.70 ms). The warpgroup index goes through a shuffle so that
// ptxas knows it is warp-uniform (40 -> 8 bytes spilled). Without the
// producer warpgroup (thread 0 of warpgroup 1 issuing, 255 registers) it
// ran 0.85 ms slower and spilled 300 bytes. The diagonal still costs ~0.6
// ms of the 4 at the wide LM's shape: its four warps per SM (one per
// scheduler) wait on their shared-memory loads, and warpgroup 1 waits for
// warpgroup 0's diagonal to free the v slot.
//
// All three. Blocks go by (b, h), and within one the longest causal rows
// (dk/dv: the keys seen by the most rows) first. Tiles arrive by the tensor memory
// accelerator (TMA): one 4-D tensor map per operand, (Dh, H, T, B) with the
// caller's element strides (q, k, v are strided views of one projection),
// boxes of 64 columns x 64 rows in the 128-byte swizzle, the layout desc_k
// and desc_mn read; the hardware zero-fills rows at or past T. lse and delta
// come by a 1-D map over the (B*H*T) vector (a row stride of T floats need
// not be a multiple of 16 bytes), in boxes that start on a 16-byte boundary,
// as TMA requires (dk/dv; dq reads its rows' values directly). One thread
// issues every copy into full mbarriers that count the bytes; no thread
// computes a load address. Exchange tiles are 64
// x 64 floats, row r's columns XOR-swizzled by 8 (r % 4), so a warp's float2
// accesses (4 rows x 4 lanes per half warp) hit 32 distinct banks. No
// atomics and one fixed order of every sum: dk and dv repeat bit for bit.

#include <type_traits>

#include "flash_tma_sm90.cuh"

namespace {

constexpr int kDh = 256;
constexpr int kThreads = 2 * kWG;                 // dk/dv: two warpgroups
// forward and dq: two consumer warpgroups and a producer warpgroup, whose
// registers go to the consumers (2 x 128 x 240 + 128 x 24 <= 65,536)
constexpr int kFwdThreads = 3 * kWG;
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
constexpr int kTileBytes = kDh / 64 * kGroupBytes;  // a 64 x 256 bf16 tile: 32 KB

// forward: 128 q rows, k stages, v stages, 9 barriers (+ alignment slack)
constexpr int kFwdSmem = 6 * kTileBytes + 9 * 8 + 1024;
// dk/dv: k, v, q/dO stages, two p tiles, lse/delta stages, 5 barriers
constexpr int kDkvSmem = 6 * kTileBytes + 2 * kXFloats * 4 + 4 * kVecSlot + 5 * 8 + 1024;
// dq: 128 q rows and their dO rows (4 tiles), two k stages and one v stage, 7
// barriers: 229,376 + 56 + 1,024 = 230,456 bytes
constexpr int kDqSmem = 7 * kTileBytes + 7 * 8 + 1024;
static_assert(kFwdSmem <= 232448 && kDkvSmem <= 232448 && kDqSmem <= 232448,
              "shared memory of one H100 block");

// named barriers of dk/dv's two warpgroups (0 is __syncthreads): p tile
// i % 2 written (kPFull + i % 2) and read (kPEmpty + i % 2)
constexpr int kPFull = 1, kPEmpty = 3;


// --- the kernels ---------------------------------------------------------------

// One block per (bh, 128-row q tile): o (B, T, H, 256) contiguous, lse (B*H,
// T). Warpgroups 0 and 1 each own 64 of the rows over all 256 columns;
// warpgroup 2 issues the copies.
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_dh256_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o,
                       float* __restrict__ lse, int H, int Tn, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const uint32_t Qs = smem_addr(base);      // warpgroup w's rows at Qs + w kTileBytes
  const uint32_t Ks = Qs + 2 * kTileBytes;  // k stage s at Ks + s kTileBytes
  const uint32_t Vs = Ks + 2 * kTileBytes;  // v stage s at Vs + s kTileBytes
  // barriers: q; stage s of k and of v full (+ 8 s) and read by both
  // warpgroups (empty, + 8 s)
  const uint32_t qbar = smem_addr(base + 6 * kTileBytes);
  const uint32_t kfull = qbar + 8, vfull = qbar + 24, kempty = qbar + 40, vempty = qbar + 56;
  const int tid = threadIdx.x, wg = tid / kWG, warp = tid % kWG / 32, lane = tid % 32;
  const int nt = (Tn + kTile - 1) / kTile, nb = (Tn + 2 * kTile - 1) / (2 * kTile);
  // blocks by (b, h), and within one the longest causal rows first: the
  // resident blocks share one or two heads' k and v in L2
  const int bh = (int)blockIdx.x / nb, b = bh / H, h = bh % H;
  const int q0 = (nb - 1 - (int)blockIdx.x % nb) * 2 * kTile;
  // k tiles of warpgroup w: causal, none past its diagonal
  auto tiles = [&](int w) { return causal ? min(q0 / kTile + w + 1, nt) : nt; };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) mbar_init(qbar + 8 * i, 1);
#pragma unroll
    for (int i = 5; i < 9; ++i) mbar_init(qbar + 8 * i, kThreads);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: q, then k and v tile t once tile t - 2 is read
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 2 * kWG) {
      mbar_expect(qbar, 2 * kTileBytes);
      tma_tile<kDh>(Qs, &qmap, qbar, h, q0, b);
      tma_tile<kDh>(Qs + kTileBytes, &qmap, qbar, h, q0 + kTile, b);
      const int n = tiles(1);
      for (int t = 0; t < n; ++t) {
        const int s = t % 2;
        if (t >= 2) mbar_wait(kempty + 8 * s, (t / 2 - 1) & 1);
        mbar_expect(kfull + 8 * s, kTileBytes);
        tma_tile<kDh>(Ks + s * kTileBytes, &kmap, kfull + 8 * s, h, t * kTile, b);
        if (t >= 2) mbar_wait(vempty + 8 * s, (t / 2 - 1) & 1);
        mbar_expect(vfull + 8 * s, kTileBytes);
        tma_tile<kDh>(Vs + s * kTileBytes, &vmap, vfull + 8 * s, h, t * kTile, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int qw = q0 + wg * kTile;          // this warpgroup's first row
  const int row0 = qw + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int c2 = 2 * (lane % 4);
  const int nk = tiles(wg);
  const uint32_t q_tile = Qs + wg * kTileBytes;
  float acc[kDh / 64][32];
#pragma unroll
  for (int g = 0; g < kDh / 64; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % 2;
    const uint32_t parity = (kt / 2) & 1;
    float x[32], corr[2];
    mbar_wait(kfull + 8 * s, parity);
    wg_fence();
    scores<kDh / 16>(x, q_tile, Ks + s * kTileBytes);
    wg_commit();
    wg_wait<0>();
    pin(x);
    mbar_arrive(kempty + 8 * s);
    softmax_tile(x, m, l, corr, kt * kTile, qw, row0, c2, Tn, causal, scale);
    uint32_t a[4][3][4];
    split_frags(x, a);
    mbar_wait(vfull + 8 * s, parity);
#pragma unroll
    for (int g = 0; g < kDh / 64; ++g) {  // P V, one 64-column group at a time
      float pv[32];
      wg_fence();
      mma_split_group(pv, a, Vs + s * kTileBytes, g);
      wg_commit();
      wg_wait<0>();
      pin(pv);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[g][i] = acc[g][i] * corr[(i >> 1) & 1] + pv[i];
    }
    mbar_arrive(vempty + 8 * s);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= Tn) continue;
    const float ls = fmaxf(l[hh], 1e-30f);
    if (lane % 4 == 0) lse[(int64_t)bh * Tn + row] = m[hh] + logf(ls);
    bf16* dst = o + (((int64_t)b * Tn + row) * H + h) * kDh + c2;
#pragma unroll
    for (int g = 0; g < kDh / 64; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 64 * g + 8 * j) = __floats2bfloat162_rn(
            acc[g][4 * j + 2 * hh] / ls, acc[g][4 * j + 2 * hh + 1] / ls);
  }
}

// One block per (bh, 64-row k tile): dk and dv (B, T, H, 256) contiguous.
// dO is contiguous; lse and delta are (B*H, T). Warpgroup 0 forms p and sums
// dv, warpgroup 1 forms ds from that p and sums dk.
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_dh256_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap omap,
                       const __grid_constant__ CUtensorMap lmap,
                       const __grid_constant__ CUtensorMap dmap, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int H, int Tn, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const uint32_t Ks = smem_addr(base), Vs = Ks + kTileBytes;
  const uint32_t ring = Vs + kTileBytes;  // stage s: Q at ring + 2 s kTileBytes, dO after it
  float* P = reinterpret_cast<float*>(base + 6 * kTileBytes);  // p of q tile i: + i % 2 kXFloats
  // stage s: lse at vecs + 2 s kVecSlot, delta kVecSlot after it
  uint8_t* vecs = base + 6 * kTileBytes + 2 * kXFloats * 4;
  // barriers: k and v; stage s full at full + 8 s, read by all 256 threads at empty + 8 s
  const uint32_t kvbar = smem_addr(vecs + 4 * kVecSlot), full = kvbar + 8, empty = kvbar + 24;
  const int tid = threadIdx.x, wg = tid / kWG, warp = tid % kWG / 32, lane = tid % 32;
  const int nq = (Tn + kTile - 1) / kTile;
  // blocks by (b, h), and within one the keys seen by the most causal rows first
  const int bh = (int)blockIdx.x / nq, b = bh / H, h = bh % H;
  const int k0 = (int)blockIdx.x % nq * kTile;
  const int first = causal ? k0 / kTile : 0;  // causal: earlier q tiles see none of these keys
  const int n = nq - first;                   // q tiles of this block
  const int r = 16 * warp + lane / 4;         // this thread's keys of the tile: r, r + 8
  const int row0 = k0 + r;
  const int c2 = 2 * (lane % 4);
  const bool issuer = tid == kWG;  // warpgroup 1, which reads each stage last, refills it
  // where the q tile at q0 starts in its lse and delta boxes
  auto vec_skip = [&](int q0) { return (bh * Tn + q0) & 3; };
  // issuer only: the i-th q tile, its dO tile, lse and delta into stage i % 2
  auto load_q = [&](int i) {
    if (i < n) {
      const int q0 = (first + i) * kTile;
      const uint32_t bar = full + 8 * (i % 2), dst = ring + (i % 2) * 2 * kTileBytes;
      const uint32_t vec = smem_addr(vecs + (i % 2) * 2 * kVecSlot);
      const int v0 = bh * Tn + q0 - vec_skip(q0);
      mbar_expect(bar, 2 * kTileBytes + 2 * kVecBox * 4);
      tma_tile<kDh>(dst, &qmap, bar, h, q0, b);
      tma_tile<kDh>(dst + kTileBytes, &omap, bar, h, q0, b);
      tma_1d(vec, &lmap, bar, v0);
      tma_1d(vec + kVecSlot, &dmap, bar, v0);
    }
  };

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) mbar_init(kvbar + 8 * i, 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) mbar_init(empty + 8 * i, kThreads);
    mbar_init_fence();
  }
  __syncthreads();
  if (issuer) {
    mbar_expect(kvbar, 2 * kTileBytes);
    tma_tile<kDh>(Ks, &kmap, kvbar, h, k0, b);
    tma_tile<kDh>(Vs, &vmap, kvbar, h, k0, b);
    load_q(0);
    load_q(1);
  }
  __syncwarp();
  float acc[kDh / 64][32];  // warpgroup 0: dv, warpgroup 1: dk (scaled at the end)
#pragma unroll
  for (int g = 0; g < kDh / 64; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0.f;
  mbar_wait(kvbar, 0);

  for (int i = 0; i < n; ++i) {
    mbar_wait(full + 8 * (i % 2), (i / 2) & 1);
    const uint32_t q_tile = ring + (i % 2) * 2 * kTileBytes, o_tile = q_tile + kTileBytes;
    const int q0 = (first + i) * kTile;
    const float* lv =
        reinterpret_cast<const float*>(vecs + (i % 2) * 2 * kVecSlot) + vec_skip(q0);
    float* Pi = P + (i % 2) * kXFloats;
    float x[32];
    wg_fence();
    if (wg == 0)
      scores<kDh / 16>(x, Ks, q_tile);  // S^T = K Q^T
    else
      scores<kDh / 16>(x, Vs, o_tile);  // dP^T = V dO^T
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
      if (i >= 2) named_sync<kThreads>(kPEmpty + i % 2);  // warpgroup 1 has read p of tile i - 2
      put_tile(Pi, x, r, c2);
      named_arrive<kThreads>(kPFull + i % 2);
    } else {
      const float* dl = lv + kVecSlot / 4;
      named_sync<kThreads>(kPFull + i % 2);  // p of tile i is in Pi
      float p[32];
      get_tile(Pi, p, r, c2);
      if (i + 2 < n) named_arrive<kThreads>(kPEmpty + i % 2);
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
    const uint32_t rhs = wg == 0 ? o_tile : q_tile;  // P^T dO, or dS^T Q
#pragma unroll
    for (int g = 0; g < kDh / 64; ++g) {
      float t[32];
      wg_fence();
      mma_split_group(t, a, rhs, g);
      wg_commit();
      wg_wait<0>();
      pin(t);
#pragma unroll
      for (int m = 0; m < 32; ++m) acc[g][m] += t[m];
    }
    mbar_arrive(empty + 8 * (i % 2));  // this thread is done with stage i % 2
    if (issuer) {
      mbar_wait(empty + 8 * (i % 2), (i / 2) & 1);
      load_q(i + 2);
    }
    __syncwarp();
  }

  bf16* dst = wg == 0 ? dv : dk;
  const float mul = wg == 0 ? 1.f : scale;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= Tn) continue;
    const int64_t at = (((int64_t)b * Tn + row) * H + h) * kDh + c2;
#pragma unroll
    for (int g = 0; g < kDh / 64; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int m = 4 * j + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(dst + at + 64 * g + 8 * j) =
            __floats2bfloat162_rn(mul * acc[g][m], mul * acc[g][m + 1]);
      }
  }
}

// One block per (bh, 128-row q tile): dq (B, T, H, 256) contiguous. dO is
// contiguous; lse and delta are (B*H, T). Warpgroups 0 and 1 each own 64 of
// the rows over all 256 columns; warpgroup 2 issues the copies.
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_dq_dh256_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap, const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dq, int H, int Tn,
                      float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  const uint32_t Qs = smem_addr(base);      // warpgroup w's q rows at Qs + w kTileBytes
  const uint32_t Os = Qs + 2 * kTileBytes;  // ... its dO rows at Os + w kTileBytes
  const uint32_t Ks = Os + 2 * kTileBytes;  // k stage s at Ks + s kTileBytes
  const uint32_t Vs = Ks + 2 * kTileBytes;  // the v stage
  // barriers: q and dO; k stage s full (+ 8 s) and read by both warpgroups
  // (empty, + 8 s); v full and read
  const uint32_t qbar = smem_addr(base + 7 * kTileBytes);
  const uint32_t kfull = qbar + 8, kempty = qbar + 24, vfull = qbar + 40, vempty = qbar + 48;
  const int tid = threadIdx.x, warp = tid % kWG / 32, lane = tid % 32;
  // the warpgroup, through a shuffle, so that ptxas knows it is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  const int nt = (Tn + kTile - 1) / kTile, nb = (Tn + 2 * kTile - 1) / (2 * kTile);
  // blocks by (b, h), and within one the longest causal rows first
  const int bh = (int)blockIdx.x / nb, b = bh / H, h = bh % H;
  const int q0 = (nb - 1 - (int)blockIdx.x % nb) * 2 * kTile;
  // k tiles of warpgroup w: causal, none past its diagonal
  auto tiles = [&](int w) { return causal ? min(q0 / kTile + w + 1, nt) : nt; };
  const int n = tiles(1);  // the block's k tiles: warpgroup 1's
  auto load_qo = [&] {
    mbar_expect(qbar, 4 * kTileBytes);
    tma_tile<kDh>(Qs, &qmap, qbar, h, q0, b);
    tma_tile<kDh>(Qs + kTileBytes, &qmap, qbar, h, q0 + kTile, b);
    tma_tile<kDh>(Os, &omap, qbar, h, q0, b);
    tma_tile<kDh>(Os + kTileBytes, &omap, qbar, h, q0 + kTile, b);
  };
  auto load_k = [&](int t) {
    const uint32_t full = kfull + 8 * (t % 2);
    mbar_expect(full, kTileBytes);
    tma_tile<kDh>(Ks + (t % 2) * kTileBytes, &kmap, full, h, t * kTile, b);
  };
  auto load_v = [&](int t) {
    mbar_expect(vfull, kTileBytes);
    tma_tile<kDh>(Vs, &vmap, vfull, h, t * kTile, b);
  };

  if (tid == 0) {
    mbar_init(qbar, 1);
    mbar_init(kfull, 1);
    mbar_init(kfull + 8, 1);
    mbar_init(vfull, 1);
    mbar_init(kempty, kThreads);
    mbar_init(kempty + 8, kThreads);
    mbar_init(vempty, kThreads);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: k tile t once tile t - 2 is read, v tile t once t - 1 is
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 2 * kWG) {
      load_qo();
      for (int t = 0; t < n; ++t) {
        if (t >= 2) mbar_wait(kempty + 8 * (t % 2), (t / 2 - 1) & 1);
        load_k(t);
        if (t >= 1) mbar_wait(vempty, (t - 1) & 1);
        load_v(t);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int qw = q0 + wg * kTile;              // this warpgroup's first row
  const int row0 = qw + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int c2 = 2 * (lane % 4);
  const int nk = tiles(wg);
  const uint32_t q_tile = Qs + wg * kTileBytes, o_tile = Os + wg * kTileBytes;
  float lr[2], dr[2];  // lse and delta of this thread's rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    lr[hh] = row < Tn ? lse[(int64_t)bh * Tn + row] : 0.f;
    dr[hh] = row < Tn ? delta[(int64_t)bh * Tn + row] : 0.f;
  }
  float dqa[kDh / 64][32];
#pragma unroll
  for (int g = 0; g < kDh / 64; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[g][i] = 0.f;
  // k tile kt: S = Q K^T, issued before v has landed; dP = dO V^T, on the
  // causal diagonal (DIAG) summed by dots_plain in a plain float32 product's
  // order instead; ds; dS K one 64-column group at a time. The diagonal is
  // a separate instance, so no branch inside the loop writes a wgmma
  // accumulator (ptxas serialized every wgmma of the loop when one did).
  auto tile = [&](int kt, auto diag) {
    constexpr bool DIAG = decltype(diag)::value;
    const int sk = kt % 2;
    const uint32_t k_tile = Ks + sk * kTileBytes;
    float s[32], dp[32];
    mbar_wait(kfull + 8 * sk, (kt / 2) & 1);
    wg_fence();
    scores<kDh / 16>(s, q_tile, k_tile);
    wg_commit();
    mbar_wait(vfull, kt & 1);
    if constexpr (DIAG) {
      dots_plain<kDh>(dp, base + 2 * kTileBytes + wg * kTileBytes, base + 6 * kTileBytes,
                 row0 - qw, c2);
    } else {
      wg_fence();
      scores<kDh / 16>(dp, o_tile, Vs);
      wg_commit();
    }
    wg_wait<0>();
    pin(s);
    pin(dp);
    mbar_arrive(vempty);  // this thread is done with v
    ds_tile(s, dp, lr, dr, kt * kTile, qw, row0, c2, Tn, causal, scale);
    uint32_t a[4][3][4];
    split_frags(dp, a);
#pragma unroll
    for (int g = 0; g < kDh / 64; ++g) {
      float t[32];
      wg_fence();
      mma_split_group(t, a, k_tile, g);
      wg_commit();
      wg_wait<0>();
      pin(t);
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[g][i] += scale * t[i];
    }
    mbar_arrive(kempty + 8 * sk);  // ... and with this k stage
  };
  mbar_wait(qbar, 0);
  const int nfull = causal ? nk - 1 : nk;  // causal: the last k tile is the diagonal
  for (int kt = 0; kt < nfull; ++kt) tile(kt, std::false_type());
  if (causal) tile(nk - 1, std::true_type());

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= Tn) continue;
    bf16* dst = dq + (((int64_t)b * Tn + row) * H + h) * kDh + c2;
#pragma unroll
    for (int g = 0; g < kDh / 64; ++g)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 64 * g + 8 * j) =
            __floats2bfloat162_rn(dqa[g][4 * j + 2 * hh], dqa[g][4 * j + 2 * hh + 1]);
  }
}

}  // namespace

// The entry points take the arguments of fedml_flash_fwd_sm90 and
// fedml_flash_dkv_sm90 (flash_attention_sm90.cu) and only Dh 256 bfloat16
// (is_bf16 = 1): q, k, v (B, T, H, 256) share the element strides (sb, st,
// sh) with Dh contiguous and 16-byte aligned rows; dO, lse and delta and the
// outputs are contiguous. Return the launch's cudaError_t
// (cudaErrorInvalidValue when a tensor map cannot be made).
extern "C" int fedml_flash_fwd_dh256_sm90(const void* q, const void* k, const void* v, void* o,
                                          float* lse, int B, int H, int T, int Dh, int is_bf16,
                                          int causal, long long sb, long long st, long long sh,
                                          float scale, void* stream) {
  CUtensorMap qm, km, vm;
  if (!args_ok<kDh>(B, H, T, Dh, is_bf16) || !map_rows<kDh>(&qm, q, B, H, T, sb, st, sh) ||
      !map_rows<kDh>(&km, k, B, H, T, sb, st, sh) || !map_rows<kDh>(&vm, v, B, H, T, sb, st, sh))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_dh256_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_dh256_kernel<<<grid(B, H, T, 2 * kTile), kFwdThreads, kFwdSmem,
                           (cudaStream_t)stream>>>(
      qm, km, vm, (bf16*)o, lse, H, T, scale, causal);
  return (int)cudaGetLastError();
}

extern "C" int fedml_flash_dkv_dh256_sm90(const void* q, const void* k, const void* v,
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
  cudaError_t e = cudaFuncSetAttribute(flash_dkv_dh256_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
  if (e != cudaSuccess) return (int)e;
  flash_dkv_dh256_kernel<<<grid(B, H, T, kTile), kThreads, kDkvSmem,
                           (cudaStream_t)stream>>>(
      qm, km, vm, om, lm, dm, (bf16*)dk, (bf16*)dv, H, T, scale, causal);
  return (int)cudaGetLastError();
}

extern "C" int fedml_flash_dq_dh256_sm90(const void* q, const void* k, const void* v,
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
  cudaError_t e = cudaFuncSetAttribute(flash_dq_dh256_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (e != cudaSuccess) return (int)e;
  flash_dq_dh256_kernel<<<grid(B, H, T, 2 * kTile), kFwdThreads, kDqSmem,
                          (cudaStream_t)stream>>>(qm, km, vm, om, lse, delta, (bf16*)dq, H, T,
                                                  scale, causal);
  return (int)cudaGetLastError();
}
