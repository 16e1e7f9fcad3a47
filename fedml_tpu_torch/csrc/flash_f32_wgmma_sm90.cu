// Flash attention's backward (dq; dk and dv) for float32 inputs at Dh 128
// on the Hopper tensor cores, exact to float32 through three TF32 products
// (3xTF32, tf32x3.cuh), every product on TF32 wgmma. The float32 forward at
// Dh 128 and every other float32 head dim are flash_f32_sm90.cu's and
// flash_wide_f32_sm90.cu's (Dh 64: flash_attention.cu's FMA kernels).
//
// Replaces: fedml_tpu/ops/pallas/flash_attention.py — _dq_kernel (:167,
// pallas_call :287) and _dkv_kernel (:213, pallas_call :299), both reached
// from _flash_backward (:265), on float32 inputs at Dh 128. The TPU kernels
// walk a sequential (bh, q block, k block) grid with their sums in VMEM
// scratch; here a block owns 64 q rows (dq) or 64 key rows (dk/dv) and
// walks the other axis in a loop, with the sums in registers.
//
// Arithmetic: flash_f32_sm90.cu's, unchanged (its header). Float32 in and
// out; the score is scaled after the product; masked scores are
// finfo(float32).min; p = exp(scale q.k - lse), ds = p (dO.v - delta); dq
// adds scale (dS K) per k tile, dk/dv add P^T dO and scale (dS^T Q) per q
// tile. Every product is three TF32 products, lo hi, hi lo, hi hi (small
// terms first, lo lo dropped), from the split hi = cvt.rna.tf32(v), lo = v
// - hi (split_tf32). Each streamed tile's product starts from zero and is
// added to the running sums in float32; every sum has one fixed order and
// there are no atomics, so dq, dk and dv repeat bit for bit. The blocks of
// the longest causal rows (the keys the most rows see) launch first; rows
// and columns at or past T are zero-filled and masked, so any T works.
//
// Design. TF32 wgmma takes K-major operands only, its M is 64, and with A in
// shared memory it reads 2 KB of A for every product: on an H100 (PERF.md,
// tc_rate.cu's probe) m64nNk8 with both operands in shared memory reached
// 33 / 57 / 88% of the TF32 peak at N = 16 / 32 / 64, with A in registers
// 39 / 67 / 80% (one warpgroup an SM; two: 54 / 88 / 93%). Shared memory
// allows no streamed tile past 32 rows, so the design keeps A's hi terms in
// registers. A block is two warpgroups (256 threads) over 64 rows: each
// holds one resident tensor (q and dO in dq, k and v in dk/dv) as this
// lane's m16n8k8 A fragments of its hi terms (64 registers, read once from
// a split tile) and as its lo tile in shared memory, and runs one score
// product (S = Q K^T and dP = dO V^T; S^T = K Q^T and dP^T = V dO^T) as
// wgmma.m64n32k8: lo hi with A from shared memory, hi lo and hi hi with A
// from registers, 16 k steps into one accumulator. The streamed tiles (k and
// v in dq; q and dO in dk/dv; 32 rows) land by cp.async in a plain stage one
// tile ahead and are split once a block into hi and lo tiles in wgmma's
// 128-byte-swizzled K-major layout (flash_sm90.cuh's swz and desc_k; a TF32
// k step is 8 floats, 32 bytes). The output products (dS K; P^T dO and dS^T
// Q) have B MN-major, so the split pass also writes the tiles they read (k
// in dq; q and dO in dk/dv) transposed: 128 rows of 32 floats, K-major over
// the streamed rows. Their A operand is P or dS straight from the score
// accumulator, whose lane holds rows g and g + 8 at columns 2 t and 2 t +
// 1 of each 8-column step: as a register A fragment that is k index t = key
// 2 t and t + 4 = key 2 t + 1, so the transposed tiles store their k
// positions in that order (kpos) and no value moves between lanes. They run
// as wgmma.m64n64k8 with A from registers, three products a k step, from a
// zero accumulator per tile added in float32. In dq warpgroup 0 forms p and
// warpgroup 1 dp - delta; they trade them through shared memory (the lane of
// the same accumulator entry), each forms ds, and each adds dS K over half
// of dq's columns. In dk/dv warpgroup 0 forms p, sums dv and hands p to
// warpgroup 1, which forms ds and sums dk. Shared memory: dq 210 KB, dk/dv
// 226 KB (its p hand-over sits in the landing stage between the split and
// the next tile's copies): one block an SM. On the H100 at the float32 LM's
// shape below (PERF.md): dq 8.1-8.5 ms, dk/dv 11.7-12.0, against 9.9 and
// 14.0 for flash_f32_sm90.cu's mma.sync layouts instantiated at Dh 128, 17.0
// and 21.6 for the FMA kernels, and 24.5 for SDPA's backward. The tile-end
// split takes ~20% of either kernel and the hand-over ~20% (PERF.md).
//
// Bound on the H100 at the float32 LM's shape (B 8, T 4608, H 8, Dh 128,
// causal): 679,624,704 unmasked (q, k) pairs x 256 operations = 0.1740
// TFLOP a product; as three TF32 products at 495 TFLOP/s dq (three
// products) takes 3.163 ms and dk/dv (four) 4.218 ms, at the float32 FMA
// rate (67 TFLOP/s) 7.790 and 10.39 ms; bytes take under 0.1 ms.

#include "flash_sm90.cuh"
#include "tf32x3.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kDh = 128;         // head dim
constexpr int kRows = 64;        // rows a block owns: q rows (dq) or key rows (dk/dv)
constexpr int kKeys = 32;        // rows of the streamed tiles: k and v (dq), q and dO (dk/dv)
constexpr int kNK = kKeys / 8;   // 8-row k steps of a streamed tile
constexpr int kLand = kDh + 4;   // row stride, in floats, of the landing stage
constexpr int kNT = kDh / 8;     // 8-column tiles of a row of the output

// bytes of an R-row split tile: kDh / 32 column groups of R rows x 128 bytes
template <int R>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return R * kDh * 4;
}

// Every shared-memory address below is the block's 1024-aligned base (a
// 32-bit shared address) plus a constant. The base passes through opaque()
// once a tile, so that the compiler derives the addresses (and wgmma
// descriptors) there and does not hold ~100 of them in registers across
// the loop.
__device__ __forceinline__ void opaque(uint32_t& x) { asm volatile("" : "+r"(x)); }

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ float4 lds128(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t a, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3])
               : "memory");
}

__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// named barrier id among n threads: arrive (and go on), or wait for it
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes, zero when !valid (src-size 0: nothing is read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the four floats x of chunk c (columns 4 c .. 4 c + 3) of row r split into
// the R-row hi tile at shared address hi and lo tile at lo
template <int R>
__device__ __forceinline__ void put_split(uint32_t hi, uint32_t lo, int r, int c, float4 x) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  sts128(hi + swz<R>(r, c), h);
  sts128(lo + swz<R>(r, c), l);
}

// rows r0 .. r0 + R - 1 of one (b, h) slice (row stride st floats) split
// into hi and lo tiles by TH threads (tid = 0 .. TH - 1); rows at or past T
// zero. A warp covers a row.
template <int R, int TH>
__device__ __forceinline__ void load_split(uint32_t hi, uint32_t lo, const float* src,
                                           int64_t st, int r0, int Tn, int tid) {
  constexpr int CH = kDh / 4;
#pragma unroll
  for (int j = 0; j < R * CH / TH; ++j) {
    const int i = tid + j * TH, r = i / CH, c = i % CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < Tn) x = *reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * st + 4 * c);
    put_split<R>(hi, lo, r, c, x);
  }
}

// rows r0 .. r0 + R - 1 into the landing stage at shared address dst by
// cp.async, by the block's TH threads; rows at or past T zero-filled
template <int R, int TH>
__device__ __forceinline__ void land(uint32_t dst, const float* src, int64_t st, int r0,
                                     int Tn) {
  constexpr int CH = kDh / 4;
#pragma unroll
  for (int j = 0; j < R * CH / TH; ++j) {
    const int i = threadIdx.x + j * TH, r = i / CH, c = i % CH;
    const bool ok = r0 + r < Tn;
    cp_async16(dst + 4 * (r * kLand + 4 * c), src + (int64_t)(ok ? r0 + r : 0) * st + 4 * c, ok);
  }
}

// kpos(r): the k position of streamed row r (r < 32) in the transposed
// tiles. The output products take P (or dS) from the score accumulator as
// their register A operand, whose k index t holds key 2 t and t + 4 key 2 t
// + 1 of each 8-key step (fragments below), so B's k positions follow the
// same order.
__device__ __forceinline__ int kpos(int r) { return (r & ~7) + ((r & 7) >> 1) + 4 * (r & 1); }

// The landed kKeys-row tile at raw split into hi and lo tiles (lo right
// after hi) for the score products and, with TRANS, also into transposed hi
// and lo tiles at thi (kDh rows of kKeys floats, K-major over the permuted
// streamed rows) for the output products. Lane = streamed row; the block's
// warps take the 16-byte column chunks in turn. No bank conflicts: a
// quarter-warp's 16-byte stores hit eight rows of one chunk, a warp's
// transposed 4-byte stores one 128-byte row.
template <bool TRANS>
__device__ __forceinline__ void split_tile(uint32_t hi, uint32_t thi, uint32_t raw) {
  constexpr int R = kKeys, CH = kDh / 4, WARPS = 2 * kWG / 32;
  static_assert(R == 32, "a lane a row");
  const int r = threadIdx.x % 32, kp = kpos(r);
#pragma unroll
  for (int j = 0; j < CH / WARPS; ++j) {
    const int c = threadIdx.x / 32 + WARPS * j;
    const float4 x = lds128(raw + 4 * (r * kLand + 4 * c));
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    sts128(hi + swz<R>(r, c), h);
    sts128(hi + tile_bytes<R>() + swz<R>(r, c), l);
    if constexpr (TRANS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t at = thi + swz<kDh>(4 * c + i, kp >> 2) + 4 * (kp & 3);
        sts32(at, h[i]);
        sts32(at + tile_bytes<R>(), l[i]);
      }
    }
  }
}

// the wgmma descriptor of k step kk of the R-row tile at byte offset off
// from the base whose descriptor is d0 (flash_sm90.cuh's desc_k, as an add)
template <int R>
__device__ __forceinline__ uint64_t kdesc(uint64_t d0, uint32_t off, int kk) {
  return d0 + ((off + (kk >> 2) * (R * kRowBytes) + (kk & 3) * 32) >> 4);
}

// d (64 x kKeys) = A B^T over the kDh columns from zero: per 8-column k
// step the three TF32 products lo hi, hi lo, hi hi. A's hi terms come from
// registers (ah[kk]: this lane's m16n8k8 A fragment of k step kk, rows 16 w
// + g and + 8 of the warpgroup's warp w), its lo tile from the 64-row tile
// at offset al; B is the streamed hi tile at offset b (lo after it); d0 is
// the base's descriptor
__device__ __forceinline__ void score_chain(float (&d)[kKeys / 2], uint64_t d0,
                                            const uint32_t (&ah)[kDh / 8][4], uint32_t al,
                                            uint32_t b) {
  constexpr uint32_t bl = tile_bytes<kKeys>();
#pragma unroll
  for (int kk = 0; kk < kDh / 8; ++kk) {
    WgTf32<kKeys>::ss(d, kdesc<kRows>(d0, al, kk), kdesc<kKeys>(d0, b, kk), kk > 0);
    WgTf32<kKeys>::rs(d, ah[kk], kdesc<kKeys>(d0, b + bl, kk), 1);
    WgTf32<kKeys>::rs(d, ah[kk], kdesc<kKeys>(d0, b, kk), 1);
  }
}

// P's (or dS's) A fragments from the accumulator values f: key step kk
// covers keys 8 kk .. 8 kk + 7, its k index t being key 2 t and t + 4 key
// 2 t + 1 (the transposed tiles hold their k positions in that order)
__device__ __forceinline__ void fragments(const float (&f)[kKeys / 2], uint32_t (&hi)[kNK][4],
                                          uint32_t (&lo)[kNK][4]) {
#pragma unroll
  for (int kk = 0; kk < kNK; ++kk) {
    split_tf32(f[4 * kk + 0], hi[kk][0], lo[kk][0]);  // row g, key 2 t
    split_tf32(f[4 * kk + 2], hi[kk][1], lo[kk][1]);  // row g + 8, key 2 t
    split_tf32(f[4 * kk + 1], hi[kk][2], lo[kk][2]);  // row g, key 2 t + 1
    split_tf32(f[4 * kk + 3], hi[kk][3], lo[kk][3]);  // row g + 8, key 2 t + 1
  }
}

// acc[C0 + n] += mul * (F X) over 64 output columns: F (64 x kKeys) from
// its fragments (fh, fl), X's columns the 64 rows of the transposed hi tile
// from offset x (its lo tile tile_bytes<kKeys>() after the hi one), in three
// TF32 products a k step from a zero accumulator, added to acc in float32
template <int C0, int NT>
__device__ __forceinline__ void out_product(float (&acc)[NT][4], uint64_t d0,
                                            const uint32_t (&fh)[kNK][4],
                                            const uint32_t (&fl)[kNK][4], uint32_t x, float mul) {
  constexpr uint32_t xl = tile_bytes<kKeys>();
  float d[32];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kNK; ++kk) {
    WgTf32<64>::rs(d, fl[kk], kdesc<kDh>(d0, x, kk), kk > 0);
    WgTf32<64>::rs(d, fh[kk], kdesc<kDh>(d0, x + xl, kk), 1);
    WgTf32<64>::rs(d, fh[kk], kdesc<kDh>(d0, x, kk), 1);
  }
  wg_commit();
  wg_wait<0>();
  pin(d);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[C0 + n][e] = acc[C0 + n][e] + mul * d[4 * n + e];
}

// rows row0 (values e = 0, 1) and row0 + 8 (e = 2, 3) of a warp's (16, 8 NT)
// sum acc[A0 ..] into columns c0 .. c0 + 8 NT - 1 of a contiguous (B, T, H,
// kDh) output
template <int NT, int A0, int NA>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[NA][4], int b, int h,
                                           int H, int Tn, int row0, int c0, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= Tn) continue;
    float* dst = out + (((int64_t)b * Tn + row) * H + h) * kDh + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(acc[A0 + n][2 * half], acc[A0 + n][2 * half + 1]);
  }
}

// dq's hand-over between its roles: f holds p (role 0) or dp - delta (role
// 1) of this lane's accumulator entries, the same entries in both roles;
// each writes its values to its slot (p at pslot, dp - delta at dslot,
// lane-major), both meet, and each forms ds = p (dp - delta) into f from its
// own and the other's values: the same product of the same two floats, so
// both roles hold the same bits. (p handed one way and ds back took dq 3%
// longer.)
template <int M>
__device__ __forceinline__ void exchange_ds(float (&f)[M], uint32_t pslot, uint32_t dslot,
                                            int role, int tid) {
  const uint32_t mine = (role ? dslot : pslot) + 4 * tid, other = (role ? pslot : dslot) + 4 * tid;
#pragma unroll
  for (int j = 0; j < M; ++j) sts32(mine + 4 * kWG * j, __float_as_uint(f[j]));
  bar_sync(1, 2 * kWG);
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float o = __uint_as_float(lds32(other + 4 * kWG * j));
    f[j] = role ? o * f[j] : f[j] * o;
  }
}

// The block's resident tensors (q and dO in dq, k and v in dk/dv), one a
// warpgroup, whose hi terms each lane keeps in registers: their 64 rows
// split, the lo tile to lo, the hi tile to the shared address hi (a stage
// the streamed tiles take over once it is read), then this lane's A
// fragments of it, rows 16 warp + g (+ 8), columns 8 kk + t (+ 4). Ends
// with every thread past the read.
__device__ __forceinline__ void load_resident(uint32_t (&ah)[kDh / 8][4], uint32_t hi,
                                              uint32_t lo, const float* src, int64_t st, int r0,
                                              int Tn, int tid) {
  load_split<kRows, kWG>(hi, lo, src, st, r0, Tn, tid);
  __syncthreads();
  const int warp = tid / 32, g = (tid % 32) / 4, t = tid % 4;
#pragma unroll
  for (int kk = 0; kk < kDh / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * warp + g + 8 * (i & 1), col = 8 * kk + t + 4 * (i >> 1);
      ah[kk][i] = lds32(hi + swz<kRows>(r, col >> 2) + 4 * (col & 3));
    }
  __syncthreads();
}

// A block's shared memory, byte offsets from its 1024-aligned base: the
// resident lo tiles of the two tensors a warpgroup each holds (64 rows: q
// and dO in dq, k and v in dk/dv); the streamed hi and lo tiles of the two
// others (kKeys rows: k and v; q and dO; at the start they hold the
// resident tensors' hi tiles); the transposed hi and lo tiles the output
// products read (k's in dq; q's and dO's in dk/dv); the landing stage of
// the streamed tiles; in dq the hand-over of p and of dp - delta between the
// warpgroups, 64 x kKeys floats each (dk/dv hands p over in the landing
// stage, between the split and the next tile's copies)
template <bool DKV>
struct Smem {
  static constexpr uint32_t kLo0 = 0, kLo1 = tile_bytes<kRows>();
  static constexpr uint32_t kB0 = 2 * tile_bytes<kRows>(), kB1 = kB0 + 2 * tile_bytes<kKeys>();
  static constexpr uint32_t kT0 = kB0 + 4 * tile_bytes<kKeys>(), kT1 = kT0 + 2 * tile_bytes<kKeys>();
  static constexpr uint32_t kLand0 = DKV ? kT1 + 2 * tile_bytes<kKeys>() : kT1;
  static constexpr uint32_t kLand1 = kLand0 + kKeys * kLand * 4;
  static constexpr uint32_t kP = DKV ? kLand0 : kLand1 + kKeys * kLand * 4;
  static constexpr uint32_t kDs = kP + kRows * kKeys * 4;
  static constexpr int kBytes = (DKV ? kLand1 + kKeys * kLand * 4 : kDs + kRows * kKeys * 4) +
                                1024;  // + the alignment's slack
  static_assert(4 * tile_bytes<kKeys>() >= 2 * tile_bytes<kRows>(), "room for the hi tiles");
  static_assert(!DKV || kRows * kKeys <= 2 * kKeys * kLand, "p's hand-over fits the landing");
};

// One block per (bh, 64 q rows): dq (B, T, H, kDh) contiguous. dout is
// contiguous; lse and delta are (B*H, T). k and v stream in kKeys-row tiles.
// Two warpgroups: role 0 holds q's hi terms in registers and sums S = Q
// K^T and p, role 1 holds dO's and sums dP = dO V^T and dp - delta; the
// roles trade those (exchange_ds), both form ds, and each then adds scale
// (dS K) over its half of the output columns.
__global__ void __launch_bounds__(2 * kWG, 1)
flash_dq_f32wg_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dq, int H, int Tn, int64_t sb, int64_t st, int64_t sh,
                      float scale, int causal) {
  constexpr int N = kKeys, TH = 2 * kWG;
  using S = Smem<false>;
  extern __shared__ uint8_t smem[];
  uint32_t sm = smem_addr(align1024(smem));
  const int role = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nt = (Tn + kRows - 1) / kRows;
  // the q tiles of one (b, h) in a row, its longest causal rows first
  const int bh = (int)blockIdx.x / nt, b = bh / H, h = bh % H;
  const int q0 = (nt - 1 - (int)blockIdx.x % nt) * kRows;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  const int64_t doff = ((int64_t)b * Tn * H + h) * kDh;
  const float *kg = k + off, *vg = v + off;
  const int ntk = (Tn + N - 1) / N;
  // causal: no k tile past the block's last row
  const int nk = causal ? min((q0 + kRows) / N, ntk) : ntk;
  auto land_kv = [&](int i) {
    land<N, TH>(sm + S::kLand0, kg, st, i * N, Tn);
    land<N, TH>(sm + S::kLand1, vg, st, i * N, Tn);
    cp_async_commit();
  };
  auto split_kv = [&]() {
    split_tile<true>(sm + S::kB0, sm + S::kT0, sm + S::kLand0);
    split_tile<false>(sm + S::kB1, 0, sm + S::kLand1);
    fence_async();  // the split tiles, written by the threads, visible to wgmma
  };
  land_kv(0);
  const uint32_t a_lo = role ? S::kLo1 : S::kLo0;
  uint32_t ah[kDh / 8][4];
  load_resident(ah, sm + S::kB0 + role * tile_bytes<kRows>(), sm + a_lo,
                role ? dout + doff : q + off, role ? (int64_t)H * kDh : st, q0, Tn, tid);
  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  // lse (role 0) or delta (role 1) of this thread's rows
  const float* rows = (role ? delta : lse) + (int64_t)bh * Tn;
  const float rv[2] = {row0 < Tn ? rows[row0] : 0.f, row0 + 8 < Tn ? rows[row0 + 8] : 0.f};
  float acc[8][4];  // dq's columns 64 role .. 64 role + 63
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  cp_async_wait_all();
  __syncthreads();  // tile 0 has landed everywhere
  split_kv();
  __syncthreads();  // the split tiles are in, and the landing stage is free
  if (nk > 1) land_kv(1);

  float s[N / 2];  // S or dP (the first product starts it)
  for (int i = 0; i < nk; ++i) {
    const int k0 = i * N;
    opaque(sm);
    const uint64_t d0 = desc(sm, 16, 1024);
    wg_fence();
    score_chain(s, d0, ah, a_lo, role ? S::kB1 : S::kB0);  // S = Q K^T, dP = dO V^T
    wg_commit();
    wg_wait<0>();
    pin(s);
    // role 0: p = exp(scale s - lse), masked entries 0; role 1: dp - delta;
    // each hands its values to the other, and both form ds = p (dp - delta)
    float f[N / 2];
    if (role == 0) {
      const bool edge = k0 + N > Tn || (causal && k0 + N - 1 > q0);
#pragma unroll
      for (int j = 0; j < kNK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
          float x = scale * s[4 * j + e];
          if (edge && (col >= Tn || (causal && col > row))) x = kNegInf;
          f[4 * j + e] = expf(x - rv[e >> 1]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < N / 2; ++j) f[j] = s[j] - rv[(j >> 1) & 1];
    }
    exchange_ds(f, sm + S::kP, sm + S::kDs, role, tid);
    uint32_t fh[kNK][4], fl[kNK][4];
    fragments(f, fh, fl);
    // dq += scale (dS K) over this role's 64 columns: rows 64 role .. of K^T
    out_product<0>(acc, d0, fh, fl, S::kT0 + 64 * role * kRowBytes, scale);
    if (i + 1 < nk) {
      cp_async_wait_all();
      __syncthreads();  // tile i + 1 has landed everywhere, and every warp is done with tile i
      split_kv();
      __syncthreads();
      if (i + 2 < nk) land_kv(i + 2);
    }
  }
  store_rows<8, 0>(dq, acc, b, h, H, Tn, row0, 64 * role, t);
}

// One block per (bh, 64 key rows): dk and dv (B, T, H, kDh) contiguous.
// dout is contiguous; lse and delta are (B*H, T). q and dO stream in
// kKeys-row tiles. Two warpgroups: role 0 holds k's hi terms in registers
// and sums S^T = K Q^T, p and dv += P^T dO; role 1 holds v's and sums dP^T =
// V dO^T, takes p from role 0 (the lane of the same accumulator entry) and
// sums dk += scale (dS^T Q). Each output product runs as two of 64 columns.
__global__ void __launch_bounds__(2 * kWG, 1)
flash_dkv_f32wg_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int H, int Tn, int64_t sb,
                       int64_t st, int64_t sh, float scale, int causal) {
  constexpr int N = kKeys, TH = 2 * kWG;
  using S = Smem<true>;
  extern __shared__ uint8_t smem[];
  uint32_t sm = smem_addr(align1024(smem));
  const int role = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nt = (Tn + kRows - 1) / kRows;
  // the key tiles of one (b, h) in a row, the keys the most causal rows see first
  const int bh = (int)blockIdx.x / nt, b = bh / H, h = bh % H;
  const int k0 = ((int)blockIdx.x % nt) * kRows;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh;
  const int64_t doff = ((int64_t)b * Tn * H + h) * kDh;
  const float *qg = q + off, *og = dout + doff;
  const float* rows = (role ? delta : lse) + (int64_t)bh * Tn;  // lse (role 0), delta (role 1)
  const int ntq = (Tn + N - 1) / N;
  // causal: no row of an earlier q tile sees these keys
  const int first = causal ? k0 / N : 0;
  auto land_qo = [&](int j) {
    land<N, TH>(sm + S::kLand0, qg, st, j * N, Tn);
    land<N, TH>(sm + S::kLand1, og, (int64_t)H * kDh, j * N, Tn);
    cp_async_commit();
  };
  auto split_qo = [&]() {
    split_tile<true>(sm + S::kB0, sm + S::kT0, sm + S::kLand0);
    split_tile<true>(sm + S::kB1, sm + S::kT1, sm + S::kLand1);
    fence_async();
  };
  land_qo(first);
  // k (role 0) or v (role 1): hi terms in registers, lo resident
  const uint32_t a_lo = role ? S::kLo1 : S::kLo0;
  uint32_t ah[kDh / 8][4];
  load_resident(ah, sm + S::kB0 + role * tile_bytes<kRows>(), sm + a_lo, (role ? v : k) + off,
                st, k0, Tn, tid);
  const int row0 = k0 + 16 * warp + g;  // this thread's keys: row0 and row0 + 8
  float acc[kNT][4];  // dv (role 0) or dk (role 1)
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  cp_async_wait_all();
  __syncthreads();  // q tile `first` has landed
  split_qo();
  __syncthreads();

  float s[N / 2];  // S^T or dP^T (the first product starts it)
  for (int j = first; j < ntq; ++j) {
    const int q0 = j * N;
    opaque(sm);
    const uint64_t d0 = desc(sm, 16, 1024);
    wg_fence();
    score_chain(s, d0, ah, a_lo, role ? S::kB1 : S::kB0);  // S^T = K Q^T, dP^T = V dO^T
    wg_commit();
    // lse or delta of this lane's queries (0 past T) while the products run
    float rv[kNK][2];
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = q0 + 8 * n + 2 * t + e;
        rv[n][e] = col < Tn ? rows[col] : 0.f;
      }
    wg_wait<0>();
    pin(s);
    // role 0: p = exp(scale s - lse), 0 where causal masks (key > query) and
    // past T, handed over; role 1: ds = p (dp - delta). (Both roles forming
    // ds from a two-way hand-over, each summing half of dv and of dk, ran
    // 2.5% slower here: 255 registers.)
    float f[N / 2];
    const uint32_t slot = sm + S::kP + 4 * tid;
    if (role == 0) {
#pragma unroll
      for (int n = 0; n < kNK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = q0 + 8 * n + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
          float x = scale * s[4 * n + e];
          if (causal && row > col) x = kNegInf;
          f[4 * n + e] = col < Tn ? expf(x - rv[n][e & 1]) : 0.f;
          sts32(slot + 4 * kWG * (4 * n + e), __float_as_uint(f[4 * n + e]));
        }
      bar_arrive(1, TH);
    } else {
      bar_sync(1, TH);
#pragma unroll
      for (int n = 0; n < kNK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f[4 * n + e] = __uint_as_float(lds32(slot + 4 * kWG * (4 * n + e))) *
                         (s[4 * n + e] - rv[n][e & 1]);
    }
    __syncthreads();  // p is read: the landing stage takes the next tile
    if (j + 1 < ntq) land_qo(j + 1);
    uint32_t fh[kNK][4], fl[kNK][4];
    fragments(f, fh, fl);
    // dv += P^T dO (role 0), dk += scale (dS^T Q) (role 1), 64 columns at a time
    const uint32_t x = role ? S::kT0 : S::kT1;
    const float mul = role ? scale : 1.f;
    out_product<0>(acc, d0, fh, fl, x, mul);
    out_product<8>(acc, d0, fh, fl, x + 64 * kRowBytes, mul);
    if (j + 1 < ntq) {
      cp_async_wait_all();
      __syncthreads();  // q tile j + 1 has landed, and both roles are done with tile j
      split_qo();
      __syncthreads();
    }
  }
  store_rows<kNT, 0>(role ? dk : dv, acc, b, h, H, Tn, row0, 0, t);
}

bool args_ok(int B, int H, int T, int Dh, int is_bf16) {
  return !is_bf16 && Dh == kDh && B > 0 && H > 0 && T > 0 &&
         (int64_t)B * H * ((T + kRows - 1) / kRows) <= 0x7fffffffLL;
}

// one block per (bh, 64-row tile), the tiles of one bh consecutive
dim3 grid(int B, int H, int T) { return dim3((unsigned)(B * H * ((T + kRows - 1) / kRows))); }

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// dq (B, T, H, 128) contiguous from q, k, v (B, T, H, 128) float32 sharing
// the element strides (sb, st, sh), Dh contiguous, 16-byte aligned rows;
// dout (B, T, H, 128) contiguous; the forward's lse and delta = rowsum(dO *
// O), both (B*H, T) float32. Takes Dh 128 with is_bf16 = 0 only. Returns
// the cudaError_t of the launch.
extern "C" int fedml_flash_dq_f32wg_sm90(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse,
                                         const float* delta, void* dq, int B, int H, int T,
                                         int Dh, int is_bf16, int causal, long long sb,
                                         long long st, long long sh, float scale,
                                         void* stream) {
  if (!args_ok(B, H, T, Dh, is_bf16)) return (int)cudaErrorInvalidValue;
  constexpr int bytes = Smem<false>::kBytes;
  cudaError_t e = prepare(flash_dq_f32wg_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  flash_dq_f32wg_kernel<<<grid(B, H, T), 2 * kWG, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dq, H, T, sb, st, sh, scale, causal);
  return (int)cudaGetLastError();
}


// dk and dv (B, T, H, 128) contiguous, from the same inputs as dq. Takes Dh
// 128 with is_bf16 = 0 only.
extern "C" int fedml_flash_dkv_f32wg_sm90(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse,
                                          const float* delta, void* dk, void* dv, int B, int H,
                                          int T, int Dh, int is_bf16, int causal, long long sb,
                                          long long st, long long sh, float scale,
                                          void* stream) {
  if (!args_ok(B, H, T, Dh, is_bf16)) return (int)cudaErrorInvalidValue;
  constexpr int bytes = Smem<true>::kBytes;
  cudaError_t e = prepare(flash_dkv_f32wg_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  flash_dkv_f32wg_kernel<<<grid(B, H, T), 2 * kWG, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse, delta,
      (float*)dk, (float*)dv, H, T, sb, st, sh, scale, causal);
  return (int)cudaGetLastError();
}
