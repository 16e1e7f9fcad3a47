// Flash attention's backward (dq; dk and dv) for float32 inputs at Dh 128
// and 512, dq at Dh 384 and the forward at Dh 512, on the Hopper tensor
// cores, exact to float32 through three TF32 products (3xTF32, tf32x3.cuh),
// every product on TF32 wgmma; at Dh 384 and 512 as a cluster of three or
// four blocks (below). The float32 forward at the other head dims, dk/dv at
// Dh 384 and every other float32 head dim are flash_f32_sm90.cu's and
// flash_wide_f32_sm90.cu's (Dh 64: flash_attention.cu's FMA kernels).
//
// Replaces: fedml_tpu/ops/pallas/flash_attention.py — _dq_kernel (:167,
// pallas_call :287) and _dkv_kernel (:213, pallas_call :299), both reached
// from _flash_backward (:265), on float32 inputs at Dh 128, 384 (dq) and
// 512; and _flash_kernel (:66, the forward of _flash_forward :129,
// pallas_call :140) on float32 inputs at Dh 512 (the forward's own section
// below: its arithmetic is the JAX kernel's, as flash_wide_f32_sm90.cu's
// header states it, with 32-key tiles). The TPU kernels
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
//
// Dh 512: the cluster. One (64, 512) float32 tile split into hi and lo is
// 256 KB, more than a block's 227 KB of shared memory, and a block must hold
// two such tensors (q and dO; k and v). So a (b, h, 64-row tile) is a
// thread-block cluster of P = 4 blocks on four SMs (the kernels' template
// parameter P; P = 1 is the Dh-128 block above), and cluster rank c owns the
// 128 columns 128 c .. 128 c + 127: it is the Dh-128 block on that slice of
// q, k, v and dO, and it sums that slice of dq, dk and dv. Its score products
// give the partial scores of its slice (S and dP in dq, S^T and dP^T in
// dk/dv), each 128-column part from zero. Once a streamed tile the cluster
// adds the four parts in rank order, ((part 0 + part 1) + part 2) + part 3,
// through distributed shared memory (the exchange, below): a reduce-scatter
// to the rows' owner, which forms ds (dq) or p and ds (dk/dv) from the sums,
// and a gather of those to every block. So all four blocks hold the same
// bits of p and ds, every score is computed once, and every byte of q, k, v
// and dO is fetched once a cluster. Rows at or past T are zero-filled and
// masked in every block alike. The launch asks for clusters of four along x
// (grid 4 B H ceil(T / 64)); a cluster that finds no four free SMs is an
// error (cudaErrorClusterOutOfResources), never a fallback. Shared memory:
// dq 226 KB (the exchange takes the hand-over's 16 KB and 16 KB more), dk/dv
// 226 KB (the exchange lives in the landing stage, between the split and the
// next tile's copies). On the H100 (PERF.md; tc_rate.cu's cluster probe): one
// barrier.cluster costs ~0.6 us and a block reads its peers' shared memory at
// ~25-35 GB/s, so the first form (each block pulling its three peers' 16 KB
// between two cluster barriers, 3.1 us a tile) took dq 59.7 ms and dk/dv 71.5
// at the shape below; the mbarrier reduce-scatter and gather takes ~1.2 us
// (dq) and ~1.4 us (dk/dv) a tile: dq 39.8 ms, dk/dv 57.6. dq then overlaps
// its exchange with the next tile's score products (split its score tiles,
// issue the products, and only then wait for ds): 36.0 ms, at 255 registers
// with 52 bytes of spills (13 loop-invariant words, reloaded in the tile-end
// split); unpipelined it held 223 registers and spilled nothing. dk/dv
// (254 registers, no spill) cannot overlap: its exchange fills the landing
// stage, so the next tile lands only after it.
//
// Bound on the H100 at the float32 XXL LM's shape (B 8, T 4224, H 8, Dh 512,
// causal): 571,084,800 unmasked pairs x 1,024 operations = 0.5848 TFLOP a
// product; as three TF32 products at 495 TFLOP/s dq takes 10.63 ms and dk/dv
// 14.18 ms.
//
// Dh 384, dq only: the cluster of three (P = 3), the same blocks on three
// 128-column slices. Three ranks cannot each own one 16-row warp's rows, so
// ownership goes by 8-key step (the exchange below): rank r owns step r of
// every warp, and step 3's eight row halves are spread 3 / 3 / 2 over the
// ranks; every warp of a block sums its share, and the parts' sum keeps
// rank order, (part 0 + part 1) + part 2. The streamed tiles stay 32 keys,
// as at P = 1 and 4 (PERF.md says what 24-key tiles, built first, did and
// did not show). Shared memory: 231,960 of the 232,448 bytes (the parts of
// the largest owner, 16.5 KB, where P = 4's 16 KB sit). The exchange hides
// behind the next tile's score products, and step 3's extra owner half is
// what it costs; an owner loop kept rolled holds the spills to 84 bytes.
// dk/dv at P = 3 ran slower than flash_f32_sm90.cu's Dh-384 kernel (its
// exchange fills the landing stage, so it cannot overlap the next tile's
// landing) and was taken out; the entry refuses Dh 384.
//
// Bound on the H100 at the float32 XL LM's shape (B 8, T 4352, H 8, Dh 384,
// causal): 606,216,192 unmasked pairs x 768 operations = 0.4656 TFLOP a
// product; as three TF32 products dq takes 8.465 ms.
//
// The forward at Dh 512: a cluster of four blocks per (b, h, 128 q rows),
// block c on columns 128 c ..; each warpgroup holds 64 of the rows' q hi
// terms in registers and sums their S over the block's 128 columns; the
// rows' owner block adds the four parts in rank order, takes the
// online-softmax step and gathers p, corr and l to all four, which add P V
// over their columns (the forward's section below). Bound at the XXL
// shape: its two products as three TF32 products, 7.088 ms. On the H100
// there (PERF.md): 20.8 ms, against 33.3 for flash_wide_f32_sm90.cu's
// mma.sync kernel and 29.9 for SDPA's forward; 250 registers, no spill,
// 223,248 bytes of shared memory, 30 clusters resident.

#include "flash_sm90.cuh"
#include "tf32x3.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int kDh = 128;         // head dim of a block (in a cluster its slice of the columns)
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
// after hi) for the score products (KMAJOR) and, with TRANS, into transposed
// hi and lo tiles at thi (kDh rows of kKeys floats, K-major over the
// permuted streamed rows) for the output products. Lane = streamed row; the
// block's warps take the 16-byte column chunks in turn. No bank conflicts: a
// quarter-warp's 16-byte stores hit eight rows of one chunk, a warp's
// transposed 4-byte stores one 128-byte row.
template <bool TRANS, bool KMAJOR = true>
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
    if constexpr (KMAJOR) {
      sts128(hi + swz<R>(r, c), h);
      sts128(hi + tile_bytes<R>() + swz<R>(r, c), l);
    }
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
// DH) output
template <int NT, int A0, int DH, int NA>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[NA][4], int b, int h,
                                           int H, int Tn, int row0, int c0, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    if (row >= Tn) continue;
    float* dst = out + (((int64_t)b * Tn + row) * H + h) * DH + c0 + 2 * t;
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

// --- the cluster (P > 1) --------------------------------------------------------
//
// The exchange of a streamed tile's partial scores is a reduce-scatter and a
// gather through distributed shared memory, signalled by mbarriers: warp w
// of each warpgroup (rows 16 w .. 16 w + 15) sends its partial tile to the
// block of rank w, their owner (st.async, its bytes counted on the owner's
// mbarrier `full_r`); the owner's two warps w add the four ranks' parts of
// S and dP (dq) or S^T and dP^T (dk/dv) in rank order, each over half of
// the tile's 8-key steps, form ds (dq) or p and ds (dk/dv) there, and send
// them to every block of the cluster (counted on each one's `full_g`);
// every warp then reads its rows' values. A block receives 16 KB of parts
// a tile (12 KB from its peers) and 8 KB (dq) or 16 KB (dk/dv) of values.
// Each mbarrier has one arrival a phase, its transaction bytes armed by one
// thread right after that thread has seen the phase before complete. A
// block sends tile i + 1's parts only after all of tile i's values have
// reached it, so no tile's bytes reach an mbarrier before its phase before
// has completed; and the owner formed those values from the parts it had
// read, so tile i + 1's parts never overwrite unread parts of tile i. The
// values are another matter: tile i + 1's values can come as soon as every
// block has sent tile i + 1's parts. dk/dv reads tile i's values before it
// sends those. dq's warps send them first (the next tile's products overlap
// the exchange), so dq keeps two values buffers, by tile parity: tile i +
// 2's values need parts that a warp sends only after it has used tile i's.
// In dk/dv the exchange lives in the landing stage, so a block sends its
// parts only once every owner has split its last landed tile (`ready`: P
// arrivals a tile, one from each block after its split).
//
// dq's cluster of three (Dh 384) has three ranks for four 16-row warps, so
// it owns by 8-key step instead: rank r owns step r of every warp's rows,
// and step 3's eight row halves (warp w, rows g + 8 hh) go to rank (2 w +
// hh) mod 3 (three, three and two of them). Warp w of each warpgroup sends
// chunk j < 3 of its partial tile to rank j and the two halves of chunk 3
// to their owners. In the owner every warp w of warpgroup `role` adds the
// three ranks' parts of S and dP for rows g + 8 role of chunk (w, r), and
// of chunk (w, 3) where it owns that half, in rank order (part 0 + part 1)
// + part 2, forms ds there and sends it to every block. A block receives
// 16.5 KB (ranks 0 and 1) or 15 KB (rank 2) of parts a tile and the same
// values as at P = 4.

// mbarrier at shared address bar: `count` arrivals a phase
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// this phase's arrival, with `bytes` more transaction bytes to come
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// an arrival at the mbarrier of another block (shared::cluster address)
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of the cluster meets (barrier.cluster, release / acquire):
// after the mbarriers' set-up and before a block leaves
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of shared address a in the block of rank r
__device__ __forceinline__ uint32_t peer(uint32_t a, uint32_t r) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(r));
  return d;
}

// 16 bytes into another block's shared memory (shared::cluster address a),
// counted on its mbarrier bar
__device__ __forceinline__ void st_async(uint32_t a, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(a),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// byte offset of 16-byte chunk j of `lane` in slot `slot` of an exchange
// buffer: a warp's NK chunks a lane (NK 4: 16 values), chunk-major, so that
// a warp's accesses are 512 contiguous bytes
template <int NK = 4>
__device__ __forceinline__ uint32_t xoff(int slot, int j, int lane) {
  return 16 * ((slot * NK + j) * 32 + lane);
}

// this thread's partial scores (tensor `tensor`: role 0's S or S^T, role 1's
// dP or dP^T) to the parts buffer of the block that owns its warp's rows,
// at slot (this block's rank, tensor)
__device__ __forceinline__ void send_parts(const float (&s)[kKeys / 2], uint32_t parts,
                                           uint32_t full_r, int rank, int tensor, int warp,
                                           int lane) {
  const uint32_t to = peer(parts + xoff(rank * 2 + tensor, 0, lane), warp);
  const uint32_t bar = peer(full_r, warp);
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j)
    st_async(to + xoff(0, j, 0), make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]),
             bar);
}

// the owner's sum of chunk j of `tensor` over the P ranks' parts, in rank
// order: ((part 0 + part 1) + part 2) + part 3
template <int P>
__device__ __forceinline__ float4 sum_parts(uint32_t parts, int tensor, int j, int lane) {
  float4 a = lds128(parts + xoff(tensor, j, lane));
#pragma unroll
  for (int r = 1; r < P; ++r) {
    const float4 b = lds128(parts + xoff(r * 2 + tensor, j, lane));
    a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
  }
  return a;
}

// the owner's chunk v to slot `slot` of the values buffer of every block
template <int P>
__device__ __forceinline__ void send_values(float4 v, uint32_t values, uint32_t full_g, int slot,
                                            int j, int lane) {
#pragma unroll
  for (int r = 0; r < P; ++r) st_async(peer(values + xoff(slot, j, lane), r), v, peer(full_g, r));
}

// --- the cluster of three: ownership by 8-key step ------------------------------

__device__ __forceinline__ float2 lds64(uint32_t a) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(a));
  return v;
}

// 8 bytes into another block's shared memory, counted on its mbarrier bar
__device__ __forceinline__ void st_async(uint32_t a, float2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          a),
      "f"(v.x), "f"(v.y), "r"(bar)
      : "memory");
}

// Its parts buffer: first steps r's chunks, slot (2 c + tensor) 4 + warp for
// rank c's part (512 bytes each, kStepBytes in all), then step 3's row halves
// that this rank owns, slot (2 c + tensor) 3 + m for its m-th half (256
// bytes each). Row half h = 2 w + hh has owner h % 3 and index m = h / 3.
constexpr uint32_t kStepBytes = 3 * 2 * 4 * 512;
constexpr uint32_t kHalfBytes = 3 * 2 * 3 * 256;

// the bytes of parts rank r receives a tile: its step and (10 - r) / 3 halves
__device__ __forceinline__ uint32_t parts_bytes3(int r) {
  return kStepBytes + (10 - r) / 3 * 3 * 2 * 256;
}

__device__ __forceinline__ uint32_t half_off(int src, int tensor, int m, int lane) {
  return kStepBytes + 8 * (((src * 2 + tensor) * 3 + m) * 32 + lane);
}

// this thread's partial scores (tensor `tensor`) to their owners: chunk j <
// 3 to rank j, the halves of chunk 3 to theirs
__device__ __forceinline__ void send_parts3(const float (&s)[16], uint32_t parts, uint32_t full_r,
                                            int rank, int tensor, int warp, int lane) {
  const uint32_t at = parts + xoff<1>((rank * 2 + tensor) * 4 + warp, 0, lane);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    st_async(peer(at, j), make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]),
             peer(full_r, j));
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = 2 * warp + hh, owner = h % 3;
    st_async(peer(parts + half_off(rank, tensor, h / 3, lane), owner),
             make_float2(s[12 + 2 * hh], s[13 + 2 * hh]), peer(full_r, owner));
  }
}

// the owner's sum of `tensor` over the three ranks' parts, in rank order
// (part 0 + part 1) + part 2: of rows g + 8 half of warp `warp`'s chunk of
// the rank's step (m < 0), or of its m-th half of step 3
__device__ __forceinline__ float2 sum_parts3(uint32_t parts, int tensor, int warp, int lane,
                                             int half, int m) {
  auto at = [&](int src) {
    return parts + (m < 0 ? xoff<1>((src * 2 + tensor) * 4 + warp, 0, lane) + 8 * half
                          : half_off(src, tensor, m, lane));
  };
  float2 a = lds64(at(0));
#pragma unroll
  for (int r = 1; r < 3; ++r) {
    const float2 b = lds64(at(r));
    a.x += b.x, a.y += b.y;
  }
  return a;
}

// the owner's half v (rows g + 8 half) of chunk j of slot `slot` to the
// values buffer of every block (a rolled loop: dq 1% faster, fewer registers)
__device__ __forceinline__ void send_half3(float2 v, uint32_t values, uint32_t full_g, int slot,
                                           int j, int lane, int half) {
  const uint32_t at = values + xoff(slot, j, lane) + 8 * half;
#pragma unroll 1
  for (int r = 0; r < 3; ++r) st_async(peer(at, r), v, peer(full_g, r));
}

// The cluster of three's owner work for this thread: values(j, s, d) forms
// and sends ds of rows g + 8 role at key step j from the summed scores s
// and dp d; once for the rank's step, once more for step 3 where the thread
// owns that half (three of the eight row halves in ranks 0 and 1, two in
// rank 2). The loop stays rolled: dq's pipelined loop then spills 84 bytes
// instead of 160 and runs 8% faster.
template <typename Values>
__device__ __forceinline__ void own3(uint32_t parts, int rank, int warp, int lane, int role,
                                     Values&& values) {
  const int h = 2 * warp + role;
#pragma unroll 1
  for (int i = 0; i < 2; ++i) {
    if (i == 1 && h % 3 != rank) break;
    const int m = i ? h / 3 : -1;
    values(i ? 3 : rank, sum_parts3(parts, 0, warp, lane, role, m),
           sum_parts3(parts, 1, warp, lane, role, m));
  }
}

// A block's shared memory, byte offsets from its 1024-aligned base: the
// resident lo tiles of the two tensors a warpgroup each holds (64 rows: q
// and dO in dq, k and v in dk/dv); the streamed hi and lo tiles of the two
// others (kKeys rows: k and v; q and dO; at the start they hold the
// resident tensors' hi tiles); the transposed hi and lo tiles the output
// products read (k's in dq; q's and dO's in dk/dv); the landing stage of
// the streamed tiles; in dq the hand-over of p and of dp - delta between the
// warpgroups, 64 x kKeys floats each (dk/dv hands p over in the landing
// stage, between the split and the next tile's copies). In a cluster (P >
// 1) the exchange instead: the parts (4 ranks x 2 tensors x 2 KB, or at P =
// 3 the largest rank's 16.5 KB: dq in the
// hand-over's place, dk/dv at the start of the landing stage), the values
// (ds in dq, two buffers of 8 KB by tile parity, after the hand-over's
// place; p and ds in dk/dv, 16 KB, in the landing stage after the parts),
// then the mbarriers full_r, full_g and (dk/dv) ready (in dk/dv after the
// landing stage, in the 1 KB that its 226 KB leave).
template <bool DKV, int P>
struct Smem {
  static constexpr uint32_t kLo0 = 0, kLo1 = tile_bytes<kRows>();
  static constexpr uint32_t kB0 = 2 * tile_bytes<kRows>(), kB1 = kB0 + 2 * tile_bytes<kKeys>();
  static constexpr uint32_t kT0 = kB0 + 4 * tile_bytes<kKeys>(), kT1 = kT0 + 2 * tile_bytes<kKeys>();
  static constexpr uint32_t kLand0 = DKV ? kT1 + 2 * tile_bytes<kKeys>() : kT1;
  static constexpr uint32_t kLand1 = kLand0 + kKeys * kLand * 4;
  static constexpr uint32_t kLandEnd = kLand1 + kKeys * kLand * 4;
  static constexpr uint32_t kSlot = kRows * kKeys * 4;  // one 64 x kKeys float tile
  static constexpr uint32_t kP = DKV ? kLand0 : kLandEnd;
  static constexpr uint32_t kDs = kP + kSlot;
  static constexpr uint32_t kParts = DKV ? kLand0 : kP;
  static constexpr uint32_t kPartsBytes = P == 3 ? kStepBytes + kHalfBytes : 2 * kSlot;
  static constexpr uint32_t kValuesBytes = DKV ? 2 * kSlot : kSlot;
  static constexpr uint32_t kValues = kParts + kPartsBytes;
  static constexpr uint32_t kValueBufs = DKV ? 1 : 2;  // dq's by tile parity (the exchange above)
  static constexpr uint32_t kFullR = DKV ? kLandEnd : kValues + kValueBufs * kValuesBytes;
  static constexpr uint32_t kFullG = kFullR + 8, kReady = kFullG + 8;
  static constexpr uint32_t kEnd = P > 1 ? kReady + 8 : (DKV ? kLandEnd : kDs + kSlot);
  static constexpr int kBytes = kEnd + 1024;  // + the alignment's slack
  static_assert(4 * tile_bytes<kKeys>() >= 2 * tile_bytes<kRows>(), "room for the hi tiles");
  static_assert(!DKV || kSlot <= 2 * kKeys * kLand * 4, "p's hand-over fits the landing stage");
  static_assert(!DKV || kValues + kValuesBytes <= kLandEnd, "the exchange fits the landing stage");
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// the bytes of parts this block receives a tile
template <int P>
__device__ __forceinline__ uint32_t parts_bytes() {
  return P == 3 ? parts_bytes3((int)cluster_rank()) : P * 2 * 2048;
}

// The mbarriers' set-up, then the cluster meets: no block sends before every
// block's mbarriers are armed
template <bool DKV, int P>
__device__ __forceinline__ void exchange_setup(uint32_t sm) {
  using S = Smem<DKV, P>;
  if (threadIdx.x == 0) {
    mbar_init(sm + S::kFullR, 1);
    mbar_init(sm + S::kFullG, 1);
    if (DKV) mbar_init(sm + S::kReady, P);
    mbar_expect(sm + S::kFullR, parts_bytes<P>());
    mbar_expect(sm + S::kFullG, S::kValuesBytes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
}

// One block per (bh, 64 q rows), or a cluster of P blocks, one per
// 128-column slice: dq (B, T, H, 128 P) contiguous. dout is contiguous; lse
// and delta are (B*H, T). k and v stream in kKeys-row tiles. Two
// warpgroups: role 0 holds q's hi terms in registers and sums S = Q K^T and
// p, role 1 holds dO's and sums dP = dO V^T and dp - delta; the roles trade
// those (exchange_ds), both form ds, and each then adds scale (dS K) over
// its half of the block's output columns. In a cluster each role sums its
// product over the block's slice, and the rows' owner block forms ds from
// the parts and sends it to all (the exchange above).
template <int P>
__global__ void __launch_bounds__(2 * kWG, 1)
flash_dq_f32wg_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dq, int H, int Tn, int64_t sb, int64_t st, int64_t sh,
                      float scale, int causal) {
  constexpr int N = kKeys, TH = 2 * kWG, DH = kDh * P;
  using S = Smem<false, P>;
  extern __shared__ uint8_t smem[];
  uint32_t sm = smem_addr(align1024(smem));
  const int role = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nt = (Tn + kRows - 1) / kRows;
  // the q tiles of one (b, h) in a row, its longest causal rows first; a
  // cluster's rank c owns columns 128 c ..
  const int tile = (int)blockIdx.x / P, c0 = P > 1 ? kDh * (int)cluster_rank() : 0;
  const int bh = tile / nt, b = bh / H, h = bh % H;
  const int q0 = (nt - 1 - tile % nt) * kRows;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh + c0;
  const int64_t doff = ((int64_t)b * Tn * H + h) * DH + c0;
  const float *kg = k + off, *vg = v + off;
  const int ntk = (Tn + N - 1) / N;
  if constexpr (P > 1) exchange_setup<false, P>(sm);
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
                role ? dout + doff : q + off, role ? (int64_t)H * DH : st, q0, Tn, tid);
  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  // lse (role 0) or delta (role 1) of this thread's rows
  const float* rows = (role ? delta : lse) + (int64_t)bh * Tn;
  const float rv[2] = {row0 < Tn ? rows[row0] : 0.f, row0 + 8 < Tn ? rows[row0 + 8] : 0.f};
  // in a cluster the owner warps need the other one too: lse (role 1), delta (role 0)
  const float* others = (role ? lse : delta) + (int64_t)bh * Tn;
  const float ov[2] = {P > 1 && row0 < Tn ? others[row0] : 0.f,
                       P > 1 && row0 + 8 < Tn ? others[row0 + 8] : 0.f};
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
  if constexpr (P == 1) {
    for (int i = 0; i < nk; ++i) {
      const int k0 = i * N;
      opaque(sm);
      const uint64_t d0 = desc(sm, 16, 1024);
      wg_fence();
      score_chain(s, d0, ah, a_lo, role ? S::kB1 : S::kB0);  // S = Q K^T, dP = dO V^T
      wg_commit();
      wg_wait<0>();
      pin(s);
      float f[N / 2];
      // role 0: p = exp(scale s - lse), masked entries 0; role 1: dp - delta;
      // each hands its values to the other, and both form ds = p (dp - delta)
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
  } else {
    // The cluster's loop, pipelined: the next tile's score products run
    // while this tile's exchange does. Per tile i: the owner warps form ds of
    // their rows from the four parts and send it to every block (values
    // buffer i % 2); the next tile's score tiles are split and its products
    // issued; ds arrives; once the products are done the next tile's parts go
    // out; then ds is read, dS K is added, the next tile's transposed k tile
    // is split, and the landing stage takes tile i + 2. The products issued
    // on the last tile (from its own score tiles again) are not used.
    const int rank = c0 / kDh;
    const float lr[2] = {role ? ov[0] : rv[0], role ? ov[1] : rv[1]};
    const float dr[2] = {role ? rv[0] : ov[0], role ? rv[1] : ov[1]};
    // at P = 3 every thread owns rows g + 8 role: their lse and delta
    const float lh = role ? lr[1] : lr[0], dh = role ? dr[1] : dr[0];
    uint64_t d0 = desc(sm, 16, 1024);
    auto send = [&]() {
      if constexpr (P == 3)
        send_parts3(s, sm + S::kParts, sm + S::kFullR, rank, role, warp, lane);
      else
        send_parts(s, sm + S::kParts, sm + S::kFullR, rank, role, warp, lane);
    };
    wg_fence();
    score_chain(s, d0, ah, a_lo, role ? S::kB1 : S::kB0);  // S = Q K^T, dP = dO V^T
    wg_commit();
    wg_wait<0>();
    pin(s);
    send();
    for (int i = 0; i < nk; ++i) {
      const int k0 = i * N, ph = i & 1;
      opaque(sm);
      const uint32_t vbuf = S::kValues + ph * S::kValuesBytes;  // this tile's values buffer
      if constexpr (P == 3) {
        // every warp: ds of rows g + 8 role of its chunk of this rank's step
        // (and of step 3 where it owns that half)
        mbar_wait(sm + S::kFullR, ph);
        if (threadIdx.x == 0) mbar_expect(sm + S::kFullR, parts_bytes<P>());
        const int row = row0 + 8 * role;
        own3(sm + S::kParts, rank, warp, lane, role, [&](int j, float2 sp, float2 dp) {
          const float sv[2] = {sp.x, sp.y}, dv[2] = {dp.x, dp.y};
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + 2 * t + e;
            float x = scale * sv[e];
            if (col >= Tn || (causal && col > row)) x = kNegInf;
            ds[e] = expf(x - lh) * (dv[e] - dh);
          }
          send_half3(make_float2(ds[0], ds[1]), sm + vbuf, sm + S::kFullG, warp, j, lane, role);
        });
      } else if (warp == rank) {
        // the owner's warps: ds = p (dp - delta), p = exp(scale s - lse)
        // (masked entries 0), for the 8-key steps 2 role and 2 role + 1
        mbar_wait(sm + S::kFullR, ph);
        if (role == 0 && lane == 0) mbar_expect(sm + S::kFullR, parts_bytes<P>());
        const bool edge = k0 + N > Tn || (causal && k0 + N - 1 > q0);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * role + jj;
          const float4 sp = sum_parts<P>(sm + S::kParts, 0, j, lane);
          const float4 dp = sum_parts<P>(sm + S::kParts, 1, j, lane);
          const float sv[4] = {sp.x, sp.y, sp.z, sp.w}, dv[4] = {dp.x, dp.y, dp.z, dp.w};
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * j + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
            float x = scale * sv[e];
            if (edge && (col >= Tn || (causal && col > row))) x = kNegInf;
            ds[e] = expf(x - lr[e >> 1]) * (dv[e] - dr[e >> 1]);
          }
          send_values<P>(make_float4(ds[0], ds[1], ds[2], ds[3]), sm + vbuf, sm + S::kFullG,
                         rank, j, lane);
        }
      }
      // the next tile's score tiles, and its products issued
      if (i + 1 < nk) {
        cp_async_wait_all();
        __syncthreads();  // tile i + 1 has landed everywhere
        split_tile<false>(sm + S::kB0, 0, sm + S::kLand0);
        split_tile<false>(sm + S::kB1, 0, sm + S::kLand1);
        fence_async();
        __syncthreads();
      }
      opaque(sm);  // the descriptors derived here, not held across the tile
      d0 = desc(sm, 16, 1024);
      wg_fence();
      score_chain(s, d0, ah, a_lo, role ? S::kB1 : S::kB0);
      wg_commit();
      // this tile's ds, from every owner, read once the products are done
      // and the next tile's parts are out (nothing else held beside them;
      // once those are out, tile i + 1's ds may come: hence two buffers)
      mbar_wait(sm + S::kFullG, ph);
      if (threadIdx.x == 0) mbar_expect(sm + S::kFullG, S::kValuesBytes);
      wg_wait<0>();
      pin(s);
      if (i + 1 < nk) send();
      float f[N / 2];
#pragma unroll
      for (int j = 0; j < kNK; ++j) {
        const float4 x = lds128(sm + vbuf + xoff(warp, j, lane));
        f[4 * j] = x.x, f[4 * j + 1] = x.y, f[4 * j + 2] = x.z, f[4 * j + 3] = x.w;
      }
      uint32_t fh[kNK][4], fl[kNK][4];
      fragments(f, fh, fl);
      // dq += scale (dS K) over this role's 64 columns
      opaque(sm);
      d0 = desc(sm, 16, 1024);
      out_product<0>(acc, d0, fh, fl, S::kT0 + 64 * role * kRowBytes, scale);
      if (i + 1 < nk) {
        __syncthreads();  // every warp is done with tile i's transposed k
        split_tile<true, false>(0, sm + S::kT0, sm + S::kLand0);
        fence_async();
        __syncthreads();  // the landing stage is free
        if (i + 2 < nk) land_kv(i + 2);
      }
    }
    cluster_sync();  // no block leaves while its peers may still send
  }
  store_rows<8, 0, DH>(dq, acc, b, h, H, Tn, row0, c0 + 64 * role, t);
}

// One block per (bh, 64 key rows), or a cluster of P blocks, one per
// 128-column slice: dk and dv (B, T, H, 128 P) contiguous. dout is
// contiguous; lse and delta are (B*H, T). q and dO stream in kKeys-row
// tiles. Two warpgroups: role 0 holds k's hi terms in registers and sums
// S^T = K Q^T, p and dv += P^T dO; role 1 holds v's and sums dP^T = V dO^T,
// takes p from role 0 (the lane of the same accumulator entry) and sums dk
// += scale (dS^T Q). Each output product runs as two of 64 columns. In a
// cluster each role sums its product over the block's slice, and the rows'
// owner block forms p and ds from the parts and sends both to all.
template <int P>
__global__ void __launch_bounds__(2 * kWG, 1)
flash_dkv_f32wg_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv, int H, int Tn, int64_t sb,
                       int64_t st, int64_t sh, float scale, int causal) {
  static_assert(P == 1 || P == 4, "dk/dv: one block, or a cluster of four at Dh 512");
  constexpr int N = kKeys, TH = 2 * kWG, DH = kDh * P;
  using S = Smem<true, P>;
  extern __shared__ uint8_t smem[];
  uint32_t sm = smem_addr(align1024(smem));
  const int role = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nt = (Tn + kRows - 1) / kRows;
  // the key tiles of one (b, h) in a row, the keys the most causal rows see
  // first; a cluster's rank c owns columns 128 c ..
  const int tile = (int)blockIdx.x / P, c0 = P > 1 ? kDh * (int)cluster_rank() : 0;
  const int bh = tile / nt, b = bh / H, h = bh % H;
  const int k0 = (tile % nt) * kRows;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh + c0;
  const int64_t doff = ((int64_t)b * Tn * H + h) * DH + c0;
  const float *qg = q + off, *og = dout + doff;
  const float* rows = (role ? delta : lse) + (int64_t)bh * Tn;  // lse (role 0), delta (role 1)
  const int ntq = (Tn + N - 1) / N;
  // causal: no row of an earlier q tile sees these keys
  const int first = causal ? k0 / N : 0;
  if constexpr (P > 1) exchange_setup<true, P>(sm);
  // in a cluster, this block's landing stage is free for the exchange: an
  // arrival at every block's `ready`
  auto landing_free = [&]() {
    if constexpr (P > 1)
      if (threadIdx.x == 0)
        for (int r = 0; r < P; ++r) mbar_arrive_peer(peer(sm + S::kReady, r));
  };
  auto land_qo = [&](int j) {
    land<N, TH>(sm + S::kLand0, qg, st, j * N, Tn);
    land<N, TH>(sm + S::kLand1, og, (int64_t)H * DH, j * N, Tn);
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
  landing_free();

  float s[N / 2];  // S^T or dP^T (the first product starts it)
  for (int j = first; j < ntq; ++j) {
    const int q0 = j * N;
    opaque(sm);
    const uint64_t d0 = desc(sm, 16, 1024);
    wg_fence();
    score_chain(s, d0, ah, a_lo, role ? S::kB1 : S::kB0);  // S^T = K Q^T, dP^T = V dO^T
    wg_commit();
    // lse or delta of this lane's queries (0 past T) while the products run;
    // in a cluster, the owner warps' lse and delta of their 8-key steps
    float rv[kNK][2];
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (P > 1) {  // rv[jj]: lse, rv[2 + jj]: delta of the step 2 role + jj
          const int col = q0 + 8 * (2 * role + (n & 1)) + 2 * t + e;
          const float* src = (n < 2 ? lse : delta) + (int64_t)bh * Tn;
          rv[n][e] = col < Tn ? src[col] : 0.f;
        } else {
          const int col = q0 + 8 * n + 2 * t + e;
          rv[n][e] = col < Tn ? rows[col] : 0.f;
        }
      }
    wg_wait<0>();
    pin(s);
    float f[N / 2];
    if constexpr (P > 1) {
      // the cluster's p (role 0) and ds (role 1): the parts to their owner;
      // the owner's warps form p = exp(scale s - lse) (0 where causal masks
      // and past T) and ds = p (dp - delta) for the 8-key steps 2 role and 2
      // role + 1 and send both to every block
      const int rank = c0 / kDh, ph = (j - first) & 1;
      mbar_wait(sm + S::kReady, ph);  // every owner's landing stage is free
      send_parts(s, sm + S::kParts, sm + S::kFullR, rank, role, warp, lane);
      if (warp == rank) {
        mbar_wait(sm + S::kFullR, ph);
        if (role == 0 && lane == 0) mbar_expect(sm + S::kFullR, parts_bytes<P>());
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int jt = 2 * role + jj;
          const float4 sp = sum_parts<P>(sm + S::kParts, 0, jt, lane);
          const float4 dp = sum_parts<P>(sm + S::kParts, 1, jt, lane);
          const float sv[4] = {sp.x, sp.y, sp.z, sp.w}, dv4[4] = {dp.x, dp.y, dp.z, dp.w};
          float pv[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = q0 + 8 * jt + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
            float x = scale * sv[e];
            if (causal && row > col) x = kNegInf;
            pv[e] = col < Tn ? expf(x - rv[jj][e & 1]) : 0.f;
            ds[e] = pv[e] * (dv4[e] - rv[2 + jj][e & 1]);
          }
          send_values<P>(make_float4(pv[0], pv[1], pv[2], pv[3]), sm + S::kValues,
                         sm + S::kFullG, rank, jt, lane);
          send_values<P>(make_float4(ds[0], ds[1], ds[2], ds[3]), sm + S::kValues,
                         sm + S::kFullG, 4 + rank, jt, lane);
        }
      }
      mbar_wait(sm + S::kFullG, ph);
      if (threadIdx.x == 0) mbar_expect(sm + S::kFullG, S::kValuesBytes);
#pragma unroll
      for (int n = 0; n < kNK; ++n) {
        const float4 x = lds128(sm + S::kValues + xoff(4 * role + warp, n, lane));
        f[4 * n] = x.x, f[4 * n + 1] = x.y, f[4 * n + 2] = x.z, f[4 * n + 3] = x.w;
      }
    } else {
      // role 0: p = exp(scale s - lse), 0 where causal masks (key > query) and
      // past T, handed over; role 1: ds = p (dp - delta). (Both roles forming
      // ds from a two-way hand-over, each summing half of dv and of dk, ran
      // 2.5% slower here: 255 registers.)
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
    }
    __syncthreads();  // p (or the exchange) is read: the landing stage takes the next tile
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
      landing_free();
    }
  }
  if constexpr (P > 1) cluster_sync();  // no block leaves while its peers may still send
  store_rows<kNT, 0, DH>(role ? dk : dv, acc, b, h, H, Tn, row0, c0, t);
}

// --- the forward at Dh 512: a cluster of four blocks ---------------------------
//
// 128 q rows a block, each warpgroup owning 64 of them over all of the
// block's 128 columns (columns 128 c .. of rank c). Warpgroup r keeps the
// hi terms of its q rows (64 r ..), scaled before the split, in registers
// (16 k steps, as dq's resident tensors) and sums S over the block's 128
// columns (m64n32k8, its q lo tile in shared memory). Warp w of each
// warpgroup sends its rows' part to rank w (send_parts: slot 2 rank + r),
// whose warp w of warpgroup r adds the four ranks' parts in rank order
// (sum_parts), masks and takes the online-softmax step for both of its
// lane's rows (new m, p = exp(s - m), corr, l = l corr + rowsum p), and
// sends p and (corr, l) to every block (counted on full_g), so all four
// blocks hold the same bits of p, corr and l. Every warpgroup then scales
// its rows' 128 output columns by corr and adds P V as two m64n64k8 halves,
// P from the values as register A fragments against v's transposed tile
// (keys in the fragment's order), from zero a tile. As in dq, the next
// tile's score products are issued before this tile's p arrives, and the
// values keep two buffers by tile parity; the mbarriers' rules are dq's.
// The owner writes lse = m + log l of its rows; every block divides its
// columns by l. A first form, 64 q rows a block with the warpgroups
// splitting each block's contraction (eight parts a row), ran no faster
// than flash_wide_f32_sm90.cu's kernel: a tile costs mostly what it costs
// whatever its rows (the k and v splits, four barriers, the exchange's
// round trip), so 128 rows a block halve the tiles (PERF.md).

constexpr int kFwdChunks = kNK + 1;  // values a lane: p's 8-key steps, then (corr, l)

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// acc[C0 + n] = acc[C0 + n] * corr + P X over 64 output columns: P (64 x
// kKeys) from its fragments (fh, fl), X's columns the 64 rows of the
// transposed hi tile at offset x (its lo tile after it), three TF32
// products a k step from a zero accumulator; corr0 is the lane's row g's,
// corr1 row g + 8's
template <int C0, int NT>
__device__ __forceinline__ void pv_product(float (&acc)[NT][4], uint64_t d0,
                                           const uint32_t (&fh)[kNK][4],
                                           const uint32_t (&fl)[kNK][4], uint32_t x, float corr0,
                                           float corr1) {
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
    for (int e = 0; e < 4; ++e)
      acc[C0 + n][e] = acc[C0 + n][e] * (e < 2 ? corr0 : corr1) + d[4 * n + e];
}

constexpr int kFwdRows = 2 * kRows;  // q rows of a block: 64 a warpgroup

// The block's shared memory, byte offsets from its 1024-aligned base: each
// warpgroup's q lo tile (64 rows); k's split hi and lo tiles and v's
// transposed ones (at the start the stages of the two q hi tiles); the
// landing stage of k and v; the parts (4 ranks x 2 warpgroups x 2 KB); the
// values (p and (corr, l) of 128 rows, two buffers by tile parity); the
// mbarriers full_r and full_g.
struct FwdSmem {
  static constexpr uint32_t kLo = 0, kK = 2 * tile_bytes<kRows>();
  static constexpr uint32_t kVT = kK + 2 * tile_bytes<kKeys>();
  static constexpr uint32_t kLand0 = kVT + 2 * tile_bytes<kKeys>();
  static constexpr uint32_t kLand1 = kLand0 + kKeys * kLand * 4;
  static constexpr uint32_t kParts = kLand1 + kKeys * kLand * 4;
  static constexpr uint32_t kPartsBytes = 4 * 2 * 16 * kKeys * 4;
  static constexpr uint32_t kValues = kParts + kPartsBytes;
  static constexpr uint32_t kValuesBytes = 8 * kFwdChunks * 32 * 16;
  static constexpr uint32_t kFullR = kValues + 2 * kValuesBytes, kFullG = kFullR + 8;
  static constexpr int kBytes = kFullG + 8 + 1024;  // + the alignment's slack
  static_assert(2 * tile_bytes<kKeys>() == tile_bytes<kRows>(), "a q hi tile fits k's place");
  static_assert(kBytes <= 232448, "a block's shared memory");
};

// A warpgroup's 64 q rows from r0 (row stride st floats), scaled before
// the split as the TPU kernel scales them (:93), into its lo tile at lo and
// its hi tile at hi (a stage the streamed tiles take over), then this
// lane's A fragments of all kDh columns: rows 16 warp + g (+ 8), columns 8
// kk + t (+ 4). Rows at or past T zero. Ends with every thread past the read.
__device__ __forceinline__ void load_q(uint32_t (&ah)[kDh / 8][4], uint32_t hi, uint32_t lo,
                                       const float* src, int64_t st, int r0, int Tn,
                                       float scale, int tid) {
  constexpr int CH = kDh / 4;
#pragma unroll
  for (int j = 0; j < kRows * CH / kWG; ++j) {
    const int i = tid + j * kWG, r = i / CH, c = i % CH;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < Tn) x = *reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * st + 4 * c);
    put_split<kRows>(hi, lo, r, c,
                     make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale));
  }
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

// A cluster of P = 4 blocks per (bh, 128 q rows), one per 128-column slice:
// o (B, T, H, 128 P) contiguous, lse (B*H, T). k and v stream in kKeys-row
// tiles.
template <int P>
__global__ void __launch_bounds__(2 * kWG, 1)
flash_fwd_f32wg_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int H, int Tn, int64_t sb, int64_t st,
                       int64_t sh, float scale, int causal) {
  static_assert(P == 4, "the forward: a cluster of four at Dh 512");
  constexpr int N = kKeys, TH = 2 * kWG, DH = kDh * P;
  using S = FwdSmem;
  extern __shared__ uint8_t smem[];
  uint32_t sm = smem_addr(align1024(smem));
  const int role = threadIdx.x / kWG, tid = threadIdx.x % kWG;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int nt = (Tn + kFwdRows - 1) / kFwdRows;
  // the q tiles of one (b, h) in a row, its longest causal rows first; rank
  // c owns columns 128 c ..
  const int tile = (int)blockIdx.x / P, rank = (int)cluster_rank(), c0 = kDh * rank;
  const int bh = tile / nt, b = bh / H, h = bh % H;
  const int q0 = (nt - 1 - tile % nt) * kFwdRows;
  const int64_t off = (int64_t)b * sb + (int64_t)h * sh + c0;
  const float *kg = k + off, *vg = v + off;
  const int ntk = (Tn + N - 1) / N;
  // causal: no k tile past the block's last row
  const int nk = causal ? min((q0 + kFwdRows) / N, ntk) : ntk;
  if (threadIdx.x == 0) {
    mbar_init(sm + S::kFullR, 1);
    mbar_init(sm + S::kFullG, 1);
    mbar_expect(sm + S::kFullR, S::kPartsBytes);
    mbar_expect(sm + S::kFullG, S::kValuesBytes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // no block sends before every block's mbarriers are armed
  auto land_kv = [&](int i) {
    land<N, TH>(sm + S::kLand0, kg, st, i * N, Tn);
    land<N, TH>(sm + S::kLand1, vg, st, i * N, Tn);
    cp_async_commit();
  };
  land_kv(0);
  const uint32_t a_lo = S::kLo + role * tile_bytes<kRows>();
  uint32_t ah[kDh / 8][4];
  load_q(ah, sm + S::kK + role * tile_bytes<kRows>(), sm + a_lo, q + off, st,
         q0 + kRows * role, Tn, scale, tid);
  const int row0 = q0 + kRows * role + 16 * warp + g;  // this thread's rows: row0 and row0 + 8
  float acc[kNT][4];  // o's columns c0 .., unnormalised
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  cp_async_wait_all();
  __syncthreads();  // tile 0 has landed everywhere
  split_tile<false>(sm + S::kK, 0, sm + S::kLand0);         // k: K-major
  split_tile<true, false>(0, sm + S::kVT, sm + S::kLand1);  // v: transposed
  fence_async();
  __syncthreads();  // the split tiles are in, and the landing stage is free
  if (nk > 1) land_kv(1);

  // The loop, pipelined as dq's: per tile i the owner warps take the
  // softmax step of their rows from the four parts and send p and (corr,
  // l) to every block (values buffer i % 2); the next tile's k is split and
  // its score products issued; the values arrive; once the products are
  // done the next tile's parts go out; then P V is added, the next tile's
  // v is split, and the landing stage takes tile i + 2. The products issued
  // on the last tile (from its own k again) are not used.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // the owner's, of rows g and g + 8
  float lg[2] = {0.f, 0.f};  // l of this thread's rows, as the owners sent it
  float s[N / 2];
  uint64_t d0 = desc(sm, 16, 1024);
  wg_fence();
  score_chain(s, d0, ah, a_lo, S::kK);  // S = Q K^T over the block's columns
  wg_commit();
  wg_wait<0>();
  pin(s);
  send_parts(s, sm + S::kParts, sm + S::kFullR, rank, role, warp, lane);
  for (int i = 0; i < nk; ++i) {
    const int k0 = i * N, ph = i & 1;
    opaque(sm);
    const uint32_t vbuf = S::kValues + ph * S::kValuesBytes;  // this tile's values buffer
    if (warp == rank) {
      // the owner: its warpgroup's warp `rank`, rows g and g + 8
      mbar_wait(sm + S::kFullR, ph);
      if (role == 0 && lane == 0) mbar_expect(sm + S::kFullR, S::kPartsBytes);
      const bool edge = k0 + N > Tn || (causal && k0 + N - 1 > row0 - g);
      float x[kNK][4], mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kNK; ++j) {
        const float4 a = sum_parts<P>(sm + S::kParts, role, j, lane);  // rank order
        x[j][0] = a.x, x[j][1] = a.y, x[j][2] = a.z, x[j][3] = a.w;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * t + (e & 1), row = row0 + 8 * (e >> 1);
          if (edge && (col >= Tn || (causal && col > row))) x[j][e] = kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], x[j][e]);
        }
      }
      float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float nm = fmaxf(m[r], quad_max(mx[r]));
        corr[r] = expf(m[r] - nm);
        m[r] = nm;
      }
#pragma unroll
      for (int j = 0; j < kNK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[j][e] = expf(x[j][e] - m[e >> 1]);
          rs[e >> 1] += x[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(rs[r]);
      const uint32_t at = sm + vbuf + xoff<kFwdChunks>(4 * role + warp, 0, lane);
#pragma unroll
      for (int r = 0; r < P; ++r) {
        const uint32_t to = peer(at, r), bar = peer(sm + S::kFullG, r);
#pragma unroll
        for (int j = 0; j < kNK; ++j)
          st_async(to + xoff<kFwdChunks>(0, j, 0), make_float4(x[j][0], x[j][1], x[j][2], x[j][3]),
                   bar);
        st_async(to + xoff<kFwdChunks>(0, kNK, 0), make_float4(corr[0], l[0], corr[1], l[1]),
                 bar);
      }
    }
    // the next tile's k split, and its score products issued
    if (i + 1 < nk) {
      cp_async_wait_all();
      __syncthreads();  // tile i + 1 has landed everywhere
      split_tile<false>(sm + S::kK, 0, sm + S::kLand0);
      fence_async();
      __syncthreads();
    }
    opaque(sm);  // the descriptors derived here, not held across the tile
    d0 = desc(sm, 16, 1024);
    wg_fence();
    score_chain(s, d0, ah, a_lo, S::kK);
    wg_commit();
    // this tile's values, from every owner, read once the products are done
    // and the next tile's parts are out
    mbar_wait(sm + S::kFullG, ph);
    if (threadIdx.x == 0) mbar_expect(sm + S::kFullG, S::kValuesBytes);
    wg_wait<0>();
    pin(s);
    if (i + 1 < nk) send_parts(s, sm + S::kParts, sm + S::kFullR, rank, role, warp, lane);
    float f[N / 2];
#pragma unroll
    for (int j = 0; j < kNK; ++j) {
      const float4 x = lds128(sm + vbuf + xoff<kFwdChunks>(4 * role + warp, j, lane));
      f[4 * j] = x.x, f[4 * j + 1] = x.y, f[4 * j + 2] = x.z, f[4 * j + 3] = x.w;
    }
    // (corr, l) of rows g and g + 8
    const float4 cl = lds128(sm + vbuf + xoff<kFwdChunks>(4 * role + warp, kNK, lane));
    lg[0] = cl.y, lg[1] = cl.w;
    uint32_t fh[kNK][4], fl[kNK][4];
    fragments(f, fh, fl);
    // acc = acc corr + P V over the 128 columns, 64 at a time
    opaque(sm);
    d0 = desc(sm, 16, 1024);
    pv_product<0>(acc, d0, fh, fl, S::kVT, cl.x, cl.z);
    pv_product<8>(acc, d0, fh, fl, S::kVT + 64 * kRowBytes, cl.x, cl.z);
    if (i + 1 < nk) {
      __syncthreads();  // every warp is done with tile i's transposed v
      split_tile<true, false>(0, sm + S::kVT, sm + S::kLand1);
      fence_async();
      __syncthreads();  // the landing stage is free
      if (i + 2 < nk) land_kv(i + 2);
    }
  }
  cluster_sync();  // no block leaves while its peers may still send
  if (warp == rank && t == 0)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row0 + 8 * r < Tn) lse[(int64_t)bh * Tn + row0 + 8 * r] = m[r] + logf(fmaxf(l[r], 1e-30f));
  const float ls0 = fmaxf(lg[0], 1e-30f), ls1 = fmaxf(lg[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < kNT; ++n) {
    acc[n][0] /= ls0, acc[n][1] /= ls0;
    acc[n][2] /= ls1, acc[n][3] /= ls1;
  }
  store_rows<kNT, 0, DH>(o, acc, b, h, H, Tn, row0, c0, t);
}

// the arguments an entry takes; dk/dv (dkv) has no Dh-384 form
bool args_ok(int B, int H, int T, int Dh, int is_bf16, bool dkv) {
  return !is_bf16 && (Dh == kDh || (Dh == 3 * kDh && !dkv) || Dh == 4 * kDh) && B > 0 && H > 0 &&
         T > 0 && (int64_t)B * H * ((T + kRows - 1) / kRows) * (Dh / kDh) <= 0x7fffffffLL;
}

// one block per (bh, 64-row tile), the tiles of one bh consecutive; P
// blocks (a cluster) per tile at Dh = 128 P
dim3 grid(int B, int H, int T, int P) {
  return dim3((unsigned)(B * H * ((T + kRows - 1) / kRows) * P));
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the launch configuration of the cluster kernels: clusters of P blocks
// along x, 256 threads and `bytes` of dynamic shared memory a block
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterLaunch(int P, dim3 grid, int bytes, cudaStream_t s) : attr{}, cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = P;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(2 * kWG);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// dq at Dh = 128 P: one block a tile (P = 1) or a cluster of P
template <int P>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* delta, float* dq, int B, int H, int T,
                      int causal, int64_t sb, int64_t st, int64_t sh, float scale,
                      cudaStream_t stream) {
  constexpr int bytes = Smem<false, P>::kBytes;
  cudaError_t e = prepare(flash_dq_f32wg_kernel<P>, bytes);
  if (e != cudaSuccess) return e;
  if constexpr (P == 1) {
    flash_dq_f32wg_kernel<1><<<grid(B, H, T, 1), 2 * kWG, bytes, stream>>>(
        q, k, v, dout, lse, delta, dq, H, T, sb, st, sh, scale, causal);
    return cudaGetLastError();
  } else {
    ClusterLaunch l(P, grid(B, H, T, P), bytes, stream);
    e = cudaLaunchKernelEx(&l.cfg, flash_dq_f32wg_kernel<P>, q, k, v, dout, lse, delta, dq, H, T,
                           sb, st, sh, scale, causal);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
}

// dk and dv at Dh = 128 P (P = 1 or 4), likewise
template <int P>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* delta, float* dk, float* dv, int B, int H,
                       int T, int causal, int64_t sb, int64_t st, int64_t sh, float scale,
                       cudaStream_t stream) {
  constexpr int bytes = Smem<true, P>::kBytes;
  cudaError_t e = prepare(flash_dkv_f32wg_kernel<P>, bytes);
  if (e != cudaSuccess) return e;
  if constexpr (P == 1) {
    flash_dkv_f32wg_kernel<1><<<grid(B, H, T, 1), 2 * kWG, bytes, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, H, T, sb, st, sh, scale, causal);
    return cudaGetLastError();
  } else {
    ClusterLaunch l(P, grid(B, H, T, P), bytes, stream);
    e = cudaLaunchKernelEx(&l.cfg, flash_dkv_f32wg_kernel<P>, q, k, v, dout, lse, delta, dk, dv,
                           H, T, sb, st, sh, scale, causal);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
}

// the forward at Dh 512: a cluster of four blocks a 128-row q tile
cudaError_t launch_fwd(const float* q, const float* k, const float* v, float* o, float* lse, int B,
                       int H, int T, int causal, int64_t sb, int64_t st, int64_t sh, float scale,
                       cudaStream_t stream) {
  constexpr int bytes = FwdSmem::kBytes;
  cudaError_t e = prepare(flash_fwd_f32wg_kernel<4>, bytes);
  if (e != cudaSuccess) return e;
  const int tiles = B * H * ((T + kFwdRows - 1) / kFwdRows);
  ClusterLaunch l(4, dim3((unsigned)(4 * tiles)), bytes, stream);
  e = cudaLaunchKernelEx(&l.cfg, flash_fwd_f32wg_kernel<4>, q, k, v, o, lse, H, T, sb, st, sh,
                         scale, causal);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the clusters of P blocks of kernel `kernel` at `bytes` that the card holds at once
int resident_clusters(const void* kernel, int P, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return -(int)e;
  ClusterLaunch l(P, dim3(P * 64), bytes, 0);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, kernel, &l.cfg);
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

// o (B, T, H, Dh) contiguous and lse (B*H, T) from q, k, v (B, T, H, Dh)
// float32 sharing the element strides (sb, st, sh), Dh contiguous, 16-byte
// aligned rows. Takes Dh 512 (a cluster of four blocks a 128-row q tile)
// with is_bf16 = 0 only. Returns the cudaError_t of the launch.
extern "C" int fedml_flash_fwd_f32wg_sm90(const void* q, const void* k, const void* v, void* o,
                                          float* lse, int B, int H, int T, int Dh, int is_bf16,
                                          int causal, long long sb, long long st, long long sh,
                                          float scale, void* stream) {
  if (Dh != 4 * kDh || !args_ok(B, H, T, Dh, is_bf16, false)) return (int)cudaErrorInvalidValue;
  return (int)launch_fwd((const float*)q, (const float*)k, (const float*)v, (float*)o, lse, B, H,
                         T, causal, sb, st, sh, scale, (cudaStream_t)stream);
}

// dq (B, T, H, Dh) contiguous from q, k, v (B, T, H, Dh) float32 sharing
// the element strides (sb, st, sh), Dh contiguous, 16-byte aligned rows;
// dout (B, T, H, Dh) contiguous; the forward's lse and delta = rowsum(dO *
// O), both (B*H, T) float32. Takes Dh 128 (one block a tile), 384 (a
// cluster of three) and 512 (a cluster of four) with is_bf16 = 0 only.
// Returns the cudaError_t of the launch.
extern "C" int fedml_flash_dq_f32wg_sm90(const void* q, const void* k, const void* v,
                                         const void* dout, const float* lse,
                                         const float* delta, void* dq, int B, int H, int T,
                                         int Dh, int is_bf16, int causal, long long sb,
                                         long long st, long long sh, float scale,
                                         void* stream) {
  if (!args_ok(B, H, T, Dh, is_bf16, false)) return (int)cudaErrorInvalidValue;
  const auto launch = Dh == kDh ? launch_dq<1> : Dh == 3 * kDh ? launch_dq<3> : launch_dq<4>;
  return (int)launch((const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse,
                     delta, (float*)dq, B, H, T, causal, sb, st, sh, scale,
                     (cudaStream_t)stream);
}

// dk and dv (B, T, H, Dh) contiguous, from the same inputs as dq. Takes Dh
// 128 and 512 with is_bf16 = 0 only.
extern "C" int fedml_flash_dkv_f32wg_sm90(const void* q, const void* k, const void* v,
                                          const void* dout, const float* lse,
                                          const float* delta, void* dk, void* dv, int B, int H,
                                          int T, int Dh, int is_bf16, int causal, long long sb,
                                          long long st, long long sh, float scale,
                                          void* stream) {
  if (!args_ok(B, H, T, Dh, is_bf16, true)) return (int)cudaErrorInvalidValue;
  const auto launch = Dh == kDh ? launch_dkv<1> : launch_dkv<4>;
  return (int)launch((const float*)q, (const float*)k, (const float*)v, (const float*)dout, lse,
                     delta, (float*)dk, (float*)dv, B, H, T, causal, sb, st, sh, scale,
                     (cudaStream_t)stream);
}

// The clusters of P blocks (P = 3: dq at Dh 384; P = 4: Dh 512) of the dq
// (kind 0), dk/dv (kind 1) or forward (kind 2, Dh 512 only) kernel that
// the card holds at once (cudaOccupancyMaxActiveClusters at the kernel's
// shared memory), or minus the cudaError_t of the query;
// cudaErrorInvalidValue for another form.
extern "C" int fedml_flash_f32wg_clusters(int kind, int P) {
  if (P == 3 && kind == 0)
    return resident_clusters((const void*)flash_dq_f32wg_kernel<3>, 3, Smem<false, 3>::kBytes);
  if (P == 4 && kind == 0)
    return resident_clusters((const void*)flash_dq_f32wg_kernel<4>, 4, Smem<false, 4>::kBytes);
  if (P == 4 && kind == 1)
    return resident_clusters((const void*)flash_dkv_f32wg_kernel<4>, 4, Smem<true, 4>::kBytes);
  if (P == 4 && kind == 2)
    return resident_clusters((const void*)flash_fwd_f32wg_kernel<4>, 4, FwdSmem::kBytes);
  return -(int)cudaErrorInvalidValue;
}
