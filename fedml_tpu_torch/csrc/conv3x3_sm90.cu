// 3x3 / stride-1 / SAME convolution over a leading lane axis (one weight set
// per client lane) on the Hopper tensor cores, exact to float32 through three
// TF32 products (3xTF32). Activations NHWC, weights HWIO, float32. It runs
// the forward (and so dx, the forward of dy with the flipped,
// channel-transposed kernel) for Ci = Co in {16, 32, 64}: ResNet's block
// convs; in bfloat16 (use_bf16) the forward and the weight gradient (both
// at the end of this file), and the stem's forward (3 -> 16) in bf16 and
// in float32. Other channel counts (ragged shapes), the stem's weight
// gradient and the float32 weight gradient keep the FMA kernels of
// conv3x3.cu; ops/conv.py::fwd_route and dw_route pick by (Ci, Co) and
// dtype and mirror tc_channels() and kStemCI / kStemCO below.
//
// Replaces: fedml_tpu/ops/conv.py::conv2d_pallas — the forward Pallas kernel
// _fwd_kernel (:143, pallas_call :208), which builds the [Bt H W, 9 Ci] patch
// matrix in VMEM (_build_patches :124) and runs one jnp.dot against
// w.reshape(9 Ci, Co); reused for dx by _conv2d_pallas_bwd (:226). Under
// jax.vmap the Pallas grid gains the lane axis; here it is blockIdx.y.
//
// It is a GEMM over an implicit patch matrix: y[l, m, n] = sum_k A_l[m, k]
// w[l, k, n], m = (b, h, w) a pixel, k = (dy, dx, ci), A_l[m, k] =
// x[l, b, h + dy - 1, w + dx - 1, ci], zero outside the image.
//
// Bound on the H100 at the path's block shapes (L = 10 lanes, B = 64; bytes
// = x and y once, w; operations = 3 TF32 products of 2 operations per
// multiply-add over the taps inside the image, at 495 TFLOP/s):
//   32x32, 16 -> 16: 84.0 MB, 0.0251 ms of bytes; 0.0175 ms of operations
//   16x16, 32 -> 32: 41.9 MB, 0.0125 ms;          0.0168 ms
//    8x8,  64 -> 64: 21.0 MB, 0.0063 ms;          0.0154 ms
// The first is bound by bytes, the others by operations. On the CUDA cores
// (fp32 FMA at 67 TFLOP/s) the same work cannot take less than 0.038-0.043
// ms; that is why this kernel exists.
//
// Exactness. Each operand v (an x or a w value) is split in the kernel into
// hi = cvt.rna.tf32(v) (computed with two integer operations, the same bits
// as the conversion instruction for every finite v) and lo = v - hi, exact
// in float32 with |lo| <= 2^-11 |v|; the tensor core reads lo as TF32 by
// dropping its low 13 bits, an error of at most 2^-10 |lo| <= 2^-21 |v|. A
// TF32 x TF32 product (11 x 11 significant bits) is exact in float32, so
// a_lo b_hi + a_hi b_lo + a_hi b_hi differs from a b by the dropped a_lo b_lo
// (<= 2^-22 |a||b|) and the two reads of lo: at most ~1.2e-6 of the
// magnitudes, inside chip_smoke.py's CONV_TOL = 1e-5 (|y - plain| / the same
// product on |x|, |w|); one unsplit TF32 product errs by ~1e-4 there. The
// three products go into one accumulator, small terms first (lo hi, hi lo,
// then hi hi). The tensor cores' float32 sums do not round to nearest and
// their errors lean one way, which over a long run of additions into one
// accumulator adds up (the bf16 flash kernels of flash_attention_sm90.cu
// failed their gate that way at T 8192). Here the run is one tap: each tap's products (2-8 k-steps of 8,
// three mma each) start from a zero accumulator, and the nine tap sums are
// added in float32 registers, rounded to nearest, in tap order.
// tests/test_torch_conv.py emulates this split and order on the CPU. No
// atomics and no split of the contraction across blocks: y repeats bit for
// bit. The pins that keep PyTorch's matmuls and cuDNN off TF32 stay.
//
// Design. mma.sync.m16n8k8 (row.col, tf32, float32 sums), whose A fragments
// load from any shared-memory address: that suits the tap-shifted reads of
// one halo tile. A tile is BM = 32 WM pixel slots of one lane: whole image
// rows (and, where an image is smaller than BM, BM / (H W) images), or BM
// columns of a row wider than that. Its (rows + 2) x (cols + 2) x Ci halo of
// x is staged in shared memory by cp.async with zero-fill at the image
// edge, so the patch matrix never reaches device memory (the TPU kernel's
// VMEM patch matrix) and all nine taps read the halo at their shift. Warps
// tile the block as WM (32 pixels each) x Co / 32 (columns, at most 32
// each); a warp holds 2 x (its columns / 8) accumulator tiles and as many
// for the tap sum. Within each k-step the logical k index j maps to channel
// 2 j (j < 4) or 2 (j - 4) + 1, the same for A and B, so a thread's two A
// values of a row are adjacent: one 8-byte shared load. Padding (halo
// pixels Ci + 8 floats apart, w rows Co + 4) keeps those loads free of bank
// conflicts. Per Ci (the dispatch at the end):
//   Ci 16 and 32: w stays resident (all nine taps, staged once per block)
//     and each block walks several tiles of its lane (as many blocks as the
//     SMs hold, each the same number of tiles), staging the next tile's
//     halo while this one's products run: one barrier per tile.
//   Ci 64: w (157 KB with its padding) does not fit beside two halos; it
//     streams one tap at a time through a two-stage ring, the next tap in
//     flight during this one's products, one barrier per tap, a block per
//     tile, three blocks per SM overlapping one's staging with another's
//     products.
// What bounds it on the H100: mma.sync does not reach the TF32 rate the
// bound counts (wgmma's); chip_smoke.py's tc_rate phase measures what it
// reaches (csrc/tc_rate.cu). The split is the next cost. cvt.rna.tf32.f32
// runs on the slow conversion pipe, which made the kernel markedly slower
// than the integer operations used here; rounding lo as well cost more
// than the 2^-22 it buys and was dropped for the tensor core's own read of
// lo. Splitting x once per tile into hi and lo planes in shared memory
// doubles the A fragments' shared-memory traffic and ran slower. A
// streamed w ring with a block per tile ran slower at Ci 16 and 32, a
// persistent ring slower at Ci 64 (bring-up on the H100, PERF.md).
// ptxas -v for sm_90a (chip_smoke.py's build phase): Ci 16 (taps unrolled,
// cut for 4 blocks per SM) 128 registers with 16 bytes of spill stores and
// 24 of loads; Ci 32 146 registers, Ci 64 160, no spills.
//
// Left for later: wgmma (both shared-memory operands K-major in TF32, A from
// registers) for the rest of the tensor cores' rate; fewer integer
// operations per split; in bfloat16, the column cut of Ci 64 (below) at Ci
// 16 and 32, whose blocks still stage all of w with a transposing loop.
//
// bfloat16 (fedml_conv3x3_fwd_sm90_bf16, the JAX package's use_bf16: the
// same Pallas kernel on bf16 x and w, a bf16 patch scratch, f32 sums by
// preferred_element_type, conv.py:147, and a bf16 output, :149): the same
// tiling with one mma.sync.m16n8k16 bf16 product per 16-channel k-step in
// place of three TF32 ones. Products of two bf16 values are exact in
// float32 and the sums are float32 (the tensor core's, not rounded to
// nearest, over at most 9 x 4 k-steps into one accumulator); each output is
// rounded once to bf16 on store, so the kernel is within one bf16 step of
// the rounded float32 result (chip_smoke.py's bf16 conv gate). The halo is
// staged as bf16 (half the float32 bytes). At Ci 16 and 32 w, all nine
// taps, is staged once per block, transposed to [tap][co][ci] so that both
// operands are read as one 8-byte word per fragment row (see
// conv3x3_bf16_kernel); at Ci 64 each block takes one 32-column slice of
// the output and stages only that slice of w, untransposed, with ldmatrix
// reading both operands (conv3x3_bf16_cut_kernel); the stem (3 -> 16) has
// its own kernel, its 27-deep contraction padded to two k-steps
// (conv3x3_stem_bf16_kernel). Bound at the path's block shapes (L = 10, B
// = 64): 42.0, 21.0 and 10.5 MB of bytes, 0.0125, 0.0063 and 0.0031 ms at
// 3.35 TB/s, against 2.9, 2.8 and 2.6 us of operations (in-image taps) at
// 989 TFLOP/s: all three are bound by bytes; the stem 24.9 MB, 0.0074 ms.
// ptxas -v for sm_90a (chip_smoke.py's build phase): conv3x3_bf16_kernel
// Ci 16 76 registers, Ci 32 102; conv3x3_bf16_cut_kernel 77;
// conv3x3_stem_bf16_kernel 123 (cut for four blocks an SM); no spills.
//
// bfloat16 weight gradient (fedml_conv3x3_dw_sm90_bf16). Replaces the same
// Pallas kernel's _dw_kernel (:152, pallas_call :240) on bf16 x and dy: dw =
// patches(x)^T dy, float32 sums over the batch-block grid (:156),
// .astype(w.dtype) once (:252). Here it is an mma.sync.m16n8k16 product
// whose M is the 9 Ci rows of dw (144, 288 or 576: whole 16-row tiles), N
// its Co columns and K the pixels, 16 a k-step: bf16 x bf16 products exact
// in float32, float32 sums. Bound as the forward (the same bytes; the
// in-image multiply-adds at the bf16 rate): bytes at the path's shapes.
// Before it, the bf16 dw ran conv3x3.cu's FMA kernel on the CUDA cores (the
// same operations at the float32 FMA rate, >= 45 us at L = 10, 32 x 32).
//   Tiles: up to 128 pixel slots of one image, whole rows (or 128 columns
// of a wider row); the tile's (rows + 2) x (cols + 2) halo of x and its dy
// rows are staged by cp.async (zero-filled outside the image and past the
// tile) into one of two buffers while the other's products run, one
// barrier a tile. Both operands are pixel-major in shared memory, 16-byte
// rows Ci + 8 elements apart (conflict-free), and ldmatrix.x4.trans turns
// them into row.col fragments: A from the halo at the tap's shift (each
// 16-row tile of dw is one tap and 16 channels), B from the dy rows. Warps
// own MT 16-row tiles over all Co columns (Ci 16: 3 warps x 3 tiles, the
// whole 144 rows; Ci 32: 6 x 3, all 288; Ci 64: 6 x 2, a third of 576, so a
// lane's rows take three blocks). A lane's tiles are cut into spans across
// blocks (ops/conv.py::dw_split_plan: at most two blocks per SM, one wave),
// each writing its float32 partial; conv3x3.cu's second kernel
// (conv_dw_reduce.cuh) adds the partials in the fixed order s = 0..S-1 and
// rounds once to bf16: no atomics, dw repeats bit for bit. x may broadcast over lanes (stride 0).
//   The tensor cores' float32 sums lean one way (as the forward's and the
// flash kernels'), so each tile's k-steps (at most 8) start from a zero
// accumulator and the tile is added to the running sum in float32
// registers, rounded to nearest. How long a chain may run (a sweep of
// this kernel rebuilt at other chain lengths, one block per lane, 64
// images, on an H100 80GB HBM3 at 700 W; PERF.md): chains of 1 and 4 tiles
// (<= 512 pixels) leave 0.043% of the outputs off the exactly rounded value
// at 32 x 32 x 16, 16 tiles 0.17%, 64 tiles 0.56% and one chain over all
// 65,536 pixels 3.9%, past chip_smoke.py's 0.25% gate; the smaller convs
// (16,384 and 4,096 pixels a lane) move less. The chain is one tile.
//   Tried and not kept, each timed against this form in one call on the
// card: staging without divisions (the forward's walk: within 8% either
// way); more blocks per SM than two (faster only at Ci 16 with ten lanes,
// slower at one or two, where more partials lengthen the reduce's chains);
// loads batched in the reduce (no change); at Ci 64, warps of one 16-row
// tile, or nine or twelve warps a block (all slower at ten lanes).
// ptxas -v for sm_90a (chip_smoke.py's build phase): Ci 16 108 registers,
// Ci 32 156, Ci 64 167, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_dw_reduce.cuh"
#include "tf32x3.cuh"

namespace {

constexpr int kMI = 2;  // 16-row mma tiles per warp along the pixels: 32 slots

// Ci = Co channels; WM warps along the pixels; RES: w resident (all nine
// taps staged once) and a block walks several tiles, the next tile's halo
// staged during this one's products; else w streams through a two-tap ring
// and a block takes one tile; UNROLL: the nine taps unrolled
template <int CI, int WM, bool RES, bool UNROLL>
struct Cfg {
  using T = float;
  static constexpr int CO = CI;
  static constexpr int WCOLS = CO < 32 ? CO : 32;  // columns of one warp
  static constexpr int WARPS_N = CO / WCOLS;
  static constexpr int NT = 32 * WM * WARPS_N;     // threads
  static constexpr int BM = 32 * WM;               // pixel slots of a tile
  static constexpr int NI = WCOLS / 8;             // 8-column mma tiles per warp
  static constexpr int XS = CI + 8;                // floats between halo pixels
  static constexpr int WS = CO + 4;                // floats between rows of a tap's w
  static constexpr int WTAP = CI * WS;             // floats of one tap of w
  static constexpr int WFLOATS = (RES ? 9 : 2) * WTAP;
  static constexpr int HALOS = RES ? 2 : 1;        // halo buffers: tiles in flight
  static constexpr int CPP = CI / 4;               // 16-byte chunks of a pixel
  static constexpr int NPX = NT / CPP;             // halo pixels staged per pass
  static_assert(CI % 16 == 0 && CO <= 64 && NT % CPP == 0, "channels the kernel takes");
};

// A tile's pixel slots: `imgs` images x `rb` rows x `cb` columns; the grid
// of tiles along b, h and w; the halo's rows and columns
struct Geo {
  int imgs, rb, cb, nh, nw, hr, hc, halo_px;
};

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// taps [tap0, tap0 + n) of w (each Ci x Co, contiguous) into shared memory,
// WS floats between rows, one tap after another
template <int CI, int CO, int NT, int WS>
__device__ __forceinline__ void stage_w(float* dst, const float* wl, int tap0, int n, int t) {
  const float* src = wl + (int64_t)tap0 * CI * CO;
  for (int e = t; e < n * CI * CO / 4; e += NT) {
    const int r = e / (CO / 4), c = 4 * (e % (CO / 4));  // r: row of the n taps
    cp_async16(dst + r * WS + c, src + r * CO + c, true);
  }
}

// The tile's origin: first image, row and column
__device__ __forceinline__ void tile_origin(int tile, const Geo& g, int& b0, int& h0, int& w0) {
  w0 = (tile % g.nw) * g.cb;
  tile /= g.nw;
  h0 = (tile % g.nh) * g.rb;
  b0 = (tile / g.nh) * g.imgs;
}

// One tap's products into acc: from a zero accumulator, lo hi, hi lo, hi hi
// per k-step, then added to acc in float32
template <class C, int CI>
__device__ __forceinline__ void tap_products(float (&acc)[kMI][C::NI][4], const float* hb,
                                             const int (&hoff)[kMI][2], int toff,
                                             const float* ws) {
  float sacc[kMI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[mi][ni][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < CI / 8; ++ks) {
    // A: a0 (row gid, k tig) and a2 (row gid, k tig + 4) are channels
    // 8 ks + 2 tig and + 1, adjacent; a1, a3 the same for row gid + 8
    uint32_t ah[kMI][4], al[kMI][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const float2 v0 = *reinterpret_cast<const float2*>(hb + hoff[mi][0] + toff + 8 * ks);
      const float2 v1 = *reinterpret_cast<const float2*>(hb + hoff[mi][1] + toff + 8 * ks);
      split_tf32(v0.x, ah[mi][0], al[mi][0]);
      split_tf32(v1.x, ah[mi][1], al[mi][1]);
      split_tf32(v0.y, ah[mi][2], al[mi][2]);
      split_tf32(v1.y, ah[mi][3], al[mi][3]);
    }
    // B: b0 (k tig, column gid) and b1 (k tig + 4) are w's rows 8 ks + 2 tig
    // and + 1
    uint32_t bh[C::NI][2], bl[C::NI][2];
    const float* wk = ws + 8 * ks * C::WS;
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
      split_tf32(wk[8 * ni], bh[ni][0], bl[ni][0]);
      split_tf32(wk[C::WS + 8 * ni], bh[ni][1], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        mma_tf32(sacc[mi][ni], al[mi], bh[ni]);
        mma_tf32(sacc[mi][ni], ah[mi], bl[ni]);
        mma_tf32(sacc[mi][ni], ah[mi], bh[ni]);
      }
  }
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] += sacc[mi][ni][e];
}

template <int CI, int WM, bool RES, bool UNROLL, int MINB>
__global__ void __launch_bounds__(Cfg<CI, WM, RES, UNROLL>::NT, MINB)
conv3x3_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ y, int B, int H, int W, int64_t x_lane,
                    int64_t w_lane, Geo g, int tiles) {
  using C = Cfg<CI, WM, RES, UNROLL>;
  constexpr int CO = C::CO;
  extern __shared__ float4 smem4[];
  float* wbuf = reinterpret_cast<float*>(smem4);
  float* halo = wbuf + C::WFLOATS;  // HALOS buffers of halo_px * XS floats
  const int halo_floats = g.halo_px * C::XS;

  const int t = threadIdx.x, lane = blockIdx.y;
  const float* xl = x + (int64_t)lane * x_lane;
  const float* wl = w + (int64_t)lane * w_lane;
  float* yl = y + (int64_t)lane * B * H * W * CO;

  // the halo pixels this thread stages: chunk hcc of pixels hp0 + NPX j
  const int hcc = 4 * (t % C::CPP), hp0 = t / C::CPP;
  const int pc0 = hp0 % g.hc, pr0 = (hp0 / g.hc) % g.hr, pi0 = hp0 / (g.hc * g.hr);
  // pixel p = (img, pr, pc) of buffer dst holds x[b0 + img, h0 + pr - 1,
  // w0 + pc - 1, :], zero outside the image
  auto stage_halo = [&](float* dst, int tile) {
    int b0, h0, w0;
    tile_origin(tile, g, b0, h0, w0);
    int pc = pc0, pr = pr0, img = pi0;
    for (int p = hp0; p < g.halo_px; p += C::NPX) {
      const int b = b0 + img, h = h0 + pr - 1, ww = w0 + pc - 1;
      const bool ok = b < B && h >= 0 && h < H && ww >= 0 && ww < W;
      cp_async16(dst + p * C::XS + hcc,
                 ok ? xl + (((int64_t)b * H + h) * W + ww) * CI + hcc : xl, ok);
      pc += C::NPX;
      while (pc >= g.hc) pc -= g.hc, ++pr;
      while (pr >= g.hr) pr -= g.hr, ++img;
    }
  };

  const int warp = t / 32, gid = (t % 32) >> 2, tig = t & 3;
  const int wm = warp % WM, wn = warp / WM;
  // per fragment row (mi, half): the halo offset of its slot's tap (0, 0)
  int hoff[kMI][2];
  const int slots = g.imgs * g.rb * g.cb;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = wm * 32 + mi * 16 + gid + 8 * hh;
      const int img = s / (g.rb * g.cb), r = (s / g.cb) % g.rb, c = s % g.cb;
      hoff[mi][hh] = (s < slots ? ((img * g.hr + r) * g.hc + c) * C::XS : 0) + 2 * tig;
    }
  // this thread's B values: rows 2 tig and + 1 of each k-step, column
  // wn * WCOLS + gid + 8 ni
  const int boff = 2 * tig * C::WS + wn * C::WCOLS + gid;

  const int tile0 = blockIdx.x, stride = gridDim.x;
  const int my_tiles = RES ? (tiles - tile0 + stride - 1) / stride : 1;
  // prologue: the first tile's halo with w (all of it, or its first tap)
  stage_halo(halo, tile0);
  stage_w<CI, CO, C::NT, C::WS>(wbuf, wl, 0, RES ? 9 : 1, t);
  cp_async_commit();

#pragma unroll 1
  for (int i = 0; i < my_tiles; ++i) {
    const int tile = tile0 + i * stride;
    const float* hb = halo + (i & 1) * halo_floats;
    float acc[kMI][C::NI][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    if constexpr (RES) {
      cp_async_wait<0>();  // this tile's halo (and, first, w) has landed
      __syncthreads();     // ... for every thread, and the other buffer is free
      if (i + 1 < my_tiles) stage_halo(halo + ((i + 1) & 1) * halo_floats, tile + stride);
      cp_async_commit();
      if constexpr (UNROLL) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          tap_products<C, CI>(acc, hb, hoff, ((tap / 3) * g.hc + tap % 3) * C::XS,
                              wbuf + tap * C::WTAP + boff);
      } else {
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap)
          tap_products<C, CI>(acc, hb, hoff, ((tap / 3) * g.hc + tap % 3) * C::XS,
                              wbuf + tap * C::WTAP + boff);
      }
    } else {
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        cp_async_wait<0>();  // this tap's w (and, first, the halo) has landed
        __syncthreads();     // ... for every thread, and tap - 1's ring slot is free
        if (tap + 1 < 9)
          stage_w<CI, CO, C::NT, C::WS>(wbuf + ((tap + 1) & 1) * C::WTAP, wl, tap + 1, 1, t);
        cp_async_commit();
        tap_products<C, CI>(acc, hb, hoff, ((tap / 3) * g.hc + tap % 3) * C::XS,
                            wbuf + (tap & 1) * C::WTAP + boff);
      }
    }

    // c0, c1: row gid, columns 2 tig and + 1; c2, c3: row gid + 8
    int b0, h0, w0;
    tile_origin(tile, g, b0, h0, w0);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = wm * 32 + mi * 16 + gid + 8 * hh;
        const int b = b0 + s / (g.rb * g.cb), h = h0 + (s / g.cb) % g.rb, ww = w0 + s % g.cb;
        if (s >= slots || b >= B || h >= H || ww >= W) continue;
        float* dst = yl + (((int64_t)b * H + h) * W + ww) * CO + wn * C::WCOLS + 2 * tig;
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni)
          *reinterpret_cast<float2*>(dst + 8 * ni) =
              make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
  }
  cp_async_wait<0>();
}

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

// A tile's slots: whole rows of one image where a row fits BM (with as many
// images as fit where the image does), else BM columns of one row; fewer
// images, rows or columns where the halos and w would not fit the shared
// memory.
template <class C>
Geo geometry(int B, int H, int W, int& bytes) {
  Geo g;
  g.cb = W < C::BM ? W : C::BM;
  g.rb = g.cb < W ? 1 : (H < C::BM / W ? H : C::BM / W);
  g.imgs = g.rb < H ? 1 : (B < C::BM / (H * W) ? B : C::BM / (H * W));
  if (g.imgs < 1) g.imgs = 1;
  auto smem = [&] {
    return (int)sizeof(typename C::T) *
           (C::HALOS * g.imgs * (g.rb + 2) * (g.cb + 2) * C::XS + C::WFLOATS);
  };
  while (smem() > kMaxSmem && g.imgs > 1) --g.imgs;
  while (smem() > kMaxSmem && g.rb > 1) --g.rb;
  while (smem() > kMaxSmem && g.cb > 1) g.cb = (g.cb + 1) / 2;
  g.nh = (H + g.rb - 1) / g.rb;
  g.nw = (W + g.cb - 1) / g.cb;
  g.hr = g.rb + 2;
  g.hc = g.cb + 2;
  g.halo_px = g.imgs * g.hr * g.hc;
  bytes = smem();
  return g;
}

template <int CI, int WM, bool RES, bool UNROLL, int MINB>
cudaError_t launch(const float* x, const float* w, float* y, int L, int B, int H, int W,
                   int64_t x_lane, int64_t w_lane, cudaStream_t st) {
  using C = Cfg<CI, WM, RES, UNROLL>;
  int bytes;
  const Geo g = geometry<C>(B, H, W, bytes);
  const int64_t tiles = (int64_t)((B + g.imgs - 1) / g.imgs) * g.nh * g.nw;
  if (tiles > 0x7fffffff || bytes > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = conv3x3_tf32_kernel<CI, WM, RES, UNROLL, MINB>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  int64_t blocks = tiles;
  if constexpr (RES) {
    // blocks per lane: the SM slots shared among the lanes, then as few as
    // give every block the same number of tiles (rounds)
    int dev, sms, per_sm;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::NT, bytes);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int64_t slots = ((int64_t)sms * per_sm + L - 1) / L;
    const int64_t rounds = (tiles + slots - 1) / slots;
    blocks = (tiles + rounds - 1) / rounds;
  }
  kernel<<<dim3((unsigned)blocks, (unsigned)L), C::NT, bytes, st>>>(x, w, y, B, H, W, x_lane,
                                                                     w_lane, g, (int)tiles);
  return cudaGetLastError();
}

// --- bfloat16: one mma.sync m16n8k16 product, float32 sums ----------------

typedef __nv_bfloat16 bf16;

// Ci = Co channels, WM warps along the pixels; w resident (all nine taps,
// transposed to [tap][co][ci] once per block) and each block walks several
// tiles, the next tile's halo staged during this one's products, as the
// resident float32 configuration does
template <int CI, int WM>
struct CfgBf16 {
  using T = bf16;
  static constexpr int CO = CI;
  static constexpr int WCOLS = CO < 32 ? CO : 32;  // columns of one warp
  static constexpr int WARPS_N = CO / WCOLS;
  static constexpr int NT = 32 * WM * WARPS_N;     // threads
  static constexpr int BM = 32 * WM;               // pixel slots of a tile
  static constexpr int NI = WCOLS / 8;             // 8-column mma tiles per warp
  // elements between halo pixels and between the channel rows of the
  // transposed w: 2 XS bytes = 32 or 96 mod 128, so the 8-byte fragment
  // loads of a half-warp's four rows (or columns) fall in distinct banks
  static constexpr int XS = CI == 16 ? 16 : CI + 16;
  static constexpr int WTAP = CO * XS;             // elements of one tap of w
  static constexpr int WFLOATS = 9 * WTAP;         // elements of w (geometry's name)
  static constexpr int HALOS = 2;
  static constexpr int CPP = CI / 8;               // 16-byte chunks of a pixel
  static constexpr int NPX = NT / CPP;             // halo pixels staged per pass
  static_assert(CI % 16 == 0 && CO <= 64 && NT % CPP == 0, "channels the kernel takes");
};

__device__ __forceinline__ void cp_async16b(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The k-step's channel order. In a 16-channel k-step a thread of the mma
// holds logical k 2 tig, +1 (its first A and B register) and 2 tig + 8, +9
// (its second); these are stored channels 16 ks + 4 tig .. + 3, the same
// for A and B, so each thread reads one 8-byte word per fragment row or
// column. The products summed are the same; only their order differs.
template <int CI, int WM, int MINB>
__global__ void __launch_bounds__(CfgBf16<CI, WM>::NT, MINB)
conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    bf16* __restrict__ y, int B, int H, int W, int64_t x_lane, int64_t w_lane,
                    Geo g, int tiles) {
  using C = CfgBf16<CI, WM>;
  constexpr int CO = C::CO;
  extern __shared__ float4 smem4[];
  bf16* wbuf = reinterpret_cast<bf16*>(smem4);   // [9][CO][XS]
  bf16* halo = wbuf + C::WFLOATS;                // HALOS buffers of halo_px * XS
  const int halo_elems = g.halo_px * C::XS;

  const int t = threadIdx.x, lane = blockIdx.y;
  const bf16* xl = x + (int64_t)lane * x_lane;
  const bf16* wl = w + (int64_t)lane * w_lane;
  bf16* yl = y + (int64_t)lane * B * H * W * CO;

  // halo staging as the float32 kernel's, 8 channels per 16-byte chunk
  const int hcc = 8 * (t % C::CPP), hp0 = t / C::CPP;
  const int pc0 = hp0 % g.hc, pr0 = (hp0 / g.hc) % g.hr, pi0 = hp0 / (g.hc * g.hr);
  auto stage_halo = [&](bf16* dst, int tile) {
    int b0, h0, w0;
    tile_origin(tile, g, b0, h0, w0);
    int pc = pc0, pr = pr0, img = pi0;
    for (int p = hp0; p < g.halo_px; p += C::NPX) {
      const int b = b0 + img, h = h0 + pr - 1, ww = w0 + pc - 1;
      const bool ok = b < B && h >= 0 && h < H && ww >= 0 && ww < W;
      cp_async16b(dst + p * C::XS + hcc,
                  ok ? xl + (((int64_t)b * H + h) * W + ww) * CI + hcc : xl, ok);
      pc += C::NPX;
      while (pc >= g.hc) pc -= g.hc, ++pr;
      while (pr >= g.hr) pr -= g.hr, ++img;
    }
  };

  const int warp = t / 32, gid = (t % 32) >> 2, tig = t & 3;
  const int wm = warp % WM, wn = warp / WM;
  int hoff[kMI][2];
  const int slots = g.imgs * g.rb * g.cb;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = wm * 32 + mi * 16 + gid + 8 * hh;
      const int img = s / (g.rb * g.cb), r = (s / g.cb) % g.rb, c = s % g.cb;
      hoff[mi][hh] = (s < slots ? ((img * g.hr + r) * g.hc + c) * C::XS : 0) + 4 * tig;
    }
  // this thread's B column wn * WCOLS + gid (+ 8 ni), channels 4 tig..
  const int boff = (wn * C::WCOLS + gid) * C::XS + 4 * tig;

  const int tile0 = blockIdx.x, stride = gridDim.x;
  const int my_tiles = (tiles - tile0 + stride - 1) / stride;
  stage_halo(halo, tile0);
  cp_async_commit();
  // w, transposed: wbuf[tap][co][ci] = w[tap][ci][co]
  for (int e = t; e < 9 * CI * CO; e += C::NT) {
    const int tap = e / (CI * CO), r = e % (CI * CO), ci = r / CO, co = r % CO;
    wbuf[tap * C::WTAP + co * C::XS + ci] = wl[e];
  }

#pragma unroll 1
  for (int i = 0; i < my_tiles; ++i) {
    const int tile = tile0 + i * stride;
    const bf16* hb = halo + (i & 1) * halo_elems;
    float acc[kMI][C::NI][4];
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    cp_async_wait<0>();  // this tile's halo has landed
    __syncthreads();     // ... for every thread (and w, first), the other buffer is free
    if (i + 1 < my_tiles) stage_halo(halo + ((i + 1) & 1) * halo_elems, tile + stride);
    cp_async_commit();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const bf16* ht = hb + ((tap / 3) * g.hc + tap % 3) * C::XS;
      const bf16* wt = wbuf + tap * C::WTAP + boff;
#pragma unroll
      for (int ks = 0; ks < CI / 16; ++ks) {
        uint2 a[kMI][2];
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            a[mi][hh] = *reinterpret_cast<const uint2*>(ht + hoff[mi][hh] + 16 * ks);
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni) {
          const uint2 b = *reinterpret_cast<const uint2*>(wt + 8 * ni * C::XS + 16 * ks);
#pragma unroll
          for (int mi = 0; mi < kMI; ++mi)
            mma_bf16(acc[mi][ni], a[mi][0].x, a[mi][1].x, a[mi][0].y, a[mi][1].y, b.x, b.y);
        }
      }
    }

    // c0, c1: row gid, columns 2 tig and + 1; c2, c3: row gid + 8; rounded
    // once to bfloat16 (to nearest even) on store
    int b0, h0, w0;
    tile_origin(tile, g, b0, h0, w0);
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = wm * 32 + mi * 16 + gid + 8 * hh;
        const int b = b0 + s / (g.rb * g.cb), h = h0 + (s / g.cb) % g.rb, ww = w0 + s % g.cb;
        if (s >= slots || b >= B || h >= H || ww >= W) continue;
        bf16* dst = yl + (((int64_t)b * H + h) * W + ww) * CO + wn * C::WCOLS + 2 * tig;
#pragma unroll
        for (int ni = 0; ni < C::NI; ++ni)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * ni) =
              __floats2bfloat162_rn(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
  }
  cp_async_wait<0>();
}

// The launch plan of a bf16 forward kernel that walks tiles: blocks per
// unit (a lane, or one column slice of a lane) as the resident float32
// kernel's, the SM slots shared among the units, then as few blocks as give
// every block the same number of tiles (rounds). ops/conv.py::fwd_tc_plan
// mirrors it for given sms and per_sm; fedml_conv3x3_fwd_sm90_bf16_plan
// reports it from the card.
struct Plan {
  Geo g;
  int units, tiles, blocks, rounds, bytes, per_sm, sms;
};

// p.g and p.bytes set; fills the rest for `units` units of the kernel
template <class K>
cudaError_t plan_blocks(K kernel, int nt, int64_t units, int B, Plan& p) {
  const int64_t tiles = (int64_t)((B + p.g.imgs - 1) / p.g.imgs) * p.g.nh * p.g.nw;
  if (tiles > 0x7fffffff || p.bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  int dev;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&p.sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, kernel, nt, p.bytes);
  if (e != cudaSuccess) return e;
  if (p.per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t slots = ((int64_t)p.sms * p.per_sm + units - 1) / units;
  p.units = (int)units;
  p.tiles = (int)tiles;
  p.rounds = (int)((tiles + slots - 1) / slots);
  p.blocks = (int)((tiles + p.rounds - 1) / p.rounds);
  return cudaSuccess;
}

template <int CI, int WM, int MINB>
cudaError_t plan_bf16(int L, int B, int H, int W, Plan& p) {
  p.g = geometry<CfgBf16<CI, WM>>(B, H, W, p.bytes);
  return plan_blocks(conv3x3_bf16_kernel<CI, WM, MINB>, CfgBf16<CI, WM>::NT, L, B, p);
}

template <int CI, int WM, int MINB>
cudaError_t launch_bf16(const bf16* x, const bf16* w, bf16* y, int L, int B, int H, int W,
                        int64_t x_lane, int64_t w_lane, cudaStream_t st) {
  Plan p;
  cudaError_t e = plan_bf16<CI, WM, MINB>(L, B, H, W, p);
  if (e != cudaSuccess) return e;
  conv3x3_bf16_kernel<CI, WM, MINB><<<dim3(p.blocks, L), CfgBf16<CI, WM>::NT, p.bytes, st>>>(
      x, w, y, B, H, W, x_lane, w_lane, p.g, p.tiles);
  return cudaGetLastError();
}

// --- bfloat16 at Ci = Co = 64: the output columns cut across blocks --------
//
// Replaces, at Ci 64, the resident-w form above (conv3x3_bf16_kernel<64>),
// which held all of w (9 x 64 x 80 x 2 = 92 KB padded) beside two 128-slot
// halos, one 256-thread block per SM, staged w through a scalar transposing
// loop (144 two-byte loads and stores a thread) that nothing overlapped, and
// at 8 x 8 images launched 32 blocks for L = 1 (two images a tile): 100 of
// the 132 SMs idle, 14.4 us at (1, 64, 8, 8, 64, 64) against cuDNN's 11.0
// (PERF.md). Here a block owns one column slice of NS outputs and so holds
// w's slice only (9 x 64 x 32 x 2 = 36 KB, 45 KB padded), a tile is BM =
// 16 WM = 64 slots (one 8 x 8 image), so L = 1, B = 64 launches 64 tiles x
// 2 slices = 128 blocks, three resident per SM. w is staged as it lies in
// HWIO ([tap][ci][co], the slice's 64 bytes of each row) by 16-byte
// cp.async beside the halo, in three commit groups of three taps, so the
// first taps' products start while the later taps land; ldmatrix reads
// the A fragments from the halo (a pixel's 16 channels of a k-step are two
// 16-byte rows) and ldmatrix.x4.trans turns the k-major w rows into the
// row.col B fragments (two n8 tiles a load). Rows are padded (halo pixels
// 72 elements, 144 bytes = 16 mod 128; w rows NS + 8 = 40, 80 bytes) so the
// eight 16-byte rows of an ldmatrix matrix fall in distinct banks.
// Arithmetic as the kernel above: one bf16 m16n8k16 product per 16-channel
// k-step, channels in natural order, taps in order, the 36 k-steps of a
// tile summed in one float32 accumulator, each output rounded once to bf16;
// no split of the contraction and no atomics, so y repeats bit for bit.
// Bound at (1, 64, 8, 8, 64, 64): 1,122,304 bytes, 0.335 us at 3.35 TB/s
// (0.257 us of in-image operations at 989 TFLOP/s); at L = 10, 3.35 us.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py conv, PERF.md): 5.2 us at
// L = 1, 7.4 at L = 2, 22.7 at L = 10, against the resident form's 14.4 /
// 14.4 / 25.5 and cuDNN's grouped bf16 conv's 11.1 / 11.9 / 32.2. Tried
// and not kept: 16-column quarters (four blocks an SM, 56 KB) ran slower at
// every shape (6.3 / 8.7 / 26.5); the tap loop rolled (65 registers)
// 5.6 / 7.3 / 23.8. ptxas -v: 77 registers, no spills.

// Ci = Co channels, NS output columns a block, WM warps of 16 pixel slots
template <int CI, int NS, int WM>
struct CfgCut {
  using T = bf16;
  static constexpr int CO = CI;
  static constexpr int SLICES = CO / NS;
  static constexpr int NT = 32 * WM;               // threads
  static constexpr int BM = 16 * WM;               // pixel slots of a tile
  static constexpr int N8 = NS / 8;                // 8-column mma tiles of a warp
  static constexpr int XS = CI + 8;                // elements between halo pixels
  static constexpr int WS = NS + 8;                // elements between w rows of the slice
  static constexpr int WTAP = CI * WS;             // elements of one tap of the slice
  static constexpr int WFLOATS = 9 * WTAP;         // elements of w (geometry's name)
  static constexpr int HALOS = 2;
  static constexpr int CPP = CI / 8;               // 16-byte chunks of a halo pixel
  static constexpr int NPX = NT / CPP;             // halo pixels staged per pass
  static constexpr int WCH = NS / 8;               // 16-byte chunks of a w row's slice
  static_assert(CI % 16 == 0 && NS % 16 == 0 && CO % NS == 0 && NT % CPP == 0,
                "channels the kernel takes");
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// One block per (tile, column slice, lane) unit slot, walking tiles tile0,
// tile0 + gridDim.x, ...: w's slice staged once, the next tile's halo
// staged while this one's products run (two buffers, one barrier a tile).
template <int CI, int NS, int WM, int MINB>
__global__ void __launch_bounds__(CfgCut<CI, NS, WM>::NT, MINB)
conv3x3_bf16_cut_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        bf16* __restrict__ y, int B, int H, int W, int64_t x_lane,
                        int64_t w_lane, Geo g, int tiles) {
  using C = CfgCut<CI, NS, WM>;
  constexpr int CO = C::CO, XS = C::XS, WS = C::WS;
  extern __shared__ float4 smem4[];
  bf16* wbuf = reinterpret_cast<bf16*>(smem4);  // [9][CI][WS]: the slice's NS columns
  bf16* halo = wbuf + C::WFLOATS;               // HALOS buffers of halo_px * XS
  const int halo_elems = g.halo_px * XS;

  const int t = threadIdx.x, n0 = blockIdx.y * NS, lane = blockIdx.z;
  const bf16* xl = x + (int64_t)lane * x_lane;
  const bf16* wl = w + (int64_t)lane * w_lane + n0;
  bf16* yl = y + (int64_t)lane * B * H * W * CO + n0;

  // halo staging as conv3x3_bf16_kernel's, 8 channels per 16-byte chunk
  const int hcc = 8 * (t % C::CPP), hp0 = t / C::CPP;
  const int pc0 = hp0 % g.hc, pr0 = (hp0 / g.hc) % g.hr, pi0 = hp0 / (g.hc * g.hr);
  auto stage_halo = [&](bf16* dst, int tile) {
    int b0, h0, w0;
    tile_origin(tile, g, b0, h0, w0);
    int pc = pc0, pr = pr0, img = pi0;
    for (int p = hp0; p < g.halo_px; p += C::NPX) {
      const int b = b0 + img, h = h0 + pr - 1, ww = w0 + pc - 1;
      const bool ok = b < B && h >= 0 && h < H && ww >= 0 && ww < W;
      cp_async16b(dst + p * XS + hcc, ok ? xl + (((int64_t)b * H + h) * W + ww) * CI + hcc : xl,
                  ok);
      pc += C::NPX;
      while (pc >= g.hc) pc -= g.hc, ++pr;
      while (pr >= g.hr) pr -= g.hr, ++img;
    }
  };
  // taps [tap0, tap0 + 3) of w's slice: row (tap, ci) is NS contiguous
  // elements at w[tap][ci][n0], 16-byte aligned
  auto stage_w = [&](int tap0) {
    for (int e = t; e < 3 * CI * C::WCH; e += C::NT) {
      const int r = tap0 * CI + e / C::WCH, c = 8 * (e % C::WCH);
      cp_async16b(wbuf + r * WS + c, wl + (int64_t)r * CO + c, true);
    }
  };

  const int warp = t / 32, ln = t % 32, gid = ln >> 2, tig = ln & 3;
  const int slots = g.imgs * g.rb * g.cb;
  // A (16 slots x 16 channels, ldmatrix.x4): lanes 0-7 address slots 0-7 at
  // channels 0-7, lanes 8-15 slots 8-15, lanes 16-31 the same at channels
  // 8-15: the a0..a3 registers of the row.col fragment
  int aoff;
  {
    const int s = warp * 16 + (ln & 7) + 8 * ((ln >> 3) & 1);
    const int img = s / (g.rb * g.cb), r = (s / g.cb) % g.rb, c = s % g.cb;
    aoff = (s < slots ? ((img * g.hr + r) * g.hc + c) * XS : 0) + 8 * (ln >> 4);
  }
  // B (16 channels x 16 columns of w, ldmatrix.x4.trans): lanes 0-7
  // address rows (channels) 0-7 and lanes 8-15 rows 8-15 of columns 0-7,
  // lanes 16-31 the same of columns 8-15: b0 b1 of two n8 tiles
  const int boff = ((ln & 7) + 8 * ((ln >> 3) & 1)) * WS + 8 * (ln >> 4);

  const int tile0 = blockIdx.x, stride = gridDim.x;
  const int my_tiles = (tiles - tile0 + stride - 1) / stride;
  // three commit groups: the first tile's halo with taps 0-2, taps 3-5,
  // taps 6-8
  stage_halo(halo, tile0);
  stage_w(0);
  cp_async_commit();
  stage_w(3);
  cp_async_commit();
  stage_w(6);
  cp_async_commit();

#pragma unroll 1
  for (int i = 0; i < my_tiles; ++i) {
    const int tile = tile0 + i * stride;
    const bf16* hb = halo + (i & 1) * halo_elems + aoff;
    float acc[C::N8][4];
#pragma unroll
    for (int n = 0; n < C::N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    if (i == 0)
      cp_async_wait<2>();  // the halo and taps 0-2 have landed
    else
      cp_async_wait<0>();  // this tile's halo has landed
    __syncthreads();       // ... for every thread, and the other buffer is free
    if (i + 1 < my_tiles) stage_halo(halo + ((i + 1) & 1) * halo_elems, tile + stride);
    cp_async_commit();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      if (i == 0 && (tap == 3 || tap == 6)) {  // the first tile waits for w's next taps
        if (tap == 3)
          cp_async_wait<2>();
        else
          cp_async_wait<1>();
        __syncthreads();
      }
      const bf16* ht = hb + ((tap / 3) * g.hc + tap % 3) * XS;
      const bf16* wt = wbuf + tap * C::WTAP + boff;
#pragma unroll
      for (int ks = 0; ks < CI / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, ht + 16 * ks);
#pragma unroll
        for (int n16 = 0; n16 < NS / 16; ++n16) {
          uint32_t b[4];
          ldsm_x4_trans(b, wt + 16 * ks * WS + 16 * n16);
          mma_bf16(acc[2 * n16], a[0], a[1], a[2], a[3], b[0], b[1]);
          mma_bf16(acc[2 * n16 + 1], a[0], a[1], a[2], a[3], b[2], b[3]);
        }
      }
    }

    // c0, c1: row gid, columns 2 tig and + 1; c2, c3: row gid + 8; rounded
    // once to bfloat16 (to nearest even) on store
    int b0, h0, w0;
    tile_origin(tile, g, b0, h0, w0);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = warp * 16 + gid + 8 * hh;
      const int b = b0 + s / (g.rb * g.cb), h = h0 + (s / g.cb) % g.rb, ww = w0 + s % g.cb;
      if (s >= slots || b >= B || h >= H || ww >= W) continue;
      bf16* dst = yl + (((int64_t)b * H + h) * W + ww) * CO + 2 * tig;
#pragma unroll
      for (int n = 0; n < C::N8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(acc[n][2 * hh], acc[n][2 * hh + 1]);
    }
  }
  cp_async_wait<0>();
}

template <int CI, int NS, int WM, int MINB>
cudaError_t plan_bf16_cut(int L, int B, int H, int W, Plan& p) {
  using C = CfgCut<CI, NS, WM>;
  p.g = geometry<C>(B, H, W, p.bytes);
  return plan_blocks(conv3x3_bf16_cut_kernel<CI, NS, WM, MINB>, C::NT, (int64_t)L * C::SLICES,
                     B, p);
}

template <int CI, int NS, int WM, int MINB>
cudaError_t launch_bf16_cut(const bf16* x, const bf16* w, bf16* y, int L, int B, int H, int W,
                            int64_t x_lane, int64_t w_lane, cudaStream_t st) {
  using C = CfgCut<CI, NS, WM>;
  Plan p;
  cudaError_t e = plan_bf16_cut<CI, NS, WM, MINB>(L, B, H, W, p);
  if (e != cudaSuccess) return e;
  conv3x3_bf16_cut_kernel<CI, NS, WM, MINB>
      <<<dim3(p.blocks, C::SLICES, L), C::NT, p.bytes, st>>>(x, w, y, B, H, W, x_lane, w_lane,
                                                             p.g, p.tiles);
  return cudaGetLastError();
}

// --- bfloat16 stem (Ci 3 -> Co 16) on the tensor cores ----------------------
//
// Replaces, for the bf16 stem, conv3x3.cu's conv3x3_fwd_kernel<16, false,
// bf16> (route fma_bf16): K = 27 as two 16-deep slices (11 of the second's
// 16 rows live), A and B staged element by element with a run-time
// division by Ci and a 2-byte load widened to float32 each, a 4 x 4 float32
// FMA tile a thread: 12.4 us at (1, 64, 32, 32, 3, 16) against cuDNN's
// 10.5 (PERF.md). Bound there: (64 x 1,024 x 19 + 432) x 2 = 2,491,232
// bytes, 0.744 us at 3.35 TB/s (54.3 M in-image operations, 0.055 us at the
// bf16 tensor-core rate, 0.81 at the float32 FMA rate); at L = 10, 7.44 us.
//   Here the 27-deep contraction, k = 3 tap + ci, is padded with zeros to
// 32 and runs as two mma.sync m16n8k16 k-steps; the 16 output columns are
// two n8 tiles. A tile is kStemBM = 128 pixel slots, whole image rows (or
// columns of a wider row), at most kStemPx halo pixels a thread; its halo
// sits in shared memory with x's three channels padded to four, a pixel
// one 8-byte word (channel 3 zero). x's pixels are 6 bytes, at 2-byte
// alignment only (an odd pixel starts 2 mod 4 bytes), and cp.async copies
// 4, 8 or 16 aligned bytes, so the halo is read by 2-byte global loads
// into registers and stored as one 8-byte word a pixel: a thread loads the
// next tile's pixels before this tile's products and stores them after,
// so the loads are in flight while the products run (two buffers, one
// barrier a tile). A fragments are gathered from the halo by 2-byte shared
// loads through a per-thread table of the (tap, channel) offsets of its
// eight k values, computed once; k >= 27 reads the pixel's zero channel 3
// against w's zero rows 27-31, exact zeros. w (27 x 16, padded to 32 rows)
// is staged once and its B fragments are held in registers for every tile.
// bf16 x bf16 products are exact in float32, the sums are float32 (the
// tensor core's, 27 terms from zero), each output is rounded once to bf16:
// the TPU kernel's preferred_element_type=float32 and .astype
// (fedml_tpu/ops/conv.py:143-149). No dx: the stem's input needs no
// gradient. On an H100 80GB HBM3 at 700 W (chip_smoke.py conv, PERF.md):
// 4.85 us at (1, 64, 32, 32, 3, 16), 6.4 at L = 2, 19.0 at L = 10, against
// the FMA kernel's 12.5 / 20.5 / 87.0 and cuDNN's 10.5 / 21.1 / 108-158.
// ptxas -v: 123 registers, no spills; cut for eight blocks an SM (64
// registers) it spilled 128 bytes and ran slower (6.5 / 9.5 / 24.4).

constexpr int kStemCI = 3, kStemCO = 16;
constexpr int kStemNT = 128;  // threads: four warps of 32 pixel slots
constexpr int kStemBM = 128;  // pixel slots of a tile
constexpr int kStemPx = 2;    // halo pixels a thread stages
constexpr int kStemHalo = kStemNT * kStemPx;  // halo pixels of a tile, at most
constexpr int kStemK = 32;    // the contraction, padded
// shared memory: two halos of 8-byte pixels, then w
constexpr int kStemSmem = 2 * kStemHalo * 8 + kStemK * kStemCO * 2;

// The stem's tile: as geometry<>'s, with fewer images, rows or columns
// where the halo would pass kStemHalo pixels. ops/conv.py::fwd_tc_geometry
// mirrors it.
Geo stem_geometry(int B, int H, int W) {
  Geo g;
  g.cb = W < kStemBM ? W : kStemBM;
  g.rb = g.cb < W ? 1 : (H < kStemBM / W ? H : kStemBM / W);
  g.imgs = g.rb < H ? 1 : (B < kStemBM / (H * W) ? B : kStemBM / (H * W));
  if (g.imgs < 1) g.imgs = 1;
  auto px = [&] { return g.imgs * (g.rb + 2) * (g.cb + 2); };
  while (px() > kStemHalo && g.imgs > 1) --g.imgs;
  while (px() > kStemHalo && g.rb > 1) --g.rb;
  while (px() > kStemHalo && g.cb > 1) g.cb = (g.cb + 1) / 2;
  g.nh = (H + g.rb - 1) / g.rb;
  g.nw = (W + g.cb - 1) / g.cb;
  g.hr = g.rb + 2;
  g.hc = g.cb + 2;
  g.halo_px = g.imgs * g.hr * g.hc;
  return g;
}

__device__ __forceinline__ uint32_t pack2(unsigned short lo, unsigned short hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

template <int MINB>
__global__ void __launch_bounds__(kStemNT, MINB)
conv3x3_stem_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         bf16* __restrict__ y, int B, int H, int W, int64_t x_lane,
                         int64_t w_lane, Geo g, int tiles) {
  extern __shared__ float4 smem4[];
  uint2* halo = reinterpret_cast<uint2*>(smem4);  // 2 x kStemHalo pixels: channels 0-2, 0
  unsigned short* ws = reinterpret_cast<unsigned short*>(halo + 2 * kStemHalo);  // [k][co]

  const int t = threadIdx.x, lane = blockIdx.y;
  const unsigned short* xl = reinterpret_cast<const unsigned short*>(x) + lane * x_lane;
  const unsigned short* wl = reinterpret_cast<const unsigned short*>(w) + lane * w_lane;
  bf16* yl = y + (int64_t)lane * B * H * W * kStemCO;

  for (int e = t; e < kStemK * kStemCO; e += kStemNT)
    ws[e] = e < 9 * kStemCI * kStemCO ? wl[e] : (unsigned short)0;

  // the halo pixels this thread stages: p = t + kStemNT j, at (img, pr, pc)
  int pimg[kStemPx], prow[kStemPx], pcol[kStemPx];
#pragma unroll
  for (int j = 0; j < kStemPx; ++j) {
    const int p = t + kStemNT * j;
    pcol[j] = p % g.hc;
    prow[j] = (p / g.hc) % g.hr;
    pimg[j] = p < g.halo_px ? p / (g.hc * g.hr) : B;  // B: never in the image
  }
  uint2 next[kStemPx];
  // x[b0 + img, h0 + pr - 1, w0 + pc - 1, :] of the tile's pixels, zero
  // outside the image, into next
  auto load = [&](int tile) {
    int b0, h0, w0;
    tile_origin(tile, g, b0, h0, w0);
#pragma unroll
    for (int j = 0; j < kStemPx; ++j) {
      const int b = b0 + pimg[j], h = h0 + prow[j] - 1, ww = w0 + pcol[j] - 1;
      unsigned short c0 = 0, c1 = 0, c2 = 0;
      if (b < B && h >= 0 && h < H && ww >= 0 && ww < W) {
        const unsigned short* src = xl + (((int64_t)b * H + h) * W + ww) * kStemCI;
        c0 = __ldg(src);
        c1 = __ldg(src + 1);
        c2 = __ldg(src + 2);
      }
      next[j] = make_uint2(pack2(c0, c1), pack2(c2, 0));
    }
  };
  auto store = [&](uint2* dst) {
#pragma unroll
    for (int j = 0; j < kStemPx; ++j)
      if (t + kStemNT * j < g.halo_px) dst[t + kStemNT * j] = next[j];
  };

  const int warp = t / 32, gid = (t % 32) >> 2, tig = t & 3;
  // k offsets (2-byte units in the halo, from the slot's tap (0, 0) pixel)
  // of this thread's A values: k-step s holds k = 16 s + 2 tig, + 1, + 8, + 9
  int koff[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 16 * s + 2 * tig + (q & 1) + 8 * (q >> 1);
      const int tap = k / kStemCI, ci = k % kStemCI;
      koff[s][q] = k < 9 * kStemCI ? ((tap / 3) * g.hc + tap % 3) * 4 + ci : 3;
    }
  // per fragment row (mi, half): the slot's tap (0, 0) pixel, 2-byte units
  int roff[2][2];
  const int slots = g.imgs * g.rb * g.cb;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = warp * 32 + mi * 16 + gid + 8 * hh;
      const int img = s / (g.rb * g.cb), r = (s / g.cb) % g.rb, c = s % g.cb;
      roff[mi][hh] = s < slots ? ((img * g.hr + r) * g.hc + c) * 4 : 0;
    }

  const int tile0 = blockIdx.x, stride = gridDim.x;
  const int my_tiles = (tiles - tile0 + stride - 1) / stride;
  load(tile0);
  store(halo);
  __syncthreads();  // w and the first halo
  // B: b0 (k 2 tig, + 1; column gid of n tile ni), b1 (k + 8, + 9)
  uint32_t bfr[2][2][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = 16 * s + 2 * tig + 8 * r, n = 8 * ni + gid;
        bfr[s][ni][r] = pack2(ws[k * kStemCO + n], ws[(k + 1) * kStemCO + n]);
      }

#pragma unroll 1
  for (int i = 0; i < my_tiles; ++i) {
    const int tile = tile0 + i * stride;
    if (i + 1 < my_tiles) load(tile + stride);  // in flight during the products
    const unsigned short* hb =
        reinterpret_cast<const unsigned short*>(halo + (i & 1) * kStemHalo);
    float acc[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const unsigned short* r0 = hb + roff[mi][0];
      const unsigned short* r1 = hb + roff[mi][1];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t a0 = pack2(r0[koff[s][0]], r0[koff[s][1]]);
        const uint32_t a1 = pack2(r1[koff[s][0]], r1[koff[s][1]]);
        const uint32_t a2 = pack2(r0[koff[s][2]], r0[koff[s][3]]);
        const uint32_t a3 = pack2(r1[koff[s][2]], r1[koff[s][3]]);
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          mma_bf16(acc[mi][ni], a0, a1, a2, a3, bfr[s][ni][0], bfr[s][ni][1]);
      }
    }
    // c0, c1: row gid, columns 2 tig and + 1; c2, c3: row gid + 8
    int b0, h0, w0;
    tile_origin(tile, g, b0, h0, w0);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = warp * 32 + mi * 16 + gid + 8 * hh;
        const int b = b0 + s / (g.rb * g.cb), h = h0 + (s / g.cb) % g.rb, ww = w0 + s % g.cb;
        if (s >= slots || b >= B || h >= H || ww >= W) continue;
        bf16* dst = yl + (((int64_t)b * H + h) * W + ww) * kStemCO + 2 * tig;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * ni) =
              __floats2bfloat162_rn(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
    if (i + 1 < my_tiles) store(halo + ((i + 1) & 1) * kStemHalo);
    __syncthreads();  // the next halo stored; this one's reads done
  }
}

constexpr int kStemMinB = 4;  // blocks per SM the registers are cut for

cudaError_t plan_stem(int L, int B, int H, int W, Plan& p) {
  p.g = stem_geometry(B, H, W);
  p.bytes = kStemSmem;
  return plan_blocks(conv3x3_stem_bf16_kernel<kStemMinB>, kStemNT, L, B, p);
}

// --- float32 stem (Ci 3 -> Co 16) on the tensor cores ----------------------
//
// Replaces, for the float32 stem, conv3x3.cu's conv3x3_fwd_kernel<16, false,
// float> (route fma): K = 27 staged element by element with a run-time
// division by Ci, a 4 x 4 float32 FMA tile a thread: 12.2 us at (1, 64, 32,
// 32, 3, 16) against cuDNN's 10.65 (PERF.md). Bound there: (64 x 1,024 x 19
// + 432) x 4 = 4,982,464 bytes, 1.487 us at 3.35 TB/s (54.3 M in-image
// operations as three TF32 products, 0.33 us at 495 TFLOP/s): bound by bytes.
//   The form is the bf16 stem's (above) in three TF32 products: the same
// tiles (stem_geometry, 128 pixel slots, at most kStemPx halo pixels a
// thread) and the same walk, a thread loading the next tile's pixels into
// registers before this tile's products and storing them after (two
// buffers, one barrier a tile). A halo pixel is x's three channels padded
// to four, one 16-byte word (channel 3 zero); x's pixels are 12 bytes, at
// 4-byte alignment only, so they are read by 4-byte global loads. The
// 27-deep contraction, k = 3 tap + ci, is padded with zeros to 32 and runs
// as four mma.sync m16n8k8 k-steps, each as lo hi, hi lo and hi hi (small
// terms first, tf32x3.cuh's split), into one accumulator from zero a tile:
// 27 terms, as in the bf16 stem. A fragments are gathered from the halo by
// 4-byte shared loads through a per-thread table of the (tap, channel)
// offsets of its k values (k-step s holds k = 8 s + t and 8 s + t + 4),
// computed once, and split where they are loaded; k >= 27 reads the
// pixel's zero channel 3 against w's zero rows 27-31. w (27 x 16, padded to
// 32 rows) is staged once and split once into hi and lo B fragments held in
// registers for every tile. No atomics: y repeats bit for bit. No dx.
// On an H100 80GB HBM3 at 700 W (chip_smoke.py kernels, PERF.md): 5.29 us
// at (1, 64, 32, 32, 3, 16), 7.49 at L = 2, 27.0 at L = 10, against the
// FMA kernel's 12.1 / 20.5 / 87.0 and cuDNN's 10.7 / 21.7 / 400. ptxas -v:
// 128 registers (cut for four blocks an SM), 12 bytes of spills.

// shared memory: two halos of 16-byte pixels, then w as 32 x 16 floats
constexpr int kStemSmemF32 = 2 * kStemHalo * 16 + kStemK * kStemCO * 4;

template <int MINB>
__global__ void __launch_bounds__(kStemNT, MINB)
conv3x3_stem_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         float* __restrict__ y, int B, int H, int W, int64_t x_lane,
                         int64_t w_lane, Geo g, int tiles) {
  extern __shared__ float4 smem4[];
  float4* halo = smem4;  // 2 x kStemHalo pixels: channels 0-2, 0
  float* ws = reinterpret_cast<float*>(halo + 2 * kStemHalo);  // [k][co]

  const int t = threadIdx.x, lane = blockIdx.y;
  const float* xl = x + lane * x_lane;
  const float* wl = w + lane * w_lane;
  float* yl = y + (int64_t)lane * B * H * W * kStemCO;

  for (int e = t; e < kStemK * kStemCO; e += kStemNT)
    ws[e] = e < 9 * kStemCI * kStemCO ? wl[e] : 0.f;

  // the halo pixels this thread stages: p = t + kStemNT j, at (img, pr, pc)
  int pimg[kStemPx], prow[kStemPx], pcol[kStemPx];
#pragma unroll
  for (int j = 0; j < kStemPx; ++j) {
    const int p = t + kStemNT * j;
    pcol[j] = p % g.hc;
    prow[j] = (p / g.hc) % g.hr;
    pimg[j] = p < g.halo_px ? p / (g.hc * g.hr) : B;  // B: never in the image
  }
  float4 next[kStemPx];
  // x[b0 + img, h0 + pr - 1, w0 + pc - 1, :] of the tile's pixels, zero
  // outside the image, into next
  auto load = [&](int tile) {
    int b0, h0, w0;
    tile_origin(tile, g, b0, h0, w0);
#pragma unroll
    for (int j = 0; j < kStemPx; ++j) {
      const int b = b0 + pimg[j], h = h0 + prow[j] - 1, ww = w0 + pcol[j] - 1;
      float c0 = 0.f, c1 = 0.f, c2 = 0.f;
      if (b < B && h >= 0 && h < H && ww >= 0 && ww < W) {
        const float* src = xl + (((int64_t)b * H + h) * W + ww) * kStemCI;
        c0 = __ldg(src);
        c1 = __ldg(src + 1);
        c2 = __ldg(src + 2);
      }
      next[j] = make_float4(c0, c1, c2, 0.f);
    }
  };
  auto store = [&](float4* dst) {
#pragma unroll
    for (int j = 0; j < kStemPx; ++j)
      if (t + kStemNT * j < g.halo_px) dst[t + kStemNT * j] = next[j];
  };

  const int warp = t / 32, gid = (t % 32) >> 2, tig = t & 3;
  // k offsets (floats in the halo, from the slot's tap (0, 0) pixel) of
  // this thread's A values: k-step s holds k = 8 s + tig (a0, a1) and + 4
  // (a2, a3)
  int koff[4][2];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = 8 * s + tig + 4 * q;
      const int tap = k / kStemCI, ci = k % kStemCI;
      koff[s][q] = k < 9 * kStemCI ? ((tap / 3) * g.hc + tap % 3) * 4 + ci : 3;
    }
  // per fragment row (mi, half): the slot's tap (0, 0) pixel, in floats
  int roff[2][2];
  const int slots = g.imgs * g.rb * g.cb;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int s = warp * 32 + mi * 16 + gid + 8 * hh;
      const int img = s / (g.rb * g.cb), r = (s / g.cb) % g.rb, c = s % g.cb;
      roff[mi][hh] = s < slots ? ((img * g.hr + r) * g.hc + c) * 4 : 0;
    }

  const int tile0 = blockIdx.x, stride = gridDim.x;
  const int my_tiles = (tiles - tile0 + stride - 1) / stride;
  load(tile0);
  store(halo);
  __syncthreads();  // w and the first halo
  // B, split once: b0 (k 8 s + tig; column gid of n tile ni), b1 (k + 4)
  uint32_t bh[4][2][2], bl[4][2][2];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        split_tf32(ws[(8 * s + tig + 4 * r) * kStemCO + 8 * ni + gid], bh[s][ni][r],
                   bl[s][ni][r]);

#pragma unroll 1
  for (int i = 0; i < my_tiles; ++i) {
    const int tile = tile0 + i * stride;
    if (i + 1 < my_tiles) load(tile + stride);  // in flight during the products
    const float* hb = reinterpret_cast<const float*>(halo + (i & 1) * kStemHalo);
    float acc[2][2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* r0 = hb + roff[mi][0];
      const float* r1 = hb + roff[mi][1];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        // a0 (row gid, k 8 s + tig), a1 (row gid + 8), a2 and a3 at k + 4
        uint32_t ah[4], al[4];
        split_tf32(r0[koff[s][0]], ah[0], al[0]);
        split_tf32(r1[koff[s][0]], ah[1], al[1]);
        split_tf32(r0[koff[s][1]], ah[2], al[2]);
        split_tf32(r1[koff[s][1]], ah[3], al[3]);
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          mma_tf32(acc[mi][ni], al, bh[s][ni]);
          mma_tf32(acc[mi][ni], ah, bl[s][ni]);
          mma_tf32(acc[mi][ni], ah, bh[s][ni]);
        }
      }
    }
    // c0, c1: row gid, columns 2 tig and + 1; c2, c3: row gid + 8
    int b0, h0, w0;
    tile_origin(tile, g, b0, h0, w0);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int s = warp * 32 + mi * 16 + gid + 8 * hh;
        const int b = b0 + s / (g.rb * g.cb), h = h0 + (s / g.cb) % g.rb, ww = w0 + s % g.cb;
        if (s >= slots || b >= B || h >= H || ww >= W) continue;
        float* dst = yl + (((int64_t)b * H + h) * W + ww) * kStemCO + 2 * tig;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
          *reinterpret_cast<float2*>(dst + 8 * ni) =
              make_float2(acc[mi][ni][2 * hh], acc[mi][ni][2 * hh + 1]);
      }
    if (i + 1 < my_tiles) store(halo + ((i + 1) & 1) * kStemHalo);
    __syncthreads();  // the next halo stored; this one's reads done
  }
}

cudaError_t plan_stem_f32(int L, int B, int H, int W, Plan& p) {
  p.g = stem_geometry(B, H, W);
  p.bytes = kStemSmemF32;
  return plan_blocks(conv3x3_stem_tf32_kernel<kStemMinB>, kStemNT, L, B, p);
}

// a plan entry's out: {blocks in all, tiles a block walks at most, dynamic
// shared-memory bytes, SMs, blocks an SM holds}; 0
int put_plan(const Plan& p, int* out) {
  out[0] = p.blocks * p.units;
  out[1] = p.rounds;
  out[2] = p.bytes;
  out[3] = p.sms;
  out[4] = p.per_sm;
  return 0;
}

// --- bfloat16 weight gradient: mma.sync m16n8k16 over pixels --------------

// dw[tap, ci, co] = sum over the pixels m of x[m + shift(tap), ci] dy[m, co]:
// a product whose M is the 9 Ci rows of dw, N its Co columns and K the
// pixels. A tile is up to kDwSlots pixel slots of one image: whole rows
// (as many as fit) or kDwSlots columns of one row; its (rows + 2) x (cols +
// 2) halo of x and its dy rows are staged in shared memory, pixel-major, and
// each 16-slot k-step reads both with ldmatrix.trans.
constexpr int kDwSlots = 128;

// Ci = Co channels; warps of MT 16-row tiles of dw each, all Co columns; NW
// warps; a block covers ROWS of the 9 Ci rows, so a lane takes RTILES
// blocks along the rows
template <int CI, int MT, int NW>
struct DwCfg {
  static constexpr int CO = CI;
  static constexpr int NT = 32 * NW;           // threads
  static constexpr int ROWS = 16 * MT * NW;    // rows of dw one block covers
  static constexpr int RTILES = 9 * CI / ROWS;
  static constexpr int N8 = CO / 8;            // 8-column mma tiles
  // elements between staged pixels (x and dy alike): 2 XS bytes = 16, 48 or
  // 80 mod 128, so the eight 16-byte rows of an ldmatrix matrix (eight
  // consecutive pixels) fall in distinct banks
  static constexpr int XS = CI + 8;
  static_assert(CI % 16 == 0 && (9 * CI) % ROWS == 0, "channels the kernel takes");
};

// A dw tile: rb rows x cb columns of one image; tiles along h and w; the
// halo's rows and columns; 16-slot k-steps
struct DwGeo {
  int rb, cb, nh, nw, hr, hc, steps;
};

// ops/conv.py::dw_tc_geometry mirrors this
DwGeo dw_geometry(int H, int W) {
  DwGeo g;
  g.cb = W < kDwSlots ? W : kDwSlots;
  g.rb = g.cb < W ? 1 : (H < kDwSlots / W ? H : kDwSlots / W);
  g.nh = (H + g.rb - 1) / g.rb;
  g.nw = (W + g.cb - 1) / g.cb;
  g.hr = g.rb + 2;
  g.hc = g.cb + 2;
  g.steps = (g.rb * g.cb + 15) / 16;
  return g;
}

// One block per (tile span s, row tile, lane): rows [ROWS rt, ROWS (rt + 1))
// of dw summed over the span's tiles into part[lane, s]. The next tile is
// staged while this one's products run (two buffers, one barrier a tile).
template <int CI, int MT, int NW, int MINB>
__global__ void __launch_bounds__(DwCfg<CI, MT, NW>::NT, MINB)
conv3x3_dw_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                       float* __restrict__ part, int B, int H, int W, int64_t x_lane, DwGeo g,
                       int tiles, int span, int splits) {
  using C = DwCfg<CI, MT, NW>;
  constexpr int CO = C::CO, XS = C::XS;
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int halo_elems = g.hr * g.hc * XS;
  const int stage_elems = halo_elems + 16 * g.steps * XS;  // the halo, then dy's slots

  const int t = threadIdx.x, s = blockIdx.x, lane = blockIdx.z;
  const bf16* xl = x + (int64_t)lane * x_lane;
  const bf16* gl = dy + (int64_t)lane * B * H * W * CO;
  const int t_begin = s * span, t_end = t_begin + span < tiles ? t_begin + span : tiles;
  const int slots = g.rb * g.cb;

  // tile -> its halo (pixel (pr, pc) holds x[b, h0 + pr - 1, w0 + pc - 1],
  // zero outside the image) and its dy slots (slot (r, c): dy[b, h0 + r,
  // w0 + c], zero past the image and past the tile's slots)
  auto stage = [&](bf16* dst, int tile) {
    const int w0 = (tile % g.nw) * g.cb;
    tile /= g.nw;
    const int h0 = (tile % g.nh) * g.rb, b = tile / g.nh;
    for (int e = t; e < g.hr * g.hc * (CI / 8); e += C::NT) {
      const int p = e / (CI / 8), c = 8 * (e % (CI / 8));
      const int h = h0 + p / g.hc - 1, w = w0 + p % g.hc - 1;
      const bool ok = h >= 0 && h < H && w >= 0 && w < W;
      cp_async16b(dst + p * XS + c, ok ? xl + (((int64_t)b * H + h) * W + w) * CI + c : xl, ok);
    }
    bf16* gd = dst + halo_elems;
    for (int e = t; e < 16 * g.steps * (CO / 8); e += C::NT) {
      const int sl = e / (CO / 8), c = 8 * (e % (CO / 8));
      const int h = h0 + sl / g.cb, w = w0 + sl % g.cb;
      const bool ok = sl < slots && h < H && w < W;
      cp_async16b(gd + sl * XS + c, ok ? gl + (((int64_t)b * H + h) * W + w) * CO + c : gl, ok);
    }
  };

  const int warp = t / 32, ln = t % 32, gid = ln >> 2, tig = ln & 3;
  const int mt0 = blockIdx.y * (MT * NW) + warp * MT;  // this warp's first 16-row tile of dw
  // A (x^T, 16 channels x 16 slots): lanes 0-7 address rows (slots) 0-7 of
  // channels 0-7, lanes 8-15 the same slots' channels 8-15, lanes 16-31 slots
  // 8-15; transposed, these are the a0..a3 registers of the fragment
  int aoff[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mt = mt0 + i, tap = mt / (CI / 16);
    aoff[i] = ((tap / 3) * g.hc + tap % 3) * XS + 16 * (mt % (CI / 16)) + 8 * ((ln >> 3) & 1);
  }
  int hoff[kDwSlots / 16];  // per k-step: the halo pixel of this lane's slot, tap (0, 0)
#pragma unroll
  for (int j = 0; j < kDwSlots / 16; ++j) {
    const int sl = 16 * j + (ln & 7) + 8 * (ln >> 4);
    hoff[j] = sl < slots ? ((sl / g.cb) * g.hc + sl % g.cb) * XS : 0;
  }
  // B (dy, 16 slots x 16 columns): lanes 0-7 slots 0-7, 8-15 slots 8-15 of
  // columns 0-7, lanes 16-31 the same of columns 8-15: b0 b1 of two n8 tiles
  const int boff = ((ln & 7) + 8 * ((ln >> 3) & 1)) * XS + 8 * (ln >> 4);

  float acc[MT][C::N8][4], sacc[MT][C::N8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < C::N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = sacc[i][n][e] = 0.f;

  if (t_begin < t_end) stage(smem, t_begin);
  cp_async_commit();
#pragma unroll 1
  for (int i = t_begin; i < t_end; ++i) {
    const bf16* hb = smem + ((i - t_begin) & 1) * stage_elems;
    const bf16* gb = hb + halo_elems;
    cp_async_wait<0>();  // this tile has landed
    __syncthreads();     // ... for every thread, and the other buffer is free
    if (i + 1 < t_end) stage(smem + ((i + 1 - t_begin) & 1) * stage_elems, i + 1);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < kDwSlots / 16; ++j) {
      if (j < g.steps) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) ldsm_x4_trans(a[mi], hb + hoff[j] + aoff[mi]);
#pragma unroll
        for (int n16 = 0; n16 < CO / 16; ++n16) {
          uint32_t b[4];
          ldsm_x4_trans(b, gb + 16 * j * XS + boff + 16 * n16);
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mma_bf16(sacc[mi][2 * n16], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b[0], b[1]);
            mma_bf16(sacc[mi][2 * n16 + 1], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b[2], b[3]);
          }
        }
      }
    }
    // the tile's sums, from zero, join the running sum (see the design comment)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int n = 0; n < C::N8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mi][n][e] += sacc[mi][n][e];
          sacc[mi][n][e] = 0.f;
        }
  }
  cp_async_wait<0>();

  // c0, c1: row gid, columns 2 tig and + 1; c2, c3: row gid + 8
  float* out = part + ((int64_t)lane * splits + s) * 9 * CI * CO;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* dst = out + (int64_t)(16 * (mt0 + mi) + gid + 8 * hh) * CO + 2 * tig;
#pragma unroll
      for (int n = 0; n < C::N8; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(acc[mi][n][2 * hh], acc[mi][n][2 * hh + 1]);
    }
}

template <int CI, int MT, int NW, int MINB>
cudaError_t launch_dw_bf16(const bf16* x, const bf16* dy, float* part, bf16* out, int L, int B,
                           int H, int W, int64_t x_lane, int span, int splits, cudaStream_t st) {
  using C = DwCfg<CI, MT, NW>;
  const DwGeo g = dw_geometry(H, W);
  const int64_t tiles = (int64_t)B * g.nh * g.nw;
  if (tiles > 0x7fffffff || (int64_t)(splits - 1) * span >= tiles ||
      (int64_t)splits * span < tiles)
    return cudaErrorInvalidValue;
  const int bytes = 2 * (g.hr * g.hc + 16 * g.steps) * C::XS * (int)sizeof(bf16);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = conv3x3_dw_bf16_kernel<CI, MT, NW, MINB>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((unsigned)splits, (unsigned)C::RTILES, (unsigned)L), C::NT, bytes, st>>>(
      x, dy, part, B, H, W, x_lane, g, (int)tiles, span, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_dw_reduce<bf16>(part, 9LL * CI * CI, splits, L, out, st);
}

// the channel counts this kernel takes (ops/conv.py::fwd_route)
bool tc_channels(int Ci, int Co) { return Ci == Co && (Ci == 16 || Ci == 32 || Ci == 64); }

}  // namespace

// y (L, B, H, W, Co) = conv3x3(x (L | 1, B, H, W, Ci), w (L | 1, 3, 3, Ci, Co))
// for Ci = Co in {16, 32, 64}; x and w contiguous per lane and 16-byte
// aligned, x_lane / w_lane the lane strides in floats (0 to broadcast one
// lane). The same arguments as conv3x3.cu's fedml_conv3x3_fwd. Returns the
// cudaError_t of the launch.
extern "C" int fedml_conv3x3_fwd_sm90(const float* x, const float* w, float* y, int L, int B,
                                      int H, int W, int Ci, int Co, long long x_lane,
                                      long long w_lane, void* stream) {
  if (!tc_channels(Ci, Co) || L <= 0 || L > 65535 || B <= 0 || H <= 0 || W <= 0 ||
      (int64_t)H * W > (1LL << 30) || x_lane < 0 || w_lane < 0 ||
      ((uintptr_t)x & 15) || ((uintptr_t)w & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // <Ci, warps along the pixels, w resident, taps unrolled, blocks per SM
  // the registers are cut for>: at the path's shapes Ci 16 keeps w (11.5 KB)
  // and two halos in 51 KB, 4 blocks per SM; Ci 32 w (41.5 KB) and two halos
  // in 99 KB, 2 blocks; Ci 64's w (157 KB padded) streams through the
  // two-tap ring beside one halo, 64 KB, 3 blocks
  switch (Ci) {
    case 16: return (int)launch<16, 4, true, true, 4>(x, w, y, L, B, H, W, x_lane, w_lane, st);
    case 32: return (int)launch<32, 4, true, false, 2>(x, w, y, L, B, H, W, x_lane, w_lane, st);
    default: return (int)launch<64, 2, false, false, 3>(x, w, y, L, B, H, W, x_lane, w_lane, st);
  }
}

// The same for bfloat16 x, w and y (use_bf16): one bf16 mma.sync product per
// k-step with float32 sums, y rounded once to bfloat16. Ci = Co in {16, 32,
// 64}; x and w contiguous per lane and 16-byte aligned, lane strides in
// elements.
extern "C" int fedml_conv3x3_fwd_sm90_bf16(const bf16* x, const bf16* w, bf16* y, int L, int B,
                                           int H, int W, int Ci, int Co, long long x_lane,
                                           long long w_lane, void* stream) {
  if (!tc_channels(Ci, Co) || L <= 0 || L > 65535 || B <= 0 || H <= 0 || W <= 0 ||
      (int64_t)H * W > (1LL << 30) || x_lane < 0 || w_lane < 0 ||
      ((uintptr_t)x & 15) || ((uintptr_t)w & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // <Ci, warps along the pixels, blocks per SM>: 128-slot tiles; w resident
  // (4.6, 27.6, 92 KB with its padding) beside two halos
  switch (Ci) {
    case 16: return (int)launch_bf16<16, 4, 2>(x, w, y, L, B, H, W, x_lane, w_lane, st);
    case 32: return (int)launch_bf16<32, 4, 2>(x, w, y, L, B, H, W, x_lane, w_lane, st);
    default: return (int)launch_bf16_cut<64, 32, 4, 3>(x, w, y, L, B, H, W, x_lane, w_lane, st);
  }
}

// The same for the bf16 stem, Ci 3 -> Co 16: x, w and y 2-byte aligned,
// lane strides in elements.
extern "C" int fedml_conv3x3_stem_sm90_bf16(const bf16* x, const bf16* w, bf16* y, int L,
                                            int B, int H, int W, int Ci, int Co,
                                            long long x_lane, long long w_lane, void* stream) {
  if (Ci != kStemCI || Co != kStemCO || L <= 0 || L > 65535 || B <= 0 || H <= 0 || W <= 0 ||
      (int64_t)H * W > (1LL << 30) || x_lane < 0 || w_lane < 0 || ((uintptr_t)y & 3))
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = plan_stem(L, B, H, W, p);
  if (e != cudaSuccess) return (int)e;
  conv3x3_stem_bf16_kernel<kStemMinB><<<dim3(p.blocks, L), kStemNT, p.bytes,
                                        (cudaStream_t)stream>>>(x, w, y, B, H, W, x_lane,
                                                                w_lane, p.g, p.tiles);
  return (int)cudaGetLastError();
}

// The same for the float32 stem, Ci 3 -> Co 16 (three TF32 products): x
// and w 4-byte aligned, y 8-byte aligned, lane strides in floats.
extern "C" int fedml_conv3x3_stem_sm90(const float* x, const float* w, float* y, int L, int B,
                                       int H, int W, int Ci, int Co, long long x_lane,
                                       long long w_lane, void* stream) {
  if (Ci != kStemCI || Co != kStemCO || L <= 0 || L > 65535 || B <= 0 || H <= 0 || W <= 0 ||
      (int64_t)H * W > (1LL << 30) || x_lane < 0 || w_lane < 0 || ((uintptr_t)y & 7))
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = plan_stem_f32(L, B, H, W, p);
  if (e != cudaSuccess) return (int)e;
  conv3x3_stem_tf32_kernel<kStemMinB><<<dim3(p.blocks, L), kStemNT, p.bytes,
                                        (cudaStream_t)stream>>>(x, w, y, B, H, W, x_lane,
                                                                w_lane, p.g, p.tiles);
  return (int)cudaGetLastError();
}

// The launch plan of the float32 stem at (L, B, H, W, 3, 16), as
// fedml_conv3x3_fwd_sm90_bf16_plan gives the bf16 forwards'.
extern "C" int fedml_conv3x3_stem_sm90_plan(int L, int B, int H, int W, int Ci, int Co,
                                            int* out) {
  if (L <= 0 || B <= 0 || H <= 0 || W <= 0 || Ci != kStemCI || Co != kStemCO)
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = plan_stem_f32(L, B, H, W, p);
  return e == cudaSuccess ? put_plan(p, out) : (int)e;
}

// The launch plan of the bf16 tensor-core forward at (L, B, H, W, Ci, Co),
// Ci = Co in {16, 32, 64} or the stem's 3 -> 16: out = {blocks in all,
// tiles a block walks at most, dynamic shared-memory bytes, SMs, blocks an
// SM holds}. ops/conv.py::fwd_tc_plan mirrors the first three.
extern "C" int fedml_conv3x3_fwd_sm90_bf16_plan(int L, int B, int H, int W, int Ci, int Co,
                                                int* out) {
  if (L <= 0 || B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e;
  if (Ci == kStemCI && Co == kStemCO)
    e = plan_stem(L, B, H, W, p);
  else if (!tc_channels(Ci, Co))
    return (int)cudaErrorInvalidValue;
  else if (Ci == 16)
    e = plan_bf16<16, 4, 2>(L, B, H, W, p);
  else if (Ci == 32)
    e = plan_bf16<32, 4, 2>(L, B, H, W, p);
  else
    e = plan_bf16_cut<64, 32, 4, 3>(L, B, H, W, p);
  return e == cudaSuccess ? put_plan(p, out) : (int)e;
}

// dw (L, 3, 3, Ci, Co) = sum over (B, H, W) of patches(x)^T dy per lane, for
// bfloat16 x (L | 1, B, H, W, Ci) (lane stride x_lane elements, 0 to
// broadcast) and dy (L, B, H, W, Co), Ci = Co in {16, 32, 64}, both 16-byte
// aligned: conv3x3.cu's fedml_conv3x3_dw_bf16 arguments, with the
// contraction cut into `splits` spans of `span` pixel tiles
// (ops/conv.py::dw_tc_geometry) instead of pixels; part is (L, splits, 9 Ci,
// Co) float32 scratch. float32 sums, dw rounded once to bfloat16. Returns the
// cudaError_t.
extern "C" int fedml_conv3x3_dw_sm90_bf16(const bf16* x, const bf16* dy, float* part,
                                          bf16* dw_out, int L, int B, int H, int W, int Ci,
                                          int Co, long long x_lane, long long span, int splits,
                                          void* stream) {
  if (!tc_channels(Ci, Co) || L <= 0 || L > 65535 || B <= 0 || H <= 0 || W <= 0 ||
      (int64_t)B * H * W >= (1LL << 31) || x_lane < 0 || span <= 0 || span > 0x7fffffff ||
      splits <= 0 || splits > 65535 || ((uintptr_t)x & 15) || ((uintptr_t)dy & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // <Ci, 16-row tiles per warp, warps, blocks per SM the registers are cut
  // for>: Ci 16 and 32 a block covers all 9 Ci rows, Ci 64 a third of them
  switch (Ci) {
    case 16:
      return (int)launch_dw_bf16<16, 3, 3, 4>(x, dy, part, dw_out, L, B, H, W, x_lane,
                                              (int)span, splits, st);
    case 32:
      return (int)launch_dw_bf16<32, 3, 6, 2>(x, dy, part, dw_out, L, B, H, W, x_lane,
                                              (int)span, splits, st);
    default:
      return (int)launch_dw_bf16<64, 2, 6, 2>(x, dy, part, dw_out, L, B, H, W, x_lane,
                                              (int)span, splits, st);
  }
}
