// The wide-window resize for Hopper (sm_90a): every plan whose source band
// fits no width of the tiled kernel (resize_tiled.cuh), among them the exact
// plans whose column windows are too wide for a 16-row work tile of the
// windowed kernel (cuda_resize.work_rows < 16): Area 8192x4 -> 16x4 (512 X
// taps, one window of 8192 columns), the thumbnails Area 4096x4096 ->
// 128x128, 3840x2160 -> 128x72, Area and Lanczos3 7680x4320 -> 240x135, Area
// 40960x8 -> 1024x8, and the tall-band thumbnails whose 16 rows fit the
// windowed kernel but whose band fits no tiled width: Lanczos3 3840x2160 ->
// 256x144, 1920x1080 -> 128x72, 7680x4320 -> 480x270, the 4K -> 1920x16
// strips.  Byte equal to the windowed kernel and to golden/numpy_ref.py, in
// the exact instantiations of resize_fused.cu: kWrap16 (Lanczos: int16 work
// rows, Y-border renormalisation, int32-wrapping X sums, border-column
// divide) and u16 (Area, Linear: u16 work rows, (sums + half) >> out_shift);
// and in the relaxed form (kRelaxed, precision="relaxed"), byte equal to the
// windowed kernel's relaxed form and to torch_resize.resize_relaxed: the
// same exact Y pass, the work value rounded to bf16, a float32 X pass over
// the relaxed plane and then the residual plane where the plan has one, tap
// by tap in order with each product and add rounded on its own, truncated
// to int32, then the wrap16 epilogue.
//
// Replaces the TPU kernel libiqo_tpu/ops/pallas_resize.py _make_padless_fn
// (pl.pallas_call at :1687) on these plans: K3, the Y pass over byte planes
// for taps outside s8 (:843-847, 1374-1396), and K4, the X pass over u16
// work rows (:956-962, 1448-1456), and K1+K2's wrap16 epilogue; relaxed,
// K7's X scheme (:943-1024, 1486-1505).
//
// What bounds it on the H100: the bytes, each source byte read once (2.5-12
// us for the thumbnails at 3.35 TB/s), and for Lanczos3 8K -> 240x135 about
// as long again in int32 multiply-adds (192 Y taps an output row).  The
// windowed kernel's wide-window walk, which these plans took before, is held
// back by three things: one block owns a column tile of 128 outputs and its
// whole window, so such plans run 1-22 blocks on 132 SMs; one thread walks
// each work element's Y taps and each output's 512-1024 X taps in series;
// and every tap is a dependent load of the tap tables plus a byte load.
//
// What the design does about it:
// * Fill the card.  The host (cuda_resize.wide_layout) picks a tile of tr
//   output rows and tc output columns per plan, halving tc and tr in turn
//   from 16 x 128 until the grid holds about two blocks an SM (264) or every
//   output has its own block.  Narrow column tiles have narrow windows, so
//   shared memory no longer caps the rows: the work tile is tr x wp int32.
// * Wide, reused loads.  The Y pass walks items of (output row, 16 work
//   columns, slice of the Y taps): one 16-byte load a tap (byte loads
//   where the source's rows are not 16-byte aligned), the tap's
//   coefficient and source row from the block's copy of the Y table in shared
//   memory.  u16 plans multiply two bytes a word at once: their taps are
//   >= 0 and sum to <= 256 an output row, so each 16-bit lane of c * (bytes
//   0 and 2) holds its sum without a carry into the next lane.  wrap16 plans
//   take one byte permute and one multiply-add a byte.
// * Split the sums.  Where one thread would walk 128 or more Y taps
//   (cuda_resize.WIDE_SLICE_TAPS; Lanczos3 8K -> 240x135: 192) and the
//   block's items are too few for its threads, the Y taps split into ks
//   slices whose uint32 sums meet by shared-memory atomicAdd into the
//   zeroed work tile; the int16 wrap and the Y-border
//   renormalisation then run once, on the complete sum.  Each output's X taps
//   split over a group of `group` lanes of a warp (tap t on lane t % group),
//   met by butterfly shuffles; the epilogue runs once on the complete sum.
//   uint32 addition is associative mod 2^32, so any split is exact, and each
//   output's sum stays inside one block: no global atomics, one launch.
//   Float addition is not associative, so the relaxed form keeps the Y
//   split (its sums are the exact uint32 ones, rounded once complete) and
//   runs each output's X taps on one thread (group 1), in tap order.
// * Intended wraps go through uint32 (signed overflow is undefined in C++);
//   int16 narrowing, two's-complement reinterpretation and the arithmetic
//   shift are written out, as in resize_fused.cu.
//
// The s8 Y form (resize_wide_kernel_s8y, cuda_resize.wide_s8): exact wrap16
// plans whose merged Y matrix fits s8, whose source rows each feed 5 or
// more Y taps, whose bands are at most 1024 rows a row tile and whose frame
// has at least 66 blocks (the Lanczos3 thumbnails; Area, Lanczos2, the 4K ->
// 1920x16 strips and 1920x1080 -> 128x72 keep the scalar pass, which was
// faster there).  The scalar Y
// pass above issues, per tap and 16 work columns, a dependent 16-byte load,
// 16 byte permutes and 16 IMADs: at 4K ->
// 256x144 (90 taps) ~58 M IMADs a frame, ~3.7 us of issue slots on 132 SMs,
// already above the 2.49 us bytes bound, with 45 % of the threads idle
// through the pass.  The tiled kernel's s8 Y pass (resize_tiled.cuh) does
// that work on the tensor cores, but it stages a row tile's whole band, and
// at 15:1 (320 rows of 640 bytes at TW 32) the band fits no width.  So:
// * One block computes TH 16 output rows x TW (32 or 16) columns from the
//   tiled kernel's row and column records (cuda_resize.tiled_layout at TW,
//   the X pass per tap): A, the row tile's merged 16 x k_rows s8 Y matrix,
//   and the records stay in shared memory.
// * The band streams through a ring of `stages` slabs of 32 rows (one
//   m16n8k32 K step), 16-byte cp.async pieces swizzled as the tiled band
//   (byte loads at the plane's edges and where the row pitch is not a
//   multiple of 16); slab k + stages - 1 is copied while slab k feeds the
//   dot, one barrier a slab.  Its height no longer decides the fit, but a
//   block streams its slabs in series: a 2176-row band with few blocks (the
//   strips, 60 a frame) is slower than the scalar pass.
// * Each warp holds the s32 sums of up to kS8Groups 32-column groups of the
//   band in registers over the whole stream (B rebased by ^ 0x80); after the
//   last slab the row's 128 * sum cy is added back in uint32 and the wrap
//   and the border renormalisation run once, into the 16-bit work tile,
//   which takes the ring's place.  The X pass is the tiled kernel's per tap.
// * The host sizes the ring so that two blocks share an SM (cuda_resize.
//   WIDE_S8_SMEM); the bytes then bound it: the source read once from HBM and
//   ~1.5x over from L2 (the windows' overlap at TH 16), the dot under 1 us.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "exec.cuh"
#include "resize_tiled.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroupCols = 16;    // work columns a Y item computes: one 16-byte load

__device__ __forceinline__ int32_t wrap16(uint32_t v) {
  return static_cast<int32_t>(v & 0xFFFFu) -
         static_cast<int32_t>((v & 0x8000u) << 1);
}

__device__ __forceinline__ int32_t as_i32(uint32_t v) {
  return v < 0x80000000u ? static_cast<int32_t>(v)
                         : -static_cast<int32_t>(~v) - 1;
}

__device__ __forceinline__ int32_t shift_floor(int32_t v, int k) {
  return v >= 0 ? (v >> k) : ~((~v) >> k);
}

// The 16 source bytes of columns [c, c + 16) of `row` as four words: one
// 16-byte load (V = 16, row + c 16-byte aligned), or byte loads (V = 1).
// Bytes at or past the row's end read as zeros with byte loads; a 16-byte
// piece that starts inside the row brings the bytes after the row's end
// along (they lie in the same aligned 16 bytes, so in memory the row's page
// holds), and those columns are never read by the X pass.
template <int V>
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ row, int c,
                                        int src_w) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (V == 16) {
    if (c < src_w) w = __ldg(reinterpret_cast<const uint4*>(row + c));
  } else {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (c + k < src_w) v[k >> 2] |= static_cast<uint32_t>(__ldg(row + c + k)) << (8 * (k & 3));
    w = make_uint4(v[0], v[1], v[2], v[3]);
  }
  return w;
}

// One Y item: the uint32 sums over taps [t0, t1) of output row r (of the
// block) for work columns [col, col + 16), into s[0..16).
template <bool kWrap16, int V>
__device__ __forceinline__ void y_item(
    uint32_t (&s)[kGroupCols], const uint8_t* __restrict__ fsrc,
    long long row_stride, int src_h, int src_w, int col, const int32_t* cyr,
    int ys, int t0, int t1) {
  if constexpr (kWrap16) {
    uint32_t acc[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = 0u;
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
      const uint32_t c = static_cast<uint32_t>(cyr[t]);
      const int row = min(max(ys + t, 0), src_h - 1);
      const uint4 w = load16<V>(fsrc + row * row_stride, col, src_w);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[4 * q + k] += c * __byte_perm(words[q], 0u, 0x4440u | k);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) s[k] = acc[k];
  } else {
    // bytes 0, 2 and 1, 3 of each word in 16-bit lanes: taps >= 0 summing
    // to <= 256 keep every lane's sum <= 65280
    uint32_t acc[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0u;
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
      const uint32_t c = static_cast<uint32_t>(cyr[t]);
      const int row = min(max(ys + t, 0), src_h - 1);
      const uint4 w = load16<V>(fsrc + row * row_stride, col, src_w);
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[2 * q] += c * (words[q] & 0x00FF00FFu);
        acc[2 * q + 1] += c * __byte_perm(words[q], 0u, 0x4341u);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s[4 * q] = acc[2 * q] & 0xFFFFu;
      s[4 * q + 1] = acc[2 * q + 1] & 0xFFFFu;
      s[4 * q + 2] = acc[2 * q] >> 16;
      s[4 * q + 3] = acc[2 * q + 1] >> 16;
    }
  }
}

// A complete Y sum -> the work value: int16 narrowing and the border-row
// renormalisation trunc(w * y_bias / d) with kWrap16 (d != 0 on border rows).
template <bool kWrap16>
__device__ __forceinline__ int32_t work_value(uint32_t acc, int32_t d, int y_bias) {
  if constexpr (kWrap16) {
    int32_t w = wrap16(acc);
    if (d != 0) w = wrap16(static_cast<uint32_t>((w * y_bias) / d));  // |w*y_bias| < 2^31
    return w;
  } else {
    return static_cast<int32_t>(acc);   // <= 65280
  }
}

// The value the work tile holds: the work value, or with kRelaxed its bf16
// rounding as float32 bits (|w| <= 65280 is exact in float32 first).
template <bool kWrap16, bool kRelaxed>
__device__ __forceinline__ int32_t stored(uint32_t acc, int32_t d, int y_bias) {
  const int32_t w = work_value<kWrap16>(acc, d, y_bias);
  if constexpr (kRelaxed) {
    return __float_as_int(__bfloat162float(__float2bfloat16_rn(static_cast<float>(w))));
  } else {
    return w;
  }
}

// sum_t plane[t] * work[clamp(x0 + t) - lo_al] in float32, in tap order,
// without contraction, truncated toward zero (resize_fused.cu float_taps).
__device__ __forceinline__ uint32_t float_taps(const int32_t* plane, const int32_t* wrow,
                                               int x0, int taps, int src_w, int lo_al) {
  float acc = 0.0f;
  for (int t = 0; t < taps; ++t)
    acc = __fadd_rn(acc, __fmul_rn(__int_as_float(plane[t]),
                                   __int_as_float(wrow[min(max(x0 + t, 0), src_w - 1) - lo_al])));
  return static_cast<uint32_t>(__float2int_rz(acc));
}

// Tables are output-major: cy[i * taps_y + t], cx[j * planes * taps_x + t]
// (with kRelaxed the planes' float32 bits, each output's relaxed taps then
// its residual taps where planes is 2); ys/xs
// the first (unclamped) source row/column of each output row/column, whose
// taps read clamp(start + t) (taps outside the source are zero in the plan);
// ydiv/xdiv the border divisors (0 on main outputs; read with kWrap16);
// win[2 ct], win[2 ct + 1] the source columns [lo, hi) that column tile ct's
// clamped taps read.  Block b takes row tile b / n_ct and column tile
// b % n_ct, frame blockIdx.z.
template <bool kWrap16, int V, bool kRelaxed>
__global__ void __launch_bounds__(kThreads, 2) resize_wide_kernel(
    const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
    long long src_frame_stride, long long src_row_stride, int src_h, int src_w,
    int dst_h, int dst_w,
    const int32_t* __restrict__ cy, const int32_t* __restrict__ ys,
    const int32_t* __restrict__ ydiv, int taps_y, int y_bias,
    const int32_t* __restrict__ cx, const int32_t* __restrict__ xs,
    const int32_t* __restrict__ xdiv, int taps_x, int planes,
    const int32_t* __restrict__ win, int n_ct, int tc, int tr, int ks,
    int group, int wp, int out_shift) {
  // work [tr][wp], then the block's Y table [tr][taps_y], X table
  // [tc][planes * taps_x], row starts [tr] and column starts [tc]
  extern __shared__ __align__(16) int32_t smem[];
  const int xrow = planes * taps_x;
  int32_t* work = smem;
  int32_t* s_cy = work + tr * wp;
  int32_t* s_cx = s_cy + tr * taps_y;
  int32_t* s_ys = s_cx + tc * xrow;
  int32_t* s_xs = s_ys + tr;

  const int ct = blockIdx.x % n_ct;
  const int r0 = (blockIdx.x / n_ct) * tr;
  const int c0 = ct * tc;
  const int rows = min(tr, dst_h - r0);
  const int cols = min(tc, dst_w - c0);
  const uint8_t* fsrc = src + static_cast<long long>(blockIdx.z) * src_frame_stride;
  uint8_t* fdst = dst + static_cast<long long>(blockIdx.z) * dst_h * dst_w;
  const int lo = __ldg(win + 2 * ct);
  const int lo_al = lo & ~(V - 1);                 // loads start V-aligned
  const int ng = (__ldg(win + 2 * ct + 1) - lo_al + kGroupCols - 1) / kGroupCols;

  for (int e = threadIdx.x; e < rows * taps_y; e += kThreads)
    s_cy[e] = __ldg(cy + static_cast<long long>(r0) * taps_y + e);
  for (int e = threadIdx.x; e < cols * xrow; e += kThreads)
    s_cx[e] = __ldg(cx + static_cast<long long>(c0) * xrow + e);
  for (int e = threadIdx.x; e < rows; e += kThreads) s_ys[e] = __ldg(ys + r0 + e);
  for (int e = threadIdx.x; e < cols; e += kThreads) s_xs[e] = __ldg(xs + c0 + e);
  if (ks > 1)
    for (int e = threadIdx.x; e < rows * wp; e += kThreads) work[e] = 0;
  __syncthreads();

  // Y pass: items (slice, row, 16-column group), the groups fastest
  const int slice = (taps_y + ks - 1) / ks;
  for (int e = threadIdx.x; e < ks * rows * ng; e += kThreads) {
    const int g = e % ng;
    const int rk = e / ng;
    const int r = rk % rows;
    const int t0 = (rk / rows) * slice;
    const int t1 = min(t0 + slice, taps_y);
    uint32_t s[kGroupCols];
    y_item<kWrap16, V>(s, fsrc, src_row_stride, src_h, src_w, lo_al + kGroupCols * g,
                       s_cy + r * taps_y, s_ys[r], t0, t1);
    int32_t* wrow = work + r * wp + kGroupCols * g;
    if (ks == 1) {
      const int32_t d = kWrap16 ? __ldg(ydiv + r0 + r) : 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        reinterpret_cast<int4*>(wrow)[q] = make_int4(
            stored<kWrap16, kRelaxed>(s[4 * q], d, y_bias),
            stored<kWrap16, kRelaxed>(s[4 * q + 1], d, y_bias),
            stored<kWrap16, kRelaxed>(s[4 * q + 2], d, y_bias),
            stored<kWrap16, kRelaxed>(s[4 * q + 3], d, y_bias));
    } else {
#pragma unroll
      for (int k = 0; k < kGroupCols; ++k)
        atomicAdd(reinterpret_cast<unsigned int*>(wrow + k), s[k]);
    }
  }
  __syncthreads();
  if ((kWrap16 || kRelaxed) && ks > 1) {  // the wrap, renormalisation and rounding, once
    for (int e = threadIdx.x; e < rows * ng * kGroupCols; e += kThreads) {
      const int r = e / (ng * kGroupCols);
      const int c = e - r * ng * kGroupCols;
      int32_t* p = work + r * wp + c;
      *p = stored<kWrap16, kRelaxed>(static_cast<uint32_t>(*p),
                                     kWrap16 ? __ldg(ydiv + r0 + r) : 0, y_bias);
    }
    __syncthreads();
  }

  // X pass: outputs (row fastest) over groups of `group` lanes, tap t on
  // lane t % group, the lanes' sums met by butterfly shuffles; with
  // kRelaxed group is 1 and each thread sums its output's planes in order
  const uint32_t half = 1u << (out_shift - 1);
  const int lane = threadIdx.x & (group - 1);
  const int groups = kThreads / group;
  for (int o0 = 0; o0 < tr * tc; o0 += groups) {
    const int o = o0 + threadIdx.x / group;
    const int r = o % tr;
    const int jt = o / tr;
    const bool valid = r < rows && jt < cols;
    uint32_t acc = 0u;
    if (valid) {
      const int32_t* wrow = work + r * wp;
      const int32_t* cxr = s_cx + jt * xrow;
      const int x0 = s_xs[jt];
      if constexpr (kRelaxed) {
        acc = float_taps(cxr, wrow, x0, taps_x, src_w, lo_al);
        if (planes > 1) acc += float_taps(cxr + taps_x, wrow, x0, taps_x, src_w, lo_al);
      } else {
        for (int t = lane; t < taps_x; t += group)
          acc += static_cast<uint32_t>(cxr[t]) *
                 static_cast<uint32_t>(wrow[min(max(x0 + t, 0), src_w - 1) - lo_al]);
      }
    }
    for (int off = group >> 1; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
    if (valid && lane == 0) {
      const int j = c0 + jt;
      int32_t v;
      if constexpr (kWrap16 || kRelaxed) {
        const int32_t sum = as_i32(acc + half);
        const int32_t d = __ldg(xdiv + j);
        // d is a nonzero multiple of y_bias (>= 2 in magnitude) on border
        // columns, so sum / d cannot overflow
        v = wrap16(static_cast<uint32_t>(d != 0 ? sum / d : shift_floor(sum, out_shift)));
      } else {
        v = static_cast<int32_t>((acc + half) >> out_shift);
      }
      fdst[static_cast<long long>(r0 + r) * dst_w + j] =
          static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// ---- the s8 Y form -----------------------------------------------------

constexpr int kSlab = 32;         // band rows a slab: one mma K step
constexpr int kS8Groups = 3;      // 32-column groups of the band a warp's sums hold
constexpr int kS8Cols = 32 * kS8Groups * (kThreads / 32);   // widest band pitch
constexpr int kMaxStages = 8;     // slabs the ring holds at most

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most n (0 .. kMaxStages - 2) of this thread's cp.async
// groups are pending.
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;" ::: "memory"); break;
  }
}

constexpr int kSlabPieces = kSlab * (kS8Cols / 16) / kThreads;   // a thread's pieces of a slab

// This thread's 16-byte pieces of every slab: piece e = tid + kThreads i of
// a slab's 32 rows x nchunk pieces, as (row << 8) | piece, in increasing
// order, -1 past the slab.  Every slab has that shape, so they are worked
// out once a block, not by a division a piece a slab as stage_rows does.
__device__ __forceinline__ void slab_pieces(int nchunk, int (&mine)[kSlabPieces]) {
#pragma unroll
  for (int i = 0; i < kSlabPieces; ++i) {
    const int e = threadIdx.x + kThreads * i;
    mine[i] = e < kSlab * nchunk ? (e / nchunk) << 8 | (e % nchunk) : -1;
  }
}

// Slab k of a row tile's band, source rows [first + 32 k, end) at most 32,
// into ring stage k % stages: 16-byte cp.async pieces where `vec` (the row
// pitch is a multiple of 16) and the piece lies in the row, byte loads of
// the bytes inside the row otherwise (resize_tiled.cuh stage_rows).
__device__ __forceinline__ void copy_slab(uint8_t* ring, const iqo_tiled::TiledArgs& a,
                                          const uint8_t* frame, int k, int stages, int first,
                                          int end, int c_base, bool vec,
                                          const int (&mine)[kSlabPieces]) {
  const int row0 = first + kSlab * k;
  const int n = min(kSlab, end - row0);
  const uint8_t* rows = frame + static_cast<long long>(row0) * a.row_stride + c_base;
  uint8_t* stage = ring + (k % stages) * kSlab * a.pitch;
#pragma unroll
  for (int i = 0; i < kSlabPieces; ++i) {
    const int r = mine[i] >> 8;
    if (mine[i] < 0 || r >= n) break;
    const int c = (mine[i] & 0xFF) << 4;
    const int col = c_base + c;
    const uint8_t* g = rows + r * a.row_stride + c;
    uint8_t* s = stage + iqo_tiled::swz(r, c, a.pitch);
    if (vec && col >= 0 && col + 16 <= a.src_w) {
      iqo_tiled::cp_async16(s, g);
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (col + b >= 0 && col + b < a.src_w) s[b] = __ldg(g + b);
    }
  }
}

// Block (column tile x, row tile y, frame z) of the s8 form: the records of
// resize_tiled.cuh (cuda_resize.TiledLayout: row record with corr, ydiv and
// A; column record of the per-tap X pass), the band streamed in slabs
// through a ring of `stages`, then the tiled kernel's epilogue and X pass.
// Shared memory: [max(ring, 16-bit work tile)] [column record] [row record].
template <int kTW>
__global__ void __launch_bounds__(kThreads, 2)
    resize_wide_kernel_s8y(iqo_tiled::TiledArgs a, int stages) {
  namespace t = iqo_tiled;
  extern __shared__ __align__(16) uint8_t s8_smem[];
  const int region = max(stages * kSlab * a.pitch, t::kRows * a.work_pitch * 2);
  uint8_t* ring = s8_smem;
  uint16_t* work = reinterpret_cast<uint16_t*>(s8_smem);   // once the ring is spent
  int32_t* crec = reinterpret_cast<int32_t*>(s8_smem + region);
  int32_t* rrec = crec + a.crec_words;

  const int tid = threadIdx.x, warp = tid / 32, g = (tid % 32) / 4, q = tid % 4;
  const int32_t* grrec = a.rrec + static_cast<long long>(blockIdx.y) * a.rrec_words;
  const int32_t* gcrec = a.crec + static_cast<long long>(blockIdx.x) * a.crec_words;
  const int first = __ldg(grrec + 2), end = __ldg(grrec + 3);
  const int lo = __ldg(gcrec), width = __ldg(gcrec + 1);
  for (int i = tid; i < a.rrec_words / 4; i += kThreads) t::cp_async16(rrec + 4 * i, grrec + 4 * i);
  for (int i = tid; i < a.crec_words / 4; i += kThreads) t::cp_async16(crec + 4 * i, gcrec + 4 * i);
  const uint8_t* frame = a.src + static_cast<long long>(blockIdx.z) * a.frame_stride;
  const int mis = static_cast<int>(
      reinterpret_cast<uintptr_t>(frame + static_cast<long long>(first) * a.row_stride + lo) & 15);
  const bool vec = (a.row_stride & 15) == 0;
  const int c_base = lo - mis;                  // source column of band column 0
  const int groups = (mis + width + 31) >> 5;
  const int slabs = (end - first + kSlab - 1) / kSlab;
  int mine[kSlabPieces];
  slab_pieces((mis + width + 15) >> 4, mine);

  // the records ride with slab 0; slabs 1 .. stages - 2 follow, a group each
  for (int k = 0; k < stages - 1; ++k) {
    if (k < slabs) copy_slab(ring, a, frame, k, stages, first, end, c_base, vec, mine);
    cp_async_commit();
  }
  const uint8_t* amat = reinterpret_cast<const uint8_t*>(rrec + t::kHead + 2 * t::kRows);
  const int ka = a.k_rows + 16;
  int acc[kS8Groups][4][4] = {};
  for (int k = 0; k < slabs; ++k) {
    cp_async_wait_pending(stages - 2);          // slab k landed, for this thread
    __syncthreads();                            // ... for all; slab k - 1's stage is free
    if (k + stages - 1 < slabs)
      copy_slab(ring, a, frame, k + stages - 1, stages, first, end, c_base, vec, mine);
    cp_async_commit();
    const uint8_t* slab = ring + (k % stages) * kSlab * a.pitch;
    uint32_t af[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      af[i] = *reinterpret_cast<const uint32_t*>(
          amat + (g + 8 * (i & 1)) * ka + kSlab * k + 16 * (i >> 1) + 4 * q);
#pragma unroll
    for (int i = 0; i < kS8Groups; ++i) {
      const int grp = warp + t::kWarps * i;
      if (grp < groups) {
        uint32_t b[2][4];
        t::b_frags<false>(slab, a.pitch, 0, q, 8 * grp + g, 0, 0, b);
#pragma unroll
        for (int p = 0; p < 4; ++p) t::mma_s8(acc[i][p], af, b[0][p], b[1][p]);
      }
    }
  }
  t::cp_async_wait_all();
  __syncthreads();                              // every warp is done with the ring

  // acc[i][p][2 rh + ec]: row g + 8 rh, band column 32 grp + 8 q + 4 ec + p
  const uint32_t* corr = reinterpret_cast<const uint32_t*>(rrec + t::kHead);
  const int32_t* ydiv = rrec + t::kHead + t::kRows;
#pragma unroll
  for (int i = 0; i < kS8Groups; ++i) {
    const int grp = warp + t::kWarps * i;
    if (grp < groups) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = g + 8 * rh;
        uint32_t v[8];
#pragma unroll
        for (int ec = 0; ec < 2; ++ec)
#pragma unroll
          for (int p = 0; p < 4; ++p) v[4 * ec + p] = static_cast<uint32_t>(acc[i][p][2 * rh + ec]);
        t::store8<true, false>(work, a.work_pitch, a.margin, row, 32 * grp + 8 * q, v,
                                  corr[row], ydiv[row], a.y_bias);
      }
    }
  }
  __syncthreads();

  const int r = tid >> 4, l = tid & 15;
  const int c0 = blockIdx.x * kTW;
  const int row = blockIdx.y * t::kRows + r;
  if (row >= a.dst_h) return;
  uint8_t* out = a.dst + static_cast<long long>(blockIdx.z) * a.dst_h * a.dst_w +
                 static_cast<long long>(row) * a.dst_w + c0;
  t::x_pass<true, kTW, false, false>(a, work, crec, mis, r, l, min(kTW, a.dst_w - c0), out);
}

using S8Kernel = decltype(&resize_wide_kernel_s8y<32>);

// The s8 form's instantiation for tw, or null for a width it is not built
// for (32 and 16).
S8Kernel pick_s8(int tw) {
  if (tw == 32) return &resize_wide_kernel_s8y<32>;
  if (tw == 16) return &resize_wide_kernel_s8y<16>;
  return nullptr;
}

using Kernel = decltype(&resize_wide_kernel<true, 16, false>);

// The instantiation for (relaxed, wrap16, 16-byte loads).
Kernel pick(int relaxed, int wrap16, int vec16) {
  static const Kernel kernels[8] = {
      &resize_wide_kernel<false, 1, false>, &resize_wide_kernel<false, 16, false>,
      &resize_wide_kernel<true, 1, false>,  &resize_wide_kernel<true, 16, false>,
      &resize_wide_kernel<false, 1, true>,  &resize_wide_kernel<false, 16, true>,
      &resize_wide_kernel<true, 1, true>,   &resize_wide_kernel<true, 16, true>};
  return kernels[(relaxed ? 4 : 0) + (wrap16 ? 2 : 0) + (vec16 ? 1 : 0)];
}

bool aligned(long long v, int n) { return v % n == 0; }

// The kernel's arguments but the source, the output and the strides.
struct WideArgs {
  int src_h, src_w, dst_h, dst_w;
  const int32_t *cy, *ys, *ydiv;
  int taps_y, y_bias;
  const int32_t *cx, *xs, *xdiv;
  int taps_x, planes;
  const int32_t* win;
  int n_ct, tc, tr, ks, group, wp, out_shift;
};

int load_bytes(const void* src, int n_frames, long long src_frame_stride,
               long long src_row_stride) {
  const long long base = static_cast<long long>(reinterpret_cast<uintptr_t>(src));
  return aligned(base, 16) && aligned(src_row_stride, 16) &&
                 (n_frames == 1 || aligned(src_frame_stride, 16))
             ? 16
             : 1;
}

// The instantiation of a launch (byte or 16-byte loads) follows the
// source's alignment, so it is picked per launch.
struct WideExec final : iqo::Exec {
  int wrap16 = 0;
  int relaxed = 0;
  unsigned blocks = 0;       // of one frame
  int smem = 0;
  WideArgs a{};

  int launch(const void* src, void* dst, int n_frames, long long frame_stride,
             long long row_stride, cudaStream_t stream) const override {
    if (!iqo::frames_ok(n_frames)) return static_cast<int>(cudaErrorInvalidValue);
    const WideArgs r = a;
    const bool vec16 = load_bytes(src, n_frames, frame_stride, row_stride) == 16;
    pick(relaxed, wrap16, vec16)<<<dim3(blocks, 1, n_frames), kThreads, smem, stream>>>(
        static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), frame_stride, row_stride,
        r.src_h, r.src_w, r.dst_h, r.dst_w, r.cy, r.ys, r.ydiv, r.taps_y, r.y_bias, r.cx, r.xs,
        r.xdiv, r.taps_x, r.planes, r.win, r.n_ct, r.tc, r.tr, r.ks, r.group, r.wp,
        r.out_shift);
    return static_cast<int>(cudaGetLastError());
  }
};

// Packs one wide-window resize into e.  Returns a cudaError_t.
int pack(WideExec& e, int wrap16, int relaxed, int src_h, int src_w, int dst_h, int dst_w,
         const void* cy, const void* ys, const void* ydiv, int taps_y, int y_bias,
         const void* cx, const void* xs, const void* xdiv, int taps_x, int planes,
         const void* win, int n_ct, int tc, int tr, int ks, int group, int wp, int out_shift) {
  if (tc < 1 || tr < 1 || ks < 1 || ks > taps_y || group < 1 || group > 32 ||
      (group & (group - 1)) != 0 || wp % 4 != 0 || n_ct != (dst_w + tc - 1) / tc ||
      (relaxed ? (group != 1 || planes < 1 || planes > 2) : planes != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(n_ct) * ((dst_h + tr - 1) / tr);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  e.a = WideArgs{src_h, src_w, dst_h, dst_w, i32(cy), i32(ys), i32(ydiv), taps_y, y_bias,
                 i32(cx), i32(xs), i32(xdiv), taps_x, planes, i32(win), n_ct, tc, tr, ks,
                 group, wp, out_shift};
  e.wrap16 = wrap16;
  e.relaxed = relaxed;
  e.blocks = static_cast<unsigned>(blocks);
  e.smem = 4 * (tr * (wp + taps_y + 1) + tc * (planes * taps_x + 1));
  e.out_frame = static_cast<long long>(dst_h) * dst_w;
  return 0;
}

// The s8 form's executable: the instantiation, its record (src, dst and the
// strides filled in per launch), the ring's stages and one frame's grid.
struct WideS8Exec final : iqo::Exec {
  S8Kernel kernel = nullptr;
  dim3 grid;                 // of one frame
  int smem = 0;
  int stages = 0;
  iqo_tiled::TiledArgs a{};

  int launch(const void* src, void* dst, int n_frames, long long frame_stride,
             long long row_stride, cudaStream_t stream) const override {
    if (!iqo::frames_ok(n_frames)) return static_cast<int>(cudaErrorInvalidValue);
    iqo_tiled::TiledArgs args = a;
    args.src = static_cast<const uint8_t*>(src);
    args.dst = static_cast<uint8_t*>(dst);
    args.frame_stride = frame_stride;
    args.row_stride = row_stride;
    kernel<<<dim3(grid.x, grid.y, n_frames), kThreads, smem, stream>>>(args, stages);
    return static_cast<int>(cudaGetLastError());
  }
};

// Packs one resize of the s8 form into e.  Returns a cudaError_t.
int pack_s8(WideS8Exec& e, int tw, int src_w, int dst_h, int dst_w,
            const void* rrec, int rrec_words, const void* crec, int crec_words, int taps_x,
            int k_rows, int pitch, int margin, int work_pitch, int max_phases, int y_bias,
            int out_shift, int stages) {
  e.kernel = pick_s8(tw);
  if (e.kernel == nullptr || stages < 2 || stages > kMaxStages || pitch % 128 != 0 ||
      pitch > kS8Cols || k_rows % kSlab != 0 || rrec_words % 4 != 0 || crec_words % 4 != 0 ||
      work_pitch % 8 != 0 || (dst_h + iqo_tiled::kRows - 1) / iqo_tiled::kRows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  e.a = iqo_tiled::TiledArgs{nullptr, nullptr, 0, 0, src_w, dst_h, dst_w,
                             static_cast<const int32_t*>(rrec),
                             static_cast<const int32_t*>(crec), rrec_words, crec_words, 0,
                             taps_x, k_rows, pitch, margin, work_pitch, max_phases, y_bias,
                             out_shift, 1, 1, 0, 0};
  e.stages = stages;
  e.smem = std::max(stages * kSlab * pitch, iqo_tiled::kRows * work_pitch * 2) +
           4 * (rrec_words + crec_words);
  e.grid = dim3((dst_w + tw - 1) / tw, (dst_h + iqo_tiled::kRows - 1) / iqo_tiled::kRows, 1);
  e.out_frame = static_cast<long long>(dst_h) * dst_w;
  return 0;
}

}  // namespace

extern "C" {

// The width in bytes of the loads a launch on this source takes: 16 where
// src, its row stride and (with several frames) its frame stride are 16-byte
// aligned, else 1.
int iqo_wide_load_bytes(const void* src, int n_frames, long long src_frame_stride,
                        long long src_row_stride) {
  return load_bytes(src, n_frames, src_frame_stride, src_row_stride);
}

// Threads a block and work columns a Y item, read by the host to lay out
// the plan.
int iqo_wide_shape(int* threads, int* group_cols) {
  *threads = kThreads;
  *group_cols = kGroupCols;
  return 0;
}

// The s8 form's widest band pitch in bytes and most ring stages, read by
// the host (cuda_resize.WIDE_S8_COLS, WIDE_S8_MAX_STAGES).
int iqo_wide_s8_shape(int* cols, int* stages) {
  *cols = kS8Cols;
  *stages = kMaxStages;
  return 0;
}

// Raises the dynamic shared-memory limit of the eight scalar instantiations
// and the two of the s8 form on the current device to `bytes`.  Returns a
// cudaError_t.
int iqo_wide_set_max_smem(int bytes) {
  for (int k = 0; k < 10; ++k) {
    const void* f = k < 8 ? reinterpret_cast<const void*>(pick(k & 4, k & 2, k & 1))
                          : reinterpret_cast<const void*>(pick_s8(k == 8 ? 32 : 16));
    cudaError_t rc = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}

// The executable of one resize of a wrap16 (Lanczos) plan on the s8 form at
// tw (32 or 16) output columns a block, from the records of
// cuda_resize.tiled_layout at tw with the X pass per tap (row
// records with A, rrec_words each; column records, crec_words each; k_rows,
// pitch <= iqo_wide_s8_shape's cols, margin, work_pitch, max_phases as
// there), the band streamed through a ring of `stages` (2 ..
// iqo_wide_s8_shape's stages) slabs of 32 rows.  Its shared memory,
// max(stages * 32 * pitch, 32 * work_pitch) + 4 * (rrec_words + crec_words)
// bytes, must be within the limit set by iqo_wide_set_max_smem.  Writes the
// handle to *out.  Returns a cudaError_t.
int iqo_resize_wide_s8_exec_create(int tw, int src_w, int dst_h, int dst_w,
                                   const void* rrec, int rrec_words, const void* crec,
                                   int crec_words, int taps_x, int k_rows, int pitch,
                                   int margin, int work_pitch, int max_phases, int y_bias,
                                   int out_shift, int stages, void** out) {
  WideS8Exec e;
  const int rc = pack_s8(e, tw, src_w, dst_h, dst_w, rrec, rrec_words, crec,
                         crec_words, taps_x, k_rows, pitch, margin, work_pitch, max_phases,
                         y_bias, out_shift, stages);
  return iqo::create(e, rc, out);
}

// Launches one resize of n_frames frames on the s8 form: the executable of
// iqo_resize_wide_s8_exec_create with the same arguments, made on the stack
// and launched once.  dst is contiguous (n_frames, dst_h, dst_w).  Returns a
// cudaError_t.
int iqo_resize_wide_s8(int tw, const void* src, void* dst, int n_frames,
                       long long src_frame_stride, long long src_row_stride, int src_w,
                       int dst_h, int dst_w, const void* rrec, int rrec_words,
                       const void* crec, int crec_words, int taps_x, int k_rows, int pitch,
                       int margin, int work_pitch, int max_phases, int y_bias, int out_shift,
                       int stages, void* stream) {
  WideS8Exec e;
  const int rc = pack_s8(e, tw, src_w, dst_h, dst_w, rrec, rrec_words, crec,
                         crec_words, taps_x, k_rows, pitch, margin, work_pitch, max_phases,
                         y_bias, out_shift, stages);
  if (rc != 0) return rc;
  return e.launch(src, dst, n_frames, src_frame_stride, src_row_stride,
                  static_cast<cudaStream_t>(stream));
}

// The executable of one resize in tiles of tr x tc outputs over n_ct column
// tiles (win), ks slices of the Y taps and groups of `group` lanes (a power
// of two <= 32) an output's X taps; wp is the work tile's row pitch in
// words, at least 16 * ceil((hi - (lo & ~15)) / 16) of every column tile and
// a multiple of 4.  Exact: cx the integer taps, planes 1.  Relaxed: cx the
// float32 bits of each output's `planes` (1 or 2) planes, group 1.  Each
// launch's loads are iqo_wide_load_bytes wide on its source.  The shared
// memory, 4 * (tr * (wp + taps_y + 1) + tc * (planes * taps_x + 1)) bytes,
// must be within the limit set by iqo_wide_set_max_smem.  Writes the handle
// to *out.  Returns a cudaError_t.
int iqo_resize_wide_exec_create(int wrap16, int relaxed, int src_h, int src_w, int dst_h,
                                int dst_w, const void* cy, const void* ys, const void* ydiv,
                                int taps_y, int y_bias, const void* cx, const void* xs,
                                const void* xdiv, int taps_x, int planes, const void* win,
                                int n_ct, int tc, int tr, int ks, int group, int wp,
                                int out_shift, void** out) {
  WideExec e;
  const int rc = pack(e, wrap16, relaxed, src_h, src_w, dst_h, dst_w, cy, ys, ydiv, taps_y,
                      y_bias, cx, xs, xdiv, taps_x, planes, win, n_ct, tc, tr, ks, group, wp,
                      out_shift);
  return iqo::create(e, rc, out);
}

// Launches one resize of n_frames frames on `stream`: the executable of
// iqo_resize_wide_exec_create with the same arguments, made on the stack
// and launched once.  dst is contiguous (n_frames, dst_h, dst_w).  Returns
// a cudaError_t.
int iqo_resize_wide(int wrap16, int relaxed, const void* src, void* dst, int n_frames,
                    long long src_frame_stride, long long src_row_stride,
                    int src_h, int src_w, int dst_h, int dst_w,
                    const void* cy, const void* ys, const void* ydiv, int taps_y,
                    int y_bias, const void* cx, const void* xs, const void* xdiv,
                    int taps_x, int planes, const void* win, int n_ct, int tc, int tr,
                    int ks, int group, int wp, int out_shift, void* stream) {
  WideExec e;
  const int rc = pack(e, wrap16, relaxed, src_h, src_w, dst_h, dst_w, cy, ys, ydiv, taps_y,
                      y_bias, cx, xs, xdiv, taps_x, planes, win, n_ct, tc, tr, ks, group, wp,
                      out_shift);
  if (rc != 0) return rc;
  return e.launch(src, dst, n_frames, src_frame_stride, src_row_stride,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
