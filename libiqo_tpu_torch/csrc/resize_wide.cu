// The wide-window resize for Hopper (sm_90a): the exact plans whose column
// windows are too wide for a 16-row work tile of the windowed kernel
// (cuda_resize.work_rows < 16): Area 8192x4 -> 16x4 (512 X taps, one window
// of 8192 columns), the thumbnails Area 4096x4096 -> 128x128, 3840x2160 ->
// 128x72, Area and Lanczos3 7680x4320 -> 240x135, Area 40960x8 -> 1024x8, and
// with tiled=False Area 8192x2160 -> 256x540 and 4096x2160 -> 128x540.  Byte
// equal to the windowed kernel and to golden/numpy_ref.py, in two exact
// instantiations as resize_fused.cu: kWrap16 (Lanczos: int16 work rows,
// Y-border renormalisation, int32-wrapping X sums, border-column divide) and
// u16 (Area, Linear: u16 work rows, (sums + half) >> out_shift).
//
// Replaces the TPU kernel libiqo_tpu/ops/pallas_resize.py _make_padless_fn
// (pl.pallas_call at :1687) on these plans: K3, the Y pass over byte planes
// for taps outside s8 (:843-847, 1374-1396), and K4, the X pass over u16
// work rows (:956-962, 1448-1456), and K1+K2's wrap16 epilogue.
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
// * Intended wraps go through uint32 (signed overflow is undefined in C++);
//   int16 narrowing, two's-complement reinterpretation and the arithmetic
//   shift are written out, as in resize_fused.cu.

#include <cstdint>
#include <cuda_runtime.h>

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

// Tables are output-major: cy[i * taps_y + t], cx[j * taps_x + t]; ys/xs
// the first (unclamped) source row/column of each output row/column, whose
// taps read clamp(start + t) (taps outside the source are zero in the plan);
// ydiv/xdiv the border divisors (0 on main outputs; read with kWrap16);
// win[2 ct], win[2 ct + 1] the source columns [lo, hi) that column tile ct's
// clamped taps read.  Block b takes row tile b / n_ct and column tile
// b % n_ct, frame blockIdx.z.
template <bool kWrap16, int V>
__global__ void __launch_bounds__(kThreads, 2) resize_wide_kernel(
    const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
    long long src_frame_stride, long long src_row_stride, int src_h, int src_w,
    int dst_h, int dst_w,
    const int32_t* __restrict__ cy, const int32_t* __restrict__ ys,
    const int32_t* __restrict__ ydiv, int taps_y, int y_bias,
    const int32_t* __restrict__ cx, const int32_t* __restrict__ xs,
    const int32_t* __restrict__ xdiv, int taps_x,
    const int32_t* __restrict__ win, int n_ct, int tc, int tr, int ks,
    int group, int wp, int out_shift) {
  // work [tr][wp], then the block's Y table [tr][taps_y], X table
  // [tc][taps_x], row starts [tr] and column starts [tc]
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* work = smem;
  int32_t* s_cy = work + tr * wp;
  int32_t* s_cx = s_cy + tr * taps_y;
  int32_t* s_ys = s_cx + tc * taps_x;
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
  for (int e = threadIdx.x; e < cols * taps_x; e += kThreads)
    s_cx[e] = __ldg(cx + static_cast<long long>(c0) * taps_x + e);
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
            work_value<kWrap16>(s[4 * q], d, y_bias),
            work_value<kWrap16>(s[4 * q + 1], d, y_bias),
            work_value<kWrap16>(s[4 * q + 2], d, y_bias),
            work_value<kWrap16>(s[4 * q + 3], d, y_bias));
    } else {
#pragma unroll
      for (int k = 0; k < kGroupCols; ++k)
        atomicAdd(reinterpret_cast<unsigned int*>(wrow + k), s[k]);
    }
  }
  __syncthreads();
  if (kWrap16 && ks > 1) {                 // the wrap and renormalisation, once
    for (int e = threadIdx.x; e < rows * ng * kGroupCols; e += kThreads) {
      const int r = e / (ng * kGroupCols);
      const int c = e - r * ng * kGroupCols;
      int32_t* p = work + r * wp + c;
      *p = work_value<kWrap16>(static_cast<uint32_t>(*p), __ldg(ydiv + r0 + r), y_bias);
    }
    __syncthreads();
  }

  // X pass: outputs (row fastest) over groups of `group` lanes, tap t on
  // lane t % group, the lanes' sums met by butterfly shuffles
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
      const int32_t* cxr = s_cx + jt * taps_x;
      const int x0 = s_xs[jt];
      for (int t = lane; t < taps_x; t += group)
        acc += static_cast<uint32_t>(cxr[t]) *
               static_cast<uint32_t>(wrow[min(max(x0 + t, 0), src_w - 1) - lo_al]);
    }
    for (int off = group >> 1; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
    if (valid && lane == 0) {
      const int j = c0 + jt;
      int32_t v;
      if constexpr (kWrap16) {
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

using Kernel = decltype(&resize_wide_kernel<true, 16>);

// The instantiation for (wrap16, 16-byte loads).
Kernel pick(int wrap16, int vec16) {
  static const Kernel kernels[4] = {
      &resize_wide_kernel<false, 1>, &resize_wide_kernel<false, 16>,
      &resize_wide_kernel<true, 1>, &resize_wide_kernel<true, 16>};
  return kernels[(wrap16 ? 2 : 0) + (vec16 ? 1 : 0)];
}

bool aligned(long long v, int n) { return v % n == 0; }

}  // namespace

extern "C" {

// The width in bytes of the loads a launch on this source takes: 16 where
// src, its row stride and (with several frames) its frame stride are 16-byte
// aligned, else 1.
int iqo_wide_load_bytes(const void* src, int n_frames, long long src_frame_stride,
                        long long src_row_stride) {
  const long long base = static_cast<long long>(reinterpret_cast<uintptr_t>(src));
  return aligned(base, 16) && aligned(src_row_stride, 16) &&
                 (n_frames == 1 || aligned(src_frame_stride, 16))
             ? 16
             : 1;
}

// Threads a block and work columns a Y item, read by the host to lay out
// the plan.
int iqo_wide_shape(int* threads, int* group_cols) {
  *threads = kThreads;
  *group_cols = kGroupCols;
  return 0;
}

// Raises the four instantiations' dynamic shared-memory limit on the current
// device to `bytes`.  Returns a cudaError_t.
int iqo_wide_set_max_smem(int bytes) {
  for (int k = 0; k < 4; ++k) {
    cudaError_t rc = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(pick(k & 2, k & 1)),
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}

// Launches one resize of n_frames frames on `stream` in tiles of tr x tc
// outputs over n_ct column tiles (win), ks slices of the Y taps and groups
// of `group` lanes (a power of two <= 32) an output's X taps; wp is the work
// tile's row pitch in words, at least 16 * ceil((hi - (lo & ~15)) / 16) of
// every column tile and a multiple of 4.  The loads are
// iqo_wide_load_bytes wide.  dst is contiguous (n_frames, dst_h,
// dst_w); the shared memory, 4 * (tr * (wp + taps_y + 1) + tc * (taps_x +
// 1)) bytes, must be within the limit set by iqo_wide_set_max_smem.
// Returns a cudaError_t.
int iqo_resize_wide(int wrap16, const void* src, void* dst, int n_frames,
                    long long src_frame_stride, long long src_row_stride,
                    int src_h, int src_w, int dst_h, int dst_w,
                    const void* cy, const void* ys, const void* ydiv, int taps_y,
                    int y_bias, const void* cx, const void* xs, const void* xdiv,
                    int taps_x, const void* win, int n_ct, int tc, int tr, int ks,
                    int group, int wp, int out_shift, void* stream) {
  if (tc < 1 || tr < 1 || ks < 1 || ks > taps_y || group < 1 || group > 32 ||
      (group & (group - 1)) != 0 || wp % 4 != 0 || n_ct != (dst_w + tc - 1) / tc)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec16 =
      iqo_wide_load_bytes(src, n_frames, src_frame_stride, src_row_stride) == 16;
  const int smem = 4 * (tr * (wp + taps_y + 1) + tc * (taps_x + 1));
  const long long blocks = static_cast<long long>(n_ct) * ((dst_h + tr - 1) / tr);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), 1, n_frames);
  pick(wrap16, vec16)<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), src_frame_stride,
      src_row_stride, src_h, src_w, dst_h, dst_w, static_cast<const int32_t*>(cy),
      static_cast<const int32_t*>(ys), static_cast<const int32_t*>(ydiv), taps_y, y_bias,
      static_cast<const int32_t*>(cx), static_cast<const int32_t*>(xs),
      static_cast<const int32_t*>(xdiv), taps_x, static_cast<const int32_t*>(win), n_ct,
      tc, tr, ks, group, wp, out_shift);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
