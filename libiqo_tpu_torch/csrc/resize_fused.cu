// Fused separable resize for Hopper (sm_90a): Y pass, X pass and rounding
// epilogue in one kernel, exact to the reference Generic fixed-point path
// (libiqo_tpu_torch/golden/numpy_ref.py).  Two exact instantiations:
// * kWrap16 = true (Lanczos): int16 wrap of the work rows, Y-border
//   renormalisation, int32-wrapping X sums, border-column divide;
// * kWrap16 = false (Area, Linear): u16 work rows kept as they are, no
//   border divides, (sums + half) >> out_shift;
// the relaxed form of each (kRelaxed = true, precision="relaxed"), within
// 2 LSB of the exact output with flat fields exact; and a row-halo carry
// form of all four (kCarry = true, below), byte-equal to the windowed one.
//
// Replaces the TPU kernel libiqo_tpu/ops/pallas_resize.py _make_padless_fn
// (pl.pallas_call at :1687) -> kernel/_frame in these configurations:
// * K1+K2, the Lanczos main path (s8 Y dot, int16 wrap, y_cond border rows,
//   s8-split X dots, x_slab border columns) with its exact truncating
//   divide _exact_trunc_div (:79-129);
// * K3, the Y pass on bf16 byte planes for taps outside s8 (:843-847,
//   1374-1396), and K4, the X pass over u16 work rows, x_u8work (:956-962,
//   1448-1456): the Area/Linear plans, here kWrap16 = false;
// * K5, the exact X schemes for 16-bit taps outside the s8 gate, x_single,
//   x_kara and hi/lo bf16 (:954,1043-1052,1506-1548): Lanczos at px_scale
//   >= 3, here kWrap16 = true, whose uint32 sums take taps of any width;
// * K8, the streamed-Y build that libiqo_tpu/parallel/sharding.py:197 asks
//   for (force_streamed_y, :766-781,808-812) so that every device of a row
//   mesh runs one program on its own Y values: here each row shard simply
//   launches this kernel on its own local Y tables over its halo-extended
//   band (libiqo_tpu_torch/parallel/sharding.py).
//
// What bounds it on the H100: the bytes of one YUV420 frame, each source
// byte read once and each output byte written once: 15.55 MB for 4K->1080p
// and for 1080p->4K (4.6 us at 3.35 TB/s), 3.46 MB for 1080p->360p.  The
// int32 multiply-adds (~85 M for Lanczos3 4K->1080p) are far below the
// card's integer rate.  The simple form below is bound by its load
// instructions (each tap is a load of the source or the work tile) and by
// launch latency, not by either.
//
// What the design does about it:
// * The TPU's byte planes, s8 rebasing, Karatsuba splits, hi/lo planes and
//   corr_y/corr_x fixups exist because its matrix unit multiplies in bf16
//   and its vector divide is slow.  On Hopper 32-bit integer multiply-add
//   and `/` are exact and native, so one direct-tap integer form covers
//   every scheme: each output is a direct tap sum, and the border divide is
//   C++ `/` (truncation toward zero by language rule).
// * Area/Linear work rows are <= 255 * 256 = 65280 and their X sums plus
//   the half stay below 2^31 (the host's supports_plan checks both), so the
//   kWrap16 = false path needs no wrap anywhere.
// * One block computes a TH x TW output tile.  The Y pass writes the tile's
//   work rows, over the column tile's source window only, into shared
//   memory; the work tile never touches device memory (as VMEM on the TPU).
// * The host computes each column tile's source window [lo, hi) from the
//   clamped tap indices, so every read lies inside the source frame and
//   inside the shared tile, whatever the plan's stale-iterator starts do.
// * Intended wraps are done in uint32_t (signed overflow is undefined in
//   C++); int16 narrowing, two's-complement reinterpretation and the
//   arithmetic right shift are written out explicitly.
//
// The work tile is kTileRows x win_max int32 words, except for the plans
// whose widest column-tile window is so wide that sixteen rows of it exceed
// shared memory (area 8192x4 -> 16x4: one partial column tile of 8192
// source columns, 512 taps an output; area 8192x2160 -> 256x540: two column
// tiles of 4096): a block then takes fewer output rows, tile_rows =
// min(16, budget / (4 * win_max)), on any number of column tiles, and the
// grid more row tiles (cuda_resize.work_rows; at least 4 rows, which keeps
// the scope at the JAX package's for these plans).  Each output is still
// computed by one thread over its whole tap list in tap order, so the bytes
// are those of the 16-row tile.  The carry form keeps 16 rows.  This walk
// takes such plans only with cuda_resize.pack_operands(..., wide=False),
// for timing turns: csrc/resize_wide.cu takes them otherwise.
//
// Every plan whose band (or carry ring) fits shared memory now runs on the
// tiled kernel, csrc/resize_tiled.cuh, which stages the source band with
// cp.async, runs the Y pass on s8 mma.sync and keeps a 16-bit work tile, in
// exact, relaxed and carry forms; this kernel serves the rest in all eight
// instantiations (cuda_resize.tiled_ok and tiled_carry_layout refuse them:
// bands taller than shared memory).
//
// kRelaxed replaces the TPU's relaxed X scheme (K7): the relaxed build of
// libiqo_tpu/ops/pallas_resize.py:943-1024 with _bf16_relaxed_plane
// (:163-197), and its X pass (:1486-1505).  The Y pass is unchanged and
// exact.  The work row w is rounded to bf16 (8 significant bits) and kept
// as a float in the same 4 bytes of the work tile; each output's X sum is
// sum_t cxr[t] * w, in float32, tap by tap in order, each product and add
// rounded on its own (__fmul_rn/__fadd_rn: no contraction), then truncated
// to int32.  cxr is the bf16 coefficient plane whose column sums the host
// repaired (cuda_resize.relaxed_plane); where a column could not be
// repaired, the same sum over the residual plane cxd is added.  bf16 x bf16
// products are exact in float32, so the order of the adds is the only
// freedom, and fixing it makes the kernel byte-equal to its plain version
// (torch_resize.resize_relaxed).  The shared epilogue follows, as on the
// TPU: int32-wrapping sums + half, the shift or the truncating border
// divide, int16 narrowing, clip.  On the TPU relaxed bought one bf16 MXU
// dot instead of four s8 ones.  Here the direct-tap form does the same
// number of multiply-adds in float instead of integer, so no speed-up is
// expected from it; the tiled kernel's relaxed form keeps the same float32
// tap order (a tensor-core X pass would sum in the unit's own order).
//
// kCarry replaces the TPU's row-halo carry mode (K9, LIBIQO_TPU_CARRY):
// _Carry/_carry_layout at libiqo_tpu/ops/pallas_resize.py:542-591, engaged
// at :689-703,803-812, its prologue at :1242-1310.  Consecutive row tiles
// of one column tile read overlapping source row windows; the windowed form
// re-reads the source 1.31x on Lanczos3 4K->1080p luma, 8K->1080p and
// Lanczos2 720p->1080p, 1.25x on Linear 1080p->4K, 1.06x on px2 chroma and
// 1.0x on Area.  What bounds carry is the same bytes as above; what it
// saves is the re-read (carry fetches 76-80 % of the band rows where it
// engages) and, more on this card, the Y pass's dependent global loads,
// which now hit shared memory.  Blocks run in no order on Hopper, so the
// carry lives inside a block: a block owns one column tile and walks a run
// of `run` consecutive row tiles in order, keeping the run's source rows of
// its column window in a ring of `ring_rows` u8 rows in shared memory
// (16-byte-aligned pitch, beside the int32 work tile).  Source row s sits
// in ring slot s % ring_rows; the host turns the Y taps' row indices into
// slots (iyr) and gives each row tile's source rows [lo, hi) (rwin), which
// are non-decreasing in both ends across a run (cuda_resize.carry_ok).  At
// step t the block first loads tile t+1's fresh rows [max(hi_t, lo_t+1),
// hi_t+1) into slots that no row of tile t occupies (ring_rows >= hi_t+1 -
// lo_t), then runs tile t's Y pass from the ring, as the JAX schedule
// issues the next fetch before computing.  The loads are plain loads: warps
// that finish theirs go on to tile t's Y pass while others still wait, and
// no barrier separates the two because they touch disjoint slots.  The
// host picks `run` so the grid still holds about two blocks per SM.
// Where carry_ok refuses a plan the windowed instantiation runs.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "exec.cuh"

namespace {

constexpr int kTileRows = 16;     // TH: output rows per block
constexpr int kTileCols = 128;    // TW: output columns per block
constexpr int kThreads = 256;

// C++ int16_t narrowing of the low 16 bits, without an implementation-
// defined conversion.
__device__ __forceinline__ int32_t wrap16(uint32_t v) {
  return static_cast<int32_t>(v & 0xFFFFu) -
         static_cast<int32_t>((v & 0x8000u) << 1);
}

// Two's-complement reinterpretation of 32 bits.
__device__ __forceinline__ int32_t as_i32(uint32_t v) {
  return v < 0x80000000u ? static_cast<int32_t>(v)
                         : -static_cast<int32_t>(~v) - 1;
}

// floor(v / 2^k): an arithmetic right shift on every int32.
__device__ __forceinline__ int32_t shift_floor(int32_t v, int k) {
  return v >= 0 ? (v >> k) : ~((~v) >> k);
}

// sum_t plane[t * dst_w + j] * work[ix - lo] in float32, in tap order,
// without contraction, truncated toward zero.
__device__ __forceinline__ uint32_t float_taps(
    const float* __restrict__ plane, const int32_t* __restrict__ ix,
    const int32_t* wrow, int taps, int dst_w, int j, int lo) {
  float acc = 0.0f;
  for (int t = 0; t < taps; ++t) {
    const int k = t * dst_w + j;
    acc = __fadd_rn(acc, __fmul_rn(__ldg(plane + k),
                                   __int_as_float(wrow[__ldg(ix + k) - lo])));
  }
  return static_cast<uint32_t>(__float2int_rz(acc));
}

// Source rows of the column window read from device memory: column(c)
// reads column c of the window in the row it is given.
struct GlobalRows {
  const uint8_t* __restrict__ base;   // frame + window start
  long long stride;
  struct Column {
    const uint8_t* __restrict__ p;
    long long stride;
    __device__ __forceinline__ uint32_t operator()(int row) const {
      return __ldg(p + row * stride);
    }
  };
  __device__ __forceinline__ Column column(int c) const {
    return Column{base + c, stride};
  }
};

// The same rows read from the shared-memory ring, by ring slot.
struct RingRows {
  const uint8_t* ring;
  int pitch;
  struct Column {
    const uint8_t* p;
    int pitch;
    __device__ __forceinline__ uint32_t operator()(int slot) const {
      return p[slot * pitch];
    }
  };
  __device__ __forceinline__ Column column(int c) const {
    return Column{ring + c, pitch};
  }
};

// Y pass of the output rows [r0, r0 + rows) over the window's `width`
// columns: work[r][c] = sum_t cy * source(rix[t, i], c); with kWrap16 it is
// narrowed to int16 and border rows are renormalised by
// trunc(w * y_bias / deno_y); with kRelaxed it is stored as its bf16
// rounding.  rix holds source rows (GlobalRows) or ring slots (RingRows).
template <bool kWrap16, bool kRelaxed, typename Rows>
__device__ __forceinline__ void y_pass(
    int32_t* work, int win_max, int r0, int rows, int width, int dst_h,
    const int32_t* __restrict__ cy, const int32_t* __restrict__ rix,
    const int32_t* __restrict__ ydiv, int taps_y, int y_bias, Rows rows_of) {
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    const int r = e / width;
    const int c = e - r * width;
    const int i = r0 + r;
    const auto col = rows_of.column(c);
    uint32_t acc = 0;
    for (int t = 0; t < taps_y; ++t) {
      const int k = t * dst_h + i;
      acc += static_cast<uint32_t>(__ldg(cy + k)) * col(__ldg(rix + k));
    }
    int32_t w;
    if constexpr (kWrap16) {
      w = wrap16(acc);
      const int32_t d = __ldg(ydiv + i);
      if (d != 0) w = wrap16(static_cast<uint32_t>((w * y_bias) / d));  // |w*y_bias| < 2^31
    } else {
      w = static_cast<int32_t>(acc);   // <= 65280: taps >= 0, row sums <= 256
    }
    if constexpr (kRelaxed) {
      // |w| <= 65280 is exact in float32 before the rounding
      work[r * win_max + c] = __float_as_int(
          __bfloat162float(__float2bfloat16_rn(static_cast<float>(w))));
    } else {
      work[r * win_max + c] = w;
    }
  }
}

// X pass and epilogue of the output rows [r0, r0 + rows), columns
// [c0, c0 + kTileCols).  kWrap16 or kRelaxed: sums wrap in int32 as the
// reference's C accumulator; main columns (sums + half) >> out_shift,
// border columns trunc((sums + half) / (deno_x * y_bias)); then int16
// narrowing, clip.  Otherwise sums + half < 2^31, so
// (sums + half) >> out_shift, clip.
template <bool kWrap16, bool kRelaxed>
__device__ __forceinline__ void x_pass(
    const int32_t* work, int win_max, uint8_t* __restrict__ fdst, int r0,
    int rows, int c0, int dst_w, int lo,
    const int32_t* __restrict__ cx, const int32_t* __restrict__ ix,
    const int32_t* __restrict__ xdiv, int taps_x,
    const float* __restrict__ cxr, const float* __restrict__ cxd,
    int out_shift) {
  const int cols = min(kTileCols, dst_w - c0);
  const uint32_t half = 1u << (out_shift - 1);
  for (int e = threadIdx.x; e < rows * kTileCols; e += kThreads) {
    const int r = e / kTileCols;
    const int jt = e - r * kTileCols;
    if (jt >= cols) continue;
    const int j = c0 + jt;
    const int32_t* wrow = work + r * win_max;
    uint32_t acc = 0;
    if constexpr (kRelaxed) {
      acc = float_taps(cxr, ix, wrow, taps_x, dst_w, j, lo);
      if (cxd != nullptr) acc += float_taps(cxd, ix, wrow, taps_x, dst_w, j, lo);
    } else {
      for (int t = 0; t < taps_x; ++t) {
        const int k = t * dst_w + j;
        acc += static_cast<uint32_t>(__ldg(cx + k)) *
               static_cast<uint32_t>(wrow[__ldg(ix + k) - lo]);
      }
    }
    int32_t v;
    if constexpr (kWrap16 || kRelaxed) {
      const int32_t s = as_i32(acc + half);
      const int32_t d = __ldg(xdiv + j);
      // d is a nonzero multiple of y_bias (>= 2 in magnitude) on border
      // columns, so s / d cannot overflow.
      v = wrap16(static_cast<uint32_t>(d != 0 ? s / d : shift_floor(s, out_shift)));
    } else {
      v = static_cast<int32_t>((acc + half) >> out_shift);
    }
    fdst[static_cast<long long>(r0 + r) * dst_w + j] =
        static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

// Copies source rows [s0, s1) of the column window into their ring slots.
__device__ __forceinline__ void load_rows(
    uint8_t* ring, int pitch, int ring_rows, const uint8_t* __restrict__ base,
    long long stride, int width, int s0, int s1) {
  for (int e = threadIdx.x; e < (s1 - s0) * width; e += kThreads) {
    const int k = e / width;
    const int c = e - k * width;
    const int s = s0 + k;
    ring[(s % ring_rows) * pitch + c] = __ldg(base + s * stride + c);
  }
}

// Tables are tap-major: coef[t * n_dst + i].  ydiv/xdiv hold the border
// divisor of each output row/column, 0 on main outputs (unread when
// kWrap16 is false).  cxr/cxd are the relaxed coefficient planes, read
// only when kRelaxed; cxd may be null.  win holds [lo, hi) of each column
// tile's source window.  With kCarry, rwin holds [lo, hi) of each row
// tile's source rows, iyr the ring slot of every Y tap (tap-major, as iy),
// and blockIdx.y indexes runs of `run` row tiles of kTileRows rows;
// otherwise they are unread and blockIdx.y is the row tile of tile_rows
// (<= kTileRows) rows.
template <bool kWrap16, bool kRelaxed, bool kCarry>
__global__ void __launch_bounds__(kThreads) resize_fused_kernel(
    const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
    long long src_frame_stride, long long src_row_stride,
    int dst_h, int dst_w, int tile_rows,
    const int32_t* __restrict__ cy, const int32_t* __restrict__ iy,
    const int32_t* __restrict__ ydiv, int taps_y, int y_bias,
    const int32_t* __restrict__ cx, const int32_t* __restrict__ ix,
    const int32_t* __restrict__ xdiv, int taps_x,
    const float* __restrict__ cxr, const float* __restrict__ cxd,
    const int32_t* __restrict__ win, int win_max, int out_shift,
    const int32_t* __restrict__ rwin, const int32_t* __restrict__ iyr,
    int ring_rows, int ring_pitch, int run) {
  // [tile_rows][win_max]: int32 work rows, or with kRelaxed the bits of
  // their bf16-rounded float values; with kCarry ([kTileRows][win_max])
  // the u8 ring [ring_rows][ring_pitch] follows
  extern __shared__ int32_t work[];

  const uint8_t* fsrc = src + static_cast<long long>(blockIdx.z) * src_frame_stride;
  uint8_t* fdst = dst + static_cast<long long>(blockIdx.z) * dst_h * dst_w;
  const int lo = win[2 * blockIdx.x];
  const int width = win[2 * blockIdx.x + 1] - lo;
  const int c0 = blockIdx.x * kTileCols;

  if constexpr (!kCarry) {
    const int r0 = blockIdx.y * tile_rows;
    const int rows = min(tile_rows, dst_h - r0);
    y_pass<kWrap16, kRelaxed>(work, win_max, r0, rows, width, dst_h, cy, iy,
                              ydiv, taps_y, y_bias,
                              GlobalRows{fsrc + lo, src_row_stride});
    __syncthreads();
    x_pass<kWrap16, kRelaxed>(work, win_max, fdst, r0, rows, c0, dst_w, lo,
                              cx, ix, xdiv, taps_x, cxr, cxd, out_shift);
  } else {
    uint8_t* ring = reinterpret_cast<uint8_t*>(work + kTileRows * win_max);
    const uint8_t* base = fsrc + lo;
    const int n_tiles = (dst_h + kTileRows - 1) / kTileRows;
    const int t0 = blockIdx.y * run;
    const int t1 = min(t0 + run, n_tiles);
    load_rows(ring, ring_pitch, ring_rows, base, src_row_stride, width,
              __ldg(rwin + 2 * t0), __ldg(rwin + 2 * t0 + 1));
    __syncthreads();
    for (int t = t0; t < t1; ++t) {
      if (t + 1 < t1) {
        // tile t+1's fresh rows, into slots tile t does not read
        load_rows(ring, ring_pitch, ring_rows, base, src_row_stride, width,
                  max(__ldg(rwin + 2 * t + 1), __ldg(rwin + 2 * t + 2)),
                  __ldg(rwin + 2 * t + 3));
      }
      const int r0 = t * kTileRows;
      const int rows = min(kTileRows, dst_h - r0);
      y_pass<kWrap16, kRelaxed>(work, win_max, r0, rows, width, dst_h, cy, iyr,
                                ydiv, taps_y, y_bias,
                                RingRows{ring, ring_pitch});
      __syncthreads();   // work rows complete; tile t+1's rows landed
      x_pass<kWrap16, kRelaxed>(work, win_max, fdst, r0, rows, c0, dst_w, lo,
                                cx, ix, xdiv, taps_x, cxr, cxd, out_shift);
      __syncthreads();   // work rows read before tile t+1 rewrites them
    }
  }
}

using Kernel = decltype(&resize_fused_kernel<true, false, false>);

// The instantiation for (wrap16, relaxed, carry).
Kernel pick(int wrap16, int relaxed, int carry) {
  static const Kernel kernels[8] = {
      &resize_fused_kernel<false, false, false>,
      &resize_fused_kernel<false, false, true>,
      &resize_fused_kernel<false, true, false>,
      &resize_fused_kernel<false, true, true>,
      &resize_fused_kernel<true, false, false>,
      &resize_fused_kernel<true, false, true>,
      &resize_fused_kernel<true, true, false>,
      &resize_fused_kernel<true, true, true>};
  return kernels[(wrap16 ? 4 : 0) | (relaxed ? 2 : 0) | (carry ? 1 : 0)];
}

// The kernel's arguments but the source, the output and the strides.
struct FusedArgs {
  int dst_h, dst_w, tile_rows;
  const int32_t *cy, *iy, *ydiv;
  int taps_y, y_bias;
  const int32_t *cx, *ix, *xdiv;
  int taps_x;
  const float *cxr, *cxd;
  const int32_t* win;
  int win_max, out_shift;
  const int32_t *rwin, *iyr;
  int ring_rows, ring_pitch, run;
};

struct FusedExec final : iqo::Exec {
  Kernel kernel = nullptr;
  dim3 grid;                 // of one frame
  int smem = 0;
  FusedArgs a{};

  int launch(const void* src, void* dst, int n_frames, long long frame_stride,
             long long row_stride, cudaStream_t stream) const override {
    if (!iqo::frames_ok(n_frames)) return static_cast<int>(cudaErrorInvalidValue);
    const FusedArgs r = a;
    kernel<<<dim3(grid.x, grid.y, n_frames), kThreads, smem, stream>>>(
        static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), frame_stride, row_stride,
        r.dst_h, r.dst_w, r.tile_rows, r.cy, r.iy, r.ydiv, r.taps_y, r.y_bias, r.cx, r.ix,
        r.xdiv, r.taps_x, r.cxr, r.cxd, r.win, r.win_max, r.out_shift, r.rwin, r.iyr,
        r.ring_rows, r.ring_pitch, r.run);
    return static_cast<int>(cudaGetLastError());
  }
};

// Packs one windowed resize into e: the instantiation for (wrap16, relaxed,
// carry), the record and the geometry of one frame.  Returns a cudaError_t.
int pack(FusedExec& e, int wrap16, int relaxed, int carry, int dst_h, int dst_w,
         int tile_rows, const void* cy, const void* iy, const void* ydiv, int taps_y,
         int y_bias, const void* cx, const void* ix, const void* xdiv, int taps_x,
         const void* cxr, const void* cxd, const void* win, int win_max, int out_shift,
         const void* rwin, const void* iyr, int ring_rows, int ring_pitch, int run) {
  if (tile_rows < 1 || tile_rows > kTileRows || (carry && tile_rows != kTileRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
  e.a = FusedArgs{dst_h, dst_w, tile_rows, i32(cy), i32(iy), i32(ydiv), taps_y, y_bias,
                  i32(cx), i32(ix), i32(xdiv), taps_x, static_cast<const float*>(cxr),
                  static_cast<const float*>(cxd), i32(win), win_max, out_shift, i32(rwin),
                  i32(iyr), ring_rows, ring_pitch, run};
  e.kernel = pick(wrap16, relaxed, carry);
  e.smem = tile_rows * win_max * static_cast<int>(sizeof(int32_t));
  const int row_tiles = (dst_h + tile_rows - 1) / tile_rows;
  int grid_y = row_tiles;
  if (carry) {
    e.smem += ring_rows * ring_pitch;
    grid_y = (row_tiles + run - 1) / run;
  }
  e.grid = dim3((dst_w + kTileCols - 1) / kTileCols, grid_y, 1);
  e.out_frame = static_cast<long long>(dst_h) * dst_w;
  return 0;
}

}  // namespace

extern "C" {

// Tile shape, read by the host to compute the column windows.
int iqo_tile_shape(int* rows, int* cols) {
  *rows = kTileRows;
  *cols = kTileCols;
  return 0;
}

const char* iqo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Raises the eight instantiations' dynamic shared-memory limit on the
// current device to `bytes`; called once per device before its first
// launch.  Returns a cudaError_t.
int iqo_set_max_smem(int bytes) {
  for (int k = 0; k < 8; ++k) {
    cudaError_t rc = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(pick(k & 4, k & 2, k & 1)),
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return 0;
}

// The executable of one windowed resize: the kWrap16 instantiation when
// wrap16 is nonzero, its relaxed form when relaxed is nonzero (cxr then
// holds the bf16 plane; cxd the residual plane or null), and its carry form
// when carry is nonzero (rwin, iyr, ring_rows, ring_pitch and run then
// describe the ring; otherwise they are unread).  Without carry a block
// computes tile_rows output rows (1..kTileRows); the carry form takes
// kTileRows, and tile_rows must be kTileRows.  The shared memory (work
// tile, and the ring with carry) must be within the limit set by
// iqo_set_max_smem.  Writes the handle to *out.  Returns a cudaError_t.
int iqo_resize_fused_exec_create(int wrap16, int relaxed, int carry, int dst_h, int dst_w,
                                 int tile_rows, const void* cy, const void* iy,
                                 const void* ydiv, int taps_y, int y_bias, const void* cx,
                                 const void* ix, const void* xdiv, int taps_x,
                                 const void* cxr, const void* cxd, const void* win,
                                 int win_max, int out_shift, const void* rwin,
                                 const void* iyr, int ring_rows, int ring_pitch, int run,
                                 void** out) {
  FusedExec e;
  const int rc = pack(e, wrap16, relaxed, carry, dst_h, dst_w, tile_rows, cy, iy, ydiv, taps_y,
                      y_bias, cx, ix, xdiv, taps_x, cxr, cxd, win, win_max, out_shift, rwin,
                      iyr, ring_rows, ring_pitch, run);
  return iqo::create(e, rc, out);
}

// Launches one resize of n_frames frames on `stream`: the executable of
// iqo_resize_fused_exec_create with the same arguments, made on the stack
// and launched once.  Allocates nothing; dst is contiguous (n_frames,
// dst_h, dst_w).  Returns a cudaError_t.
int iqo_resize_fused(int wrap16, int relaxed, int carry, const void* src,
                     void* dst, int n_frames, long long src_frame_stride,
                     long long src_row_stride, int dst_h, int dst_w,
                     int tile_rows,
                     const void* cy, const void* iy, const void* ydiv,
                     int taps_y, int y_bias,
                     const void* cx, const void* ix, const void* xdiv,
                     int taps_x, const void* cxr, const void* cxd,
                     const void* win, int win_max, int out_shift,
                     const void* rwin, const void* iyr, int ring_rows,
                     int ring_pitch, int run, void* stream) {
  FusedExec e;
  const int rc = pack(e, wrap16, relaxed, carry, dst_h, dst_w, tile_rows, cy, iy, ydiv, taps_y,
                      y_bias, cx, ix, xdiv, taps_x, cxr, cxd, win, win_max, out_shift, rwin,
                      iyr, ring_rows, ring_pitch, run);
  if (rc != 0) return rc;
  return e.launch(src, dst, n_frames, src_frame_stride, src_row_stride,
                  static_cast<cudaStream_t>(stream));
}

// Launches the executable `exec` (any iqo_resize_*_exec_create's) on
// n_frames frames of src into dst, as its iqo_resize_* entry would.
// Returns a cudaError_t.
int iqo_exec_launch(const void* exec, const void* src, void* dst, int n_frames,
                    long long src_frame_stride, long long src_row_stride, void* stream) {
  return static_cast<const iqo::Exec*>(exec)->launch(
      src, dst, n_frames, src_frame_stride, src_row_stride, static_cast<cudaStream_t>(stream));
}

// One YUV420 step of n_frames frames in one call: luma's executable on y
// into oy, chroma's on U and V into the two halves of ouv (contiguous (2
// n_frames, dst_h / 2, dst_w / 2): U's frames, then V's).  A lone frame
// whose U and V share a row stride takes one chroma launch of two frames,
// the second at the distance from U to V; otherwise U and V take a launch
// each.  Nothing is copied.  Returns the number of launches, 2 or 3, or
// minus a cudaError_t.
int iqo_exec_launch_frame(const void* luma, const void* chroma, int n_frames, const void* y,
                          long long y_frame_stride, long long y_row_stride, void* oy,
                          const void* u, long long u_frame_stride, long long u_row_stride,
                          const void* v, long long v_frame_stride, long long v_row_stride,
                          void* ouv, void* stream) {
  const auto* l = static_cast<const iqo::Exec*>(luma);
  const auto* c = static_cast<const iqo::Exec*>(chroma);
  const auto s = static_cast<cudaStream_t>(stream);
  int rc = l->launch(y, oy, n_frames, y_frame_stride, y_row_stride, s);
  if (rc != 0) return -rc;
  if (n_frames == 1 && u_row_stride == v_row_stride) {
    const long long gap = static_cast<long long>(reinterpret_cast<uintptr_t>(v)) -
                          static_cast<long long>(reinterpret_cast<uintptr_t>(u));
    rc = c->launch(u, ouv, 2, gap, u_row_stride, s);
    return rc != 0 ? -rc : 2;
  }
  rc = c->launch(u, ouv, n_frames, u_frame_stride, u_row_stride, s);
  if (rc != 0) return -rc;
  rc = c->launch(v, static_cast<uint8_t*>(ouv) + n_frames * c->out_frame, n_frames,
                 v_frame_stride, v_row_stride, s);
  return rc != 0 ? -rc : 3;
}

// Frees an executable.  Its tables are the host's and stay.
void iqo_exec_destroy(void* exec) { delete static_cast<iqo::Exec*>(exec); }

}  // extern "C"
