// Tiled separable resize for Hopper (sm_90a): the exact windowed
// instantiations of resize_fused.cu (<true, false, false>, wrap16, and
// <false, false, false>, u16) redesigned around a staged source band.  It
// computes what they compute, byte for byte: uint32 accumulators, the int16
// wrap of the work rows, the Y-border renormalisation, int32-wrapping X
// sums, and the truncating border-column divide by C++ `/`
// (libiqo_tpu_torch/golden/numpy_ref.py is the contract).
//
// Replaces the TPU kernel libiqo_tpu/ops/pallas_resize.py _make_padless_fn
// (pl.pallas_call at :1687) -> kernel/_frame on the main path: K1+K2, the
// Lanczos plans (s8 Y dot with the ^0x80 rebase and corr_y, int16 wrap,
// y_cond border rows, x_slab border columns, _exact_trunc_div :79-129), and
// K3+K4, the Area and Linear plans (u16 work rows, x_u8work :956-962).
//
// What bounds it on the H100: bytes.  One YUV420 frame reads each source
// byte once and writes each output byte once: 15.55 MB for Lanczos3
// 4K->1080p (4.6 us at 3.35 TB/s) and 3.46 MB for Area 1080p->360p
// (1.0 us).  Its ~90 M multiply-adds are far under the card's rates.
//
// What the design does about it, one block per TH x TW output tile:
// 1. The block stages its source band once: rows [rlo, rlo + bh) of its row
//    tile and columns [lo - mis, lo + width) of its column tile, in 16-byte
//    cp.async copies where the rows' pitch is a multiple of 16 (mis, the
//    source address's low 4 bits, aligns the copies down), and in byte loads
//    otherwise and at the plane's edges, which never read outside a row.
//    The band's 16-byte pieces are swizzled by row (piece ^ 2 ((r >> 2) &
//    3)) at a 128-byte-multiple pitch, so the Y pass's word loads hit 32
//    banks.  The inner loops then issue no global load.
// 2. The host's row and column tile records (cuda_resize.tiled_layout:
//    band windows, tap offsets relative to the band, coefficients, border
//    divisors) are copied into shared memory once per block, as cp.async
//    copies issued with the band's.
// 3. Y pass.  kS8Y: on the tensor cores, mma.sync m16n8k32 s8 -> s32, with
//    M the 16 rows of the tile, K the band's rows (padded to k_rows, where
//    A is zero) and N the band's columns; A is the tile's merged Y matrix
//    (clamped taps that read one row add), B the band rebased as u8 ^ 0x80,
//    and the row's 128 * sum cy is added back in uint32 before the wrap.
//    B's fragments are word loads transposed with __byte_perm, as kernel E
//    (csrc/exp/exp_band.cu).  Plans whose merged taps do not fit s8 (Area
//    2:1, Linear upscales, px_scale >= 3) run an IMAD Y pass over the same
//    band, 8 columns a thread.
// 4. The work tile stays in shared memory at 16 bits (int16 after the wrap
//    and border renorm, u16 <= 65280), at a pitch of 32 mod 64 columns: a
//    2:1 X pass reads it without bank conflicts.
// 5. X pass on CUDA cores, kernel J's answer: each thread computes TW / 16
//    outputs of one row, 16 apart (neighbouring lanes take neighbouring
//    outputs, so a 2:1 pass reads 32 distinct banks; adjacent outputs per
//    thread would put 4 lanes on a bank), from each output's first tap
//    (unclamped: taps outside the plane have coefficient 0 and read the
//    work tile's margins, whatever they hold) and its phase's coefficients,
//    one broadcast load per tap where the column tile has one phase; signed
//    16-bit loads, uint32 multiply-adds, then the shared epilogue, whose
//    border divide runs only in column tiles that have border columns.
// 6. TW (128, 64 or 32) is chosen per plan by the host so that a frame's
//    grid holds about two blocks per SM; TH is 16, the m16 of the Y dot.
//
// Intended wraps are done in uint32_t (signed overflow is undefined in C++);
// int16 narrowing, two's-complement reinterpretation and the arithmetic
// right shift are written out explicitly, as in resize_fused.cu.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;         // TH: output rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHead = 4;          // header words of a tile record
constexpr int kWidths[3] = {128, 64, 32};

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

// Byte offset of band (row r, byte column c): 16-byte pieces swizzled by
// row inside each 128-byte group (the pitch is a multiple of 128).
__device__ __forceinline__ int swz(int r, int c, int pitch) {
  return r * pitch + ((((c >> 4) ^ (((r >> 2) & 3) << 1))) << 4) + (c & 15);
}

// o[p] = byte p of w0, w1, w2, w3, in that order (a 4 x 4 byte transpose).
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4], uint32_t (&o)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
  o[0] = __byte_perm(lo01, lo23, 0x5410);
  o[1] = __byte_perm(lo01, lo23, 0x7632);
  o[2] = __byte_perm(hi01, hi23, 0x5410);
  o[3] = __byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragments of band rows kb .. kb + 31 for the four n-tiles of a lane
// (kernel E's b_frags<true>): b[h][p] holds rows kb + 16 h + 4 t .. + 3 of
// byte column 4 wc + p, rebased u8 -> s8 by ^ 0x80.
__device__ __forceinline__ void b_frags(const uint8_t* band, int pitch, int kb, int t,
                                        int wc, uint32_t (&b)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = *reinterpret_cast<const uint32_t*>(
                 band + swz(kb + 16 * h + 4 * t + j, 4 * wc, pitch)) ^ 0x80808080u;
    transpose4(w, b[h]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}

// The work value of a Y sum: kWrap16 narrows it to int16 and renormalises
// border rows (d != 0) by trunc(w * y_bias / d); u16 keeps it (<= 65280).
// Returned as the 16 bits the work tile stores.
template <bool kWrap16>
__device__ __forceinline__ uint32_t work_bits(uint32_t acc, int32_t d, int y_bias) {
  if constexpr (kWrap16) {
    int32_t w = wrap16(acc);
    if (d != 0) w = wrap16(static_cast<uint32_t>((w * y_bias) / d));  // |w*y_bias| < 2^31
    return static_cast<uint32_t>(w) & 0xFFFFu;
  } else {
    return acc & 0xFFFFu;
  }
}

// The work tile's element: int16 (kWrap16), loaded sign-extended, or u16.
template <bool kWrap16>
using Work = std::conditional_t<kWrap16, int16_t, uint16_t>;

// Stores 8 work values of row `row`, band columns c .. c + 7, as one
// 16-byte store.
template <bool kWrap16>
__device__ __forceinline__ void store8(uint16_t* work, int work_pitch, int margin, int row,
                                       int c, const uint32_t (&acc)[8], uint32_t corr,
                                       int32_t d, int y_bias) {
  uint32_t v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = work_bits<kWrap16>(acc[e] + corr, d, y_bias);
  *reinterpret_cast<uint4*>(work + row * work_pitch + margin + c) =
      make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16, v[6] | v[7] << 16);
}

struct TiledArgs {
  const uint8_t* src;
  uint8_t* dst;
  long long frame_stride, row_stride;
  int src_w, dst_h, dst_w;
  const int32_t* rrec;        // (row tiles, rrec_words)
  const int32_t* crec;        // (column tiles, crec_words)
  int rrec_words, crec_words;
  int taps_y, taps_x;
  int k_rows, pitch, margin, work_pitch, max_phases;
  int y_bias, out_shift;
};

// Tile records (cuda_resize.TiledLayout).  Row: [rlo, bh, 0, 0], corr[16],
// ydiv[16], then with kS8Y A (16 rows of k_rows + 16 s8 bytes), else
// cy[taps_y][16], iyr[taps_y][16].  Column: [lo, width, phases, border],
// xs[TW], ph[TW], xdiv[TW], cxu[taps_x][max_phases].
template <bool kWrap16, bool kS8Y, int kTW>
__global__ void __launch_bounds__(kThreads) resize_tiled_kernel(TiledArgs a) {
  // [k_rows][pitch] u8 band | [16][work_pitch] u16 work | row record |
  // column record
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* band = smem;
  uint16_t* work = reinterpret_cast<uint16_t*>(smem + a.k_rows * a.pitch);
  int32_t* rrec = reinterpret_cast<int32_t*>(work + kRows * a.work_pitch);
  int32_t* crec = rrec + a.rrec_words;

  const int tid = threadIdx.x;
  const int32_t* grrec = a.rrec + static_cast<long long>(blockIdx.y) * a.rrec_words;
  const int32_t* gcrec = a.crec + static_cast<long long>(blockIdx.x) * a.crec_words;
  const int rlo = __ldg(grrec), bh = __ldg(grrec + 1);
  const int lo = __ldg(gcrec), width = __ldg(gcrec + 1);

  // 1-2. the two records and the band, all as asynchronous copies behind
  // the one dependent load of the headers above
  for (int i = tid; i < a.rrec_words / 4; i += kThreads) cp_async16(rrec + 4 * i, grrec + 4 * i);
  for (int i = tid; i < a.crec_words / 4; i += kThreads) cp_async16(crec + 4 * i, gcrec + 4 * i);
  const uint8_t* row0 = a.src + static_cast<long long>(blockIdx.z) * a.frame_stride +
                        static_cast<long long>(rlo) * a.row_stride;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row0 + lo) & 15);
  const bool vec = (a.row_stride & 15) == 0;
  const int c_base = lo - mis;                  // source column of band column 0
  const int nchunk = (mis + width + 15) >> 4;
  for (int e = tid; e < bh * nchunk; e += kThreads) {
    const int r = e / nchunk;
    const int c = (e - r * nchunk) << 4;
    const int col = c_base + c;
    const uint8_t* g = row0 + static_cast<long long>(r) * a.row_stride + col;
    uint8_t* s = band + swz(r, c, a.pitch);
    if (vec && col >= 0 && col + 16 <= a.src_w) {
      cp_async16(s, g);
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (col + b >= 0 && col + b < a.src_w) s[b] = __ldg(g + b);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // 3. Y pass into the work tile, band columns [0, mis + width) rounded up
  const uint32_t* corr = reinterpret_cast<const uint32_t*>(rrec + kHead);
  const int32_t* ydiv = rrec + kHead + kRows;
  const int32_t* ytab = rrec + kHead + 2 * kRows;
  if constexpr (kS8Y) {
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
    const uint8_t* amat = reinterpret_cast<const uint8_t*>(ytab);
    const int ka = a.k_rows + 16;
    const int groups = (mis + width + 31) >> 5;
    for (int grp = warp; grp < groups; grp += kWarps) {
      int acc[4][4] = {};
      for (int kb = 0; kb < a.k_rows; kb += 32) {
        uint32_t af[4], b[2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          af[i] = *reinterpret_cast<const uint32_t*>(
              amat + (g + 8 * (i & 1)) * ka + kb + 16 * (i >> 1) + 4 * q);
        b_frags(band, a.pitch, kb, q, 8 * grp + g, b);
#pragma unroll
        for (int p = 0; p < 4; ++p) mma_s8(acc[p], af, b[0][p], b[1][p]);
      }
      // acc[p][2 rh + ec]: row g + 8 rh, band column 32 grp + 8 q + 4 ec + p
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        const int row = g + 8 * rh;
        uint32_t v[8];
#pragma unroll
        for (int ec = 0; ec < 2; ++ec)
#pragma unroll
          for (int p = 0; p < 4; ++p) v[4 * ec + p] = static_cast<uint32_t>(acc[p][2 * rh + ec]);
        store8<kWrap16>(work, a.work_pitch, a.margin, row, 32 * grp + 8 * q, v, corr[row],
                        ydiv[row], a.y_bias);
      }
    }
  } else {
    const int32_t* cy = ytab;
    const int32_t* iyr = ytab + a.taps_y * kRows;
    const int n8 = (mis + width + 7) >> 3;
    for (int e = tid; e < kRows * n8; e += kThreads) {
      const int row = e / n8;
      const int c = (e - row * n8) << 3;
      uint32_t acc[8] = {};
      for (int t = 0; t < a.taps_y; ++t) {
        const uint32_t cf = static_cast<uint32_t>(cy[t * kRows + row]);
        const uint2 w = *reinterpret_cast<const uint2*>(band + swz(iyr[t * kRows + row], c, a.pitch));
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[b] += cf * ((w.x >> (8 * b)) & 0xFFu);
          acc[4 + b] += cf * ((w.y >> (8 * b)) & 0xFFu);
        }
      }
      store8<kWrap16>(work, a.work_pitch, a.margin, row, c, acc, 0u, ydiv[row], a.y_bias);
    }
  }
  __syncthreads();

  // 5. X pass and epilogue: row tid / 16, outputs (tid % 16) + 16 k
  constexpr int kPer = kTW / 16;
  const int r = tid >> 4, l = tid & 15;
  const int r0 = blockIdx.y * kRows, c0 = blockIdx.x * kTW;
  if (r0 + r >= a.dst_h) return;
  const int cols = min(kTW, a.dst_w - c0);
  const int32_t* xs = crec + kHead;
  const int32_t* ph = xs + kTW;
  const int32_t* xdiv = ph + kTW;
  const int32_t* cxu = xdiv + kTW;
  const Work<kWrap16>* wrow =
      reinterpret_cast<const Work<kWrap16>*>(work + r * a.work_pitch + a.margin + mis);
  const Work<kWrap16>* base[kPer];
  uint32_t acc[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    base[k] = wrow + xs[l + 16 * k];
    acc[k] = 0;
  }
  if (crec[2] == 1) {            // one phase: a broadcast coefficient per tap
    for (int t = 0; t < a.taps_x; ++t) {
      const uint32_t cf = static_cast<uint32_t>(cxu[t * a.max_phases]);
#pragma unroll
      for (int k = 0; k < kPer; ++k) acc[k] += cf * static_cast<uint32_t>(base[k][t]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int32_t* c = cxu + ph[l + 16 * k];
      for (int t = 0; t < a.taps_x; ++t)
        acc[k] += static_cast<uint32_t>(c[t * a.max_phases]) * static_cast<uint32_t>(base[k][t]);
    }
  }
  const uint32_t half = 1u << (a.out_shift - 1);
  uint8_t* out = a.dst + static_cast<long long>(blockIdx.z) * a.dst_h * a.dst_w +
                 static_cast<long long>(r0 + r) * a.dst_w + c0;
  const bool border = kWrap16 && crec[3] != 0;    // the tile has border columns
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = l + 16 * k;
    if (j >= cols) continue;
    int32_t v;
    if constexpr (kWrap16) {
      const int32_t s = as_i32(acc[k] + half);
      v = shift_floor(s, a.out_shift);
      // d is a nonzero multiple of y_bias (>= 2 in magnitude) on border
      // columns, so s / d cannot overflow.
      if (border && xdiv[j] != 0) v = s / xdiv[j];
      v = wrap16(static_cast<uint32_t>(v));
    } else {
      v = static_cast<int32_t>((acc[k] + half) >> a.out_shift);
    }
    out[j] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

using Kernel = decltype(&resize_tiled_kernel<true, true, 128>);

template <int kTW>
Kernel pick_w(int wrap16, int s8y) {
  static const Kernel kernels[4] = {
      &resize_tiled_kernel<false, false, kTW>, &resize_tiled_kernel<false, true, kTW>,
      &resize_tiled_kernel<true, false, kTW>, &resize_tiled_kernel<true, true, kTW>};
  return kernels[(wrap16 ? 2 : 0) | (s8y ? 1 : 0)];
}

// The instantiation for (wrap16, s8y, tw), or null for a width not in kWidths.
Kernel pick(int wrap16, int s8y, int tw) {
  switch (tw) {
    case 128: return pick_w<128>(wrap16, s8y);
    case 64: return pick_w<64>(wrap16, s8y);
    case 32: return pick_w<32>(wrap16, s8y);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Rows per tile and the column widths the tiled kernel is built for, read by
// the host (cuda_resize.TILED_WIDTHS).  Returns the number of widths.
int iqo_tiled_shape(int* rows, int* widths, int n) {
  *rows = kRows;
  for (int i = 0; i < 3 && i < n; ++i) widths[i] = kWidths[i];
  return 3;
}

// Raises the twelve instantiations' dynamic shared-memory limit on the
// current device to `bytes`.  Returns a cudaError_t.
int iqo_tiled_set_max_smem(int bytes) {
  for (int tw : kWidths)
    for (int k = 0; k < 4; ++k) {
      cudaError_t rc = cudaFuncSetAttribute(reinterpret_cast<const void*>(pick(k & 2, k & 1, tw)),
                                            cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
  return 0;
}

// Launches one tiled resize of n_frames frames on `stream`: the wrap16
// (Lanczos) or u16 (Area, Linear) instantiation, its Y pass on the tensor
// cores when s8y is nonzero, tw output columns per block.  Allocates
// nothing; dst is contiguous (n_frames, dst_h, dst_w); source rows are
// contiguous at any pitch and base address.  Returns a cudaError_t.
int iqo_resize_tiled(int wrap16, int s8y, int tw, const void* src, void* dst,
                     int n_frames, long long src_frame_stride,
                     long long src_row_stride, int src_w, int dst_h, int dst_w,
                     const void* rrec, int rrec_words, const void* crec,
                     int crec_words, int taps_y, int taps_x, int k_rows,
                     int pitch, int margin, int work_pitch, int max_phases,
                     int y_bias, int out_shift, void* stream) {
  const Kernel kernel = pick(wrap16, s8y, tw);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const TiledArgs a{static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
                    src_frame_stride, src_row_stride, src_w, dst_h, dst_w,
                    static_cast<const int32_t*>(rrec), static_cast<const int32_t*>(crec),
                    rrec_words, crec_words, taps_y, taps_x, k_rows, pitch, margin,
                    work_pitch, max_phases, y_bias, out_shift};
  const int smem = k_rows * pitch + kRows * work_pitch * 2 + 4 * (rrec_words + crec_words);
  const dim3 grid((dst_w + tw - 1) / tw, (dst_h + kRows - 1) / kRows, n_frames);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
