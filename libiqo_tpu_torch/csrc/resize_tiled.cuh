// Tiled separable resize for Hopper (sm_90a): the kernel template and its
// launcher, shared by the translation units that instantiate its forms
// (resize_tiled.cu: the exact form and the C entry points;
// resize_tiled_relaxed.cu, resize_tiled_carry.cu and
// resize_tiled_relaxed_carry.cu: one form each, so that nvcc builds the four
// side by side).
//
// The exact form is the windowed instantiations of resize_fused.cu
// (<true, false, false>, wrap16, and <false, false, false>, u16) redesigned
// around a staged source band.  It computes what they compute, byte for
// byte: uint32 accumulators, the int16 wrap of the work rows, the Y-border
// renormalisation, int32-wrapping X sums, and the truncating border-column
// divide by C++ `/` (libiqo_tpu_torch/golden/numpy_ref.py is the contract).
//
// Replaces the TPU kernel libiqo_tpu/ops/pallas_resize.py _make_padless_fn
// (pl.pallas_call at :1687) -> kernel/_frame on the main path: K1+K2, the
// Lanczos plans (s8 Y dot with the ^0x80 rebase and corr_y, int16 wrap,
// y_cond border rows, x_slab border columns, _exact_trunc_div :79-129), and
// K3+K4, the Area and Linear plans (u16 work rows, x_u8work :956-962); and
// in its two opt-in forms K7, the relaxed X scheme (kRelaxed, below), and
// K9, the row-halo carry (kCarry, below).
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
//    and border renorm, u16 <= 65280), at a pitch of 32 mod 64 columns for
//    the per-tap X pass (16-byte stores of the Y pass) and 36 mod 64 for
//    the window form (5b; rows 8-byte aligned, two 8-byte stores).
// 5. X pass on CUDA cores, kernel J's answer: each thread computes TW / 16
//    outputs of one row from each output's first tap (unclamped: in the
//    exact form taps outside the plane have coefficient 0 and read the work
//    tile's margins, whatever they hold) and its phase's coefficients, one
//    broadcast load per tap where the column tile has one phase; uint32
//    multiply-adds in tap order, then the shared epilogue, whose border
//    divide runs only in column tiles that have border columns.
//    a. Per tap (the relaxed form, and exact plans the window does not
//       take): the thread's outputs lie 16 apart (neighbouring lanes take
//       neighbouring outputs, so a 2:1 pass reads 32 distinct banks), one
//       16-bit load per tap and output, one byte store per output.
//    b. Window (exact plans whose output starts step by a whole x_step <=
//       kXSteps source columns, and whose thread windows, x_step (TW/16 - 1)
//       + taps values, fit kXWindow: cuda_resize.tiled_layout decides): the
//       thread's outputs are adjacent, so their taps overlap (at 2:1, 10 of
//       12), and the thread loads their union once as 32-bit words (an odd
//       start in the first word's high half, in code of its own), takes
//       each tap's value from its registers, and writes its outputs as one
//       store.  A warp holds 8 threads of 4 rows each, which with the 36
//       mod 64 pitch puts at most 2 lanes on a bank.  The window form's
//       instantiations are kernels of their own, with a register bound.
// 6. TW (128, 64 or 32) is chosen per plan by the host so that a frame's
//    grid holds about two blocks per SM; TH is 16, the m16 of the Y dot.
//
// kRelaxed replaces the TPU's relaxed X scheme (K7): the relaxed build of
// libiqo_tpu/ops/pallas_resize.py:943-1024 with _bf16_relaxed_plane
// (:163-197) and its X pass (:1486-1505), as resize_fused.cu's <*, true, *>
// forms do, byte for byte with them and with torch_resize.resize_relaxed.
// The Y pass is the exact one; each work value is rounded to bf16 and the
// work tile holds those 16 bits.  The X pass stays on CUDA cores: per
// output, acc = __fadd_rn(acc, __fmul_rn(c[t], w[t])) over the taps in
// order from 0.0f, then __float2int_rz, once over the repaired bf16 plane
// and, where the host could not repair a column, once more over the
// residual plane; the integer sums meet the exact epilogue.  bf16 x bf16
// products are exact in float32, so the order of the adds is the one
// freedom, and it is fixed: a bf16 mma.sync/wgmma X pass would sum in the
// unit's own order and lose byte equality with the plain version (and
// kernel J found the CUDA-core correlation 42x faster than four bf16 dots
// for one phase).  The column record carries each phase's planes as float32
// bits in place of the integer taps.  The plain version reads an
// out-of-plane tap at the clamped edge column, and the column-sum repair can
// give such a tap a nonzero relaxed coefficient (Lanczos2 720p -> 1080p),
// so in column tiles at the plane's edges the work columns outside the
// plane take the edge column's value before the X pass.  Every float is
// formed from work values the Y pass or that fill wrote: bf16 of an
// integer, never Inf or NaN.
//
// kCarry replaces the TPU's row-halo carry mode (K9, LIBIQO_TPU_CARRY):
// _Carry/_carry_layout at libiqo_tpu/ops/pallas_resize.py:542-591, engaged
// at :689-703,803-812, its prologue at :1242-1310.  Consecutive row tiles
// of one column tile read overlapping source rows.  Blocks run in no order
// on Hopper, so the carry lives inside a block: it owns one column tile and
// a run of `run` consecutive row tiles (cuda_resize.tiled_carry_layout
// picks TW and the run together, for about two blocks per SM), and keeps
// their band rows in a ring of `slots` rows in shared memory: source row s
// in slot s % slots, the swizzle keyed on the slot.  Before computing tile
// i the block issues the cp.async copies of tile i+1's fresh rows
// [max(hi_i, lo_i+1), hi_i+1) and of its row record (into the second of two
// record buffers); it computes tile i's Y and X passes from the ring, then
// waits and synchronises, as the JAX schedule issues the next fetch before
// computing.  Each tile's K window for the Y dot ends at its band's last
// row (A's origin, record word 0, is hi - k_rows): its padded rows are
// rows of earlier tiles, never the slots being filled, which the host's
// ring size (slots >= k_rows + the largest fresh count of a run) keeps
// apart; A is zero on them.  The output is byte-equal to the tiled and
// windowed forms.
//
// Intended wraps are done in uint32_t (signed overflow is undefined in C++);
// int16 narrowing, two's-complement reinterpretation and the arithmetic
// right shift are written out explicitly, as in resize_fused.cu.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace iqo_tiled {

constexpr int kRows = 16;         // TH: output rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHead = 4;          // header words of a tile record
constexpr int kWidths[3] = {128, 64, 32};
constexpr int kXWindow = 26;      // most work values a thread's X window holds
constexpr int kXSteps = 3;        // largest step between outputs' starts it takes

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
// row inside each 128-byte group (the pitch is a multiple of 128).  In the
// carry ring r is the slot.
__device__ __forceinline__ int swz(int r, int c, int pitch) {
  return r * pitch + ((((c >> 4) ^ (((r >> 2) & 3) << 1))) << 4) + (c & 15);
}

// The ring slot of band row r, whose row 0 sits in slot `base`: r itself
// outside carry; with it base + r, once wrapped (base < slots, r < k_rows
// <= slots).
template <bool kCarry>
__device__ __forceinline__ int slot_of(int r, int base, int slots) {
  if constexpr (kCarry) {
    const int s = base + r;
    return s >= slots ? s - slots : s;
  } else {
    return r;
  }
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
template <bool kCarry>
__device__ __forceinline__ void b_frags(const uint8_t* band, int pitch, int kb, int t,
                                        int wc, int base, int slots, uint32_t (&b)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = *reinterpret_cast<const uint32_t*>(
                 band + swz(slot_of<kCarry>(kb + 16 * h + 4 * t + j, base, slots),
                            4 * wc, pitch)) ^ 0x80808080u;
    transpose4(w, b[h]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The work value of a Y sum: kWrap16 narrows it to int16 and renormalises
// border rows (d != 0) by trunc(w * y_bias / d); u16 keeps it (<= 65280).
// Returned as the 16 bits the work tile stores: the value, or with
// kRelaxed its bf16 rounding (|w| <= 65535 is exact in float32 first).
template <bool kWrap16, bool kRelaxed>
__device__ __forceinline__ uint32_t work_bits(uint32_t acc, int32_t d, int y_bias) {
  int32_t w;
  if constexpr (kWrap16) {
    w = wrap16(acc);
    if (d != 0) w = wrap16(static_cast<uint32_t>((w * y_bias) / d));  // |w*y_bias| < 2^31
  } else {
    w = static_cast<int32_t>(acc & 0xFFFFu);
  }
  if constexpr (kRelaxed) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(w)));
  } else {
    return static_cast<uint32_t>(w) & 0xFFFFu;
  }
}

// The float32 value of a work element holding bf16 bits.
__device__ __forceinline__ float bf16_value(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// The work tile's element: int16 (kWrap16), loaded sign-extended, or u16.
template <bool kWrap16>
using Work = std::conditional_t<kWrap16, int16_t, uint16_t>;

// Stores 8 work values of row `row`, band columns c .. c + 7: one 16-byte
// store where the pitch keeps rows 16-byte aligned, else two 8-byte ones.
template <bool kWrap16, bool kRelaxed>
__device__ __forceinline__ void store8(uint16_t* work, int work_pitch, int margin, int row,
                                       int c, const uint32_t (&acc)[8], uint32_t corr,
                                       int32_t d, int y_bias) {
  uint32_t v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = work_bits<kWrap16, kRelaxed>(acc[e] + corr, d, y_bias);
  uint16_t* p = work + row * work_pitch + margin + c;
  if ((work_pitch & 7) == 0) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16, v[6] | v[7] << 16);
  } else {
    reinterpret_cast<uint2*>(p)[0] = make_uint2(v[0] | v[1] << 16, v[2] | v[3] << 16);
    reinterpret_cast<uint2*>(p)[1] = make_uint2(v[4] | v[5] << 16, v[6] | v[7] << 16);
  }
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
  int planes;                 // kRelaxed: X planes per phase (2 with a residual)
  int run, slots;             // kCarry: row tiles per block, ring rows
  int x_step;                 // the X window's step (1..kXSteps), 0: per tap
};

// Copies source rows [first, first + n) of the frame, byte columns
// [c_base, c_base + 16 nchunk), into the band: row first + r into slot
// slot_of(r, slot0).  16-byte cp.async copies where `vec` (the row pitch is
// a multiple of 16) and the piece lies in the row; byte loads otherwise,
// which skip bytes outside the row.
template <bool kCarry>
__device__ __forceinline__ void stage_rows(uint8_t* band, const TiledArgs& a,
                                           const uint8_t* frame, int first, int n,
                                           int slot0, int c_base, int nchunk, bool vec) {
  for (int e = threadIdx.x; e < n * nchunk; e += kThreads) {
    const int r = e / nchunk;
    const int c = (e - r * nchunk) << 4;
    const int col = c_base + c;
    const uint8_t* g = frame + static_cast<long long>(first + r) * a.row_stride + col;
    uint8_t* s = band + swz(slot_of<kCarry>(r, slot0, a.slots), c, a.pitch);
    if (vec && col >= 0 && col + 16 <= a.src_w) {
      cp_async16(s, g);
    } else {
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (col + b >= 0 && col + b < a.src_w) s[b] = __ldg(g + b);
    }
  }
}

// Y pass of one row tile into the work tile, band columns [0, mis + width)
// rounded up, from the band whose row 0 is in slot `base`.
template <bool kWrap16, bool kS8Y, bool kRelaxed, bool kCarry>
__device__ __forceinline__ void y_pass(const TiledArgs& a, const uint8_t* band,
                                       uint16_t* work, const int32_t* rrec, int mis,
                                       int width, int base) {
  const int tid = threadIdx.x;
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
        b_frags<kCarry>(band, a.pitch, kb, q, 8 * grp + g, base, a.slots, b);
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
        store8<kWrap16, kRelaxed>(work, a.work_pitch, a.margin, row, 32 * grp + 8 * q, v,
                                  corr[row], ydiv[row], a.y_bias);
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
        const uint2 w = *reinterpret_cast<const uint2*>(
            band + swz(slot_of<kCarry>(iyr[t * kRows + row], base, a.slots), c, a.pitch));
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[b] += cf * ((w.x >> (8 * b)) & 0xFFu);
          acc[4 + b] += cf * ((w.y >> (8 * b)) & 0xFFu);
        }
      }
      store8<kWrap16, kRelaxed>(work, a.work_pitch, a.margin, row, c, acc, 0u, ydiv[row],
                                a.y_bias);
    }
  }
}

// kRelaxed, in column tiles at the plane's edges: the work columns left of
// source column 0 take its value, those right of column src_w - 1 take that
// one's, in every row, as the plain version's clamped taps read them.  The
// window [lo, lo + width) holds column 0 where lo == 0 and column src_w - 1
// where it ends at src_w, and only such tiles read outside the plane.
// Returns whether it filled anything (then the caller synchronises).
__device__ __forceinline__ bool fill_edges(uint16_t* work, const TiledArgs& a, int lo,
                                           int width, int mis) {
  const int c0 = a.margin + mis;                 // work column of source column lo
  const int n_left = lo == 0 ? c0 : 0;
  const int n_right = lo + width == a.src_w ? a.work_pitch - c0 - width : 0;
  const int n = n_left + n_right;
  if (n == 0) return false;
  for (int e = threadIdx.x; e < kRows * n; e += kThreads) {
    const int r = e / n;
    const int i = e - r * n;
    uint16_t* row = work + r * a.work_pitch;
    if (i < n_left) {
      row[i] = row[c0];
    } else {
      row[c0 + width + i - n_left] = row[c0 + width - 1];
    }
  }
  return true;
}

// The epilogue of one row's X sums: acc[k] is output j0 + kStride k of the
// column tile, written to out[j].  With adjacent outputs (kStride 1) the
// kTW / 16 bytes go out as one store where the address allows it and all
// of them lie in the plane, else as byte stores.
template <bool kWrap16, int kTW, bool kRelaxed, int kStride>
__device__ __forceinline__ void epilogue(const TiledArgs& a, const int32_t* crec,
                                         const uint32_t (&acc)[kTW / 16], int j0, int cols,
                                         uint8_t* out) {
  constexpr int kPer = kTW / 16;
  const int32_t* xdiv = crec + kHead + 2 * kTW;
  const uint32_t half = 1u << (a.out_shift - 1);
  // the tile has border columns (wrap16 plans only; u16 plans have none)
  const bool border = (kWrap16 || kRelaxed) && crec[3] != 0;
  uint32_t b[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = j0 + kStride * k;
    int32_t v;
    if constexpr (kWrap16 || kRelaxed) {
      const int32_t s = as_i32(acc[k] + half);
      v = shift_floor(s, a.out_shift);
      // d is a nonzero multiple of y_bias (>= 2 in magnitude) on border
      // columns, so s / d cannot overflow.
      if (border && xdiv[j] != 0) v = s / xdiv[j];
      v = wrap16(static_cast<uint32_t>(v));
    } else {
      v = static_cast<int32_t>((acc[k] + half) >> a.out_shift);
    }
    b[k] = static_cast<uint32_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
  if constexpr (kStride == 1) {
    uint8_t* p = out + j0;
    if (j0 + kPer <= cols && (reinterpret_cast<uintptr_t>(p) & (kPer - 1)) == 0) {
      uint32_t q[(kPer + 3) / 4] = {};
#pragma unroll
      for (int k = 0; k < kPer; ++k) q[k / 4] |= b[k] << (8 * (k % 4));
      if constexpr (kPer == 8) {
        *reinterpret_cast<uint2*>(p) = make_uint2(q[0], q[1]);
      } else if constexpr (kPer == 4) {
        *reinterpret_cast<uint32_t*>(p) = q[0];
      } else {
        *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(q[0]);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (j0 + kStride * k < cols) out[j0 + kStride * k] = static_cast<uint8_t>(b[k]);
}

// Work value q of a thread's X window, whose words hold two values each
// and start kOdd values before it: int16 (kWrap16), sign-extended, or u16.
template <bool kWrap16, bool kOdd, int kWords>
__device__ __forceinline__ uint32_t window_value(const uint32_t (&w)[kWords], int q) {
  const int v = q + (kOdd ? 1 : 0);
  const uint32_t word = w[v >> 1];
  if constexpr (kWrap16) {
    return static_cast<uint32_t>(shift_floor(as_i32((v & 1) ? word : word << 16), 16));
  } else {
    return (v & 1) ? word >> 16 : word & 0xFFFFu;
  }
}

// The window form of the exact X pass (5b): the sums of outputs j0 ..
// j0 + kPer - 1, whose first taps lie kStep apart, from the window of
// kStep (kPer - 1) + taps_x values at the first one's first tap, which lies
// in the word row[0], in its high half when kOdd.
template <bool kWrap16, int kTW, int kStep, bool kOdd>
__device__ __forceinline__ void x_window(const TiledArgs& a, const uint32_t* row,
                                         const int32_t* crec, int j0,
                                         uint32_t (&acc)[kTW / 16]) {
  constexpr int kPer = kTW / 16;
  constexpr int kTaps = kXWindow - kStep * (kPer - 1);   // most taps a window holds
  constexpr int kWords = (kXWindow + 2) / 2;
  constexpr int kOne = kOdd ? 1 : 0;
  constexpr int kFewest = (kOne + kStep * (kPer - 1) + 2) / 2;   // words of a one-tap window
  static_assert(kTaps >= 1, "no tap fits the window");
  const int32_t* cxu = crec + kHead + 3 * kTW;
  const int nw = (kOne + kStep * (kPer - 1) + a.taps_x + 1) >> 1;
  uint32_t w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    if (i >= kFewest && i >= nw) break;
    w[i] = row[i];
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) acc[k] = 0;
  if (crec[2] == 1) {            // one phase: a broadcast coefficient per tap
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      if (t >= a.taps_x) break;
      const uint32_t cf = static_cast<uint32_t>(cxu[t * a.max_phases]);
#pragma unroll
      for (int k = 0; k < kPer; ++k) acc[k] += cf * window_value<kWrap16, kOdd>(w, kStep * k + t);
    }
  } else {                       // each output its phase's coefficients, output by output
    const int32_t* ph = crec + kHead + kTW;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int32_t* c = cxu + ph[j0 + k];
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        if (t >= a.taps_x) break;
        acc[k] += static_cast<uint32_t>(c[t * a.max_phases]) *
                  window_value<kWrap16, kOdd>(w, kStep * k + t);
      }
    }
  }
}

// The window form at step a.x_step, its start's parity read once.
template <bool kWrap16, int kTW, bool kOdd>
__device__ __forceinline__ void x_window_at(const TiledArgs& a, const uint32_t* row,
                                            const int32_t* crec, int j0,
                                            uint32_t (&acc)[kTW / 16]) {
  switch (a.x_step) {
    case 1: x_window<kWrap16, kTW, 1, kOdd>(a, row, crec, j0, acc); break;
    case 2: x_window<kWrap16, kTW, 2, kOdd>(a, row, crec, j0, acc); break;
    default: x_window<kWrap16, kTW, kXSteps, kOdd>(a, row, crec, j0, acc); break;
  }
}

// X pass and epilogue of one output row: row `r` of the work tile, written
// to out[j].  The window form (kWindow: exact forms, x_step != 0) computes
// outputs l (TW / 16) + k, the per-tap form outputs l + 16 k.
template <bool kWrap16, int kTW, bool kRelaxed, bool kWindow>
__device__ __forceinline__ void x_pass(const TiledArgs& a, const uint16_t* work,
                                       const int32_t* crec, int mis, int r, int l, int cols,
                                       uint8_t* out) {
  constexpr int kPer = kTW / 16;
  const int32_t* xs = crec + kHead;
  uint32_t acc[kPer];
  if constexpr (kWindow) {
    const int j0 = l * kPer;
    const int s0 = a.margin + mis + xs[j0];     // the window's first value in the row
    const uint32_t* row = reinterpret_cast<const uint32_t*>(work + r * a.work_pitch) + (s0 >> 1);
    if (s0 & 1) {
      x_window_at<kWrap16, kTW, true>(a, row, crec, j0, acc);
    } else {
      x_window_at<kWrap16, kTW, false>(a, row, crec, j0, acc);
    }
    epilogue<kWrap16, kTW, kRelaxed, 1>(a, crec, acc, j0, cols, out);
  } else {
    const int32_t* ph = xs + kTW;
    const int32_t* xdiv = ph + kTW;
    if constexpr (kRelaxed) {
      const uint16_t* wrow = work + r * a.work_pitch + a.margin + mis;
      const uint16_t* base[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        base[k] = wrow + xs[l + 16 * k];
        acc[k] = 0;
      }
      const float* planes = reinterpret_cast<const float*>(xdiv + kTW);
      for (int p = 0; p < a.planes; ++p) {
        const float* cxf = planes + p * a.taps_x * a.max_phases;
        float f[kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k) f[k] = 0.0f;
        if (crec[2] == 1) {          // one phase: a broadcast coefficient per tap
          for (int t = 0; t < a.taps_x; ++t) {
            const float cf = cxf[t * a.max_phases];
#pragma unroll
            for (int k = 0; k < kPer; ++k)
              f[k] = __fadd_rn(f[k], __fmul_rn(cf, bf16_value(base[k][t])));
          }
        } else {
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            const float* c = cxf + ph[l + 16 * k];
            for (int t = 0; t < a.taps_x; ++t)
              f[k] = __fadd_rn(f[k], __fmul_rn(c[t * a.max_phases], bf16_value(base[k][t])));
          }
        }
#pragma unroll
        for (int k = 0; k < kPer; ++k) acc[k] += static_cast<uint32_t>(__float2int_rz(f[k]));
      }
    } else {
      const int32_t* cxu = xdiv + kTW;
      const Work<kWrap16>* wrow =
          reinterpret_cast<const Work<kWrap16>*>(work + r * a.work_pitch + a.margin + mis);
      const Work<kWrap16>* base[kPer];
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
            acc[k] += static_cast<uint32_t>(c[t * a.max_phases]) *
                      static_cast<uint32_t>(base[k][t]);
        }
      }
    }
    epilogue<kWrap16, kTW, kRelaxed, 16>(a, crec, acc, l, cols, out);
  }
}

// Tile records (cuda_resize.TiledLayout).  Row: [origin, band rows, first
// row, end row], corr[16], ydiv[16], then with kS8Y A (16 rows of k_rows +
// 16 s8 bytes, column k for source row origin + k), else cy[taps_y][16],
// iyr[taps_y][16] (relative to origin); the tile reads source rows [first,
// end), and origin is first outside carry, end - k_rows in it.  Column:
// [lo, width, phases, border], xs[TW], ph[TW], xdiv[TW], then
// cxu[taps_x][max_phases] (int32), or with kRelaxed `planes` planes of
// float32 bits [taps_x][max_phases].
template <bool kWrap16, bool kS8Y, int kTW, bool kRelaxed, bool kCarry, bool kWindow>
__device__ __forceinline__ void tiled_block(const TiledArgs& a) {
  static_assert(!(kRelaxed && kWindow), "the relaxed form sums per tap");
  // [k_rows or slots][pitch] u8 band | [16][work_pitch] u16 work | column
  // record | row record (two with kCarry)
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* band = smem;
  uint16_t* work = reinterpret_cast<uint16_t*>(smem + (kCarry ? a.slots : a.k_rows) * a.pitch);
  int32_t* crec = reinterpret_cast<int32_t*>(work + kRows * a.work_pitch);
  int32_t* rrec = crec + a.crec_words;

  const int tid = threadIdx.x;
  const int n_rt = (a.dst_h + kRows - 1) / kRows;
  const int t0 = kCarry ? blockIdx.y * a.run : blockIdx.y;
  const int t1 = kCarry ? min(t0 + a.run, n_rt) : t0 + 1;
  const int32_t* grrec = a.rrec + static_cast<long long>(t0) * a.rrec_words;
  const int32_t* gcrec = a.crec + static_cast<long long>(blockIdx.x) * a.crec_words;
  const int first = __ldg(grrec + 2), end = __ldg(grrec + 3);
  const int lo = __ldg(gcrec), width = __ldg(gcrec + 1);

  // 1-2. the two records and the band, all as asynchronous copies behind
  // the dependent loads of the headers above
  for (int i = tid; i < a.rrec_words / 4; i += kThreads) cp_async16(rrec + 4 * i, grrec + 4 * i);
  for (int i = tid; i < a.crec_words / 4; i += kThreads) cp_async16(crec + 4 * i, gcrec + 4 * i);
  const uint8_t* frame = a.src + static_cast<long long>(blockIdx.z) * a.frame_stride;
  const int mis = static_cast<int>(
      reinterpret_cast<uintptr_t>(frame + static_cast<long long>(first) * a.row_stride + lo) & 15);
  const bool vec = (a.row_stride & 15) == 0;
  const int c_base = lo - mis;                  // source column of band column 0
  const int nchunk = (mis + width + 15) >> 4;
  stage_rows<kCarry>(band, a, frame, first, end - first, kCarry ? first % a.slots : 0,
                     c_base, nchunk, vec);
  cp_async_wait_all();
  __syncthreads();

  // 3-5. per row tile: Y pass, (relaxed) edge fill, X pass and epilogue of
  // row r, outputs l + 16 k or, in the window form, l (TW / 16) + k: there
  // warp w takes rows 4 (w / 2) .. + 3, 8 threads each (5b)
  const int r = kWindow ? 4 * (tid >> 6) + ((tid >> 3) & 3) : tid >> 4;
  const int l = kWindow ? 8 * ((tid >> 5) & 1) + (tid & 7) : tid & 15;
  const int c0 = blockIdx.x * kTW;
  const int cols = min(kTW, a.dst_w - c0);
  uint8_t* out = a.dst + static_cast<long long>(blockIdx.z) * a.dst_h * a.dst_w + c0;
  if constexpr (!kCarry) {
    y_pass<kWrap16, kS8Y, kRelaxed, false>(a, band, work, rrec, mis, width, 0);
    __syncthreads();
    if constexpr (kRelaxed) {
      if (fill_edges(work, a, lo, width, mis)) __syncthreads();
    }
    const int row = t0 * kRows + r;
    if (row >= a.dst_h) return;
    x_pass<kWrap16, kTW, kRelaxed, kWindow>(a, work, crec, mis, r, l, cols,
                                            out + static_cast<long long>(row) * a.dst_w);
  } else {
    // tile t + 1's rows and tile t + 2's, read ahead of the step that
    // copies them
    int hi = end, nlo = 0, nhi = 0;
    if (t0 + 1 < t1) {
      nlo = __ldg(grrec + a.rrec_words + 2);
      nhi = __ldg(grrec + a.rrec_words + 3);
    }
    for (int t = t0; t < t1; ++t) {
      const int32_t* rec = rrec + ((t - t0) & 1) * a.rrec_words;
      int n2lo = 0, n2hi = 0;
      if (t + 1 < t1) {
        // tile t + 1's record and fresh rows, into slots tile t does not read
        int32_t* nrec = rrec + ((t + 1 - t0) & 1) * a.rrec_words;
        const int32_t* g = a.rrec + static_cast<long long>(t + 1) * a.rrec_words;
        for (int i = tid; i < a.rrec_words / 4; i += kThreads) cp_async16(nrec + 4 * i, g + 4 * i);
        const int f0 = max(hi, nlo);
        stage_rows<true>(band, a, frame, f0, nhi - f0, f0 % a.slots, c_base, nchunk, vec);
        if (t + 2 < t1) {
          n2lo = __ldg(g + a.rrec_words + 2);
          n2hi = __ldg(g + a.rrec_words + 3);
        }
      }
      const int origin = rec[0] % a.slots;
      y_pass<kWrap16, kS8Y, kRelaxed, true>(a, band, work, rec, mis, width,
                                            origin < 0 ? origin + a.slots : origin);
      __syncthreads();
      if constexpr (kRelaxed) {
        if (fill_edges(work, a, lo, width, mis)) __syncthreads();
      }
      const int row = t * kRows + r;
      if (row < a.dst_h)
        x_pass<kWrap16, kTW, kRelaxed, kWindow>(a, work, crec, mis, r, l, cols,
                                                out + static_cast<long long>(row) * a.dst_w);
      cp_async_wait_all();
      __syncthreads();     // tile t + 1's rows landed; the work tile is free
      hi = nhi;
      nlo = n2lo;
      nhi = n2hi;
    }
  }
}

// The per-tap instantiations, ptxas free in its registers.
template <bool kWrap16, bool kS8Y, int kTW, bool kRelaxed, bool kCarry>
__global__ void __launch_bounds__(kThreads) resize_tiled_kernel(TiledArgs a) {
  tiled_block<kWrap16, kS8Y, kTW, kRelaxed, kCarry, false>(a);
}

// The X window's instantiations (exact forms), held to the registers of
// kWindowBlocks resident blocks an SM, as many as the shared memory of the
// main plans allows: 5 in the tiled form (Lanczos3 4K -> 1080p: 41 KB a
// block; at 6, ptxas spills the s8 Y pass of the narrower widths), 4 in the
// carry form (its ring: 55 KB).  Free, ptxas takes 64 registers: 4 blocks.
template <bool kCarry>
constexpr int kWindowBlocks = kCarry ? 4 : 5;

template <bool kWrap16, bool kS8Y, int kTW, bool kCarry>
__global__ void __launch_bounds__(kThreads, kWindowBlocks<kCarry>)
    resize_tiled_window_kernel(TiledArgs a) {
  tiled_block<kWrap16, kS8Y, kTW, false, kCarry, true>(a);
}

using Kernel = decltype(&resize_tiled_kernel<true, true, 128, false, false>);

// One form of the kernel (exact, relaxed, carry, relaxed carry): its
// instantiations <kWrap16, kS8Y, TW, kWindow> (twelve per-tap ones, and in
// the exact forms twelve of the X window besides), their shared-memory
// limit and the launch geometry of one frame (configure: the instantiation
// for (wrap16, s8y, tw) and a.x_step, its grid with gridDim.z left to the
// launch, and its dynamic shared memory; cudaErrorInvalidValue for a width
// not in kWidths, or a window asked of a relaxed form).  The two members
// are defined out of the class, so not inline: each form is instantiated in
// its own translation unit and nowhere else.
template <bool kRelaxed, bool kCarry>
struct Form {
  static int set_max_smem(int bytes);
  static int configure(int wrap16, int s8y, int tw, const TiledArgs& a, Kernel* kernel,
                       dim3* grid, int* smem);
};

// The instantiation of a form for (wrap16, s8y, tw), or null for a width
// not in kWidths.  No function-local static table: g++ makes such a table
// of a template a process-wide unique symbol, so a second build of this
// library loaded into the same process (tools/tiled_ablate.py loads
// several) would launch the first one's kernels.
template <bool kRelaxed, bool kCarry, int kTW, bool kWindow>
Kernel pick_w(int wrap16, int s8y) {
  if constexpr (kWindow) {
    if (wrap16)
      return s8y ? &resize_tiled_window_kernel<true, true, kTW, kCarry>
                 : &resize_tiled_window_kernel<true, false, kTW, kCarry>;
    return s8y ? &resize_tiled_window_kernel<false, true, kTW, kCarry>
               : &resize_tiled_window_kernel<false, false, kTW, kCarry>;
  } else {
    if (wrap16)
      return s8y ? &resize_tiled_kernel<true, true, kTW, kRelaxed, kCarry>
                 : &resize_tiled_kernel<true, false, kTW, kRelaxed, kCarry>;
    return s8y ? &resize_tiled_kernel<false, true, kTW, kRelaxed, kCarry>
               : &resize_tiled_kernel<false, false, kTW, kRelaxed, kCarry>;
  }
}

template <bool kRelaxed, bool kCarry, bool kWindow>
Kernel pick_tw(int wrap16, int s8y, int tw) {
  switch (tw) {
    case 128: return pick_w<kRelaxed, kCarry, 128, kWindow>(wrap16, s8y);
    case 64: return pick_w<kRelaxed, kCarry, 64, kWindow>(wrap16, s8y);
    case 32: return pick_w<kRelaxed, kCarry, 32, kWindow>(wrap16, s8y);
    default: return nullptr;
  }
}

template <bool kRelaxed, bool kCarry>
Kernel pick(int wrap16, int s8y, int tw, bool window) {
  if constexpr (kRelaxed) {
    return window ? nullptr : pick_tw<true, kCarry, false>(wrap16, s8y, tw);
  } else {
    return window ? pick_tw<false, kCarry, true>(wrap16, s8y, tw)
                  : pick_tw<false, kCarry, false>(wrap16, s8y, tw);
  }
}

template <bool kRelaxed, bool kCarry>
int Form<kRelaxed, kCarry>::set_max_smem(int bytes) {
  for (int tw : kWidths)
    for (int k = 0; k < (kRelaxed ? 4 : 8); ++k) {
      const cudaError_t rc = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(pick<kRelaxed, kCarry>(k & 2, k & 1, tw, k & 4)),
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
  return 0;
}

template <bool kRelaxed, bool kCarry>
int Form<kRelaxed, kCarry>::configure(int wrap16, int s8y, int tw, const TiledArgs& a,
                                      Kernel* kernel, dim3* grid, int* smem) {
  *kernel = pick<kRelaxed, kCarry>(wrap16, s8y, tw, a.x_step != 0);
  if (*kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int ring_rows = kCarry ? a.slots : a.k_rows;
  *smem = ring_rows * a.pitch + kRows * a.work_pitch * 2 +
          4 * ((kCarry ? 2 : 1) * a.rrec_words + a.crec_words);
  const int row_tiles = (a.dst_h + kRows - 1) / kRows;
  *grid = dim3((a.dst_w + tw - 1) / tw, kCarry ? (row_tiles + a.run - 1) / a.run : row_tiles,
               1);
  return 0;
}

}  // namespace iqo_tiled
