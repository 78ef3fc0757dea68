// Per-pass cost probe for Hopper (sm_90a), kernel D, banded_tile<Y, X>: the
// tile loop of a 4K Lanczos3 resize on the tensor cores, for each of
// Y, X in {mono, grouped, skip}.  Per tile t of (band (336, 896) u8):
//   w    = int32(cy (160, 336) @ bf16(band))         Y mono (f32 sums)
//          or each row's 96-row sub-window only      Y grouped
//          or band[:160] * 37                        Y skip
//   w    = wrap16(w); b = ((w + 128) & 255) - 128; a = (w - b) >> 8
//   sums = 65280 * D0 - 255 * D1 + 256 * D2 (int32 wrap), Dp = int32 of
//          (a, b, a + b as bf16) @ cxp (896, 384)    X mono
//          or each column's 384-column sub-window    X grouped
//          or a * 65280 + b * 256 on columns < 384   X skip
//   out  = clip(wrap16((sums + 2^19) >> 20), 0, 255) as u8 (160, 384).
//
// Replaces the TPU kernel of scripts/exp_banded_dots.py: make (pl.pallas_call
// at :92), all nine (Y, X) modes of :150-155, with the groups of :39-40.
// The Python side is libiqo_tpu_torch/experiments/exp_banded_dots.py.
//
// What bounds it on the H100: for a 35-tile frame, operations in the dot
// modes and bytes in skip/skip.  Mono/mono is 7.47 G multiply-adds (15.1 us
// at 989 TFLOP/s bf16), grouped/grouped 2.96 G (6.0 us); the frame moves
// 14.9 MB (band, coefficients and output once each; 4.4 us at 3.35 TB/s).
//
// What the design does about it: one TPU grid step holds a whole 160 x 896
// work tile, which no block can (as bf16 a, b and a + b planes it is 860 KB
// against 227 KB of shared memory).  So each tile is split by output rows:
// a block of 8 warps owns 16 rows, runs their Y dot over all 896 columns
// with mma.sync m16n8k16 (bf16 in, f32 sums; the band is staged through
// shared memory 16 rows at a time as packed bf16 pairs, double-buffered in
// registers), turns the f32 sums into int32 work rows exactly as
// `.astype(jnp.int32)` does, keeps the three bf16 work planes in shared
// memory and runs the X dots for all 384 outputs with each warp on 48
// columns, the coefficients read K-major (the wrapper lays them out once)
// straight from the L2, where all 350 blocks share them.  Grouped modes
// contract only the sub-windows: Y over the union of its 16 rows' windows
// with the coefficients outside a row's window zeroed, X over each 8-column
// tile's window.  Each block loads its own coefficient slices; nothing
// carries across blocks.  The int32 recombination wraps in uint32 (signed
// overflow is undefined in C++), and the shift is arithmetic on the wrapped
// value, as in JAX.  The f32 sums are exact while each output's sum of
// |terms| stays below 2^24: always for Y (336 * 64 * 255), for X on the
// probe's seeded inputs (the plain version asserts it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { kMono = 0, kGrouped = 1, kSkip = 2 };
constexpr int kTH = 160, kBH = 336, kBW = 896, kTW = 384;
constexpr int kRows = 16;                   // output rows per block
constexpr int kWarps = 8, kThreads = kWarps * 32;
constexpr int kYCols = kBW / kWarps;        // 112 Y columns per warp
constexpr int kYTiles = kYCols / 8;         // 14 n-tiles
constexpr int kXCols = kTW / kWarps;        // 48 X columns per warp
constexpr int kXTiles = kXCols / 8;         // 6 n-tiles
// pitches in 32-bit words, chosen so that a warp's fragment loads hit 32
// distinct banks (12 or 8 mod 32)
constexpr int kCyPitch = kBH / 2 + 4;       // 172
constexpr int kBandPitch = kBW + 8;         // 904: one word per column (a k pair)
constexpr int kWorkPitch = kBW / 2 + 12;    // 460
constexpr int kChunkK = 16;                 // band rows per stage
constexpr int kCyWords = kRows * kCyPitch;
constexpr int kBandWords = (kChunkK / 2) * kBandPitch;
constexpr int kWorkWords = kRows * kWorkPitch;
constexpr int kYWords = kCyWords + 2 * kBandWords;
constexpr int kXWords = 3 * kWorkWords;
constexpr int kSmemBytes = 4 * (kYWords > kXWords ? kYWords : kXWords);
constexpr int kStageItems = (kChunkK / 2) * (kBW / 4) / kThreads;   // 7
static_assert((kChunkK / 2) * (kBW / 4) % kThreads == 0, "stage split");

// the script's groups (exp_banded_dots.py:39-40)
__host__ __device__ constexpr int y_k0(int row) {
  const int g = row / 40;
  return 80 * g < kBH - 96 ? 80 * g : kBH - 96;
}
__host__ __device__ constexpr int x_k0(int col) {
  const int g = col / 128;
  return 256 * g - 128 > 0 ? 256 * g - 128 : 0;
}

__device__ __forceinline__ uint32_t bf16_bits(int v) {   // exact for |v| <= 256
  return __float_as_uint(static_cast<float>(v)) >> 16;
}
__device__ __forceinline__ int bf16_value(uint32_t bits) {
  return static_cast<int>(__uint_as_float(bits << 16));
}
__device__ __forceinline__ int wrap16(int v) {
  return static_cast<int>(static_cast<int16_t>(static_cast<uint16_t>(v)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int kY, int kX>
__global__ void __launch_bounds__(kThreads, 1)
banded_kernel(const uint8_t* __restrict__ band, const uint32_t* __restrict__ cy,
              const uint32_t* __restrict__ cx0t, const uint32_t* __restrict__ cx1t,
              const uint32_t* __restrict__ cx2t, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kRows, tile = blockIdx.y;
  const uint8_t* tband = band + (long long)tile * kBH * kBW;

  // ---- Y pass: w for rows r0..r0+15 at (row g / g + 8, col n + 2t, +1)
  int w[kYTiles][4];
  if constexpr (kY == kSkip) {
#pragma unroll
    for (int j = 0; j < kYTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e / 2), col = warp * kYCols + 8 * j + 2 * t + e % 2;
        w[j][e] = tband[row * kBW + col] * 37;
      }
  } else {
    uint32_t* cys = smem;
    uint32_t* bands = smem + kCyWords;
    const int kb = kY == kGrouped ? y_k0(r0) : 0;
    const int ke = kY == kGrouped ? y_k0(r0 + kRows - 1) + 96 : kBH;
    // this block's cy rows, as bf16 pairs; grouped: zero outside each row's window
    for (int i = tid; i < kRows * (kBH / 2); i += kThreads) {
      const int row = i / (kBH / 2), word = i % (kBH / 2);
      uint32_t v = cy[(r0 + row) * (kBH / 2) + word];
      if constexpr (kY == kGrouped) {
        const int lo = y_k0(r0 + row), k = 2 * word;
        if (k < lo || k >= lo + 96) v &= 0xFFFF0000u;
        if (k + 1 < lo || k + 1 >= lo + 96) v &= 0x0000FFFFu;
      }
      cys[row * kCyPitch + word] = v;
    }
    // band rows k, k+1 at 4 columns -> 4 words of bf16 pairs
    uint32_t lo4[kStageItems], hi4[kStageItems];
    auto fetch = [&](int kc) {
#pragma unroll
      for (int i = 0; i < kStageItems; ++i) {
        const int item = tid + i * kThreads, pr = item / (kBW / 4), c4 = (item % (kBW / 4)) * 4;
        const uint8_t* p = tband + (kc + 2 * pr) * kBW + c4;
        lo4[i] = *reinterpret_cast<const uint32_t*>(p);
        hi4[i] = *reinterpret_cast<const uint32_t*>(p + kBW);
      }
    };
    auto stash = [&](int buf) {
#pragma unroll
      for (int i = 0; i < kStageItems; ++i) {
        const int item = tid + i * kThreads, pr = item / (kBW / 4), c4 = (item % (kBW / 4)) * 4;
        auto pair = [&](int b) {
          return bf16_bits((lo4[i] >> (8 * b)) & 255) |
                 (bf16_bits((hi4[i] >> (8 * b)) & 255) << 16);
        };
        *reinterpret_cast<uint4*>(&bands[buf * kBandWords + pr * kBandPitch + c4]) =
            make_uint4(pair(0), pair(1), pair(2), pair(3));
      }
    };
    float acc[kYTiles][4] = {};
    fetch(kb);
    stash(0);
    __syncthreads();
    for (int kc = kb, buf = 0; kc < ke; kc += kChunkK, buf ^= 1) {
      if (kc + kChunkK < ke) fetch(kc + kChunkK);
      const uint32_t* a_lo = cys + g * kCyPitch + kc / 2 + t;
      const uint32_t* a_hi = a_lo + 8 * kCyPitch;
      const uint32_t a0 = a_lo[0], a1 = a_hi[0], a2 = a_lo[4], a3 = a_hi[4];
      const uint32_t* bp = bands + buf * kBandWords + t * kBandPitch + warp * kYCols + g;
#pragma unroll
      for (int j = 0; j < kYTiles; ++j)
        mma_bf16(acc[j], a0, a1, a2, a3, bp[8 * j], bp[8 * j + 4 * kBandPitch]);
      if (kc + kChunkK < ke) {
        stash(buf ^ 1);
        __syncthreads();
      }
    }
#pragma unroll
    for (int j = 0; j < kYTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) w[j][e] = static_cast<int>(acc[j][e]);
    __syncthreads();   // the Y buffers become the work planes
  }

  // ---- work planes a, b, a + b as bf16 pairs, rows 0..15, all 896 columns
  uint32_t* planes = smem;
#pragma unroll
  for (int j = 0; j < kYTiles; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t pa = 0, pb = 0, pg = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = wrap16(w[j][2 * h + e]);
        const int b = ((v + 128) & 255) - 128, a = (v - b) >> 8;
        pa |= bf16_bits(a) << (16 * e);
        pb |= bf16_bits(b) << (16 * e);
        pg |= bf16_bits(a + b) << (16 * e);
      }
      const int idx = (g + 8 * h) * kWorkPitch + (warp * kYCols + 8 * j) / 2 + t;
      planes[idx] = pa;
      planes[kWorkWords + idx] = pb;
      planes[2 * kWorkWords + idx] = pg;
    }
  __syncthreads();

  // ---- X pass: sums at (row g / g + 8, col c + 2t, +1) of each n-tile
  const int c0 = warp * kXCols;
  uint32_t sums[kXTiles][4];
  if constexpr (kX == kSkip) {
#pragma unroll
    for (int j = 0; j < kXTiles; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = (g + 8 * h) * kWorkPitch + (c0 + 8 * j) / 2 + t;
        const uint32_t pa = planes[idx], pb = planes[kWorkWords + idx];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sums[j][2 * h + e] =
              static_cast<uint32_t>(bf16_value((pa >> (16 * e)) & 0xFFFF)) * 65280u +
              static_cast<uint32_t>(bf16_value((pb >> (16 * e)) & 0xFFFF)) * 256u;
      }
  } else {
#pragma unroll
    for (int j = 0; j < kXTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sums[j][e] = 0;
    const int kb = kX == kGrouped ? x_k0(c0) : 0;
    const int ke = kX == kGrouped ? x_k0(c0 + kXCols - 1) + 384 : kBW;
    const uint32_t* cxs[3] = {cx0t, cx1t, cx2t};
    const uint32_t weight[3] = {65280u, static_cast<uint32_t>(-255), 256u};
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      float acc[kXTiles][4] = {};
      const uint32_t* plane = planes + p * kWorkWords + g * kWorkPitch + t;
      const uint32_t* cx = cxs[p] + (long long)(c0 + g) * (kBW / 2) + t;
#pragma unroll 2
      for (int k = kb; k < ke; k += 16) {
        const uint32_t a0 = plane[k / 2], a1 = plane[8 * kWorkPitch + k / 2];
        const uint32_t a2 = plane[k / 2 + 4], a3 = plane[8 * kWorkPitch + k / 2 + 4];
#pragma unroll
        for (int j = 0; j < kXTiles; ++j) {
          if constexpr (kX == kGrouped) {
            const int lo = x_k0(c0 + 8 * j);
            if (k < lo || k >= lo + 384) continue;
          }
          const uint32_t* bp = cx + (long long)8 * j * (kBW / 2) + k / 2;
          mma_bf16(acc[j], a0, a1, a2, a3, __ldg(bp), __ldg(bp + 4));
        }
      }
#pragma unroll
      for (int j = 0; j < kXTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sums[j][e] += static_cast<uint32_t>(static_cast<int>(acc[j][e])) * weight[p];
    }
  }

  // ---- epilogue: round, wrap16, clip, store 2 bytes per (row, col pair)
  uint8_t* tout = out + ((long long)tile * kTH + r0) * kTW;
#pragma unroll
  for (int j = 0; j < kXTiles; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t pair = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int v = static_cast<int>(sums[j][2 * h + e] + (1u << 19)) >> 20;
        const int c = min(max(wrap16(v), 0), 255);
        pair |= static_cast<uint32_t>(c) << (8 * e);
      }
      *reinterpret_cast<uint16_t*>(tout + (g + 8 * h) * kTW + c0 + 8 * j + 2 * t) =
          static_cast<uint16_t>(pair);
    }
}

template <int kY, int kX>
int launch(const void* band, const void* cy, const void* cx0t, const void* cx1t,
           const void* cx2t, void* out, int tiles, cudaStream_t s) {
  const dim3 grid(kTH / kRows, tiles);
  banded_kernel<kY, kX><<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const uint8_t*>(band), static_cast<const uint32_t*>(cy),
      static_cast<const uint32_t*>(cx0t), static_cast<const uint32_t*>(cx1t),
      static_cast<const uint32_t*>(cx2t), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int kY, int kX>
int allow_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      banded_kernel<kY, kX>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes));
}

}  // namespace

extern "C" {

int iqo_exp_banded_shape(int* th, int* bh, int* bw, int* tw) {
  *th = kTH;
  *bh = kBH;
  *bw = kBW;
  *tw = kTW;
  return 0;
}

// Raise the nine instantiations' dynamic shared-memory limit on the current
// device; call once per device before the first launch.
int iqo_exp_banded_setup() {
  int rc = 0;
#define IQO_ALLOW(Y, X) if (!rc) rc = allow_smem<Y, X>();
  IQO_ALLOW(kMono, kMono) IQO_ALLOW(kMono, kGrouped) IQO_ALLOW(kMono, kSkip)
  IQO_ALLOW(kGrouped, kMono) IQO_ALLOW(kGrouped, kGrouped) IQO_ALLOW(kGrouped, kSkip)
  IQO_ALLOW(kSkip, kMono) IQO_ALLOW(kSkip, kGrouped) IQO_ALLOW(kSkip, kSkip)
#undef IQO_ALLOW
  return rc;
}

int iqo_exp_banded(int ymode, int xmode, const void* band, const void* cy,
                   const void* cx0t, const void* cx1t, const void* cx2t, void* out,
                   int tiles, void* stream) {
  if ((reinterpret_cast<uintptr_t>(band) | reinterpret_cast<uintptr_t>(cy) |
       reinterpret_cast<uintptr_t>(cx0t) | reinterpret_cast<uintptr_t>(cx1t) |
       reinterpret_cast<uintptr_t>(cx2t) | reinterpret_cast<uintptr_t>(out)) % 16)
    return 1002;
  if (tiles <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
#define IQO_CASE(Y, X) \
  if (ymode == Y && xmode == X) return launch<Y, X>(band, cy, cx0t, cx1t, cx2t, out, tiles, s);
  IQO_CASE(kMono, kMono) IQO_CASE(kMono, kGrouped) IQO_CASE(kMono, kSkip)
  IQO_CASE(kGrouped, kMono) IQO_CASE(kGrouped, kGrouped) IQO_CASE(kGrouped, kSkip)
  IQO_CASE(kSkip, kMono) IQO_CASE(kSkip, kGrouped) IQO_CASE(kSkip, kSkip)
#undef IQO_CASE
  return 1006;
}

}  // extern "C"
