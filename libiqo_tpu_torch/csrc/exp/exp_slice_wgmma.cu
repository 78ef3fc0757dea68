// Kernel L redesigned for Hopper (sm_90a), slice_wgmma<Check>: the same
// function as exp_slice.cu's slice_groups<Check> (the first, mma.sync form,
// kept): per step t of w (steps, 32, 3840) i16 and group g < 15 (outputs
// [128 g, 128 g + 128), window k0 = min(max(0, 256 g - 5) / align * align,
// 3840 - kl), kl wide), d_i = int(p_i[:, k0 : k0 + kl] @ c_i[k0 : k0 + kl,
// 128 g : 128 g + 128]) for p = (a, b, a + b) in bf16 with f32 sums,
// b = ((w + 128) & 255) - 128, a = (w - b) >> 8; s = 65280 d1 - 255 d2 +
// 256 d3 (uint32 wraps); out = clip((s + 2^19) >> 20, 0, 255) as u8, or s
// as i32 with Check.  Every sum of |products| stays below 2^24 (the plain
// version asserts it), so the tensor cores' order changes nothing: the
// result equals exp_slice_align.slice_groups_plain bit for bit.
//
// Replaces the TPU kernel of scripts/exp_slice_align.py: make (pl.pallas_call
// at :56) at (align, kl) = (128, 512), (64, 384), (32, 384).  The Python side
// is libiqo_tpu_torch/experiments/exp_slice_align.py (form "wgmma", the
// default).
//
// What bounds it on the H100: operations.  (128, 512) is 3.21 G bf16
// multiply-adds, 6.5 us at 989 TFLOP/s, against 16.4 MB of input and output
// (4.9 us at 3.35 TB/s).  What the design does about it:
// * A window is 3 planes x 64 columns (half a group) x kl of the K-major
//   coefficients, 196,608 bytes at kl = 512.  A block holds its window in
//   shared memory for as long as it works in it, and streams the int16 rows
//   of 64-row M tiles (two steps) past it: the window is read once per
//   block, not once per step.
// * A persistent grid of one block an SM takes contiguous runs of the
//   window-major tile order (30 windows x ceil(steps / 2) M tiles; 510 at
//   34 steps, runs of 3 or 4 on 132 SMs): one wave, and a block loads at
//   most two windows at the scripts' shapes.  Where a run crosses into the
//   next window, the window's K chunks are reloaded one by one as the last
//   tiles of the old window retire each.
// * Two consumer warpgroups take alternate M tiles of the block's run, each
//   fed by a producer warp of its own through a ring of 2 stages.  The
//   producers issue TMA loads: producer 0 also the window, as 128-byte K
//   chunks of the three planes (one mbarrier a chunk, so the first tiles
//   compute on chunk c while the later ones land), and each its consumer's
//   M tiles' int16 rows as 64 x 128-byte boxes; all 128-byte swizzled.
//   Rows past the last step arrive as zeros (TMA's out-of-bounds fill) and
//   are not stored.
// * Each warp of a consumer owns 16 rows of the M tile.  At a K chunk it
//   reads its rows' 16 words of int16 pairs from the ring and hands the
//   stage back at once; per K step of 16 it splits its 8 values into the
//   three bf16 A fragments in registers (a, b and a + b, each exact: |a + b|
//   <= 254) with integer masks and bf16x2 subtractions on both values of a
//   pair at once, then issues one wgmma m64n64k16 per plane against the
//   window's swizzled tile.  The split is paid once for 64 columns.  Two A
//   sets alternate, a set rewritten only after the group that read it has
//   retired.  While one consumer splits or stores, the other's products
//   can run.
// * Accumulators: the three planes' m64n64 sums, 96 f32 registers a
//   thread.  At the end of K each is truncated (exact integers) and the
//   three meet in uint32, then round and clip; the four lanes of a quad
//   trade their bytes by shuffles so that each stores 16 contiguous bytes
//   of a row (or the i32 s, 8 bytes a store, with Check).
// * A window's chunk c is reloaded for the next window once both
//   consumers' last tiles in the old one have retired their products on it
//   (a consumer with no tile in a window still waits for its chunks, so
//   that its arrival cannot count toward the previous window's).
// What holds it back (libiqo_tpu_torch/tools/slice_ablate.py on the H100):
// the copies alone, 63 MB from L2 a launch at (128, 512), take about half
// the kernel's time, and the products, the split and the epilogue's
// conversions add to them instead of hiding under them.
// Shared memory: 196,608 (window) + 2 x 2 x 8,192 (rings) + 24 barriers +
// 1,024 alignment slack = 230,592 of 232,448 bytes, one block an SM.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

namespace gl {
constexpr int kTH = 32, kBW = 3840, kTWF = 1920, kGN = 128, kGroups = 15;
constexpr int kBN = 64;                    // columns of a block's window: half a group
constexpr int kWindows = kGroups * (kGN / kBN);
constexpr int kBM = 64;                    // rows of an M tile: two steps
constexpr int kKC = 64;                    // K of a chunk: 128 bytes, the swizzle's width
constexpr int kMaxChunks = 8;              // kl <= 512
constexpr int kStages = 2;                 // each consumer's ring of M-tile rows
constexpr int kConsumers = 2;              // warpgroups, alternate M tiles each
constexpr int kThreads = 160 * kConsumers;       // + a producer warp each
constexpr int kTileBytes = kBN * kKC * 2;  // one plane's K chunk of the window
constexpr int kChunkBytes = 3 * kTileBytes;
constexpr int kWinBytes = kMaxChunks * kChunkBytes;
constexpr int kStageBytes = kBM * kKC * 2; // one K chunk of an M tile's int16 rows
constexpr int kBarriers = 2 * kConsumers * kStages + 2 * kMaxChunks;
constexpr int kSmem = kWinBytes + kConsumers * kStages * kStageBytes + 8 * kBarriers +
                      1024;                // + the alignment slack
static_assert(kTileBytes % 1024 == 0 && kStageBytes % 1024 == 0, "swizzled tiles 1024-aligned");
static_assert(kSmem <= 232448, "shared memory of one block");
}  // namespace gl

// D[64 x 64] (+)= A[64 x 16] (registers) x B[16 x 64] (shared, by
// descriptor), bf16 -> f32; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
__device__ __forceinline__ uint32_t u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The Karatsuba split of a pair of int16 (x in the low half, y in the high
// half) into bf16x2 a, b and a + b, pair for pair, every step exact.  With
// lb, hb a value's low and high byte: b = int8(lb) = (lb & 127) - 128 bit7(lb)
// and a = int8(hb) + bit7(lb).  bf16 0x4300 | m is 128 + m for m < 128, and
// with bit 7 set, 0x4380 is 256; bf16 0x0080 is 2^-126, times 2^126 one.
__device__ __forceinline__ void split_pair(uint32_t v, uint32_t& pa, uint32_t& pb,
                                           uint32_t& ps) {
  const uint32_t h = v >> 8;                              // the high bytes in bits 0-7, 16-23
  const __nv_bfloat162 b = __hsub2(bf2((v & 0x007F007Fu) | 0x43004300u),    // 128 + (lb & 127)
                                   bf2((v & 0x00800080u) | 0x43004300u));   // 128 or 256
  const __nv_bfloat162 hs = __hsub2(bf2((h & 0x007F007Fu) | 0x43004300u),   // int8(hb)
                                    bf2((h & 0x00800080u) | 0x43004300u));
  const __nv_bfloat162 a = __hfma2(bf2(v & 0x00800080u), bf2(0x7E807E80u), hs);   // + bit7(lb)
  pa = u32(a);
  pb = u32(b);
  ps = u32(__hadd2(a, b));
}

__device__ __forceinline__ uint32_t f2u(float x) {
  return static_cast<uint32_t>(__float2int_rz(x));
}

struct Tile {                              // tile t of the window-major order
  int window, m, col0, k0;
};

__device__ __forceinline__ Tile tile_of(int t, int mt, int align, int kl) {
  const int wi = t / mt, g = wi / 2;
  return {wi, t % mt, gl::kGN * g + gl::kBN * (wi % 2),
          min(max(0, 2 * gl::kGN * g - 5) / align * align, gl::kBW - kl)};
}

template <bool kCheck>
__global__ void __launch_bounds__(gl::kThreads, 1)
slice_wgmma_kernel(const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_c, void* __restrict__ out, int steps,
                   int align, int kl) {
  using namespace gl;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* win = align1024(smem_raw);                       // [chunk][plane] 64 x 128 bytes
  uint8_t* rings = win + kWinBytes;                         // [consumer][stage] 64 x 128 bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(rings + kConsumers * kStages * kStageBytes);
  uint64_t* empty = full + kConsumers * kStages;            // both [consumer][stage]
  uint64_t* wfull = empty + kConsumers * kStages;
  uint64_t* wempty = wfull + kMaxChunks;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int chunks = kl / kKC, mt = (steps * kTH + kBM - 1) / kBM, tiles = kWindows * mt;
  const int t0 = static_cast<int>(static_cast<long long>(blockIdx.x) * tiles / gridDim.x);
  const int t1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * tiles / gridDim.x);

  if (tid == 0) {
    for (int s = 0; s < kConsumers * kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);           // every thread of the stage's consumer, after its reads
    }
    for (int c = 0; c < kMaxChunks; ++c) {
      mbar_init(&wfull[c], 1);
      mbar_init(&wempty[c], 128 * kConsumers);  // every consumer thread, once a window
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Tile t0 + i of the block's run goes to consumer i % kConsumers; a
  // consumer takes its tiles in order, through a ring of its own that a
  // producer warp of its own fills.
  if (warp >= 4 * kConsumers) {            // producer warp j: one thread issues
    const int j = warp - 4 * kConsumers;
    if (lane == 0) {
      const CUtensorMap* mw = &map_w;
      const CUtensorMap* mc = &map_c;
      int it = 0;
      auto load_rows = [&](int tt, int c) {
        const int s = j * kStages + it % kStages;
        const Tile tl = tile_of(tt, mt, align, kl);
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);     // its last readers are done
        mbar_expect(&full[s], kStageBytes);
        tma_2d(rings + s * kStageBytes, mw, 2 * (tl.k0 + kKC * c), kBM * tl.m, &full[s]);
        ++it;
      };
      for (int t = t0, seg = 0; t < t1; ++seg) {
        const Tile first = tile_of(t, mt, align, kl);
        const int tend = min(t1, (first.window + 1) * mt);
        const int mine = t + ((j - (t - t0)) % kConsumers + kConsumers) % kConsumers;
        // producer 0 loads the window, chunk by chunk as the previous
        // window's last tiles retire it, each followed by that chunk of its
        // consumer's first tile; then each producer its consumer's tiles
        for (int c = 0; c < chunks && j == 0; ++c) {
          if (seg > 0) mbar_wait(&wempty[c], (seg - 1) & 1);
          mbar_expect(&wfull[c], kChunkBytes);
          for (int p = 0; p < 3; ++p)
            tma_2d(win + (3 * c + p) * kTileBytes, mc, 2 * (first.k0 + kKC * c),
                   kTWF * p + first.col0, &wfull[c]);
          if (mine < tend) load_rows(mine, c);
        }
        for (int tt = j == 0 ? mine + kConsumers : mine; tt < tend; tt += kConsumers)
          for (int c = 0; c < chunks; ++c) load_rows(tt, c);
        t = tend;
      }
    }
    return;
  }

  // consumer warpgroup j: warp wl owns rows 16 wl + g and 16 wl + g + 8 of
  // each of its M tiles (g = lane / 4); d[p] is plane p's m64n64 sum in
  // wgmma's fragment layout (n8 tile j: d[p][4 j + 2 h + e] is row
  // 16 wl + g + 8 h, column 8 j + 2 q + e)
  const int j = warp / 4, wl = warp % 4, g = lane / 4, q = lane % 4;
  const uint32_t win_addr = smem_addr(win);
  const uint8_t* ring = rings + j * kStages * kStageBytes;
  // this thread's word q of 16-byte piece P of row r in a swizzled stage
  const int off0 = (16 * wl + g) * 128 + 4 * q, off1 = off0 + 8 * 128;
  const long long rows = static_cast<long long>(steps) * kTH;
  int it = 0;
  for (int t = t0, seg = 0; t < t1; ++seg) {
    const Tile first = tile_of(t, mt, align, kl);
    const int tend = min(t1, (first.window + 1) * mt);
    const int mine = t + ((j - (t - t0)) % kConsumers + kConsumers) % kConsumers;
    if (mine >= tend) {                    // no tile here: the window's phase passes anyway
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(&wfull[c], seg & 1);
        mbar_arrive(&wempty[c]);
      }
      t = tend;
      continue;
    }
    for (int tt = mine; tt < tend; tt += kConsumers) {
      const bool last = tt + kConsumers >= tend;
      float d[3][32];
      uint32_t af[2][3][4];                // two A sets: K step kk writes set kk & 1
      for (int c = 0; c < chunks; ++c, ++it) {
        const int s = it % kStages;
        mbar_wait(&full[j * kStages + s], (it / kStages) & 1);
        if (tt == mine) mbar_wait(&wfull[c], seg & 1);       // the window's chunk c is in
        const uint8_t* st = ring + s * kStageBytes;
        uint32_t wv[4][4];                 // [K step][row g pair k 2q, row g + 8, k 2q + 8 ...]
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int p0 = ((2 * kk) ^ g) << 4, p1 = ((2 * kk + 1) ^ g) << 4;
          wv[kk][0] = *reinterpret_cast<const uint32_t*>(st + off0 + p0);
          wv[kk][1] = *reinterpret_cast<const uint32_t*>(st + off1 + p0);
          wv[kk][2] = *reinterpret_cast<const uint32_t*>(st + off0 + p1);
          wv[kk][3] = *reinterpret_cast<const uint32_t*>(st + off1 + p1);
        }
        mbar_arrive(&empty[j * kStages + s]);   // the rows are in registers: hand the stage back
        const uint32_t wtile = win_addr + 3 * c * kTileBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t (&a)[3][4] = af[kk & 1];   // the set K step kk - 2 read: retired
#pragma unroll
          for (int i = 0; i < 4; ++i) split_pair(wv[kk][i], a[0][i], a[1][i], a[2][i]);
          wgmma_fence();
#pragma unroll
          for (int p = 0; p < 3; ++p)
            wgmma_rs_m64n64(d[p], a[p], desc_sw128(wtile + p * kTileBytes + 32 * kk),
                            (c | kk) != 0);
          wgmma_commit();
#pragma unroll
          for (int p = 0; p < 3; ++p) pin(a[p]);
          wgmma_wait<1>();                 // K step kk - 1 retired: its A set is free
          if (last && kk == 0 && c > 0) mbar_arrive(&wempty[c - 1]);   // chunk c - 1 is read
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < 3; ++p) pin(d[p]);
      if (last) mbar_arrive(&wempty[chunks - 1]);

      // each plane's sums truncated (exact integers), met in uint32, then
      // rounded and clipped to u8 (or s itself with Check)
      const Tile tl = tile_of(tt, mt, align, kl);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = static_cast<long long>(kBM) * tl.m + 16 * wl + g + 8 * h;
        uint32_t sv[8][2];                 // [n8 tile j][column 8 j + 2 q + e]
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            sv[j][e] = f2u(d[0][i]) * 65280u - f2u(d[1][i]) * 255u + f2u(d[2][i]) * 256u;
          }
        if constexpr (kCheck) {
          if (row < rows) {
            int32_t* o = static_cast<int32_t*>(out) + row * kTWF + tl.col0 + 2 * q;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              *reinterpret_cast<int2*>(o + 8 * j) =
                  make_int2(static_cast<int>(sv[j][0]), static_cast<int>(sv[j][1]));
          }
        } else {
          // pk[i]: the u8 pairs of n8 tiles 2 i and 2 i + 1; the quad's four
          // lanes trade them so that lane q holds columns 16 q .. 16 q + 15
          // of the row (pk of lane q' at index q) and stores them as one
          // 16-byte word
          uint32_t pk[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t u[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              u[e] = static_cast<uint32_t>(
                  min(max(static_cast<int>(sv[2 * i + e / 2][e % 2] + (1u << 19)) >> 20, 0), 255));
            pk[i] = u[0] | u[1] << 8 | u[2] << 16 | u[3] << 24;
          }
          auto pick = [&](int i) {
            return i == 0 ? pk[0] : i == 1 ? pk[1] : i == 2 ? pk[2] : pk[3];
          };
          uint32_t r[4];                   // r[q']: lane q''s pk[q], by selects (no local memory)
#pragma unroll
          for (int i = 0; i < 4; ++i) r[i] = i == q ? pk[i] : 0u;
#pragma unroll
          for (int k = 1; k < 4; ++k) {    // lane q + k (mod 4) of the quad sends its pk[q]
            const uint32_t got =
                __shfl_sync(0xffffffffu, pick((q - k) & 3), (lane & ~3) | ((q + k) & 3));
#pragma unroll
            for (int i = 0; i < 4; ++i) r[i] = i == ((q + k) & 3) ? got : r[i];
          }
          if (row < rows)
            *reinterpret_cast<uint4*>(static_cast<uint8_t*>(out) + row * kTWF + tl.col0 + 16 * q) =
                make_uint4(__byte_perm(r[0], r[1], 0x5410), __byte_perm(r[2], r[3], 0x5410),
                           __byte_perm(r[0], r[1], 0x7632), __byte_perm(r[2], r[3], 0x7632));
        }
      }
    }
    t = tend;
  }
}

}  // namespace

extern "C" {

// Raise both instantiations' dynamic shared-memory limits on the current
// device; call once per device before their first launch.
int iqo_exp_slice_wgmma_setup() {
  int rc = static_cast<int>(cudaFuncSetAttribute(
      slice_wgmma_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, gl::kSmem));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      slice_wgmma_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, gl::kSmem));
  return rc;
}

// The geometry the kernel was built with, for the host's model: M tile rows,
// window columns, K chunk, most chunks, ring stages, threads, shared bytes.
int iqo_exp_slice_wgmma_shape(int* shape) {
  const int v[7] = {gl::kBM, gl::kBN, gl::kKC, gl::kMaxChunks, gl::kStages, gl::kThreads,
                    gl::kSmem};
  for (int i = 0; i < 7; ++i) shape[i] = v[i];
  return 0;
}

// Kernel L, wgmma form: w (steps, 32, 3840) i16, ct (3, 1920, 3840) bf16
// (K-major) -> out (steps, 32, 1920) u8, or the i32 sums with check; `ctas`
// persistent blocks (1 .. the tile count) take the window-major tiles in
// contiguous runs.
int iqo_exp_slice_wgmma(int align, int kl, int check, const void* w, const void* ct, void* out,
                        int steps, int ctas, void* stream) {
  using namespace gl;
  if (align < 8 || align % 8 || kl < kKC || kl % kKC || kl > kMaxChunks * kKC || steps < 1)
    return 1008;
  const long long tiles = static_cast<long long>(kWindows) * ((steps * kTH + kBM - 1) / kBM);
  if (ctas < 1 || ctas > tiles) return 1008;
  if ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(ct) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return 1002;
  // both as bytes: w (steps 32 rows, 7680), ct (3 x 1920 rows, 7680), boxes
  // of 64 rows x 128 bytes
  CUtensorMap mw, mc;
  int rc = encode_sw128(&mw, w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2LL * kBW,
                        static_cast<long long>(steps) * kTH, kBM);
  if (!rc) rc = encode_sw128(&mc, ct, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2LL * kBW, 3LL * kTWF,
                             kBN);
  if (rc) return rc;
  auto s = static_cast<cudaStream_t>(stream);
  if (check)
    slice_wgmma_kernel<true><<<ctas, kThreads, kSmem, s>>>(mw, mc, out, steps, align, kl);
  else
    slice_wgmma_kernel<false><<<ctas, kThreads, kSmem, s>>>(mw, mc, out, steps, align, kl);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
