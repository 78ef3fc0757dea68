// Kernel I's s8 schemes redesigned for Hopper (sm_90a): s8_4dot and
// s8_2dot_cat as s8 wgmma GEMMs whose M stacks the repeats' work rows, on a
// persistent walk that keeps every SM busy.
//
// Kernel I, xscheme_s8_gemm<kCat>: replaces scripts/exp_x_schemes.py, make
// (pl.pallas_call at :156), variants s8_4dot (kCat false) and s8_2dot_cat
// (kCat true).  On w (160, 896) i32 and the taps' planes e = int8(C >> 8),
// f = int8(C & 255) (C (3, 384, 128)), group g of 128 outputs contracts the
// work columns [256 g, 256 g + 384):
//   out = sum_{r < reps} 65536 ae + 256 (af + be) + bf + corr, int32 wraps,
//   a = int8((w + r) >> 8), b = int8(((w + r) & 255) - 128),
// bit for bit equal to exp_x_schemes.x_scheme_plain("s8_4dot") and
// ("s8_2dot_cat"), which compute the same function.  a is byte 1 of w + r and
// b its byte 0 XOR 0x80: both are the bytes of int16(w + r), so the split is
// s16_1dot[gemm]'s (exp_xpass_gemm.cu, xscheme_s16_gemm) plus one XOR, and
// every product is .s8.s8.  (Its int16 pairs plus r are one DPX instruction,
// __viaddmax_s16x2, here, where add16x2 takes four.)
//   kCat false (s8_4dot): four wgmma m64n64k32 .s32.s8.s8 a K step of 32,
//   a e, a f, b e and b f, a f and b e into one accumulator: three sets of 32
//   s32 registers.  kCat true (s8_2dot_cat): two wgmma m64n128k32 .s32.s8.s8
//   a K step, a [e | f] and b [e | f], the B tile's 128 rows the block's 64 e
//   columns, then its 64 f columns: two sets of 64.  The two issue the same
//   multiply-adds; they ask the TPU script's per-dot question on Hopper, one
//   N = 128 product against two of N = 64.
//   Block: two warpgroups, a tile of 16 work rows x 64 output columns (half
//   a group).  A step stacks 8 repeats, one a warp (warp w: repeat 8 step +
//   w); per K step a lane reads its int16 pairs of rows g and g + 8 from the
//   resident window as two 16-byte words, adds r to both halves of each word
//   (one DPX add a word), and permutes out the high bytes (a) and the low
//   bytes XOR 0x80 (b).  A repeat past reps reads a window of zeros with
//   0x80 added to each int16 in place of r, which gives a = b = 0 without a
//   select a fragment.  The taps, laid out once by
//   the host (build_cvals' ef_k: [e^T; f^T], K-major), stay in shared memory
//   as 3 K blocks of 128 rows x 128 bytes, 128-byte swizzled, a cp.async
//   group a K block, so that a tile's first step computes on K block kb while
//   the later ones land.  Two wgmma groups in flight (two A sets).
//   The walk: the work is 60 tiles x ceil(reps / 8) steps of (tile, step)
//   units, unit = tile * steps + step (tile = 10 half + row tile); a
//   persistent grid of min(SMs, units) blocks, block b taking the units
//   [b U / B, (b + 1) U / B): at R = 512, 3840 units on 132 SMs, runs of 29
//   or 30, a wave efficiency of 0.97 against the 0.909 of s16_1dot's
//   slicing (120 blocks of 32 steps).  A block flushes its sums where its run crosses into a new
//   tile and after at most 64 steps of one tile, so that no s32 sum leaves
//   int32 (64 x 384 x 128 x 128 x 2 < 2^31 for the middle sum): it forms
//   65536 hh + 256 mid + ll in uint32, plus corr[col] times the live repeats
//   the warp summed, the 8 warps' sums meet in shared memory and then in the
//   zeroed output by one uint32 atomicAdd an output.  Where the run goes on
//   into a new tile, that tile's taps (cp.async) and window (loads into
//   registers) are issued into the other of two buffers before the flush, so
//   that they land while it runs.
//   Shared memory: 2 x (49,152 taps + 12,288 window) + 32,768 the warps' sums
//   + 12,288 zeros + 1,024 alignment slack = 168,960 bytes; one block an SM,
//   8 warps (2 a scheduler).
//
// What bounds it on the H100: operations.  Per application the four s8
// products are 94.4 M multiply-adds, 0.0954 us at 1,979 TOP/s; the bytes
// (under 2 MB a launch) are read once for all repeats.  What the design does
// about it: the split is two loads, 8 DPX adds, 8 permutes and 4 XORs a lane
// and K step for 4 (or 2) products of 64 x 64 (or 128) x 32 (drafts with the
// s16 form's SWAR add, 4 instructions a word, and a select a fragment for
// the repeats past reps were issue-bound and slower), the taps are read by
// the tensor cores from shared memory, and the walk gives each SM the same
// share of the units.
//
// Intended int32 wraps (the recombination, corr times the repeats, the
// warps' and blocks' meeting) are uint32 arithmetic, inline PTX mad.lo.u32 /
// add.u32 (hopper.cuh).

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

namespace g8 {
constexpr int kThreads = 256;              // two warpgroups of 4 warps
constexpr int kRows = 16;                  // work rows of a tile
constexpr int kRepStep = 8;                // repeats a step stacks along M: one a warp
constexpr int kCols = 64;                  // output columns of a tile: half a group
constexpr int kK = 384, kKC = 128, kKBlocks = kK / kKC;   // K blocks of 128 bytes
constexpr int kKSteps = kK / 32;           // wgmma k32 steps
constexpr int kBand = 896, kTW = 384, kTH = 160, kGN = 128;
constexpr int kTilesY = kTW / kCols, kTilesZ = kTH / kRows, kTiles = kTilesY * kTilesZ;
constexpr int kBTile = 2 * kCols * kKC;    // a K block of the tile's taps: e's 64 rows, f's 64
constexpr int kSmemB = kKBlocks * kBTile;  // the tile's taps, resident
constexpr int kSmemW = kRows * kK * 2;     // the tile's work window as int16, in A-fragment order
constexpr int kBuf = kSmemB + kSmemW;      // one of the two tile buffers
constexpr int kSmemPart = kRepStep * kRows * kCols * 4;   // the warps' sums at a flush
constexpr int kSmemZ = kSmemW;             // a window of zeros: the A rows of a repeat past reps
constexpr int kSmem = 2 * kBuf + kSmemPart + kSmemZ + 1024;   // + the alignment slack
constexpr int kWLoads = kRows * kK / 2 / kThreads;        // int16 pairs of the window a thread
// A warp's accumulators sum its repeats between two flushes: at most this
// many steps, so that no s32 sum can leave int32 for any s8 planes (the
// middle sum, a f + b e, the largest: 2 x 384 x 128 x 128 a repeat)
constexpr int kMaxRunSteps = 64;
static_assert(kBTile % 1024 == 0 && kBuf % 1024 == 0, "K blocks 1024-byte aligned");
static_assert(static_cast<long long>(kMaxRunSteps) * kK * 128 * 128 * 2 < (1LL << 31),
              "a flush's s32 sums stay in int32");
static_assert(kWLoads * kThreads * 2 == kRows * kK, "the window's pairs share out evenly");
static_assert(kSmemZ % (16 * kThreads) == 0, "the zeros share out in 16-byte stores");
static_assert(kSmem <= 232448, "shared memory of one block");
}  // namespace g8

// wgmma .s32.s8.s8 at N = 64 and N = 128 (hopper.cuh)
IQO_WGMMA_I8(wgmma_s8s8, "s8.s8")
IQO_WGMMA_I8_N128(wgmma_s8s8_n128, "s8.s8")

// int16(x + r) of a pair of int16 in one word, each half wrapped to 16 bits:
// Hopper's DPX add-and-max on 16-bit halves, one instruction (the max with
// -32768 keeps every sum), where add16x2 takes four
__device__ __forceinline__ uint32_t add_pair(uint32_t x, uint32_t rr) {
  return __viaddmax_s16x2(x, rr, 0x80008000u);
}

template <bool kCat>
__global__ void __launch_bounds__(g8::kThreads, 1)
xscheme_s8_gemm(const int32_t* __restrict__ w, const int8_t* __restrict__ ck,
                const int32_t* __restrict__ corr, uint32_t* __restrict__ out, int reps) {
  using namespace g8;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);     // two tile buffers: [taps][window]
  uint32_t* part = reinterpret_cast<uint32_t*>(base + 2 * kBuf);   // [warp][row][column]
  uint8_t* zeros = base + 2 * kBuf + kSmemPart;                    // read in the window's place
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int steps = (reps + kRepStep - 1) / kRepStep;

  // this block's units [u, u1) of the walk, unit = tile * steps + step:
  // equal contiguous runs
  const long long units = static_cast<long long>(kTiles) * steps;
  long long u = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;
  if (u >= u1) return;

  // tile t: half = t / kTilesZ (64 output columns, group half / 2), row tile
  // t % kTilesZ.  Its taps (ck: (3, 256, 384), K-major, e's 128 columns then
  // f's): row n < 64 of K block kb is e's column 64 (half % 2) + n, row 64 +
  // n f's, 128 bytes of K at 128 kb, each 16-byte piece at piece ^ (n & 7);
  // one cp.async group a K block
  auto load_taps = [&](int tile, uint8_t* buf) {
    const int half = tile / kTilesZ;
    const int8_t* cg = ck + static_cast<long long>(half / 2) * 2 * kGN * kK;
#pragma unroll
    for (int kb = 0; kb < kKBlocks; ++kb) {
#pragma unroll
      for (int j = 0; j < 2 * kCols * 8 / kThreads; ++j) {
        const int i = tid + kThreads * j, n = i / 8, pc = i % 8;
        const int row = (n / kCols) * kGN + kCols * (half % 2) + n % kCols;
        cp_async16(buf + kb * kBTile + n * 128 + ((pc ^ (n & 7)) << 4),
                   cg + static_cast<long long>(row) * kK + kKC * kb + 16 * pc);
      }
      cp_commit();
    }
  };
  // its window: int16(w) of the tile's 16 rows over the group's 384 columns,
  // loaded into registers (wv) and then stored with element (row, k) at byte
  // ((k / 32 * 2 + row / 8) * 32 + 4 (row % 8) + k % 16 / 4) * 16 + 8 (k % 32
  // / 16) + 2 (k % 4), as xscheme_s16_gemm's: lane (g, q) reads its K step's
  // A values of rows g and g + 8 as two 16-byte words
  int2 wv[kWLoads];
  auto load_window = [&](int tile) {
    const int32_t* wsrc = w + static_cast<long long>(kRows * (tile % kTilesZ)) * kBand +
                          256 * (tile / kTilesZ / 2);
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = tid + kThreads * j, row = i / (kK / 2), k = 2 * (i % (kK / 2));
      wv[j] = __ldg(reinterpret_cast<const int2*>(wsrc + static_cast<long long>(row) * kBand + k));
    }
  };
  auto store_window = [&](uint8_t* buf) {
#pragma unroll
    for (int j = 0; j < kWLoads; ++j) {
      const int i = tid + kThreads * j, row = i / (kK / 2), k = 2 * (i % (kK / 2));
      const int off = (((k / 32) * 2 + row / 8) * 32 + 4 * (row % 8) + k % 16 / 4) * 16 +
                      8 * (k % 32 / 16) + 2 * (k % 4);
      *reinterpret_cast<uint32_t*>(buf + kSmemB + off) =
          (static_cast<uint32_t>(wv[j].x) & 0xFFFFu) | (static_cast<uint32_t>(wv[j].y) << 16);
    }
  };

  // s8_4dot: d0 = a e, d1 = a f + b e, d2 = b f; s8_2dot_cat: d0 = a [e | f],
  // d1 = b [e | f] (fragment i < 32 against e, 32 + i the same place against
  // f), d2 unused.  Warp w's 16 rows are the tile's work rows at repeat
  // 8 step + w.
  uint32_t d0[kCat ? 64 : 32], d1[kCat ? 64 : 32], d2[32];
#pragma unroll
  for (int i = 0; i < (kCat ? 64 : 32); ++i) d0[i] = d1[i] = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) d2[i] = 0;

  // The flush of a tile's steps s0 .. s1 - 1: the warp's recombined sums
  // plus corr times its live repeats, met in shared memory, then in the
  // output
  auto flush = [&](int tile, int s0, int s1) {
    wgmma_wait<0>();
    pin(d0);
    pin(d1);
    if constexpr (!kCat) pin(d2);
    const int half = tile / kTilesZ;
    const int lim = reps > warp ? (reps - warp + kRepStep - 1) / kRepStep : 0;
    const uint32_t live = static_cast<uint32_t>(max(0, min(s1, lim) - s0));
    const int32_t* cr = corr + (half / 2) * kGN + kCols * (half % 2);
    __syncthreads();                       // every thread has read the last flush's sums
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * q + i % 2;
      uint32_t hh, mid, ll;
      if constexpr (kCat) {
        hh = d0[i];
        mid = add_u32(d0[32 + i], d1[i]);
        ll = d1[32 + i];
      } else {
        hh = d0[i];
        mid = d1[i];
        ll = d2[i];
      }
      part[(warp * kRows + g + 8 * (i % 4 / 2)) * kCols + col] =
          mad_u32(static_cast<uint32_t>(__ldg(cr + col)), live,
                  mad_u32(hh, 65536u, mad_u32(mid, 256u, ll)));
    }
    __syncthreads();
    uint32_t* otile = out + static_cast<long long>(kRows * (tile % kTilesZ)) * kTW + kCols * half;
    for (int e = tid; e < kRows * kCols; e += kThreads) {
      uint32_t v = 0;
#pragma unroll
      for (int wp = 0; wp < kRepStep; ++wp) v = add_u32(v, part[wp * kRows * kCols + e]);
      atomicAdd(otile + (e / kCols) * kTW + e % kCols, v);
    }
#pragma unroll
    for (int i = 0; i < (kCat ? 64 : 32); ++i) d0[i] = d1[i] = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) d2[i] = 0;
  };

  int buf = 0;                             // the buffer that holds the current tile
#pragma unroll
  for (int i = 0; i < kSmemZ / (16 * kThreads); ++i)   // before the first step's barrier
    reinterpret_cast<uint4*>(zeros)[tid + kThreads * i] = make_uint4(0, 0, 0, 0);
  load_taps(static_cast<int>(u / steps), base);
  load_window(static_cast<int>(u / steps));
  store_window(base);
  bool fresh = true;                       // the buffer's taps are still landing
  uint32_t ahi[2][4], alo[2][4];           // two A sets: K step kk writes set kk & 1
  const uint4* wfrag0 = reinterpret_cast<const uint4*>(base + kSmemB) + lane;
  const uint4* zfrag = reinterpret_cast<const uint4*>(zeros) + lane;
  while (u < u1) {
    const int tile = static_cast<int>(u / steps), s0 = static_cast<int>(u % steps);
    int s1 = min(steps, s0 + kMaxRunSteps);
    if (u1 - u < s1 - s0) s1 = s0 + static_cast<int>(u1 - u);
    const uint32_t bbase = smem_addr(base + buf * kBuf);
    const uint4* wfrag = wfrag0 + buf * (kBuf / 16);
    for (int step = s0; step < s1; ++step) {
      // a repeat past reps reads the zeros plus 0x80 in each int16: a = 0, b = 0
      const uint32_t r = static_cast<uint32_t>(kRepStep * step + warp);
      const bool on = r < static_cast<uint32_t>(reps);
      const uint32_t rr = on ? (r & 0xFFFFu) * 0x10001u : 0x00800080u;
      const uint4* wf = on ? wfrag : zfrag;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        if (fresh && step == s0 && kk % 4 == 0) {   // the tile's first step waits for K block kk / 4
          if (kk == 0) cp_wait<kKBlocks - 1>();
          else if (kk == 4) cp_wait<kKBlocks - 2>();
          else cp_wait<0>();
          fence_proxy_async();
          __syncthreads();
        }
        const uint4 x0 = wf[(2 * kk) * 32];          // row g: k 4q .. 4q + 3, 16 + 4q ..
        const uint4 x1 = wf[(2 * kk + 1) * 32];      // row g + 8
        const uint32_t p[8] = {add_pair(x0.x, rr), add_pair(x0.y, rr), add_pair(x1.x, rr),
                               add_pair(x1.y, rr), add_pair(x0.z, rr), add_pair(x0.w, rr),
                               add_pair(x1.z, rr), add_pair(x1.w, rr)};
        uint32_t (&a)[4] = ahi[kk & 1];    // the sets K step kk - 2 read: retired
        uint32_t (&b)[4] = alo[kk & 1];
#pragma unroll
        for (int i = 0; i < 4; ++i) {      // a_i: rows g, g + 8, g, g + 8; k 4q.., 4q.., 16 + 4q..
          a[i] = __byte_perm(p[2 * i], p[2 * i + 1], 0x7531);                 // high bytes
          b[i] = __byte_perm(p[2 * i], p[2 * i + 1], 0x6420) ^ 0x80808080u;   // low ^ 0x80
        }
        const uint32_t kb = bbase + (kk / 4) * kBTile + 32 * (kk % 4);
        wgmma_fence();
        if constexpr (kCat) {
          const uint64_t def = desc_sw128(kb);       // 128 rows: e's 64, then f's
          wgmma_s8s8_n128(d0, a, def);
          wgmma_s8s8_n128(d1, b, def);
        } else {
          const uint64_t de = desc_sw128(kb), df = desc_sw128(kb + kBTile / 2);
          wgmma_s8s8(d0, a, de);
          wgmma_s8s8(d1, a, df);
          wgmma_s8s8(d1, b, de);
          wgmma_s8s8(d2, b, df);
        }
        wgmma_commit();
        pin(a);
        pin(b);
        wgmma_wait<1>();                   // K step kk - 1 retired: its A sets are free
      }
    }
    u += s1 - s0;
    // a run that goes on into the next tile issues its loads into the other
    // buffer (read last by the tile before, whose flush waited for every
    // product) before this flush, and stores the window after it
    const bool next = u < u1 && u / steps != tile;
    if (next) {
      load_taps(tile + 1, base + (buf ^ 1) * kBuf);
      load_window(tile + 1);
    }
    flush(tile, s0, s1);
    if (next) {
      store_window(base + (buf ^ 1) * kBuf);
      buf ^= 1;
    }
    fresh = next;
  }
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

template <bool kCat>
int setup_one() {
  int rc = static_cast<int>(cudaFuncSetAttribute(
      xscheme_s8_gemm<kCat>, cudaFuncAttributeMaxDynamicSharedMemorySize, g8::kSmem));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      xscheme_s8_gemm<kCat>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared));
  return rc;
}

}  // namespace

extern "C" {

// Raise both instantiations' dynamic shared-memory limits (and prefer shared
// memory over L1) on the current device; call once per device before their
// first launch.
int iqo_exp_xpass_s8_setup() {
  const int rc = setup_one<false>();
  return rc ? rc : setup_one<true>();
}

// The geometry the kernel was built with, for the host's model: threads,
// rows, repeats a step, columns, K block, K blocks, tiles, shared bytes, most
// steps between two flushes.
int iqo_exp_xpass_s8_shape(int* shape) {
  const int v[9] = {g8::kThreads, g8::kRows,  g8::kRepStep, g8::kCols,          g8::kKC,
                    g8::kKBlocks, g8::kTiles, g8::kSmem,    g8::kMaxRunSteps};
  for (int i = 0; i < 9; ++i) shape[i] = v[i];
  return 0;
}

// Kernel I, s8_4dot (cat 0) and s8_2dot_cat (cat 1): w (160, 896) i32, ck
// (3, 256, 384) s8 (e's and f's columns, K-major), corr (3, 128) i32 -> out
// (160, 384) int32, zeroed by the caller, on the walk of `blocks`
// persistent blocks (at most one a unit).
int iqo_exp_xscheme_s8_gemm(const void* w, const void* ck, const void* corr, void* out,
                            int reps, int cat, int blocks, void* stream) {
  using namespace g8;
  if (reps < 1 || blocks < 1 || (cat != 0 && cat != 1)) return 1008;
  const int steps = (reps + kRepStep - 1) / kRepStep;
  if (blocks > static_cast<long long>(kTiles) * steps) return 1008;
  if (misaligned(w) || misaligned(ck) || misaligned(out) || corr == nullptr) return 1002;
  const auto* wp = static_cast<const int32_t*>(w);
  const auto* cp = static_cast<const int8_t*>(ck);
  const auto* rp = static_cast<const int32_t*>(corr);
  auto* op = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (cat)
    xscheme_s8_gemm<true><<<blocks, kThreads, kSmem, s>>>(wp, cp, rp, op, reps);
  else
    xscheme_s8_gemm<false><<<blocks, kThreads, kSmem, s>>>(wp, cp, rp, op, reps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
