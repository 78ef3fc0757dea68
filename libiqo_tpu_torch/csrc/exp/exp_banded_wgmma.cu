// Kernel D redesigned for Hopper (sm_90a), form "wgmma": the same function
// as exp_banded.cu's banded_tile<Y, X> (the first, mma.sync form, kept).
// Per tile t of band (tiles, 336, 896) u8:
//   w    = int32(cy (160, 336) @ bf16(band))  Y mono (f32 sums, exact)
//          or each group of 40 rows over its 96 band rows   Y grouped
//          or band[:160] * 37                               Y skip
//   w    = wrap16(w); b = ((w + 128) & 255) - 128; a = (w - b) >> 8
//   sums = 65280 D0 - 255 D1 + 256 D2 (uint32), Dp = int32 of (a, b, a + b
//          as bf16) @ cxp (896, 384) X mono, or each group of 128 columns
//          over its 384 work columns X grouped, or a * 65280 + b * 256 on the
//          first 384 columns X skip
//   out  = clip(wrap16((sums + 2^19) >> 20), 0, 255) as u8 (160, 384).
// Replaces the TPU kernel of scripts/exp_banded_dots.py: make (pl.pallas_call
// at :92), all nine (Y, X) modes of :150-155, with the groups of :39-40.  The
// Python side is libiqo_tpu_torch/experiments/exp_banded_dots.py (form
// "wgmma", the default), its walk and NumPy model experiments/banded_wgmma.py.
//
// What bounds it on the H100: operations.  A 35-tile frame is 7.47 G bf16
// multiply-adds in mono/mono (15.1 us at 989 TFLOP/s), 2.96 G in
// grouped/grouped (6.0 us), against 14.9 MB of band, coefficients and output.
//
// What the design does about it.  The sync form gives each 16 output rows
// of a tile a block that reads the three X coefficient planes whole from L2
// (722 MB a launch) and feeds every B fragment to one m16 mma.sync.  Here
// both dots are GEMMs with a shared operand, on wgmma, in two launches, the
// X launch the Y launch's programmatic dependent (its blocks start on the
// SMs Y's blocks leave, and its producer waits for Y's completion before
// its first read; a one-launch form with ready counters was not tried):
// * Y, banded_y_kernel, transposed: w^T (896 x 160) = band^T @ cy^T for each
//   tile, so that M is the 896 band columns (14 x 64, no padding of the 160
//   output rows) and cy^T is B, K-major as cy is stored: resident in shared
//   memory (K padded to 384 with zeros, 6 K blocks of 160 x 128 bytes,
//   128-byte swizzled, all in flight by cp.async at once; the first item's
//   chunk c waits for its K block c alone).  An item is (tile, 64 band
//   columns), one warpgroup's; a persistent grid of one block an SM strides
//   over the items, each warpgroup of it on its own (stages, staging and a
//   named barrier of its own), so that one's loads, widening and stores run
//   beside the other's products.  The band arrives in chunks of 64 rows x
//   64 bytes by 16-byte loads into registers, 3 chunks ahead across items,
//   is widened to bf16 into a double-buffered stage, and ldmatrix.trans
//   gives each warp its A fragments of band^T (16-bit wgmma reads A from
//   registers in mma.sync's layout).  A chunk's K steps are one commit
//   group, retired one chunk later, so that the next chunk's stage is
//   written while they run.  Mono: one wgmma m64n160k16 a K step of 16.
//   Grouped: each group of 40 output rows is n40 of B with the window's 6 K
//   steps only (m64n40k16), so the Y pass does the TPU's grouped work and
//   no more.  Each f32 sum is exact (|terms| sum below 336 x 64 x 255 <
//   2^24), truncated and wrapped to int16, and the item's (160, 64) work
//   values are turned back through shared memory into row-major int16 work
//   rows (10 MB for 35 tiles, in L2), or with X skip straight into the
//   output.  Y skip writes band * 37 the same way, with no dot, each
//   thread's loads of an item all in flight before the first is used.
//   Where the Y launch's time goes is open (tools/banded_ablate.py): its
//   products, its band loads, its widening and its stores each take a small
//   share, and neither the band by cp.async into a ring a whole item ahead
//   nor 6 chunks ahead in registers made it faster.
// * X, banded_x_kernel: the three planes' products over M = tiles x 160 work
//   rows (5,600 at 35 tiles), N = 384, K = 896 (mono) or each 128-column
//   group's 384-wide window (grouped).  An item is 128 work rows x 64
//   outputs; a persistent grid of one block an SM takes contiguous runs of
//   the items (column-block-major: 6 x 44 at 35 tiles, one wave).  A
//   producer warp keeps 4 stages of TMA boxes in flight (5 were slower):
//   per K chunk of 64, the item's int16 work rows (128 x 128 bytes) and the
//   three planes' K-major coefficients (64 x 128 bytes each), 128-byte
//   swizzled, 40 KB.  Two consumer warpgroups, one a 64-row half, read their
//   rows' int16 pairs from the stage and split them in registers into a, b
//   and a + b as bf16 (exp_slice_wgmma.cu's split_pair, every step exact),
//   then issue one wgmma m64n64k16 a plane and K step, a commit group a K
//   step.  The three m64n64 sums (96 f32 registers a thread) are whole over
//   K, truncated (exact integers: the plain version asserts every sum of
//   |terms| below 2^24), met in uint32, rounded, wrapped and clipped; a
//   quad's lanes trade bytes so that each stores 16 contiguous bytes.  A
//   stage is handed back once the products that read it have retired.
//   From L2 a mono launch reads the work rows 6 times (60 MB) and each
//   coefficient plane's 64-column block once an item (91 MB), against the
//   sync form's 722 MB of coefficients; the items' N is 64 because three
//   planes of m64n128 sums would not fit in registers.  The X launch takes
//   about as long as its TMA ring alone plus its products alone
//   (tools/banded_ablate.py).  Drafts that were slower on the H100 and are
//   not kept: three commit groups in flight with four A sets; three
//   consumer warpgroups, one a plane, each on m64n128 (items of 64 rows x
//   128 outputs, the planes meeting in shared memory; 40 % more bytes from
//   L2); that with each coefficient chunk multicast to a cluster of two
//   blocks.
//
// Shared memory: Y 122,880 (cy^T) + 2 x 2 x 9,216 (stages) + 2 x 23,040
// (the items' work values) + 1,024 slack = 206,848 bytes; X 4 x 40,960 (stages)
// + 64 (barriers) + 1,024 slack = 164,928 bytes.  One block an SM each.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

namespace gd {
enum Mode { kMono = 0, kGrouped = 1, kSkip = 2 };
constexpr int kTH = 160, kBH = 336, kBW = 896, kTW = 384;
// the Y kernel
constexpr int kYThreads = 256;                 // two warpgroups
constexpr int kYCols = 64;                     // band columns of an item: a warpgroup's
constexpr int kYColBlocks = kBW / kYCols;      // 14
constexpr int kYChunk = 64;                    // band rows of a chunk
constexpr int kYChunks = (kBH + kYChunk - 1) / kYChunk;   // 6, the last of 16 rows
constexpr int kYAhead = 3;                     // chunks a thread's band loads run ahead
constexpr int kCyKBlocks = 6;                  // cy^T in K blocks of 64 (K padded to 384)
constexpr int kCyTile = kTH * 128;             // one K block: 160 rows x 128 bytes
constexpr int kStagePitch = kYCols * 2 + 16;   // bytes a band row of a stage (bf16)
constexpr int kStageBytes = kYChunk * kStagePitch;   // 2 a warpgroup
constexpr int kOutPitch = kYCols * 2 + 16;     // bytes an output row of the item's work values
constexpr int kOutBytes = kTH * kOutPitch;     // 1 a warpgroup
constexpr int kYSmem = kCyKBlocks * kCyTile + 4 * kStageBytes + 2 * kOutBytes + 1024;
constexpr int kYGroupRows = 40, kYGroupK = 96;  // the script's Y groups (:39)
// the X kernel
constexpr int kXRows = 128;                    // work rows of an item, 64 a consumer
constexpr int kXCols = 64;                     // outputs of an item
constexpr int kXColBlocks = kTW / kXCols;      // 6
constexpr int kXKC = 64;                       // K of a chunk: 128 bytes
constexpr int kXStages = 4;                    // (5 took 1.03x as long)
constexpr int kXConsumers = 2;                 // warpgroups
constexpr int kXThreads = 128 * kXConsumers + 32;   // + the producer warp
constexpr int kATile = kXRows * 128;           // a chunk's work rows
constexpr int kBTile = kXCols * 128;           // a chunk of one coefficient plane
constexpr int kXStage = kATile + 3 * kBTile;
constexpr int kXSmem = kXStages * kXStage + 2 * kXStages * 8 + 1024;
static_assert(kCyTile % 1024 == 0 && kATile % 1024 == 0 && kBTile % 1024 == 0 &&
              kXStage % 1024 == 0, "swizzled tiles 1024-byte aligned");
static_assert(kYChunk * kYCols / 32 == 128, "32 band bytes a thread and chunk");
static_assert(kTH * kYCols / 4 % 128 == 0, "Y skip: whole words a thread");
static_assert(kYChunks % kYAhead == 0 && kCyKBlocks == kYChunks, "chunk c reads K block c");
static_assert(kYSmem <= 232448 && kXSmem <= 232448, "shared memory of one block");

// the first work column of X group `col / 128`'s window (:40)
__host__ __device__ constexpr int x_k0(int col) {
  return 256 * (col / 128) - 128 > 0 ? 256 * (col / 128) - 128 : 0;
}
// the first K step of Y group g's window (:39): min(80 g, 336 - 96) / 16
__host__ __device__ constexpr int y_ks0(int g) {
  return (80 * g < kBH - kYGroupK ? 80 * g : kBH - kYGroupK) / 16;
}
}  // namespace gd

__device__ __forceinline__ int wrap16(int v) {
  return static_cast<int>(static_cast<int16_t>(static_cast<uint16_t>(v)));
}

// out's byte of a wrapped int16 work value in X skip: a * 65280 + b * 256,
// rounded, wrapped and clipped
__device__ __forceinline__ uint32_t xskip_byte(int w) {
  const int b = ((w + 128) & 255) - 128, a = (w - b) >> 8;
  const uint32_t s = static_cast<uint32_t>(a) * 65280u + static_cast<uint32_t>(b) * 256u;
  return static_cast<uint32_t>(min(max(wrap16(static_cast<int>(s + (1u << 19)) >> 20), 0), 255));
}

// float(x) of a byte x, exact, as bf16 bits in the float's high half
__device__ __forceinline__ uint32_t byte_float(uint32_t x) {
  return __float_as_uint(__uint_as_float(0x4B000000u | x) - 8388608.0f);
}

// 4 bytes -> 2 words of bf16x2 (byte 0 in the first word's low half)
__device__ __forceinline__ uint2 widen4(uint32_t v) {
  const uint32_t f0 = byte_float(v & 255), f1 = byte_float((v >> 8) & 255);
  const uint32_t f2 = byte_float((v >> 16) & 255), f3 = byte_float(v >> 24);
  return make_uint2(__byte_perm(f0, f1, 0x7632), __byte_perm(f2, f3, 0x7632));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], uint32_t saddr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(saddr));
}

// The 20 accumulators of an m64n40 wgmma: IQO_ACC20("+f", a) for a float[20]
#define IQO_ACC20(c, a) IQO_ACC8(c, a, 0), IQO_ACC8(c, a, 8), c(a[16]), c(a[17]), c(a[18]), \
                        c(a[19])

// wgmma: D[64 x 160] += A[64 x 16] (registers) x B[16 x 160] (shared, by
// descriptor, K-major), bf16 -> f32.  d[G] holds the n8 tiles 5 G .. 5 G + 4
// (Y group G's 40 output rows), each as an m64n40 wgmma holds them: every
// wgmma names whole arrays, so the compiler never moves a sum in flight
__device__ __forceinline__ void wgmma_n160(float (&d)[4][20], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : IQO_ACC20("+f", d[0]), IQO_ACC20("+f", d[1]), IQO_ACC20("+f", d[2]),
        IQO_ACC20("+f", d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// wgmma: D[64 x 40] += A[64 x 16] x B[16 x 40]: Y group G's 40 output rows
__device__ __forceinline__ void wgmma_n40(float (&d)[20], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19}, {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : IQO_ACC20("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- Y ------------------------------------------------------------------------

// a compile-time int, for the Y kernel's chunk and K-step lambdas
template <int v>
struct Int {
  static constexpr int value = v;
};

// Y group G's wgmma at K step KS, where its window reaches
template <int G, int KS>
__device__ __forceinline__ void y_group(float (&d)[4][20], const uint32_t (&a)[4],
                                        uint32_t cyb) {
  using namespace gd;
  if constexpr (KS >= y_ks0(G) && KS < y_ks0(G) + kYGroupK / 16)
    wgmma_n40(d[G], a, desc_sw128(cyb + (KS / 4) * kCyTile + G * kYGroupRows * 128 +
                                  32 * (KS % 4)));
}

template <int kY, bool kXSkip>
__global__ void __launch_bounds__(gd::kYThreads, 1)
banded_y_kernel(const uint8_t* __restrict__ band, const __nv_bfloat16* __restrict__ cy,
                int16_t* __restrict__ work, uint8_t* __restrict__ out, int tiles) {
  using namespace gd;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // the X launch may start its blocks on SMs this launch leaves: they set up
  // their rings, then wait for this grid to complete before reading a row
  asm volatile("griddepcontrol.launch_dependents;");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wl = warp % 4, wt = tid % 128, g = lane / 4, q = lane % 4;
  uint8_t* cys = align1024(smem_raw);                      // [K block] 160 x 128 bytes
  uint8_t* stages = cys + kCyKBlocks * kCyTile + wg * 2 * kStageBytes;   // this warpgroup's 2
  uint8_t* ost = cys + kCyKBlocks * kCyTile + 4 * kStageBytes + wg * kOutBytes;
  const int cblocks = kXSkip ? kTW / kYCols : kYColBlocks; // X skip needs columns < 384
  const int items = tiles * cblocks;                       // warpgroup items
  const int step = 2 * gridDim.x;          // warpgroup wg of block b: items 2 b + wg, + step ..
  auto wg_sync = [&] { named_sync(1 + wg, 128); };

  // a work value v (wrapped) of output row n, item column m: into the
  // warpgroup's staging (int16, or with X skip the output byte)
  auto stage_value = [&](int n, int m, int v) {
    if constexpr (kXSkip) ost[n * kOutPitch + m] = static_cast<uint8_t>(xskip_byte(v));
    else *reinterpret_cast<int16_t*>(ost + n * kOutPitch + 2 * m) = static_cast<int16_t>(v);
  };
  // the staging out to the work rows (or the output), 16 bytes a store
  auto store_item = [&](int t, int c0) {
    constexpr int kRowBytes = kXSkip ? kYCols : 2 * kYCols;
    for (int e = wt; e < kTH * kRowBytes / 16; e += 128) {
      const int n = e / (kRowBytes / 16), p = e % (kRowBytes / 16);
      const uint4 v = *reinterpret_cast<const uint4*>(ost + n * kOutPitch + 16 * p);
      const long long row = static_cast<long long>(t) * kTH + n;
      if constexpr (kXSkip)
        *reinterpret_cast<uint4*>(out + row * kTW + c0 + 16 * p) = v;
      else
        *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(work + row * kBW + c0) + 16 * p) = v;
    }
  };

  if constexpr (kY == kSkip) {           // w = band[:160] * 37: no dot
    constexpr int kWords = kTH * kYCols / 4 / 128;   // a thread's 4-byte words of an item
    for (int i = 2 * blockIdx.x + wg; i < items; i += step) {
      const int t = i / cblocks, c0 = kYCols * (i % cblocks);
      uint32_t v[kWords];                  // all in flight before the first is used
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        const int e = wt + 128 * u, n = e / (kYCols / 4), m = 4 * (e % (kYCols / 4));
        v[u] = __ldg(reinterpret_cast<const uint32_t*>(
            band + (static_cast<long long>(t) * kBH + n) * kBW + c0 + m));
      }
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        const int e = wt + 128 * u, n = e / (kYCols / 4), m = 4 * (e % (kYCols / 4));
#pragma unroll
        for (int j = 0; j < 4; ++j)
          stage_value(n, m + j, wrap16(((v[u] >> (8 * j)) & 255) * 37));
      }
      wg_sync();
      store_item(t, c0);
      wg_sync();
    }
    return;
  }

  // cy^T, K-major: K block kb holds rows n (160) x 128 bytes of cy[n][64 kb
  // .. 64 kb + 63] (zeros past 336), 16-byte pieces at piece ^ (n & 7); by
  // cp.async, a group a K block, all in flight at once: the first item's
  // chunk c waits for K block c only
  for (int kb = 0; kb < kCyKBlocks; ++kb) {
    for (int i = tid; i < kTH * 8; i += kYThreads) {
      const int n = i / 8, pc = i % 8, k = 64 * kb + 8 * pc;
      uint8_t* dst = cys + kb * kCyTile + n * 128 + ((pc ^ (n & 7)) << 4);
      if (k < kBH) cp_async16(dst, cy + static_cast<long long>(n) * kBH + k);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_commit();
  }

  const int m0 = 16 * wl;                  // the warp's 16 band columns of the item
  const uint32_t cyb = smem_addr(cys), stb = smem_addr(stages);
  // ldmatrix.x4.trans: lane L gives row k = 16 kl + L % 8 + 8 (L / 16) of the
  // stage at column m0 + 8 ((L / 8) & 1): matrix i = L / 8 is A fragment
  // register i of band^T (rows m0 .. m0 + 15, K step kl)
  const uint32_t lm_off =
      (lane % 8 + 8 * (lane / 16)) * kStagePitch + 2 * (m0 + 8 * ((lane / 8) & 1));
  // this thread's 32 band bytes of a chunk (row 64 c + wt / 2, columns
  // 32 (wt % 2) ..), loaded 3 chunks ahead across items: pre[c % 3] holds
  // chunk c until it is staged, then chunk c + 3 (or the next item's c - 3)
  uint4 pre[kYAhead][2];
  auto fetch = [&](int i, int c, uint4 (&v)[2]) {
    const int t = i / cblocks, c0 = kYCols * (i % cblocks), row = kYChunk * c + wt / 2;
    v[0] = v[1] = make_uint4(0u, 0u, 0u, 0u);
    if (i < items && row < kBH) {
      const uint4* src = reinterpret_cast<const uint4*>(
          band + (static_cast<long long>(t) * kBH + row) * kBW + c0 + 32 * (wt % 2));
      v[0] = __ldg(src);
      v[1] = __ldg(src + 1);
    }
  };
  auto stash = [&](int buf, const uint4 (&v)[2]) {   // rows past 336 are zeros
    uint8_t* dst = stages + buf * kStageBytes + (wt / 2) * kStagePitch + 64 * (wt % 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint2 w0 = widen4(v[h].x), w1 = widen4(v[h].y);
      const uint2 w2 = widen4(v[h].z), w3 = widen4(v[h].w);
      *reinterpret_cast<uint4*>(dst + 32 * h) = make_uint4(w0.x, w0.y, w1.x, w1.y);
      *reinterpret_cast<uint4*>(dst + 32 * h + 16) = make_uint4(w2.x, w2.y, w3.x, w3.y);
    }
  };
#pragma unroll
  for (int c = 0; c < kYAhead; ++c) fetch(2 * blockIdx.x + wg, c, pre[c]);

  // every warpgroup has a first item (the grid is at most half the items):
  // in it both warpgroups wait for cy^T's K blocks together
  bool first = true;
  for (int i = 2 * blockIdx.x + wg; i < items; i += step, first = false) {
    const int t = i / cblocks, c0 = kYCols * (i % cblocks);
    float d[4][20];                        // d[j / 5][4 (j % 5) + 2 h + e]: n8 tile j
#pragma unroll
    for (int e = 0; e < 80; ++e) d[e / 20][e % 20] = 0.f;
    uint32_t af[2][4][4];                  // A sets: chunk c, K step kl writes af[c & 1][kl]
    // chunk C, K step KL: compile-time constants (lambdas on Int<>), so that
    // every array index is one and the A sets stay in registers
    auto kload = [&](auto cc, auto kk) {   // K step kl's A fragments of the stage
      constexpr int c = decltype(cc)::value, kl = decltype(kk)::value;
      if constexpr (kl < (kBH - kYChunk * c < kYChunk ? kBH - kYChunk * c : kYChunk) / 16)
        ldmatrix_x4_trans(af[c & 1][kl],   // the sets of chunk c - 2: retired
                          stb + (c & 1) * kStageBytes + 16 * kl * kStagePitch + lm_off);
    };
    auto kstep = [&](auto cc, auto kk) {
      constexpr int c = decltype(cc)::value, kl = decltype(kk)::value, ks = 4 * c + kl;
      if constexpr (kl < (kBH - kYChunk * c < kYChunk ? kBH - kYChunk * c : kYChunk) / 16) {
        const uint32_t (&a)[4] = af[c & 1][kl];
        if constexpr (kY == kMono) {
          wgmma_n160(d, a, desc_sw128(cyb + (ks / 4) * kCyTile + 32 * (ks % 4)));
        } else {
          y_group<0, ks>(d, a, cyb);
          y_group<1, ks>(d, a, cyb);
          y_group<2, ks>(d, a, cyb);
          y_group<3, ks>(d, a, cyb);
        }
      }
    };
    auto chunk = [&](auto cc) {
      constexpr int c = decltype(cc)::value;
      stash(c & 1, pre[c % kYAhead]);
      if constexpr (c + kYAhead < kYChunks) fetch(i, c + kYAhead, pre[c % kYAhead]);
      else fetch(i + step, c + kYAhead - kYChunks, pre[c % kYAhead]);
      if (first) {                         // this thread's copies of cy^T's K block c
        cp_wait<kYChunks - 1 - c>();
        fence_proxy_async();
        __syncthreads();
      } else {
        wg_sync();                         // the stage is written; the other one is free
      }
      kload(cc, Int<0>{});
      kload(cc, Int<1>{});
      kload(cc, Int<2>{});
      kload(cc, Int<3>{});
      wgmma_fence();                       // the chunk's A sets are written
      kstep(cc, Int<0>{});
      kstep(cc, Int<1>{});
      kstep(cc, Int<2>{});
      kstep(cc, Int<3>{});
      wgmma_commit();                      // one group a chunk
      wgmma_wait<1>();                     // chunk c - 1 retired: its A sets are free
      // every A set stays live up to here, so that no register a product in
      // flight reads is reallocated before the wait that retires it
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int kl = 0; kl < 4; ++kl) pin(af[h][kl]);
    };
    static_assert(kYChunks == 6, "the chunks below");
    chunk(Int<0>{});
    chunk(Int<1>{});
    chunk(Int<2>{});
    chunk(Int<3>{});
    chunk(Int<4>{});
    chunk(Int<5>{});
    wgmma_wait<0>();
#pragma unroll
    for (int grp = 0; grp < 4; ++grp) pin(d[grp]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kl = 0; kl < 4; ++kl) pin(af[h][kl]);
    // n8 tile j's d[j / 5][4 (j % 5) + 2 h + e]: band column m0 + g + 8 h of
    // the item, output row 8 j + 2 q + e; each f32 sum an exact integer
#pragma unroll
    for (int j = 0; j < 20; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          stage_value(8 * j + 2 * q + e, m0 + g + 8 * h,
                      wrap16(static_cast<int>(d[j / 5][4 * (j % 5) + 2 * h + e])));
    wg_sync();
    store_item(t, c0);
  }
}

// ---- X ------------------------------------------------------------------------

// D[64 x 64] (+)= A[64 x 16] (registers) x B[16 x 64] (shared, by
// descriptor), bf16 -> f32; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : IQO_ACC8("+f", d, 0), IQO_ACC8("+f", d, 8), IQO_ACC8("+f", d, 16),
        IQO_ACC8("+f", d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
__device__ __forceinline__ uint32_t u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The split of a pair of int16 (x low, y high) into bf16x2 a, b and a + b,
// pair for pair, every step exact (exp_slice_wgmma.cu's split_pair): with
// lb, hb a value's low and high byte, b = int8(lb) = (lb & 127) - 128 bit7(lb)
// and a = int8(hb) + bit7(lb); bf16 0x4300 | m is 128 + m for m < 128, and
// with bit 7 set, 0x4380 is 256; bf16 0x0080 is 2^-126, times 2^126 one.
__device__ __forceinline__ void split_pair(uint32_t v, uint32_t& pa, uint32_t& pb,
                                           uint32_t& ps) {
  const uint32_t h = v >> 8;
  const __nv_bfloat162 b = __hsub2(bf2((v & 0x007F007Fu) | 0x43004300u),
                                   bf2((v & 0x00800080u) | 0x43004300u));
  const __nv_bfloat162 hs = __hsub2(bf2((h & 0x007F007Fu) | 0x43004300u),
                                    bf2((h & 0x00800080u) | 0x43004300u));
  const __nv_bfloat162 a = __hfma2(bf2(v & 0x00800080u), bf2(0x7E807E80u), hs);
  pa = u32(a);
  pb = u32(b);
  ps = u32(__hadd2(a, b));
}

__device__ __forceinline__ uint32_t f2u(float x) {
  return static_cast<uint32_t>(__float2int_rz(x));
}

template <bool kGrouped>
__global__ void __launch_bounds__(gd::kXThreads, 1)
banded_x_kernel(const __grid_constant__ CUtensorMap map_w,
                const __grid_constant__ CUtensorMap map_c0,
                const __grid_constant__ CUtensorMap map_c1,
                const __grid_constant__ CUtensorMap map_c2, uint8_t* __restrict__ out,
                int rows) {
  using namespace gd;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = align1024(smem_raw);                      // [stage] A, then planes 0..2
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kXStages * kXStage);
  uint64_t* empty = full + kXStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pairs = (rows + kXRows - 1) / kXRows, items = kXColBlocks * pairs;
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.x) * items / gridDim.x);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * items / gridDim.x);
  const int chunks = kGrouped ? 384 / kXKC : kBW / kXKC;

  if (tid == 0) {
    for (int s = 0; s < kXStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kXConsumers);   // every consumer thread, once a use
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kXConsumers) {           // the producer warp: one thread issues
    if (lane == 0) {
      // the Y launch (this one's programmatic predecessor) has completed
      // and its work rows are visible; the consumers read only the stages
      asm volatile("griddepcontrol.wait;" ::: "memory");
      const CUtensorMap* mc[3] = {&map_c0, &map_c1, &map_c2};
      int it = 0;
      for (int i = i0; i < i1; ++i) {
        const int cb = i / pairs, mp = i % pairs;
        const int k0 = kGrouped ? x_k0(kXCols * cb) : 0;
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % kXStages;
          uint8_t* st = ring + s * kXStage;
          mbar_wait(&empty[s], ((it / kXStages) & 1) ^ 1);   // its last readers are done
          mbar_expect(&full[s], kXStage);
          tma_2d(st, &map_w, 2 * (k0 + kXKC * c), kXRows * mp, &full[s]);
          for (int p = 0; p < 3; ++p)
            tma_2d(st + kATile + p * kBTile, mc[p], 2 * (k0 + kXKC * c), kXCols * cb, &full[s]);
        }
      }
    }
    return;
  }

  // consumer warpgroup j: warp wl owns work rows 64 j + 16 wl + g and + 8
  // of the item (g = lane / 4); d[p] is plane p's m64n64 sum in wgmma's
  // fragment layout (n8 tile n: d[p][4 n + 2 h + e] is row 16 wl + g + 8 h,
  // column 8 n + 2 q + e)
  const int j = warp / 4, wl = warp % 4, g = lane / 4, q = lane % 4;
  const int off0 = (64 * j + 16 * wl + g) * 128 + 4 * q, off1 = off0 + 8 * 128;
  const uint32_t ring_addr = smem_addr(ring);
  int it = 0;
  for (int i = i0; i < i1; ++i) {
    const int cb = i / pairs, mp = i % pairs;
    float d[3][32];
    uint32_t af[2][3][4];                  // two A sets: K step kk writes set kk & 1
    for (int c = 0; c < chunks; ++c, ++it) {
      const int s = it % kXStages;
      mbar_wait(&full[s], (it / kXStages) & 1);
      const uint8_t* st = ring + s * kXStage;
      uint32_t wv[4][4];                   // [K step][row g pair k 2q, row g + 8, k 2q + 8 ...]
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int p0 = ((2 * kk) ^ g) << 4, p1 = ((2 * kk + 1) ^ g) << 4;
        wv[kk][0] = *reinterpret_cast<const uint32_t*>(st + off0 + p0);
        wv[kk][1] = *reinterpret_cast<const uint32_t*>(st + off1 + p0);
        wv[kk][2] = *reinterpret_cast<const uint32_t*>(st + off0 + p1);
        wv[kk][3] = *reinterpret_cast<const uint32_t*>(st + off1 + p1);
      }
      const uint32_t btile = ring_addr + s * kXStage + kATile;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t (&a)[3][4] = af[kk & 1];  // the set K step kk - 2 read: retired
#pragma unroll
        for (int e = 0; e < 4; ++e) split_pair(wv[kk][e], a[0][e], a[1][e], a[2][e]);
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < 3; ++p)
          wgmma_m64n64(d[p], a[p], desc_sw128(btile + p * kBTile + 32 * kk), (c | kk) != 0);
        wgmma_commit();
#pragma unroll
        for (int p = 0; p < 3; ++p) pin(a[p]);
        wgmma_wait<1>();                   // K step kk - 1 retired: its A set is free
        if (kk == 0 && c > 0) mbar_arrive(&empty[(it - 1) % kXStages]);   // chunk c - 1 is read
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < 3; ++p) pin(d[p]);
    mbar_arrive(&empty[(it - 1) % kXStages]);

    // each plane's sums truncated (exact integers), met in uint32, rounded,
    // wrapped (a no-op on (s + 2^19) >> 20 of an int32) and clipped to u8
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = kXRows * mp + 64 * j + 16 * wl + g + 8 * h;
      // pk[n]: the u8 of n8 tiles 2 n and 2 n + 1; the quad's four lanes
      // trade them so that lane q holds columns 16 q .. 16 q + 15 of the row
      // (pk of lane q' at index q) and stores them as one 16-byte word
      uint32_t pk[4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t u[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * (2 * n + e / 2) + 2 * h + e % 2;
          const uint32_t sv = f2u(d[0][idx]) * 65280u - f2u(d[1][idx]) * 255u +
                              f2u(d[2][idx]) * 256u;
          u[e] = static_cast<uint32_t>(
              min(max(wrap16(static_cast<int>(sv + (1u << 19)) >> 20), 0), 255));
        }
        pk[n] = u[0] | u[1] << 8 | u[2] << 16 | u[3] << 24;
      }
      auto pick = [&](int n) {
        return n == 0 ? pk[0] : n == 1 ? pk[1] : n == 2 ? pk[2] : pk[3];
      };
      uint32_t r[4];                       // r[q']: lane q''s pk[q], by selects (no local memory)
#pragma unroll
      for (int n = 0; n < 4; ++n) r[n] = n == q ? pk[n] : 0u;
#pragma unroll
      for (int k = 1; k < 4; ++k) {        // lane q + k (mod 4) of the quad sends its pk[q]
        const uint32_t got =
            __shfl_sync(0xffffffffu, pick((q - k) & 3), (lane & ~3) | ((q + k) & 3));
#pragma unroll
        for (int n = 0; n < 4; ++n) r[n] = n == ((q + k) & 3) ? got : r[n];
      }
      if (row < rows)
        *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * kTW + kXCols * cb + 16 * q) =
            make_uint4(__byte_perm(r[0], r[1], 0x5410), __byte_perm(r[2], r[3], 0x5410),
                       __byte_perm(r[0], r[1], 0x7632), __byte_perm(r[2], r[3], 0x7632));
    }
  }
}

template <int kY, bool kXSkip>
int y_setup() {
  return static_cast<int>(cudaFuncSetAttribute(
      banded_y_kernel<kY, kXSkip>, cudaFuncAttributeMaxDynamicSharedMemorySize, gd::kYSmem));
}

template <int kY, bool kXSkip>
void y_launch(int ctas, const void* band, const void* cy, void* work, void* out, int tiles,
              cudaStream_t s) {
  banded_y_kernel<kY, kXSkip><<<ctas, gd::kYThreads, gd::kYSmem, s>>>(
      static_cast<const uint8_t*>(band), static_cast<const __nv_bfloat16*>(cy),
      static_cast<int16_t*>(work), static_cast<uint8_t*>(out), tiles);
}

}  // namespace

extern "C" {

// Raise the Y and X kernels' dynamic shared-memory limits on the current
// device; call once per device before their first launch.
int iqo_exp_banded_wgmma_setup() {
  using namespace gd;
  int rc = 0;
#define IQO_Y(Y) if (!rc) rc = y_setup<Y, false>(); if (!rc) rc = y_setup<Y, true>();
  IQO_Y(kMono) IQO_Y(kGrouped) IQO_Y(kSkip)
#undef IQO_Y
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      banded_x_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kXSmem));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      banded_x_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kXSmem));
  return rc;
}

// The geometry the kernels were built with, for the host's model: Y threads,
// item columns, chunk rows, chunks, shared bytes; X item rows, item
// columns, K chunk, stages, threads, stage bytes, shared bytes.
int iqo_exp_banded_wgmma_shape(int* shape) {
  using namespace gd;
  const int v[12] = {kYThreads, kYCols, kYChunk, kYChunks, kYSmem, kXRows,
                     kXCols,    kXKC,   kXStages, kXThreads, kXStage, kXSmem};
  for (int i = 0; i < 12; ++i) shape[i] = v[i];
  return 0;
}

// Kernel D, wgmma form: band (tiles, 336, 896) u8, cy (160, 336) bf16, cxt0..2
// (384, 896) bf16 (K-major) -> out (tiles, 160, 384) u8, through work
// (tiles x 160, 896) int16 unless X skips; y_ctas blocks (at most half the
// Y items) stride over the Y items by warpgroup, x_ctas take contiguous runs
// of the X items.
int iqo_exp_banded_wgmma(int ymode, int xmode, const void* band, const void* cy,
                         const void* cxt0, const void* cxt1, const void* cxt2, void* work,
                         void* out, int tiles, int y_ctas, int x_ctas, void* stream) {
  using namespace gd;
  if (ymode < 0 || ymode > 2 || xmode < 0 || xmode > 2) return 1006;
  if (tiles < 1 || y_ctas < 1 || (xmode != kSkip && x_ctas < 1)) return 1008;
  const bool xskip = xmode == kSkip;
  if ((reinterpret_cast<uintptr_t>(band) | reinterpret_cast<uintptr_t>(cy) |
       reinterpret_cast<uintptr_t>(cxt0) | reinterpret_cast<uintptr_t>(cxt1) |
       reinterpret_cast<uintptr_t>(cxt2) | reinterpret_cast<uintptr_t>(out) |
       (xskip ? 0 : reinterpret_cast<uintptr_t>(work))) % 16)
    return 1002;
  const long long rows = static_cast<long long>(tiles) * kTH;
  const int x_items = kXColBlocks * static_cast<int>((rows + kXRows - 1) / kXRows);
  if (2 * y_ctas > tiles * (xskip ? kTW / kYCols : kYColBlocks) ||
      (!xskip && x_ctas > x_items))
    return 1008;
  CUtensorMap mw, mc[3];
  if (!xskip) {                            // all as bytes: rows of 1,792, boxes of 128 bytes
    int rc = encode_sw128(&mw, work, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2LL * kBW, rows, kXRows);
    const void* cxt[3] = {cxt0, cxt1, cxt2};
    for (int p = 0; p < 3 && !rc; ++p)
      rc = encode_sw128(&mc[p], cxt[p], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2LL * kBW, kTW, kXCols);
    if (rc) return rc;
  }
  auto s = static_cast<cudaStream_t>(stream);
#define IQO_Y(Y)                                                              \
  if (ymode == Y) {                                                           \
    if (xskip) y_launch<Y, true>(y_ctas, band, cy, work, out, tiles, s);      \
    else y_launch<Y, false>(y_ctas, band, cy, work, out, tiles, s);           \
  }
  IQO_Y(kMono) IQO_Y(kGrouped) IQO_Y(kSkip)
#undef IQO_Y
  int rc = static_cast<int>(cudaGetLastError());
  if (rc || xskip) return rc;
  // X as the Y launch's programmatic dependent: its blocks may start while
  // Y's last blocks run, and wait (griddepcontrol.wait) before their first
  // read of the work rows
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(x_ctas);
  cfg.blockDim = dim3(kXThreads);
  cfg.dynamicSmemBytes = kXSmem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto o = static_cast<uint8_t*>(out);
  const int r = static_cast<int>(rows);
  if (xmode == kMono)
    rc = static_cast<int>(
        cudaLaunchKernelEx(&cfg, banded_x_kernel<false>, mw, mc[0], mc[1], mc[2], o, r));
  else
    rc = static_cast<int>(
        cudaLaunchKernelEx(&cfg, banded_x_kernel<true>, mw, mc[0], mc[1], mc[2], o, r));
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

}  // extern "C"
