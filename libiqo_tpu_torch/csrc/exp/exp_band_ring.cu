// Kernels E and G redesigned for Hopper (sm_90a), the "ring" forms:
// band_ring<Form, kWords> and overlap_ring<kBlocked>, the same functions as
// exp_band.cu's band_ydot<Form, kWords> and overlap_kernel<V> (kept, the
// "sync" forms), bit for bit:
//   E: out[32 t + i, j] = sum_k C (32, 96)[i, k] * int8(src[64 t + k, j] ^ 0x80)
//      in every form of exp_band.cu (base, arb, grid3, clamp, u8out, streams,
//      vmem, and the word form's permuted output);
//   G: out[96 t + i, j] = (sum_{i' < P} C (96, 128) @ int8(window_t[8 i' :
//      8 i' + 128, j]))[i] & 255, or window_t[i, j] at P = 0, the window of
//      208 rows at max(0, min(clamp_hi, 192 t)) (elem, elem-b2 and parallel
//      all compute it) or of 192 rows at 192 t, rows past the plane zero
//      (blocked).
// Replaces the TPU kernels of scripts/exp_band_shape.py: build
// (pl.pallas_call at :65, :124, :147), scripts/exp_i32_band.py: build_u8
// (:65) and build_i32 (:94), and scripts/exp_overlap.py: build (:82).  The
// Python side is libiqo_tpu_torch/experiments/exp_band_shape.py,
// exp_overlap.py (impl "ring", the default) and band_ring.py (the geometry,
// walk, ring and a NumPy model of this file).
//
// What bounds them on the H100: E bytes (8.23 MB of rows in, 16.22 MB of
// i32 out: 7.3 us at 3.35 TB/s; u8 out 3.7 us); G at P = 8 operations (2.26 G
// multiply-adds, 2.3 us at the int8 peak).  The sync forms lost to one
// torch._int_mm over the same windows (E 1.7-16.4x, G 5.5-5.9x): the TPU's
// sequential grid became one block per column chunk (30 or 15 blocks on 132
// SMs), and every window was fetched by synchronous loads before a barrier.
// What this design does about it:
// * A persistent grid of one block an SM walks the items of the work in
//   order: item (frame, chunk, tile) for E, 990 at full size; (chunk, tile,
//   64-column side) for G, 360, so that 132 blocks carry runs of 2 or 3 and
//   not of 1 or 2.  Block b takes the run [b N / grid, (b + 1) N /
//   grid), which walks the row tiles of a column chunk in order: the TPU's
//   sequential grid ("arbitrary") and its parallel one are the same schedule
//   here, and the forms differ only in their ingredients (template flags).
// * A producer warp keeps the windows in flight by TMA, one box a window
//   (96 rows x 128 bytes for E, 208 or 192 for G, 128-byte swizzled) into a
//   ring of window stages (8 for E, 4 for G), each with a full and an empty
//   mbarrier: a block's whole run (at most 8 windows for E, 2 for G) is in
//   flight from its start.  Windows overlap (E by 32 of 96 rows, G by 16 of
//   208, by 176 where the clamp binds) and are fetched whole: the rows shared
//   with the previous window come again, mostly from L2 (issued bytes 1.48x
//   the rows for E, 1.33x for G).  Items that share a window (G's two sides
//   of a tile, tiles whose clamped windows coincide) share its stage.  Rows
//   past the plane arrive as zeros (TMA's out-of-bounds fill): G blocked's
//   last block.  Drafts that loaded each row once per run were no faster:
//   16-row boxes (2 KB) fetched slower, from L2 as from memory, and 64-row
//   boxes with a third fewer bytes took the same time as whole windows.
// * The eight consumer warps take the items of the run in turn: E in two
//   groups of four warps, G in four groups of two, each warp 32 columns of
//   the item (G: all 96 output rows of them, so that each B fragment feeds
//   six m-tiles; 48 rows a warp, a first draft, paid twice the fragment
//   loads and transposes for the same dots).  Every consumer thread waits
//   for each window once and arrives on its empty barrier once, after the
//   last item that reads it, whether or not its group computed that item, so
//   each barrier's arrivals match its waits for every run length the walk
//   produces.
// * The dots stay mma.sync m16n8k32 s8 -> s32 (8-bit wgmma reads only
//   K-major operands from shared memory, and the band is row-major).  A lane
//   reads one 32-bit word (four columns) of each of four rows and transposes
//   the bytes (__byte_perm) into the B fragments of four n-tiles, as
//   exp_band.cu.  Under TMA's swizzle (piece ^ (row & 7)) the rows of a K
//   step are permuted: mma k index k = 16 h + 4 q + j reads window row
//   16 h + 8 (j >> 1) + 2 q + (j & 1), so the four q of one load sit 2 rows
//   apart and hit 32 distinct banks; C sits in shared memory with the same
//   permutation of its columns, so the sums are unchanged.
// * Outputs go straight from the accumulators as 16-byte (i32) or 8-byte
//   (u8) stores, which do not hold the warps.  Which word column a lane's
//   B fragment takes for each mma n index is free (word_col): for i32 rows
//   the four lanes of a quad then hold 16 adjacent columns, so each store
//   writes whole 32-byte sectors (64 bytes a quad), where the first mapping
//   wrote every other 16 bytes and its stores took most of the time.  The
//   streamed
//   operands of streams/vmem are read per item (rows) and per chunk
//   (columns); vmem's 4.5 MB slab copy is shared out over the blocks, each
//   copying its share after its last item (a little faster, in turns, than
//   before its first).
// What holds them back (libiqo_tpu_torch/tools/band_ablate.py): for E the
// launch and the fetch pipeline alone (no item bodies) take most of the time,
// and did not shrink with fewer bytes; for G at P = 8 the fragment loads and
// transposes, then the dots.

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

namespace rg {
constexpr int kChunk = 128;                // source columns of an item: a 128-byte box row
constexpr int kConsumers = 256;            // 8 consumer warps
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kGroupsE = 2, kGroupsG = 4;  // item i of a run to group i % groups: E 4 warps
                                           // an item, G 2
constexpr int kTH = 32, kStep = 64, kBand = 96;                       // kernel E
constexpr int kEPitch = kBand + 16;        // C's pitch in shared memory: A loads hit 32 banks
constexpr int kOTH = 96, kOStep = 192, kOBand = 208, kKD = 128;   // kernel G
constexpr int kOPitch = kKD + 16;
constexpr int kOpCols = 1920, kSlabCols = 128;
constexpr int kStagesE = 8, kStagesG = 4;  // windows in flight
constexpr int kStageE = kBand * kChunk, kStageG = kOBand * kChunk;   // a window's bytes
constexpr int kSmemE = kStagesE * kStageE + 2 * kStagesE * 8 + kTH * kEPitch + 1024;   // + slack
constexpr int kSmemG = kStagesG * kStageG + 2 * kStagesG * 8 + kOTH * kOPitch + 1024;
static_assert(kStageE % 1024 == 0 && kStageG % 1024 == 0,
              "stages 1024-byte aligned for the 128-byte swizzle");
static_assert(kStagesE >= kGroupsE && kStagesG >= kGroupsG, "each group a window in flight");
}  // namespace rg

enum Form { kBase = 0, kArb = 1, kGrid3 = 2, kClamp = 3, kU8Out = 4, kStreams = 5, kVmem = 6 };

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

// Byte (row wr, column c) of a window staged at `w`: TMA's 128-byte swizzle
// puts 16-byte piece c / 16 of a row at piece ^ (row & 7).
__device__ __forceinline__ const uint8_t* at(const uint8_t* w, int wr, int c) {
  return w + wr * rg::kChunk + ((((c >> 4) ^ (wr & 7))) << 4) + (c & 15);
}

// Lane constants of the fragment loads: the byte offsets, inside an 8-row
// block of a window, of rows 2 q and 2 q + 1 at chunk column col.  The
// 8-row blocks start at multiples of 8, so TMA's swizzle phase (row & 7) of
// a lane's row is 2 q + e wherever the block lies.
struct LaneRows {
  int off[2];
  __device__ __forceinline__ LaneRows(int q, int col) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 2 * q + e;
      off[e] = r * rg::kChunk + (((col >> 4) ^ r) << 4) + (col & 15);
    }
  }
};

// The B fragments of K step rows kb .. kb + 31 (kb % 8 == 0) of the window
// staged at w for the four n-tiles of a lane: b[h][p] holds, in mma k order,
// rows kb + 8 (2 h + (j >> 1)) + 2 q + (j & 1) (j = 0 .. 3), the permuted k
// = 16 h + 4 q + j, of chunk column col + p.  kFlip rebases u8 to s8 (^ 0x80).
template <bool kFlip>
__device__ __forceinline__ void b_frags(const uint8_t* w, int kb, const LaneRows& lr,
                                        uint32_t (&b)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t v[4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const uint8_t* blk = w + (kb + 16 * h + 8 * m) * rg::kChunk;   // an 8-row block
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[2 * m + e] = *reinterpret_cast<const uint32_t*>(blk + lr.off[e]);
        if constexpr (kFlip) v[2 * m + e] ^= 0x80808080u;
      }
    }
    transpose4(v, b[h]);
  }
}

// C (rows, k) s8 into shared memory at `pitch`, the columns of each 32-wide
// K step permuted as the rows: column 32 s + 16 h + 4 q + j holds C's column
// 32 s + 16 h + 8 (j >> 1) + 2 q + (j & 1), so that an A fragment's word is
// one 4-byte load.  Each 16 columns are a byte permutation of themselves:
// word q of 16 h .. 16 h + 15 takes bytes 2 q, 2 q + 1, 2 q + 8, 2 q + 9.
// Consumer threads only.
__device__ __forceinline__ void load_coef(uint8_t* cs, const uint8_t* coef, int rows, int k,
                                          int pitch) {
  for (int e = threadIdx.x; e < rows * k / 16; e += rg::kConsumers) {
    const int r = e / (k / 16), c = 16 * (e % (k / 16));
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(coef + r * k + c));
    *reinterpret_cast<uint4*>(cs + r * pitch + c) =
        make_uint4(__byte_perm(v.x, v.z, 0x5410), __byte_perm(v.x, v.z, 0x7632),
                   __byte_perm(v.y, v.w, 0x5410), __byte_perm(v.y, v.w, 0x7632));
  }
}

// ---- the walk: one producer, two consumer groups ----------------------------
//
// A block's run is the items [i0, i1); key(i) names item i's window (its
// group and first row), and consecutive items with one key share one load.
// Window n of the run sits in stage n % stages.

// The producer (one thread): each window of the run once, in order, into the
// next stage, after the stage's last readers released it.
template <class Key, class Load>
__device__ __forceinline__ void produce(int i0, int i1, int stages, uint32_t bytes, Key key,
                                        Load load, uint64_t* full, uint64_t* empty) {
  for (int i = i0, n = 0; i < i1; ++i) {
    if (i > i0 && key(i) == key(i - 1)) continue;      // the item before loaded it
    const int s = n % stages;
    mbar_wait(&empty[s], ((n / stages) & 1) ^ 1);
    mbar_expect(&full[s], bytes);
    load(i, s, &full[s]);
    ++n;
  }
}

// A consumer thread of group `group` (of `groups`): waits for each window of
// its run once, computes the items i with (i - i0) % groups == group, and
// releases each window once, after the last item that reads it.
template <class Key, class Body>
__device__ __forceinline__ void consume(int i0, int i1, int stages, int groups, int group,
                                        Key key, Body body, uint64_t* full, uint64_t* empty) {
  for (int i = i0, n = -1; i < i1; ++i) {
    if (i == i0 || key(i) != key(i - 1)) {
      ++n;
      mbar_wait(&full[n % stages], (n / stages) & 1);
    }
    if ((i - i0) % groups == group) body(i, n % stages);
    if (i + 1 == i1 || key(i + 1) != key(i)) mbar_arrive(&empty[n % stages]);
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], rg::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// ---- kernel E -------------------------------------------------------------

struct YdotRingArgs {
  const uint8_t* coef;        // (32, 96) s8, row-major
  void* out;                  // (frames, 32 n_t, w) i32 or u8
  int frames, h, w, n_t, clamp_hi;
  const int32_t* rows[3];     // (32 n_t, 1) i32 each (streams, vmem)
  const int32_t* cols[3];     // (1, 1920) i32 each (streams, vmem)
  const uint4* slab;          // (36864, 128) s8 (vmem)
  uint4* scratch;             // the slab's copy (vmem)
  long long slab_pieces;      // slab bytes / 16
};

// Whether form kForm stores i32 rows: their accumulators are laid out so
// that the four lanes of a quad store 64 contiguous bytes of a row at once.
template <int kForm, bool kWords>
__host__ __device__ constexpr bool wide_rows() {
  return !kWords && kForm != kU8Out && kForm != kStreams;
}

// The word column (four chunk columns) whose B fragment a lane loads for
// mma n index n, and so the columns its sums land in: n -> 8 wl + n packs a
// lane's two n (2 q, 2 q + 1) into 32 contiguous bytes of u8 or word output
// (a quad: 32 bytes of u8, 32 of words); wide_rows: n -> 8 wl + 4 (n & 1) +
// (n >> 1) puts a quad's n = 2 q + ec side by side, 64 bytes of i32 for each
// ec.
template <bool kWide>
__host__ __device__ constexpr int word_col(int wl, int n) {
  return kWide ? 8 * wl + 4 * (n & 1) + (n >> 1) : 8 * wl + n;
}

// Item (frame, chunk, t): this warp's 32 columns of the 32 output rows.
template <int kForm, bool kWords>
__device__ __forceinline__ void ydot_item(const YdotRingArgs& a, const uint8_t* win,
                                          const uint32_t (&af)[2][3][4],
                                          const uint32_t (&colv)[8], int frame, int chunk,
                                          int t) {
  using namespace rg;
  constexpr bool kWide = wide_rows<kForm, kWords>();
  const int lane = threadIdx.x % 32, wl = (threadIdx.x / 32) % 4, g = lane / 4, q = lane % 4;
  const LaneRows lr(q, 4 * word_col<kWide>(wl, g));
  int acc[2][4][4] = {};
#pragma unroll
  for (int ks = 0; ks < kBand / 32; ++ks) {
    uint32_t b[2][4];
    b_frags<true>(win, 32 * ks, lr, b);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int p = 0; p < 4; ++p) mma_s8(acc[mt][p], af[mt][ks], b[0][p], b[1][p]);
  }
  const int chunk0 = chunk * kChunk, row0 = (frame * a.n_t + t) * kTH;
  // acc[mt][p][2 rh + ec]: row 16 mt + g + 8 rh, chunk column
  // 4 word_col(wl, 2 q + ec) + p: 32 wl + 8 q + 4 ec + p (kWords: plane p,
  // word column 8 wl + 2 q + ec), or 32 wl + 16 ec + 4 q + p (kWide)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = 16 * mt + g + 8 * rh;
      const long long orow = static_cast<long long>(row0 + row) * a.w;
      if constexpr (kWords) {
        int32_t* o = static_cast<int32_t*>(a.out) + orow + chunk0 / 4 + 8 * wl + 2 * q;
#pragma unroll
        for (int p = 0; p < 4; ++p)
          *reinterpret_cast<int2*>(o + p * (a.w / 4)) =
              make_int2(acc[mt][p][2 * rh], acc[mt][p][2 * rh + 1]);
      } else {
        uint32_t rowv = 0;
        if constexpr (kForm >= kStreams)
          rowv = static_cast<uint32_t>(__ldg(a.rows[0] + t * kTH + row)) +
                 static_cast<uint32_t>(__ldg(a.rows[1] + t * kTH + row)) +
                 static_cast<uint32_t>(__ldg(a.rows[2] + t * kTH + row));
        uint32_t v[8];
#pragma unroll
        for (int ec = 0; ec < 2; ++ec)
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            v[4 * ec + p] = static_cast<uint32_t>(acc[mt][p][2 * rh + ec]);
            if constexpr (kForm >= kStreams) v[4 * ec + p] += rowv + colv[4 * ec + p];
            if constexpr (kForm >= kU8Out) v[4 * ec + p] &= 255u;
          }
        if constexpr (kWide) {
          int32_t* o = static_cast<int32_t*>(a.out) + orow + chunk0 + 32 * wl + 4 * q;
          *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
          *reinterpret_cast<int4*>(o + 16) = make_int4(v[4], v[5], v[6], v[7]);
        } else {
          uint8_t* o = static_cast<uint8_t*>(a.out) + orow + chunk0 + 32 * wl + 8 * q;
          *reinterpret_cast<uint2*>(o) =
              make_uint2(v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24,
                         v[4] | v[5] << 8 | v[6] << 16 | v[7] << 24);
        }
      }
    }
}

template <int kForm, bool kWords>
__global__ void __launch_bounds__(rg::kThreads, 1)
band_ring_kernel(const __grid_constant__ CUtensorMap map, const YdotRingArgs a) {
  using namespace rg;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* stage = align1024(smem_raw);                          // [stage] 96 x 128 bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + kStagesE * kStageE);
  uint64_t* empty = full + kStagesE;
  uint8_t* cs = reinterpret_cast<uint8_t*>(empty + kStagesE);   // C, (32, 112) permuted
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int chunks = a.w / kChunk, items = a.frames * chunks * a.n_t;
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.x) * items / gridDim.x);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * items / gridDim.x);
  init_barriers(full, empty, kStagesE);
  // item i = (frame, chunk, t): group i / n_t is frame * chunks + chunk;
  // tile t's window is 96 rows at 64 t (the clamp forms clamp to h - 96,
  // which never binds for t < n_t): every item its own window
  auto off = [&](int i) {
    const int t = i % a.n_t;
    return kForm >= kClamp ? min(a.clamp_hi, kStep * t) : kStep * t;
  };
  auto key = [](int i) { return i; };

  if (warp == kConsumers / 32) {             // the producer warp: one thread issues
    if (lane == 0) {
      const CUtensorMap* m = &map;
      produce(i0, i1, kStagesE, kStageE, key,
              [&](int i, int s, uint64_t* bar) {
                const int grp = i / a.n_t;
                tma_2d(stage + s * kStageE, m, (grp % chunks) * kChunk,
                       (grp / chunks) * a.h + off(i), bar);
              },
              full, empty);
    }
    return;
  }

  load_coef(cs, a.coef, kTH, kBand, kEPitch);
  named_sync(1, kConsumers);
  const int g = lane / 4, q = lane % 4, wl = warp % 4;
  // the A fragments of C, once: rows 16 mt + g (+8), k 32 ks + 4 q (+16)
  uint32_t af[2][3][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < 3; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        af[mt][ks][i] = *reinterpret_cast<const uint32_t*>(
            cs + (16 * mt + g + 8 * (i & 1)) * kEPitch + 32 * ks + 16 * (i >> 1) + 4 * q);
  uint32_t colv[8] = {};                     // streams/vmem: the column operands of a chunk
  int chunk_of_colv = -1;
  consume(i0, i1, kStagesE, kGroupsE, warp / 4, key,
          [&](int i, int s) {
            const int grp = i / a.n_t, chunk = grp % chunks;
            if constexpr (kForm >= kStreams) {
              if (chunk != chunk_of_colv) {
                chunk_of_colv = chunk;
                constexpr bool kWide = wide_rows<kForm, kWords>();
#pragma unroll
                for (int e = 0; e < 8; ++e) {   // v[e] of ydot_item: ec = e / 4, p = e % 4
                  const int j = chunk * kChunk + 4 * word_col<kWide>(wl, 2 * q + e / 4) + e % 4;
                  uint32_t v = static_cast<uint32_t>(__ldg(a.cols[0] + j % kOpCols)) +
                               static_cast<uint32_t>(__ldg(a.cols[1] + j % kOpCols)) +
                               static_cast<uint32_t>(__ldg(a.cols[2] + j % kOpCols));
                  if constexpr (kForm == kVmem)
                    v += static_cast<uint32_t>(static_cast<int>(
                        reinterpret_cast<const int8_t*>(a.slab)[j % kSlabCols]));
                  colv[e] = v;
                }
              }
            }
            ydot_item<kForm, kWords>(a, stage + s * kStageE, af, colv, grp / chunks, chunk,
                                     i % a.n_t);
          },
          full, empty);
  if constexpr (kForm == kVmem) {            // this block's share of the slab copy
    const long long b0 = blockIdx.x * a.slab_pieces / gridDim.x;
    const long long b1 = (blockIdx.x + 1) * a.slab_pieces / gridDim.x;
    constexpr int kIn = 12;                  // loads a thread issues before its stores: a
                                             // share of 4.5 MB / 132 blocks in one round
    for (long long i = b0 + tid; i < b1; i += kIn * kConsumers) {
      uint4 v[kIn];
#pragma unroll
      for (int k = 0; k < kIn; ++k)
        if (i + k * kConsumers < b1) v[k] = __ldg(a.slab + i + k * kConsumers);
#pragma unroll
      for (int k = 0; k < kIn; ++k)
        if (i + k * kConsumers < b1) a.scratch[i + k * kConsumers] = v[k];
    }
  }
}

// ---- kernel G -------------------------------------------------------------

struct OverlapRingArgs {
  const uint8_t* coef;        // (96, 128) s8, row-major
  uint8_t* out;               // (96 n_ty, nd) u8
  int h, nd, n_ty, clamp_hi, p;
};

// Item (chunk, t, side): this warp's 32 columns (32 wl of the side's 64) of
// the 96 output rows of tile t.
__device__ __forceinline__ void overlap_item(const OverlapRingArgs& a, const uint8_t* win,
                                             const uint8_t* cs, int chunk, int t, int side) {
  using namespace rg;
  const int tid = threadIdx.x % 64, lane = tid % 32, wl = tid / 32, g = lane / 4, q = lane % 4;
  const int col0 = 64 * side;               // the item's first chunk column
  uint8_t* out = a.out + static_cast<long long>(kOTH * t) * a.nd + chunk * kChunk + col0;
  if (a.p == 0) {                            // window rows 0 .. 95, the side's 64 columns
    for (int e = tid; e < kOTH * 4; e += 64) {
      const int r = e / 4, c = 16 * (e % 4);
      *reinterpret_cast<uint4*>(out + static_cast<long long>(r) * a.nd + c) =
          *reinterpret_cast<const uint4*>(at(win, r, col0 + c));
    }
    return;
  }
  const LaneRows lr(q, col0 + 32 * wl + 4 * g);
  int acc[6][4][4] = {};
  for (int ks = 0; ks < kKD / 32; ++ks) {
    uint32_t af[6][4];
#pragma unroll
    for (int mt = 0; mt < 6; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        af[mt][i] = *reinterpret_cast<const uint32_t*>(
            cs + (16 * mt + g + 8 * (i & 1)) * kOPitch + 32 * ks + 16 * (i >> 1) + 4 * q);
#pragma unroll 2
    for (int i = 0; i < a.p; ++i) {
      uint32_t b[2][4];
      b_frags<false>(win, 8 * i + 32 * ks, lr, b);
#pragma unroll
      for (int mt = 0; mt < 6; ++mt)
#pragma unroll
        for (int p = 0; p < 4; ++p) mma_s8(acc[mt][p], af[mt], b[0][p], b[1][p]);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 6; ++mt)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      uint32_t v[8];
#pragma unroll
      for (int ec = 0; ec < 2; ++ec)
#pragma unroll
        for (int p = 0; p < 4; ++p)
          v[4 * ec + p] = static_cast<uint32_t>(acc[mt][p][2 * rh + ec]) & 255u;
      *reinterpret_cast<uint2*>(out + static_cast<long long>(16 * mt + g + 8 * rh) * a.nd +
                                32 * wl + 8 * q) =
          make_uint2(v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24,
                     v[4] | v[5] << 8 | v[6] << 16 | v[7] << 24);
    }
}

template <bool kBlocked>
__global__ void __launch_bounds__(rg::kThreads, 1)
overlap_ring_kernel(const __grid_constant__ CUtensorMap map, const OverlapRingArgs a) {
  using namespace rg;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* stage = align1024(smem_raw);                          // [stage] 208 x 128 bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(stage + kStagesG * kStageG);
  uint64_t* empty = full + kStagesG;
  uint8_t* cs = reinterpret_cast<uint8_t*>(empty + kStagesG);   // C, (96, 144) permuted
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int per_group = 2 * a.n_ty, items = a.nd / kChunk * per_group;
  const int i0 = static_cast<int>(static_cast<long long>(blockIdx.x) * items / gridDim.x);
  const int i1 = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * items / gridDim.x);
  init_barriers(full, empty, kStagesG);
  // item i = (chunk, t, side), chunk = i / per_group, the side's 64 columns;
  // tile t's window: 192 rows at 192 t (blocked), else 208 rows at
  // max(0, min(clamp_hi, 192 t)), shared by both sides and by tiles whose
  // clamped windows coincide
  auto off = [&](int i) {
    const int t = (i % per_group) / 2;
    return kBlocked ? kOStep * t : max(0, min(a.clamp_hi, kOStep * t));
  };
  auto key = [&](int i) { return (i / per_group) * (a.h + kOStep * a.n_ty) + off(i); };

  if (warp == kConsumers / 32) {
    if (lane == 0) {
      const CUtensorMap* m = &map;
      produce(i0, i1, kStagesG, (kBlocked ? kOStep : kOBand) * kChunk, key,
              [&](int i, int s, uint64_t* bar) {
                tma_2d(stage + s * kStageG, m, i / per_group * kChunk, off(i), bar);
              },
              full, empty);
    }
    return;
  }

  load_coef(cs, a.coef, kOTH, kKD, kOPitch);
  named_sync(1, kConsumers);
  consume(i0, i1, kStagesG, kGroupsG, warp / 2, key,
          [&](int i, int s) {
            overlap_item(a, stage + s * kStageG, cs, i / per_group, (i % per_group) / 2, i % 2);
          },
          full, empty);
}

// ---- host -----------------------------------------------------------------

template <class K>
int allow_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int kForm, bool kWords>
int launch_ydot_ring(const CUtensorMap& map, const YdotRingArgs& a, int ctas, cudaStream_t s) {
  band_ring_kernel<kForm, kWords><<<ctas, rg::kThreads, rg::kSmemE, s>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

bool misaligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes != 0; }

}  // namespace

extern "C" {

// Raise every ring instantiation's dynamic shared-memory limit on the
// current device; call once per device before their first launch.
int iqo_exp_band_ring_setup() {
  using namespace rg;
  int rc = allow_smem(band_ring_kernel<kBase, false>, kSmemE);
  if (!rc) rc = allow_smem(band_ring_kernel<kArb, false>, kSmemE);
  if (!rc) rc = allow_smem(band_ring_kernel<kGrid3, false>, kSmemE);
  if (!rc) rc = allow_smem(band_ring_kernel<kClamp, false>, kSmemE);
  if (!rc) rc = allow_smem(band_ring_kernel<kU8Out, false>, kSmemE);
  if (!rc) rc = allow_smem(band_ring_kernel<kStreams, false>, kSmemE);
  if (!rc) rc = allow_smem(band_ring_kernel<kVmem, false>, kSmemE);
  if (!rc) rc = allow_smem(band_ring_kernel<kBase, true>, kSmemE);
  if (!rc) rc = allow_smem(overlap_ring_kernel<false>, kSmemG);
  if (!rc) rc = allow_smem(overlap_ring_kernel<true>, kSmemG);
  return rc;
}

// The geometry the ring kernels were built with, for the host's model:
// chunk, threads, E's and G's consumer groups, E's and G's stages, shared
// bytes of E and G.
int iqo_exp_band_ring_shape(int* shape) {
  using namespace rg;
  const int v[8] = {kChunk, kThreads, kGroupsE, kGroupsG, kStagesE, kStagesG, kSmemE, kSmemG};
  for (int i = 0; i < 8; ++i) shape[i] = v[i];
  return 0;
}

// Kernel E, ring form.  form: Form; words: the (h, w / 4) i32 source (base
// only).  src holds `frames` planes of (h, w) bytes back to back; out is
// (frames, 32 n_t, w) of i32, or of u8 for u8out/streams; `ctas` persistent
// blocks (1 .. the item count) take the (frame, chunk, tile) items in runs.
int iqo_exp_band_ydot_ring(int form, int words, const void* src, int frames, int h, int w,
                           const void* coef, void* out, const void* r0, const void* r1,
                           const void* r2, const void* c0, const void* c1, const void* c2,
                           const void* slab, void* scratch, long long slab_bytes, int ctas,
                           void* stream) {
  using namespace rg;
  if (form < kBase || form > kVmem || (words && form != kBase)) return 1007;
  if (w % kChunk) return 1003;
  if (h < kBand || frames < 1 || (frames > 1 && form < kGrid3) ||
      (form >= kStreams && w > 2 * kOpCols) || (form == kVmem && slab_bytes % 16))
    return 1008;
  const int n_t = (h - kBand) / kStep + 1;
  if (ctas < 1 || ctas > static_cast<long long>(frames) * (w / kChunk) * n_t) return 1008;
  if (misaligned(src, 16) || misaligned(coef, 16) || misaligned(out, 16) ||
      (form == kVmem && (misaligned(slab, 16) || misaligned(scratch, 16))))
    return 1002;
  CUtensorMap map;
  const int rc = encode_sw128(&map, src, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w,
                              static_cast<long long>(frames) * h, kBand);
  if (rc) return rc;
  const YdotRingArgs a{static_cast<const uint8_t*>(coef), out, frames, h, w, n_t, h - kBand,
                       {static_cast<const int32_t*>(r0), static_cast<const int32_t*>(r1),
                        static_cast<const int32_t*>(r2)},
                       {static_cast<const int32_t*>(c0), static_cast<const int32_t*>(c1),
                        static_cast<const int32_t*>(c2)},
                       static_cast<const uint4*>(slab), static_cast<uint4*>(scratch),
                       slab_bytes / 16};
  auto s = static_cast<cudaStream_t>(stream);
  if (words) return launch_ydot_ring<kBase, true>(map, a, ctas, s);
  switch (form) {
    case kBase: return launch_ydot_ring<kBase, false>(map, a, ctas, s);
    case kArb: return launch_ydot_ring<kArb, false>(map, a, ctas, s);
    case kGrid3: return launch_ydot_ring<kGrid3, false>(map, a, ctas, s);
    case kClamp: return launch_ydot_ring<kClamp, false>(map, a, ctas, s);
    case kU8Out: return launch_ydot_ring<kU8Out, false>(map, a, ctas, s);
    case kStreams: return launch_ydot_ring<kStreams, false>(map, a, ctas, s);
    default: return launch_ydot_ring<kVmem, false>(map, a, ctas, s);
  }
}

// Kernel G, ring form: src (h, w) u8, coef (96, 128) s8 -> out (96 n_ty, nd)
// u8; blocked: 192-row blocks, else the clamped 208-row windows; `ctas`
// persistent blocks (1 .. the item count) take the (chunk, tile, side) items.
int iqo_exp_overlap_ring(int blocked, int p, const void* src, int h, int w, const void* coef,
                         void* out, int nd, int n_ty, int ctas, void* stream) {
  using namespace rg;
  if (nd % kChunk) return 1003;
  const int rows = blocked ? kOStep : kOBand;
  if (p < 0 || 8 * (p - 1) + kKD > rows || nd > w || w % 16 || n_ty < 1 ||
      (!blocked && h < kOBand))
    return 1008;
  if (ctas < 1 || ctas > nd / kChunk * 2 * n_ty) return 1008;
  if (misaligned(src, 16) || misaligned(coef, 16) || misaligned(out, 16)) return 1002;
  CUtensorMap map;
  const int rc = encode_sw128(&map, src, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, h, rows);
  if (rc) return rc;
  const OverlapRingArgs a{static_cast<const uint8_t*>(coef), static_cast<uint8_t*>(out), h, nd,
                          n_ty, (h - kOBand) / 32 * 32, p};
  auto s = static_cast<cudaStream_t>(stream);
  if (blocked)
    overlap_ring_kernel<true><<<ctas, kThreads, kSmemG, s>>>(map, a);
  else
    overlap_ring_kernel<false><<<ctas, kThreads, kSmemG, s>>>(map, a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
