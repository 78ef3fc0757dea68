// Band-fetch probes for Hopper (sm_90a): how the source band of a resize
// tile reaches its Y pass.  Three kernels, each on column chunks of 128
// source columns (kChunk) with 4 warps:
//
// Kernel E, band_ydot<Form, kWords>: the Y pass of a 2:1 tile,
//   out[32 t + i, j] = sum_k C[i, k] * int8(src[off(t) + k, j] ^ 0x80)
// for C (32, 96) s8 and t < n_t = (H - 96) / 64 + 1 windows of 96 rows,
// off(t) = 64 t (clamped to [0, H - 96] in the clamp forms), over a u8
// plane (H, W).  The forms, each adding one ingredient of the production
// kernel, as scripts/exp_band_shape.py's variants:
//   base     2-D plane, one block per (tile, chunk), out (32 n_t, W) i32;
//   arb      one block per chunk, an in-block loop over the tiles;
//   grid3    a (frames, H, W) source with a frame stride, blockIdx.z = tile;
//   clamp    grid3 with off(t) = max(0, min(H - 96, 64 t)) in the kernel;
//   u8out    clamp, storing (r & 255) as u8;
//   streams  u8out, plus r0..r2[row] ((32 n_t, 1) i32) and c0..c2[j % 1920]
//            ((1, 1920) i32) added before the mask: six per-tile loads;
//   vmem     streams, plus int8(slab[0, j % 128]) added, and the whole
//            4.5 MB slab copied once per launch into a device scratch,
//            shared out over the blocks; stores (r & 255) in i32.
// kWords (only with base): the plane arrives as (H, W / 4) i32 words, four
// source columns each (little-endian), and column 4 q + p of the source
// lands at output column p * W / 4 + q, the permuted order of
// scripts/exp_i32_band.py's build_i32.  Otherwise kWords is false and the
// band is fetched one byte per thread per load, as the resize kernel's
// load_rows does.
// Replaces the TPU kernels of scripts/exp_band_shape.py: build (pl.pallas_call
// at :65 for base/arb, :124 for streams/vmem, :147 for grid3/clamp/u8out), and
// of scripts/exp_i32_band.py: build_u8 (:65, = base) and build_i32 (:94).
// |sum| <= 96 * 64 * 128 < 2^31: no signed overflow; the streams sums wrap
// in uint32 before the mask.
//
// Kernel G, overlap_dots<Variant>(P): per row tile t < n_ty, a window of
// 208 rows at off(t) = max(0, min(clamp_hi, 192 t)), clamp_hi =
// (H - 208) / 32 * 32 (blocked: 192 rows at 192 t, rows >= H read as 0);
//   P = 0: out[96 t + i, j] = window[i, j]                   (u8 copy)
//   P > 0: out = (sum_{i < P} C (96, 128) @ int8(window[8 i : 8 i + 128, :nd])) & 255
// with the u8 -> int8 cast wrapping (no ^ 0x80), out (96 n_ty, nd) u8.
// Variants: elem (in-block tile loop, synchronous loads), elem-b2 (the same
// loop with a cp.async double buffer), blocked (the loop on 192-row blocks)
// and parallel (one block per (tile, chunk), synchronous loads).  Replaces
// the TPU kernel of scripts/exp_overlap.py: build (pl.pallas_call at :82).
// |sum| <= 8 * 128 * 64 * 128 < 2^31.
//
// Kernel H, band_colsum<Variant>: per tile t < n_t, the i32 column sums of
// the rows [t step, t step + step + halo) of a u8 plane (element), of the
// rows [t step, (t + 1) step) of plane A plus [(t + 1) step, (t + 1) step +
// halo) of plane B (blocked2; the probe passes the same plane twice, as the
// script's call(x, x)), or of the step rows alone (blocked1), each sum
// written to 8 rows: out (8 n_t, W) i32.  One block per (tile, chunk): the
// grid form (form="grid"); the walk, its redesign and the default, is
// exp_colsum_walk.cu.  Replaces the TPU kernel of scripts/exp_blocked_halo.py:
// build (pl.pallas_call at :82).  |sum| <= 128 * 255.
//
// The Python side is libiqo_tpu_torch/experiments/exp_band_shape.py,
// exp_i32_band.py, exp_overlap.py and exp_blocked_halo.py.
//
// What bounds them on the H100: bytes.  E moves 8.23 MB of source rows and
// 16.22 MB of i32 output (7.3 us at 3.35 TB/s; u8 output 3.7 us) for 0.39 G
// multiply-adds (0.39 us at 1,979 TOP/s int8); G at P = 8 does 2.26 G
// multiply-adds (2.3 us) on 6.4 MB (1.9 us), so there operations bound it;
// H moves 15.97 + 7.86 MB (7.1 us) on its wide configs.
//
// What the design does about it: the forms keep their functions fixed, so
// that only their times differ, and every synchronous fetch keeps the same
// number of loads in flight per thread (kDepth; G's whole window), so that
// the forms differ in what they load and not in how the compiler happened
// to schedule it.  The TPU's launch forms map onto Hopper as
// follows: a grid that runs in order on one core ("arbitrary") becomes a
// loop inside the block over the row tiles of its column chunk; "parallel"
// one block per (row tile, column chunk); an Element window synchronous
// loads into shared memory and __syncthreads(); a Buffered(2) window a
// cp.async double buffer of the next tile's rows while this tile computes.
// No kernel fetches columns it does not read (G reads nd of W).  The s8
// dots run on mma.sync m16n8k32 (s8 -> s32, exact).  Its B fragment wants
// four consecutive rows of one column in a register, while the band lies
// row-major: each thread reads one 32-bit word (four columns) from each of
// four rows and transposes the 4 x 4 bytes with __byte_perm, which gives
// the fragments of four n-tiles at once; the n-index of tile p is mapped to
// column 4 n + p, so a thread's outputs are 8 neighbouring columns.  The
// band sits in shared memory at a 128-byte pitch with its 16-byte pieces
// swizzled by row (piece ^ 2 ((row >> 2) & 3)), so those word loads hit
// 32 distinct banks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 128;                 // source columns per block
constexpr int kThreads = 128;               // 4 warps, 32 columns each
constexpr int kDepth = 8;                   // loads a thread issues before it uses one
// kernel E
enum Form { kBase = 0, kArb = 1, kGrid3 = 2, kClamp = 3, kU8Out = 4, kStreams = 5,
            kVmem = 6 };
constexpr int kTH = 32, kStep = 64, kBand = 96;
constexpr int kOpCols = 1920, kSlabCols = 128;
// kernel G
enum Overlap { kElem = 0, kElemB2 = 1, kBlocked = 2, kParallel = 3 };
constexpr int kOTH = 96, kOStep = 192, kOBand = 208, kKD = 128;
constexpr int kCPitch = kKD + 16;           // 36 words: A loads hit 32 banks
constexpr int kOBandBytes = kOBand * kChunk;
constexpr int kOSmemBytes = kOTH * kCPitch + 2 * kOBandBytes;
// kernel H
enum Colsum { kElement = 0, kBlocked2 = 1, kBlocked1 = 2 };

// Byte offset of (row r, column c) in a band of 128-byte rows whose 16-byte
// pieces are swizzled by row.
__device__ __forceinline__ int swz(int r, int c) {
  return r * kChunk + ((((c >> 4) ^ (((r >> 2) & 3) << 1))) << 4) + (c & 15);
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

// The B fragments of k rows kb .. kb + 31 for the four n-tiles of a lane:
// b[h][p] holds rows kb + 16 h + 4 t .. + 3 of column 4 wc + p, where wc is
// the lane's word column in the chunk.  kFlip rebases u8 to s8 (^ 0x80).
template <bool kFlip>
__device__ __forceinline__ void b_frags(const uint8_t* band, int kb, int t, int wc,
                                        uint32_t (&b)[2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = *reinterpret_cast<const uint32_t*>(band + swz(kb + 16 * h + 4 * t + j, 4 * wc));
      if constexpr (kFlip) w[j] ^= 0x80808080u;
    }
    transpose4(w, b[h]);
  }
}

// ---- kernel E -------------------------------------------------------------

struct YdotArgs {
  const uint8_t* src;         // (frames, H, W) u8, or (H, W / 4) i32 words
  long long frame_stride;     // bytes between frames (3-D forms)
  int h, w, n_t, clamp_hi;
  const uint8_t* coef;        // (32, 96) s8, row-major
  void* out;
  const int32_t* rows[3];     // (32 n_t, 1) i32 each (streams, vmem)
  const int32_t* cols[3];     // (1, 1920) i32 each (streams, vmem)
  const uint4* slab;          // (36864, 128) s8 (vmem)
  uint4* scratch;             // the slab's copy (vmem)
  long long slab_pieces;      // slab bytes / 16
};

template <int kForm, bool kWords>
__device__ __forceinline__ void ydot_tile(const YdotArgs& a, uint8_t* band, uint32_t* rowop,
                                          uint32_t* colop, const uint32_t (&af)[2][3][4],
                                          int frame, int t) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int chunk0 = blockIdx.x * kChunk;
  const int off = kForm >= kClamp ? max(0, min(a.clamp_hi, kStep * t)) : kStep * t;
  const uint8_t* base = a.src + frame * a.frame_stride + (long long)off * a.w + chunk0;

  // the window: 96 rows x 128 columns, synchronous, kDepth loads deep in
  // both widths, then the barrier
  if constexpr (kWords) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(base);
    constexpr int kLoads = kBand * (kChunk / 4) / kThreads;     // 24
#pragma unroll 1
    for (int b = 0; b < kLoads; b += kDepth) {
      uint32_t v[kDepth];
#pragma unroll
      for (int i = 0; i < kDepth; ++i) {
        const int e = tid + (b + i) * kThreads;
        v[i] = __ldg(s + (long long)(e / (kChunk / 4)) * (a.w / 4) + e % (kChunk / 4));
      }
#pragma unroll
      for (int i = 0; i < kDepth; ++i) {
        const int e = tid + (b + i) * kThreads;
        *reinterpret_cast<uint32_t*>(band + swz(e / (kChunk / 4), 4 * (e % (kChunk / 4)))) = v[i];
      }
    }
  } else {
    constexpr int kLoads = kBand * kChunk / kThreads;           // 96
#pragma unroll 1
    for (int b = 0; b < kLoads; b += kDepth) {
      uint8_t v[kDepth];
#pragma unroll
      for (int i = 0; i < kDepth; ++i) {
        const int e = tid + (b + i) * kThreads;
        v[i] = __ldg(base + (long long)(e / kChunk) * a.w + e % kChunk);
      }
#pragma unroll
      for (int i = 0; i < kDepth; ++i) {
        const int e = tid + (b + i) * kThreads;
        band[swz(e / kChunk, e % kChunk)] = v[i];
      }
    }
  }
  const int row0 = (frame * a.n_t + t) * kTH;       // first output row
  if constexpr (kForm >= kStreams) {
    if (tid < kTH)
      rowop[tid] = static_cast<uint32_t>(__ldg(a.rows[0] + t * kTH + tid)) +
                   static_cast<uint32_t>(__ldg(a.rows[1] + t * kTH + tid)) +
                   static_cast<uint32_t>(__ldg(a.rows[2] + t * kTH + tid));
    const int j = chunk0 + tid;
    uint32_t v = static_cast<uint32_t>(__ldg(a.cols[0] + j % kOpCols)) +
                 static_cast<uint32_t>(__ldg(a.cols[1] + j % kOpCols)) +
                 static_cast<uint32_t>(__ldg(a.cols[2] + j % kOpCols));
    if constexpr (kForm == kVmem)
      v += static_cast<uint32_t>(static_cast<int>(
          reinterpret_cast<const int8_t*>(a.slab)[j % kSlabCols]));
    colop[tid] = v;
  }
  __syncthreads();

  int acc[2][4][4] = {};
#pragma unroll
  for (int ks = 0; ks < kBand / 32; ++ks) {
    uint32_t b[2][4];
    b_frags<true>(band, 32 * ks, q, 8 * warp + g, b);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int p = 0; p < 4; ++p) mma_s8(acc[mt][p], af[mt][ks], b[0][p], b[1][p]);
  }

  // acc[mt][p][2 rh + ec]: row 16 mt + g + 8 rh, chunk column
  // 32 warp + 8 q + 4 ec + p (kWords: plane p, word column 8 warp + 2 q + ec)
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int row = 16 * mt + g + 8 * rh;
      const long long orow = (long long)(row0 + row) * a.w;
      if constexpr (kWords) {
        int32_t* o = static_cast<int32_t*>(a.out) + orow + chunk0 / 4 + 8 * warp + 2 * q;
#pragma unroll
        for (int p = 0; p < 4; ++p)
          *reinterpret_cast<int2*>(o + p * (a.w / 4)) =
              make_int2(acc[mt][p][2 * rh], acc[mt][p][2 * rh + 1]);
      } else {
        const int col = 32 * warp + 8 * q;
        uint32_t v[8];
#pragma unroll
        for (int ec = 0; ec < 2; ++ec)
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            v[4 * ec + p] = static_cast<uint32_t>(acc[mt][p][2 * rh + ec]);
            if constexpr (kForm >= kStreams) v[4 * ec + p] += rowop[row] + colop[col + 4 * ec + p];
            if constexpr (kForm >= kU8Out) v[4 * ec + p] &= 255u;
          }
        if constexpr (kForm == kU8Out || kForm == kStreams) {
          uint8_t* o = static_cast<uint8_t*>(a.out) + orow + chunk0 + col;
          *reinterpret_cast<uint2*>(o) =
              make_uint2(v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24,
                         v[4] | v[5] << 8 | v[6] << 16 | v[7] << 24);
        } else {
          int4* o = reinterpret_cast<int4*>(static_cast<int32_t*>(a.out) + orow + chunk0 + col);
          o[0] = make_int4(v[0], v[1], v[2], v[3]);
          o[1] = make_int4(v[4], v[5], v[6], v[7]);
        }
      }
    }
}

template <int kForm, bool kWords>
__global__ void __launch_bounds__(kThreads) band_ydot_kernel(YdotArgs a) {
  __shared__ __align__(16) uint8_t band[kBand * kChunk];
  __shared__ uint32_t rowop[kTH], colop[kChunk];
  const int tid = threadIdx.x, lane = tid % 32, g = lane / 4, q = lane % 4;

  if constexpr (kForm == kVmem) {     // this block's share of the slab copy
    const long long nb = (long long)gridDim.x * gridDim.y * gridDim.z;
    const long long b = blockIdx.x + (long long)gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z);
    for (long long i = b * kThreads + tid; i < a.slab_pieces; i += nb * kThreads)
      a.scratch[i] = __ldg(a.slab + i);
  }
  // the A fragments of C, once per block: rows 16 mt + g (+8), k 32 ks + 4 q (+16)
  uint32_t af[2][3][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < 3; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        af[mt][ks][i] = __ldg(reinterpret_cast<const uint32_t*>(
            a.coef + (16 * mt + g + 8 * (i & 1)) * kBand + 32 * ks + 16 * (i >> 1) + 4 * q));

  if constexpr (kForm == kArb) {
    for (int t = 0; t < a.n_t; ++t) {
      ydot_tile<kForm, kWords>(a, band, rowop, colop, af, 0, t);
      __syncthreads();                // the band is read before the next tile's rows
    }
  } else if constexpr (kForm == kBase) {
    ydot_tile<kForm, kWords>(a, band, rowop, colop, af, 0, blockIdx.y);
  } else {
    ydot_tile<kForm, kWords>(a, band, rowop, colop, af, blockIdx.y, blockIdx.z);
  }
}

template <int kForm, bool kWords>
int launch_ydot(const YdotArgs& a, int frames, cudaStream_t s) {
  const int chunks = a.w / kChunk;
  const dim3 grid = kForm == kArb ? dim3(chunks)
                    : kForm == kBase ? dim3(chunks, a.n_t)
                                     : dim3(chunks, frames, a.n_t);
  band_ydot_kernel<kForm, kWords><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- kernel G -------------------------------------------------------------

struct OverlapArgs {
  const uint8_t* src;         // (H, W) u8
  int h, w, nd, n_ty, clamp_hi, p;
  const uint8_t* coef;        // (96, 128) s8, row-major
  uint8_t* out;               // (96 n_ty, nd) u8
};

template <int kV>
__host__ __device__ constexpr int window_rows() { return kV == kBlocked ? kOStep : kOBand; }

template <int kV>
__device__ __forceinline__ int window_off(const OverlapArgs& a, int t) {
  return kV == kBlocked ? kOStep * t : max(0, min(a.clamp_hi, kOStep * t));
}

// The window of tile t into buf, 16 bytes per load, synchronously: every
// load of the thread (12 or 13) issued before the first store; rows past
// the plane are zeros.
template <int kV>
__device__ __forceinline__ void fetch_sync(const OverlapArgs& a, uint8_t* buf, int t) {
  constexpr int kLoads = window_rows<kV>() * (kChunk / 16) / kThreads;
  static_assert(window_rows<kV>() * (kChunk / 16) % kThreads == 0, "window split");
  const int off = window_off<kV>(a, t), chunk0 = blockIdx.x * kChunk;
  uint4 v[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int p = threadIdx.x + i * kThreads, r = p / (kChunk / 16), c = (p % (kChunk / 16)) * 16;
    // only blocked's last window runs past the plane
    v[i] = kV != kBlocked || off + r < a.h
               ? __ldg(reinterpret_cast<const uint4*>(a.src + (long long)(off + r) * a.w + chunk0 + c))
               : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int p = threadIdx.x + i * kThreads;
    *reinterpret_cast<uint4*>(buf + swz(p / (kChunk / 16), (p % (kChunk / 16)) * 16)) = v[i];
  }
}

// The same window by cp.async, one commit group; rows past the plane are
// zero-filled (source size 0).
template <int kV>
__device__ __forceinline__ void fetch_async(const OverlapArgs& a, uint8_t* buf, int t) {
  const int off = window_off<kV>(a, t), chunk0 = blockIdx.x * kChunk;
  for (int i = threadIdx.x; i < window_rows<kV>() * (kChunk / 16); i += kThreads) {
    const int r = i / (kChunk / 16), c = (i % (kChunk / 16)) * 16;
    const bool in = off + r < a.h;
    const uint8_t* gp = a.src + (long long)(in ? off + r : 0) * a.w + chunk0 + c;
    const uint32_t sp = static_cast<uint32_t>(__cvta_generic_to_shared(buf + swz(r, c)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(sp), "l"(gp), "r"(in ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// Tile t from the window in buf: the P dots (or the copy at P = 0), & 255.
__device__ __forceinline__ void overlap_tile(const OverlapArgs& a, const uint8_t* cs,
                                             const uint8_t* buf, int t) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int chunk0 = blockIdx.x * kChunk;
  uint8_t* out = a.out + (long long)t * kOTH * a.nd + chunk0;
  if (a.p == 0) {
    for (int i = tid; i < kOTH * (kChunk / 16); i += kThreads) {
      const int r = i / (kChunk / 16), c = (i % (kChunk / 16)) * 16;
      *reinterpret_cast<uint4*>(out + (long long)r * a.nd + c) =
          *reinterpret_cast<const uint4*>(buf + swz(r, c));
    }
    return;
  }
  int acc[6][4][4] = {};
  for (int ks = 0; ks < kKD / 32; ++ks) {
    uint32_t af[6][4];
#pragma unroll
    for (int mt = 0; mt < 6; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        af[mt][i] = *reinterpret_cast<const uint32_t*>(
            cs + (16 * mt + g + 8 * (i & 1)) * kCPitch + 32 * ks + 16 * (i >> 1) + 4 * q);
    for (int i = 0; i < a.p; ++i) {
      uint32_t b[2][4];
      b_frags<false>(buf, 8 * i + 32 * ks, q, 8 * warp + g, b);
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
        for (int p = 0; p < 4; ++p) v[4 * ec + p] = static_cast<uint32_t>(acc[mt][p][2 * rh + ec]) & 255u;
      *reinterpret_cast<uint2*>(out + (long long)(16 * mt + g + 8 * rh) * a.nd + 32 * warp + 8 * q) =
          make_uint2(v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24,
                     v[4] | v[5] << 8 | v[6] << 16 | v[7] << 24);
    }
}

template <int kV>
__global__ void __launch_bounds__(kThreads) overlap_kernel(OverlapArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* cs = smem;                               // C, (96, 144)
  auto buf = [&](int i) { return smem + kOTH * kCPitch + i * kOBandBytes; };
  for (int i = threadIdx.x; i < kOTH * (kKD / 16); i += kThreads) {
    const int r = i / (kKD / 16), c = (i % (kKD / 16)) * 16;
    *reinterpret_cast<uint4*>(cs + r * kCPitch + c) =
        __ldg(reinterpret_cast<const uint4*>(a.coef + r * kKD + c));
  }
  if constexpr (kV == kParallel) {
    fetch_sync<kV>(a, buf(0), blockIdx.y);
    __syncthreads();
    overlap_tile(a, cs, buf(0), blockIdx.y);
  } else if constexpr (kV == kElemB2) {
    fetch_async<kV>(a, buf(0), 0);
    for (int t = 0; t < a.n_ty; ++t) {
      if (t + 1 < a.n_ty) {
        fetch_async<kV>(a, buf((t + 1) & 1), t + 1);   // read by tile t - 1, before the last barrier
        async_wait<1>();
      } else {
        async_wait<0>();
      }
      __syncthreads();                                 // tile t's rows landed for every thread
      overlap_tile(a, cs, buf(t & 1), t);
      __syncthreads();
    }
  } else {
    for (int t = 0; t < a.n_ty; ++t) {
      fetch_sync<kV>(a, buf(0), t);
      __syncthreads();
      overlap_tile(a, cs, buf(0), t);
      __syncthreads();
    }
  }
}

template <int kV>
int launch_overlap(const OverlapArgs& a, cudaStream_t s) {
  const int chunks = a.nd / kChunk;
  const dim3 grid = kV == kParallel ? dim3(chunks, a.n_ty) : dim3(chunks);
  overlap_kernel<kV><<<grid, kThreads, kOSmemBytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kV>
int allow_overlap_smem() {
  return static_cast<int>(cudaFuncSetAttribute(
      overlap_kernel<kV>, cudaFuncAttributeMaxDynamicSharedMemorySize, kOSmemBytes));
}

// ---- kernel H -------------------------------------------------------------

// Thread (rg, q) sums word column q of the chunk (4 source columns) over the
// rows rg, rg + 4, ..., kDepth loads deep in every loop; the four row groups
// meet in shared memory.
template <int kV>
__global__ void __launch_bounds__(kThreads)
band_colsum_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                   int32_t* __restrict__ out, int w, int step, int halo) {
  __shared__ __align__(16) uint32_t part[4][kChunk];
  const int tid = threadIdx.x, rg = tid / 32, t = blockIdx.y;
  const int chunk0 = blockIdx.x * kChunk, w4 = w / 4, qcol = chunk0 / 4 + tid % 32;
  uint32_t s[4] = {0, 0, 0, 0};
  auto add_rows = [&](const uint8_t* plane, int row0, int rows) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(plane) + (long long)row0 * w4 + qcol;
    auto add = [&](uint32_t v) {
      s[0] += v & 255u;
      s[1] += (v >> 8) & 255u;
      s[2] += (v >> 16) & 255u;
      s[3] += v >> 24;
    };
    const int n = (rows - rg + 3) / 4;            // this thread's rows: rg, rg + 4, ...
    int i0 = 0;
#pragma unroll 1
    for (; i0 + kDepth <= n; i0 += kDepth) {
      uint32_t v[kDepth];
#pragma unroll
      for (int i = 0; i < kDepth; ++i) v[i] = __ldg(p + (long long)(rg + 4 * (i0 + i)) * w4);
#pragma unroll
      for (int i = 0; i < kDepth; ++i) add(v[i]);
    }
    for (; i0 < n; ++i0) add(__ldg(p + (long long)(rg + 4 * i0) * w4));
  };
  if (qcol < w4) {
    if constexpr (kV == kElement) {
      add_rows(a, t * step, step + halo);
    } else {
      add_rows(a, t * step, step);
      if constexpr (kV == kBlocked2) add_rows(b, (t + 1) * step, halo);
    }
  }
  *reinterpret_cast<uint4*>(&part[rg][4 * (tid % 32)]) = make_uint4(s[0], s[1], s[2], s[3]);
  __syncthreads();
  const int c = chunk0 + tid;
  if (c < w) {
    const int32_t v = static_cast<int32_t>(part[0][tid] + part[1][tid] + part[2][tid] + part[3][tid]);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[(long long)(8 * t + i) * w + c] = v;
  }
}

bool misaligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes != 0; }

}  // namespace

extern "C" {

// dims: E's TH, STEP, BAND; G's TH, STEP, BAND, KD; the column chunk.
int iqo_exp_band_shape(int* dims) {
  const int v[8] = {kTH, kStep, kBand, kOTH, kOStep, kOBand, kKD, kChunk};
  for (int i = 0; i < 8; ++i) dims[i] = v[i];
  return 0;
}

// Kernel E.  form: Form; words: the (H, W / 4) i32 source (base only).
// src holds `frames` planes of (h, w) bytes at frame_stride; out is
// (frames, 32 n_t, w) of i32, or of u8 for u8out/streams.
int iqo_exp_band_ydot(int form, int words, const void* src, long long frame_stride, int frames,
                      int h, int w, const void* coef, void* out, const void* r0,
                      const void* r1, const void* r2, const void* c0, const void* c1,
                      const void* c2, const void* slab, void* scratch, long long slab_bytes,
                      void* stream) {
  if (form < kBase || form > kVmem || (words && form != kBase)) return 1007;
  if (w % kChunk) return 1003;
  if (h < kBand || frames < 1 || (frames > 1 && form < kGrid3) ||
      (form >= kStreams && w > 2 * kOpCols) || (form == kVmem && slab_bytes % 16))
    return 1008;
  if (misaligned(src, 16) || misaligned(coef, 16) || misaligned(out, 16) ||
      (form == kVmem && (misaligned(slab, 16) || misaligned(scratch, 16))) ||
      frame_stride % 16)
    return 1002;
  YdotArgs a{static_cast<const uint8_t*>(src), frame_stride, h, w,
             (h - kBand) / kStep + 1, h - kBand, static_cast<const uint8_t*>(coef), out,
             {static_cast<const int32_t*>(r0), static_cast<const int32_t*>(r1),
              static_cast<const int32_t*>(r2)},
             {static_cast<const int32_t*>(c0), static_cast<const int32_t*>(c1),
              static_cast<const int32_t*>(c2)},
             static_cast<const uint4*>(slab), static_cast<uint4*>(scratch), slab_bytes / 16};
  auto s = static_cast<cudaStream_t>(stream);
  if (words) return launch_ydot<kBase, true>(a, frames, s);
  switch (form) {
    case kBase: return launch_ydot<kBase, false>(a, frames, s);
    case kArb: return launch_ydot<kArb, false>(a, frames, s);
    case kGrid3: return launch_ydot<kGrid3, false>(a, frames, s);
    case kClamp: return launch_ydot<kClamp, false>(a, frames, s);
    case kU8Out: return launch_ydot<kU8Out, false>(a, frames, s);
    case kStreams: return launch_ydot<kStreams, false>(a, frames, s);
    default: return launch_ydot<kVmem, false>(a, frames, s);
  }
}

// Raise kernel G's dynamic shared-memory limit on the current device; call
// once per device before its first launch.
int iqo_exp_overlap_setup() {
  int rc = allow_overlap_smem<kElem>();
  if (!rc) rc = allow_overlap_smem<kElemB2>();
  if (!rc) rc = allow_overlap_smem<kBlocked>();
  if (!rc) rc = allow_overlap_smem<kParallel>();
  return rc;
}

// Kernel G: src (h, w) u8, coef (96, 128) s8 -> out (96 n_ty, nd) u8.
int iqo_exp_overlap(int variant, int p, const void* src, int h, int w, const void* coef,
                    void* out, int nd, int n_ty, void* stream) {
  if (variant < kElem || variant > kParallel) return 1007;
  if (nd % kChunk) return 1003;
  const int rows = variant == kBlocked ? kOStep : kOBand;
  if (p < 0 || 8 * (p - 1) + kKD > rows || nd > w || w % 16 || n_ty < 1 ||
      (variant != kBlocked && h < kOBand))
    return 1008;
  if (misaligned(src, 16) || misaligned(coef, 16) || misaligned(out, 16)) return 1002;
  const OverlapArgs a{static_cast<const uint8_t*>(src), h, w, nd, n_ty,
                      (h - kOBand) / 32 * 32, p, static_cast<const uint8_t*>(coef),
                      static_cast<uint8_t*>(out)};
  auto s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case kElem: return launch_overlap<kElem>(a, s);
    case kElemB2: return launch_overlap<kElemB2>(a, s);
    case kBlocked: return launch_overlap<kBlocked>(a, s);
    default: return launch_overlap<kParallel>(a, s);
  }
}

// Kernel H: planes a and b (b read by blocked2 only) of w columns -> out
// (8 n_t, w) i32.  The caller checks that the rows exist.
int iqo_exp_band_colsum(int variant, const void* a, const void* b, void* out, int w, int n_t,
                        int step, int halo, void* stream) {
  if (variant < kElement || variant > kBlocked1) return 1007;
  if (w % 4 || w <= 0 || n_t < 1 || step < 1 || halo < 0) return 1008;
  if (misaligned(a, 16) || misaligned(b, 16) || misaligned(out, 16)) return 1002;
  const dim3 grid((w + kChunk - 1) / kChunk, n_t);
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const uint8_t*>(a);
  auto pb = static_cast<const uint8_t*>(b);
  auto po = static_cast<int32_t*>(out);
  switch (variant) {
    case kElement: band_colsum_kernel<kElement><<<grid, kThreads, 0, s>>>(pa, pb, po, w, step, halo); break;
    case kBlocked2: band_colsum_kernel<kBlocked2><<<grid, kThreads, 0, s>>>(pa, pb, po, w, step, halo); break;
    default: band_colsum_kernel<kBlocked1><<<grid, kThreads, 0, s>>>(pa, pb, po, w, step, halo); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
