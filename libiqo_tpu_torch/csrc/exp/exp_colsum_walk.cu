// Kernel H redesigned for Hopper (sm_90a): band_colsum's walk (form="walk",
// the default of libiqo_tpu_torch/experiments/exp_blocked_halo.py), the
// column sums of a band's windows with every source row read once.
//
// What it computes (as exp_band.cu's band_colsum_kernel, the grid form):
// per tile t < n_t the i32 column sums of rows [t step, t step + step + halo)
// of a u8 plane (element), of the rows [t step, (t + 1) step) of plane A plus
// [(t + 1) step, (t + 1) step + halo) of plane B (blocked2), or of the step
// rows alone (blocked1), each written to 8 rows: out (8 n_t, W) i32.
// Replaces the TPU kernel of scripts/exp_blocked_halo.py: build
// (pl.pallas_call at :82).
//
// What bounds it on the H100: bytes, each source row once and the output
// once (12.6 MB on the narrow config (256, 64, 64, 512): 3.77 us at 3.35
// TB/s; 23.8 MB on the luma-like one: 7.12 us).  The grid form reads each
// halo row twice (once as its tile's, once as the next tile's step rows) on
// 1,024-1,920 blocks of 4-byte loads.
//
// What the design does about it.  One block a (column chunk of cw bytes, run
// of `run` consecutive tiles), several resident an SM
// (experiments/exp_blocked_halo.py colsum_walk picks cw, run and the thread
// rows: 128 bytes, 3 tiles and one piece a thread where the caller does not
// fix them).  For each plane it reads (a pass: element and blocked1 one,
// blocked2 two), the window of tile t is L = q step + h rows (0 <= h < step)
// from row t step + alpha: the sums of the q step blocks from there, each a
// head of h rows and a tail, and the head of the next.  The block reads the
// rows of its run's windows once, as step blocks of `step` rows (the last
// one its head of h rows alone), cut at h into a head and a tail, these into
// pieces of kRows rows; pieces are grouped by step block g, a group holding
// every pass's pieces of g.
// * Thread (u, tp) takes column unit u (V bytes: 16, ld.global.nc.v4, a warp
//   load whole 128-byte lines; 4 where w or an address is not a multiple of
//   16) of pieces tp, tp + tps, tp + 2 tps, ... (tps: the thread rows), one
//   a phase, in row order; each piece is kRows loads of V bytes, all in
//   flight at once.  Where the block's threads hold every piece of its run
//   (one phase, the host's default), the block requests its whole run at
//   once; two blocks an SM at least (48 registers a thread) keep other
//   blocks' loads in flight while one sums and stores.
// * A piece's bytes add two columns to a 32-bit word (at most kRows x 255)
//   and land as the piece's partial sums in shared memory, every piece of the
//   run its own slot: no atomics, no shuffles.
// * After each phase's barrier the block stores the tiles whose step blocks'
//   pieces are all summed, a thread a (tile, four columns): the sums of the
//   window's pieces, unpacked and added in uint32, 16 bytes to each of the
//   tile's 8 rows.
//
// The Python side is libiqo_tpu_torch/experiments/exp_blocked_halo.py
// (band_colsum, colsum_walk, and colsum_model, this kernel's partition and
// order in NumPy); where its time goes: libiqo_tpu_torch/tools/colsum_ablate.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Colsum { kElement = 0, kBlocked2 = 1, kBlocked1 = 2 };

constexpr int kWalkMaxThreads = 640;        // a block's threads, at most; two blocks an SM at least
constexpr int kWalkPieceBytes = 128;        // bytes a thread loads of a piece: kRows x V
constexpr int kWalkSmemBytes = 232448;      // dynamic shared memory a block may take

struct WalkPass {
  const uint8_t* plane;
  int alpha;          // rows from a tile's first row to its window's first row
  int q, h;           // the window: q step + h rows, 0 <= h < step
  int nh, nt;         // pieces of a step block's head and tail; both 0 for an empty window
};

struct WalkArgs {
  WalkPass pass[2];
  int passes;
  int32_t* out;
  int w, n_t, step;
  int cw, c4_log2, run, tps;
};

struct WalkPiece {
  const uint8_t* src;   // the piece's first row at the thread's column unit
  int rows;             // 0: nothing to load
};

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}
__device__ __forceinline__ uint32_t word(uint32_t v, int) { return v; }

template <typename Vec>
__global__ void __launch_bounds__(kWalkMaxThreads, 2)
band_colsum_walk_kernel(const __grid_constant__ WalkArgs a) {
  constexpr int V = sizeof(Vec), kRows = kWalkPieceBytes / V, kW = V / 4;
  extern __shared__ uint4 walk_smem[];
  uint32_t* part = reinterpret_cast<uint32_t*>(walk_smem);   // [piece][cw / 2]
  const int cw = a.cw, c4 = cw / 4, cu = cw / V, half = cw / 2;
  const int u = threadIdx.x % cu, tp = threadIdx.x / cu;
  const int chunks = (a.w + cw - 1) / cw;
  const int c0 = (blockIdx.x % chunks) * cw, t0 = (blockIdx.x / chunks) * a.run;
  const int R = min(a.run, a.n_t - t0), P = a.passes;
  const int nu0 = a.pass[0].nh + a.pass[0].nt;
  const int nug = nu0 + (P > 1 ? a.pass[1].nh + a.pass[1].nt : 0);
  const int qmax = max(a.pass[0].q, P > 1 ? a.pass[1].q : 0);
  const int G = R + qmax, pieces = G * nug, phases = (pieces + a.tps - 1) / a.tps;
  const bool mine = tp < a.tps && c0 + u * V < a.w;

  auto piece = [&](int i) {
    WalkPiece r{nullptr, 0};
    if (!mine || i >= pieces) return r;
    const int g = i / nug, j = i - g * nug, p = j < nu0 ? 0 : 1, jj = p ? j - nu0 : j;
    const WalkPass ps = p ? a.pass[1] : a.pass[0];
    if (g >= R + ps.q) return r;
    int lo;
    if (jj < ps.nh) {
      lo = jj * kRows;
      r.rows = min(kRows, ps.h - lo);
    } else {
      if (g == R + ps.q - 1) return r;             // the last step block: its head alone
      lo = ps.h + (jj - ps.nh) * kRows;
      r.rows = min(kRows, a.step - lo);
    }
    r.src = ps.plane + ((long long)(t0 + g) * a.step + ps.alpha + lo) * a.w + c0 + u * V;
    return r;
  };
  auto issue = [&](Vec (&v)[kRows], const WalkPiece& pc) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      v[r] = r < pc.rows ? __ldg(reinterpret_cast<const Vec*>(pc.src + (long long)r * a.w))
                         : Vec{};
  };
  // the piece's partial sums: word 2 c of its slot holds columns 4 c and
  // 4 c + 2 (bytes 0 and 2 of the source word), word 2 c + 1 columns 4 c + 1
  // and 4 c + 3
  auto sum = [&](const Vec (&v)[kRows], int i, const WalkPiece& pc) {
    if (pc.rows == 0) return;
    uint32_t pk[2 * kW];
#pragma unroll
    for (int j = 0; j < 2 * kW; ++j) pk[j] = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        const uint32_t x = word(v[r], j);
        pk[2 * j] += x & 0x00FF00FFu;
        pk[2 * j + 1] += __byte_perm(x, 0, 0x4341);
      }
    }
    uint32_t* s = part + (long long)i * half + u * 2 * kW;
#pragma unroll
    for (int j = 0; j < 2 * kW; j += 2) *reinterpret_cast<uint2*>(s + j) = make_uint2(pk[j], pk[j + 1]);
  };
  int emitted = 0;
  // after phase ph's barrier: the tiles whose pieces are all summed, a thread
  // a (tile, four columns)
  auto store = [&](int ph) {
    const int done = ph + 1 >= phases ? G : min(G, (ph + 1) * a.tps / nug);
    const int ready = min(R, done - qmax);
    for (int i = threadIdx.x; i < max(0, ready - emitted) << a.c4_log2; i += blockDim.x) {
      const int k = emitted + (i >> a.c4_log2), c = i & (c4 - 1);
      if (c0 + 4 * c >= a.w) continue;
      uint32_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if (p < P) {
          const WalkPass& ps = a.pass[p];
          const int off = p ? nu0 : 0;
          for (int g = k; g <= k + ps.q; ++g) {
            const int n = g < k + ps.q ? ps.nh + ps.nt : ps.nh;
            for (int j = 0; j < n; ++j) {
              const uint2 x = *reinterpret_cast<const uint2*>(
                  part + (long long)(g * nug + off + j) * half + 2 * c);
              s0 += x.x & 0xFFFFu;
              s1 += x.y & 0xFFFFu;
              s2 += x.x >> 16;
              s3 += x.y >> 16;
            }
          }
        }
      }
      uint4* o = reinterpret_cast<uint4*>(a.out + (long long)8 * (t0 + k) * a.w + c0 + 4 * c);
#pragma unroll
      for (int r = 0; r < 8; ++r) o[(long long)r * (a.w / 4)] = make_uint4(s0, s1, s2, s3);
    }
    emitted = max(emitted, ready);
  };

  for (int ph = 0; ph < phases; ++ph) {
    Vec v[kRows];
    const WalkPiece pc = piece(tp + ph * a.tps);
    issue(v, pc);
    sum(v, tp + ph * a.tps, pc);
    __syncthreads();                               // phase ph's pieces are summed
    store(ph);
  }
}

// The pass of a window of L rows from row alpha of each tile, on plane p; a
// window inside one step block (L < step) is its head alone: no tails.
WalkPass walk_pass(const void* p, int alpha, int L, int step, int rows) {
  const int q = L / step, h = L % step;
  if (L == 0) return {static_cast<const uint8_t*>(p), alpha, 0, 0, 0, 0};
  return {static_cast<const uint8_t*>(p), alpha, q, h, (h + rows - 1) / rows,
          q ? (step - h + rows - 1) / rows : 0};
}

bool misaligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes != 0; }

template <typename Vec>
int allow_walk_smem() {
  return static_cast<int>(cudaFuncSetAttribute(band_colsum_walk_kernel<Vec>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kWalkSmemBytes));
}

}  // namespace

extern "C" {

// Raise the walk's dynamic shared-memory limit on the current device.
int iqo_exp_band_colsum_walk_setup() {
  int rc = allow_walk_smem<uint4>();
  if (!rc) rc = allow_walk_smem<uint32_t>();
  return rc;
}

// dims: most threads a block, bytes a thread loads of a piece, shared memory
// a block may take.
int iqo_exp_band_colsum_walk_shape(int* dims) {
  const int v[3] = {kWalkMaxThreads, kWalkPieceBytes, kWalkSmemBytes};
  for (int i = 0; i < 3; ++i) dims[i] = v[i];
  return 0;
}

// Kernel H, the walk: planes a and b (read by blocked2 only) of w columns ->
// out (8 n_t, w) i32, on blocks of (cw bytes, run tiles) with tps thread rows
// of cw / vec threads, loads of `vec` bytes (16 or 4).  The host's walk
// (experiments/exp_blocked_halo.py colsum_walk) picks cw, run and tps; the
// caller checks that the rows exist.
int iqo_exp_band_colsum_walk(int variant, const void* a, const void* b, void* out, int w,
                             int n_t, int step, int halo, int vec, int cw, int run, int tps,
                             void* stream) {
  if (variant < kElement || variant > kBlocked1 || (vec != 16 && vec != 4)) return 1007;
  if (w % vec || w <= 0 || n_t < 1 || step < 1 || halo < 0 || run < 1 || tps < 1) return 1008;
  if (cw < 16 || cw > 512 || (cw & (cw - 1)) || cw < vec) return 1008;
  const long long threads = ((long long)cw / vec * tps + 31) / 32 * 32;
  if (threads > kWalkMaxThreads) return 1008;
  if (misaligned(a, vec) || misaligned(b, vec) || misaligned(out, 16)) return 1002;
  const int rows = kWalkPieceBytes / vec;
  WalkArgs args{};
  if (variant == kBlocked2) {
    args.pass[0] = walk_pass(a, 0, step, step, rows);
    args.pass[1] = walk_pass(b, step, halo, step, rows);
    args.passes = 2;
  } else {
    args.pass[0] = walk_pass(a, 0, variant == kElement ? step + halo : step, step, rows);
    args.passes = 1;
  }
  int qmax = 0, nug = 0;
  for (int p = 0; p < args.passes; ++p) {
    qmax = args.pass[p].q > qmax ? args.pass[p].q : qmax;
    nug += args.pass[p].nh + args.pass[p].nt;
  }
  args.out = static_cast<int32_t*>(out);
  args.w = w;
  args.n_t = n_t;
  args.step = step;
  args.cw = cw;
  while ((4 << args.c4_log2) < cw) ++args.c4_log2;
  args.run = run;
  args.tps = tps;
  const long long smem = 2ll * cw * (run + qmax) * nug;      // a slot of cw / 2 words a piece
  if (smem > kWalkSmemBytes) return 1008;
  const long long blocks = (long long)((w + cw - 1) / cw) * ((n_t + run - 1) / run);
  if (blocks > 0x7fffffff) return 1008;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (vec == 16)
    band_colsum_walk_kernel<uint4><<<grid, threads, smem, s>>>(args);
  else
    band_colsum_walk_kernel<uint32_t><<<grid, threads, smem, s>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
