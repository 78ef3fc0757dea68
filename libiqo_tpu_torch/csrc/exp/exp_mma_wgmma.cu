// Kernel C redesigned for Hopper (sm_90a), mma_wgmma<Kind>: the same
// function as exp_mma.cu's mma_steps<Kind> (the first, mma.sync form, kept),
// out[t] = a[t] @ b for every step t, a (steps, M, K) and b held K-major as
// bt (N, K), in the same four input/accumulator pairs:
// * kF32: float32 inputs on the tensor cores' TF32 path (wgmma k8), f32 sums.
//   The unit reads the f32 bits as they are and keeps the top 19 (no
//   cvt.rna, unlike the mma.sync form); on the plain version's inputs, integers of
//   |x| <= 2^11, both agree exactly;
// * kBF16: bf16 inputs (wgmma k16), f32 sums;
// * kS8S32: int8 inputs (wgmma k32), int32 sums;
// * kS8F32: int8 inputs, the same int32 sums converted by __int2float_rn at
//   the store (Hopper has no int8 -> f32 product).
//
// Replaces the TPU kernel of scripts/exp_int8_mxu.py: make (pl.pallas_call
// at :29), `a_ref[...] @ b_ref[...]` with preferred_element_type over a grid
// of STEPS, b resident.  The Python side is
// libiqo_tpu_torch/experiments/exp_int8_mxu.py (form "wgmma", the default).
//
// What bounds it on the H100: at the script's shapes (64 x (256, 1024) @
// (1024, 512)) bytes for the s8 and bf16 rows, mostly the output written
// once: s8 -> s32 moves 50.9 MB (15.2 us at 3.35 TB/s; two thirds of it the
// int32 output) for 17.2 G operations (8.7 us at 1,979 TOP/s); bf16 68.2 MB
// (20.3 us) for 17.4 us of operations at 989 TFLOP/s; the TF32 row's
// operations take 34.7 us at 495 TFLOP/s against 30.7 us of bytes.
//
// What the design does about it: it keeps the loads, the products and the
// output stores of consecutive tiles in flight together, so that the bytes
// move at the rate the card gives.
// * A persistent grid of one block an SM walks the output tiles of
//   128 x 256 (tile t of the block: blockIdx.x + i gridDim.x; rows of all
//   steps as one (steps M) x N product, N tiles innermost, so that
//   neighbouring blocks read the same rows of `a` from L2 at once).
// * One producer warp issues TMA loads (cp.async.bulk.tensor) of 128-byte K
//   chunks of `a` (128 rows) and `bt` (256 rows), 128-byte swizzled, into a
//   ring of 4 mbarrier-tracked stages of 48 KB; it runs ahead into the next
//   tile while the consumers hand this one to the stores.
// * Two consumer warpgroups each own 64 rows x 256 columns: per 128-byte
//   chunk, 4 K steps of 32 bytes (8 tf32, 16 bf16 or 32 int8: one byte-level
//   pipeline feeds all four kinds) x 2 wgmma m64n128 on the swizzled tiles,
//   both operands K-major (the only layout wgmma takes for s8 and tf32).  A
//   chunk's stage is handed back once the next chunk's wgmma group is issued
//   and the chunk's own has retired (wait_group 1), so a consumer never waits
//   for its last group.
// * The epilogue hands the tile to the TMA unit: each warpgroup writes its
//   64 rows into a 16 KB staging of 64 columns (2 boxes of 64 x 32, 128-byte
//   swizzled, so a warp's 8-byte writes are conflict-free), one thread
//   issues bulk tensor stores (cp.async.bulk.tensor, shared -> global), and
//   the next pass waits only until the TMA unit has read the staging out; 4
//   passes a tile, then the warpgroup goes on to the next tile's products
//   while the stores drain.  (Stores straight from the registers held the
//   consumers until their output had left the SM, with or without an
//   evict-first hint.)
// Shared memory: 4 x 48 KB stages + 2 x 16 KB staging + barriers + 1 KB
// alignment slack = 230,464 of 232,448 bytes, one block an SM.
// The wrapper refuses shapes off the tile (M a multiple of 128, N of 256, K
// of 128 bytes); it does not fall back.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

enum Kind { kF32 = 0, kBF16 = 1, kS8S32 = 2, kS8F32 = 3 };

namespace gc {
constexpr int kBM = 128, kBN = 256;        // output tile of a block
constexpr int kKC = 128;                   // bytes of K a stage: the 128-byte swizzle's width
constexpr int kStages = 4;
constexpr int kConsumers = 2;              // warpgroups, 64 rows each
constexpr int kThreads = 128 * kConsumers + 32;   // + one producer warp
constexpr int kABytes = kBM * kKC;
constexpr int kBBytes = kBN * kKC;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOutCols = 64;               // columns a warpgroup stages a pass (4 passes a tile)
constexpr int kOutBytes = 64 * kOutCols * 4;   // one warpgroup's staging: 2 boxes of 64 x 32
constexpr int kSmem = kStages * kStageBytes + kConsumers * kOutBytes + 2 * kStages * 8 +
                      1024;                // + barriers, slack
static_assert(kStageBytes % 1024 == 0 && kABytes % 1024 == 0, "swizzled tiles 1024-aligned");
static_assert(kOutBytes % 1024 == 0, "staging boxes 1024-aligned");
static_assert(kSmem <= 232448, "shared memory of one block");
}  // namespace gc

// D[64 x 128] (+)= A[64 x 32 bytes] x B[32 bytes x 128], both from shared
// memory by descriptor; scale_d 0 overwrites D.
template <int kKind>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (kKind == kF32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " IQO_D64
        ", %64, %65, p, 1, 1;\n}\n"
        : IQO_ACC64("+f", d)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " IQO_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : IQO_ACC64("+f", d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

__device__ __forceinline__ void wgmma_ss_s8(uint32_t (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " IQO_D64 ", %64, %65, p;\n}\n"
      : IQO_ACC64("+r", d)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int kKind>
__global__ void __launch_bounds__(gc::kThreads, 1)
mma_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __grid_constant__ CUtensorMap map_out, int n, int chunks, int tiles) {
  using namespace gc;
  using Acc = std::conditional_t<(kKind >= kS8S32), uint32_t, float>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* staging = smem + kStages * kStageBytes;                 // kConsumers x kOutBytes
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + kConsumers * kOutBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = n / kBN;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);   // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {            // the producer warp: one thread issues
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int row0 = (t / n_tiles) * kBM, col0 = (t % n_tiles) * kBN;
        for (int c = 0; c < chunks; ++c, ++it) {
          const int s = it % kStages;
          mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);   // its last readers are done
          mbar_expect(&full[s], kStageBytes);
          uint8_t* st = smem + s * kStageBytes;
          tma_2d(st, &map_a, c * kKC, row0, &full[s]);
          tma_2d(st + kABytes, &map_b, c * kKC, col0, &full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile, both
  // halves of 128 columns; d[h] is half h in wgmma's fragment layout (warp w
  // of the group: rows 16 w + g, + 8; n8 tile j: columns 8 j + 2 q, + 1)
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, q = lane % 4;
  Acc d[2][64];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = (t / n_tiles) * kBM, col0 = (t % n_tiles) * kBN;
    for (int c = 0; c < chunks; ++c, ++it) {
      const int s = it % kStages;
      mbar_wait(&full[s], (it / kStages) & 1);
      const uint32_t a0 = smem_addr(smem + s * kStageBytes + wg * 64 * kKC);
      const uint32_t b0 = smem_addr(smem + s * kStageBytes + kABytes);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) pin(d[h]);
#pragma unroll
      for (int kk = 0; kk < kKC / 32; ++kk) {
        const uint64_t da = desc_sw128(a0 + 32 * kk);
        const int scale_d = (c > 0 || kk > 0) ? 1 : 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint64_t db = desc_sw128(b0 + h * 128 * kKC + 32 * kk);
          if constexpr (kKind >= kS8S32) wgmma_ss_s8(d[h], da, db, scale_d);
          else wgmma_ss<kKind>(d[h], da, db, scale_d);
        }
      }
      wgmma_commit();
#pragma unroll
      for (int h = 0; h < 2; ++h) pin(d[h]);
      if (c > 0) {
        wgmma_wait<1>();                   // chunk c - 1 retired: hand its stage back
        if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) pin(d[h]);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % kStages]);

    // The epilogue: 4 passes of 64 columns.  Each thread writes its pass's
    // values into the warpgroup's staging (2 boxes of 64 rows x 32 columns,
    // 128-byte swizzled: conflict-free), and one thread hands them to the
    // TMA unit as bulk tensor stores; the warpgroup goes on to the next
    // tile while they drain.  A pass first waits until the TMA has read the
    // previous pass out of the staging.
    uint8_t* st = staging + wg * kOutBytes;
    const int wt = tid % 128, r0 = 16 * wl + g;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (wt == 0) bulk_wait_read();
      named_sync(1 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {     // n8 tile j = 8 (p % 2) + jj of half p / 2
        const int j = 8 * (p % 2) + jj;
        uint8_t* box = st + (jj / 4) * (kOutBytes / 2);
        const int chunk = 2 * (jj % 4) + q / 2, byte = 8 * (q % 2);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + 8 * r;
          const Acc v0 = d[p / 2][4 * j + 2 * r], v1 = d[p / 2][4 * j + 2 * r + 1];
          uint2 v;
          if constexpr (kKind == kS8F32) {
            v = make_uint2(__float_as_uint(__int2float_rn(static_cast<int>(v0))),
                           __float_as_uint(__int2float_rn(static_cast<int>(v1))));
          } else if constexpr (kKind == kS8S32) {
            v = make_uint2(v0, v1);
          } else {
            v = make_uint2(__float_as_uint(v0), __float_as_uint(v1));
          }
          *reinterpret_cast<uint2*>(box + row * 128 + ((chunk ^ (row & 7)) << 4) + byte) = v;
        }
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (wt == 0) {
        const int x = col0 + kOutCols * p, y = row0 + 64 * wg;
        tma_store_2d(&map_out, x, y, st);
        tma_store_2d(&map_out, x + 32, y, st + kOutBytes / 2);
        bulk_commit();
      }
    }
  }
  if (tid % 128 == 0) bulk_wait_all();   // the last stores are complete before the block exits
}

template <int kKind>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& mo, int n, int chunks,
           int tiles, int ctas, cudaStream_t s) {
  mma_wgmma_kernel<kKind><<<ctas, gc::kThreads, gc::kSmem, s>>>(ma, mb, mo, n, chunks, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Raise the four instantiations' dynamic shared-memory limits on the current
// device; call once per device before their first launch.
int iqo_exp_mma_wgmma_setup() {
  int rc = static_cast<int>(cudaFuncSetAttribute(
      mma_wgmma_kernel<kF32>, cudaFuncAttributeMaxDynamicSharedMemorySize, gc::kSmem));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      mma_wgmma_kernel<kBF16>, cudaFuncAttributeMaxDynamicSharedMemorySize, gc::kSmem));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      mma_wgmma_kernel<kS8S32>, cudaFuncAttributeMaxDynamicSharedMemorySize, gc::kSmem));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      mma_wgmma_kernel<kS8F32>, cudaFuncAttributeMaxDynamicSharedMemorySize, gc::kSmem));
  return rc;
}

// The geometry the kernel was built with, for the host's model: tile rows,
// tile columns, K bytes a stage, stages, threads, shared bytes.
int iqo_exp_mma_wgmma_shape(int* shape) {
  const int v[6] = {gc::kBM, gc::kBN, gc::kKC, gc::kStages, gc::kThreads, gc::kSmem};
  for (int i = 0; i < 6; ++i) shape[i] = v[i];
  return 0;
}

// a (steps, m, k), bt (n, k) of the kind's input type -> out (steps, m, n);
// `ctas` persistent blocks (1 .. the tile count) walk the tiles.
int iqo_exp_mma_wgmma(int kind, const void* a, const void* bt, void* out, int steps, int m,
                      int n, int k, int ctas, void* stream) {
  if (kind < kF32 || kind > kS8F32) return 1004;
  const long long kbytes = static_cast<long long>(k) * (kind == kF32 ? 4 : kind == kBF16 ? 2 : 1);
  if (steps <= 0 || m <= 0 || n <= 0 || k <= 0 || m % gc::kBM || n % gc::kBN ||
      kbytes % gc::kKC)
    return 1005;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(bt) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return 1002;
  const long long tiles = static_cast<long long>(steps) * (m / gc::kBM) * (n / gc::kBN);
  if (ctas < 1 || ctas > tiles || tiles > 0x7FFFFFFF) return 1008;
  CUtensorMap ma, mb, mo;
  int rc = encode_sw128(&ma, a, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kbytes,
                        static_cast<long long>(steps) * m, gc::kBM);
  if (!rc) rc = encode_sw128(&mb, bt, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, kbytes, n, gc::kBN);
  if (!rc) rc = encode_sw128(&mo, out, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, n,
                             static_cast<long long>(steps) * m, 64);
  if (rc) return rc;
  const int chunks = static_cast<int>(kbytes / gc::kKC);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kF32: return launch<kF32>(ma, mb, mo, n, chunks, static_cast<int>(tiles), ctas, s);
    case kBF16: return launch<kBF16>(ma, mb, mo, n, chunks, static_cast<int>(tiles), ctas, s);
    case kS8S32: return launch<kS8S32>(ma, mb, mo, n, chunks, static_cast<int>(tiles), ctas, s);
    default: return launch<kS8F32>(ma, mb, mo, n, chunks, static_cast<int>(tiles), ctas, s);
  }
}

}  // extern "C"
