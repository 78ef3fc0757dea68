// Window legality probes for Hopper (sm_90a), kernel M: the port's first TMA
// and bulk copies.
//
// window_x1: on a (160, 640) i32 source, or a batch of them, tile (ty, tx)
//   of a (4, 4) grid loads a (64, 256) window at (clamp(32 ty - 32, 0, 96),
//   clamp(128 tx - 128, 0, 384)) as one TMA box (cp.async.bulk.tensor.2d, or
//   .3d for the batch, completing on an mbarrier; the coordinates clamped in
//   the kernel from blockIdx, as the TPU index map clamps them) and writes the
//   window's top-left (32, 128) to out tile (ty, tx): out (128, 512) i32 per
//   plane.  Two forms: window_x1_boxes (form="boxes", the default) splits
//   each tile's window into 8 boxes of (64, 32) at the same clamped
//   coordinates, one a block of 128 threads (128 blocks, 384 for the batch
//   through the 3-D map), and the 4 blocks whose boxes cover the window's
//   columns 0-127 write their (32, 32) of the corner; window_x1_kernel
//   (form="single") is the first form, one block of 256 threads per (tx, ty,
//   plane) landing the whole window as one 64 KB box before any store, the
//   fault X2's split form removed.
// window_x2: the (64, 256) window at row 128 of the (160, 640) source: its
//   last 32 rows lie past the end, and TMA fills them with zeros
//   (CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE).  Rows 0-31, columns 0-127 (inside the
//   source) go to out (32, 128); `spill`, if given, takes the whole window, so
//   that the caller can see what the rows past the end held.  Two forms:
//   window_x2_boxes (form="boxes", the default) splits the window into 8
//   boxes of (64, 32), one a block of 128 threads, each box starting at row
//   128 and running past the end, each block writing its columns of out
//   (boxes 0-3) and of spill; window_x2_kernel (form="single") is the first
//   form, one block loading the whole window as one 64 KB box, 256 threads
//   copying out.  The single box's 64 KB landing in one SM before any store
//   starts is what kept it behind src[128:160, :128].clone() (1.117x): the
//   split form lands 8 KB in each of 8 SMs at once.
// window_x3: the TPU's sequential grid of 4 with its scratch carried from
//   step 0, as one block looping over t: at t = 0 one 1-D bulk copy
//   (cp.async.bulk global -> shared on an mbarrier, the counterpart of
//   make_async_copy and its DMA semaphore) of var (3, 64, 256) f32, 192 KB of
//   dynamic shared memory; step t writes scratch[v(t)], v = 0, 1, 1, 2
//   computed at run time (the loop is not unrolled), to out[t]
//   (form="serial").
// window_x3_cluster (form="cluster", the default): the sequential grid of 4
//   as a thread block cluster of 4 blocks, block rank t taking step t, whose
//   scratch is read through the cluster's distributed shared memory.  The 64
//   rows split into 16 row chunks, one cluster each (64 blocks of 128
//   threads).  Rank 0 fills its cluster's scratch once, at the start: one
//   cp.async.bulk a variant slice (the chunk's 4 rows of variant v, 4 KB)
//   into its own shared memory, all completing on its mbarrier.  After a
//   cluster barrier, rank t computes v = 0, 1, 1, 2 at run time, reads
//   scratch[v] from rank 0 (mapa + ld.shared::cluster) and writes out[t]'s
//   rows of the chunk; a split cluster barrier (arrive after the reads, wait
//   after the stores) keeps rank 0 until every peer has read.  No rank loads
//   its own slice from global memory: the question stays whether a scratch
//   filled once, asynchronously, can be read under a run-time index from a
//   later step.  (Slices spread over ranks 0-2 would need one more cluster
//   barrier before the copies, for every owner's mbarrier to be initialised,
//   on the critical path.)
//
// Replaces the TPU kernels of scripts/exp_element_clamp.py: run_x1
// (pl.pallas_call at :44), run_x2 (:83) and run_x3 (:127).  The Python side
// is libiqo_tpu_torch/experiments/exp_element_clamp.py.
//
// The tensor maps are encoded on the host by cuTensorMapEncodeTiled, fetched
// through cudaGetDriverEntryPoint (hopper.cuh, with the mbarrier and TMA
// helpers), so the library keeps its one nvcc -shared command and links no
// libcuda; each map is a __grid_constant__ parameter.
//
// What bounds them on the H100: launch latency.  X1 moves 262 KB (786 KB
// for the batch of 3), X2 32 KB, X3 448 KB: under a microsecond at 3.35
// TB/s.  The probes ask whether the copies are legal and right, not how fast.
// X3's serial form pushes its 448 KB through one SM; the cluster form
// spreads them over 64 blocks, 4 KB in and 4 KB out each.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kH = 160, kW = 640;
constexpr int kTH = 32, kTW = 128, kBandH = 64, kBandW = 256;
constexpr int kNTy = 4, kNTx = 4;
constexpr int kHiH = (kH - kBandH) / 32 * 32, kHiW = (kW - kBandW) / 128 * 128;
constexpr int kOutH = kNTy * kTH, kOutW = kNTx * kTW;
constexpr int kBoxBytes = kBandH * kBandW * 4;
constexpr int kNVar = 3, kA = 64, kB = 256;
constexpr int kVarBytes = kNVar * kA * kB * 4;
constexpr int kAlign = 128;                 // TMA's shared-memory destination alignment
constexpr int kThreads = 256;
constexpr int kX2Boxes = 8;                 // boxes of X1's and X2's split forms, one a block
constexpr int kX2BoxW = kBandW / kX2Boxes;  // 32 columns: 128 bytes a box row
constexpr int kX2Threads = 128;

__device__ __forceinline__ uint8_t* aligned(uint8_t* p) {
  const uint32_t s = smem_addr(p);
  return p + ((kAlign - s % kAlign) % kAlign);
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int x, int y, int z,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z),
         "r"(smem_addr(bar)) : "memory");
}

// rows x cols i32 from box (256 wide) to dst (pitch wide), 16 bytes a thread
__device__ __forceinline__ void copy_out(const int32_t* box, int32_t* dst, int rows, int cols,
                                         int pitch) {
  for (int i = threadIdx.x; i < rows * cols / 4; i += kThreads) {
    const int r = i / (cols / 4), c = 4 * (i % (cols / 4));
    *reinterpret_cast<int4*>(dst + (long long)r * pitch + c) =
        *reinterpret_cast<const int4*>(box + r * kBandW + c);
  }
}

template <bool kBatched>
__global__ void __launch_bounds__(kThreads)
window_x1_kernel(const __grid_constant__ CUtensorMap map, int32_t* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  int32_t* box = reinterpret_cast<int32_t*>(aligned(smem_raw));
  const int tx = blockIdx.x, ty = blockIdx.y, plane = blockIdx.z;
  const int oy = max(0, min(kHiH, ty * kTH - 32)), ox = max(0, min(kHiW, tx * kTW - 128));
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(&bar, kBoxBytes);
    if constexpr (kBatched)
      tma_3d(box, &map, ox, oy, plane, &bar);
    else
      tma_2d(box, &map, ox, oy, &bar);
  }
  mbar_wait(&bar, 0);
  copy_out(box, out + (long long)plane * kOutH * kOutW + (long long)ty * kTH * kOutW + tx * kTW,
           kTH, kTW, kOutW);
}

// X1's split form: block (8 tx + j, ty, plane) loads the (64, 32) box at
// column ox + 32 j, row oy of tile (ty, tx)'s clamped window; boxes 0-3 (the
// window's columns 0-127) write their rows 0-31 to the tile's corner.
template <bool kBatched>
__global__ void __launch_bounds__(kX2Threads)
window_x1_boxes_kernel(const __grid_constant__ CUtensorMap map, int32_t* __restrict__ out) {
  __shared__ __align__(kAlign) int32_t box[kBandH * kX2BoxW];
  __shared__ __align__(8) uint64_t bar;
  const int j = blockIdx.x % kX2Boxes, tx = blockIdx.x / kX2Boxes, ty = blockIdx.y;
  const int plane = blockIdx.z;
  const int oy = max(0, min(kHiH, ty * kTH - 32)), ox = max(0, min(kHiW, tx * kTW - 128));
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
    mbar_expect(&bar, sizeof(box));
    if constexpr (kBatched)
      tma_3d(box, &map, ox + j * kX2BoxW, oy, plane, &bar);
    else
      tma_2d(box, &map, ox + j * kX2BoxW, oy, &bar);
  }
  __syncthreads();                                // the barrier is initialised
  mbar_wait(&bar, 0);
  if (j * kX2BoxW >= kTW) return;                 // past the corner's columns
  constexpr int kRowVecs = kX2BoxW / 4;
  int32_t* dst = out + (long long)plane * kOutH * kOutW + (long long)ty * kTH * kOutW +
                 tx * kTW + j * kX2BoxW;
  for (int i = threadIdx.x; i < kTH * kRowVecs; i += kX2Threads) {
    const int r = i / kRowVecs, c = 4 * (i % kRowVecs);
    *reinterpret_cast<int4*>(dst + r * kOutW + c) =
        *reinterpret_cast<const int4*>(box + r * kX2BoxW + c);
  }
}

__global__ void __launch_bounds__(kThreads)
window_x2_kernel(const __grid_constant__ CUtensorMap map, int32_t* __restrict__ out,
                 int32_t* __restrict__ spill) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  int32_t* box = reinterpret_cast<int32_t*>(aligned(smem_raw));
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect(&bar, kBoxBytes);                 // the whole box, zeros included
    tma_2d(box, &map, 0, (kH - 32) / 32 * 32, &bar);
  }
  mbar_wait(&bar, 0);
  copy_out(box, out, 32, kTW, kTW);
  if (spill != nullptr) copy_out(box, spill, kBandH, kBandW, kBandW);
}

// X2's split form: block b loads the (64, 32) box at (column 32 b, row 128)
// and writes its rows 0-31 to out's columns [32 b, 32 b + 32) where they
// lie inside out's 128, and the whole box to spill's columns.
__global__ void __launch_bounds__(kX2Threads)
window_x2_boxes_kernel(const __grid_constant__ CUtensorMap map, int32_t* __restrict__ out,
                       int32_t* __restrict__ spill) {
  __shared__ __align__(kAlign) int32_t box[kBandH * kX2BoxW];
  __shared__ __align__(8) uint64_t bar;
  const int c0 = blockIdx.x * kX2BoxW;
  if (threadIdx.x == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
    mbar_expect(&bar, sizeof(box));               // the whole box, zeros included
    tma_2d(box, &map, c0, (kH - 32) / 32 * 32, &bar);
  }
  __syncthreads();                                // the barrier is initialised
  mbar_wait(&bar, 0);
  constexpr int kRowVecs = kX2BoxW / 4;
  if (c0 < kTW) {
    for (int i = threadIdx.x; i < 32 * kRowVecs; i += kX2Threads) {
      const int r = i / kRowVecs, c = 4 * (i % kRowVecs);
      *reinterpret_cast<int4*>(out + r * kTW + c0 + c) =
          *reinterpret_cast<const int4*>(box + r * kX2BoxW + c);
    }
  }
  if (spill != nullptr) {
    for (int i = threadIdx.x; i < kBandH * kRowVecs; i += kX2Threads) {
      const int r = i / kRowVecs, c = 4 * (i % kRowVecs);
      *reinterpret_cast<int4*>(spill + r * kBandW + c0 + c) =
          *reinterpret_cast<const int4*>(box + r * kX2BoxW + c);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
window_x3_kernel(const float* __restrict__ var, float* __restrict__ out, int steps) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  float* scratch = reinterpret_cast<float*>(aligned(smem_raw));
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    if (t == 0) {
      if (threadIdx.x == 0) {
        mbar_init(&bar, 1);
        mbar_fence_init();
        mbar_expect(&bar, kVarBytes);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n"
            :: "r"(smem_addr(scratch)), "l"(reinterpret_cast<uint64_t>(var)), "r"(kVarBytes), "r"(smem_addr(&bar))
            : "memory");
      }
      __syncthreads();                            // the barrier is initialised
      mbar_wait(&bar, 0);
    }
    const int v = t == 0 ? 0 : (t == 3 ? 2 : 1);
    const float* src = scratch + v * kA * kB;
    float* dst = out + (long long)t * kA * kB;
    for (int i = threadIdx.x; i < kA * kB / 4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
  }
}

constexpr int kX3Steps = 4;                 // blocks of a cluster: the TPU grid's steps
constexpr int kX3Rows = 4;                  // rows of each variant a cluster takes
constexpr int kX3Chunks = kA / kX3Rows;     // clusters: 16
constexpr int kX3SliceBytes = kX3Rows * kB * 4;
constexpr int kX3Threads = 128;
constexpr int kX3PerThread = kX3Rows * kB / 4 / kX3Threads;   // float4 a thread

// v(t) of the TPU kernel: 0, 1, 1, 2
__device__ __forceinline__ uint32_t x3_variant(uint32_t t) { return t == 0 ? 0 : (t == 3 ? 2 : 1); }

__global__ void __launch_bounds__(kX3Threads)
window_x3_cluster_kernel(const float* __restrict__ var, float* __restrict__ out) {
  __shared__ __align__(128) float scratch[kNVar][kX3Rows * kB];   // rank 0's: 12 KB
  __shared__ __align__(8) uint64_t bar;
  const uint32_t t = cluster_rank();
  const int chunk = blockIdx.y;
  if (t == 0) {                               // rank 0 fills the whole scratch, once
    if (threadIdx.x == 0) {
      mbar_init(&bar, 1);
      mbar_fence_init();
      mbar_expect(&bar, kNVar * kX3SliceBytes);
      for (int v = 0; v < kNVar; ++v)
        bulk_copy_cluster(smem_addr(scratch[v]), var + (v * kA + chunk * kX3Rows) * kB,
                          kX3SliceBytes, smem_addr(&bar));
    }
    __syncthreads();                          // the barrier is initialised
    mbar_wait(&bar, 0);
  }
  cluster_sync();                             // the scratch has landed; every rank reads it
  const uint32_t src = map_rank(scratch[x3_variant(t)], 0);
  float4 v[kX3PerThread];
#pragma unroll
  for (int i = 0; i < kX3PerThread; ++i)
    v[i] = ld_cluster_f4(src + 16 * (threadIdx.x + i * kX3Threads));
  cluster_arrive();                           // this block's reads of rank 0 are done
  float4* dst = reinterpret_cast<float4*>(out + (static_cast<long long>(t) * kA +
                                                 chunk * kX3Rows) * kB);
#pragma unroll
  for (int i = 0; i < kX3PerThread; ++i) dst[threadIdx.x + i * kX3Threads] = v[i];
  cluster_wait();                             // rank 0 stays until every read is done
}

// A map of `planes` (160, 640) i32 planes (2-D when planes == 0) with a
// (64, box_w) box, out-of-bounds elements read as zeros.
int encode(CUtensorMap* map, const void* src, int planes, int box_w = kBandW) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return 1010;
  const cuuint64_t dims[3] = {kW, kH, static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {kW * 4ull, kW * kH * 4ull};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_w), kBandH, 1};
  const cuuint32_t estrides[3] = {1, 1, 1};
  const CUresult rc = fn(map, CU_TENSOR_MAP_DATA_TYPE_INT32, planes ? 3 : 2,
                         const_cast<void*>(src), dims, strides, box, estrides,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : 1009;
}

constexpr int kBoxSmem = kBoxBytes + kAlign;
constexpr int kVarSmem = kVarBytes + kAlign;

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

extern "C" {

// Raise kernel M's dynamic shared-memory limits on the current device.
int iqo_exp_window_setup() {
  int rc = static_cast<int>(cudaFuncSetAttribute(
      window_x1_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBoxSmem));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      window_x1_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBoxSmem));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      window_x2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBoxSmem));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      window_x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kVarSmem));
  return rc;
}

// X1: src (160, 640) i32, or (planes, 160, 640) when planes > 0 -> out
// (128, 512), or (planes, 128, 512).  form 0: the split form (8 boxes of
// (64, 32) a tile, one a block); 1: one (64, 256) box a tile.
int iqo_exp_window_x1(int form, const void* src, void* out, int planes, void* stream) {
  if ((form != 0 && form != 1) || planes < 0) return 1008;
  if (misaligned(src) || misaligned(out)) return 1002;
  CUtensorMap map;
  if (const int rc = encode(&map, src, planes, form == 0 ? kX2BoxW : kBandW)) return rc;
  auto s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<int32_t*>(out);
  if (form == 0) {
    const dim3 grid(kNTx * kX2Boxes, kNTy, planes ? planes : 1);
    if (planes)
      window_x1_boxes_kernel<true><<<grid, kX2Threads, 0, s>>>(map, o);
    else
      window_x1_boxes_kernel<false><<<grid, kX2Threads, 0, s>>>(map, o);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(kNTx, kNTy, planes ? planes : 1);
  if (planes)
    window_x1_kernel<true><<<grid, kThreads, kBoxSmem, s>>>(map, o);
  else
    window_x1_kernel<false><<<grid, kThreads, kBoxSmem, s>>>(map, o);
  return static_cast<int>(cudaGetLastError());
}

// X2: src (160, 640) i32 -> out (32, 128); spill (64, 256) or NULL.  form
// 0: the split form (8 boxes of (64, 32), 8 blocks); 1: one (64, 256) box.
int iqo_exp_window_x2(int form, const void* src, void* out, void* spill, void* stream) {
  if (form != 0 && form != 1) return 1008;
  if (misaligned(src) || misaligned(out) || (spill != nullptr && misaligned(spill))) return 1002;
  CUtensorMap map;
  if (const int rc = encode(&map, src, 0, form == 0 ? kX2BoxW : kBandW)) return rc;
  const auto s = static_cast<cudaStream_t>(stream);
  if (form == 0)
    window_x2_boxes_kernel<<<kX2Boxes, kX2Threads, 0, s>>>(
        map, static_cast<int32_t*>(out), static_cast<int32_t*>(spill));
  else
    window_x2_kernel<<<1, kThreads, kBoxSmem, s>>>(
        map, static_cast<int32_t*>(out), static_cast<int32_t*>(spill));
  return static_cast<int>(cudaGetLastError());
}

// X3: var (3, 64, 256) f32 -> out (steps, 64, 256), steps <= 4.
int iqo_exp_window_x3(const void* var, void* out, int steps, void* stream) {
  if (steps < 1 || steps > 4) return 1008;
  if (misaligned(var) || misaligned(out)) return 1002;
  window_x3_kernel<<<1, kThreads, kVarSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(var), static_cast<float*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}

// X3, cluster form: var (3, 64, 256) f32 -> out (4, 64, 256), as 16
// clusters of 4 blocks.  A cluster launch the card refuses returns its error.
int iqo_exp_window_x3_cluster(const void* var, void* out, void* stream) {
  if (misaligned(var) || misaligned(out)) return 1002;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kX3Steps, kX3Chunks, 1);
  cfg.blockDim = dim3(kX3Threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kX3Steps;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, window_x3_cluster_kernel,
                                            static_cast<const float*>(var),
                                            static_cast<float*>(out));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(rc != cudaSuccess ? rc : last);
}

}  // extern "C"
