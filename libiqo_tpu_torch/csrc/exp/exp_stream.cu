// Streaming probes for Hopper (sm_90a): how fast the card moves u8 and i32
// planes in and out (kernel A, stream_map<Op>) and folds a u8 plane that it
// reads whole into a narrow output (kernel B, readsum).
//
// Replaces the TPU kernels of scripts/exp_dma_ceiling.py: make_inc
// (pl.pallas_call at :57, x + 1 per element, u8 with wrap or i32), main's
// mix (:195, (x ^ 0x5A5A5A5A) + 1 on i32) and copy (:224, o = x), all as
// kernel A; and make_readsum (:73, fold all W columns of each row into 128
// lanes, & 255) as kernel B.  The Python side is
// libiqo_tpu_torch/experiments/exp_dma_ceiling.py.
//
// What bounds it on the H100: bytes alone.  Kernel A reads and writes each
// byte once (2 * H * W per application: 66.4 MB for the 8640 x 3840 rows,
// 19.8 us at the data sheet's 3.35 TB/s) and does one or two integer
// operations per 4 bytes; kernel B reads H * W and writes H * 128 bytes
// (8.6 MB for 2160 x 3840, 2.6 us).  A chain of 8.3 MB applications stays in
// the 50 MB L2, so those rows read the L2, not device memory, as the TPU
// script's 8.3 MB rows read VMEM.
//
// What the design does about it: every thread moves 16 bytes per load and
// store (uint4), neighbouring threads on neighbouring addresses, in a grid
// stride loop over a grid that fills the card several times over; the u8
// add wraps per byte in one SIMD instruction (__vadd4), so no element is
// widened.  Kernel B sums the bytes modulo 256 with __vadd4, which is `& 255`
// of the int32 sum and exact in any order, in two forms:
// * rows8 (readsum_kernel, the first form): 8 threads of 16 lanes a row, a
//   thread's W / 128 loads of 16 bytes issued 8 at a time; 270 blocks of 64
//   threads at 2160 rows, about 4 warps an SM, so at most ~16 KB of loads
//   are in flight on an SM, and the 270 blocks sit 2 on 126 SMs and 3 on 6;
// * warp (readsum_warp_kernel): one warp a row; lane t loads the row's
//   16-byte pieces t, t + 32, ... (240 at W = 3840), kWarpLoads of them
//   issued before their adds (predicated, with the streaming hint
//   ld.global.cs: the plane is read once).  32 = 0 mod 8, so every piece of
//   lane t lands on the 16 output lanes of group t % 8: the lane sums its
//   pieces, then folds with its three partners (t ^ 8, t ^ 16) by two
//   __shfl_xor_sync, and lanes 0-7 store 16 bytes each.  Blocks of one
//   warp, 2,160 at 2,160 rows, all resident at once (16 or 17 an SM): every
//   row of the plane is requested in the first microseconds (blocks of 2,
//   4 or 8 warps, two warps a row, plain __ldg loads, and a persistent grid
//   whose warps copied their rows by cp.async.bulk into rings in shared
//   memory all timed slower on the H100).
// Neither form stages anything in shared memory: there is no reuse to keep.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Op { kIncU8 = 0, kIncI32 = 1, kMixI32 = 2, kCopy = 3 };
constexpr uint32_t kMix = 0x5A5A5A5Au;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;      // 16 blocks of 256 per SM
constexpr int kReadsumLanes = 128;        // output lanes per row
constexpr int kReadsumRowsPerBlock = 8;   // 8 threads of 16 lanes per row
constexpr int kWarpLoads = 8;             // warp form: loads a lane issues before it adds

template <int kOp>
__device__ __forceinline__ uint32_t apply(uint32_t w) {
  if constexpr (kOp == kIncU8) return __vadd4(w, 0x01010101u);  // per-byte wrap
  if constexpr (kOp == kIncI32) return w + 1u;                  // uint32 wrap
  if constexpr (kOp == kMixI32) return (w ^ kMix) + 1u;
  return w;
}

template <int kOp>
__global__ void stream_map_kernel(const uint8_t* __restrict__ src,
                                  uint8_t* __restrict__ dst, long long nbytes) {
  const long long n16 = nbytes / 16;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += stride) {
    uint4 v = s[i];
    v.x = apply<kOp>(v.x);
    v.y = apply<kOp>(v.y);
    v.z = apply<kOp>(v.z);
    v.w = apply<kOp>(v.w);
    d[i] = v;
  }
  // the ragged tail (< 16 bytes): whole words for i32, bytes for u8
  if (blockIdx.x == 0) {
    const long long t = n16 * 16 + (long long)threadIdx.x * (kOp == kIncU8 || kOp == kCopy ? 1 : 4);
    if (t < nbytes) {
      if constexpr (kOp == kIncU8) {
        dst[t] = (uint8_t)(src[t] + 1);
      } else if constexpr (kOp == kCopy) {
        dst[t] = src[t];
      } else {
        *reinterpret_cast<uint32_t*>(dst + t) =
            apply<kOp>(*reinterpret_cast<const uint32_t*>(src + t));
      }
    }
  }
}

// out[r, l] = (sum over c of x[r, c * 128 + l]) & 255, for l < 128.
__global__ void readsum_kernel(const uint8_t* __restrict__ src,
                               uint8_t* __restrict__ dst, int h, int w) {
  const int row = blockIdx.x * kReadsumRowsPerBlock + threadIdx.x / 8;
  const int lane = (threadIdx.x % 8) * 16;
  if (row >= h) return;
  const uint8_t* p = src + (long long)row * w + lane;
  uint4 acc = make_uint4(0, 0, 0, 0);
  const int chunks = w / kReadsumLanes;
#pragma unroll 8
  for (int c = 0; c < chunks; ++c) {
    const uint4 v = *reinterpret_cast<const uint4*>(p + c * kReadsumLanes);
    acc.x = __vadd4(acc.x, v.x);
    acc.y = __vadd4(acc.y, v.y);
    acc.z = __vadd4(acc.z, v.z);
    acc.w = __vadd4(acc.w, v.w);
  }
  *reinterpret_cast<uint4*>(dst + (long long)row * kReadsumLanes + lane) = acc;
}

// lane t's sum of 16-byte pieces, folded over t, t ^ 8, t ^ 16, t ^ 24 (the
// lanes of one group of 16 output lanes); lanes 0-7 store the row's 128
__device__ __forceinline__ void fold_store(uint4 acc, uint8_t* __restrict__ dst, long long row,
                                           int lane) {
#pragma unroll
  for (int off = 8; off < 32; off *= 2) {
    acc.x = __vadd4(acc.x, __shfl_xor_sync(0xffffffffu, acc.x, off));
    acc.y = __vadd4(acc.y, __shfl_xor_sync(0xffffffffu, acc.y, off));
    acc.z = __vadd4(acc.z, __shfl_xor_sync(0xffffffffu, acc.z, off));
    acc.w = __vadd4(acc.w, __shfl_xor_sync(0xffffffffu, acc.w, off));
  }
  if (lane < 8) *reinterpret_cast<uint4*>(dst + row * kReadsumLanes + 16 * lane) = acc;
}

__device__ __forceinline__ void add4(uint4& acc, const uint4 v) {
  acc.x = __vadd4(acc.x, v.x);
  acc.y = __vadd4(acc.y, v.y);
  acc.z = __vadd4(acc.z, v.z);
  acc.w = __vadd4(acc.w, v.w);
}

// The warp form: block = warp = row; each round issues kWarpLoads loads
// (predicated) before it adds any.
__global__ void __launch_bounds__(32)
readsum_warp_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int w) {
  const int row = blockIdx.x, lane = threadIdx.x;
  const uint4* p = reinterpret_cast<const uint4*>(src + static_cast<long long>(row) * w);
  const int pieces = w / 16;
  uint4 acc = make_uint4(0, 0, 0, 0);
  for (int base = lane; base < pieces; base += kWarpLoads * 32) {
    uint4 v[kWarpLoads];
#pragma unroll
    for (int k = 0; k < kWarpLoads; ++k)
      v[k] = base + 32 * k < pieces ? __ldcs(p + base + 32 * k) : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < kWarpLoads; ++k) add4(acc, v[k]);
  }
  fold_store(acc, dst, row, lane);
}

int launch_check() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// Codes below 1000 are cudaError_t; these are the probes' own.
const char* iqo_exp_error_string(int code) {
  switch (code) {
    case 1001: return "unknown stream_map op";
    case 1002: return "pointer not 16-byte aligned";
    case 1003: return "width not a multiple of 128";
    case 1004: return "unknown mma kind";
    case 1005: return "mma shape not a multiple of the block tile";
    case 1006: return "unknown banded mode";
    case 1007: return "unknown probe form or variant";
    case 1008: return "probe geometry not supported";
    case 1009: return "cuTensorMapEncodeTiled refused the tensor map";
    case 1010: return "cuTensorMapEncodeTiled is not available";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

int iqo_exp_stream_map(int op, const void* src, void* dst, long long nbytes,
                       void* stream) {
  if ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) % 16)
    return 1002;
  if (nbytes <= 0) return 0;
  const long long n16 = nbytes / 16;
  long long blocks = (n16 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  auto s = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const uint8_t*>(src);
  auto out = static_cast<uint8_t*>(dst);
  switch (op) {
    case kIncU8: stream_map_kernel<kIncU8><<<blocks, kThreads, 0, s>>>(in, out, nbytes); break;
    case kIncI32: stream_map_kernel<kIncI32><<<blocks, kThreads, 0, s>>>(in, out, nbytes); break;
    case kMixI32: stream_map_kernel<kMixI32><<<blocks, kThreads, 0, s>>>(in, out, nbytes); break;
    case kCopy: stream_map_kernel<kCopy><<<blocks, kThreads, 0, s>>>(in, out, nbytes); break;
    default: return 1001;
  }
  return launch_check();
}

// Kernel B's warp form; iqo_exp_readsum is the rows8 form.
int iqo_exp_readsum_warp(const void* src, void* dst, int h, int w, void* stream) {
  if ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) % 16)
    return 1002;
  if (w % kReadsumLanes) return 1003;
  if (h <= 0) return 0;
  readsum_warp_kernel<<<h, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), w);
  return launch_check();
}

int iqo_exp_readsum(const void* src, void* dst, int h, int w, void* stream) {
  if ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) % 16)
    return 1002;
  if (w % kReadsumLanes) return 1003;
  if (h <= 0) return 0;
  const int blocks = (h + kReadsumRowsPerBlock - 1) / kReadsumRowsPerBlock;
  readsum_kernel<<<blocks, kReadsumRowsPerBlock * 8, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), h, w);
  return launch_check();
}

}  // extern "C"
