// Kernel J's float32 variants redesigned for Hopper (sm_90a): corr_f32 and
// muls_f32 of vpu_xpass_tile (exp_xpass.cu), form="wide".
//
// out (160, 384) i32 = sum_{r < reps} body(we + r, wo + r) on we, wo
// (160, 512) i32 and 12 integer taps C, the float32 variants of
// scripts/exp_vpu_xpass.py's body_of:
//   corr_f32  per plane p of (x >> 8, x & 255), in float32 and the script's
//             source order, t_k = C[2k] e_p[c + k] + C[2k + 1] o_p[c + k],
//             s_p = t_0 + t_1 + ... + t_5, then int(s_hi) * 256 + int(s_lo);
//   muls_f32  the same sum on the unshifted values, int(s).
// Replaces the TPU kernel of scripts/exp_vpu_xpass.py, make (pl.pallas_call
// at :156), for these two variants; the Python side is
// libiqo_tpu_torch/experiments/exp_vpu_xpass.py, the thread map and its
// NumPy model libiqo_tpu_torch/experiments/vpu_f32.py.
//
// What bounds it on the H100: operations.  Per output and repeat corr_f32
// needs 24 FMUL and 22 FADD, muls_f32 12 and 11, on the 128-a-clock FP32
// pipe; int <-> float conversions run at 16 a clock an SM.  The serial form
// (vpu_xpass_kernel<kCorrF32 / kMulsF32>) converts 36 work values a repeat
// for 4 outputs (8 for muls_f32) that way, and ran one warp a scheduler on
// 120 SMs.  This form:
//   * converts int -> float on the FP32 pipe: for |v| < 2^22,
//     __int_as_float(0x4B400000 + v) - 1.5 * 2^23 == (float)v exactly (the
//     work values, and corr_f32's high plane x >> 8), and for a byte b,
//     __int_as_float(0x4B000000 | b) - 2^23 == (float)b (the low plane
//     x & 255, the byte placed by one byte permute).  One integer op and one
//     FADD a value, where the serial form issues I2FP.F32.S32 (16 a clock
//     an SM).
//     A warp takes this path only if every work value of its lanes has
//     |v| + reps < 2^22 (decided once, before the repeat loop, by
//     __all_sync); any other warp converts with I2F, so the form is exact on
//     every input the plain version takes.  float -> int stays
//     __float2int_rz, which saturates (muls_f32's sums pass 2^31);
//   * fills the card: a thread keeps corr_f32's sharing of 9 + 9 work values
//     among 4 adjacent outputs (muls_f32, which shares nothing, takes the
//     same map), and the 3 warps of a block split the repeats in contiguous
//     thirds over the same 128 outputs (one third of a row): 480 blocks of
//     96 threads, 1440 warps, 10.9 an SM on 132 SMs; the thirds' uint32 sums
//     meet in shared memory at the end.  Three, because R = 24 and R / 8 = 3
//     (the probe's slope) both split evenly;
//   * keeps the arithmetic bit for bit: __fmul_rn / __fadd_rn in the
//     script's order, no contraction, and the loop-carried + r applied to the
//     work values before the split, so the conversions run in every repeat;
//     the sums over repeats are uint32 (the intended int32 wraps).
// (Two outputs a thread, sharing converted values between lanes by shuffle
// or staging converted planes in shared memory, comes within 12 % of this on
// paper and needs shuffles, halo lanes or a barrier a repeat: vpu_f32.py
// states the counts.)

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kTH = 160, kTW = 384, kWdi = 512, kTaps = 12, kHalf = 6;
constexpr int kOuts = 4;                   // adjacent outputs a thread
constexpr int kSlices = 3;                 // warps of a block: thirds of the repeats
constexpr int kLanes = 32;
constexpr int kThreads = kLanes * kSlices;
constexpr int kParts = kSlices > 1 ? kSlices - 1 : 1;   // slices handing their sums over
constexpr int kBlockCols = kOuts * kLanes; // outputs of one row a block
constexpr int kBlocksPerRow = kTW / kBlockCols;
constexpr int kBlocks = kTH * kBlocksPerRow;
constexpr uint32_t kByteBits = 0x4B000000; // 2^23's exponent, above a byte
constexpr int kFit = 1 << 22;              // |v| + reps below this: the exponent trick
constexpr float kBias22 = 12582912.0f;     // 1.5 * 2^23
constexpr float kBias23 = 8388608.0f;      // 2^23

enum F32Variant { kCorr = 0, kMuls = 1 };

struct Taps {
  int c[kTaps];
};

// (float)v for |v| < 2^22, on the FP32 pipe
__device__ __forceinline__ float exact_f32(int v) {
  return __fsub_rn(__int_as_float(0x4B400000 + v), kBias22);
}

// (float)(v & 255): one byte permute puts v's low byte under the exponent
// bits `bits` (kByteBits, held in a register: with both it and the selector
// constant, the compiler keeps the selector in a register and copies it
// before every permute; a mask and an OR take two LOP3)
__device__ __forceinline__ float byte_f32(int v, uint32_t bits) {
  return __fsub_rn(__int_as_float(__byte_perm(v, bits, 0x7440)), kBias23);
}

template <bool kFast>
__device__ __forceinline__ float to_f32(int v) {
  if constexpr (kFast) return exact_f32(v);
  return static_cast<float>(v);
}

// corr_f32's planes of a repeat's work value x: x >> 8 and x & 255
template <bool kFast>
__device__ __forceinline__ float high_plane(int v) {
  return to_f32<kFast>(v >> 8);
}

template <bool kFast>
__device__ __forceinline__ float low_plane(int v, uint32_t bits) {
  if constexpr (kFast) return byte_f32(v, bits);
  return static_cast<float>(v & 255);
}

// s = t_0 + ... + t_5, t_k = ce_k a_k + co_k b_k, in the script's order
__device__ __forceinline__ float tap_sum(const float (&ce)[kHalf], const float (&co)[kHalf],
                                         const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    const float t = __fadd_rn(__fmul_rn(ce[k], a[k]), __fmul_rn(co[k], b[k]));
    s = k == 0 ? t : __fadd_rn(s, t);
  }
  return s;
}

// Repeats [r0, r1) of this thread's outputs into acc.
template <int kV, bool kFast, int kN>
__device__ __forceinline__ void run_repeats(const int (&ve)[kN], const int (&vo)[kN],
                                            const float (&ce)[kHalf], const float (&co)[kHalf],
                                            uint32_t bits, int r0, int r1,
                                            uint32_t (&acc)[kOuts]) {
#pragma unroll 1
  for (int r = r0; r < r1; ++r) {
    if constexpr (kV == kCorr) {
      float eh[kN], el[kN], oh[kN], ol[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) {        // + r before the split (int32 wraps)
        const int xe = static_cast<int>(static_cast<uint32_t>(ve[j]) + r);
        const int xo = static_cast<int>(static_cast<uint32_t>(vo[j]) + r);
        eh[j] = high_plane<kFast>(xe);
        el[j] = low_plane<kFast>(xe, bits);
        oh[j] = high_plane<kFast>(xo);
        ol[j] = low_plane<kFast>(xo, bits);
      }
#pragma unroll
      for (int c = 0; c < kOuts; ++c) {
        const float h = tap_sum(ce, co, eh + c, oh + c);
        const float l = tap_sum(ce, co, el + c, ol + c);
        acc[c] += static_cast<uint32_t>(__float2int_rz(h)) * 256u +
                  static_cast<uint32_t>(__float2int_rz(l));
      }
    } else {
#pragma unroll
      for (int c = 0; c < kOuts; ++c) {
        const float a = to_f32<kFast>(static_cast<int>(static_cast<uint32_t>(ve[c]) + r));
        const float b = to_f32<kFast>(static_cast<int>(static_cast<uint32_t>(vo[c]) + r));
        float av[kHalf], bv[kHalf];
#pragma unroll
        for (int k = 0; k < kHalf; ++k) av[k] = a, bv[k] = b;
        acc[c] += static_cast<uint32_t>(__float2int_rz(tap_sum(ce, co, av, bv)));
      }
    }
  }
}

template <int kV>
__global__ void __launch_bounds__(kThreads)
vpu_f32_wide_kernel(const int32_t* __restrict__ we, const int32_t* __restrict__ wo, Taps taps,
                    uint32_t byte_bits, int32_t* __restrict__ out, int reps) {
  constexpr int kN = kV == kCorr ? kOuts + kHalf - 1 : kOuts;    // work values a thread
  __shared__ uint32_t part[kParts][kOuts][kLanes];
  const int slice = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int row = blockIdx.x / kBlocksPerRow;
  const int c0 = kBlockCols * (blockIdx.x % kBlocksPerRow) + kOuts * lane;
  int ve[kN], vo[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    ve[j] = we[row * kWdi + c0 + j];
    vo[j] = wo[row * kWdi + c0 + j];
  }
  float ce[kHalf], co[kHalf];
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    ce[k] = static_cast<float>(taps.c[2 * k]);
    co[k] = static_cast<float>(taps.c[2 * k + 1]);
  }
  // the warp's path, decided once: every value with |v| + reps < 2^22
  bool fits = true;
#pragma unroll
  for (int j = 0; j < kN; ++j)
    fits &= llabs(static_cast<long long>(ve[j])) + reps < kFit &&
            llabs(static_cast<long long>(vo[j])) + reps < kFit;
  const bool fast = __all_sync(0xffffffffu, fits);
  const int r0 = static_cast<int>(static_cast<long long>(reps) * slice / kSlices);
  const int r1 = static_cast<int>(static_cast<long long>(reps) * (slice + 1) / kSlices);
  uint32_t acc[kOuts] = {};
  if (fast)
    run_repeats<kV, true>(ve, vo, ce, co, byte_bits, r0, r1, acc);
  else
    run_repeats<kV, false>(ve, vo, ce, co, byte_bits, r0, r1, acc);
  if (slice > 0) {
#pragma unroll
    for (int c = 0; c < kOuts; ++c) part[slice - 1][c][lane] = acc[c];
  }
  __syncthreads();
  if (slice == 0) {
#pragma unroll
    for (int c = 0; c < kOuts; ++c) {
#pragma unroll
      for (int p = 0; p < kSlices - 1; ++p) acc[c] += part[p][c][lane];
      out[row * kTW + c0 + c] = static_cast<int32_t>(acc[c]);
    }
  }
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

extern "C" {

// Kernel J, float32 variants, wide form: variant 0 corr_f32, 1 muls_f32; we,
// wo (160, 512) i32, 12 taps (host array) -> out (160, 384) i32.
int iqo_exp_vpu_f32_wide(int variant, const void* we, const void* wo, const int* taps, void* out,
                         int reps, void* stream) {
  if (variant != kCorr && variant != kMuls) return 1007;
  if (reps < 1) return 1008;
  if (misaligned(we) || misaligned(wo) || misaligned(out)) return 1002;
  Taps t;
  for (int i = 0; i < kTaps; ++i) t.c[i] = taps[i];
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int32_t*>(we);
  auto b = static_cast<const int32_t*>(wo);
  auto o = static_cast<int32_t*>(out);
  if (variant == kCorr)
    vpu_f32_wide_kernel<kCorr><<<kBlocks, kThreads, 0, s>>>(a, b, t, kByteBits, o, reps);
  else
    vpu_f32_wide_kernel<kMuls><<<kBlocks, kThreads, 0, s>>>(a, b, t, kByteBits, o, reps);
  return static_cast<int>(cudaGetLastError());
}

// The compiled thread map: outputs a thread, slices (warps) a block,
// threads a block, blocks; 0.
int iqo_exp_vpu_f32_shape(int* shape) {
  shape[0] = kOuts;
  shape[1] = kSlices;
  shape[2] = kThreads;
  shape[3] = kBlocks;
  return 0;
}

}  // extern "C"
