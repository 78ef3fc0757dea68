// Elementwise op-mix rate probe for Hopper (sm_90a), kernel K, op_mix<Mix, P>:
// on src (n) i32, with acc = 0 and P repeats (all wraps in uint32):
//   mad    v = v * 3 + 7, acc ^= v;
//   epi    m = (v + 32) >> 6, m = ((m + 32768) & 65535) - 32768 (the int16
//          wrap), acc ^= clip(m, 0, 255), v += 1  (the resize epilogue);
//   split  a = int8((v * 65536) >> 24), b = int8((v & 255) - 128),
//          acc ^= int32(a ^ b), v += 1  (the s8 work split);
// out (n) i32 = acc.
//
// Replaces the TPU kernel of scripts/exp_vpu_rate.py: build (pl.pallas_call
// at :50), 12 "arbitrary" grid steps of a (96, 1920) tile.  The steps carry
// no state, so the launch form is one block per (step, chunk of 1024
// elements): 256 threads, one thread per 4 elements (a 16-byte load and
// store), the P repeats unrolled in registers.  The Python side is
// libiqo_tpu_torch/experiments/exp_vpu_rate.py.
//
// What bounds it on the H100: bytes at small P, operations at large P.  One
// launch moves 8.85 MB in and 8.85 MB out (5.3 us at 3.35 TB/s); the script
// counts 2, 8 and 6 operations per element and repeat, so epi at P = 8 is
// 141 M int32 operations (8.4 us at 64 per clock per SM).  What the design
// does about it: 16-byte accesses and enough blocks to fill every SM; the
// ops are what the compiler makes of the mix (the SASS count is reported
// beside the time).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mix { kMad = 0, kEpi = 1, kSplit = 2 };
constexpr int kThreads = 256;

template <int kMix>
__device__ __forceinline__ void step(uint32_t& v, uint32_t& acc) {
  if constexpr (kMix == kMad) {
    v = v * 3u + 7u;
    acc ^= v;
  } else if constexpr (kMix == kEpi) {
    int m = static_cast<int>(v + 32u) >> 6;
    m = ((m + 32768) & 65535) - 32768;
    acc ^= static_cast<uint32_t>(min(max(m, 0), 255));
    v += 1u;
  } else {
    const int8_t a = static_cast<int8_t>(static_cast<int>(v * 65536u) >> 24);
    const int8_t b = static_cast<int8_t>(static_cast<int>(v & 255u) - 128);
    acc ^= static_cast<uint32_t>(static_cast<int>(static_cast<int8_t>(a ^ b)));
    v += 1u;
  }
}

template <int kMix, int kP>
__global__ void __launch_bounds__(kThreads)
op_mix_kernel(const int4* __restrict__ src, int4* __restrict__ out, int n4) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n4) return;
  const int4 x = __ldg(src + i);
  uint32_t v[4] = {static_cast<uint32_t>(x.x), static_cast<uint32_t>(x.y),
                   static_cast<uint32_t>(x.z), static_cast<uint32_t>(x.w)};
  uint32_t acc[4] = {0, 0, 0, 0};
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) step<kMix>(v[j], acc[j]);
  out[i] = make_int4(static_cast<int>(acc[0]), static_cast<int>(acc[1]),
                     static_cast<int>(acc[2]), static_cast<int>(acc[3]));
}

template <int kMix>
int launch_mix(int p, const int4* src, int4* out, int n4, cudaStream_t s) {
  const int blocks = (n4 + kThreads - 1) / kThreads;
  switch (p) {
    case 1: op_mix_kernel<kMix, 1><<<blocks, kThreads, 0, s>>>(src, out, n4); break;
    case 4: op_mix_kernel<kMix, 4><<<blocks, kThreads, 0, s>>>(src, out, n4); break;
    case 8: op_mix_kernel<kMix, 8><<<blocks, kThreads, 0, s>>>(src, out, n4); break;
    default: return 1008;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kernel K: src, out (n) i32, n a multiple of 4, P in {1, 4, 8}.
int iqo_exp_op_mix(int mix, int p, const void* src, void* out, long long n, void* stream) {
  if (mix < kMad || mix > kSplit) return 1007;
  if (n <= 0 || n % 4 || n / 4 > 0x7fffffff) return 1008;
  if ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out)) % 16) return 1002;
  auto s = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const int4*>(src);
  auto o = static_cast<int4*>(out);
  const int n4 = static_cast<int>(n / 4);
  switch (mix) {
    case kMad: return launch_mix<kMad>(p, in, o, n4, s);
    case kEpi: return launch_mix<kEpi>(p, in, o, n4, s);
    default: return launch_mix<kSplit>(p, in, o, n4, s);
  }
}

}  // extern "C"
