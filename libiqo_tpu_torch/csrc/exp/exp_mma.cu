// Tensor-core rate probe for Hopper (sm_90a), kernel C, mma_steps<Kind>:
// out[t] = a[t] @ b for every step t, a (steps, M, K), b (K, N) held K-major
// as bt (N, K), in four input/accumulator pairs:
// * kF32: float32 inputs on the TF32 path, mma.sync m16n8k8, f32 sums;
// * kBF16: bf16 inputs, mma.sync m16n8k16, f32 sums;
// * kS8S32: int8 inputs, mma.sync m16n8k32, int32 sums;
// * kS8F32: int8 inputs, the same int32 sums, converted to f32 at the store
//   (Hopper has no int8 -> f32 product).
//
// Replaces the TPU kernel of scripts/exp_int8_mxu.py: make (pl.pallas_call
// at :29), `a_ref[...] @ b_ref[...]` with preferred_element_type over a grid
// of STEPS, b resident.  The Python side is
// libiqo_tpu_torch/experiments/exp_int8_mxu.py.
//
// What bounds it on the H100: at the script's shapes (64 x (256, 1024) @
// (1024, 512)) bytes, for all rows but the f32 one.  bf16 moves 68.2 MB (a,
// b and the f32 output once each; 20.3 us at 3.35 TB/s) for 17.2 G
// operations (17.4 us at 989 TFLOP/s); s8 -> s32 moves 50.9 MB (15.2 us)
// for the same operations (8.7 us at 1,979 TOP/s); the f32 row moves
// 102.8 MB (30.7 us) but its TF32 operations take 34.7 us at 495 TFLOP/s.
//
// What the design does about it: the simple form.  A block of 4 warps owns
// a 64 x 64 output tile of one step and walks K in 128-byte chunks through
// shared memory, double-buffered in registers (the next chunk's 16-byte
// loads are issued before the current chunk's products).  The three
// fragment layouts coincide byte for byte (each mma consumes 32 bytes of K:
// 8 tf32, 16 bf16 or 32 int8), so one load path feeds all of them; rows are
// padded to 144 bytes so that a warp's fragment loads hit 32 distinct banks.
// Each warp runs 2 x 4 mma tiles of 16 x 8 per 32 bytes of K.  No TMA, no
// wgmma and no warp specialisation: those are for a later, faster form.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

enum Kind { kF32 = 0, kBF16 = 1, kS8S32 = 2, kS8F32 = 3 };
constexpr int kBM = 64, kBN = 64;       // block tile
constexpr int kChunk = 128;             // bytes of K per shared-memory stage
constexpr int kPitch = kChunk + 16;     // padded row pitch, bytes
constexpr int kThreads = 128;           // 4 warps, 2 x 2, 32 x 32 each

__device__ __forceinline__ uint32_t to_tf32(uint32_t f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(__uint_as_float(f)));
  return r;
}

template <int kKind, typename Acc>
__device__ __forceinline__ void mma(Acc (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  if constexpr (kKind == kF32) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(to_tf32(a[0])), "r"(to_tf32(a[1])), "r"(to_tf32(a[2])),
          "r"(to_tf32(a[3])), "r"(to_tf32(b[0])), "r"(to_tf32(b[1])));
  } else if constexpr (kKind == kBF16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
mma_steps_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ bt,
                 void* __restrict__ out, int m, int n, int kbytes) {
  using Acc = std::conditional_t<(kKind >= kS8S32), int, float>;
  __shared__ __align__(16) uint8_t sa[2][kBM * kPitch];
  __shared__ __align__(16) uint8_t sb[2][kBN * kPitch];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN, step = blockIdx.z;
  const uint8_t* ga = a + ((long long)step * m + m0) * kbytes;
  const uint8_t* gb = bt + (long long)n0 * kbytes;

  // each thread moves 4 of the 512 16-byte pieces of each tile per chunk
  uint4 ra[4], rb[4];
  auto fetch = [&](int kb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int piece = tid + i * kThreads, row = piece / 8, col = (piece % 8) * 16;
      ra[i] = *reinterpret_cast<const uint4*>(ga + (long long)row * kbytes + kb + col);
      rb[i] = *reinterpret_cast<const uint4*>(gb + (long long)row * kbytes + kb + col);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int piece = tid + i * kThreads, row = piece / 8, col = (piece % 8) * 16;
      *reinterpret_cast<uint4*>(&sa[buf][row * kPitch + col]) = ra[i];
      *reinterpret_cast<uint4*>(&sb[buf][row * kPitch + col]) = rb[i];
    }
  };

  Acc c[2][4][4] = {};
  const int chunks = kbytes / kChunk;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    if (ch + 1 < chunks) fetch((ch + 1) * kChunk);
#pragma unroll
    for (int ks = 0; ks < kChunk; ks += 32) {
      uint32_t fa[2][4], fb[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint8_t* r0 = &sa[buf][(wm + 16 * i + g) * kPitch + ks + 4 * t];
        const uint8_t* r8 = r0 + 8 * kPitch;
        fa[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        fa[i][1] = *reinterpret_cast<const uint32_t*>(r8);
        fa[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        fa[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint8_t* r = &sb[buf][(wn + 8 * j + g) * kPitch + ks + 4 * t];
        fb[j][0] = *reinterpret_cast<const uint32_t*>(r);
        fb[j][1] = *reinterpret_cast<const uint32_t*>(r + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma<kKind>(c[i][j], fa[i], fb[j]);
    }
    if (ch + 1 < chunks) {
      stash(buf ^ 1);   // the other buffer: its last readers passed the
      __syncthreads();  // barrier that ended the previous chunk
    }
  }

  // c[i][j]: rows wm + 16i + g (+8), columns wn + 8j + 2t, +1
  using Out = std::conditional_t<kKind == kS8S32, int, float>;
  Out* o = static_cast<Out*>(out) + ((long long)step * m + m0) * n + n0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm + 16 * i + g + 8 * h, col = wn + 8 * j + 2 * t;
        Out v0, v1;
        if constexpr (kKind == kS8F32) {
          v0 = __int2float_rn(c[i][j][2 * h]);
          v1 = __int2float_rn(c[i][j][2 * h + 1]);
        } else {
          v0 = c[i][j][2 * h];
          v1 = c[i][j][2 * h + 1];
        }
        Out* p = o + (long long)row * n + col;
        p[0] = v0;
        p[1] = v1;
      }
}

}  // namespace

extern "C" {

int iqo_exp_mma_steps(int kind, const void* a, const void* bt, void* out,
                      int steps, int m, int n, int k, void* stream) {
  const int esize = kind == kF32 ? 4 : kind == kBF16 ? 2 : 1;
  const int kbytes = k * esize;
  if (kind < kF32 || kind > kS8F32) return 1004;
  if (m % kBM || n % kBN || kbytes % kChunk || m <= 0 || n <= 0 || steps <= 0)
    return 1005;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(bt) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return 1002;
  const dim3 grid(n / kBN, m / kBM, steps);
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<const uint8_t*>(a);
  auto pb = static_cast<const uint8_t*>(bt);
  switch (kind) {
    case kF32: mma_steps_kernel<kF32><<<grid, kThreads, 0, s>>>(pa, pb, out, m, n, kbytes); break;
    case kBF16: mma_steps_kernel<kBF16><<<grid, kThreads, 0, s>>>(pa, pb, out, m, n, kbytes); break;
    case kS8S32: mma_steps_kernel<kS8S32><<<grid, kThreads, 0, s>>>(pa, pb, out, m, n, kbytes); break;
    default: mma_steps_kernel<kS8F32><<<grid, kThreads, 0, s>>>(pa, pb, out, m, n, kbytes); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
