// X-pass probes for Hopper (sm_90a): which arithmetic a resize X pass should
// use.  Two kernels, each repeating its body `reps` times inside the kernel
// with the loop-carried `+ r` applied to the work values, so that the split
// or conversion runs in every repeat, as the TPU scripts' body_of does.
//
// Kernel I, xscheme_tile<Variant>: on a work tile w (160, 896) i32 and taps
// C (3, 384, 128), out (160, 384) i32 = sum_{r < reps} body(w + r), where
// group g of 128 outputs contracts the work columns [256 g, 256 g + 384):
//   empty   w[:, :384];
//   s8x4    a = int8(w >> 8), b = int8((w & 255) - 128) against e = int8(C >> 8),
//           f = int8(C & 255): 65536 ae + 256 (af + be) + bf + corr, mma.sync
//           m16n8k32 s8 -> s32 (four products per 32 of K);
//   s8cat   the same products with [e | f] read from one (384, 256) plane;
//   f32x2   int(a @ C) * 256 + int(b @ C), a = w >> 8, b = w & 255, FP32 FMA
//           on CUDA cores (TF32 would round C; every sum is an integer below
//           2^24, so exact in any order);
//   s16     int16(w) @ C as an int32 IMAD dot on CUDA cores: the serial
//           form's route (__dp2a cannot serve: C does not fit s8); the gemm
//           form (exp_xpass_gemm.cu, xscheme_s16_gemm) is the exact route on
//           the s8 tensor cores, the dot as four byte-plane products;
//   bf16    int(bf16(w) @ bf16(C)), mma.sync m16n8k16 bf16 -> f32, truncated.
// Replaces the TPU kernels of scripts/exp_x_schemes.py: make (pl.pallas_call
// at :156) and, at reps = 1, check_f32_exact (:230), check_s16_exact (:248)
// and check_bf16_error (:271).
// Launch form: 120 blocks of 128 threads, (4 column chunks of 32) x (3
// groups) x (10 row blocks of 16); each block keeps its 16 work rows of the
// group's 384-column window in registers (48 values a thread) and its
// coefficient slice on chip for all repeats (B fragments in registers for
// the tensor-core variants, a (384, 32) slice in shared memory for the
// CUDA-core ones), and splits w + r into shared memory once per repeat for
// its 4 warps.  (The TPU keeps the whole 573 KB tile and 295-590 KB of
// planes in VMEM, more than an SM holds.)
//
// Kernel J, vpu_xpass_tile<Variant>: out (160, 384) i32 = sum_{r < reps}
// body(we + r, wo + r, wd + r) on we, wo (160, 512), wd (160, 896) i32 and
// cxh, cxl (896, 384) bf16, 12 integer taps C:
//   empty    we[:, :384];
//   dense4   sum over cc in (cxh, cxl) of int(hi) * 256 + int(lo), hi =
//            (wd >> 8) @ cc and lo = (wd & 255) @ cc, mma.sync m16n8k16 bf16
//            -> f32 (exact: no sum of |products| reaches 2^24);
//   corr_i32 sum_k C[2k] we[:, k:k+384] + C[2k+1] wo[:, k:k+384], IMAD;
//   corr_f32 the same on the byte-split planes in float32, in the script's
//            source order (__fmul_rn/__fadd_rn, no contraction), then
//            int(h) * 256 + int(l);
//   muls_*   the taps on the unshifted first 384 columns.
// Replaces the TPU kernels of scripts/exp_vpu_xpass.py: make (pl.pallas_call
// at :156) and, at reps = 1, check_exact (:191).
// Launch form: 120 blocks of 128 threads, (12 column chunks of 32) x (10 row
// blocks of 16).  dense4 keeps its 16 work rows (57 KB) and its 2 x 32
// coefficient columns, K-major (116 KB), in shared memory and splits K over
// its 4 warps; the partial f32 sums (exact) meet in shared memory.  The
// CUDA-core variants keep each thread's 9 + 9 work values of its 4 outputs
// in registers.  A strided read from shared memory is legal on Hopper (the
// reason the TPU script needed deinterleaved planes); not a variant here.
//
// What bounds them on the H100: operations.  Per application, I's s8 dots
// are 94.4 M multiply-adds (0.095 us at 1,979 TOP/s), bf16 23.6 M (0.048 us
// at 989 TFLOP/s), f32x2 47.2 M FMA (1.41 us at 67 TFLOP/s), s16 23.6 M IMAD
// (1.41 us at 64 IMAD per clock per SM); J's dense4 220 M bf16
// multiply-adds (0.45 us), corr/muls 0.74 M multiply-adds (0.04 us).  The
// bytes (under 2 MB a launch) are read once for all repeats.  What the design
// does about it: nothing beyond the split above; the probes ask how far each
// variant stays from its unit's peak once the per-repeat split is paid.
//
// Intended int32 wraps (the accumulators over repeats, the recombinations
// 65536 ae, 256 int(A), and every corr/muls sum) are uint32 arithmetic;
// the integer multiply-adds of the repeat loops are inline PTX mad.lo.u32, so
// that the compiler cannot fold a loop whose sum is a polynomial in r into
// its closed form.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 16, kCols = 32;      // block tile of both kernels
constexpr int kTW = 384;                   // output columns

__device__ __forceinline__ uint32_t mad_u32(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t add_u32(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// ---- kernel I -------------------------------------------------------------

enum XScheme { kEmpty = 0, kS8x4 = 1, kS8Cat = 2, kF32x2 = 3, kS16 = 4, kBF16 = 5 };
constexpr int kBandI = 896, kK = 384, kGN = 128;
constexpr int kS8Pitch = kK + 16;          // bytes per s8 plane row: A loads hit 32 banks
constexpr int kBfPitch = 2 * kK + 16;      // bytes per bf16 plane row
constexpr int kIQuads = kRows * kK / 4 / kThreads;   // 12 int4 of w per thread
constexpr int kIScalars = kRows * kK / kThreads;     // 48 scalars of w per thread

template <int kV>
__host__ __device__ constexpr int xscheme_smem() {
  return kV == kF32x2 ? 2 * kK * kRows * 4 + kK * kCols * 4
         : kV == kS16 ? kK * kRows * 4 + kK * kCols * 4
         : (kV == kS8x4 || kV == kS8Cat) ? 2 * kRows * kS8Pitch
         : kV == kBF16 ? kRows * kBfPitch
                       : 0;
}

template <int kV>
__global__ void __launch_bounds__(kThreads)
xscheme_kernel(const int32_t* __restrict__ w, const void* __restrict__ c0,
               const void* __restrict__ c1, const int32_t* __restrict__ corr,
               int32_t* __restrict__ out, int reps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
  const int chunk = blockIdx.x, grp = blockIdx.y, row0 = kRows * blockIdx.z;
  const int k0 = 256 * grp;                            // the group's window
  const int ocol = kGN * grp + kCols * chunk;          // first output column of the block
  const int32_t* wrow = w + (long long)row0 * kBandI + k0;

  if constexpr (kV == kEmpty) {
    // thread (warp, lane): rows 4 warp + i, output column ocol + lane
    uint32_t v[4], acc[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = static_cast<uint32_t>(w[(long long)(row0 + 4 * warp + i) * kBandI + ocol + lane]);
    for (int r = 0; r < reps; ++r) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = add_u32(acc[i], v[i] + static_cast<uint32_t>(r));
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[(long long)(row0 + 4 * warp + i) * kTW + ocol + lane] = static_cast<int32_t>(acc[i]);
  } else if constexpr (kV == kF32x2 || kV == kS16) {
    // planes K-major, (384, 16): aT[k][row] (and bT); C slice (384, 32)
    using T = std::conditional_t<kV == kF32x2, float, int32_t>;
    T* aT = reinterpret_cast<T*>(smem);
    T* bT = aT + kK * kRows;                             // f32x2 only
    T* cs = reinterpret_cast<T*>(smem + (kV == kF32x2 ? 2 : 1) * kK * kRows * 4);
    for (int i = tid; i < kK * kCols; i += kThreads) {
      const int k = i / kCols, n = i % kCols, col = kCols * chunk + n;
      if constexpr (kV == kF32x2)
        cs[i] = static_cast<const float*>(c0)[((long long)grp * kK + k) * kGN + col];
      else
        cs[i] = static_cast<const int16_t*>(c0)[((long long)grp * kK + k) * kGN + col];
    }
    // this thread's work values: row tid % 16, k = tid / 16 + 8 i
    int32_t wv[kIScalars];
#pragma unroll
    for (int i = 0; i < kIScalars; ++i)
      wv[i] = wrow[(long long)(tid % kRows) * kBandI + tid / kRows + 8 * i];
    float fa[4] = {}, fb[4] = {};
    uint32_t acc[4] = {0, 0, 0, 0};
    for (int r = 0; r < reps; ++r) {
#pragma unroll
      for (int i = 0; i < kIScalars; ++i) {
        const int x = wv[i] + r, e = tid + kThreads * i;   // e = k * 16 + row
        if constexpr (kV == kF32x2) {
          aT[e] = static_cast<float>(x >> 8);
          bT[e] = static_cast<float>(x & 255);
        } else {
          aT[e] = static_cast<int16_t>(x);
        }
      }
      __syncthreads();
      if constexpr (kV == kF32x2) {
#pragma unroll
        for (int i = 0; i < 4; ++i) fa[i] = fb[i] = 0.f;
#pragma unroll 4
        for (int k = 0; k < kK; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(aT + k * kRows + 4 * warp);
          const float4 b = *reinterpret_cast<const float4*>(bT + k * kRows + 4 * warp);
          const float c = cs[k * kCols + lane];
          fa[0] = fmaf(a.x, c, fa[0]); fa[1] = fmaf(a.y, c, fa[1]);
          fa[2] = fmaf(a.z, c, fa[2]); fa[3] = fmaf(a.w, c, fa[3]);
          fb[0] = fmaf(b.x, c, fb[0]); fb[1] = fmaf(b.y, c, fb[1]);
          fb[2] = fmaf(b.z, c, fb[2]); fb[3] = fmaf(b.w, c, fb[3]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i] += static_cast<uint32_t>(__float2int_rz(fa[i])) * 256u +
                    static_cast<uint32_t>(__float2int_rz(fb[i]));
      } else {
        uint32_t s[4] = {0, 0, 0, 0};
#pragma unroll 4
        for (int k = 0; k < kK; ++k) {
          const int4 a = *reinterpret_cast<const int4*>(aT + k * kRows + 4 * warp);
          const uint32_t c = static_cast<uint32_t>(cs[k * kCols + lane]);
          s[0] = mad_u32(static_cast<uint32_t>(a.x), c, s[0]);
          s[1] = mad_u32(static_cast<uint32_t>(a.y), c, s[1]);
          s[2] = mad_u32(static_cast<uint32_t>(a.z), c, s[2]);
          s[3] = mad_u32(static_cast<uint32_t>(a.w), c, s[3]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += s[i];
      }
      __syncthreads();                                   // the planes are read
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out[(long long)(row0 + 4 * warp + i) * kTW + ocol + lane] = static_cast<int32_t>(acc[i]);
  } else {
    // tensor cores: warp `warp` owns output columns 8 warp .. + 7 of the block
    const int n = kCols * chunk + 8 * warp + g;          // this lane's B column in the group
    int4 wq[kIQuads];                                    // quad e4 = tid + 128 i: row e4 / 96
#pragma unroll
    for (int i = 0; i < kIQuads; ++i) {
      const int e4 = tid + kThreads * i;
      wq[i] = *reinterpret_cast<const int4*>(wrow + (long long)(e4 / (kK / 4)) * kBandI +
                                             4 * (e4 % (kK / 4)));
    }
    const int cn = ocol + 8 * warp + 2 * q;              // output columns cn, cn + 1
    if constexpr (kV == kBF16) {
      const auto* cb = static_cast<const __nv_bfloat16*>(c0) + (long long)grp * kK * kGN;
      uint32_t bfr[kK / 16][2];
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = 16 * ks + 8 * h + 2 * q;
          bfr[ks][h] = bf16_bits(cb + (long long)k * kGN + n) |
                       bf16_bits(cb + (long long)(k + 1) * kGN + n) << 16;
        }
      uint8_t* plane = smem;                             // (16, 384) bf16, row-major
      uint32_t acc[4] = {0, 0, 0, 0};
      for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int i = 0; i < kIQuads; ++i) {
          const int e4 = tid + kThreads * i;
          const int4 x = wq[i];
          *reinterpret_cast<uint2*>(plane + (e4 / (kK / 4)) * kBfPitch + 8 * (e4 % (kK / 4))) =
              make_uint2(bf16x2(static_cast<float>(x.x + r), static_cast<float>(x.y + r)),
                         bf16x2(static_cast<float>(x.z + r), static_cast<float>(x.w + r)));
        }
        __syncthreads();
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < kK / 16; ++ks) {
          const uint8_t* p = plane + g * kBfPitch + 2 * (16 * ks + 2 * q);
          const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(p),
                                 *reinterpret_cast<const uint32_t*>(p + 8 * kBfPitch),
                                 *reinterpret_cast<const uint32_t*>(p + 16),
                                 *reinterpret_cast<const uint32_t*>(p + 8 * kBfPitch + 16)};
          mma_bf16(c, a, bfr[ks][0], bfr[ks][1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += static_cast<uint32_t>(__float2int_rz(c[i]));
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[(long long)(row0 + g + 8 * (i / 2)) * kTW + cn + i % 2] = static_cast<int32_t>(acc[i]);
    } else {
      // s8: B fragments of e and f, k rows 32 ks + 4 q .. + 3 (and + 16)
      const int8_t* ce = static_cast<const int8_t*>(c0);
      const int8_t* cf = kV == kS8Cat ? ce + kGN : static_cast<const int8_t*>(c1);
      const int pitch = kV == kS8Cat ? 2 * kGN : kGN;
      ce += (long long)grp * kK * pitch;
      cf += (long long)grp * kK * pitch;
      uint32_t be[kK / 32][2], bf[kK / 32][2];
#pragma unroll
      for (int ks = 0; ks < kK / 32; ++ks)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t ve = 0, vf = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const long long at = (long long)(32 * ks + 16 * h + 4 * q + j) * pitch + n;
            ve |= static_cast<uint32_t>(static_cast<uint8_t>(ce[at])) << (8 * j);
            vf |= static_cast<uint32_t>(static_cast<uint8_t>(cf[at])) << (8 * j);
          }
          be[ks][h] = ve;
          bf[ks][h] = vf;
        }
      uint32_t cr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        cr[i] = static_cast<uint32_t>(corr[grp * kGN + kCols * chunk + 8 * warp + 2 * q + i]);
      uint8_t* pa = smem;                                // (16, 384) s8 planes a and b
      uint8_t* pb = smem + kRows * kS8Pitch;
      uint32_t acc[4] = {0, 0, 0, 0};
      for (int r = 0; r < reps; ++r) {
#pragma unroll
        for (int i = 0; i < kIQuads; ++i) {
          const int e4 = tid + kThreads * i;
          const uint32_t x0 = wq[i].x + r, x1 = wq[i].y + r, x2 = wq[i].z + r, x3 = wq[i].w + r;
          // a: byte 1 of each (w >> 8 wrapped to s8); b: byte 0 ^ 0x80 ((w & 255) - 128)
          const uint32_t a = __byte_perm(__byte_perm(x0, x1, 0x0051), __byte_perm(x2, x3, 0x0051),
                                         0x5410);
          const uint32_t b = __byte_perm(__byte_perm(x0, x1, 0x0040), __byte_perm(x2, x3, 0x0040),
                                         0x5410) ^ 0x80808080u;
          const int off = (e4 / (kK / 4)) * kS8Pitch + 4 * (e4 % (kK / 4));
          *reinterpret_cast<uint32_t*>(pa + off) = a;
          *reinterpret_cast<uint32_t*>(pb + off) = b;
        }
        __syncthreads();
        int ae[4] = {}, af[4] = {}, bea[4] = {}, bfa[4] = {};
#pragma unroll
        for (int ks = 0; ks < kK / 32; ++ks) {
          const int o = g * kS8Pitch + 32 * ks + 4 * q;
          const uint32_t fa[4] = {*reinterpret_cast<const uint32_t*>(pa + o),
                                  *reinterpret_cast<const uint32_t*>(pa + o + 8 * kS8Pitch),
                                  *reinterpret_cast<const uint32_t*>(pa + o + 16),
                                  *reinterpret_cast<const uint32_t*>(pa + o + 8 * kS8Pitch + 16)};
          const uint32_t fb[4] = {*reinterpret_cast<const uint32_t*>(pb + o),
                                  *reinterpret_cast<const uint32_t*>(pb + o + 8 * kS8Pitch),
                                  *reinterpret_cast<const uint32_t*>(pb + o + 16),
                                  *reinterpret_cast<const uint32_t*>(pb + o + 8 * kS8Pitch + 16)};
          mma_s8(ae, fa, be[ks][0], be[ks][1]);
          mma_s8(af, fa, bf[ks][0], bf[ks][1]);
          mma_s8(bea, fb, be[ks][0], be[ks][1]);
          mma_s8(bfa, fb, bf[ks][0], bf[ks][1]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i] += static_cast<uint32_t>(ae[i]) * 65536u +
                    (static_cast<uint32_t>(af[i]) + static_cast<uint32_t>(bea[i])) * 256u +
                    static_cast<uint32_t>(bfa[i]) + cr[i % 2];
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[(long long)(row0 + g + 8 * (i / 2)) * kTW + cn + i % 2] = static_cast<int32_t>(acc[i]);
    }
  }
}

template <int kV>
int launch_xscheme(const int32_t* w, const void* c0, const void* c1, const int32_t* corr,
                   int32_t* out, int reps, cudaStream_t s) {
  xscheme_kernel<kV><<<dim3(kGN / kCols, 3, 160 / kRows), kThreads, xscheme_smem<kV>(), s>>>(
      w, c0, c1, corr, out, reps);
  return static_cast<int>(cudaGetLastError());
}

// ---- kernel J -------------------------------------------------------------

enum Vpu { kVEmpty = 0, kDense4 = 1, kCorrI32 = 2, kCorrF32 = 3, kMulsI32 = 4, kMulsF32 = 5 };
constexpr int kBandJ = 896, kWdi = 512, kTaps = 12, kHalf = 6;
constexpr int kWPitch = kBandJ + 8;        // words per dense4 work row: A loads hit 32 banks
constexpr int kCPitchJ = kBandJ / 2 + 4;   // words per K-major coefficient column
constexpr int kDense4Smem = kRows * kWPitch * 4 + 2 * kCols * kCPitchJ * 4 +
                            4 * 4 * kRows * kCols * 4;

struct Taps {
  int c[kTaps];
};

template <int kV>
__global__ void __launch_bounds__(kThreads)
vpu_xpass_kernel(const int32_t* __restrict__ we, const int32_t* __restrict__ wo,
                 const int32_t* __restrict__ wd, const __nv_bfloat16* __restrict__ cxt,
                 Taps taps, int32_t* __restrict__ out, int reps) {
  const int tid = threadIdx.x;
  const int col0 = kCols * blockIdx.x, row0 = kRows * blockIdx.y;
  if constexpr (kV == kDense4) {
    extern __shared__ __align__(16) uint8_t smem[];
    int32_t* ws = reinterpret_cast<int32_t*>(smem);                         // (16, 904)
    uint32_t* cs = reinterpret_cast<uint32_t*>(smem + kRows * kWPitch * 4); // (2, 32, 452)
    float* red = reinterpret_cast<float*>(smem + kRows * kWPitch * 4 + 2 * kCols * kCPitchJ * 4);
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, q = lane % 4;
    for (int i = tid; i < kRows * kBandJ / 4; i += kThreads) {
      const int r = i / (kBandJ / 4), c = 4 * (i % (kBandJ / 4));
      *reinterpret_cast<int4*>(ws + r * kWPitch + c) =
          *reinterpret_cast<const int4*>(wd + (long long)(row0 + r) * kBandJ + c);
    }
    for (int i = tid; i < 2 * kCols * kBandJ / 8; i += kThreads) {
      const int p = i / (kCols * kBandJ / 8), rest = i % (kCols * kBandJ / 8);
      const int n = rest / (kBandJ / 8), k = 8 * (rest % (kBandJ / 8));
      *reinterpret_cast<int4*>(cs + (p * kCols + n) * kCPitchJ + k / 2) =
          *reinterpret_cast<const int4*>(cxt + ((long long)p * kTW + col0 + n) * kBandJ + k);
    }
    __syncthreads();
    uint32_t acc[4] = {0, 0, 0, 0};        // outputs tid + 128 i of the block
    for (int r = 0; r < reps; ++r) {
      float s[4][4][4] = {};               // [hi/lo x cxh/cxl][n-tile][fragment]
      for (int ks = warp; ks < kBandJ / 16; ks += 4) {
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {      // rows g (+8), k 16 ks + 2 q (+8)
          const int2 v = *reinterpret_cast<const int2*>(
              ws + (g + 8 * (i & 1)) * kWPitch + 16 * ks + 2 * q + 8 * (i >> 1));
          const int x0 = v.x + r, x1 = v.y + r;
          ahi[i] = bf16x2(static_cast<float>(x0 >> 8), static_cast<float>(x1 >> 8));
          alo[i] = bf16x2(static_cast<float>(x0 & 255), static_cast<float>(x1 & 255));
        }
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t* b = cs + (p * kCols + 8 * j + g) * kCPitchJ + 8 * ks + q;
            mma_bf16(s[2 * p][j], ahi, b[0], b[4]);
            mma_bf16(s[2 * p + 1][j], alo, b[0], b[4]);
          }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            red[((warp * 4 + t) * kRows + g + 8 * (i / 2)) * kCols + 8 * j + 2 * q + i % 2] =
                s[t][j][i];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = tid + kThreads * i;
        uint32_t part = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {      // hi.cxh, lo.cxh, hi.cxl, lo.cxl
          float v = 0.f;
#pragma unroll
          for (int wp = 0; wp < 4; ++wp) v += red[(wp * 4 + t) * kRows * kCols + o];
          part += static_cast<uint32_t>(__float2int_rz(v)) * (t % 2 == 0 ? 256u : 1u);
        }
        acc[i] += part;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = tid + kThreads * i;
      out[(long long)(row0 + o / kCols) * kTW + col0 + o % kCols] = static_cast<int32_t>(acc[i]);
    }
  } else {
    // thread: row row0 + tid / 8, output columns c0 .. c0 + 3
    const int row = row0 + tid / 8, c0 = col0 + 4 * (tid % 8);
    constexpr bool kShift = kV == kCorrI32 || kV == kCorrF32;
    constexpr int kN = kShift ? 4 + kHalf - 1 : 4;
    int32_t ve[kN], vo[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      ve[j] = we[(long long)row * kWdi + c0 + j];
      vo[j] = wo[(long long)row * kWdi + c0 + j];
    }
    uint32_t acc[4] = {0, 0, 0, 0};
    for (int r = 0; r < reps; ++r) {
      if constexpr (kV == kVEmpty) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = add_u32(acc[c], static_cast<uint32_t>(ve[c] + r));
      } else if constexpr (kV == kCorrI32 || kV == kMulsI32) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int k = 0; k < kHalf; ++k) {
            const int j = kShift ? c + k : c;
            acc[c] = mad_u32(static_cast<uint32_t>(taps.c[2 * k]),
                             static_cast<uint32_t>(ve[j] + r), acc[c]);
            acc[c] = mad_u32(static_cast<uint32_t>(taps.c[2 * k + 1]),
                             static_cast<uint32_t>(vo[j] + r), acc[c]);
          }
      } else if constexpr (kV == kCorrF32) {
        float eh[kN], el[kN], oh[kN], ol[kN];
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          const int xe = ve[j] + r, xo = vo[j] + r;
          eh[j] = static_cast<float>(xe >> 8);
          el[j] = static_cast<float>(xe & 255);
          oh[j] = static_cast<float>(xo >> 8);
          ol[j] = static_cast<float>(xo & 255);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float h = 0.f, l = 0.f;
#pragma unroll
          for (int k = 0; k < kHalf; ++k) {
            const float ce = static_cast<float>(taps.c[2 * k]);
            const float co = static_cast<float>(taps.c[2 * k + 1]);
            const float th = __fadd_rn(__fmul_rn(ce, eh[c + k]), __fmul_rn(co, oh[c + k]));
            const float tl = __fadd_rn(__fmul_rn(ce, el[c + k]), __fmul_rn(co, ol[c + k]));
            h = k == 0 ? th : __fadd_rn(h, th);
            l = k == 0 ? tl : __fadd_rn(l, tl);
          }
          acc[c] += static_cast<uint32_t>(__float2int_rz(h)) * 256u +
                    static_cast<uint32_t>(__float2int_rz(l));
        }
      } else {                               // muls_f32
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float a = static_cast<float>(ve[c] + r), b = static_cast<float>(vo[c] + r);
          float s = 0.f;
#pragma unroll
          for (int k = 0; k < kHalf; ++k) {
            const float t = __fadd_rn(__fmul_rn(static_cast<float>(taps.c[2 * k]), a),
                                      __fmul_rn(static_cast<float>(taps.c[2 * k + 1]), b));
            s = k == 0 ? t : __fadd_rn(s, t);
          }
          acc[c] += static_cast<uint32_t>(__float2int_rz(s));   // saturates, NaN -> 0
        }
      }
    }
    *reinterpret_cast<int4*>(out + (long long)row * kTW + c0) =
        make_int4(acc[0], acc[1], acc[2], acc[3]);
  }
}

template <int kV>
int launch_vpu(const int32_t* we, const int32_t* wo, const int32_t* wd,
               const __nv_bfloat16* cxt, const Taps& taps, int32_t* out, int reps,
               cudaStream_t s) {
  vpu_xpass_kernel<kV><<<dim3(kTW / kCols, 160 / kRows), kThreads,
                         kV == kDense4 ? kDense4Smem : 0, s>>>(we, wo, wd, cxt, taps, out, reps);
  return static_cast<int>(cudaGetLastError());
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

extern "C" {

// Raise kernels I's and J's dynamic shared-memory limits on the current
// device; call once per device before their first launch.
int iqo_exp_xpass_setup() {
  int rc = static_cast<int>(cudaFuncSetAttribute(
      xscheme_kernel<kF32x2>, cudaFuncAttributeMaxDynamicSharedMemorySize, xscheme_smem<kF32x2>()));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      xscheme_kernel<kS16>, cudaFuncAttributeMaxDynamicSharedMemorySize, xscheme_smem<kS16>()));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      vpu_xpass_kernel<kDense4>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDense4Smem));
  return rc;
}

// Kernel I: w (160, 896) i32; c0, c1 the variant's planes (s8x4: e, f; s8cat:
// [e | f]; f32x2: C f32; s16: C i16; bf16: C bf16; empty: none), corr (3, 128)
// i32 for the s8 variants -> out (160, 384) i32.
int iqo_exp_xscheme(int variant, const void* w, const void* c0, const void* c1,
                    const void* corr, void* out, int reps, void* stream) {
  if (variant < kEmpty || variant > kBF16) return 1007;
  if (reps < 1) return 1008;
  if (misaligned(w) || misaligned(out)) return 1002;
  auto s = static_cast<cudaStream_t>(stream);
  auto pw = static_cast<const int32_t*>(w);
  auto pc = static_cast<const int32_t*>(corr);
  auto po = static_cast<int32_t*>(out);
  switch (variant) {
    case kEmpty: return launch_xscheme<kEmpty>(pw, c0, c1, pc, po, reps, s);
    case kS8x4: return launch_xscheme<kS8x4>(pw, c0, c1, pc, po, reps, s);
    case kS8Cat: return launch_xscheme<kS8Cat>(pw, c0, c1, pc, po, reps, s);
    case kF32x2: return launch_xscheme<kF32x2>(pw, c0, c1, pc, po, reps, s);
    case kS16: return launch_xscheme<kS16>(pw, c0, c1, pc, po, reps, s);
    default: return launch_xscheme<kBF16>(pw, c0, c1, pc, po, reps, s);
  }
}

// Kernel J: we, wo (160, 512), wd (160, 896) i32, cxt (2, 384, 896) bf16
// (cxh, cxl K-major), 12 taps (host array) -> out (160, 384) i32.
int iqo_exp_vpu_xpass(int variant, const void* we, const void* wo, const void* wd,
                      const void* cxt, const int* taps, void* out, int reps, void* stream) {
  if (variant < kVEmpty || variant > kMulsF32) return 1007;
  if (reps < 1) return 1008;
  if (misaligned(we) || misaligned(wo) || misaligned(wd) || misaligned(cxt) || misaligned(out))
    return 1002;
  Taps t;
  for (int i = 0; i < kTaps; ++i) t.c[i] = taps[i];
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const int32_t*>(we);
  auto b = static_cast<const int32_t*>(wo);
  auto d = static_cast<const int32_t*>(wd);
  auto c = static_cast<const __nv_bfloat16*>(cxt);
  auto o = static_cast<int32_t*>(out);
  switch (variant) {
    case kVEmpty: return launch_vpu<kVEmpty>(a, b, d, c, t, o, reps, s);
    case kDense4: return launch_vpu<kDense4>(a, b, d, c, t, o, reps, s);
    case kCorrI32: return launch_vpu<kCorrI32>(a, b, d, c, t, o, reps, s);
    case kCorrF32: return launch_vpu<kCorrF32>(a, b, d, c, t, o, reps, s);
    case kMulsI32: return launch_vpu<kMulsI32>(a, b, d, c, t, o, reps, s);
    default: return launch_vpu<kMulsF32>(a, b, d, c, t, o, reps, s);
  }
}

}  // extern "C"
