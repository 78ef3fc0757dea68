// X-pass probes redesigned for Hopper (sm_90a): kernel I's f32_2dot,
// bf16_1dot and s16_1dot schemes and kernel J's dense4 as GEMMs whose M
// stacks the repeats' work rows (I's f32_2dot on CUDA cores in FP32 FMA,
// bf16_1dot, s16_1dot and J on the tensor cores with wgmma).  Each computes what the TPU kernel
// computes, out = sum_{r < reps} body(w + r) with int32 wraps; f32_2dot and
// dense4 equal the plain versions bit for bit
// (exp_x_schemes.x_scheme_plain("f32_2dot"), exp_vpu_xpass.vpu_xpass_plain
// ("dense4")), bf16_1dot stays within the f32 summation bound of its plain
// version (exp_x_schemes.bf16_bound).  The first forms (exp_xpass.cu,
// xscheme_kernel<kF32x2>, <kBF16> and vpu_xpass_kernel<kDense4>) launch 120
// blocks of 128 threads that each walk every repeat in series; these spread
// the repeats over the grid.
//
// Kernel I, xscheme_f32_gemm: replaces scripts/exp_x_schemes.py, make
// (pl.pallas_call at :156), variant f32_2dot, and at reps = 1 its
// check_f32_exact (:230).  On w (160, 896) i32 and C (3, 384, 128) f32, group
// g of 128 outputs contracts the work columns [256 g, 256 g + 384):
// out += int(a @ C_g) * 256 + int(b @ C_g), a = (w + r) >> 8, b = (w + r) & 255.
//   Block: one group, 16 work rows, a slice of the repeats.  It loads C_g
//   (384 x 128 f32, 192 KB) into shared memory once, as 12 K chunks of 32
//   rows, each its own cp.async group, so that the first step computes on
//   chunk c while chunks c + 1 .. 11 are in flight; every later step reads it
//   from shared memory.  A step stacks 4 repeats along M: 16 rows x 4 repeats
//   x 2 planes = 128 A rows, m = 8 row + 2 repeat + plane.  Each K chunk of A
//   is split from w + r into shared memory once per (step, chunk), double
//   buffered: the split of chunk c + 1 is written while chunk c is computed,
//   one barrier a chunk.  256 threads, each an 8 x 8 register tile (its
//   row's 4 repeats x 2 planes, against 8 columns): per k two 16-byte loads
//   of A and two of C feed 64 FFMA, 16 FFMA a shared load.  A thread's rows
//   are one work row's, so it converts and meets the two planes and the
//   step's repeats in its own registers, wrapping in uint32.  TF32 stays off
//   (FFMA on CUDA cores): every partial and full sum is an integer whose
//   |terms| sum below 2^24 (_F32_EXACT, asserted by the plain version), so
//   any order of summation is exact.
//   Shared memory: 196,608 (C) + 2 x 16,384 (A) = 229,376 bytes of 232,448,
//   one block an SM, 8 warps (2 a scheduler).
//
// Kernel I, xscheme_bf16_gemm: replaces scripts/exp_x_schemes.py, make
// (pl.pallas_call at :156), variant bf16_1dot, and at reps = 1 its
// check_bf16_error (:271).  out += int(f32(bf16(w + r) @ bf16(C_g))): each
// repeat's f32 dot is truncated before the repeats meet, so a repeat's
// accumulator must be whole over K = 384 before it is converted; repeats
// stack along M, never in one accumulator.
//   Block: two warpgroups, one group, 16 work rows, a slice of the repeats.
//   C_g, laid out K-major once per operand set by the host (build_cvals'
//   cbf_k), stays in shared memory for the whole slice: 6 K blocks of 128 x
//   64 bf16, 128-byte swizzled, 96 KB, each its own cp.async group so that
//   the first step computes on block kb while the later ones land.  The
//   block's window of w (16 x 384 i32, 24 KB) is resident too, stored in
//   A-fragment order.  A step stacks 8 repeats, one a warp: warp w's 16 A
//   rows are the 16 work rows at repeat 8 step + w, so each warpgroup issues
//   24 K steps of wgmma m64n128k16 with A from registers, bf16(w + r)
//   rounded as the plain version rounds (one rounding to f32, then to the
//   nearest even bf16).  Where every |w + r| of the block's window stays
//   below 2^24 (the script's tile: |w| < 21,931), the window is turned into
//   floats once and float(w + r) is one FADD, exact, in place of an int32
//   add and an int -> float conversion, which the other blocks take.  Two A
//   sets alternate, a set rewritten only after the group that read it
//   retired.  At the end of K each thread
//   truncates its 64 f32 sums and adds them into uint32 totals.  At the end
//   of the slice the 8 warps' totals meet in shared memory, then in the
//   output by one atomicAdd an output.  The tensor cores sum in their own
//   order: the result is held within bf16_bound, which covers any f32 order.
//   Shared memory: 98,304 + 24,576 + 1,024 slack = 123,904 bytes, one block
//   an SM, 8 warps (2 a scheduler).
//
// Kernel I, xscheme_s16_gemm: replaces scripts/exp_x_schemes.py, make
// (pl.pallas_call at :156), variant s16_1dot, and at reps = 1 its
// check_s16_exact (:248).  out += wrap32(int16(w + r) @ C_g), exact: the
// serial form's IMAD dot (exp_xpass.cu) as four products on the s8 tensor
// cores.  With x = int16(w + r) = 256 xh + xl (xh = x >> 8 as s8, xl = x &
// 255 as u8) and the taps c = 256 ch + cl alike (laid out once by the host,
// build_cvals' c16_k, both bytes K-major), x c = 65536 xh ch + 256 (xh cl +
// xl ch) + xl cl: wgmma m64n64k32 .s32.s8.s8, .s8.u8, .u8.s8 and .u8.u8,
// the two middle products into one accumulator.
//   Block: two warpgroups, 16 work rows, 64 output columns (half a group), a
//   slice of the repeats.  Both byte planes of its taps (3 K blocks of 64 x
//   128 bytes each, 128-byte swizzled: 48 KB) stay in shared memory for the
//   slice, a cp.async group a K block, as bf16_1dot's.  The window of w is
//   resident as int16 (12 KB) in A-fragment order.  A step stacks 8
//   repeats, one a warp (warp w: repeat 8 step + w).  Per K step of 32 a
//   lane reads its 16 int16 of rows g and g + 8 as two 16-byte words, adds
//   r to both halves of each word at once (no carry crosses them: the int16
//   wrap), and splits the high and low bytes into the two A fragments with
//   one byte permute each; a repeat past reps gives zero fragments.  The
//   s32 accumulators (hh, mid, ll: 96 registers) sum over K and over the
//   warp's repeats of the slice; a slice has at most 64 steps, so no sum can
//   leave int32 for any int16 values (64 x 384 x 255 x 255 < 2^31) and no
//   wrap is relied on.  At the end of the slice each thread forms 65536 hh
//   + 256 mid + ll in uint32, the 8 warps' sums meet in shared memory and
//   then in the output by one atomicAdd an output.  Bit for bit equal to
//   exp_x_schemes.x_scheme_plain("s16_1dot"), and to gold at one repeat.
//   Shared memory: 49,152 + 12,288 + 1,024 slack = 62,464 bytes; one block
//   an SM by registers, 8 warps (2 a scheduler).
//
// Kernel J, vpu_dense4_gemm: replaces scripts/exp_vpu_xpass.py, make
// (pl.pallas_call at :156), variant dense4.  On wd (160, 896) i32 and cxh,
// cxl (896, 384) bf16: out += sum over cc in (cxh, cxl) of int(hi @ cc) *
// 256 + int(lo @ cc), hi = (wd + r) >> 8, lo = (wd + r) & 255 as bf16.
//   Block: one warpgroup (128 threads), 16 work rows, 32 output columns, a
//   slice of the repeats; a step stacks 8 repeats x 2 planes x 16 rows = 256
//   A rows along M.  B is 64 rows of the K-major coefficients (cxh's 32
//   columns, then cxl's): the block's 14 K chunks of 64, each with its 16
//   work rows, are staged by cp.async in 4 stages, the B tiles 1024-byte
//   aligned with their 16-byte pieces XOR-swizzled by row (the 128-byte
//   swizzle that wgmma's descriptor names).  Each K step of 16 issues 4
//   wgmma m64n64k16 (bf16 -> f32), one a repeat of the warp's 4: A from
//   registers, B read by the tensor cores from the swizzled tile, D in
//   registers; every warp holds its 16 rows over the full K, so no partial
//   sums meet between warps.  The split is done in the kernel once per
//   (repeat, K step) and goes straight into the A fragments: a warp's 16 A
//   rows are the hi (row g) and lo (row g + 8) planes of its 8 work rows, so
//   a lane splits its 4 work values of the K step for the warp's first
//   repeat (I2F for hi, a magic-number add for lo) and steps to the next 3
//   repeats by a carry from lo, in float.  Two A sets alternate: the K
//   step's products run while the next one's split is made, and a set is
//   rewritten only after the wgmma group that read it has retired.  A
//   thread holds, for each output, the hi and lo rows against cxh and cxl:
//   it converts each of the four f32 dots and meets them and its repeats in
//   uint32.  Any order of the f32 sums is exact: no sum of |products|
//   reaches 2^24 (test_dense4_sums_stay_below_2_24), so the tensor cores'
//   order is free.  A step's 8 repeats are computed whole: past reps they
//   are products of valid work values that the meeting leaves out.
//   (bf16 mma.sync on fragments read with ldmatrix, with the split written
//   into a shared A tile or made in registers, was slower on the H100: B
//   fragments cost shared-memory traffic for every warp, and one m16n8k16
//   product an instruction leaves the split and the products competing for
//   issue; wgmma reads B without ldmatrix and issues a 64 x 64 x 16 product
//   in one instruction.)
//   Shared memory: 4 x (8,192 B + 4,608 work rows) + 1,024 alignment slack
//   = 52,224 bytes; two blocks an SM by registers, 8 warps (2 a scheduler).

// Both: a block's slice of repeats meets the other slices' in the output by
// atomicAdd on uint32, which wraps and does not depend on the order; the
// wrapper zeroes the output first.  The host (experiments/xpass_gemm.py)
// picks the slices so that the grid fills the card, holds the geometry below
// in a NumPy model, and checks it against iqo_exp_xpass_gemm_shape.
//
// What bounds them on the H100: operations.  Per application, I's two f32
// dots are 47.2 M FMA, 1.41 us at 67 TFLOP/s; I's bf16 dot 23.6 M
// multiply-adds, 0.0477 us at 989 TFLOP/s; I's s16 dot as four s8 products
// 94.4 M multiply-adds, 0.0954 us at 1,979 TOP/s; J's four bf16 dots 220 M
// multiply-adds, 0.445 us at 989 TFLOP/s.  Bytes are read once for all
// repeats (under 2 MB a launch; C and the coefficient chunks come from L2).
// What the design does about it: it keeps the split (once per repeat, row
// and column for all of a block's output columns) and the memory traffic (a
// coefficient chunk read into shared memory once for every repeat a step
// stacks) small beside the products, and puts 8 warps on each SM with
// enough independent accumulators to keep the FMA pipes or the tensor cores
// fed; J uses wgmma, the only path to the tensor cores' full rate.
//
// Intended int32 wraps (the sums over repeats, 256 int(hi), the slices'
// meeting) are uint32 arithmetic, with inline PTX mad.lo.u32 / add.u32 in the
// repeat loops so that the compiler cannot fold them.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

__device__ __forceinline__ uint32_t f2u(float x) {
  return static_cast<uint32_t>(__float2int_rz(x));
}

// Wait until at most `pending` (0..10) of this thread's cp.async groups are
// still in flight.
__device__ __forceinline__ void cp_wait_at_most(int pending) {
  switch (pending) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    case 6: cp_wait<6>(); break;
    case 7: cp_wait<7>(); break;
    case 8: cp_wait<8>(); break;
    case 9: cp_wait<9>(); break;
    default: cp_wait<10>(); break;
  }
}

// wgmma (sm_90a): D[64 x 64] += A[64 x 16] (registers) x B[16 x 64] (shared,
// by descriptor), f32 accumulators; the warpgroup's 4 warps each hold 16 rows
// of A and D in mma.sync's m16n8k16 fragment layout.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 0;"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// wgmma: D[64 x 128] (+)= A[64 x 16] (registers) x B[16 x 128] (shared, by
// descriptor), bf16 -> f32; scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " IQO_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : IQO_ACC64("+f", d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// x & 255 as float, exact: the integer in the low mantissa bits of 2^23
__device__ __forceinline__ float low_byte(int x) {
  return __int_as_float(0x4B000000 | (x & 255)) - 8388608.0f;
}

// ---- kernel I: f32_2dot ----------------------------------------------------

namespace gi {
constexpr int kThreads = 256;
constexpr int kRows = 16;                  // work rows of a block
constexpr int kRepStep = 4;                // repeats a step stacks along M
constexpr int kM = kRows * kRepStep * 2;   // 128 A rows: m = 8 row + 2 repeat + plane
constexpr int kN = 128, kK = 384, kKC = 32, kChunks = kK / kKC;
constexpr int kBand = 896, kTW = 384, kTH = 160, kGroups = 3;
constexpr int kSmemC = kK * kN * 4;        // C_g, resident
constexpr int kSmemA = 2 * kKC * kM * 4;   // two A chunks, [k][m]
constexpr int kSmem = kSmemC + kSmemA;
static_assert(kThreads == kRows * (kN / 8), "one 8 x 8 tile a thread");
static_assert(kKC * kRows == 2 * kThreads, "two split values a thread and chunk");
static_assert(kSmem <= 232448, "shared memory of one block");
}  // namespace gi

__global__ void __launch_bounds__(gi::kThreads, 1)
xscheme_f32_gemm(const int32_t* __restrict__ w, const float* __restrict__ c,
                 uint32_t* __restrict__ out, int reps, int steps_per_slice) {
  using namespace gi;
  extern __shared__ __align__(16) float smem_f[];
  float* cs = smem_f;                      // (384, 128): C_g
  float* as = smem_f + kK * kN;            // 2 x (32, 128): A chunk, [k][m]
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  const int grp = blockIdx.y, row0 = kRows * blockIdx.z;
  const int steps = (reps + kRepStep - 1) / kRepStep;
  const int s0 = blockIdx.x * steps_per_slice;
  const int s1 = min(s0 + steps_per_slice, steps);
  if (s0 >= s1) return;

  // C_g once, one cp.async group per K chunk
  const float* cg = c + static_cast<long long>(grp) * kK * kN;
  for (int ch = 0; ch < kChunks; ++ch) {
#pragma unroll
    for (int i = 0; i < kKC * kN / 4 / kThreads; ++i) {
      const int e = ch * kKC * kN + 4 * (tid + kThreads * i);
      cp_async16(cs + e, cg + e);
    }
    cp_commit();
  }

  // split duty: work row srow, chunk columns sk and sk + 16
  const int srow = tid % kRows, sk = tid / kRows;
  const int32_t* wsrc = w + static_cast<long long>(row0 + srow) * kBand + 256 * grp + sk;
  int32_t wn0 = 0, wn1 = 0;                // the next split's two work values
  auto wload = [&](int ch) {
    wn0 = __ldg(wsrc + kKC * ch);
    wn1 = __ldg(wsrc + kKC * ch + 16);
  };
  auto split = [&](int step, int buf) {
    float* dst = as + buf * kKC * kM + srow * 8;
    const uint32_t r0 = static_cast<uint32_t>(kRepStep * step);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t v = static_cast<uint32_t>(h ? wn1 : wn0) + r0;
      float f[8];
#pragma unroll
      for (int j = 0; j < kRepStep; ++j) {
        const int x = static_cast<int>(v + static_cast<uint32_t>(j));   // w + r, wrapped
        f[2 * j] = static_cast<float>(x >> 8);
        f[2 * j + 1] = low_byte(x);
      }
      float* p = dst + (sk + 16 * h) * kM;
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  uint32_t sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};

  const int g0 = s0 * kChunks, g1 = s1 * kChunks;
  wload(0);
  split(s0, 0);
  wload(1);
  cp_wait<kChunks - 1>();                  // this thread's copies of chunk 0
  __syncthreads();
  for (int g = g0; g < g1; ++g) {
    const int ch = g % kChunks, buf = (g - g0) & 1;
    if (g + 1 < g1) {
      split((g + 1) / kChunks, buf ^ 1);
      wload((g + 2) % kChunks);
    }
    const float* ap = as + buf * kKC * kM + 8 * tm;
    const float* bp = cs + ch * kKC * kN + 4 * tn;
#pragma unroll 8
    for (int k = 0; k < kKC; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(ap + k * kM);
      const float4 a1 = *reinterpret_cast<const float4*>(ap + k * kM + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bp + k * kN);
      const float4 b1 = *reinterpret_cast<const float4*>(bp + k * kN + 64);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (ch == kChunks - 1) {               // the step's repeats meet in uint32
      const int r0 = kRepStep * (g / kChunks);
#pragma unroll
      for (int j = 0; j < kRepStep; ++j) {
        if (r0 + j < reps) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
            sum[n] = add_u32(sum[n], mad_u32(f2u(acc[2 * j][n]), 256u, f2u(acc[2 * j + 1][n])));
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[2 * j][n] = acc[2 * j + 1][n] = 0.f;
      }
    }
    if (g - g0 < kChunks - 1) cp_wait_at_most(kChunks - 2 - (g - g0));   // C chunk ch + 1
    __syncthreads();
  }
  uint32_t* orow = out + static_cast<long long>(row0 + tm) * kTW + kN * grp + 4 * tn;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    atomicAdd(orow + j, sum[j]);
    atomicAdd(orow + 64 + j, sum[4 + j]);
  }
}

// ---- kernel I: bf16_1dot -----------------------------------------------------

namespace gb {
constexpr int kThreads = 256;              // two warpgroups of 4 warps
constexpr int kRows = 16;                  // work rows of a block
constexpr int kRepStep = 8;                // repeats a step stacks along M: one a warp
constexpr int kM = kRows * kRepStep;       // 128 A rows a step: m = 16 repeat + row
constexpr int kN = 128, kK = 384, kKC = 64, kChunks = kK / kKC;   // K blocks of 128 bytes
constexpr int kBand = 896, kTW = 384, kTH = 160, kGroups = 3;
constexpr int kBBytes = kN * kKC * 2;      // one K block of C_g: 128 rows x 128 bytes, swizzled
constexpr int kSmemB = kChunks * kBBytes;  // C_g, resident
constexpr int kSmemW = kRows * kK * 4;     // the block's work window, in A-fragment order
constexpr int kSmem = kSmemB + kSmemW + 1024;   // + the alignment slack
static_assert(kM == 2 * 4 * 16, "2 warpgroups x 4 warps x 16 rows a step");
static_assert(kBBytes % 1024 == 0, "K blocks 1024-byte aligned");
static_assert(8 * kRows * kN * 4 <= kSmemB, "the warps' sums fit where C_g was");
static_assert(kSmem <= 232448, "shared memory of one block");
}  // namespace gb

// bf16x2 of two floats, each rounded to the nearest even bf16; f0 in the
// low half
__device__ __forceinline__ uint32_t bf16x2_rn(float f0, float f1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(f0, f1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16x2 of float(x0 + r), float(x1 + r): int32 additions, then one rounding
// to f32 and one to bf16, as the plain version rounds
__device__ __forceinline__ uint32_t bf16x2_of(int x0, int x1, uint32_t r) {
  return bf16x2_rn(__int2float_rn(static_cast<int>(static_cast<uint32_t>(x0) + r)),
                   __int2float_rn(static_cast<int>(static_cast<uint32_t>(x1) + r)));
}

// One warp's share of a block's steps s0 .. s1 - 1 of bf16_1dot: warp w is
// repeat r = 8 step + w, whose 16 A rows of the warpgroup's m64 are the
// block's 16 work rows.  24 K steps of wgmma m64n128k16 with A = bf16(w +
// r) made from the window, then each f32 sum truncated and added into sum
// (uint32).  d: the warp's D rows g and g + 8 (work rows) x columns 8 j +
// 2 q, + 1 (n8 tile j: d[4 j .. 4 j + 3]).  kFloat: the window holds
// float(w) and every |w + r| < 2^24, so float(w + r) is float(w) + r, exact.
template <bool kFloat>
__device__ __forceinline__ void bf16_gemm_steps(const int4* wfrag, uint32_t bbase, int s0, int s1,
                                                int reps, int warp, uint32_t (&sum)[64]) {
  using namespace gb;
  float d[64];
  uint32_t af[2][4];                       // two A sets: K step kk writes set kk & 1
  for (int step = s0; step < s1; ++step) {
    const uint32_t r = static_cast<uint32_t>(kRepStep * step + warp);
    const float rf = static_cast<float>(r);
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      if (step == s0 && kk % 4 == 0 && kk > 0) {   // the first step waits for K block kk / 4
        cp_wait_at_most(kChunks - 1 - kk / 4);
        fence_proxy_async();
        __syncthreads();
      }
      uint32_t (&a)[4] = af[kk & 1];       // the set K step kk - 2 read: retired
      if constexpr (kFloat) {
        const float4 x0 = reinterpret_cast<const float4*>(wfrag)[kk * 64];        // row g
        const float4 x1 = reinterpret_cast<const float4*>(wfrag)[kk * 64 + 32];   // row g + 8
        a[0] = bf16x2_rn(x0.x + rf, x0.y + rf);   // row g, k 2 q, + 1
        a[1] = bf16x2_rn(x1.x + rf, x1.y + rf);   // row g + 8
        a[2] = bf16x2_rn(x0.z + rf, x0.w + rf);   // row g, k 2 q + 8, + 9
        a[3] = bf16x2_rn(x1.z + rf, x1.w + rf);   // row g + 8
      } else {
        const int4 x0 = wfrag[kk * 64], x1 = wfrag[kk * 64 + 32];
        a[0] = bf16x2_of(x0.x, x0.y, r);
        a[1] = bf16x2_of(x1.x, x1.y, r);
        a[2] = bf16x2_of(x0.z, x0.w, r);
        a[3] = bf16x2_of(x1.z, x1.w, r);
      }
      wgmma_fence();
      wgmma_m64n128k16(d, a, desc_sw128(bbase + (kk / 4) * kBBytes + 32 * (kk % 4)), kk > 0);
      wgmma_commit();
      pin(a);
      wgmma_wait<1>();                     // K step kk - 1 retired: its A set is free
    }
    wgmma_wait<0>();
    pin(d);
    if (r < static_cast<uint32_t>(reps)) { // each f32 dot truncated, then summed in uint32
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = add_u32(sum[i], f2u(d[i]));
    }
  }
}

__global__ void __launch_bounds__(gb::kThreads, 1)
xscheme_bf16_gemm(const int32_t* __restrict__ w, const __nv_bfloat16* __restrict__ ck,
                  uint32_t* __restrict__ out, int reps, int steps_per_slice) {
  using namespace gb;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* bsm = align1024(smem_raw);                         // C_g: kChunks K blocks
  int32_t* wsm = reinterpret_cast<int32_t*>(bsm + kSmemB);    // the work window
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = blockIdx.y, row0 = kRows * blockIdx.z;
  const int steps = (reps + kRepStep - 1) / kRepStep;
  const int s0 = blockIdx.x * steps_per_slice;
  const int s1 = min(s0 + steps_per_slice, steps);
  if (s0 >= s1) return;

  // The window: the 8-byte pieces (row, k pair p), k = 2 p, each at its A
  // fragment's slot ((kk * 2 + row / 8) * 32 + 4 (row % 8) + q) * 4 + e, kk
  // = p / 8, q = p % 4, e = 2 (p % 8 / 4), so that a lane reads its K step's
  // values for rows g and g + 8 as two 16-byte words.  It rides in the first
  // cp.async group with K block 0 of C_g; K blocks 1 .. 5 follow, a group
  // each, and the first step computes on block kb while the later ones land.
  const int32_t* wsrc = w + static_cast<long long>(row0) * kBand + 256 * grp;
  for (int i = tid; i < kRows * kK / 2; i += kThreads) {
    const int row = i / (kK / 2), p = i % (kK / 2);
    cp_async8(wsm + ((p / 8 * 2 + row / 8) * 32 + 4 * (row % 8) + p % 4) * 4 + 2 * (p % 8 / 4),
              wsrc + static_cast<long long>(row) * kBand + 2 * p);
  }
  // C_g K-major (ck: (3, 128, 384)): row n of K block kb is columns 64 kb ..
  // of C_g's column n, its 16-byte pieces at piece ^ (n & 7)
  const __nv_bfloat16* cg = ck + static_cast<long long>(grp) * kN * kK;
  for (int kb = 0; kb < kChunks; ++kb) {
    for (int i = tid; i < kN * 8; i += kThreads) {
      const int n = i / 8, pc = i % 8;
      cp_async16(bsm + kb * kBBytes + n * 128 + ((pc ^ (n & 7)) << 4),
                 cg + static_cast<long long>(n) * kK + kKC * kb + 8 * pc);
    }
    cp_commit();
  }

  // Before the first product: the window and K block 0 have landed.  Where
  // every |w + r| of the block's window stays below 2^24, the window is
  // turned into floats in place (exact), and each value of a K step costs
  // one FADD instead of an int32 add and a conversion.
  cp_wait_at_most(kChunks - 1);
  fence_proxy_async();
  __syncthreads();
  const int lim = (1 << 24) - reps;        // |w| < lim: |w + r| < 2^24 for every r
  int wide = 0;
  for (int i = tid; i < kRows * kK; i += kThreads) wide |= wsm[i] >= lim || wsm[i] <= -lim;
  const bool narrow = !__syncthreads_or(wide);
  if (narrow) {
    for (int i = tid; i < kRows * kK; i += kThreads)
      reinterpret_cast<float*>(wsm)[i] = static_cast<float>(wsm[i]);
    __syncthreads();
  }
  uint32_t sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] = 0;
  const int4* wfrag = reinterpret_cast<const int4*>(wsm) + lane;
  if (narrow) bf16_gemm_steps<true>(wfrag, smem_addr(bsm), s0, s1, reps, warp, sum);
  else bf16_gemm_steps<false>(wfrag, smem_addr(bsm), s0, s1, reps, warp, sum);

  // the 8 warps' sums meet in shared memory (where C_g was), then one uint32
  // atomicAdd an output meets the other slices'
  __syncthreads();
  uint32_t* part = reinterpret_cast<uint32_t*>(bsm);         // [warp][row][column]
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int i = 0; i < 64; ++i)
    part[(warp * kRows + g + 8 * (i % 4 / 2)) * kN + 8 * (i / 4) + 2 * q + i % 2] = sum[i];
  __syncthreads();
  for (int e = tid; e < kRows * kN; e += kThreads) {
    uint32_t v = 0;
#pragma unroll
    for (int wp = 0; wp < kThreads / 32; ++wp) v = add_u32(v, part[wp * kRows * kN + e]);
    atomicAdd(out + static_cast<long long>(row0 + e / kN) * kTW + kN * grp + e % kN, v);
  }
}

// ---- kernel I: s16_1dot ------------------------------------------------------

namespace gs {
constexpr int kThreads = 256;              // two warpgroups of 4 warps
constexpr int kRows = 16;                  // work rows of a block
constexpr int kRepStep = 8;                // repeats a step stacks along M: one a warp
constexpr int kCols = 64;                  // output columns of a block: half a group
constexpr int kK = 384, kKC = 128, kKBlocks = kK / kKC;   // K blocks of 128 bytes
constexpr int kKSteps = kK / 32;           // wgmma k32 steps
constexpr int kBand = 896, kTW = 384, kTH = 160, kGN = 128;
constexpr int kBTile = kCols * kKC;        // a byte plane's K block: 64 x 128 bytes, swizzled
constexpr int kSmemB = 2 * kKBlocks * kBTile;   // both byte planes of the taps, resident
constexpr int kSmemW = kRows * kK * 2;     // the block's work window as int16, in A-fragment order
constexpr int kSmem = kSmemB + kSmemW + 1024;   // + the alignment slack
// A warp's accumulators sum its repeats of a slice: at most this many steps,
// so that no s32 sum can leave int32 for any int16 work values and taps
// (384 x 255 x 255 a repeat for the low bytes' product, the largest)
constexpr int kMaxSliceSteps = 64;
static_assert(kBTile % 1024 == 0, "K blocks 1024-byte aligned");
static_assert(8 * kRows * kCols * 4 <= kSmemB, "the warps' sums fit where the taps were");
static_assert(static_cast<long long>(kMaxSliceSteps) * kK * 255 * 255 < (1LL << 31),
              "a slice's s32 sums stay in int32");
static_assert(kSmem <= 232448, "shared memory of one block");
}  // namespace gs

// wgmma m64n64k32 with s32 sums, one per pair of 8-bit types (hopper.cuh)
IQO_WGMMA_I8(wgmma_s8s8, "s8.s8")
IQO_WGMMA_I8(wgmma_s8u8, "s8.u8")
IQO_WGMMA_I8(wgmma_u8s8, "u8.s8")
IQO_WGMMA_I8(wgmma_u8u8, "u8.u8")

// Two int16 (a pair in one word) plus the same 16-bit r in each half
// (rr = r | r << 16), each wrapped to 16 bits: the low 15 bits add, bit 15
// is the sum's, and no carry crosses the halves
__device__ __forceinline__ uint32_t add16x2(uint32_t x, uint32_t rr) {
  return ((x & 0x7FFF7FFFu) + (rr & 0x7FFF7FFFu)) ^ ((x ^ rr) & 0x80008000u);
}

__global__ void __launch_bounds__(gs::kThreads, 1)
xscheme_s16_gemm(const int32_t* __restrict__ w, const uint8_t* __restrict__ ck,
                 uint32_t* __restrict__ out, int reps, int steps_per_slice) {
  using namespace gs;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* bsm = align1024(smem_raw);      // [K block][hi, lo] taps, 64 x 128 bytes each
  uint8_t* wsm = bsm + kSmemB;             // the work window, int16 pairs
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int half = blockIdx.y, grp = half / 2, row0 = kRows * blockIdx.z;
  const int steps = (reps + kRepStep - 1) / kRepStep;
  const int s0 = blockIdx.x * steps_per_slice;
  const int s1 = min(s0 + steps_per_slice, steps);
  if (s0 >= s1) return;

  // the taps' byte planes (ck: (3, 2, 128, 384), K-major): row n of the
  // block's K block kb and plane p is column 64 half' + n of the group,
  // columns 128 kb .. of K, its 16-byte pieces at piece ^ (n & 7); one
  // cp.async group a K block
  const uint8_t* cg = ck + static_cast<long long>(grp) * 2 * kGN * kK;
  for (int kb = 0; kb < kKBlocks; ++kb) {
    for (int i = tid; i < 2 * kCols * 8; i += kThreads) {
      const int p = i / (kCols * 8), n = i / 8 % kCols, pc = i % 8;
      cp_async16(bsm + (2 * kb + p) * kBTile + n * 128 + ((pc ^ (n & 7)) << 4),
                 cg + (static_cast<long long>(p) * kGN + kCols * (half % 2) + n) * kK +
                     kKC * kb + 16 * pc);
    }
    cp_commit();
  }
  // the window: int16(w) of the block's 16 rows over the group's 384
  // columns, element (row, k) at byte ((kk * 2 + row / 8) * 32 + lane) * 16
  // + 8 (k % 32 / 16) + 2 (k % 4), kk = k / 32, lane = 4 (row % 8) + k % 16
  // / 4: lane (g, q) reads its K step's A values of rows g and g + 8 as two
  // 16-byte words, the warp 512 contiguous bytes a word
  const int32_t* wsrc = w + static_cast<long long>(row0) * kBand + 256 * grp;
  for (int i = tid; i < kRows * kK / 2; i += kThreads) {
    const int row = i / (kK / 2), k = 2 * (i % (kK / 2));
    const int2 v = *reinterpret_cast<const int2*>(wsrc + static_cast<long long>(row) * kBand + k);
    const int off = (((k / 32) * 2 + row / 8) * 32 + 4 * (row % 8) + k % 16 / 4) * 16 +
                    8 * (k % 32 / 16) + 2 * (k % 4);
    *reinterpret_cast<uint32_t*>(wsm + off) =
        (static_cast<uint32_t>(v.x) & 0xFFFFu) | (static_cast<uint32_t>(v.y) << 16);
  }
  cp_wait<kKBlocks - 1>();                 // this thread's copies of K block 0
  fence_proxy_async();
  __syncthreads();

  // warp w's 16 A rows of each step are the block's work rows at repeat
  // r = 8 step + w: hh += ah ch, mid += ah cl + al ch, ll += al cl, each over
  // the warp's repeats of the slice; a repeat past reps gives zero A rows
  uint32_t hh[32], mid[32], ll[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) hh[i] = mid[i] = ll[i] = 0;
  const uint4* wfrag = reinterpret_cast<const uint4*>(wsm) + lane;
  const uint32_t bbase = smem_addr(bsm);
  uint32_t ahi[2][4], alo[2][4];           // two A sets: K step kk writes set kk & 1
  for (int step = s0; step < s1; ++step) {
    const uint32_t r = static_cast<uint32_t>(kRepStep * step + warp);
    const bool live = r < static_cast<uint32_t>(reps);
    const uint32_t rr = (r & 0xFFFFu) * 0x10001u;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      if (step == s0 && kk % 4 == 0 && kk > 0) {   // the first step waits for K block kk / 4
        if (kk / 4 == 1) cp_wait<kKBlocks - 2>();
        else cp_wait<0>();
        fence_proxy_async();
        __syncthreads();
      }
      const uint4 x0 = wfrag[(2 * kk) * 32];       // row g: k 4q .. 4q + 3, 16 + 4q ..
      const uint4 x1 = wfrag[(2 * kk + 1) * 32];   // row g + 8
      const uint32_t p[8] = {add16x2(x0.x, rr), add16x2(x0.y, rr), add16x2(x1.x, rr),
                             add16x2(x1.y, rr), add16x2(x0.z, rr), add16x2(x0.w, rr),
                             add16x2(x1.z, rr), add16x2(x1.w, rr)};
      uint32_t (&ah)[4] = ahi[kk & 1];     // the sets K step kk - 2 read: retired
      uint32_t (&al)[4] = alo[kk & 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {        // a_i: rows g, g + 8, g, g + 8; k 4q.., 4q.., 16 + 4q..
        ah[i] = live ? __byte_perm(p[2 * i], p[2 * i + 1], 0x7531) : 0u;   // the high bytes, s8
        al[i] = live ? __byte_perm(p[2 * i], p[2 * i + 1], 0x6420) : 0u;   // the low bytes, u8
      }
      const uint32_t kb = bbase + (kk / 4) * 2 * kBTile + 32 * (kk % 4);
      const uint64_t dh = desc_sw128(kb), dl = desc_sw128(kb + kBTile);
      wgmma_fence();
      wgmma_s8s8(hh, ah, dh);
      wgmma_s8u8(mid, ah, dl);
      wgmma_u8s8(mid, al, dh);
      wgmma_u8u8(ll, al, dl);
      wgmma_commit();
      pin(ah);
      pin(al);
      wgmma_wait<1>();                     // K step kk - 1 retired: its A sets are free
    }
  }
  wgmma_wait<0>();
  pin(hh);
  pin(mid);
  pin(ll);

  // 65536 hh + 256 mid + ll in uint32 (the int32 wrap of the dot, summed
  // over the warp's repeats); the 8 warps' sums meet in shared memory (where
  // the taps were), then one uint32 atomicAdd an output meets the other
  // slices'
  __syncthreads();
  uint32_t* part = reinterpret_cast<uint32_t*>(bsm);         // [warp][row][column]
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    part[(warp * kRows + g + 8 * (i % 4 / 2)) * kCols + 8 * (i / 4) + 2 * q + i % 2] =
        mad_u32(hh[i], 65536u, mad_u32(mid[i], 256u, ll[i]));
  __syncthreads();
  for (int e = tid; e < kRows * kCols; e += kThreads) {
    uint32_t v = 0;
#pragma unroll
    for (int wp = 0; wp < kThreads / 32; ++wp) v = add_u32(v, part[wp * kRows * kCols + e]);
    atomicAdd(out + static_cast<long long>(row0 + e / kCols) * kTW + kCols * half + e % kCols, v);
  }
}

// ---- kernel J: dense4 ------------------------------------------------------

namespace gj {
constexpr int kThreads = 128;              // one warpgroup: 2 (row halves) x 2 (repeat halves)
constexpr int kRows = 16;                  // work rows of a block
constexpr int kRepStep = 8;                // repeats a step stacks along M, 4 a warp
constexpr int kM = kRepStep * 2 * kRows;   // 256 A rows a step (the host's model)
constexpr int kCols = 32;                  // output columns of a block
constexpr int kN = 2 * kCols;              // 64 B rows: cxh's 32 columns, then cxl's
constexpr int kK = 896, kKC = 64, kChunks = kK / kKC;
constexpr int kTW = 384, kTH = 160;
constexpr int kRowBytes = kKC * 2;         // a B row: 8 pieces of 16 bytes, swizzled
constexpr int kWPitch = kKC + 8;           // words a work row: 8-byte loads in 2 wavefronts
constexpr int kStages = 4;
constexpr int kBBytes = kN * kRowBytes;    // a multiple of 1024: every B tile stays aligned
constexpr int kWBytes = kRows * kWPitch * 4;
constexpr int kSmem = kStages * (kBBytes + kWBytes) + 1024;   // + the alignment slack
static_assert(kM == 4 * 4 * 16, "4 warps x 4 wgmma of 16 rows a step");
static_assert(kBBytes % 1024 == 0, "B tiles 1024-byte aligned");
static_assert(kN * 8 == 4 * kThreads && kRows * kKC / 4 == 2 * kThreads, "copies a thread");
static_assert(2 * (kSmem + 1024) <= 233472, "two blocks an SM");
}  // namespace gj

// byte offset of 16-byte piece `piece` of row `row` in a swizzled B tile
__device__ __forceinline__ int swz(int row, int piece) {
  return row * gj::kRowBytes + ((piece ^ (row & 7)) << 4);
}

// bf16x2 of two floats by their high halves: exact for integers of at most
// 8 significant bits (lo in [0, 255]; hi wherever bf16 holds it, which the
// plain version's exact products need as well)
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__global__ void __launch_bounds__(gj::kThreads, 2)
vpu_dense4_gemm(const int32_t* __restrict__ wd, const __nv_bfloat16* __restrict__ cxt,
                uint32_t* __restrict__ out, int reps, int steps_per_slice) {
  using namespace gj;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* bsm = smem_raw + (((raw + 1023) & ~1023u) - raw);   // kStages B tiles
  uint8_t* wsm = bsm + kStages * kBBytes;                        // kStages work-row tiles
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp % 2, wp = warp / 2, g = lane / 4, q = lane % 4;
  const int col0 = kCols * blockIdx.y, row0 = kRows * blockIdx.z;
  const int steps = (reps + kRepStep - 1) / kRepStep;
  const int s0 = blockIdx.x * steps_per_slice;
  const int s1 = min(s0 + steps_per_slice, steps);
  if (s0 >= s1) return;
  const int g0 = s0 * kChunks, g1 = s1 * kChunks;

  // chunk gc's coefficient rows (rows j < 32: cxh's column col0 + j, then
  // cxl's) and work rows into stage (gc - g0) % kStages
  auto load = [&](int gc) {
    const int st = (gc - g0) % kStages;
    const int k0 = kKC * (gc % kChunks);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int piece = tid + kThreads * i, row = piece / 8, pc = piece % 8;
      cp_async16(bsm + st * kBBytes + swz(row, pc),
                 cxt + (static_cast<long long>(row / kCols) * kTW + col0 + row % kCols) * kK +
                     k0 + 8 * pc);
    }
    int32_t* ws = reinterpret_cast<int32_t*>(wsm + st * kWBytes);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int piece = tid + kThreads * i, row = piece / 16, pc = piece % 16;
      cp_async16(ws + row * kWPitch + 4 * pc,
                 wd + static_cast<long long>(row0 + row) * kK + k0 + 4 * pc);
    }
  };

  // acc[tt]: wgmma tt's D, this warp's 16 rows (g: hi, g + 8: lo of work row
  // 8 wr + g, repeat 4 wp + tt of the step) x the 64 B columns: fragment
  // 4 j + i is n8 tile j (j < 4: cxh's columns 8 j .., j >= 4: cxl's)
  float acc[4][32];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;
  uint32_t sum[4][2] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (g0 + st < g1) load(g0 + st);
    cp_commit();
  }
  cp_wait<kStages - 2>();
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");   // cp.async -> wgmma
  __syncthreads();
  for (int gc = g0; gc < g1; ++gc) {       // chunk gc of the slice
    const int t = gc - g0, step = gc / kChunks;
    if (gc + kStages - 1 < g1) load(gc + kStages - 1);
    cp_commit();
    const uint32_t btile = smem_addr(bsm + (t % kStages) * kBBytes);
    const int32_t* wrow = reinterpret_cast<const int32_t*>(wsm + (t % kStages) * kWBytes) +
                          (8 * wr + g) * kWPitch + 2 * q;
    const int r0 = kRepStep * step + 4 * wp;                    // the warp's first repeat
    uint32_t af[2][4][4];                  // [K step & 1][repeat][fragment]
#pragma unroll
    for (int kk = 0; kk < kKC / 16; ++kk) {
      // the A fragments' work values: row g, k = 16 kk + 2 q + {0, 1, 8, 9};
      // the split of w + r0 once, then r0 + 1 .. r0 + 3 by a carry from lo
      const int2 v0 = *reinterpret_cast<const int2*>(wrow + 16 * kk);
      const int2 v1 = *reinterpret_cast<const int2*>(wrow + 16 * kk + 8);
      const int xw[4] = {v0.x, v0.y, v1.x, v1.y};
      float hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = static_cast<int>(static_cast<uint32_t>(xw[e]) + static_cast<uint32_t>(r0));
        hi[e] = static_cast<float>(x >> 8);
        lo[e] = low_byte(x);
      }
      uint32_t (&a)[4][4] = af[kk & 1];    // the set K step kk - 2 read: retired
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        if (tt > 0) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            lo[e] += 1.f;
            const float carry = lo[e] >= 256.f ? 1.f : 0.f;
            lo[e] = fmaf(-256.f, carry, lo[e]);
            hi[e] += carry;
          }
        }
        a[tt][0] = pack_exact(hi[0], hi[1]);
        a[tt][1] = pack_exact(lo[0], lo[1]);
        a[tt][2] = pack_exact(hi[2], hi[3]);
        a[tt][3] = pack_exact(lo[2], lo[3]);
      }
      const uint64_t desc = desc_sw128(btile + 32 * kk);   // K step kk: 32 bytes in
      wgmma_fence();
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) wgmma_m64n64k16(acc[tt], a[tt], desc);
      wgmma_commit();
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) pin(a[tt]);
      wgmma_wait<1>();                     // K step kk - 1 retired: its A set is free
    }
    wgmma_wait<0>();                       // the chunk's B tile is read
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) pin(acc[tt]);
    if (gc % kChunks == kChunks - 1) {     // the step's repeats meet in uint32
#pragma unroll
      for (int tt = 0; tt < 4; ++tt) {
        if (r0 + tt < reps) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c2 = 0; c2 < 2; ++c2) {
              // n8 tile j: cxh, j + 4: cxl; fragment c2: the hi row, 2 + c2: the lo row
              const uint32_t h =
                  add_u32(f2u(acc[tt][4 * j + c2]), f2u(acc[tt][4 * (j + 4) + c2]));
              const uint32_t l =
                  add_u32(f2u(acc[tt][4 * j + 2 + c2]), f2u(acc[tt][4 * (j + 4) + 2 + c2]));
              sum[j][c2] = add_u32(sum[j][c2], mad_u32(h, 256u, l));
            }
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[tt][i] = 0.f;
      }
    }
    cp_wait<kStages - 2>();
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  }
  uint32_t* orow = out + static_cast<long long>(row0 + 8 * wr + g) * kTW + col0 + 2 * q;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c2 = 0; c2 < 2; ++c2) atomicAdd(orow + 8 * j + c2, sum[j][c2]);
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

}  // namespace

extern "C" {

// Raise the four kernels' dynamic shared-memory limits (and prefer shared memory
// over L1) on the current device; call once per device before their first
// launch.
int iqo_exp_xpass_gemm_setup() {
  int rc = static_cast<int>(cudaFuncSetAttribute(
      xscheme_f32_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, gi::kSmem));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      vpu_dense4_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, gj::kSmem));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      xscheme_bf16_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, gb::kSmem));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      xscheme_s16_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, gs::kSmem));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      xscheme_s16_gemm, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      xscheme_f32_gemm, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      xscheme_bf16_gemm, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared));
  if (!rc) rc = static_cast<int>(cudaFuncSetAttribute(
      vpu_dense4_gemm, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared));
  return rc;
}

// The geometry the kernels were built with, for the host's model: shape[0..5]
// kernel I's f32_2dot (threads, rows, repeats a step, K chunk, chunks,
// shared bytes), shape[6..12] kernel J (threads, rows, repeats a step,
// columns, K chunk, chunks, shared bytes), shape[13..18] kernel I's
// bf16_1dot (as f32_2dot's), shape[19..26] kernel I's s16_1dot (threads,
// rows, repeats a step, columns, K block, K blocks, shared bytes, most steps
// a slice).
int iqo_exp_xpass_gemm_shape(int* shape) {
  const int v[27] = {gi::kThreads, gi::kRows, gi::kRepStep, gi::kKC, gi::kChunks, gi::kSmem,
                     gj::kThreads, gj::kRows, gj::kRepStep, gj::kCols, gj::kKC, gj::kChunks,
                     gj::kSmem, gb::kThreads, gb::kRows, gb::kRepStep, gb::kKC, gb::kChunks,
                     gb::kSmem, gs::kThreads, gs::kRows, gs::kRepStep, gs::kCols, gs::kKC,
                     gs::kKBlocks, gs::kSmem, gs::kMaxSliceSteps};
  for (int i = 0; i < 27; ++i) shape[i] = v[i];
  return 0;
}

// Kernel I, f32_2dot: w (160, 896) i32, c (3, 384, 128) f32 -> out (160,
// 384) int32, zeroed by the caller; slices x steps_per_slice covers the
// ceil(reps / 4) steps.
int iqo_exp_xscheme_gemm(const void* w, const void* c, void* out, int reps, int slices,
                         int steps_per_slice, void* stream) {
  if (reps < 1 || slices < 1 || steps_per_slice < 1) return 1008;
  const int steps = (reps + gi::kRepStep - 1) / gi::kRepStep;
  if ((slices - 1) * steps_per_slice >= steps || slices * steps_per_slice < steps) return 1008;
  if (misaligned(w) || misaligned(c) || misaligned(out)) return 1002;
  xscheme_f32_gemm<<<dim3(slices, gi::kGroups, gi::kTH / gi::kRows), gi::kThreads, gi::kSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(w), static_cast<const float*>(c), static_cast<uint32_t*>(out),
      reps, steps_per_slice);
  return static_cast<int>(cudaGetLastError());
}

// Kernel I, bf16_1dot: w (160, 896) i32, ck (3, 128, 384) bf16 (C K-major)
// -> out (160, 384) int32, zeroed by the caller; slices x steps_per_slice
// covers the ceil(reps / 8) steps.
int iqo_exp_xscheme_bf16_gemm(const void* w, const void* ck, void* out, int reps, int slices,
                              int steps_per_slice, void* stream) {
  if (reps < 1 || slices < 1 || steps_per_slice < 1) return 1008;
  const int steps = (reps + gb::kRepStep - 1) / gb::kRepStep;
  if ((slices - 1) * steps_per_slice >= steps || slices * steps_per_slice < steps) return 1008;
  if (misaligned(w) || misaligned(ck) || misaligned(out)) return 1002;
  xscheme_bf16_gemm<<<dim3(slices, gb::kGroups, gb::kTH / gb::kRows), gb::kThreads, gb::kSmem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(w), static_cast<const __nv_bfloat16*>(ck),
      static_cast<uint32_t*>(out), reps, steps_per_slice);
  return static_cast<int>(cudaGetLastError());
}

// Kernel I, s16_1dot: w (160, 896) i32, ck (3, 2, 128, 384) u8 (the taps'
// high and low bytes, K-major) -> out (160, 384) int32, zeroed by the caller;
// slices x steps_per_slice covers the ceil(reps / 8) steps, at most
// kMaxSliceSteps a slice.
int iqo_exp_xscheme_s16_gemm(const void* w, const void* ck, void* out, int reps, int slices,
                             int steps_per_slice, void* stream) {
  if (reps < 1 || slices < 1 || steps_per_slice < 1 || steps_per_slice > gs::kMaxSliceSteps)
    return 1008;
  const int steps = (reps + gs::kRepStep - 1) / gs::kRepStep;
  if ((slices - 1) * steps_per_slice >= steps || slices * steps_per_slice < steps) return 1008;
  if (misaligned(w) || misaligned(ck) || misaligned(out)) return 1002;
  xscheme_s16_gemm<<<dim3(slices, gs::kTW / gs::kCols, gs::kTH / gs::kRows), gs::kThreads,
                     gs::kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(w), static_cast<const uint8_t*>(ck),
      static_cast<uint32_t*>(out), reps, steps_per_slice);
  return static_cast<int>(cudaGetLastError());
}

// Kernel J, dense4: wd (160, 896) i32, cxt (2, 384, 896) bf16 (cxh, cxl
// K-major) -> out (160, 384) int32, zeroed by the caller; slices x
// steps_per_slice covers the ceil(reps / 8) steps.
int iqo_exp_vpu_gemm(const void* wd, const void* cxt, void* out, int reps, int slices,
                     int steps_per_slice, void* stream) {
  if (reps < 1 || slices < 1 || steps_per_slice < 1) return 1008;
  const int steps = (reps + gj::kRepStep - 1) / gj::kRepStep;
  if ((slices - 1) * steps_per_slice >= steps || slices * steps_per_slice < steps) return 1008;
  if (misaligned(wd) || misaligned(cxt) || misaligned(out)) return 1002;
  vpu_dense4_gemm<<<dim3(slices, gj::kTW / gj::kCols, gj::kTH / gj::kRows), gj::kThreads,
                    gj::kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(wd), static_cast<const __nv_bfloat16*>(cxt),
      static_cast<uint32_t*>(out), reps, steps_per_slice);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
