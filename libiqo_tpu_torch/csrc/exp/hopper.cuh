// Hopper (sm_90a) building blocks of the probes' wgmma kernels
// (exp_xpass_gemm.cu, exp_xpass_s8.cu, exp_mma_wgmma.cu, ...): shared-memory
// addresses, cp.async, mbarriers, TMA tensor loads and bulk tensor stores with
// their host-side encoder, 1-D bulk copies, thread block clusters (ranks,
// mapa, the cluster barrier, distributed shared-memory loads), named
// barriers, and wgmma with its fences,
// 128-byte-swizzle descriptors and register pins; the X-pass probes' uint32
// arithmetic, and the 8-bit wgmma products with s32 sums
// (IQO_WGMMA_I8 at N = 64, IQO_WGMMA_I8_N128 at N = 128), which a source
// instantiates by name.
//
// Everything but the macros sits in an anonymous namespace: each source that
// includes the header gets its own copy, and the shared library exports none
// of it.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the first 1024-byte-aligned address at or after p (the 128-byte swizzle's
// tiles must start there)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  const uint32_t s = smem_addr(p);
  return p + (((s + 1023) & ~1023u) - s);
}

// ---- cp.async ----------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// cp.async (generic proxy) writes -> wgmma (async proxy) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- mbarriers and TMA ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count));
}

// after every mbar_init, before any thread or TMA uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  fence_proxy_async();
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One TMA box of a 2-D map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int x, int y,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_addr(bar))
      : "memory");
}

// One TMA box from shared memory into a 2-D map (a bulk-group store); the
// writes to `src` must be fenced to the async proxy first.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int x, int y,
                                             const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], [%3];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(x), "r"(y), "r"(smem_addr(src))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global memory into the shared memory at cluster address `dst`,
// completing on the mbarrier at cluster address `bar` in the same block (a
// block's own shared-memory addresses are cluster addresses too).
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst, const void* src, uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- thread block clusters ------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the cluster address of this block's shared-memory object `p` in block
// `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(smem_addr(p)), "r"(rank));
  return d;
}

// The cluster barrier, in halves for work between them: every thread of every
// block of the cluster arrives (release), then waits (acquire) until all have,
// so that what each did before its arrival is seen by all after the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// a barrier of `threads` threads (a multiple of 32) on named barrier `id`
// (1 .. 15; 0 is __syncthreads')
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint: the library
// links no libcuda by name.
inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D map of `rows` rows of `cols` elements of `esize` bytes (`type`),
// moved in boxes of box_rows x 128 bytes with the 128-byte swizzle (16-byte
// piece p of box row r sits at piece p ^ (r & 7)): the layout desc_sw128
// names.  0, or 1010 / 1009 when the encoder is missing or refuses the map.
inline int encode_sw128(CUtensorMap* map, const void* base, CUtensorMapDataType type, int esize,
                        long long cols, long long rows, int box_rows) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return 1010;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols * esize)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / esize),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estrides[2] = {1, 1};
  const CUresult rc = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, estrides,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : 1009;
}

// ---- wgmma -------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The descriptor of a K-major tile in shared memory with the 128-byte
// swizzle: rows of 128 bytes whose 16-byte pieces sit at piece ^ (row & 7),
// 8-row groups 1024 bytes apart, the tile 1024-byte aligned.  A K step
// inside the 128 bytes advances the start address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Hold registers that an in-flight wgmma reads (A) or writes (D) until the
// wait that retires it: the compiler may not reuse or read them before.
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// ---- integer helpers of the X-pass probes ------------------------------------------

// uint32 multiply-add and add in inline PTX: the intended int32 wraps of the
// repeat loops, which the compiler cannot fold
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

}  // namespace

// The 64 accumulator operands of an m64n128 wgmma (%0 .. %63) and their
// constraints: IQO_ACC64("+f", d) or IQO_ACC64("+r", d).
#define IQO_D64                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "    \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define IQO_ACC8(c, d, i)                                                                   \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]),    \
      c(d[i + 7])
#define IQO_ACC64(c, d)                                                                     \
  IQO_ACC8(c, d, 0), IQO_ACC8(c, d, 8), IQO_ACC8(c, d, 16), IQO_ACC8(c, d, 24),             \
      IQO_ACC8(c, d, 32), IQO_ACC8(c, d, 40), IQO_ACC8(c, d, 48), IQO_ACC8(c, d, 56)

// wgmma (sm_90a): D[64 x 64] += A[64 x 32] (registers, 8-bit) x B[32 x 64]
// (shared, by descriptor, K-major), s32 accumulators; A's and B's types
// (s8 or u8) are named by the instruction
#define IQO_WGMMA_I8(name, types)                                                              \
  __device__ __forceinline__ void name(uint32_t(&d)[32], const uint32_t(&a)[4], uint64_t b) {  \
    asm volatile(                                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                            \
        "wgmma.mma_async.sync.aligned.m64n64k32.s32." types " "                                 \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "               \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "     \
        "{%32, %33, %34, %35}, %36, p;\n}\n"                                                    \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),  \
          "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),           \
          "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),        \
          "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),        \
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),        \
          "+r"(d[31])                                                                          \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                         \
  }

// The same at N = 128: D[64 x 128] += A[64 x 32] (registers) x B[32 x 128]
// (shared, K-major: 128 rows of the swizzled tile), 64 s32 accumulators
#define IQO_WGMMA_I8_N128(name, types)                                                         \
  __device__ __forceinline__ void name(uint32_t(&d)[64], const uint32_t(&a)[4], uint64_t b) {  \
    asm volatile(                                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                            \
        "wgmma.mma_async.sync.aligned.m64n128k32.s32." types " " IQO_D64                       \
        ", {%64, %65, %66, %67}, %68, p;\n}\n"                                                  \
        : IQO_ACC64("+r", d)                                                                   \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));                         \
  }
