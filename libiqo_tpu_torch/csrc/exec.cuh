// The executable form of a resize launch, the counterpart of the JAX
// package's compiled executables (libiqo_tpu/api.py _ensure_compiled, one
// jax.jit per plan; parallel/sharding.py make_yuv_step_fn, one jit for a
// YUV420 frame's three planes).
//
// An iqo_resize_{tiled,wide,wide_s8,fused}_exec_create entry packs
// everything one launch takes but the frame: the instantiation, the argument
// record, the grid of one frame, the block and the dynamic shared memory.
// The handle is immutable after create; iqo_exec_launch copies the record
// onto its own stack, fills in the source, the output, the frame count and
// the two strides, and launches, so two host threads may share a handle.
// The iqo_resize_* entries are the same create on the stack plus the same
// launch: the general path and the executable share one packing.
// iqo_exec_launch_frame issues a whole YUV420 frame, luma and chroma, in one
// host call (ops/executable.py).  A handle holds no device memory: the tables
// it points at belong to the host's KernelOperands, which outlive it.

#pragma once

#include <new>

#include <cuda_runtime.h>

namespace iqo {

constexpr int kMaxFrames = 65535;   // gridDim.z

struct Exec {
  virtual ~Exec() = default;
  // One resize of n_frames (1..kMaxFrames) frames of src, whose rows are
  // contiguous at any pitch and base address, into dst, contiguous
  // (n_frames, dst_h, dst_w).  Returns a cudaError_t.
  virtual int launch(const void* src, void* dst, int n_frames, long long frame_stride,
                     long long row_stride, cudaStream_t stream) const = 0;
  long long out_frame = 0;          // bytes of one output frame, dst_h * dst_w
};

inline bool frames_ok(int n_frames) { return n_frames >= 1 && n_frames <= kMaxFrames; }

// The handle for a record that `rc` (a cudaError_t from packing it) found
// valid: a heap copy of `e`, written to *out.
template <class E>
int create(const E& e, int rc, void** out) {
  *out = nullptr;
  if (rc != 0) return rc;
  E* h = new (std::nothrow) E(e);
  if (h == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  *out = h;
  return 0;
}

}  // namespace iqo
