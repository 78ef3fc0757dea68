// The tiled resize kernel's exact form and its C entry points.  The kernel,
// its design and the TPU kernels it replaces are described in
// resize_tiled.cuh; the relaxed, carry and relaxed carry forms are
// instantiated in resize_tiled_relaxed.cu, resize_tiled_carry.cu and
// resize_tiled_relaxed_carry.cu.  Its executable form (exec.cuh) is
// TiledExec: the record and geometry of Form::configure, launched per call.

#include "exec.cuh"
#include "resize_tiled.cuh"

namespace iqo_tiled {

extern template struct Form<true, false>;
extern template struct Form<false, true>;
extern template struct Form<true, true>;

}  // namespace iqo_tiled

namespace {

using iqo_tiled::Form;
using iqo_tiled::Kernel;
using iqo_tiled::TiledArgs;

int set_max_smem(int relaxed, int carry, int bytes) {
  if (relaxed) return carry ? Form<true, true>::set_max_smem(bytes)
                            : Form<true, false>::set_max_smem(bytes);
  return carry ? Form<false, true>::set_max_smem(bytes) : Form<false, false>::set_max_smem(bytes);
}

struct TiledExec final : iqo::Exec {
  Kernel kernel = nullptr;
  dim3 grid;                 // of one frame
  int smem = 0;
  TiledArgs a{};             // src, dst and the strides filled in per launch

  int launch(const void* src, void* dst, int n_frames, long long frame_stride,
             long long row_stride, cudaStream_t stream) const override {
    if (!iqo::frames_ok(n_frames)) return static_cast<int>(cudaErrorInvalidValue);
    TiledArgs args = a;
    args.src = static_cast<const uint8_t*>(src);
    args.dst = static_cast<uint8_t*>(dst);
    args.frame_stride = frame_stride;
    args.row_stride = row_stride;
    kernel<<<dim3(grid.x, grid.y, n_frames), iqo_tiled::kThreads, smem, stream>>>(args);
    return static_cast<int>(cudaGetLastError());
  }
};

// The instantiation of form (relaxed, carry) for (wrap16, s8y, tw) and its
// geometry for e's record.  Returns a cudaError_t.
int configure(TiledExec& e, int wrap16, int s8y, int tw, int relaxed, int carry) {
  if (relaxed)
    return carry ? Form<true, true>::configure(wrap16, s8y, tw, e.a, &e.kernel, &e.grid, &e.smem)
                 : Form<true, false>::configure(wrap16, s8y, tw, e.a, &e.kernel, &e.grid, &e.smem);
  return carry ? Form<false, true>::configure(wrap16, s8y, tw, e.a, &e.kernel, &e.grid, &e.smem)
               : Form<false, false>::configure(wrap16, s8y, tw, e.a, &e.kernel, &e.grid, &e.smem);
}

// Packs one tiled resize into e: the record of the arguments below and the
// geometry of its form (relaxed, carry).  Returns a cudaError_t.
int pack(TiledExec& e, int wrap16, int s8y, int tw, int relaxed, int carry, int src_w,
         int dst_h, int dst_w, const void* rrec, int rrec_words, const void* crec,
         int crec_words, int taps_y, int taps_x, int k_rows, int pitch, int margin,
         int work_pitch, int max_phases, int y_bias, int out_shift, int planes, int run,
         int slots, int x_step) {
  e.a = TiledArgs{nullptr, nullptr, 0, 0, src_w, dst_h, dst_w,
                  static_cast<const int32_t*>(rrec), static_cast<const int32_t*>(crec),
                  rrec_words, crec_words, taps_y, taps_x, k_rows, pitch, margin, work_pitch,
                  max_phases, y_bias, out_shift, planes, run, slots, x_step};
  e.out_frame = static_cast<long long>(dst_h) * dst_w;
  return configure(e, wrap16, s8y, tw, relaxed, carry);
}

}  // namespace

extern "C" {

// Rows per tile and the column widths the tiled kernel is built for, read by
// the host (cuda_resize.TILED_WIDTHS).  Returns the number of widths.
int iqo_tiled_shape(int* rows, int* widths, int n) {
  *rows = iqo_tiled::kRows;
  for (int i = 0; i < 3 && i < n; ++i) widths[i] = iqo_tiled::kWidths[i];
  return 3;
}

// The X pass's window form (resize_tiled.cuh, 5b): the most work values a
// thread's window holds and the largest step between its outputs' first
// taps, read by the host (cuda_resize.X_WINDOW, X_STEPS).
void iqo_tiled_x_window(int* values, int* steps) {
  *values = iqo_tiled::kXWindow;
  *steps = iqo_tiled::kXSteps;
}

// What the card makes of one instantiation (wrap16, s8y, tw, relaxed,
// carry; the X window's when x_step is nonzero) at `smem` bytes of dynamic
// shared memory: info[0] its registers a thread, info[1] its local memory
// bytes a thread (spills), info[2] its resident blocks an SM.  Returns a
// cudaError_t.
int iqo_tiled_kernel_info(int wrap16, int s8y, int tw, int relaxed, int carry, int x_step,
                          int smem, int* info) {
  TiledExec e;
  e.a.run = 1;
  e.a.x_step = x_step;
  const int rc = configure(e, wrap16, s8y, tw, relaxed, carry);
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(e.kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], e.kernel, iqo_tiled::kThreads,
                                                      smem);
  return static_cast<int>(err);
}

// Raises the 72 instantiations' dynamic shared-memory limit on the current
// device to `bytes` (the four forms, twelve per-tap each, and twelve of the X
// window in the exact and carry forms).  Returns a cudaError_t.
int iqo_tiled_set_max_smem(int bytes) {
  for (int k = 0; k < 4; ++k) {
    const int rc = set_max_smem(k & 2, k & 1, bytes);
    if (rc != 0) return rc;
  }
  return 0;
}

// The executable of one tiled resize: the wrap16 (Lanczos) or u16 (Area,
// Linear) instantiation, its Y pass on the tensor cores when s8y is nonzero,
// tw output columns per block; its relaxed form when relaxed is nonzero
// (planes: X coefficient planes per phase, 1 or 2), its carry form when
// carry is nonzero (run row tiles per block, a ring of slots rows; otherwise
// both are unread); the X pass's window form at x_step when it is nonzero
// (exact forms; cuda_resize.tiled_layout).  Writes the handle to *out
// (iqo_exec_launch, iqo_exec_destroy).  Returns a cudaError_t.
int iqo_resize_tiled_exec_create(int wrap16, int s8y, int tw, int relaxed, int carry,
                                 int src_w, int dst_h, int dst_w, const void* rrec,
                                 int rrec_words, const void* crec, int crec_words, int taps_y,
                                 int taps_x, int k_rows, int pitch, int margin, int work_pitch,
                                 int max_phases, int y_bias, int out_shift, int planes, int run,
                                 int slots, int x_step, void** out) {
  TiledExec e;
  const int rc = pack(e, wrap16, s8y, tw, relaxed, carry, src_w, dst_h, dst_w, rrec, rrec_words,
                      crec, crec_words, taps_y, taps_x, k_rows, pitch, margin, work_pitch,
                      max_phases, y_bias, out_shift, planes, run, slots, x_step);
  return iqo::create(e, rc, out);
}

// Launches one tiled resize of n_frames frames on `stream`: the executable
// of iqo_resize_tiled_exec_create with the same arguments, made on the stack
// and launched once.  Allocates nothing; dst is contiguous (n_frames,
// dst_h, dst_w); source rows are contiguous at any pitch and base address.
// Returns a cudaError_t.
int iqo_resize_tiled(int wrap16, int s8y, int tw, int relaxed, int carry, const void* src,
                     void* dst, int n_frames, long long src_frame_stride,
                     long long src_row_stride, int src_w, int dst_h, int dst_w,
                     const void* rrec, int rrec_words, const void* crec,
                     int crec_words, int taps_y, int taps_x, int k_rows,
                     int pitch, int margin, int work_pitch, int max_phases,
                     int y_bias, int out_shift, int planes, int run, int slots, int x_step,
                     void* stream) {
  TiledExec e;
  const int rc = pack(e, wrap16, s8y, tw, relaxed, carry, src_w, dst_h, dst_w, rrec, rrec_words,
                      crec, crec_words, taps_y, taps_x, k_rows, pitch, margin, work_pitch,
                      max_phases, y_bias, out_shift, planes, run, slots, x_step);
  if (rc != 0) return rc;
  return e.launch(src, dst, n_frames, src_frame_stride, src_row_stride,
                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
