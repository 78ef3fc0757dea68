// The tiled resize kernel's exact form and its C entry points.  The kernel,
// its design and the TPU kernels it replaces are described in
// resize_tiled.cuh; the relaxed, carry and relaxed carry forms are
// instantiated in resize_tiled_relaxed.cu, resize_tiled_carry.cu and
// resize_tiled_relaxed_carry.cu.

#include "resize_tiled.cuh"

namespace iqo_tiled {

extern template struct Form<true, false>;
extern template struct Form<false, true>;
extern template struct Form<true, true>;

}  // namespace iqo_tiled

namespace {

using iqo_tiled::Form;

int set_max_smem(int relaxed, int carry, int bytes) {
  if (relaxed) return carry ? Form<true, true>::set_max_smem(bytes)
                            : Form<true, false>::set_max_smem(bytes);
  return carry ? Form<false, true>::set_max_smem(bytes) : Form<false, false>::set_max_smem(bytes);
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

// Raises the 48 instantiations' dynamic shared-memory limit on the current
// device to `bytes` (the four forms, twelve each).  Returns a cudaError_t.
int iqo_tiled_set_max_smem(int bytes) {
  for (int k = 0; k < 4; ++k) {
    const int rc = set_max_smem(k & 2, k & 1, bytes);
    if (rc != 0) return rc;
  }
  return 0;
}

// Launches one tiled resize of n_frames frames on `stream`: the wrap16
// (Lanczos) or u16 (Area, Linear) instantiation, its Y pass on the tensor
// cores when s8y is nonzero, tw output columns per block; its relaxed form
// when relaxed is nonzero (planes: X coefficient planes per phase, 1 or 2),
// its carry form when carry is nonzero (run row tiles per block, a ring of
// slots rows; otherwise both are unread).  Allocates nothing; dst is
// contiguous (n_frames, dst_h, dst_w); source rows are contiguous at any
// pitch and base address.  Returns a cudaError_t.
int iqo_resize_tiled(int wrap16, int s8y, int tw, int relaxed, int carry, const void* src,
                     void* dst, int n_frames, long long src_frame_stride,
                     long long src_row_stride, int src_w, int dst_h, int dst_w,
                     const void* rrec, int rrec_words, const void* crec,
                     int crec_words, int taps_y, int taps_x, int k_rows,
                     int pitch, int margin, int work_pitch, int max_phases,
                     int y_bias, int out_shift, int planes, int run, int slots,
                     void* stream) {
  const iqo_tiled::TiledArgs a{
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), src_frame_stride,
      src_row_stride, src_w, dst_h, dst_w, static_cast<const int32_t*>(rrec),
      static_cast<const int32_t*>(crec), rrec_words, crec_words, taps_y, taps_x, k_rows,
      pitch, margin, work_pitch, max_phases, y_bias, out_shift, planes, run, slots};
  const auto s = static_cast<cudaStream_t>(stream);
  if (relaxed) {
    return carry ? Form<true, true>::launch(wrap16, s8y, tw, a, n_frames, s)
                 : Form<true, false>::launch(wrap16, s8y, tw, a, n_frames, s);
  }
  return carry ? Form<false, true>::launch(wrap16, s8y, tw, a, n_frames, s)
               : Form<false, false>::launch(wrap16, s8y, tw, a, n_frames, s);
}

}  // extern "C"
