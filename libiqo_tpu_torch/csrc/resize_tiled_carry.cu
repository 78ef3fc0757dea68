// The row-halo carry form of the tiled resize kernel (resize_tiled.cuh,
// kCarry: LIBIQO_TPU_CARRY, the TPU's K9): its twelve instantiations, in a
// translation unit of their own so that nvcc builds the forms side by side.

#include "resize_tiled.cuh"

template struct iqo_tiled::Form<false, true>;
