// The relaxed form of the tiled resize kernel (resize_tiled.cuh, kRelaxed:
// precision="relaxed", the TPU's K7): its twelve instantiations, in a
// translation unit of their own so that nvcc builds the forms side by side.

#include "resize_tiled.cuh"

template struct iqo_tiled::Form<true, false>;
