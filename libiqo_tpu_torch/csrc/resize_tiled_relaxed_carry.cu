// The relaxed carry form of the tiled resize kernel (resize_tiled.cuh,
// kRelaxed and kCarry: K7 with K9): its twelve instantiations, in a
// translation unit of their own so that nvcc builds the forms side by side.

#include "resize_tiled.cuh"

template struct iqo_tiled::Form<true, true>;
