// Fused-iteration superkernel instantiated for the stencil2d5 SPMV plug-in
// (see fused_iter.cuh for what it computes, the Pallas kernel it replaces
// and the bound it faces).
#include "fused_iter.cuh"

FI_DEFINE_ENTRY(fused_iter_stencil2d5, fi::SPMV_2D5)
