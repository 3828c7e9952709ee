// Fused-iteration superkernel instantiated for the stencil3d27 SPMV plug-in
// (see fused_iter.cuh for what it computes, the Pallas kernel it replaces
// and the bound it faces).
#include "fused_iter.cuh"

FI_DEFINE_ENTRY(fused_iter_stencil3d27, fi::SPMV_3D27)
