// Fused-iteration superkernel instantiated for the ELL SPMV plug-in (the
// Pallas plug-in `ell_spmv` of repro/kernels/fused_iter.py; see
// fused_iter.cuh for what it computes and the bound it faces).
#include "fused_iter.cuh"

FI_DEFINE_ENTRY(fused_iter_ell, fi::SPMV_ELL)
