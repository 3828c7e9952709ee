// Fused-iteration superkernel instantiated for the halo-extended ell SPMV
// plug-in of one shard of a row partition (the Pallas plug-in fed by
// repro/parallel/distributed.py's _fused_spmv_local; see fused_iter.cuh for
// what it computes and the bound it faces).
#include "fused_iter.cuh"

FI_DEFINE_ENTRY(fused_iter_ell_halo, fi::SPMV_ELL_HALO)
