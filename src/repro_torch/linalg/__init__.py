from repro_torch.linalg.operators import (DenseSPD, DiagonalOp,
                                          LinearOperator, Stencil2D5,
                                          Stencil3D7, Stencil3D27,
                                          laplacian_2d_spectrum)
from repro_torch.linalg.partition import (PartitionPlan, partition_spd,
                                          plan_for)
from repro_torch.linalg.preconditioners import (BlockJacobi, IdentityPrec,
                                                JacobiPrec, Preconditioner,
                                                spd_check_blockjacobi)
from repro_torch.linalg.sparse import (SlicedEllOp, SparseOp, bandwidth,
                                       degree_sort_permutation, ell_rowsum,
                                       permute_spd, random_fem_icesheet,
                                       random_fem_mesh, rcm_permutation,
                                       rcm_reorder, sliced_ell_reorder,
                                       sparse_from_coo, sparse_from_dense)

__all__ = [
    "LinearOperator", "DiagonalOp", "Stencil2D5", "Stencil3D7",
    "Stencil3D27", "DenseSPD", "laplacian_2d_spectrum", "Preconditioner",
    "IdentityPrec", "JacobiPrec", "BlockJacobi", "spd_check_blockjacobi",
    "SparseOp", "ell_rowsum",
    "sparse_from_coo", "sparse_from_dense", "rcm_permutation", "bandwidth",
    "permute_spd", "rcm_reorder", "random_fem_mesh", "random_fem_icesheet",
    "SlicedEllOp", "degree_sort_permutation", "sliced_ell_reorder",
    "PartitionPlan", "partition_spd", "plan_for",
]
