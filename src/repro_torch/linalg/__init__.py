from repro_torch.linalg.operators import (DenseSPD, DiagonalOp,
                                          LinearOperator, Stencil2D5,
                                          Stencil3D7, Stencil3D27,
                                          laplacian_2d_spectrum)
from repro_torch.linalg.preconditioners import (BlockJacobi, IdentityPrec,
                                                JacobiPrec, Preconditioner)

__all__ = [
    "LinearOperator", "DiagonalOp", "Stencil2D5", "Stencil3D7",
    "Stencil3D27", "DenseSPD", "laplacian_2d_spectrum", "Preconditioner",
    "IdentityPrec", "JacobiPrec", "BlockJacobi",
]
