"""CGProblem -> LinearOperator (the one place ``kind`` strings
are interpreted)."""

from __future__ import annotations

from repro_torch.configs.laplace2d import CGProblem
from repro_torch.linalg.operators import (DiagonalOp, LinearOperator,
                                          Stencil2D5, Stencil3D7,
                                          laplacian_2d_spectrum)


def build_operator(prob: CGProblem, device=None) -> LinearOperator:
    if prob.kind == "stencil2d":
        return Stencil2D5(prob.nx, prob.ny, device=device)
    if prob.kind == "stencil3d":
        return Stencil3D7(prob.nx, prob.ny, prob.nz, eps_z=prob.eps_z,
                          device=device)
    if prob.kind == "diagonal":
        return DiagonalOp(laplacian_2d_spectrum(prob.nx, prob.ny,
                                                device=device))
    if prob.kind == "unstructured":
        raise NotImplementedError(
            "unstructured problems are not ported yet (ROADMAP.md, queue 1 "
            "item 4)")
    raise ValueError(f"unknown problem kind {prob.kind!r}")
