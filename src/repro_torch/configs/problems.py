"""CGProblem -> LinearOperator (the one place ``kind`` strings
are interpreted).

``unstructured`` problems are generated and RCM-ordered on the host
(numpy, as the JAX package does) and moved to ``device`` at the end."""

from __future__ import annotations

from repro_torch.configs.laplace2d import CGProblem
from repro_torch.device import resolve_device
from repro_torch.linalg.operators import (DiagonalOp, LinearOperator,
                                          Stencil2D5, Stencil3D7,
                                          laplacian_2d_spectrum)
from repro_torch.linalg.sparse import (random_fem_icesheet, random_fem_mesh,
                                       rcm_reorder)


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
        dev = resolve_device(device)    # raise before the host work
        if prob.nz > 1:
            op = random_fem_icesheet(prob.seed, prob.nx, prob.ny, prob.nz,
                                     eps_z=prob.eps_z, device="cpu")
        else:
            op = random_fem_mesh(prob.seed, prob.nx * prob.ny, device="cpu")
        return rcm_reorder(op)[0].to(dev)
    raise ValueError(f"unknown problem kind {prob.kind!r}")
