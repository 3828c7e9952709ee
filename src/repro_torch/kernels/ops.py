"""Public wrappers around the port's kernels (counterpart of
``repro/kernels/ops.py:31-178``): the fused-iteration factory with its
operator plug-ins, and the standalone stencil applies."""

from __future__ import annotations

import torch

from repro_torch.kernels import fused_iter as _fi
from repro_torch.kernels import stencil_spmv as _ss


def _local_fused_spmv(op):
    """Single-device :class:`~repro_torch.kernels.fused_iter.FusedSpmv`
    for the operator, mirroring its plain ``apply`` term by term; None when
    unsupported.  ``use_kernel`` operators are refused as in the JAX
    package: their apply goes through the standalone stencil kernel, and
    the superkernel mirrors the plain expressions instead."""
    from repro_torch.linalg.operators import (DiagonalOp, Stencil2D5,
                                              Stencil3D7, Stencil3D27)

    if isinstance(op, DiagonalOp):
        return _fi.diagonal_spmv(op.d)
    if getattr(op, "use_kernel", False):
        return None
    if isinstance(op, Stencil2D5):
        return _fi.resident_spmv("stencil2d5", op.apply, (op.nx, op.ny))
    if isinstance(op, Stencil3D7):
        return _fi.resident_spmv("stencil3d7", op.apply,
                                 (op.nx, op.ny, op.nz), op.eps_z)
    if isinstance(op, Stencil3D27):
        return _fi.resident_spmv("stencil3d27", op.apply,
                                 (op.nx, op.ny, op.nz), op.centre)
    # Sparse (ELL) operators join with ROADMAP.md queue 1, item 4.
    return None


def fused_iteration_factory(op, prec=None):
    """Factory for the fused-iteration superkernel on one device, or None
    when the (operator, preconditioner) pair has no fused path: an
    unsupported operator kind, a kernel-routed stencil, or a
    preconditioner that is not pointwise.  ``factory(layout)`` returns
    the per-iteration ``fiter(S, idx, scal)``."""
    from repro_torch.linalg.preconditioners import IdentityPrec, JacobiPrec

    if prec is None or isinstance(prec, IdentityPrec):
        inv_diag = None
    elif isinstance(prec, JacobiPrec):
        inv_diag = prec.inv_diag
    else:
        return None
    spmv = _local_fused_spmv(op)
    if spmv is None:
        return None

    def factory(layout):
        return _fi.build_fused_iteration(layout, spmv, inv_diag)

    return factory


def stencil2d5_apply(g: torch.Tensor) -> torch.Tensor:
    """The CUDA stencil kernel needs no padding or blocking on the host:
    it reads its neighbours and the Dirichlet zeros itself."""
    return _ss.stencil2d5(g.contiguous())


def stencil3d7_apply(g: torch.Tensor, eps_z: float = 1.0) -> torch.Tensor:
    return _ss.stencil3d7(g.contiguous(), eps_z)
