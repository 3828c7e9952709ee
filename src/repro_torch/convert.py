"""Carry the JAX package's data across into the port's objects.

The JAX objects are handed over as numpy arrays and plain fields (this
module imports nothing of ``repro``); the tests extract them, so both
packages solve the identical system from the identical shifts:

* operators: ``kind`` plus grid sizes, ``eps_z``/``centre``, or a
  ``DiagonalOp``'s ``d`` (:func:`operator`, and :func:`operator_fields`
  for the way back);
* ``JacobiPrec.inv_diag`` (:func:`jacobi`);
* Chebyshev ``sigmas`` (:func:`sigmas`);
* a vector-phase ``(S, idx, scal)`` triple (:func:`vector_phase`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import as_tensor, resolve_device
from repro_torch.linalg.operators import (DenseSPD, DiagonalOp, Stencil2D5,
                                          Stencil3D7, Stencil3D27)
from repro_torch.linalg.preconditioners import JacobiPrec

OPERATOR_KINDS = ("stencil2d5", "stencil3d7", "stencil3d27", "diagonal",
                  "dense")


def operator(kind: str, device=None, **fields):
    """A port operator from the fields of its JAX counterpart:
    ``stencil2d5`` (nx, ny[, use_kernel]), ``stencil3d7`` (nx, ny, nz,
    eps_z[, use_kernel]), ``stencil3d27`` (nx, ny, nz, centre),
    ``diagonal`` (d), ``dense`` (a)."""
    if kind == "stencil2d5":
        return Stencil2D5(int(fields["nx"]), int(fields["ny"]),
                          use_kernel=bool(fields.get("use_kernel", False)),
                          device=device)
    if kind == "stencil3d7":
        return Stencil3D7(int(fields["nx"]), int(fields["ny"]),
                          int(fields["nz"]), eps_z=float(fields["eps_z"]),
                          use_kernel=bool(fields.get("use_kernel", False)),
                          device=device)
    if kind == "stencil3d27":
        return Stencil3D27(int(fields["nx"]), int(fields["ny"]),
                           int(fields["nz"]),
                           centre=float(fields["centre"]), device=device)
    if kind == "diagonal":
        return DiagonalOp(as_tensor(np.asarray(fields["d"]), device),
                          device=resolve_device(device))
    if kind == "dense":
        return DenseSPD(as_tensor(np.asarray(fields["a"]), device),
                        device=resolve_device(device))
    raise ValueError(f"unknown operator kind {kind!r}; "
                     f"available: {', '.join(OPERATOR_KINDS)}")


def operator_fields(op) -> dict:
    """The plain fields :func:`operator` takes, for a port operator."""
    if isinstance(op, Stencil2D5):
        return {"kind": "stencil2d5", "nx": op.nx, "ny": op.ny,
                "use_kernel": op.use_kernel}
    if isinstance(op, Stencil3D7):
        return {"kind": "stencil3d7", "nx": op.nx, "ny": op.ny, "nz": op.nz,
                "eps_z": op.eps_z, "use_kernel": op.use_kernel}
    if isinstance(op, Stencil3D27):
        return {"kind": "stencil3d27", "nx": op.nx, "ny": op.ny,
                "nz": op.nz, "centre": op.centre}
    if isinstance(op, DiagonalOp):
        return {"kind": "diagonal", "d": op.d.cpu().numpy()}
    if isinstance(op, DenseSPD):
        return {"kind": "dense", "a": op.a.cpu().numpy()}
    raise TypeError(f"no field form for {type(op).__name__}")


def jacobi(inv_diag, device=None) -> JacobiPrec:
    return JacobiPrec(inv_diag=as_tensor(np.asarray(inv_diag), device))


def sigmas(sig, device=None) -> torch.Tensor:
    return as_tensor(np.asarray(sig), device)


def vector_phase(S, idx, scal, device=None):
    """A ``(S, idx, scal)`` triple: fp64 slab, int32 index vector, fp64
    scalar vector, all on ``device``."""
    return (as_tensor(np.asarray(S), device),
            as_tensor(np.asarray(idx), device, torch.int32),
            as_tensor(np.asarray(scal), device))
