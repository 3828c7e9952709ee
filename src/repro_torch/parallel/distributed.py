"""Shard-level pieces of the row-partitioned solve (counterpart of parts of
``repro/parallel/distributed.py``).

The operator is split over P shards by rows: the structured stencils by
x-planes (``nx % P == 0``), a ``SparseOp`` by a
:class:`~repro_torch.linalg.partition.PartitionPlan`.  This module holds
what one shard's fused vector phase needs, with the halo left to the
caller's ``prepare``: :func:`fused_spmv_local` picks the superkernel's
halo-extended plug-in for a shard, as ``_fused_spmv_local`` does in the
JAX package, and :func:`halo_first_dim` is the in-process plane halo over
the (P, ...) stack of virtual shards.  The wire forms of the halos, the
partitioned SolverOps and the distributed solve come with the
torch.distributed backend (ROADMAP.md, queue 1 item 2).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels import fused_iter as fi
from repro_torch.kernels import ref

__all__ = ["halo_first_dim", "fused_spmv_local"]


def halo_first_dim(z_local: torch.Tensor, plane: int) -> torch.Tensor:
    """Every shard's halo-extended operand of an x-partitioned grid, in
    one process.  ``z_local`` is the (P, nxl * plane) stack of the shards'
    own planes; shard s's operand is [last plane of s-1 | own | first plane
    of s+1], with zeros where no neighbour exists (the homogeneous
    Dirichlet boundary).  Returns (P, (nxl + 2) * plane)."""
    p = z_local.shape[0]
    g = z_local.reshape(p, -1, plane)
    zero = g.new_zeros((1, 1, plane))
    above = torch.cat([zero, g[:-1, -1:]])
    below = torch.cat([g[1:, :1], zero])
    return torch.cat([above, g, below], dim=1).reshape(p, -1)


def fused_spmv_local(op, loc: dict, n_shards: int,
                     prepare: Callable[[torch.Tensor], torch.Tensor] | None
                     ) -> fi.FusedSpmv | None:
    """The superkernel's plug-in for one shard of ``op``, or None where the
    JAX package has no fused path for a shard: ``Stencil3D27``, and a
    kernel-routed operator (``use_kernel``).

    ``loc`` holds the shard's arrays: ``d`` (its slice of a
    ``DiagonalOp``'s diagonal), or ``cols``/``vals`` and
    ``send_up``/``send_dn`` (its rows of a ``PartitionPlan``).
    ``prepare(z_top)`` builds the halo-extended operand from the shard's
    ring-top row: (nxl + 2) x-planes for the stencils, [own | from prev |
    from next] for a ``SparseOp``; the diagonal needs none.  The plug-in
    evaluates the shard expression of the JAX package's
    ``_fused_spmv_local`` term by term."""
    from repro_torch.linalg.operators import (DiagonalOp, Stencil2D5,
                                              Stencil3D7)
    from repro_torch.linalg.sparse import SparseOp

    if isinstance(op, DiagonalOp):
        return fi.diagonal_spmv(loc["d"])
    if getattr(op, "use_kernel", False):
        return None                  # kernel-in-kernel: no fused mirror
    if isinstance(op, SparseOp):
        cols, vals = loc["cols"], loc["vals"]
        hops, max_send = loc["send_up"].shape[-2:]
        return fi.ell_spmv(cols, vals, prepare,
                           int(cols.shape[0]) + 2 * hops * max_send)
    if isinstance(op, Stencil2D5):
        nxl, ny = op.nx // n_shards, op.ny
        return fi.resident_spmv(
            "stencil2d5", lambda z: ref.stencil2d5_halo_ref(z, nxl, ny),
            (nxl, ny), prepare=prepare)
    if isinstance(op, Stencil3D7):
        nxl, ny, nz, ez = op.nx // n_shards, op.ny, op.nz, op.eps_z
        return fi.resident_spmv(
            "stencil3d7",
            lambda z: ref.stencil3d7_halo_ref(z, nxl, ny, nz, ez),
            (nxl, ny, nz), ez, prepare=prepare)
    return None
