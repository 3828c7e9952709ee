"""Preconditioners M^{-1} for the CG family (counterpart of
``repro/linalg/preconditioners.py``): identity, pointwise Jacobi, and
block-Jacobi (contiguous row blocks, each solved with the dense inverse
of its diagonal block; the ice-sheet configs' preconditioner).  Only the
first two have a fused superkernel path; block-Jacobi runs unfused, as in
the JAX package."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.linalg.operators import LinearOperator
from repro_torch.linalg.sparse import SparseOp, bandwidth


class Preconditioner:
    def apply(self, x: torch.Tensor) -> torch.Tensor:  # M^{-1} x
        raise NotImplementedError

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)


@dataclasses.dataclass(frozen=True)
class IdentityPrec(Preconditioner):
    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return x


@dataclasses.dataclass(frozen=True)
class JacobiPrec(Preconditioner):
    inv_diag: torch.Tensor

    @staticmethod
    def from_operator(op: LinearOperator) -> "JacobiPrec":
        return JacobiPrec(inv_diag=1.0 / op.diag())

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.inv_diag.to(x.dtype) * x


@dataclasses.dataclass(frozen=True)
class BlockJacobi(Preconditioner):
    """Block-Jacobi with precomputed dense block inverses.

    inv_blocks: (nb, b, b) fp64, the inverse of each diagonal block of A.
    ``apply`` is the batched block product, a PyTorch product as in the
    JAX package, where it runs outside any Pallas kernel.
    """

    inv_blocks: torch.Tensor

    @staticmethod
    def from_operator(op: LinearOperator, block_size: int,
                      coupling_reach: int | None = None) -> "BlockJacobi":
        """Extract the diagonal blocks by probing A with COLORED
        block-local basis vectors, then invert them in fp64.

        Only every ``n_colors``-th block is active in a probe, so no
        coupling of an active block to another lands in the extracted
        blocks: ``n_colors = min(ceil(reach / b) + 2, nb)``.  Cost:
        ``n_colors * block_size`` applies of ``op`` as given (through its
        kernel for a ``use_kernel`` operator; each probed entry is one
        nonzero term, so exact either way).

        coupling_reach: max |i - j| with A[i, j] != 0.  Defaults to the
        measured bandwidth of a :class:`~repro_torch.linalg.sparse.
        SparseOp`, else ``block_size``, as in the JAX package.  For a
        grid-ordered stencil that default is right when a block spans at
        least one grid line and no coupling lies a multiple of
        ``n_colors`` blocks away: z-line blocks of a ``Stencil3D7`` with
        ``ny % 3 == 0`` alias its x couplings into the blocks (pass
        ``coupling_reach=ny * nz`` there).
        """
        n = op.n
        if block_size < 1 or n % block_size:
            raise ValueError(f"block_size {block_size} does not divide "
                             f"n = {n}")
        nb = n // block_size
        if coupling_reach is None:
            reach = bandwidth(op) if isinstance(op, SparseOp) \
                else block_size
        else:
            reach = coupling_reach
        n_colors = min((reach + block_size - 1) // block_size + 2, nb)
        f64 = dict(dtype=torch.float64, device=op.device)
        blocks = torch.zeros((nb, block_size, block_size), **f64)
        e = torch.zeros((nb, block_size), **f64)
        for j in range(block_size):
            for c in range(n_colors):
                e[c::n_colors, j] = 1.0
                ae = op.apply(e.reshape(-1)).reshape(nb, block_size)
                e[c::n_colors, j] = 0.0
                blocks[c::n_colors, :, j] = ae[c::n_colors]
        inv = torch.linalg.inv(blocks)
        return BlockJacobi(inv_blocks=inv)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """M^{-1} x for a vector or an (s, n) slab (one vector a row; the
        slab's block products may round differently from one vector's)."""
        nb, b, _ = self.inv_blocks.shape
        y = torch.einsum("nij,...nj->...ni", self.inv_blocks.to(x.dtype),
                         x.reshape(x.shape[:-1] + (nb, b)))
        return y.reshape(x.shape)


def spd_check_blockjacobi(op: LinearOperator, block_size: int) -> bool:
    """Sanity helper (tests): block-Jacobi of an SPD matrix is SPD."""
    bj = BlockJacobi.from_operator(op, block_size)
    w = np.linalg.eigvalsh(bj.inv_blocks.cpu().numpy())
    return bool((w > 0).all())
