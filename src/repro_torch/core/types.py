"""Common solver interfaces (counterpart of ``repro/core/types.py``).

``SolverOps`` is what a Krylov solver needs from its substrate: the SPMV
``apply_a``, the preconditioner ``prec`` and the fused dot block
``dot_block`` (K, N) x (N,) -> (K,), all inner products of one iteration
in ONE reduction.  On top of it the reduction is a handle pair, the
paper's MPI_Iallreduce / MPI_Wait split: ``start`` issues the block and
``wait`` marks where it is consumed.  On the single-device substrate the
block is complete at issue, so ``wait`` and ``advance`` are the identity;
the handle pair keeps the solver's structure the same for the
multi-rank substrates still to be ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch


def dot_block_rows(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """The fused dot block (K, N) x (N,) -> (K,) as an elementwise product
    and a trailing-axis sum, the expression the JAX package pins.

    The port uses ``torch.sum``'s order, which is fixed for a given device
    and shape but differs from XLA's; port-versus-JAX comparisons of dots
    therefore hold to a stated tolerance, not bitwise."""
    return (mat * vec[None, :]).sum(dim=1)


class SolveResult(NamedTuple):
    x: torch.Tensor            # approximate solution
    iters: torch.Tensor        # number of solution updates
    restarts: torch.Tensor     # breakdown / replacement restarts
    converged: torch.Tensor    # bool
    res_history: torch.Tensor  # recursive residual M-norms, -1 padded
    norm0: torch.Tensor        # initial residual M-norm
    telemetry: torch.Tensor | None = None
    governor: torch.Tensor | None = None
    # Port only: how many times the host loop read device state to decide
    # whether to go on (the solve's host synchronisations).
    host_syncs: int = 0


@dataclasses.dataclass(frozen=True)
class SolverOps:
    apply_a: Callable[[torch.Tensor], torch.Tensor]
    prec: Callable[[torch.Tensor], torch.Tensor]
    dot_block: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    dot_block_start: Callable | None = None
    dot_block_wait: Callable | None = None
    dot_block_advance: Callable | None = None
    dot_block_handle_zeros: Callable | None = None
    # Global combine of locally accumulated dot-block partials (the
    # reduction half of the fused-iteration path); None on one device.
    combine_partials: Callable[[torch.Tensor], torch.Tensor] | None = None
    # ``factory(layout) -> fiter`` for the superkernel, or None when the
    # operator/preconditioner pair has no fused path.
    fused_iter_factory: Callable[..., Callable] | None = None

    def start(self, mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
        """Initiate the fused dot block (the MPI_Iallreduce)."""
        if self.dot_block_start is None:
            return self.dot_block(mat, vec)
        return self.dot_block_start(mat, vec)

    def advance(self, handle: torch.Tensor, step: int) -> torch.Tensor:
        """One ladder step of an in-flight handle; identity here."""
        if self.dot_block_advance is None:
            return handle
        return self.dot_block_advance(handle, step)

    def handle_zeros(self, shape: tuple, dtype,
                     device=None) -> torch.Tensor:
        """Zero in-flight handle for a dot block with payload ``shape``."""
        if self.dot_block_handle_zeros is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        return self.dot_block_handle_zeros(shape, dtype, device)

    def start_partials(self, partials: torch.Tensor) -> torch.Tensor:
        """Initiate the global combine of locally accumulated partials:
        one reduction with the same 2l+1-entry payload as ``start``."""
        if self.combine_partials is None:
            return partials
        return self.combine_partials(partials)

    def wait(self, dots: torch.Tensor, advanced: int = 0) -> torch.Tensor:
        """Consumption point of a previously started block (MPI_Wait)."""
        if self.dot_block_wait is None:
            return dots
        return self.dot_block_wait(dots, advanced=advanced)

    @staticmethod
    def create(apply_a, prec, dot_block, combine_partials=None,
               fused_iter_factory=None, dot_block_start=None,
               dot_block_wait=None, dot_block_advance=None,
               handle_zeros=None) -> "SolverOps":
        """Build SolverOps; the start/wait pair defaults to a plain
        ``dot_block`` issued at start and consumed unchanged."""
        return SolverOps(
            apply_a=apply_a, prec=prec, dot_block=dot_block,
            dot_block_start=dot_block_start, dot_block_wait=dot_block_wait,
            dot_block_advance=dot_block_advance,
            dot_block_handle_zeros=handle_zeros,
            combine_partials=combine_partials,
            fused_iter_factory=fused_iter_factory,
        )

    @staticmethod
    def local(op, prec=None) -> "SolverOps":
        """Single-device ops."""
        from repro_torch.kernels.ops import fused_iteration_factory

        pfun = (lambda v: v) if prec is None else (lambda v: prec.apply(v))
        return SolverOps.create(
            apply_a=lambda v: op.apply(v),
            prec=pfun,
            dot_block=dot_block_rows,
            fused_iter_factory=fused_iteration_factory(op, prec),
        )


def dot1(ops: SolverOps, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Single global dot through the fused-block path, started and
    immediately waited (a blocking reduction)."""
    return ops.wait(ops.start(a[None, :], b))[0].to(a.dtype)


def host_loop(st, cond, step, unroll: int, needs_interrupt=None,
              interrupt=None):
    """The solvers' host loop: ``unroll`` calls of ``step(st, active)``
    between host reads of ``cond`` (and of ``needs_interrupt``, whose
    ``interrupt`` runs when due), ``active`` being ``cond`` and not a due
    interrupt, evaluated on the device before each step.  Returns the
    final state and the number of host reads (synchronisations)."""
    if unroll < 1:
        raise ValueError("unroll must be >= 1")
    syncs = 0
    while True:
        syncs += 1
        if needs_interrupt is None:
            keep, due = bool(cond(st)), False
        else:
            keep, due = torch.stack([cond(st), needs_interrupt(st)]).tolist()
        if not keep:
            return st, syncs
        if due:
            st = interrupt(st)
            continue
        for _ in range(unroll):
            active = cond(st)
            if needs_interrupt is not None:
                active = active & ~needs_interrupt(st)
            st = step(st, active)
