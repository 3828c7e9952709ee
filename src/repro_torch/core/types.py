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
    and a trailing-axis sum, the expression the JAX package pins.  With a
    leading slab axis, (s, K, N) x (s, N) -> (s, K): the s columns' blocks
    in ONE reduction, one row a column (the JAX package's vmapped payload
    is (K, s), the same numbers transposed).

    The port uses ``torch.sum``'s order, which is fixed for a given device
    and shape but differs from XLA's; port-versus-JAX comparisons of dots
    therefore hold to a stated tolerance, not bitwise.  On the CPU the
    slab form sums each column's rows in the single-column order
    (tests/test_torch_batched.py holds them bitwise)."""
    return (mat * vec[..., None, :]).sum(dim=-1)


class SolveResult(NamedTuple):
    x: torch.Tensor            # approximate solution
    iters: torch.Tensor        # number of solution updates
    restarts: torch.Tensor     # breakdown / replacement restarts
    converged: torch.Tensor    # bool
    res_history: torch.Tensor  # recursive residual M-norms, -1 padded
    norm0: torch.Tensor        # initial residual M-norm
    # The (cap, K) telemetry ring (``TelemetrySlab`` decodes it), or None
    # when the solve was not instrumented (telemetry_cap=0).
    telemetry: torch.Tensor | None = None
    # The final (N_SLOTS,) stability-governor vector
    # (``repro_torch.stability.model``), or None when ungoverned.
    governor: torch.Tensor | None = None
    # Port only: how many times the host loop read device state to decide
    # whether to go on (the solve's host synchronisations).
    host_syncs: int = 0


@dataclasses.dataclass(frozen=True)
class TelemetrySlab:
    """Descriptor of the per-iteration telemetry ring.

    An instrumented p(l)-CG solve carries a ``(cap, K)`` ring on the
    device: one row an iteration of scalars the iteration already computed
    (residual norm, the arrived 2l+1-entry dot block, restart and
    replacement flags, handle age, the governor's gap and action), in the
    layout of ``kernels.fused_iter.tel_layout``.  Writing it adds no
    reduction and no host synchronisation; it is read only with the
    result.  Rows wrap: row ``tot % cap`` belongs to global iteration
    ``tot`` (the "iter" column tells which after a wrap)."""

    cap: int
    l: int

    @property
    def k(self) -> int:
        from repro_torch.kernels.fused_iter import tel_layout

        return tel_layout(self.l)["size"]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.cap, self.k)

    def bytes_per_iter(self, dtype=torch.float64) -> int:
        """Device bytes the ring write adds an iteration: one K-row."""
        return self.k * torch.empty((), dtype=dtype).element_size()

    def unpack(self, tel) -> dict:
        """Decode a ring (..., cap, K), a tensor or an array, into named
        columns: (..., cap) for the scalar columns and ``dots``
        (..., cap, 2l+1).  Rows never written hold -1 in every column."""
        from repro_torch.kernels.fused_iter import tel_layout

        tl = tel_layout(self.l)
        out = {name: tel[..., :, tl[name]]
               for name in ("iter", "upd", "rnorm", "age", "breakdown",
                            "restart", "replacement", "gap", "action")}
        out["dots"] = tel[..., :, tl["dots"]:tl["size"]]
        return out


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
    immediately waited (a blocking reduction).  For (s, N) slabs ``a`` and
    ``b`` it is the s columns' dots, (s,), in one start."""
    return ops.wait(ops.start(a[..., None, :], b))[..., 0].to(a.dtype)


def host_tensor(values, dtype, device) -> torch.Tensor:
    """A small host list as a tensor on ``device``.  On a card the copy
    goes from pinned memory without waiting for the stream (a plain
    ``torch.tensor(..., device="cuda")`` would synchronise the host)."""
    t = torch.tensor(values, dtype=dtype)
    dev = torch.device(device)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


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
