"""Single-device reduction backend (counterpart of
``repro/parallel/backends/local.py``): the fused dot block is a plain
in-process row reduction (``types.dot_block_rows``), or, on the fused
path, the superkernel's partials.  ``reduction="staged"`` runs the ladder
oracle over ``virtual_shards`` contiguous slices
(``repro_torch.parallel.reduction``), bitwise equal to the staged unfused
``multiprocess`` backend over that many ranks; its fused path files the
whole-vector superkernel's partial in slot 0, as the JAX package's does.

Batched multi-RHS solves (``solve_batched``, ``make_batched_solver``) and
the serving layer's slab programs (``make_slab_program``) run on either
dot block: the (s, K) block of a slab is one in-process reduction
(``types.dot_block_rows``) or the slab superkernel's partials, and with
``reduction="staged"`` the ladder oracle's (s, P, K) gather buffer, the
one-process reference of a batched staged run over P ranks (column j
bitwise the one-column oracle solve of B[j]).  A slab takes its
right-hand sides as (s, n), one a row: the transpose of the JAX package's
(n, s) ``B``."""

from __future__ import annotations

from repro_torch.core import batched as batched_mod
from repro_torch.core.types import SolverOps
from repro_torch.device import as_rhs, resolve_device
from repro_torch.parallel.backends.base import METHODS, ReductionBackend


class LocalBackend(ReductionBackend):
    name = "local"

    def __init__(self, reduction: str = "monolithic",
                 reduction_stages: int = 2, reduction_dtype=None,
                 virtual_shards: int = 1, device=None):
        """``device`` (default ``cuda``) is where a right-hand side given
        as an array is placed.  ``reduction="staged"`` runs the LADDER
        ORACLE: the dot block splits into ``virtual_shards`` contiguous
        slices whose partials fill the gather buffer directly (on the fused
        path, the superkernel's one partial fills slot 0), then the
        rank-ordered (for ``reduction_dtype=torch.float32``,
        fp64-compensated) combine of a staged run over that many ranks,
        with no wire."""
        from repro_torch.parallel.reduction import resolve_backend_reduction

        self.device = resolve_device(device)
        self.reduction_cfg = resolve_backend_reduction(
            self, reduction, reduction_stages, reduction_dtype,
            virtual_shards)

    def make_ops(self, op, prec=None) -> SolverOps:
        if self.reduction_cfg is not None:
            from repro_torch.parallel.reduction import oracle_solver_ops
            return oracle_solver_ops(op, prec, self.reduction_cfg)
        return SolverOps.local(op, prec)

    def solve(self, op, b, method: str = "plcg", prec=None,
              **solver_kwargs):
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; "
                             f"available: {', '.join(METHODS)}")
        b = as_rhs(b, self.device)
        return METHODS[method](self.make_ops(op, prec), b, solver_kwargs)

    def make_solver(self, op, method: str = "plcg", prec=None,
                    **solver_kwargs):
        """``b -> SolveResult`` on ``SolverOps`` built once (the counterpart
        of the JAX backend's jitted solver, with no jit cache to hold: each
        call runs the host loop afresh, bitwise ``solve``)."""
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; "
                             f"available: {', '.join(METHODS)}")
        ops = self.make_ops(op, prec)
        return lambda b: METHODS[method](ops, as_rhs(b, self.device),
                                         dict(solver_kwargs))

    # -------------------------------------------------- batched multi-RHS --
    def solve_batched(self, op, B, method: str = "plcg", prec=None,
                      **solver_kwargs):
        return self.make_batched_solver(op, method, prec,
                                        **solver_kwargs)(B)

    def make_batched_solver(self, op, method: str = "plcg", prec=None,
                            **solver_kwargs):
        """``B -> SolveResult`` for (s, n) right-hand sides (an array goes
        to this backend's device)."""
        ops = self.make_ops(op, prec)
        return lambda B: batched_mod.solve_batched(
            ops, as_rhs(B, self.device), method, **solver_kwargs)

    def make_slab_program(self, op, s: int, method: str = "plcg", prec=None,
                          chunk_iters: int = 16, dtype=None,
                          **solver_kwargs):
        ops = self.make_ops(op, prec)
        return batched_mod.slab_program(ops, s, op.n, method,
                                        dict(solver_kwargs), chunk_iters)

    def run(self, fn, op, b, prec=None, x0=None):
        """``fn(ops, b)`` on this backend's ``SolverOps`` (b to its
        device), or ``fn(ops, b, x0=x0)`` with a warm start: the hook that
        lets a caller rewrite the ops before a solve, as
        ``stability.governed_solve``'s ``ops_transform`` does."""
        kw = {} if x0 is None else {"x0": x0}
        return fn(self.make_ops(op, prec), as_rhs(b, self.device), **kw)

    def describe(self) -> str:
        if self.reduction_cfg is not None:
            return (f"local (single device, ladder oracle over "
                    f"{self.reduction_cfg.n_shards} virtual shards)")
        return "local (single device, in-process dot block)"
