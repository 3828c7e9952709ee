"""Single-device reduction backend (counterpart of
``repro/parallel/backends/local.py``): the fused dot block is a plain
in-process row reduction (``types.dot_block_rows``), or, on the fused
path, the superkernel's partials.  ``reduction="staged"`` runs the ladder
oracle over ``virtual_shards`` contiguous slices
(``repro_torch.parallel.reduction``), bitwise equal to the staged unfused
``multiprocess`` backend over that many ranks; its fused path files the
whole-vector superkernel's partial in slot 0, as the JAX package's does."""

from __future__ import annotations

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

    def describe(self) -> str:
        if self.reduction_cfg is not None:
            return (f"local (single device, ladder oracle over "
                    f"{self.reduction_cfg.n_shards} virtual shards)")
        return "local (single device, in-process dot block)"
