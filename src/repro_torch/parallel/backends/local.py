"""Single-device reduction backend (counterpart of
``repro/parallel/backends/local.py``): the fused dot block is a plain
in-process row reduction (``types.dot_block_rows``), or, on the fused
path, the superkernel's partials."""

from __future__ import annotations

from repro_torch.core.types import SolverOps
from repro_torch.device import as_tensor, resolve_device
from repro_torch.parallel.backends.base import METHODS, ReductionBackend


class LocalBackend(ReductionBackend):
    name = "local"

    def __init__(self, reduction: str = "monolithic",
                 virtual_shards: int = 1, device=None):
        """``device`` (default ``cuda``) is where a right-hand side given
        as an array is placed.  The staged-reduction ladder oracle
        (``reduction="staged"``, ``virtual_shards > 1``) is not ported
        yet and raises."""
        if reduction != "monolithic" or virtual_shards != 1:
            raise NotImplementedError(
                "staged reduction and virtual shards are not ported yet "
                "(ROADMAP.md, queue 1 item 5)")
        self.device = resolve_device(device)

    def make_ops(self, op, prec=None) -> SolverOps:
        return SolverOps.local(op, prec)

    def solve(self, op, b, method: str = "plcg", prec=None,
              **solver_kwargs):
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; "
                             f"available: {', '.join(METHODS)}")
        b = as_tensor(b, self.device)
        return METHODS[method](self.make_ops(op, prec), b, solver_kwargs)

    def describe(self) -> str:
        return "local (single device, in-process dot block)"
