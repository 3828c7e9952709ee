"""Reduction-backend interface (counterpart of
``repro/parallel/backends/base.py``): the substrate behind ``SolverOps``.
Only the single-device ``local`` backend is ported so far; the
torch.distributed backend follows (ROADMAP.md, queue 1 item 2)."""

from __future__ import annotations

import abc
from typing import ClassVar

from repro_torch.core import METHODS
from repro_torch.core.types import SolveResult

__all__ = ["METHODS", "ReductionBackend"]


class ReductionBackend(abc.ABC):
    """Pluggable substrate for the CG solver family."""

    name: ClassVar[str]

    # Capability flag: whether this substrate can run the dot block as the
    # staged ring-reduction ladder (``repro_torch.parallel.reduction``).  A
    # backend that cannot sets it False and ``resolve_backend_reduction``
    # downgrades a staged request to monolithic, recording why in
    # ``reduction_fallback``.
    supports_staged_reduction: ClassVar[bool] = True
    # Set by constructors: the reduction mode that runs, and why it differs
    # from the request (or None).
    reduction_mode: str = "monolithic"
    reduction_fallback: str | None = None

    @abc.abstractmethod
    def solve(self, op, b, method: str = "plcg", prec=None,
              **solver_kwargs) -> SolveResult:
        """Solve A x = b with the chosen CG variant on this substrate;
        ``solver_kwargs`` go to the solver (l, tol, maxit, sigmas, ...)."""

    def describe(self) -> str:
        return f"{self.name} reduction backend"

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<{type(self).__name__} {self.describe()}>"
