"""Reduction-backend interface (counterpart of
``repro/parallel/backends/base.py``): the substrate behind ``SolverOps``,
implemented by the single-device ``local`` backend and the
torch.distributed ``multiprocess`` backend."""

from __future__ import annotations

import abc
from typing import ClassVar

from repro_torch.core import METHODS
from repro_torch.core.types import SolveResult

__all__ = ["METHODS", "ReductionBackend"]


class ReductionBackend(abc.ABC):
    """Pluggable substrate for the CG solver family."""

    name: ClassVar[str]

    # Set by constructors: the reduction mode that runs ("monolithic" or
    # "staged", ``repro_torch.parallel.reduction``).
    reduction_mode: str = "monolithic"

    @abc.abstractmethod
    def solve(self, op, b, method: str = "plcg", prec=None,
              **solver_kwargs) -> SolveResult:
        """Solve A x = b with the chosen CG variant on this substrate;
        ``solver_kwargs`` go to the solver (l, tol, maxit, sigmas, ...)."""

    def describe(self) -> str:
        return f"{self.name} reduction backend"

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<{type(self).__name__} {self.describe()}>"
