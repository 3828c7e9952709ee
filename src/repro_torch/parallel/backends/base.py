"""Reduction-backend interface (counterpart of
``repro/parallel/backends/base.py``): the substrate behind ``SolverOps``,
implemented by the single-device ``local`` backend and the
torch.distributed ``multiprocess`` backend."""

from __future__ import annotations

import abc
from typing import ClassVar

from repro_torch.core import METHODS
from repro_torch.core.types import SolveResult

__all__ = ["METHODS", "ReductionBackend", "BATCHED_OVER_RANKS"]

# Where the batched solves and the serve layer over ranks stand in the
# roadmap (every refusal of them names it).
BATCHED_OVER_RANKS = ("batched solves and serving over ranks are not "
                      "ported yet (ROADMAP.md, queue 1 item 5b)")


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

    def make_solver(self, op, method: str = "plcg", prec=None,
                    **solver_kwargs):
        """A reusable solver ``b -> SolveResult`` with ``method``, ``prec``
        and ``solver_kwargs`` bound: what the autotuner times
        (``repro_torch.launch.autotune.measured_runner``).  PyTorch has no
        jit cache to keep, so this default is ``solve`` with its arguments
        bound; a backend whose per-solve set-up can be shared overrides
        it."""
        return lambda b: self.solve(op, b, method, prec, **solver_kwargs)

    def solve_batched(self, op, B, method: str = "plcg", prec=None,
                      **solver_kwargs) -> SolveResult:
        """Solve A X = B for every row of B (s, n) in lock step: one
        (s, K) dot-block start an iteration whatever s is; the result's
        tensors carry a leading s axis, and row j matches
        ``solve(op, B[j], ...)`` (tests/test_torch_batched.py)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support solve_batched")

    def make_batched_solver(self, op, method: str = "plcg", prec=None,
                            **solver_kwargs):
        """A reusable batched solver ``B (s, n) -> SolveResult``."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support make_batched_solver")

    def make_slab_program(self, op, s: int, method: str = "plcg", prec=None,
                          chunk_iters: int = 16, dtype=None,
                          **solver_kwargs):
        """The chunked slab life cycle for the serving layer
        (``repro_torch.serve``): init / chunk / inject / status / extract
        over a fixed (s, n) slab (``repro_torch.core.batched``)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support make_slab_program")

    def describe(self) -> str:
        return f"{self.name} reduction backend"

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<{type(self).__name__} {self.describe()}>"
