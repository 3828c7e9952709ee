from repro_torch.core import pipelined_cg
from repro_torch.core.chebyshev import (chebyshev_shifts, power_method,
                                        shifts_for_operator)
from repro_torch.core.types import SolveResult, SolverOps


def _not_ported(name: str):
    def solve(ops, b, kw):
        raise NotImplementedError(
            f"method {name!r} is not ported yet (ROADMAP.md, queue 1 "
            "item 2: classic CG and Ghysels p-CG)")
    return solve


# kwargs-dict dispatch shared by the backends, as repro.core.METHODS.
METHODS = {
    "cg": _not_ported("cg"),
    "pcg": _not_ported("pcg"),
    "plcg": lambda ops, b, kw: pipelined_cg.solve(ops, b, **kw),
}

__all__ = ["SolveResult", "SolverOps", "pipelined_cg", "chebyshev_shifts",
           "power_method", "shifts_for_operator", "METHODS"]
