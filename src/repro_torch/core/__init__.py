from repro_torch.core import classic_cg, ghysels_pcg, pipelined_cg
from repro_torch.core.chebyshev import (chebyshev_shifts, power_method,
                                        shifts_for_operator)
from repro_torch.core.types import SolveResult, SolverOps

SOLVERS = {
    "cg": classic_cg.solve,
    "pcg": ghysels_pcg.solve,          # Ghysels p-CG (~p(1)-CG)
    "pipelcg": pipelined_cg.solve,     # deep pipelined p(l)-CG (Alg. 1)
}

# kwargs-dict dispatch shared by the backends, as repro.core.METHODS.
METHODS = {
    "cg": lambda ops, b, kw: classic_cg.solve(ops, b, **kw),
    "pcg": lambda ops, b, kw: ghysels_pcg.solve(ops, b, **kw),
    "plcg": lambda ops, b, kw: pipelined_cg.solve(ops, b, **kw),
}

__all__ = ["SolveResult", "SolverOps", "classic_cg", "ghysels_pcg",
           "pipelined_cg", "chebyshev_shifts", "power_method",
           "shifts_for_operator", "SOLVERS", "METHODS"]
