"""The governed solve on the host: the pipeline-depth demotion ladder
(counterpart of ``repro/stability/governor.py``).

The in-solver governor (``core.pipelined_cg`` with a
:class:`~repro_torch.stability.model.GovernorConfig`) repairs accuracy
loss within one solve: residual replacements through the interrupt
machinery, the terminal STAGNATED flag when replacements stop helping.
Changing the pipeline depth is done here:

    result, attempts = governed_solve(backend, op, b, l=16, ...)

Each attempt the governor could not certify halves ``l`` (never below
``min_l``) and warm-restarts from the returned iterate: shallower
pipelines round less (arXiv:1804.02962).  When even ``l = min_l`` fails,
a typed :class:`StagnationError` carries the per-depth diagnosis.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.stability import model as M
from repro_torch.stability.model import GovernorConfig


class StagnationError(RuntimeError):
    """The governed solve stagnated at every pipeline depth down to
    ``min_l``.  ``diagnosis["attempts"]`` holds the per-depth governor
    summaries (depth, replacements, best relative residual)."""

    def __init__(self, message: str, diagnosis: dict | None = None):
        super().__init__(message)
        self.diagnosis = diagnosis or {}


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def diagnose(result) -> dict:
    """Summarize a governed ``SolveResult``'s final governor vector."""
    if result.governor is None:
        raise ValueError("result carries no governor state "
                         "(solve ran with governor=None)")
    g = _host(result.governor)
    return {
        "gap": float(g[M.GAP]),
        "best_rel": float(g[M.BEST]),
        "replacements": int(g[M.REPL]),
        "fruitless": int(g[M.FRUITLESS]),
        "stagnated": bool(g[M.STAGNATED] > 0),
        "last_replacement_rel": float(g[M.LAST_REL]),
        "converged": bool(_host(result.converged)),
        "iters": int(_host(result.iters)),
    }


def governed_solve(backend, op, b, *, l: int, prec=None,
                   governor: GovernorConfig | None = None,
                   recurrence: str = "stable", min_l: int = 1,
                   ops_transform=None, **solver_kwargs):
    """Solve with the governor armed, demoting the depth on stagnation.

    Returns ``(result, attempts)``, ``attempts`` the per-depth
    :func:`diagnose` dicts, each tagged with its ``l``.  Any outcome the
    governor could not certify against the true residual (STAGNATED, or
    the restart or iteration budget spent) halves ``l`` (floor ``min_l``)
    and restarts from the returned iterate; a failed attempt at ``min_l``
    raises :class:`StagnationError`.

    ``ops_transform`` rewrites the backend's ``SolverOps`` before the
    solve (``repro_torch.chaos.chaos_ops`` injects reduction-payload
    faults there); the solve then runs through ``backend.run``.  Over
    ranks (a ``MultiprocessBackend``) every rank calls it alike: each
    attempt re-enters the solve at its depth over the same wire, and the
    warm start goes to each rank as its rows of the returned iterate."""
    if min_l < 1:
        raise ValueError("min_l must be >= 1")
    cfg = governor if governor is not None else GovernorConfig()
    x0 = solver_kwargs.pop("x0", None)
    attempts: list[dict] = []
    cur_l = int(l)

    def run(cur_l, x0):
        kw = dict(solver_kwargs, l=cur_l, recurrence=recurrence,
                  governor=cfg)
        if ops_transform is None:
            return backend.solve(op, b, method="plcg", prec=prec, x0=x0,
                                 **kw)
        from repro_torch.core import pipelined_cg
        return backend.run(
            lambda ops, bb, **x: pipelined_cg.solve(ops_transform(ops), bb,
                                                    **kw, **x),
            op, b, prec=prec, x0=x0)

    while True:
        res = run(cur_l, x0)
        d = diagnose(res)
        d["l"] = cur_l
        attempts.append(d)
        if d["converged"]:
            return res, attempts
        if cur_l <= min_l:
            why = "stagnated" if d["stagnated"] else "exhausted its budget"
            raise StagnationError(
                f"governed p(l)-CG {why} at every depth down to l={min_l}: "
                f"best relative residual {d['best_rel']:.3e} after "
                f"{d['replacements']} governed replacement(s) at l={cur_l} "
                f"({len(attempts)} depth(s) tried)",
                diagnosis={"attempts": attempts})
        # Warm restart shallower from the iterate (every replacement
        # re-derived it from b - A x).
        x0 = res.x
        cur_l = max(min_l, cur_l // 2)
