"""Classic preconditioned Conjugate Gradients (Hestenes-Stiefel), the
paper's baseline, in PyTorch: the counterpart of
``repro/core/classic_cg.py``.

TWO blocking global reductions per iteration ((s, p) for alpha, then
(r, u) for beta and convergence), each started and waited at once through
the ``SolverOps`` handle pair: ``Time = 2 glred + 1 spmv`` (Table 1, row
'CG').  On one device both are stream-ordered; nothing waits on the host.

The iteration is the JAX package's ``build()`` program (init, body, cond,
finish; ``step = body``), with the same arithmetic in the same order.
``solve`` runs it in the solvers' host loop (``types.host_loop``): ``unroll``
iterations between host reads of ``cond``, the iterations of a window
run past a stop predicated on a device-side ``active`` flag.  They leave
``x``, ``it``, ``conv`` and ``hist`` as they were (``torch.where``: past
convergence alpha may be 0/0), so the result is bitwise the same for
every ``unroll``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.types import SolveResult, SolverOps, dot1, host_loop
from repro_torch.device import as_rhs, as_tensor


class CgState(NamedTuple):
    x: torch.Tensor
    r: torch.Tensor
    u: torch.Tensor
    p: torch.Tensor
    gamma: torch.Tensor
    it: torch.Tensor
    conv: torch.Tensor
    hist: torch.Tensor   # hist[0] is norm0 (the stopping reference)


class CgProgram(NamedTuple):
    init: Callable[[torch.Tensor], CgState]
    body: Callable[..., CgState]              # (st, active=None) -> st
    cond: Callable[[CgState], torch.Tensor]
    finish: Callable[..., SolveResult]
    # Uniform program surface with pcg/plcg: classic CG has no
    # restart/replacement interrupts, so step IS body.
    step: Callable[..., CgState] | None = None
    needs_interrupt: Callable[[CgState], torch.Tensor] | None = None
    interrupt: Callable[[CgState], CgState] | None = None


def build(ops: SolverOps, b: torch.Tensor, tol: float = 1e-6,
          maxit: int = 1000) -> CgProgram:
    dtype = b.dtype

    def init(x0: torch.Tensor) -> CgState:
        x = x0.to(dtype)
        r = b - ops.apply_a(x)
        u = ops.prec(r)
        gamma = dot1(ops, r, u)                   # reduction (init)
        norm0 = torch.sqrt(torch.abs(gamma))
        hist = torch.full((maxit + 2,), -1.0, dtype=dtype, device=b.device)
        hist[0] = norm0
        return CgState(x=x, r=r, u=u, p=u, gamma=gamma,
                       it=torch.zeros((), dtype=torch.int64, device=b.device),
                       conv=norm0 == 0.0, hist=hist)

    def cond(st: CgState) -> torch.Tensor:
        return (~st.conv) & (st.it < maxit)

    def body(st: CgState, active: torch.Tensor | None = None) -> CgState:
        """One iteration; ``active`` (a device bool) predicates ``x``,
        ``it``, ``conv`` and ``hist``; None means unconditionally
        active."""
        norm0 = st.hist[0]
        s = ops.apply_a(st.p)
        alpha = st.gamma / dot1(ops, s, st.p)     # reduction 1, a sync point
        x = st.x + alpha * st.p
        r = st.r - alpha * s
        u = ops.prec(r)
        gamma_new = dot1(ops, r, u)               # reduction 2, a sync point
        rnorm = torch.sqrt(torch.abs(gamma_new))
        conv = rnorm / norm0 < tol
        beta = gamma_new / st.gamma
        p = u + beta * st.p
        slot = (st.it + 1).clamp(max=maxit + 1).view(1)
        if active is None:
            it = st.it + 1
        else:
            x = torch.where(active, x, st.x)
            conv = torch.where(active, conv, st.conv)
            rnorm = torch.where(active, rnorm, st.hist.gather(0, slot)[0])
            it = st.it + active.to(st.it.dtype)
        st.hist.scatter_(0, slot, rnorm.view(1))
        return CgState(x=x, r=r, u=u, p=p, gamma=gamma_new, it=it,
                       conv=conv, hist=st.hist)

    def finish(st: CgState, host_syncs: int = 0) -> SolveResult:
        return SolveResult(
            x=st.x, iters=st.it, restarts=torch.zeros_like(st.it),
            converged=st.conv, res_history=st.hist, norm0=st.hist[0],
            host_syncs=host_syncs)

    return CgProgram(init=init, body=body, cond=cond, finish=finish,
                     step=body)


def solve(ops: SolverOps, b, x0=None, tol: float = 1e-6, maxit: int = 1000,
          unroll: int = 1, device=None) -> SolveResult:
    """Solve A x = b with classic CG.

    ``b`` is placed as ``pipelined_cg.solve`` places it (a tensor keeps
    its device, an array goes to ``device``, default ``cuda``).
    ``unroll`` iterations run between host checks of ``cond``; the result
    is bitwise the same for every ``unroll``."""
    b = as_rhs(b, device)
    prog = build(ops, b, tol=tol, maxit=maxit)
    st = prog.init(torch.zeros_like(b) if x0 is None
                   else as_tensor(x0, b.device, b.dtype))
    st, syncs = host_loop(st, prog.cond, prog.body, unroll)
    return prog.finish(st, syncs)
