"""Ghysels & Vanroose pipelined CG (p-CG) in PyTorch: the counterpart of
``repro/core/ghysels_pcg.py``.

ONE fused global reduction per iteration ({gamma = (r, u), delta =
(w, u)} in a single dot block), started through the ``SolverOps`` handle
and waited only after the iteration's own preconditioner and SPMV:
``Time = max(glred, spmv)`` (Table 1, row 'p-CG').

The vector state is the JAX package's (8, N) slab with its row order
(``X_ROW`` ... ``P_ROW``), updated row by row in place.  Residual
replacement (``replace_every > 0``, arXiv:1902.03100) swaps every
recurred vector for its true value every ``replace_every`` iterations;
here it is the host loop's ``needs_interrupt``/``interrupt`` pair, as in
``pipelined_cg``, where the JAX package runs it in a ``lax.cond`` inside
``body``: the same iterations, replaced at the same points.

``solve`` runs ``unroll`` iterations between host checks.  The
iterations of a window run past a stop or a due replacement are
predicated on a device-side ``active`` flag: they leave the rows and
scalars that ``finish`` and the replacement read (``x``, ``p``,
``gamma``, ``alpha``, ``it``, ``conv``, ``hist``, ``since_rr``) as they
were; the replacement rebuilds the other six rows from ``x`` and ``p``.
The result is bitwise the same for every ``unroll``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.types import SolveResult, SolverOps, dot1, host_loop
from repro_torch.device import as_rhs, as_tensor

# Rows of the (NV_PCG, N) vector slab, in the JAX package's order.
X_ROW, R_ROW, U_ROW, W_ROW, Z_ROW, Q_ROW, S_ROW, P_ROW = range(8)
NV_PCG = 8


class PcgState(NamedTuple):
    S: torch.Tensor          # (NV_PCG, N) slab: [x, r, u, w, z, q, s, p]
    gamma: torch.Tensor
    alpha: torch.Tensor
    it: torch.Tensor
    conv: torch.Tensor
    hist: torch.Tensor       # hist[0] is norm0 (the stopping reference)
    since_rr: torch.Tensor   # iterations since the last replacement
    k: int                   # iterations the host has run (predicated too)


class PcgProgram(NamedTuple):
    """p-CG pieces.  ``step`` is one iteration; ``needs_interrupt`` /
    ``interrupt`` the residual-replacement pair (None without
    replacement); ``body`` is ``step``, kept for the uniform program
    surface."""

    init: Callable[[torch.Tensor], PcgState]
    body: Callable[..., PcgState]
    cond: Callable[[PcgState], torch.Tensor]
    finish: Callable[..., SolveResult]
    step: Callable[..., PcgState]
    needs_interrupt: Callable[[PcgState], torch.Tensor] | None = None
    interrupt: Callable[[PcgState], PcgState] | None = None


def build(ops: SolverOps, b: torch.Tensor, tol: float = 1e-6,
          maxit: int = 1000, replace_every: int = 0) -> PcgProgram:
    dtype, dev = b.dtype, b.device

    def init(x0: torch.Tensor) -> PcgState:
        x = x0.to(dtype)
        r = b - ops.apply_a(x)
        u = ops.prec(r)
        w = ops.apply_a(u)
        norm0 = torch.sqrt(torch.abs(dot1(ops, r, u)))
        hist = torch.full((maxit + 2,), -1.0, dtype=dtype, device=dev)
        hist[0] = norm0
        S = torch.zeros((NV_PCG, b.shape[0]), dtype=dtype, device=dev)
        S[X_ROW], S[R_ROW], S[U_ROW], S[W_ROW] = x, r, u, w
        one = torch.ones((), dtype=dtype, device=dev)
        izero = torch.zeros((), dtype=torch.int64, device=dev)
        return PcgState(S=S, gamma=one, alpha=one.clone(), it=izero,
                        conv=norm0 == 0.0, hist=hist,
                        since_rr=izero.clone(), k=0)

    def cond(st: PcgState) -> torch.Tensor:
        return (~st.conv) & (st.it < maxit)

    def step(st: PcgState, active: torch.Tensor | None = None) -> PcgState:
        """One iteration; ``active`` (a device bool) predicates what the
        replacement and ``finish`` read; None means unconditionally
        active."""
        norm0 = st.hist[0]
        S = st.S
        # ONE fused reduction {(r, u), (w, u)}, started before and waited
        # after the iteration's own preconditioner and SPMV.
        pending = ops.start(S[R_ROW:W_ROW + 1:W_ROW - R_ROW],  # rows r, w
                           S[U_ROW])
        m = ops.prec(S[W_ROW])
        pending = ops.advance(pending, 0)
        nvec = ops.apply_a(m)
        gd = ops.wait(pending, advanced=1).to(dtype)
        gamma, delta = gd[0], gd[1]
        # The first iteration (it == 0) is known on the host: the host
        # checked cond before it, so it is always active.
        if st.k == 0:
            beta = torch.zeros_like(gamma)
            denom = delta
        else:
            beta = gamma / st.gamma
            denom = delta - beta * gamma / st.alpha
        alpha = gamma / denom
        # In place, in the order that reads each old row before it is
        # rewritten: z, q and s from the old rows, p and x as temporaries
        # (both predicated below), then r, u and w.
        torch.add(nvec, beta * S[Z_ROW], out=S[Z_ROW])
        torch.add(m, beta * S[Q_ROW], out=S[Q_ROW])
        torch.add(S[W_ROW], beta * S[S_ROW], out=S[S_ROW])
        p = S[U_ROW] + beta * S[P_ROW]
        x = S[X_ROW] + alpha * p
        torch.sub(S[R_ROW], alpha * S[S_ROW], out=S[R_ROW])
        torch.sub(S[U_ROW], alpha * S[Q_ROW], out=S[U_ROW])
        torch.sub(S[W_ROW], alpha * S[Z_ROW], out=S[W_ROW])
        rnorm = torch.sqrt(torch.abs(gamma))  # ||r||_M before the update
        conv = rnorm / norm0 < tol
        slot = (st.it + 1).clamp(max=maxit + 1).view(1)
        if active is None:
            S[X_ROW], S[P_ROW] = x, p
            it, since_rr = st.it + 1, st.since_rr + 1
        else:
            S[X_ROW] = torch.where(active, x, S[X_ROW])
            S[P_ROW] = torch.where(active, p, S[P_ROW])
            gamma = torch.where(active, gamma, st.gamma)
            alpha = torch.where(active, alpha, st.alpha)
            conv = torch.where(active, conv, st.conv)
            rnorm = torch.where(active, rnorm, st.hist.gather(0, slot)[0])
            inc = active.to(st.it.dtype)
            it, since_rr = st.it + inc, st.since_rr + inc
        st.hist.scatter_(0, slot, rnorm.view(1))
        return PcgState(S=S, gamma=gamma, alpha=alpha, it=it, conv=conv,
                        hist=st.hist, since_rr=since_rr, k=st.k + 1)

    def replace(st: PcgState) -> PcgState:
        """Residual replacement: every recurred vector for its true value.
        The scalars (gamma, alpha) are kept."""
        S = st.S
        r = b - ops.apply_a(S[X_ROW])
        u = ops.prec(r)
        w = ops.apply_a(u)
        s = ops.apply_a(S[P_ROW])
        q = ops.prec(s)
        z = ops.apply_a(q)
        S[R_ROW], S[U_ROW], S[W_ROW] = r, u, w
        S[S_ROW], S[Q_ROW], S[Z_ROW] = s, q, z
        return st._replace(S=S, since_rr=torch.zeros_like(st.since_rr))

    def needs_replace(st: PcgState) -> torch.Tensor:
        return st.since_rr >= replace_every

    def finish(st: PcgState, host_syncs: int = 0) -> SolveResult:
        return SolveResult(
            x=st.S[X_ROW].clone(), iters=st.it,
            restarts=torch.zeros_like(st.it), converged=st.conv,
            res_history=st.hist, norm0=st.hist[0], host_syncs=host_syncs)

    return PcgProgram(
        init=init, body=step, cond=cond, finish=finish, step=step,
        needs_interrupt=needs_replace if replace_every > 0 else None,
        interrupt=replace if replace_every > 0 else None)


def solve(ops: SolverOps, b, x0=None, tol: float = 1e-6, maxit: int = 1000,
          replace_every: int = 0, unroll: int = 1, checkpoint=None,
          device=None) -> SolveResult:
    """Solve A x = b with Ghysels p-CG.

    ``b`` is placed as ``pipelined_cg.solve`` places it.  ``unroll``
    iterations run between host checks of ``cond`` and of a due
    replacement; the result is bitwise the same for every ``unroll``."""
    if checkpoint is not None and getattr(checkpoint, "armed", True):
        raise NotImplementedError(
            "checkpointed solves are not ported yet (ROADMAP.md, queue 1 "
            "item 6)")
    b = as_rhs(b, device)
    prog = build(ops, b, tol=tol, maxit=maxit, replace_every=replace_every)
    st = prog.init(torch.zeros_like(b) if x0 is None
                   else as_tensor(x0, b.device, b.dtype))
    st, syncs = host_loop(st, prog.cond, prog.step, unroll,
                          prog.needs_interrupt, prog.interrupt)
    return prog.finish(st, syncs)
