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

from repro_torch.core.types import (SolveResult, SolverOps, dot1, host_loop,
                                    host_tensor)
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
    k: int | tuple           # iterations the host has run (predicated
                             # too); a slab holds one per column


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


def _rows(S, *rows):
    """Views of rows of an (NV_PCG, N) slab, or of every column's rows of
    an (s, NV_PCG, N) one."""
    return [S[..., r, :] for r in rows]


def build(ops: SolverOps, b: torch.Tensor, tol: float = 1e-6,
          maxit: int = 1000, replace_every: int = 0) -> PcgProgram:
    """The p-CG program for ``b`` (N,), or for a slab (s, N) of
    right-hand sides, one a row: a (s, NV_PCG, N) slab, each scalar an (s,)
    tensor and the dot block one (s, 2) start, with every column's
    arithmetic that of its own sequential program."""
    dtype, dev = b.dtype, b.device

    def init(x0: torch.Tensor, b_=None) -> PcgState:
        """The state at x0; ``b_`` (default ``b``) is the right-hand side
        of x0's columns."""
        x = x0.to(dtype)
        r = (b if b_ is None else b_) - ops.apply_a(x)
        u = ops.prec(r)
        w = ops.apply_a(u)
        norm0 = torch.sqrt(torch.abs(dot1(ops, r, u)))
        batch = norm0.shape
        hist = torch.full(batch + (maxit + 2,), -1.0, dtype=dtype,
                          device=dev)
        hist[..., 0] = norm0
        S = torch.zeros(batch + (NV_PCG, b.shape[-1]), dtype=dtype,
                        device=dev)
        for row, v in ((X_ROW, x), (R_ROW, r), (U_ROW, u), (W_ROW, w)):
            S[..., row, :] = v
        one = torch.ones(batch, dtype=dtype, device=dev)
        izero = torch.zeros(batch, dtype=torch.int64, device=dev)
        return PcgState(S=S, gamma=one, alpha=one.clone(), it=izero,
                        conv=norm0 == 0.0, hist=hist,
                        since_rr=izero.clone(),
                        k=(0,) * batch[0] if batch else 0)

    def cond(st: PcgState) -> torch.Tensor:
        return (~st.conv) & (st.it < maxit)

    def step(st: PcgState, active: torch.Tensor | None = None) -> PcgState:
        """One iteration; ``active`` (a device bool) predicates what the
        replacement and ``finish`` read; None means unconditionally
        active."""
        norm0 = st.hist[..., 0]
        S = st.S
        xr, rr, ur, wr, zr, qr, sr, pr = _rows(S, X_ROW, R_ROW, U_ROW, W_ROW,
                                               Z_ROW, Q_ROW, S_ROW, P_ROW)
        # ONE fused reduction {(r, u), (w, u)}, started before and waited
        # after the iteration's own preconditioner and SPMV.
        pending = ops.start(S[..., R_ROW:W_ROW + 1:W_ROW - R_ROW, :],
                            ur)                          # rows r, w
        m = ops.prec(wr)
        pending = ops.advance(pending, 0)
        nvec = ops.apply_a(m)
        gd = ops.wait(pending, advanced=1).to(dtype)
        gamma, delta = gd[..., 0], gd[..., 1]
        # The first iteration (it == 0) is known on the host: the host
        # checked cond before it, so it is always active.  A slab's
        # columns start at different times: a mask where they differ.
        ks = st.k if isinstance(st.k, tuple) else (st.k,)
        if all(k == 0 for k in ks):
            beta = torch.zeros_like(gamma)
            denom = delta
        elif all(k > 0 for k in ks):
            beta = gamma / st.gamma
            denom = delta - beta * gamma / st.alpha
        else:
            first = host_tensor([k == 0 for k in ks], torch.bool, dev)
            beta = torch.where(first, torch.zeros_like(gamma),
                               gamma / st.gamma)
            denom = torch.where(first, delta,
                                delta - beta * gamma / st.alpha)
        alpha = gamma / denom
        bv, av = beta[..., None], alpha[..., None]
        # In place, in the order that reads each old row before it is
        # rewritten: z, q and s from the old rows, p and x as temporaries
        # (both predicated below), then r, u and w.
        torch.add(nvec, bv * zr, out=zr)
        torch.add(m, bv * qr, out=qr)
        torch.add(wr, bv * sr, out=sr)
        p = ur + bv * pr
        x = xr + av * p
        torch.sub(rr, av * sr, out=rr)
        torch.sub(ur, av * qr, out=ur)
        torch.sub(wr, av * zr, out=wr)
        rnorm = torch.sqrt(torch.abs(gamma))  # ||r||_M before the update
        conv = rnorm / norm0 < tol
        slot = (st.it + 1).clamp(max=maxit + 1).unsqueeze(-1)
        if active is None:
            S[..., X_ROW, :], S[..., P_ROW, :] = x, p
            it, since_rr = st.it + 1, st.since_rr + 1
        else:
            S[..., X_ROW, :] = torch.where(active[..., None], x, xr)
            S[..., P_ROW, :] = torch.where(active[..., None], p, pr)
            gamma = torch.where(active, gamma, st.gamma)
            alpha = torch.where(active, alpha, st.alpha)
            conv = torch.where(active, conv, st.conv)
            rnorm = torch.where(active, rnorm,
                                st.hist.gather(-1, slot)[..., 0])
            inc = active.to(st.it.dtype)
            it, since_rr = st.it + inc, st.since_rr + inc
        st.hist.scatter_(-1, slot, rnorm.unsqueeze(-1))
        k = tuple(k + 1 for k in st.k) if isinstance(st.k, tuple) \
            else st.k + 1
        return PcgState(S=S, gamma=gamma, alpha=alpha, it=it, conv=conv,
                        hist=st.hist, since_rr=since_rr, k=k)

    def replace(st: PcgState, b_=None) -> PcgState:
        """Residual replacement: every recurred vector for its true value.
        The scalars (gamma, alpha) are kept.  ``b_`` (default ``b``) is the
        right-hand side of these columns."""
        S = st.S
        r = (b if b_ is None else b_) - ops.apply_a(S[..., X_ROW, :])
        u = ops.prec(r)
        w = ops.apply_a(u)
        s = ops.apply_a(S[..., P_ROW, :])
        q = ops.prec(s)
        z = ops.apply_a(q)
        for row, v in ((R_ROW, r), (U_ROW, u), (W_ROW, w), (S_ROW, s),
                       (Q_ROW, q), (Z_ROW, z)):
            S[..., row, :] = v
        return st._replace(S=S, since_rr=torch.zeros_like(st.since_rr))

    def needs_replace(st: PcgState) -> torch.Tensor:
        return st.since_rr >= replace_every

    def finish(st: PcgState, host_syncs: int = 0) -> SolveResult:
        return SolveResult(
            x=st.S[..., X_ROW, :].clone(), iters=st.it,
            restarts=torch.zeros_like(st.it), converged=st.conv,
            res_history=st.hist, norm0=st.hist[..., 0],
            host_syncs=host_syncs)

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
    replacement; the result is bitwise the same for every ``unroll``.
    ``checkpoint`` (``every > 0``) snapshots at replacement boundaries
    (``repro_torch.checkpoint``); ``every=0`` or None leaves this path
    untouched."""
    b = as_rhs(b, device)
    if checkpoint is not None and checkpoint.armed:
        from repro_torch.checkpoint import checkpointed_solve

        return checkpointed_solve(
            ops, b, "pcg", x0, checkpoint,
            dict(tol=tol, maxit=maxit, replace_every=replace_every,
                 unroll=unroll))
    prog = build(ops, b, tol=tol, maxit=maxit, replace_every=replace_every)
    st = prog.init(torch.zeros_like(b) if x0 is None
                   else as_tensor(x0, b.device, b.dtype))
    st, syncs = host_loop(st, prog.cond, prog.step, unroll,
                          prog.needs_interrupt, prog.interrupt)
    return prog.finish(st, syncs)
