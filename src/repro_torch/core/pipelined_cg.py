"""Deep pipelined Conjugate Gradients, p(l)-CG (Alg. 1 of the paper), in
PyTorch: the counterpart of ``repro/core/pipelined_cg.py``.

The storage and the communication structure are the JAX package's: all
vector state lives in one (NV, N) slab (``kernels.fused_iter.SlabLayout``);
each iteration issues ONE fused dot block of 2l+1 entries through the
``SolverOps`` handle pair and parks it in a D ring of depth l, consumed l
iterations later.  Each iteration splits into a scalar phase (arrival
scatter into the G window, the K2 column correction, the K3 Hessenberg
column: O(l^2) scalars on the device) and a vector phase, either unfused
(``kernels.ref.fused_iter_unfused``, one PyTorch op per pass) or the
superkernel (``fused_iteration=True``).  Both take the same ``(S, idx,
scal)`` calling convention.

The loop without ``while_loop``.  The cycle-local iteration index ``i``
is known on the host (it advances by one per iteration and resets at a
restart), so every structural branch of the iteration (``i >= l``, the
pipeline-fill masks, the ring rows) is a host decision and ``idx`` is
built on the host.  What depends on data (convergence, breakdown, the
counters) stays on the device.  ``unroll`` has the meaning of JAX's: the
number of iterations between host checks of ``cond`` and
``needs_interrupt``, with semantics identical to ``unroll=1``.  The
iterations of a window run past a stop or a due interrupt are predicated
on a device-side ``active`` flag: they leave alone the x row (``f_upd``
AND ``active`` in ``idx``), ``tot``/``upd``/``restarts``/``since_rr``,
the ``converged``/``breakdown`` flags and ``hist``.  The rest of the slab
and the G/D/gamma/delta windows need no predication: ``finish`` does not
read them, and a restart rebuilds them from x.

Breakdown handling, the steepest-descent stagnation guard of
``restart_cycle`` and residual replacement (``replace_every``) follow the
JAX package line by line.  ``governor``, ``telemetry_cap > 0`` and
``checkpoint`` are not ported yet and raise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.types import SolveResult, SolverOps, dot1, host_loop
from repro_torch.device import as_rhs, as_tensor
from repro_torch.kernels.fused_iter import (SlabLayout, host_idx, idx_layout,
                                            scal_layout)
from repro_torch.kernels.ref import fused_iter_unfused


class _Cycle(NamedTuple):
    """Per-restart-cycle state (re-initialized on breakdown)."""

    S: torch.Tensor          # (NV, N) vector slab: ZK rings | U ring | p | x
    G: torch.Tensor          # (W, W) sliding basis-transform window
    D: torch.Tensor          # (l, 2l+1) in-flight dot blocks
    gam: torch.Tensor        # (W,) gamma ring (Hessenberg diagonal)
    dlt: torch.Tensor        # (W,) delta ring (Hessenberg off-diagonal)
    eta_prev: torch.Tensor   # eta_{i-l-1}
    zet_prev: torch.Tensor   # zeta_{i-l-1}
    i: int                   # cycle-local iteration counter (host)
    norm0_cycle: torch.Tensor


class _State(NamedTuple):
    cyc: _Cycle
    tot: torch.Tensor        # global iteration counter (termination)
    upd: torch.Tensor        # solution updates (CG-comparable iterations)
    restarts: torch.Tensor
    converged: torch.Tensor
    breakdown: torch.Tensor
    hist: torch.Tensor
    norm0: torch.Tensor      # original residual M-norm (stopping reference)
    since_rr: torch.Tensor   # solution updates since the last (re)start


class PlcgProgram(NamedTuple):
    """The p(l)-CG iteration decomposed for the host loop."""

    init: Callable[[torch.Tensor], _State]
    iteration: Callable[..., _State]        # (st, active=None) -> st
    interrupt: Callable[[_State], _State]   # restart / replacement
    cond: Callable[[_State], torch.Tensor]
    needs_interrupt: Callable[[_State], torch.Tensor]
    finish: Callable[..., SolveResult]


def build(
    ops: SolverOps,
    b: torch.Tensor,
    l: int,
    tol: float = 1e-6,
    maxit: int = 1000,
    sigmas=None,
    max_restarts: int = 10,
    replace_every: int = 0,
    fused_iteration: bool = False,
    telemetry_cap: int = 0,
    recurrence: str = "ghysels",
    governor=None,
) -> PlcgProgram:
    """Construct the p(l)-CG iteration pieces for ``b`` (depth ``l``)."""
    if l < 1:
        raise ValueError("pipeline depth l must be >= 1")
    if telemetry_cap:
        raise NotImplementedError(
            "telemetry_cap > 0 is not ported yet (ROADMAP.md, queue 1 "
            "item 6)")
    if governor is not None:
        raise NotImplementedError(
            "the stability governor is not ported yet (ROADMAP.md, queue 1 "
            "item 6)")
    if not (replace_every == 0 or replace_every > l):
        raise ValueError(
            "residual replacement must be rarer than the pipeline refill")
    if recurrence not in ("ghysels", "stable"):
        raise ValueError(f"unknown recurrence {recurrence!r}: expected "
                         "'ghysels' or 'stable'")
    n = b.shape[0]
    dtype, dev = b.dtype, b.device
    sig = (torch.zeros((l,), dtype=dtype, device=dev) if sigmas is None
           else as_tensor(sigmas, dev, dtype))
    if tuple(sig.shape) != (l,):
        raise ValueError(f"sigmas must have shape ({l},)")

    RB = max(l + 1, 3)        # per-basis ring length
    W = 3 * l + 4             # G / Hessenberg window
    tot_max = maxit + (max_restarts + 1) * (l + 1)
    H = tot_max + 2

    layout = SlabLayout(l=l, RB=RB, recurrence=recurrence)
    NV = layout.nv
    IX = idx_layout(l)

    fiter = None
    if fused_iteration:
        if ops.fused_iter_factory is None:
            raise ValueError(
                "fused_iteration=True but this SolverOps has no "
                "fused_iter_factory: unsupported operator/preconditioner "
                "for the superkernel")
        fiter = ops.fused_iter_factory(layout)

    def zero():
        return torch.zeros((), dtype=dtype, device=dev)

    def one():
        return torch.ones((), dtype=dtype, device=dev)

    ZERO, ONE = zero(), one()   # read-only constants, never written

    # Device copies of the host-built index vectors, one per distinct
    # vector (there are few: the rows are periodic in i).
    idx_cache: dict[tuple, torch.Tensor] = {}

    def idx_dev(host: list[int]) -> torch.Tensor:
        key = tuple(host)
        t = idx_cache.get(key)
        if t is None:
            t = torch.tensor(host, dtype=torch.int32, device=dev)
            idx_cache[key] = t
        return t

    # ------------------------------------------------------------- init ---
    def _make_cycle(x, u0_raw, r0_raw, eta0) -> _Cycle:
        safe = torch.where(eta0 == 0, ONE, eta0)
        v0 = r0_raw / safe
        S = torch.zeros((NV, n), dtype=dtype, device=dev)
        for k in range(l + 1):
            S[k * RB] = v0                    # z_0^(k) = v_0 for all k
        S[layout.u_off] = u0_raw / safe
        S[layout.x_row] = x
        h0 = ops.handle_zeros((2 * l + 1,), dtype, dev)
        G = torch.zeros((W, W), dtype=dtype, device=dev)
        G[0, 0] = 1.0
        return _Cycle(
            S=S, G=G,
            D=torch.zeros((l,) + tuple(h0.shape), dtype=h0.dtype,
                          device=dev),
            gam=torch.zeros((W,), dtype=dtype, device=dev),
            dlt=torch.zeros((W,), dtype=dtype, device=dev),
            eta_prev=one(), zet_prev=zero(), i=0, norm0_cycle=eta0,
        )

    def init_cycle(x) -> _Cycle:
        u0_raw = b - ops.apply_a(x)
        r0_raw = ops.prec(u0_raw)
        eta0 = torch.sqrt(torch.abs(dot1(ops, u0_raw, r0_raw)))
        return _make_cycle(x, u0_raw, r0_raw, eta0)

    def restart_cycle(x, stagnant) -> _Cycle:
        """Cycle re-init for breakdown restarts, with the steepest-descent
        stagnation guard: when the dying cycle produced no updates
        (``stagnant``), fold one steepest-descent step x' = x + alpha z,
        alpha = (r, z)/(z, A z), into the re-init.  One fused reduction;
        a non-stagnant restart (alpha = 0) reproduces ``init_cycle``."""
        r = b - ops.apply_a(x)
        z = ops.prec(r)
        az = ops.apply_a(z)
        pz = ops.prec(az)
        dots = ops.wait(ops.start(
            torch.stack([r * z, az * z, az * pz]),
            torch.ones_like(z))).to(dtype)
        a, c, e = dots[0], dots[1], dots[2]
        ok = stagnant & (c > 0) & torch.isfinite(c)
        alpha = torch.where(ok, a / torch.where(c == 0, ONE, c), ZERO)
        x1 = x + alpha * z
        u0_raw = r - alpha * az
        r0_raw = z - alpha * pz               # prec is linear
        eta0 = torch.sqrt(torch.abs(a - 2 * alpha * c + alpha * alpha * e))
        return _make_cycle(x1, u0_raw, r0_raw, eta0)

    # -------------------------------------------------------- iteration ---
    def iteration(st: _State, active: torch.Tensor | None = None) -> _State:
        """One p(l)-CG iteration.  ``active`` (a device bool) predicates
        the observable state; None means unconditionally active."""
        c = st.cyc
        i = c.i
        im = i - l                     # index of the Hessenberg column built
        ge_l = i >= l
        G, gam, dlt, D = c.G, c.gam, c.dlt, c.D

        # ===== scalar phase: MPI_Wait arrival + K2 + K3 ===================
        # G, gam, dlt and D are updated in place; every value read from
        # them below is either consumed before the element is rewritten or
        # is the post-write value the functional reference reads too.
        if ge_l:
            col = i - l + 1            # G column whose dots arrived
            arrived = ops.wait(D[im % l], advanced=l - 1).to(dtype)
            for t in range(2 * l + 1):         # rows im-2l+1 .. im+1
                row = im - 2 * l + 1 + t
                if row >= 0:
                    G[row % W, col % W] = arrived[t]

            # ---- (K2) lines 9-10: correct column `col`
            for t in range(l - 1):
                j = i - 2 * l + 2 + t
                if j < 0:
                    G[j % W, col % W] = 0.0
                    continue
                ssum = ZERO
                for s in range(l + 1 + t):
                    k_ = i - 3 * l + 1 + s
                    if k_ >= 0:
                        ssum = ssum + G[k_ % W, j % W] * G[k_ % W, col % W]
                denom = G[j % W, j % W]
                denom = torch.where(denom == 0, ONE, denom)
                G[j % W, col % W] = (G[j % W, col % W] - ssum) / denom

            ssum = ZERO
            for s in range(2 * l):
                k_ = i - 3 * l + 1 + s
                if k_ >= 0:
                    g = G[k_ % W, col % W]
                    ssum = ssum + g * g
            arg = G[col % W, col % W] - ssum
            breakdown = (arg <= 0) | ~torch.isfinite(arg)      # line 11
            sq = torch.sqrt(torch.where(breakdown, ONE, arg))
            G[col % W, col % W] = sq

            # ---- (K3) lines 12-18: new Hessenberg column
            g_mm = G[im % W, im % W]
            g_mm_safe = torch.where(g_mm == 0, ONE, g_mm)
            g_mp = G[im % W, (im + 1) % W]
            g_prev = G[(im - 1) % W, im % W] if im >= 1 else ZERO
            d_prev = dlt[(im - 1) % W] if im >= 1 else ZERO
            sig_im = sig[min(max(im, 0), l - 1)]
            if i < 2 * l:
                gam_new = (g_mp + sig_im * g_mm - g_prev * d_prev) / g_mm_safe
                dlt_new = sq / g_mm_safe
            else:
                gam_new = (g_mm * gam[(im - l) % W]
                           + g_mp * dlt[(im - l) % W]
                           - g_prev * d_prev) / g_mm_safe
                dlt_new = sq * dlt[(im - l) % W] / g_mm_safe
            gam[im % W] = gam_new
            dlt[im % W] = dlt_new
            dlt_safe = torch.where(dlt_new == 0, ONE, dlt_new)
        else:
            gam_new, dlt_safe, breakdown = ZERO, ONE, None

        d2 = dlt[(im - 1) % W] if im >= 1 else ZERO   # delta_{i-l-1}

        # ---- (K6) scalar updates (lines 24-32, D-Lanczos factors)
        gam0 = gam[0]
        gam_im = gam[im % W] if ge_l else ZERO
        d_prev = d2
        is_first = i == l
        eta0_safe = torch.where(gam0 == 0, ONE, gam0)
        do_upd = i >= l + 1
        eta_prev_safe = torch.where(c.eta_prev == 0, ONE, c.eta_prev)
        lam = d_prev / eta_prev_safe
        eta_new = gam_im - lam * d_prev
        eta_new_safe = torch.where(eta_new == 0, ONE, eta_new)
        zet_new = -lam * c.zet_prev

        # ===== vector phase ===============================================
        sig_i = sig[i] if i < l else ZERO
        scal = torch.cat([
            torch.stack([sig_i, gam_new, d2, dlt_safe, c.zet_prev, d_prev,
                         eta_new_safe, eta0_safe]),
            sig - gam_new])
        host = host_idx(layout, i)
        # f_upd AND active keeps the x row of a predicated iteration.
        upd_flag = do_upd if active is None or not do_upd else active
        if fiter is not None:
            if isinstance(upd_flag, torch.Tensor):
                off = list(host)
                off[IX["f_upd"]] = 0
                idx = torch.where(upd_flag, idx_dev(host), idx_dev(off))
            else:
                idx = idx_dev(host)
            S, partials = fiter(c.S, idx, scal)
            dots = ops.start_partials(partials)
        else:
            host[IX["f_upd"]] = upd_flag
            S, mat, u_new = fused_iter_unfused(c.S, host, scal, ops.apply_a,
                                               ops.prec, layout)
            # ---- (K5) line 23: initiate the dot block, ONE reduction
            dots = ops.start(mat, u_new)
        D[i % l] = dots
        # One ladder step per in-flight handle (identity on one device).
        for t in range(1, l):
            slot = (i - t) % l
            h = ops.advance(D[slot], t - 1)
            if h is not D[slot]:
                D[slot] = h

        eta_prev = gam0.clone() if is_first else (
            eta_new if do_upd else c.eta_prev)
        zet_prev = c.norm0_cycle if is_first else (
            zet_new if do_upd else c.zet_prev)

        cyc = _Cycle(S=S, G=G, D=D, gam=gam, dlt=dlt, eta_prev=eta_prev,
                     zet_prev=zet_prev, i=i + 1, norm0_cycle=c.norm0_cycle)

        # ===== observable state, predicated on `active` ===================
        step = 1 if active is None else active.to(st.tot.dtype)
        upd, converged, hist, since_rr = st.upd, st.converged, st.hist, \
            st.since_rr
        if do_upd:
            upd = st.upd + step
            since_rr = st.since_rr + step
            rnorm = torch.abs(zet_new)
            # A breakdown iteration's scalars are garbage: never record or
            # converge on them.
            ok = ~breakdown if active is None else (~breakdown & active)
            slot = upd.clamp(0, H - 1).view(1)
            hist.scatter_(0, slot, torch.where(ok, rnorm.view(1),
                                               hist.gather(0, slot)))
            converged = st.converged | (ok & (rnorm / st.norm0 < tol))
        if breakdown is None:
            bd = st.breakdown & ~active if active is not None else \
                torch.zeros_like(st.breakdown)
        else:
            bd = breakdown if active is None else \
                torch.where(active, breakdown, st.breakdown)
        return _State(cyc=cyc, tot=st.tot + step, upd=upd,
                      restarts=st.restarts, converged=converged,
                      breakdown=bd, hist=hist, norm0=st.norm0,
                      since_rr=since_rr)

    def do_restart(st: _State) -> _State:
        # Stagnation guard: a breakdown before the cycle's first solution
        # update re-inits with a steepest-descent step.
        cyc = restart_cycle(st.cyc.S[layout.x_row],
                            st.breakdown & (st.since_rr == 0))
        # A breakdown at a converged iterate is a "lucky breakdown".
        lucky = cyc.norm0_cycle / st.norm0 < tol
        return _State(
            cyc=cyc, tot=st.tot + 1, upd=st.upd, restarts=st.restarts + 1,
            converged=st.converged | lucky,
            breakdown=torch.zeros_like(st.breakdown), hist=st.hist,
            norm0=st.norm0, since_rr=torch.zeros_like(st.since_rr))

    def needs_interrupt(st: _State) -> torch.Tensor:
        due = st.breakdown
        if replace_every > 0:
            due = due | (st.since_rr >= replace_every)
        return due

    def cond(st: _State) -> torch.Tensor:
        return ((~st.converged) & (st.tot < tot_max) & (st.upd < maxit)
                & (st.restarts <= max_restarts))

    def init(x0: torch.Tensor) -> _State:
        cyc0 = init_cycle(x0)
        norm0 = cyc0.norm0_cycle
        hist0 = torch.full((H,), -1.0, dtype=dtype, device=dev)
        hist0[0] = norm0
        izero = torch.zeros((), dtype=torch.int64, device=dev)
        return _State(
            cyc=cyc0, tot=izero, upd=izero.clone(), restarts=izero.clone(),
            converged=norm0 == 0.0,
            breakdown=torch.zeros((), dtype=torch.bool, device=dev),
            hist=hist0, norm0=norm0, since_rr=izero.clone())

    def finish(final: _State, host_syncs: int = 0) -> SolveResult:
        return SolveResult(
            x=final.cyc.S[layout.x_row].clone(), iters=final.upd,
            restarts=final.restarts, converged=final.converged,
            res_history=final.hist, norm0=final.norm0,
            host_syncs=host_syncs)

    return PlcgProgram(init=init, iteration=iteration, interrupt=do_restart,
                       cond=cond, needs_interrupt=needs_interrupt,
                       finish=finish)


def solve(
    ops: SolverOps,
    b,
    l: int,
    x0=None,
    tol: float = 1e-6,
    maxit: int = 1000,
    sigmas=None,
    max_restarts: int = 10,
    unroll: int = 1,
    replace_every: int = 0,
    fused_iteration: bool = False,
    telemetry_cap: int = 0,
    recurrence: str = "ghysels",
    governor=None,
    checkpoint=None,
    device=None,
) -> SolveResult:
    """Solve A x = b with p(l)-CG.

    ``b`` as a tensor keeps its device; as an array it goes to ``device``
    (default ``cuda``).  A floating ``b`` keeps its dtype, which is the
    solve's (the fused superkernel takes fp64 only).  ``unroll`` is the number of iterations between
    host checks of the loop condition (one host synchronisation each);
    the result is bitwise the same for every ``unroll``."""
    if checkpoint is not None and getattr(checkpoint, "armed", True):
        raise NotImplementedError(
            "checkpointed solves are not ported yet (ROADMAP.md, queue 1 "
            "item 6)")
    b = as_rhs(b, device)
    prog = build(ops, b, l, tol=tol, maxit=maxit, sigmas=sigmas,
                 max_restarts=max_restarts, replace_every=replace_every,
                 fused_iteration=fused_iteration, telemetry_cap=telemetry_cap,
                 recurrence=recurrence, governor=governor)
    st = prog.init(torch.zeros_like(b) if x0 is None
                   else as_tensor(x0, b.device, b.dtype))
    st, syncs = host_loop(st, prog.cond, prog.iteration, unroll,
                          prog.needs_interrupt, prog.interrupt)
    return prog.finish(st, syncs)
