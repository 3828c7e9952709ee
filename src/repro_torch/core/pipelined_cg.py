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
JAX package line by line, and so do the telemetry ring
(``telemetry_cap > 0``) and the stability governor (``governor``):

* the ring is a (cap + 1, K) tensor on the device (``tel_layout`` rows);
  each iteration writes one row, built by one concatenation of scalars
  the iteration already holds, at the device-side slot ``tot % cap``; a
  predicated iteration writes the spare last row instead, which
  ``finish`` drops.  No reduction and no host synchronisation is added,
  and the arithmetic is untouched: an instrumented solve is bitwise the
  plain one.
* the governor's (N_SLOTS,) vector is rebuilt each late iteration from
  the arrived dot block and the scalars of ``scal`` in a few whole-tensor
  operations (``stability.model`` holds its slots and ``gap_step``); a
  due action rides on ``needs_interrupt``, which the host loop already
  reads with ``cond`` at its check, and the restart consumes it.
  ``governor=None`` computes none of it.

``checkpoint`` (a ``repro_torch.checkpoint.CheckpointConfig`` with
``every > 0``) hands the solve to ``checkpoint.checkpointed_solve``: the
same host loop with snapshots at its interrupt boundaries, in the JAX
package's file format.  ``every=0`` or None leaves this path untouched.

The slab form (``build`` with an (s, N) ``b``, driven by
``core.batched``): each column keeps its own host cycle index, the
windows (G, gamma, delta, the D ring) turn with the program's clock ``t``
(a column's logical index k sits at ring position (k + t - i) mod length),
so one ring position serves every column, and the scalar phase runs once
per group of columns that share the host decisions of their index
(``decision_key``; one group once every column is past its pipeline
fill), on (s_g,)-stacked tensors with the elementwise operations of the
sequential code: every column's arithmetic is its sequential program's.
The vector phase takes an (s, IX) index table (one ``host_idx`` row a
column) and issues ONE dot-block start for the s columns.
"""

from __future__ import annotations

import collections
from typing import Callable, NamedTuple

import torch

from repro_torch.core.types import (SolveResult, SolverOps, dot1, host_loop,
                                    host_tensor)
from repro_torch.device import as_rhs, as_tensor
from repro_torch.kernels.fused_iter import (SlabLayout, host_idx, idx_layout,
                                            scal_layout, tel_layout)
from repro_torch.kernels.ref import (fused_iter_unfused,
                                     fused_iter_unfused_slab)


class _Cycle(NamedTuple):
    """Per-restart-cycle state (re-initialized on breakdown).  Tensors carry
    the leading batch dimension of ``b`` (none, or s for a slab)."""

    S: torch.Tensor          # (NV, N) vector slab: ZK rings | U ring | p | x
    G: torch.Tensor          # (W, W) sliding basis-transform window
    D: torch.Tensor          # (l, 2l+1) in-flight dot blocks
    gam: torch.Tensor        # (W,) gamma ring (Hessenberg diagonal)
    dlt: torch.Tensor        # (W,) delta ring (Hessenberg off-diagonal)
    eta_prev: torch.Tensor   # eta_{i-l-1}
    zet_prev: torch.Tensor   # zeta_{i-l-1}
    i: int | tuple           # cycle-local iteration counter (host; a slab
                             # holds one per column)
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
    t: int = 0               # iterations this program ran (host): the clock
                             # the windows' rings turn with
    tel: torch.Tensor | None = None   # (cap + 1, K) telemetry ring (the
                             # last row takes predicated writes); None
                             # when uninstrumented
    gov: torch.Tensor | None = None   # (N_SLOTS,) governor vector; None
                             # when ungoverned


class PlcgProgram(NamedTuple):
    """The p(l)-CG iteration decomposed for the host loop."""

    init: Callable[..., _State]             # (x0, t0=0, b_=None) -> st
    iteration: Callable[..., _State]        # (st, active=None) -> st
    interrupt: Callable[..., _State]        # (st, b_=None): restart /
                                            # replacement
    cond: Callable[[_State], torch.Tensor]
    needs_interrupt: Callable[[_State], torch.Tensor]
    finish: Callable[..., SolveResult]


# Slab iterations by the number of scalar-phase groups they ran (a slab
# past every column's pipeline fill runs one); counted for the slab form
# only, read by the measurements.
SCALAR_GROUPS: collections.Counter = collections.Counter()


def decision_key(i: int, l: int) -> int:
    """The host decisions of cycle iteration ``i``: every structural branch
    of the scalar phase and every flag of the index vector is the same for
    all i >= 3l - 1 (the pipeline is full), which share the key -1; before
    that each i is its own."""
    return i if i < 3 * l - 1 else -1


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
    """Construct the p(l)-CG iteration pieces for ``b`` (depth ``l``).

    ``b`` is one right-hand side (N,) or a slab of s of them (s, N), one a
    row; the slab program runs the s columns in lock step (one dot-block
    start and, fused, one superkernel launch an iteration), each column
    with the arithmetic of its own sequential program, its own telemetry
    ring (s, cap, K) and its own governor vector (s, N_SLOTS).

    ``telemetry_cap > 0`` records the per-iteration telemetry ring
    (``SolveResult.telemetry``); ``governor`` (a
    ``stability.GovernorConfig``) arms the stability governor
    (``SolveResult.governor``): gap- and patience-arm residual
    replacements through the interrupt machinery, convergence certified
    by the true residual, the terminal STAGNATED flag."""
    if l < 1:
        raise ValueError("pipeline depth l must be >= 1")
    if telemetry_cap < 0:
        raise ValueError("telemetry_cap must be >= 0")
    if not (replace_every == 0 or replace_every > l):
        raise ValueError(
            "residual replacement must be rarer than the pipeline refill")
    if recurrence not in ("ghysels", "stable"):
        raise ValueError(f"unknown recurrence {recurrence!r}: expected "
                         "'ghysels' or 'stable'")
    if b.dim() not in (1, 2):
        raise ValueError(f"b must be (N,) or a slab (s, N), got "
                         f"{tuple(b.shape)}")
    n = b.shape[-1]
    batch = tuple(b.shape[:-1])
    slab = bool(batch)
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
    IS = scal_layout(l)
    TK = tel_layout(l)["size"]
    cap = int(telemetry_cap)
    # The arrived dot block is read by the ring and the governor only.
    need_dots = bool(cap) or governor is not None
    if governor is not None:
        from repro_torch.stability import model as GM
        g_eps = governor.resolved_eps(dtype)
        g_patience = governor.resolved_patience(l)

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
    MINUS_ONE, TWO, THREE = -one(), 2 * one(), 3 * one()
    NAN = torch.full((), float("nan"), dtype=dtype, device=dev)
    DOTS0 = torch.zeros((2 * l + 1,), dtype=dtype, device=dev)

    # Device copies of host-built index vectors and masks, one per distinct
    # value (there are few: the rows are periodic in i; a long-lived slab
    # program meets new column phases at every inject, so the cache is
    # emptied when it grows past a bound).
    cache: dict[tuple, torch.Tensor] = {}

    def dev_tensor(kind: str, host, dt=torch.int32) -> torch.Tensor:
        key = (kind, tuple(host))
        t = cache.get(key)
        if t is None:
            if len(cache) >= 4096:
                cache.clear()
            t = cache[key] = host_tensor(list(host), dt, dev)
        return t

    def idx_key(i: int) -> int:
        """A cycle index with the index vector of ``i``: the rows are
        periodic in i with period 3 RB once the flags are settled."""
        return i if i <= l + 1 else l + 2 + (i - l - 2) % (3 * RB)

    def idx_table(i_cols: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """The slab's (s, IX) index table, one row a column, and the same
        with every ``f_upd`` cleared (a predicated column's x stays)."""
        keys = tuple(idx_key(i) for i in i_cols)
        got = cache.get(("table", keys))
        if got is None:
            rows = [host_idx(layout, k) for k in keys]
            on = dev_tensor("rows", [v for r in rows for v in r]).view(
                len(keys), IX["size"])
            off = on.clone()
            off[:, IX["f_upd"]] = 0
            got = cache[("table", keys)] = (on, off)
        return got

    # Index prefix of the batch axes: empty for one right-hand side, so the
    # sequential iteration indexes its windows without an Ellipsis (the
    # host sets the pace of that loop, and every index op counts).
    E = (slice(None),) * len(batch)

    def ring(X, k):
        """Slot ``k`` of a ring whose axis follows the batch axes."""
        return X[E + (k,)]

    # ------------------------------------------------------------- init ---
    def _make_cycle(x, u0_raw, r0_raw, eta0, t0) -> _Cycle:
        """A fresh cycle whose iteration 0 runs at program clock ``t0``:
        the windows hold logical index k at ring position (k + t0) mod
        their length, so every column of a slab turns its rings with the
        one clock (the slab's rings are read and written at one position
        whatever each column's cycle index)."""
        safe = torch.where(eta0 == 0, ONE, eta0)
        v0 = r0_raw / safe[..., None]
        S = torch.zeros(eta0.shape + (NV, n), dtype=dtype, device=dev)
        for k in range(l + 1):
            S[..., k * RB, :] = v0            # z_0^(k) = v_0 for all k
        S[..., layout.u_off, :] = u0_raw / safe[..., None]
        S[..., layout.x_row, :] = x
        h0 = ops.handle_zeros((2 * l + 1,), dtype, dev)
        G = torch.zeros(eta0.shape + (W, W), dtype=dtype, device=dev)
        G[..., t0 % W, t0 % W] = 1.0
        cols = eta0.shape[0] if eta0.dim() else 0
        return _Cycle(
            S=S, G=G,
            D=torch.zeros(eta0.shape + (l,) + tuple(h0.shape),
                          dtype=h0.dtype, device=dev),
            gam=torch.zeros(eta0.shape + (W,), dtype=dtype, device=dev),
            dlt=torch.zeros(eta0.shape + (W,), dtype=dtype, device=dev),
            eta_prev=torch.ones_like(eta0), zet_prev=torch.zeros_like(eta0),
            i=(0,) * cols if eta0.dim() else 0, norm0_cycle=eta0,
        )

    def init_cycle(x, bb, t0) -> _Cycle:
        u0_raw = bb - ops.apply_a(x)
        r0_raw = ops.prec(u0_raw)
        eta0 = torch.sqrt(torch.abs(dot1(ops, u0_raw, r0_raw)))
        return _make_cycle(x, u0_raw, r0_raw, eta0, t0)

    def restart_cycle(x, stagnant, bb, t0) -> _Cycle:
        """Cycle re-init for breakdown restarts, with the steepest-descent
        stagnation guard: when the dying cycle produced no updates
        (``stagnant``), fold one steepest-descent step x' = x + alpha z,
        alpha = (r, z)/(z, A z), into the re-init.  One fused reduction;
        a non-stagnant restart (alpha = 0) reproduces ``init_cycle``."""
        r = bb - ops.apply_a(x)
        z = ops.prec(r)
        az = ops.apply_a(z)
        pz = ops.prec(az)
        dots = ops.wait(ops.start(
            torch.stack([r * z, az * z, az * pz], dim=-2),
            torch.ones_like(z))).to(dtype)
        a, c, e = dots[..., 0], dots[..., 1], dots[..., 2]
        ok = stagnant & (c > 0) & torch.isfinite(c)
        alpha = torch.where(ok, a / torch.where(c == 0, ONE, c), ZERO)
        x1 = x + alpha[..., None] * z
        u0_raw = r - alpha[..., None] * az
        r0_raw = z - alpha[..., None] * pz    # prec is linear
        eta0 = torch.sqrt(torch.abs(a - 2 * alpha * c + alpha * alpha * e))
        return _make_cycle(x1, u0_raw, r0_raw, eta0, t0)

    # ----------------------------------------------------- scalar phase ---
    def scalar_phase(G, D, gam, dlt, eta_prev, zet_prev, norm0_cycle,
                     i: int, o: int, waited=None):
        """MPI_Wait arrival + K2 + K3 + K6 of cycle iteration ``i`` for
        windows whose logical index k sits at ring position (k + o) mod
        length (``o`` = clock - i).  G, gam and dlt are updated in place;
        every value read from them below is either consumed before the
        element is rewritten or is the post-write value the functional
        reference reads too.  ``waited``: the arrived dot block, already
        waited for (a group of a slab's columns); None waits for D's slot
        here.  Returns (scal, breakdown or None, zet_new, eta_prev',
        zet_prev', the arrived dot block or None)."""
        im = i - l                     # index of the Hessenberg column built
        ge_l = i >= l
        w_im, w_im1 = (im + o) % W, (im - 1 + o) % W

        if ge_l:
            col = i - l + 1            # G column whose dots arrived
            w_col = (col + o) % W
            arrived = waited if waited is not None else ops.wait(
                ring(D, (im + o) % l), advanced=l - 1).to(dtype)
            if need_dots and waited is None:
                # A view of the D slot this iteration's start overwrites.
                arrived = arrived.clone()
            for t in range(2 * l + 1):         # rows im-2l+1 .. im+1
                row = im - 2 * l + 1 + t
                if row >= 0:
                    G[E + ((row + o) % W, w_col)] = arrived[E + (t,)]

            # ---- (K2) lines 9-10: correct column `col`
            for t in range(l - 1):
                j = i - 2 * l + 2 + t
                w_j = (j + o) % W
                if j < 0:
                    G[E + (w_j, w_col)] = 0.0
                    continue
                ssum = ZERO
                for s in range(l + 1 + t):
                    k_ = i - 3 * l + 1 + s
                    if k_ >= 0:
                        w_k = (k_ + o) % W
                        ssum = ssum + G[E + (w_k, w_j)] * G[E + (w_k, w_col)]
                denom = G[E + (w_j, w_j)]
                denom = torch.where(denom == 0, ONE, denom)
                G[E + (w_j, w_col)] = (G[E + (w_j, w_col)] - ssum) / denom

            ssum = ZERO
            for s in range(2 * l):
                k_ = i - 3 * l + 1 + s
                if k_ >= 0:
                    g = G[E + ((k_ + o) % W, w_col)]
                    ssum = ssum + g * g
            arg = G[E + (w_col, w_col)] - ssum
            breakdown = (arg <= 0) | ~torch.isfinite(arg)      # line 11
            sq = torch.sqrt(torch.where(breakdown, ONE, arg))
            G[E + (w_col, w_col)] = sq

            # ---- (K3) lines 12-18: new Hessenberg column
            g_mm = G[E + (w_im, w_im)]
            g_mm_safe = torch.where(g_mm == 0, ONE, g_mm)
            g_mp = G[E + (w_im, (im + 1 + o) % W)]
            g_prev = G[E + (w_im1, w_im)] if im >= 1 else ZERO
            d_prev = dlt[E + (w_im1,)] if im >= 1 else ZERO
            sig_im = sig[min(max(im, 0), l - 1)]
            if i < 2 * l:
                gam_new = (g_mp + sig_im * g_mm - g_prev * d_prev) / g_mm_safe
                dlt_new = sq / g_mm_safe
            else:
                w_iml = (im - l + o) % W
                gam_new = (g_mm * gam[E + (w_iml,)]
                           + g_mp * dlt[E + (w_iml,)]
                           - g_prev * d_prev) / g_mm_safe
                dlt_new = sq * dlt[E + (w_iml,)] / g_mm_safe
            gam[E + (w_im,)] = gam_new
            dlt[E + (w_im,)] = dlt_new
            dlt_safe = torch.where(dlt_new == 0, ONE, dlt_new)
        else:
            gam_new, dlt_safe, breakdown, arrived = ZERO, ONE, None, None

        d2 = dlt[E + (w_im1,)] if im >= 1 else ZERO   # delta_{i-l-1}

        # ---- (K6) scalar updates (lines 24-32, D-Lanczos factors)
        # gamma_0 of the cycle; read at i == l only
        gam0 = gam[E + (o % W,)]
        gam_im = gam[E + (w_im,)] if ge_l else ZERO
        d_prev = d2
        is_first = i == l
        eta0_safe = torch.where(gam0 == 0, ONE, gam0)
        do_upd = i >= l + 1
        eta_prev_safe = torch.where(eta_prev == 0, ONE, eta_prev)
        lam = d_prev / eta_prev_safe
        eta_new = gam_im - lam * d_prev
        eta_new_safe = torch.where(eta_new == 0, ONE, eta_new)
        zet_new = -lam * zet_prev

        sig_i = sig[i] if i < l else ZERO
        head = [sig_i, gam_new, d2, dlt_safe, zet_prev, d_prev, eta_new_safe,
                eta0_safe]
        if E:       # a slab: the constants broadcast to the columns
            head = torch.broadcast_tensors(*head, eta_prev)[:8]
            scal = torch.cat([torch.stack(head, dim=-1),
                              sig - head[1][..., None]], dim=-1)
        else:
            scal = torch.cat([torch.stack(head), sig - gam_new])
        eta_next = gam0.clone() if is_first else (
            eta_new if do_upd else eta_prev)
        zet_next = norm0_cycle if is_first else (
            zet_new if do_upd else zet_prev)
        return scal, breakdown, zet_new, eta_next, zet_next, arrived

    def scalar_groups(c: _Cycle, t: int):
        """The scalar phase of every column: one pass per group of columns
        that share the host decisions of their cycle index (a slab past its
        pipeline fill is one group and runs on the state's own windows).
        Returns (scal, breakdown, zet_new, eta_prev', zet_prev', arrived,
        do_upd, ge_l), the last two host bools or, over several groups,
        (s,) device masks; breakdown and arrived are None where no column
        is past the fill's first l iterations (over several groups,
        arrived is assembled only when the ring or the governor reads
        it)."""
        if not slab:
            out = scalar_phase(c.G, c.D, c.gam, c.dlt, c.eta_prev,
                               c.zet_prev, c.norm0_cycle, c.i, t - c.i)
            return out + (c.i >= l + 1, c.i >= l)
        groups: dict[int, list[int]] = {}
        for col, i in enumerate(c.i):
            groups.setdefault(decision_key(i, l), []).append(col)
        SCALAR_GROUPS[len(groups)] += 1
        if len(groups) == 1:
            i = max(c.i)        # any column's: the decisions are the same
            out = scalar_phase(c.G, c.D, c.gam, c.dlt, c.eta_prev,
                               c.zet_prev, c.norm0_cycle, i, t - i)
            return out + (i >= l + 1, i >= l)
        s_ = len(c.i)
        # ONE wait for the slab's in-flight block (every group's columns
        # arrive from the ring slot of clock t - l): a wire's request or
        # ladder completes once, whatever the groups.
        full = (ops.wait(ring(c.D, t % l), advanced=l - 1).to(dtype)
                if max(c.i) >= l else None)
        scal = torch.empty((s_, 8 + l), dtype=dtype, device=dev)
        bd = torch.zeros((s_,), dtype=torch.bool, device=dev)
        zet = torch.zeros((s_,), dtype=dtype, device=dev)
        eta_next, zet_next = c.eta_prev.clone(), c.zet_prev.clone()
        arr = (torch.zeros((s_, 2 * l + 1), dtype=dtype, device=dev)
               if need_dots else None)
        for cols in groups.values():
            gi = dev_tensor("cols", cols, torch.long)
            i = c.i[cols[0]]
            win = [X.index_select(0, gi) for X in
                   (c.G, c.D, c.gam, c.dlt, c.eta_prev, c.zet_prev,
                    c.norm0_cycle)]
            sc_g, bd_g, zet_g, eta_g, zp_g, arr_g = scalar_phase(
                *win, i, t - i,
                full.index_select(0, gi) if i >= l else None)
            c.G.index_copy_(0, gi, win[0])
            c.gam.index_copy_(0, gi, win[2])
            c.dlt.index_copy_(0, gi, win[3])
            scal.index_copy_(0, gi, sc_g)
            if bd_g is not None:
                bd.index_copy_(0, gi, bd_g)
                if arr is not None:
                    arr.index_copy_(0, gi, arr_g)
            zet.index_copy_(0, gi, zet_g.expand(len(cols)))
            eta_next.index_copy_(0, gi, eta_g.expand(len(cols)))
            zet_next.index_copy_(0, gi, zp_g.expand(len(cols)))
        do_upd = dev_tensor("mask", [i >= l + 1 for i in c.i], torch.bool)
        ge_l = dev_tensor("mask", [i >= l for i in c.i], torch.bool)
        return scal, bd, zet, eta_next, zet_next, arr, do_upd, ge_l

    # ------------------------------------------- telemetry and governor ---
    SPARE = host_tensor(cap, torch.int64, dev) if cap else None

    def tel_write(tel, tot, upd, cols: list, dots, active=None):
        """Store one ``tel_layout`` row in the ring at slot ``tot % cap``
        (the spare last row where ``active`` is False): the counters
        ``tot`` and ``upd``, ``cols`` the other seven scalar columns in
        layout order (0-d or one a column, in the solve's dtype), ``dots``
        the 2l+1 dot-block entries.  One stack and one concatenation build
        the row, one scatter stores it: few launches, and few calls, since
        the host sets the pace."""
        shape = tot.shape
        if shape:           # a slab: 0-d constants go to every column
            cols = [v if v.shape == shape else v.expand(shape) for v in cols]
            dots = dots.expand(shape + (2 * l + 1,))
        row = torch.cat([torch.stack([tot.to(dtype), upd.to(dtype), *cols],
                                     -1), dots], -1)
        slot = tot % cap
        if active is not None:
            slot = torch.where(active, slot, SPARE)
        tel.scatter_(-2, slot.view(shape + (1, 1)).expand(shape + (1, TK)),
                     row.unsqueeze(-2))
        return tel

    def gov_iteration(gov, scal, arrived, ge_l, ok, rel, upd, active):
        """The governor's detection arms for one iteration (the JAX
        package's pipelined_cg.py:557-605): the new governor vector, the
        gap and the action code.  ``ok`` None: no solution update this
        iteration, so only the gap moves.  Whole-tensor operations over
        the columns, each launch counted: the host sets the pace."""
        g = gov.unbind(-1).__getitem__      # the slots, as views
        # |gam_new|, |d2|, |dlt_safe| sit side by side in scal.
        inc = GM.gap_increment(
            torch.abs(scal.narrow(-1, IS["gam_new"], 3)),
            torch.sqrt(torch.abs(arrived.select(-1, 2 * l))), g_eps,
            governor.kappa)
        gap = g(GM.GAP) + torch.maximum(inc, g(GM.RATE))
        if ge_l is not True:
            gap = torch.where(ge_l, gap, g(GM.GAP))
        if ok is None:
            new = torch.cat([gap.unsqueeze(-1),
                             gov.narrow(-1, GM.GAP + 1, GM.N_SLOTS - 1)], -1)
            code = ZERO
        else:
            # rel is NaN where not ok, so each comparison below is False
            # there, as the reference's ok & (...) is.
            rel = torch.where(ok, rel, NAN)
            upd_f = upd.to(dtype)
            improved = rel < governor.improve_ratio * g(GM.BEST)
            best = torch.where(improved, rel, g(GM.BEST))
            best_upd = torch.where(improved, upd_f, g(GM.BEST_UPD))
            # The gap arm, and the recursion claiming convergence: both
            # schedule a replacement whose true residual decides.
            gap_due = (governor.safety * gap >= rel) | (rel < tol)
            pat_due = (rel >= tol) & (upd_f - best_upd >= g_patience)
            code = torch.where(gap_due, ONE,
                               torch.where(pat_due, TWO, ZERO))
            # An active iteration has nothing due (a due action stops the
            # loop at needs_interrupt), so its due is the code.
            due = code if active is not None else torch.where(
                g(GM.DUE) > 0, g(GM.DUE), code)
            new = torch.cat([torch.stack([gap, best, best_upd, due], -1),
                             gov.narrow(-1, GM.DUE + 1,
                                        GM.N_SLOTS - GM.DUE - 1)], -1)
        if active is not None:
            new = torch.where(active.unsqueeze(-1), new, gov)
        return new, gap, code

    def gov_restart(st: _State, cyc: _Cycle):
        """The governor's accounting at a restart (the JAX package's
        pipelined_cg.py:637-693): consume the pending action, judge it
        against the TRUE residual of the re-init, re-seed the gap and
        measure the drift rate of the cycle that ended.  Returns the new
        vector and the action code."""
        gov = st.gov
        g = gov.unbind(-1).__getitem__      # the slots, as views
        was_due = g(GM.DUE)
        fired = was_due > 0
        rel_now = cyc.norm0_cycle / st.norm0      # TRUE relative residual
        rec_rel = torch.abs(st.cyc.zet_prev) / st.norm0
        measured = torch.clamp(rel_now - rec_rel, min=0.0)
        i_c = st.cyc.i
        i_f = (float(max(i_c, 1)) if isinstance(i_c, int) else
               dev_tensor("i_f", [max(i, 1) for i in i_c], dtype))
        rate_new = measured / i_f
        fruitful = rel_now < governor.improve_ratio * g(GM.LAST_REL)
        fruitless = torch.where(
            fired, torch.where(fruitful, ZERO, g(GM.FRUITLESS) + 1),
            g(GM.FRUITLESS))
        stag = torch.where(fruitless >= governor.demote_after, ONE,
                           g(GM.STAGNATED))
        action = torch.where(stag > g(GM.STAGNATED), THREE, was_due)
        new = torch.stack([
            torch.full_like(rel_now, g_eps),               # GAP
            torch.minimum(g(GM.BEST), rel_now),            # BEST
            st.upd.to(dtype),                              # BEST_UPD
            torch.zeros_like(rel_now),                     # DUE
            g(GM.REPL) + fired.to(dtype),                  # REPL
            fruitless, stag,                               # FRUITLESS, STAG
            torch.where(fired, rel_now, g(GM.LAST_REL)),   # LAST_REL
            rate_new], -1)                                 # RATE
        return new, action

    # -------------------------------------------------------- iteration ---
    def iteration(st: _State, active: torch.Tensor | None = None) -> _State:
        """One p(l)-CG iteration.  ``active`` (a device bool, (s,) for a
        slab) predicates the observable state, and is False wherever
        ``needs_interrupt`` holds (the host loop and the slab driver pass
        ``cond & ~needs_interrupt``); None means unconditionally
        active."""
        c = st.cyc
        t = st.t
        G, gam, dlt, D = c.G, c.gam, c.dlt, c.D

        # ===== scalar phase: MPI_Wait arrival + K2 + K3 + K6 ==============
        scal, breakdown, zet_new, eta_prev, zet_prev, arrived, do_upd, \
            ge_l = scalar_groups(c, t)

        # ===== vector phase ===============================================
        if slab:
            on, off = idx_table(c.i)
            idx = on if active is None else torch.where(active[:, None],
                                                        on, off)
            if fiter is not None:
                S, partials = fiter(c.S, idx, scal)
                dots = ops.start_partials(partials)
            else:
                S, mat, u_new = fused_iter_unfused_slab(
                    c.S, idx, scal, ops.apply_a, ops.prec, layout)
                # ---- (K5) line 23: ONE reduction for the s columns
                dots = ops.start(mat, u_new)
        else:
            host = host_idx(layout, c.i)
            # f_upd AND active keeps the x row of a predicated iteration.
            upd_flag = do_upd if active is None or not do_upd else active
            if fiter is not None:
                if isinstance(upd_flag, torch.Tensor):
                    off = list(host)
                    off[IX["f_upd"]] = 0
                    idx = torch.where(upd_flag, dev_tensor("idx", host),
                                      dev_tensor("idx", off))
                else:
                    idx = dev_tensor("idx", host)
                S, partials = fiter(c.S, idx, scal)
                dots = ops.start_partials(partials)
            else:
                host[IX["f_upd"]] = upd_flag
                S, mat, u_new = fused_iter_unfused(c.S, host, scal,
                                                   ops.apply_a, ops.prec,
                                                   layout)
                # ---- (K5) line 23: initiate the dot block, ONE reduction
                dots = ops.start(mat, u_new)
        D[E + (t % l,)] = dots
        # One ladder step per in-flight handle (identity on one device).
        for k in range(1, l):
            slot = (t - k) % l
            h0 = ring(D, slot)
            h = ops.advance(h0, k - 1)
            if h is not h0:
                D[E + (slot,)] = h

        i_next = tuple(i + 1 for i in c.i) if slab else c.i + 1
        cyc = _Cycle(S=S, G=G, D=D, gam=gam, dlt=dlt, eta_prev=eta_prev,
                     zet_prev=zet_prev, i=i_next, norm0_cycle=c.norm0_cycle)

        # ===== observable state, predicated on `active` ===================
        step = 1 if active is None else active.to(st.tot.dtype)
        upd, converged, hist, since_rr = st.upd, st.converged, st.hist, \
            st.since_rr
        rnorm = ok = None
        if do_upd is not False:
            if do_upd is True:
                inc = step
            else:
                inc = (do_upd if active is None
                       else do_upd & active).to(st.upd.dtype)
            upd = st.upd + inc
            since_rr = st.since_rr + inc
            rnorm = torch.abs(zet_new)
            # A breakdown iteration's scalars are garbage: never record or
            # converge on them.
            ok = ~breakdown if active is None else (~breakdown & active)
            if do_upd is not True:
                ok = ok & do_upd
            if slab:
                slot = upd.clamp(0, H - 1).unsqueeze(-1)
                hist.scatter_(-1, slot, torch.where(
                    ok, rnorm, hist.gather(-1, slot)[..., 0]).unsqueeze(-1))
            else:
                slot = upd.clamp(0, H - 1).view(1)
                hist.scatter_(0, slot, torch.where(ok, rnorm.view(1),
                                                   hist.gather(0, slot)))
            if governor is None:
                converged = st.converged | (ok & (rnorm / st.norm0 < tol))
            # Governed: only a replacement's true residual converges.
        if ge_l is False:
            bd = st.breakdown & ~active if active is not None else \
                torch.zeros_like(st.breakdown)
        else:
            if ge_l is not True:
                breakdown = breakdown & ge_l
            bd = breakdown if active is None else \
                torch.where(active, breakdown, st.breakdown)

        # ---- stability governor: detection arms (no extra reduction) ----
        gov, gap, code = st.gov, ZERO, ZERO
        if governor is not None and ge_l is False:
            gap = gov.select(-1, GM.GAP)        # the pipeline fill: unchanged
        elif governor is not None:
            gov, gap, code = gov_iteration(
                st.gov, scal, arrived, ge_l, ok,
                None if ok is None else rnorm / st.norm0, upd, active)
        tel = st.tel
        if cap:
            i_cols = c.i if slab else (c.i,)
            age = dev_tensor("age", [min(i + 1, l) for i in i_cols],
                             dtype).view(st.tot.shape)
            rn = MINUS_ONE if ok is None else torch.where(ok, rnorm,
                                                          MINUS_ONE)
            bd_f = ZERO if breakdown is None else breakdown.to(dtype)
            tel = tel_write(
                tel, st.tot, upd, [rn, age, bd_f, ZERO, ZERO, gap, code],
                DOTS0 if arrived is None else arrived, active)
        return _State(cyc=cyc, tot=st.tot + step, upd=upd,
                      restarts=st.restarts, converged=converged,
                      breakdown=bd, hist=hist, norm0=st.norm0,
                      since_rr=since_rr, t=t + 1, tel=tel, gov=gov)

    def do_restart(st: _State, b_=None) -> _State:
        """Restart (breakdown or due replacement) at the current clock;
        ``b_`` is the right-hand side of these columns (default ``b``)."""
        # Stagnation guard: a breakdown before the cycle's first solution
        # update re-inits with a steepest-descent step.
        cyc = restart_cycle(st.cyc.S[..., layout.x_row, :],
                            st.breakdown & (st.since_rr == 0),
                            b if b_ is None else b_, st.t)
        # A breakdown at a converged iterate is a "lucky breakdown"; a
        # governed replacement certifies convergence the same way.
        lucky = cyc.norm0_cycle / st.norm0 < tol
        gov, gap, action = st.gov, ZERO, ZERO
        if governor is not None:
            gov, action = gov_restart(st, cyc)
            gap = gov.select(-1, GM.GAP)
        tel = st.tel
        if cap:
            bd_f = st.breakdown.to(dtype)
            tel = tel_write(
                tel, st.tot, st.upd,
                [cyc.norm0_cycle,                   # TRUE residual M-norm
                 ZERO, bd_f, ONE, 1.0 - bd_f, gap, action], DOTS0)
        return _State(
            cyc=cyc, tot=st.tot + 1, upd=st.upd, restarts=st.restarts + 1,
            converged=st.converged | lucky,
            breakdown=torch.zeros_like(st.breakdown), hist=st.hist,
            norm0=st.norm0, since_rr=torch.zeros_like(st.since_rr), t=st.t,
            tel=tel, gov=gov)

    def needs_interrupt(st: _State) -> torch.Tensor:
        due = st.breakdown
        if replace_every > 0:
            due = due | (st.since_rr >= replace_every)
        if governor is not None:
            # A governor-scheduled replacement takes the same interrupt.
            due = due | (st.gov.select(-1, GM.DUE) > 0)
        return due

    def cond(st: _State) -> torch.Tensor:
        keep = ((~st.converged) & (st.tot < tot_max) & (st.upd < maxit)
                & (st.restarts <= max_restarts))
        if governor is not None:
            # Terminal stagnation stops the loop; the host ladder
            # (stability.governor) demotes l or raises.
            keep = keep & ~(st.gov.select(-1, GM.STAGNATED) > 0)
        return keep

    def init(x0: torch.Tensor, t0: int = 0, b_=None) -> _State:
        """The state at x0, its first cycle's iteration 0 at clock ``t0``;
        ``b_`` (default ``b``) is the right-hand side of x0's columns."""
        cyc0 = init_cycle(x0, b if b_ is None else b_, t0)
        norm0 = cyc0.norm0_cycle
        hist0 = torch.full(norm0.shape + (H,), -1.0, dtype=dtype,
                           device=dev)
        hist0[..., 0] = norm0
        izero = torch.zeros(norm0.shape, dtype=torch.int64, device=dev)
        return _State(
            cyc=cyc0, tot=izero, upd=izero.clone(), restarts=izero.clone(),
            converged=norm0 == 0.0,
            breakdown=torch.zeros(norm0.shape, dtype=torch.bool, device=dev),
            hist=hist0, norm0=norm0, since_rr=izero.clone(), t=t0,
            tel=(torch.full(norm0.shape + (cap + 1, TK), -1.0, dtype=dtype,
                            device=dev) if cap else None),
            gov=(GM.gov_init(dtype, dev, norm0.shape)
                 if governor is not None else None))

    def finish(final: _State, host_syncs: int = 0) -> SolveResult:
        return SolveResult(
            x=final.cyc.S[..., layout.x_row, :].clone(), iters=final.upd,
            restarts=final.restarts, converged=final.converged,
            res_history=final.hist, norm0=final.norm0,
            telemetry=(final.tel[..., :cap, :].clone() if cap else None),
            governor=final.gov,
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
    solve's (the fused superkernel takes fp64 only).  ``unroll`` is the
    number of iterations between host checks of the loop condition (one
    host synchronisation each); the result is bitwise the same for every
    ``unroll``.  ``telemetry_cap`` and ``governor``: see :func:`build`;
    ``checkpoint``: see the module docstring."""
    b = as_rhs(b, device)
    if checkpoint is not None and checkpoint.armed:
        from repro_torch.checkpoint import checkpointed_solve

        return checkpointed_solve(
            ops, b, "plcg", x0, checkpoint,
            dict(l=l, tol=tol, maxit=maxit, sigmas=sigmas,
                 max_restarts=max_restarts, replace_every=replace_every,
                 fused_iteration=fused_iteration,
                 telemetry_cap=telemetry_cap, recurrence=recurrence,
                 governor=governor, unroll=unroll))
    prog = build(ops, b, l, tol=tol, maxit=maxit, sigmas=sigmas,
                 max_restarts=max_restarts, replace_every=replace_every,
                 fused_iteration=fused_iteration, telemetry_cap=telemetry_cap,
                 recurrence=recurrence, governor=governor)
    st = prog.init(torch.zeros_like(b) if x0 is None
                   else as_tensor(x0, b.device, b.dtype))
    st, syncs = host_loop(st, prog.cond, prog.iteration, unroll,
                          prog.needs_interrupt, prog.interrupt)
    return prog.finish(st, syncs)
