"""Batched multi-RHS solvers, the amortized-reduction layer: counterpart of
``repro/core/batched.py``.

Solving s right-hand sides against one operator in lock step turns each
iteration's dot block into ONE (s, K) payload reduced in one start (the
JAX package's vmapped (K, s) payload, one row a column here), s times the
work per reduction latency without any extra synchronisation.

The JAX package gets the slab by ``jax.vmap`` over per-column programs.
The port has no vmap: the three solvers' own programs (``BUILDERS``, the
builders of the sequential path) take a slab ``B`` of shape (s, n), one
request a row (the transpose of the JAX package's (n, s) ``B``), and run
every column with the arithmetic of its sequential program:

* CG and p-CG carry each scalar as an (s,) tensor and each vector as an
  (s, n) slab; p-CG's first-iteration branch is a per-column mask where
  the columns started at different times.
* p(l)-CG makes its structural branches on the host from each column's
  cycle index ``i``.  Its windows turn with the program's own clock (the
  slab's iteration count), so one ring position serves every column; the
  scalar phase runs once per group of columns that share the host
  decisions of their ``i`` (one group once every column is past its
  pipeline fill), on (s_g,)-stacked tensors with the sequential code's
  elementwise operations; the vector phase is one superkernel launch
  (``fused_iteration=True``) or one unfused pass over the slab, with the
  (s, IX) index table holding each column's own index vector; and ONE
  start takes the s columns' dot blocks.

A column whose loop stops (converged, out of iterations) or that pauses
at ``needs_interrupt`` (a breakdown, a due residual replacement) goes on
iterating predicated on its ``active`` flag: its observable state and its
x row stay bitwise as they were.  Its interrupt runs at the next host
check (a chunk boundary) on the columns that are due, as the JAX
package's ``_masked_interrupt``/``_col_cond`` do, with the same
per-column arithmetic and restart schedule as the sequential path.

Two entry points, as in the JAX package:

``solve_batched(ops, B, method, **kw)``
    every column to completion; a ``SolveResult`` whose tensors carry a
    leading s axis.  A zero column has norm0 == 0 and retires at
    iteration 0: padding a partial slab with zeros is exact.

``slab_program(ops, s, n, method, kw, chunk_iters)``
    the chunked serving interface (init / chunk / inject / status /
    extract over an explicit slab state, ``chunk_iters`` iterations a
    chunk) that ``repro_torch.serve`` drives; backends build it through
    ``make_slab_program``.  The program is built once and reused across
    injects (the port's counterpart of "no recompile").
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import classic_cg, ghysels_pcg, pipelined_cg
from repro_torch.core.types import SolveResult, SolverOps, host_tensor

# The sequential solvers' program builders: the batched layer shares THE
# solver arithmetic with the sequential path (same keys as
# repro_torch.core.METHODS).
BUILDERS: dict[str, Callable] = {
    "cg": classic_cg.build,
    "pcg": ghysels_pcg.build,
    "plcg": pipelined_cg.build,
}

def vector_mask(method: str):
    """The state of ``method``'s program with each leaf replaced by a
    bool: True for the leaves whose TRAILING axis is the vector axis n,
    the ones a row partition splits over the ranks (each rank holds its
    block of rows of them); False for the windows, scalars, histories,
    the telemetry ring and the governor vector, which every rank holds
    bit for bit (the JAX package's ``vector_mask``, whose leaves shard
    under ``shard_map``; the port's program clocks ``i``, ``k`` and ``t``
    are host values, the same on every rank).  :func:`split_state` uses
    it."""
    if method == "cg":
        return classic_cg.CgState(
            x=True, r=True, u=True, p=True,
            gamma=False, it=False, conv=False, hist=False)
    if method == "pcg":
        return ghysels_pcg.PcgState(
            S=True, gamma=False, alpha=False, it=False, conv=False,
            hist=False, since_rr=False, k=False)
    if method == "plcg":
        cyc = pipelined_cg._Cycle(
            S=True, G=False, D=False, gam=False, dlt=False,
            eta_prev=False, zet_prev=False, i=False, norm0_cycle=False)
        return pipelined_cg._State(
            cyc=cyc, tot=False, upd=False, restarts=False, converged=False,
            breakdown=False, hist=False, norm0=False, since_rr=False,
            t=False, tel=False, gov=False)
    raise KeyError(method)


def split_state(st, method: str) -> tuple[list, list]:
    """(vector leaves, replicated leaves) of a program state, in leaf
    order, by :func:`vector_mask`: over ranks the first are each rank's
    rows, the second the same on every rank (None leaves dropped).
    p(l)-CG's D ring is left out of both: its in-flight slots hold each
    rank's own partials (or the all-reduce's token) until they arrive."""
    vec, rep = [], []

    def walk(v, m):
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            for name, a, b in zip(v._fields, v, m):
                if not (name == "D" and isinstance(v, pipelined_cg._Cycle)):
                    walk(a, b)
        elif v is not None:
            (vec if m else rep).append(v)

    walk(st, vector_mask(method))
    return vec, rep


class SlabStatus(NamedTuple):
    """Cheap per-chunk slab view, one entry a column."""

    running: torch.Tensor      # (s,) bool: the column's loop cond holds
    converged: torch.Tensor    # (s,) bool
    iters: torch.Tensor        # (s,) solution updates so far


class SlabProgram(NamedTuple):
    """Slab-solver handles for the serving layer (built once per slab key
    by a backend's ``make_slab_program``).  Every callable takes the (s, n)
    right-hand sides ``B`` and a state of fixed shapes, so the serve life
    cycle (init -> [chunk -> retire -> inject]* -> extract) never rebuilds
    anything, whatever requests flow through the slots."""

    method: str
    s: int
    n: int
    chunk_iters: int
    init: Callable[[torch.Tensor], Any]                         # B -> st
    chunk: Callable[[torch.Tensor, Any], Any]                   # (B, st)
    inject: Callable[[torch.Tensor, Any, Any], Any]             # (B, st, m)
    status: Callable[[torch.Tensor, Any], SlabStatus]
    extract: Callable[[torch.Tensor, Any], SolveResult]


def _program_kw(method: str, kw: dict) -> tuple[dict, int]:
    """The program builder's keyword arguments and the host-check period
    (``unroll``) from a solve's keyword arguments."""
    if method not in BUILDERS:
        raise KeyError(f"unknown method {method!r}; "
                       f"available: {', '.join(BUILDERS)}")
    kw = dict(kw)
    unroll = int(kw.pop("unroll", 1))
    if unroll < 1:
        raise ValueError("unroll must be >= 1")
    return kw, unroll


class _Slab:
    """One method's slab program over s columns: the per-column state
    operations (take, put, init, interrupt) and the host-checked loop."""

    def __init__(self, ops: SolverOps, B: torch.Tensor, method: str,
                 kw: dict):
        self.method = method
        self.prog = BUILDERS[method](ops, B, **kw)
        self.step = (self.prog.iteration if method == "plcg"
                     else self.prog.step)
        self.device = B.device
        self.syncs = 0
        self._idx: dict[tuple, torch.Tensor] = {}

    # -------------------------------------------------- column subsets --
    def _cols(self, cols: list[int]) -> torch.Tensor:
        key = tuple(cols)
        t = self._idx.get(key)
        if t is None:
            t = self._idx[key] = host_tensor(list(cols), torch.long,
                                             self.device)
        return t

    def take(self, st, cols: list[int]):
        """The state of columns ``cols`` (a slab of len(cols))."""
        gi = self._cols(cols)

        def sel(v):
            if isinstance(v, tuple) and hasattr(v, "_fields"):
                return type(v)(*(sel(f) for f in v))
            if isinstance(v, torch.Tensor):
                return v.index_select(0, gi)
            if isinstance(v, tuple):           # per-column host values
                return tuple(v[c] for c in cols)
            return v                           # the slab's own clock

        return sel(st)

    def put(self, st, cols: list[int], sub):
        """``st`` with columns ``cols`` replaced by ``sub``; every other
        column bitwise as it was.  Out of place: a state may hold one
        tensor under two names."""
        gi = self._cols(cols)

        def put_(v, w):
            if isinstance(v, tuple) and hasattr(v, "_fields"):
                return type(v)(*(put_(a, b) for a, b in zip(v, w)))
            if isinstance(v, torch.Tensor):
                return v.index_copy(0, gi, w)
            if isinstance(v, tuple):
                out = list(v)
                for c, x in zip(cols, w):
                    out[c] = x
                return tuple(out)
            return v

        return put_(st, sub)

    def _one(self, c: int, b_: torch.Tensor):
        return b_.index_select(0, self._cols([c]))

    def init_cols(self, st, B: torch.Tensor, cols: list[int]):
        """``st`` with columns ``cols`` re-initialized from rows ``cols`` of
        B (``st`` None: a fresh slab of every row), their first iteration
        at the slab's clock (a p(l)-CG column's host cycle index restarts
        at 0).  Column by column: an init's dot products then reduce one
        column's rows, as in the sequential program (on the card the
        order of torch's sum depends on how many rows it reduces)."""
        if not cols:
            return st
        t0 = 0 if st is None else getattr(st, "t", 0)
        kw = dict(t0=t0) if self.method == "plcg" else {}
        subs = []
        for c in cols:
            b_ = self._one(c, B)
            subs.append(self.prog.init(torch.zeros_like(b_), b_=b_, **kw))
        sub = _cat(subs)
        return sub if st is None else self.put(st, cols, sub)

    def interrupt(self, st, B: torch.Tensor, cols: list[int]):
        """The program's interrupt (restart / replacement) on columns
        ``cols`` only, column by column (as ``init_cols``)."""
        subs = [self.prog.interrupt(self.take(st, [c]), b_=self._one(c, B))
                for c in cols]
        return self.put(st, cols, _cat(subs))

    # ------------------------------------------------------ host loop --
    def flags(self, st) -> tuple[list[bool], list[bool]]:
        """(keep, due) per column, read to the host: one synchronisation."""
        self.syncs += 1
        p = self.prog
        if p.needs_interrupt is None:
            keep = p.cond(st).tolist()
            return keep, [False] * len(keep)
        keep, due = torch.stack([p.cond(st), p.needs_interrupt(st)]).tolist()
        return keep, due

    def active(self, st) -> torch.Tensor:
        """Per column, on the device: the loop goes on and no interrupt
        is due."""
        p = self.prog
        a = p.cond(st)
        if p.needs_interrupt is not None:
            a = a & ~p.needs_interrupt(st)
        return a

    def run(self, st, n_iters: int):
        """``n_iters`` predicated slab iterations, no host read."""
        for _ in range(n_iters):
            st = self.step(st, self.active(st))
        return st


def _cat(states: list):
    """One-column states side by side: the slab state of their columns."""
    first = states[0]
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_cat(list(f)) for f in zip(*states)))
    if isinstance(first, torch.Tensor):
        return torch.cat(states)
    if isinstance(first, tuple):               # per-column host values
        return sum(states, ())
    return first                               # the slab's own clock


def solve_batched(ops: SolverOps, B: torch.Tensor, method: str = "plcg",
                  **kw) -> SolveResult:
    """Solve A X = B for all s rows of B (s, n) in lock step.

    Each iteration issues ONE start of the (s, K) dot-block payload
    (K = 2l+1 for p(l)-CG; classic CG's two blocking dots are two starts)
    and, fused, one superkernel launch, whatever s is.  ``unroll`` slab
    iterations run between host checks; at a check the columns that are
    due (a breakdown, a due replacement) get their interrupt.  Tensors of
    the result carry a leading s axis; column j reproduces the sequential
    ``METHODS[method](ops, B[j], kw)`` (its iteration count exactly, its
    history to rounding: tests/test_torch_batched.py)."""
    if B.dim() != 2:
        raise ValueError(f"B must be (s, n), got {tuple(B.shape)}")
    pkw, unroll = _program_kw(method, kw)
    slab = _Slab(ops, B, method, pkw)
    st = slab.init_cols(None, B, list(range(B.shape[0])))
    while True:
        keep, due = slab.flags(st)
        if not any(keep):
            break
        cols = [c for c, (k, d) in enumerate(zip(keep, due)) if k and d]
        if cols:
            st = slab.interrupt(st, B, cols)
            continue
        st = slab.run(st, unroll)
    return slab.prog.finish(st, slab.syncs)


def _host_mask(mask, s: int) -> list[int]:
    if isinstance(mask, torch.Tensor):
        mask = mask.tolist()
    m = np.asarray(mask, dtype=bool).reshape(-1)
    if m.shape != (s,):
        raise ValueError(f"refresh mask of shape {m.shape}, want ({s},)")
    return [int(c) for c in np.flatnonzero(m)]


def slab_program(ops: SolverOps, s: int, n: int, method: str, kw: dict,
                 chunk_iters: int = 16) -> SlabProgram:
    """The chunked slab life cycle over ``ops`` for s columns of length n.

    ``chunk`` runs at most ``chunk_iters`` slab iterations (in windows of
    ``unroll``, default 16, with one host check before each: a chunk ends
    early once no column is active), then the interrupts of the columns
    that are due, as the JAX package's chunk does at its segment
    boundary.  ``inject`` re-initializes the columns flagged in its (s,)
    mask from the current rows of ``B`` and leaves every other column
    bitwise as it was."""
    if chunk_iters < 1:
        raise ValueError("chunk_iters must be >= 1")
    pkw, unroll = _program_kw(method, {"unroll": 16, **kw})
    window = min(unroll, chunk_iters)
    holder: dict[str, _Slab] = {}

    def slab_for(B: torch.Tensor) -> _Slab:
        if tuple(B.shape) != (s, n):
            raise ValueError(f"B of shape {tuple(B.shape)}, want ({s}, {n})")
        if "slab" not in holder:
            holder["slab"] = _Slab(ops, B, method, pkw)
        return holder["slab"]

    def init(B):
        sl = slab_for(B)
        return sl.init_cols(None, B, list(range(s)))

    def chunk(B, st):
        sl = slab_for(B)
        done = 0
        while done < chunk_iters:
            keep, due = sl.flags(st)
            if not any(k and not d for k, d in zip(keep, due)):
                break
            w = min(window, chunk_iters - done)
            st = sl.run(st, w)
            done += w
        keep, due = sl.flags(st)
        cols = [c for c, (k, d) in enumerate(zip(keep, due)) if k and d]
        return sl.interrupt(st, B, cols) if cols else st

    def inject(B, st, mask):
        return slab_for(B).init_cols(st, B, _host_mask(mask, s))

    def status(B, st):
        sl = slab_for(B)
        res = sl.prog.finish(st)
        return SlabStatus(running=sl.prog.cond(st), converged=res.converged,
                          iters=res.iters)

    def extract(B, st):
        sl = slab_for(B)
        return sl.prog.finish(st, sl.syncs)

    return SlabProgram(method=method, s=s, n=n, chunk_iters=chunk_iters,
                       init=init, chunk=chunk, inject=inject, status=status,
                       extract=extract)


# --------------------------------------------------------------------------
# Multi-slab step hooks.  The continuous-batching scheduler
# (repro_torch.serve.scheduler) runs several slabs a tick; these keep the
# cross-slab concerns next to the slab machinery they measure.
# --------------------------------------------------------------------------

def dispatch_slab_chunks(slabs) -> list:
    """Run the chunk of every slab before polling any of them.

    ``slabs`` yields ``(program, B, state)`` triples; returns the new
    states in order.  Each chunk's kernels are queued on the stream, and
    its host checks read only its own slab, so the scheduler ticks in
    three phases (pack all / chunk all / poll all) and no slab's status
    read sits between two neighbours' chunks.  Each slab still reduces
    its own dot block as ONE (s, K) start an iteration."""
    return [prog.chunk(B, st) for prog, B, st in slabs]


def slab_slot_iterations(iters_before, iters_after) -> int:
    """Occupied-slot-iterations advanced between two status polls: the sum
    of the columns' solution-update deltas (free and zero-padded slots and
    frozen columns add 0), the numerator of slot utilization against
    ``s * chunk_iters`` a chunk."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    return int(np.sum(host(iters_after) - host(iters_before)))
