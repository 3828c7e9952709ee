"""Pipeline-depth autotuner: pick (l, unroll) per problem size and worker
count (counterpart of ``repro/launch/autotune.py``, DESIGN.md §6).

The paper leaves the pipeline length as "a parameter that can be chosen
depending on the problem and hardware setup"; Cornelis et al.
(arXiv:1801.04728) and Cools & Vanroose (arXiv:1706.05988) show the
choice interacts with stability, so depth must be a measured quantity,
not a guess.  Two signal sources, combined:

* **model**: the event-driven schedule simulator (``launch.schedule_sim``)
  driven by the analytic kernel times (``launch.timing_model``) of a
  hardware profile: ``H100`` from its datasheet, or the same profile with
  the card's measured rates (:func:`recalibrate_profile`);
* **measured**: seconds an iteration of the real solver on a real backend
  (:func:`measured_runner`), which catches what the model misses.

Where the port differs from the JAX module, and why:

* **Depth.**  XLA's while-loop body completes every collective before its
  back edge, so the JAX model keeps a chain in flight only across
  ``min(l, unroll - 1)`` iterations.  The port's host loop issues in
  dataflow order whatever ``unroll`` is (``utils.trace``'s report shows l
  chains in flight at every unroll), so :func:`effective_depth` is l.  The
  two models agree for ``unroll >= l + 1``.
* **Bytes an iteration.**  :func:`measured_iteration_bytes` counts them:
  the superkernel's least bytes (``min_bytes``) on the fused path, every
  ATen operation of one late iteration on the unfused path
  (``utils.roofline.count_cost``), where the JAX module reads XLA's cost
  analysis.  The numbers are the port's own and not comparable with it.
* **Recalibration** takes the port's own measured dicts
  (:func:`recalibrate_profile`) in place of ``BENCH_*_compiled.json``, and
  refuses a number not measured on a ``cuda`` device or measured on a
  plain twin, as the JAX module refuses interpret-mode wall clocks.

Usage (model, then model and measurement)::

    from repro_torch.launch.autotune import autotune_depth, measured_runner
    from repro_torch.launch.timing_model import H100
    res = autotune_depth(n=2048 ** 2, p=1, hw=H100)
    measure = measured_runner(LocalBackend(), op, b, prec=prec,
                              sigmas_for=lambda l: shifts_for_operator(
                                  op, l, prec=prec))
    res = autotune_depth(n=op.n, p=1, hw=H100, ls=(1, 2, 3, 4),
                         unrolls=(16,), measure=measure)
    print(res.table())
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.launch.schedule_sim import iteration_time, reduction_samples
from repro_torch.launch.timing_model import (H100, HWProfile, ring_hop_time,
                                             stencil_kernel_times, tree_depth)

__all__ = ["reduction_payload_bytes", "operator_neighbor_bytes",
           "measured_iteration_bytes", "fused_iteration_bytes",
           "staged_reduction_terms", "recalibrate_profile",
           "governed_overhead", "effective_depth", "Candidate",
           "AutotuneResult", "model_iteration_time", "autotune_depth",
           "measured_runner"]


def reduction_payload_bytes(method: str, l: int, s: int = 1,
                            dsize: int = 8) -> int:
    """Bytes carried by ONE global reduction of the given method: classic
    CG reduces a single scalar per reduction, Ghysels p-CG a fused
    {gamma, delta} pair, p(l)-CG the fused 2l+1-entry dot block; a slab of
    s right-hand sides multiplies every payload by s."""
    entries = {"cg": 1, "pcg": 2}.get(method, 2 * l + 1)
    return entries * max(s, 1) * dsize


def operator_neighbor_bytes(op, n_shards: int, dsize: int = 8) -> int:
    """Per-iteration point-to-point halo traffic of one shard: a stencil
    ships one boundary plane per direction, a ``SparseOp`` its partition
    plan's send sets (``PartitionPlan.neighbor_bytes``)."""
    from repro_torch.linalg import (DiagonalOp, SparseOp, Stencil2D5,
                                    Stencil3D7, Stencil3D27, plan_for)

    if isinstance(op, SparseOp):
        return plan_for(op, n_shards).neighbor_bytes(dsize)
    if isinstance(op, DiagonalOp):
        return 0
    if isinstance(op, Stencil2D5):
        return 2 * op.ny * dsize
    if isinstance(op, (Stencil3D7, Stencil3D27)):
        return 2 * op.ny * op.nz * dsize
    n_loc = op.n / max(n_shards, 1)
    return int(2 * n_loc ** (2 / 3)) * dsize    # generic surface/volume


def measured_iteration_bytes(op, l: int, prec=None, sigmas=None,
                             fused: bool = False, dtype=torch.float64
                             ) -> float:
    """Bytes ONE late p(l)-CG iteration moves on one device, counted.

    ``fused``: the superkernel's least bytes (``fused_iter.min_bytes`` of
    a late index vector: each slab row it reads or writes once, the
    preconditioner, the operator's own data), the number every bound of
    the superkernel in PERF.md uses.  Unfused: the bytes every ATen
    operation of one late iteration (scalar phase and vector phase, one
    PyTorch operation a pass) reads and writes, counted by
    ``utils.roofline.count_cost`` on ``op``'s device.  Not comparable
    with the JAX module's XLA cost analysis."""
    from repro_torch.core import pipelined_cg
    from repro_torch.core.types import SolverOps
    from repro_torch.kernels import fused_iter as fi
    from repro_torch.kernels.ops import fused_iteration_factory
    from repro_torch.linalg import DiagonalOp
    from repro_torch.utils.roofline import count_cost

    layout = fi.SlabLayout(l=l, RB=max(l + 1, 3))
    if fused:
        fiter = fused_iteration_factory(op, prec)(layout)
        return float(fi.min_bytes(
            layout, fi.host_idx(layout, 3 * l + 3), op.n,
            has_prec=prec is not None, has_diag=isinstance(op, DiagonalOp),
            dsize=torch.empty((), dtype=dtype).element_size(),
            operand_bytes=fiter.spmv.operand_bytes))
    dev = getattr(op, "device", None) or "cpu"
    b = torch.ones((op.n,), dtype=dtype, device=dev)
    prog = pipelined_cg.build(SolverOps.local(op, prec), b, l, tol=0.0,
                              maxit=4 * l + 8, sigmas=sigmas)
    st = prog.init(torch.zeros_like(b))
    for _ in range(3 * l + 3):
        st = prog.iteration(st)
    return float(count_cost(prog.iteration, st)[1]["bytes accessed"])


def fused_iteration_bytes(n: int, l: int, dsize: int = 8,
                          extra_bytes: int = 0) -> int:
    """The JAX package's modeled bytes of one fused iteration (its
    ``custom_call_hbm_bytes``: the slab once in and once out, the resident
    SPMV operand, the O(l) bundles); ``extra_bytes`` adds operator-side
    operands.  ``measured_iteration_bytes(fused=True)`` is the port's own,
    tighter count."""
    from repro_torch.kernels.fused_iter import (SlabLayout,
                                                custom_call_hbm_bytes)

    layout = SlabLayout(l=l, RB=max(l + 1, 3))
    return custom_call_hbm_bytes(layout, n, dsize=dsize,
                                 extra_bytes=extra_bytes)


def staged_reduction_terms(hw: HWProfile, p: int, l: int, stages: int,
                           payload: int) -> dict:
    """Per-iteration cost pieces of the staged ring ladder
    (``parallel.reduction``, DESIGN.md §14): ``t_hop`` (one hop),
    ``t_advance_burst`` (the hop chain one advance step adds to the body:
    ceil((P-1)/stages) hops), ``t_wait_stall`` (the steps the pipeline
    could not advance, max(0, stages - (l-1)), run at the wait) and
    ``fill_iters`` (iterations from issue until the ladder can have
    completed)."""
    n_hops = max(p - 1, 0)
    stages = max(1, min(stages, max(n_hops, 1)))
    t_hop = ring_hop_time(hw, payload)
    group_hops = -(-n_hops // stages) if n_hops else 0     # ceil division
    advance_steps = min(stages, max(l - 1, 0))
    wait_steps = stages - advance_steps
    return {
        "t_hop": t_hop,
        "n_hops": n_hops,
        "group_hops": group_hops,
        "advance_steps": advance_steps,
        "t_advance_burst": group_hops * t_hop,
        "t_advance_total": advance_steps * group_hops * t_hop,
        "t_wait_stall": wait_steps * group_hops * t_hop,
        "fill_iters": stages + 1,
    }


def recalibrate_profile(
    hw: HWProfile,
    iter_payload: dict | None = None,
    spmv_payload: dict | None = None,
    reduce_payload: dict | None = None,
) -> HWProfile:
    """Replace an :class:`HWProfile`'s stream and latency terms with
    numbers measured on the card:

    * ``iter_payload`` ``{"device", "kernel", "bytes", "seconds"}`` ->
      ``mem_bw``: the superkernel's bytes a launch over its device time;
    * ``spmv_payload`` ``{"device", "kernel", "nnz", "seconds"}`` ->
      ``flop_rate``: 2 nnz over the ELL kernel's device time (the
      gather-bound rate reached);
    * ``reduce_payload`` ``{"device", "kernel", "payload_bytes",
      "allreduce_s"[, "hop_s"][, "devices"]}`` -> ``alpha`` (and
      ``alpha_hop``), the payload's wire term backed out so that the model
      gives the measurement back.

    Each payload must name ``"device": "cuda"`` and must not be a plain
    twin's (``"plain": True``): a CPU or plain-PyTorch time never
    recalibrates the card's profile (``ValueError``), as the JAX module
    refuses interpret-mode payloads.  Fields without a payload keep their
    values; the result is renamed ``<name>+measured``."""

    def usable(payload, name):
        if payload is None:
            return None
        if payload.get("device") != "cuda":
            raise ValueError(
                f"{name} payload was measured on device="
                f"{payload.get('device')!r}, not on a card: a CPU time "
                "never recalibrates the card's profile")
        if payload.get("plain"):
            raise ValueError(
                f"{name} payload times the plain PyTorch twin of "
                f"{payload.get('kernel', 'the kernel')!r}, not the kernel")
        return payload

    updates: dict = {}
    it = usable(iter_payload, "iteration")
    if it is not None:
        updates["mem_bw"] = it["bytes"] / it["seconds"]
    sp = usable(spmv_payload, "spmv")
    if sp is not None:
        updates["flop_rate"] = 2.0 * sp["nnz"] / sp["seconds"]
    rd = usable(reduce_payload, "reduction")
    if rd is not None:
        wire = rd.get("payload_bytes", 0) / hw.link_bw
        if rd.get("hop_s") is not None:
            updates["alpha_hop"] = max(rd["hop_s"] - wire, 1e-9)
        depth = tree_depth(hw, rd.get("devices", 1))
        updates["alpha"] = max((rd["allreduce_s"] - wire) / max(depth, 1),
                               1e-9)
    if not updates:
        return hw
    return dataclasses.replace(hw, name=f"{hw.name}+measured", **updates)


def governed_overhead(l: int, stages: int | None = None,
                      replace_period: int = 256) -> float:
    """Multiplicative per-iteration factor a GOVERNED solve pays at depth
    l (DESIGN.md §18): each replacement re-enters the pipeline fill (l + 1
    iterations, plus the staged ladder's stages + 1), and the replacement
    period shrinks first-order as ``replace_period / l``
    (arXiv:1804.02962), so the factor is 1 + refill / period(l)."""
    refill = (l + 1) + (stages + 1 if stages else 0)
    period = max(replace_period / max(l, 1), 1.0)
    return 1.0 + refill / period


def effective_depth(l: int, unroll: int) -> int:
    """Reductions the port keeps in flight at depth l: l, whatever
    ``unroll`` is.  The host loop issues every iteration's start after its
    wait in dataflow order, and an ``unroll`` window only spaces the host's
    reads of ``cond`` (``utils.trace.plcg_overlap_report`` measures the l).
    The JAX module's XLA depth is ``min(l, unroll - 1)``."""
    del unroll
    return max(l, 0)


@dataclasses.dataclass(frozen=True)
class Candidate:
    method: str
    l: int
    unroll: int
    model_s: float                 # modeled seconds / iteration
    measured_s: float | None = None  # measured seconds / iteration
    # Reduction wiring: "monolithic", or "staged" with this many stages.
    reduction: str = "monolithic"
    stages: int | None = None

    @property
    def score(self) -> float:
        return self.model_s if self.measured_s is None else self.measured_s


@dataclasses.dataclass
class AutotuneResult:
    best: Candidate
    candidates: list[Candidate]
    n: int
    p: int
    hw_name: str

    def table(self) -> str:
        hdr = (f"autotune: n={self.n:,} unknowns, p={self.p} workers, "
               f"{self.hw_name}")
        rows = [hdr, f"{'method':>10s} {'l':>3s} {'unroll':>6s} "
                     f"{'red':>6s} {'stg':>3s} "
                     f"{'model/us':>9s} {'meas/us':>9s}"]
        for c in sorted(self.candidates, key=lambda c: c.score):
            meas = f"{c.measured_s * 1e6:9.1f}" if c.measured_s is not None \
                else f"{'-':>9s}"
            star = " *" if c == self.best else ""
            red = "staged" if c.reduction == "staged" else "mono"
            stg = f"{c.stages:3d}" if c.stages is not None else "  -"
            rows.append(f"{c.method:>10s} {c.l:>3d} {c.unroll:>6d} "
                        f"{red:>6s} {stg} "
                        f"{c.model_s * 1e6:9.1f} {meas}{star}")
        return "\n".join(rows)


def model_iteration_time(
    hw: HWProfile,
    n: int,
    p: int,
    method: str,
    l: int = 0,
    unroll: int = 1,
    stencil_pts: int = 5,
    jitter: float = 0.15,
    prec_factor: float = 1.0,
    s: int = 1,
    dsize: int = 8,
    neighbor_bytes: int | None = None,
    iteration_bytes: float | None = None,
    reduction: str = "monolithic",
    stages: int | None = None,
) -> float:
    """Modeled seconds per (slab) iteration at the port's depth
    (:func:`effective_depth`), the JAX model's terms otherwise:

    * ``reduction="staged"`` (p(l)-CG): the hop-per-iteration ladder of
      DESIGN.md §14 (:func:`staged_reduction_terms`) in place of the
      monolithic ``alpha * tree_depth + payload / link_bw`` term;
    * ``iteration_bytes`` (p(l)-CG): the SPMV stream and 2l+3 AXPY passes
      scaled so that their total equals ``iteration_bytes / mem_bw``
      (:func:`measured_iteration_bytes`), halo and reduction terms kept;
    * ``s``: a slab of s columns streams s times the local work and
      carries the (2l+1) s payload in one reduction, whose latency it
      shares;
    * ``neighbor_bytes``: a shard's halo traffic, on the SPMV term."""
    halo_elems = None if neighbor_bytes is None \
        else max(neighbor_bytes // (2 * dsize), 0)
    k = stencil_kernel_times(
        hw, n, p, stencil_pts=stencil_pts, prec_factor=prec_factor,
        halo_elems=halo_elems,
        glred_payload=reduction_payload_bytes(method, l, s, dsize))
    if iteration_bytes is not None and method == "plcg":
        model_stream = k["spmv_stream"] + (2 * l + 3) * k["axpy1"]
        scale = (iteration_bytes / hw.mem_bw) / max(model_stream, 1e-30)
        k = {**k,
             "axpy1": k["axpy1"] * scale,
             "spmv": k["spmv_comm"] + k["spmv_stream"] * scale,
             "spmv_stream": k["spmv_stream"] * scale}
    if s > 1:
        k = {**k, "spmv": k["spmv"] * s, "axpy1": k["axpy1"] * s}
    if method != "plcg":
        return iteration_time(method, 0, k, jitter=jitter)
    if reduction == "staged":
        st = staged_reduction_terms(
            hw, p, l, stages if stages is not None else max(l - 1, 1),
            payload=reduction_payload_bytes(method, l, s, dsize))
        body = k["spmv"] + (2 * l + 3) * k["axpy1"]
        if jitter <= 0:
            return max(body, st["t_advance_burst"]) + st["t_wait_stall"]
        # The monolithic simulator's mean-preserving noise on the ladder's
        # bursts and stalls, so that staged candidates win no ties by
        # being scored without noise.
        rng = np.random.default_rng(0)
        bursts = reduction_samples(200, st["t_advance_burst"], jitter, rng)
        stalls = reduction_samples(200, st["t_wait_stall"], jitter, rng)
        return float(np.mean(np.maximum(body, bursts) + stalls))
    l_eff = effective_depth(l, unroll)
    if l_eff == 0:
        return k["spmv"] + (2 * l + 3) * k["axpy1"] + k["glred"]
    return iteration_time("plcg", l_eff, k, jitter=jitter, body_l=l)


def autotune_depth(
    n: int,
    p: int,
    hw: HWProfile | None = None,
    ls: tuple[int, ...] = (1, 2, 3, 5),
    unrolls: tuple[int, ...] | None = None,
    stencil_pts: int = 5,
    jitter: float = 0.15,
    prec_factor: float = 1.0,
    include_baselines: bool = True,
    measure: Callable[[str, int, int], float] | None = None,
    s: int = 1,
    neighbor_bytes: int | None = None,
    iteration_bytes: Callable[[int], float] | float | None = None,
    reduction: str = "monolithic",
    stages_grid: tuple[int, ...] | None = None,
    governed: bool = False,
    replace_period: int = 256,
) -> AutotuneResult:
    """Sweep (l, unroll), and with ``reduction="staged"`` or ``"both"`` the
    ladder's stage count, and pick the fastest candidate: by measured time
    where ``measure(method, l, unroll) -> s/iter`` gives one (monolithic
    candidates), by modeled time otherwise.  ``hw`` defaults to ``H100``.
    ``iteration_bytes`` is a float or a callable ``l -> bytes``;
    ``governed`` multiplies p(l)-CG candidates by
    :func:`governed_overhead`.  The arguments are the JAX module's."""
    if reduction not in ("monolithic", "staged", "both"):
        raise ValueError(f"unknown reduction sweep {reduction!r}")
    if hw is None:
        hw = H100
    cands: list[Candidate] = []

    def add(method, l, unroll, red="monolithic", stages=None):
        ib = None
        if method == "plcg" and iteration_bytes is not None:
            ib = iteration_bytes(l) if callable(iteration_bytes) \
                else iteration_bytes
        mdl = model_iteration_time(hw, n, p, method, l, unroll,
                                   stencil_pts=stencil_pts, jitter=jitter,
                                   prec_factor=prec_factor, s=s,
                                   neighbor_bytes=neighbor_bytes,
                                   iteration_bytes=ib,
                                   reduction=red, stages=stages)
        if governed and method == "plcg":
            mdl *= governed_overhead(
                l, stages if red == "staged" else None, replace_period)
        meas = measure(method, l, unroll) \
            if measure is not None and red == "monolithic" else None
        cands.append(Candidate(method, l, unroll, mdl, meas,
                               reduction=red, stages=stages))

    if include_baselines:
        add("cg", 0, 1)
        add("pcg", 0, 1)
    for l in ls:
        if reduction in ("monolithic", "both"):
            for u in (unrolls if unrolls is not None else (1, l + 1)):
                add("plcg", l, u)
        if reduction in ("staged", "both"):
            grid = stages_grid if stages_grid is not None \
                else tuple(sorted({1, 2, max(l - 1, 1), l}))
            for st in grid:
                add("plcg", l, l + 1, red="staged",
                    stages=max(1, min(st, max(p - 1, 1))))

    best = min(cands, key=lambda c: c.score)
    return AutotuneResult(best=best, candidates=cands, n=n, p=p,
                          hw_name=hw.name)


def measured_runner(
    backend,
    op,
    b,
    sigmas_for: Callable[[int], object] | None = None,
    prec=None,
    iters: tuple[int, int] = (20, 60),
    repeats: int = 3,
    plcg_kwargs: dict | None = None,
) -> Callable[[str, int, int], float]:
    """Seconds an iteration of the real solver on ``backend``.

    Each configuration is a ``backend.make_solver`` callable, run once to
    warm up; the solver then runs at two iteration budgets (``tol=0``:
    no early exit), the difference removing the constant set-up, the
    least over ``repeats`` suppressing noise.  On a card each run ends in
    ``torch.cuda.synchronize()``.  ``plcg_kwargs`` go to p(l)-CG only
    (for example ``fused_iteration=True``)."""
    lo, hi = iters
    assert hi > lo

    def sync(x):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)

    def time_solve(method, l, unroll, maxit) -> float:
        kw = dict(tol=0.0, maxit=maxit, unroll=unroll)
        if method == "plcg":
            kw.update(l=l, **(plcg_kwargs or {}))
            if sigmas_for is not None:
                kw.update(sigmas=sigmas_for(l))
        solver = backend.make_solver(op, method, prec, **kw)
        sync(solver(b).x)                            # warm-up
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            sync(solver(b).x)
            best = min(best, time.perf_counter() - t0)
        return best

    def measure(method: str, l: int, unroll: int) -> float:
        t_lo = time_solve(method, l, unroll, lo)
        t_hi = time_solve(method, l, unroll, hi)
        if t_hi <= t_lo:
            # Noise swallowed the budget difference: the larger run's
            # time an iteration (set-up included) is never a free win.
            return t_hi / hi
        return (t_hi - t_lo) / (hi - lo)

    return measure
