"""Open-loop traffic replay harness (counterpart of
``repro/serve/replay.py``, DESIGN.md §15).

Closed-loop benchmarking (submit a batch, drain, time it) measures a
system that never experiences queueing: the load adapts to the service.
Real traffic is *open-loop* — arrivals happen on their own schedule
whether or not the service keeps up — and that is the regime where
continuous batching, admission control and load shedding earn their
keep.  This module generates seeded open-loop traces and replays them
against a :class:`~repro_torch.serve.service.SolverService` on a virtual
clock, so the resulting goodput / latency-percentile / utilization
numbers are exact deterministic arithmetic (CI-gateable, zero timing
flake) rather than wall-clock measurements.

* **Arrival process** — Poisson: exponential inter-arrival gaps at a
  configured rate, from a seeded ``numpy`` Generator.
* **Solve-size mix** — heavy-tailed over :class:`TrafficClass` entries
  (operator × tolerance × deadline, with a weight).  A tolerance is a
  slab-key ingredient, so a loose-tol/tight-tol mix both spreads solve
  *cost* over orders of magnitude (few iterations vs many) and
  exercises the multi-slab scheduler with genuinely distinct slabs.
* **Virtual time** — the replay loop models the cost of a scheduler
  tick as ``tick_overhead_s + iter_time_s * chunk_iters * slabs_run``
  and advances the service's clock by exactly that; between due
  arrivals with an idle service it jumps straight to the next arrival.
  Under a :class:`~repro_torch.serve.clock.SystemClock` the same loop really
  sleeps, so the harness doubles as a live traffic generator.

The :class:`ReplayReport` carries the determinism witnesses —
retirement log, steal log, shed ids — plus the SLO economics: goodput
(SLO-met solves per second of virtual time), p50/p99 latency, and slab
slot-utilization (occupied-slot-iterations / capacity), the metric that
separates continuous injection from drain-to-empty serving
(BENCH_serve.json gates all three).
"""

from __future__ import annotations

import dataclasses
from typing import Hashable

import numpy as np

from repro_torch.serve.errors import AdmissionRejected
from repro_torch.serve.service import SolverService


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One request population in the mix: operator + tolerance (the slab
    key) + SLO deadline, drawn with probability proportional to
    ``weight``."""

    op_key: Hashable
    n: int                             # RHS length (operator size)
    weight: float = 1.0
    tol: float = 1e-8
    deadline_s: float | None = None


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One traced request: arrives at absolute time ``t``."""

    t: float
    op_key: Hashable
    b: np.ndarray
    tol: float
    deadline_s: float | None


def poisson_trace(classes: list[TrafficClass], rate_per_s: float,
                  n_requests: int, seed: int) -> list[Arrival]:
    """Seeded open-loop trace: Poisson arrivals at ``rate_per_s``, each
    request drawn from the heavy-tail class mix, RHS columns standard
    normal.  Same seed -> bitwise-identical trace."""
    if rate_per_s <= 0:
        raise ValueError(f"rate_per_s must be > 0 ({rate_per_s})")
    if not classes:
        raise ValueError("need at least one TrafficClass")
    rng = np.random.default_rng(seed)
    w = np.asarray([c.weight for c in classes], dtype=float)
    if (w <= 0).any():
        raise ValueError("class weights must be > 0")
    p = w / w.sum()
    out: list[Arrival] = []
    t = 0.0
    for _ in range(n_requests):
        t += rng.exponential(1.0 / rate_per_s)
        c = classes[int(rng.choice(len(classes), p=p))]
        out.append(Arrival(t=t, op_key=c.op_key,
                           b=rng.standard_normal(c.n), tol=c.tol,
                           deadline_s=c.deadline_s))
    return out


@dataclasses.dataclass
class ReplayReport:
    """Outcome of one open-loop replay (all times in the service
    clock's frame — virtual seconds under a VirtualClock)."""

    n_arrivals: int
    n_retired: int
    n_converged: int
    n_slo_met: int
    n_shed: int
    n_rejected: int
    makespan_s: float                  # first arrival -> last retirement
    offered_per_s: float               # arrival rate actually traced
    goodput_per_s: float               # SLO-met solves / makespan
    latency_p50_s: float
    latency_p99_s: float
    slot_utilization: float
    ticks: int
    chunks_run: int
    # Determinism witnesses: bitwise-comparable across replays.
    retirement_log: list[tuple[int, int, int, float]]
    steal_log: list[tuple]
    shed_ids: list[int]
    rejected_arrivals: list[int]       # indices into the trace

    def metrics(self) -> dict:
        """Flat JSON-able metric dict (for BENCH_serve.json gates)."""
        return {
            "replay_arrivals": self.n_arrivals,
            "replay_retired": self.n_retired,
            "replay_converged": self.n_converged,
            "replay_slo_met": self.n_slo_met,
            "replay_shed": self.n_shed,
            "replay_rejected": self.n_rejected,
            "replay_makespan_s": self.makespan_s,
            "replay_offered_per_s": self.offered_per_s,
            "replay_goodput_per_s": self.goodput_per_s,
            "replay_p50_s": self.latency_p50_s,
            "replay_p99_s": self.latency_p99_s,
            "replay_slot_utilization": self.slot_utilization,
            "replay_ticks": self.ticks,
            "replay_chunks_run": self.chunks_run,
        }


def _percentile(sorted_vals: list[float], p: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(int(p / 100 * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[i]


def replay(svc: SolverService, trace: list[Arrival], *,
           iter_time_s: float = 1e-4, tick_overhead_s: float = 1e-4,
           max_ticks: int = 200_000) -> ReplayReport:
    """Drive ``svc`` through an open-loop ``trace``.

    Each loop turn submits every arrival whose time has come (admission
    rejections are recorded, not fatal), runs one scheduler tick, and
    advances the service clock by the modeled tick cost — so queueing
    delay emerges exactly as in a real open-loop system: when offered
    load outruns the slabs, arrivals pile up during ticks and latency
    grows.  With an idle service the clock jumps to the next arrival.
    """
    clock = svc.clock
    results: list = []
    rejected: list[int] = []
    i = 0
    ticks = 0
    while i < len(trace) or svc.pending > 0:
        while i < len(trace) and trace[i].t <= clock.now():
            a = trace[i]
            try:
                svc.submit(a.op_key, a.b, tol=a.tol,
                           deadline_s=a.deadline_s)
            except AdmissionRejected:
                rejected.append(i)
            i += 1
        if svc.pending == 0:
            if i >= len(trace):
                break
            clock.sleep(trace[i].t - clock.now())   # idle: jump ahead
            continue
        before = svc.scheduler.chunks_run
        results.extend(svc.step())
        ran = svc.scheduler.chunks_run - before
        clock.sleep(tick_overhead_s + iter_time_s * svc.chunk_iters * ran)
        ticks += 1
        if ticks > max_ticks:
            raise RuntimeError(f"replay: exceeded {max_ticks} ticks "
                               f"({svc.pending} requests still pending)")
    solved = [r for r in results if not r.shed]
    lats = sorted(r.latency_s for r in solved)
    t0 = trace[0].t if trace else 0.0
    t_end = max((t for _rid, _w, _tick, t in svc.retirement_log),
                default=t0)
    makespan = max(t_end - t0, 1e-12)
    n_met = sum(r.slo_met for r in results)
    offered = (len(trace) / max(trace[-1].t - t0, 1e-12)) if len(trace) > 1 \
        else 0.0
    return ReplayReport(
        n_arrivals=len(trace),
        n_retired=len(solved),
        n_converged=sum(r.converged for r in solved),
        n_slo_met=n_met,
        n_shed=sum(r.shed for r in results),
        n_rejected=len(rejected),
        makespan_s=makespan,
        offered_per_s=offered,
        goodput_per_s=n_met / makespan,
        latency_p50_s=_percentile(lats, 50),
        latency_p99_s=_percentile(lats, 99),
        slot_utilization=svc.scheduler.slot_utilization(),
        ticks=ticks,
        chunks_run=svc.scheduler.chunks_run,
        retirement_log=list(svc.retirement_log),
        steal_log=list(svc.scheduler.steal_log),
        shed_ids=[r.req_id for r in results if r.shed],
        rejected_arrivals=rejected,
    )
