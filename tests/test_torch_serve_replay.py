"""Open-loop traffic replay of the port's serving layer on the virtual
clock, mirroring the JAX package's tests/test_serve_replay.py (all but its
subprocess test, whose port counterpart counts the reduction starts of
each slab iteration through counting SolverOps, in process).

The replay report on the mirrored trace is compared with the JAX
package's: every column equal.  Restart timing is rounding-sensitive
between the packages (ROADMAP.md queue 3), so the comparison runs where no
request restarts (an 8 x 8 Laplacian, no preconditioner, the JAX shifts
handed across through the port's setup cache), as the other parity tests
do; there the port's iteration counts equal the JAX package's.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

from repro.core.chebyshev import shifts_for_operator as jshifts  # noqa: E402
from repro.linalg import operators as jops  # noqa: E402
from repro.parallel import get_backend as jget_backend  # noqa: E402
from repro.serve import AdmissionPolicy as JAdmission  # noqa: E402
from repro.serve import SolverService as JService  # noqa: E402
from repro.serve import TrafficClass as JTraffic  # noqa: E402
from repro.serve import VirtualClock as JClock  # noqa: E402
from repro.serve import poisson_trace as jpoisson  # noqa: E402
from repro.serve import replay as jreplay  # noqa: E402
from repro_torch.core import batched  # noqa: E402
from repro_torch.core.types import SolverOps  # noqa: E402
from repro_torch.linalg import Stencil2D5  # noqa: E402
from repro_torch.parallel.backends import LocalBackend  # noqa: E402
from repro_torch.serve import (AdmissionPolicy, AdmissionRejected,  # noqa: E402
                               RetryPolicy, SolverService, TrafficClass,
                               VirtualClock, operator_fingerprint,
                               poisson_trace, replay)

OP = Stencil2D5(8, 8, device="cpu")       # n = 64: small enough to replay
CLASSES = [(4.0, 1e-4, 2.0), (1.0, 1e-10, 8.0)]   # weight, tol, deadline


def _service(**over):
    kw = dict(s=4, method="plcg", l=2, chunk_iters=8, maxit=300,
              clock=VirtualClock(),
              admission=AdmissionPolicy(max_pending=64),
              max_replicas=2, replicate_watermark=0.5)
    kw.update(over)
    backend = kw.pop("backend", None) or LocalBackend(device="cpu")
    svc = SolverService(backend, **kw)
    svc.register_operator("lap", OP)
    return svc


def _mixed_trace(seed=7, n_requests=24, rate=40.0):
    """Heavy-tail mix: mostly loose-tol solves, a tail of tight-tol ones —
    two slab keys, so the scheduler runs several slabs."""
    classes = [TrafficClass("lap", OP.n, weight=w, tol=t, deadline_s=d)
               for w, t, d in CLASSES]
    return poisson_trace(classes, rate_per_s=rate, n_requests=n_requests,
                         seed=seed)


def _run_replay(trace, **over):
    svc = _service(**over)
    return svc, replay(svc, trace, iter_time_s=1e-3, tick_overhead_s=1e-3)


def test_replay_report_equals_the_jax_package():
    """The same seeded trace through the JAX package's service and the
    port's: the same arrivals (bit for bit), and every replay column, the
    retirement log and the steal log equal."""
    jop = jops.Stencil2D5(8, 8)
    jtrace = jpoisson([JTraffic("lap", jop.n, weight=w, tol=t, deadline_s=d)
                       for w, t, d in CLASSES],
                      rate_per_s=40.0, n_requests=24, seed=7)
    trace = _mixed_trace()
    assert [a.t for a in trace] == [a.t for a in jtrace]
    assert all(np.array_equal(a.b, ja.b) for a, ja in zip(trace, jtrace))
    jsvc = JService(jget_backend("local"), s=4, method="plcg", l=2,
                    chunk_iters=8, maxit=300, clock=JClock(),
                    admission=JAdmission(max_pending=64), max_replicas=2,
                    replicate_watermark=0.5)
    jsvc.register_operator("lap", jop)
    jrep = jreplay(jsvc, jtrace, iter_time_s=1e-3, tick_overhead_s=1e-3)
    svc = SolverService(LocalBackend(device="cpu"), s=4, method="plcg", l=2,
                        chunk_iters=8, maxit=300, clock=VirtualClock(),
                        admission=AdmissionPolicy(max_pending=64),
                        max_replicas=2, replicate_watermark=0.5)
    sig = torch.tensor(np.asarray(jshifts(jop, 2)))
    svc.cache.get("sigmas", (operator_fingerprint(OP), None, 2),
                  lambda: sig)
    svc.register_operator("lap", OP)
    rep = replay(svc, trace, iter_time_s=1e-3, tick_overhead_s=1e-3)
    assert rep.metrics() == jrep.metrics()
    assert rep.retirement_log == jrep.retirement_log
    assert [tuple(e) for e in rep.steal_log] == \
        [tuple(e) for e in jrep.steal_log]
    assert [svc.results[i].iters for i in range(24)] == \
        [jsvc.results[i].iters for i in range(24)]


def test_replay_deterministic_and_seed_sensitive():
    """Two replays of one seeded trace on fresh services agree exactly
    (logs, decisions, percentiles); other seeds give other traces."""
    trace = _mixed_trace()
    svc1, rep1 = _run_replay(trace)
    svc2, rep2 = _run_replay(trace)
    assert rep1.retirement_log == rep2.retirement_log
    assert rep1.retirement_log
    assert rep1.steal_log == rep2.steal_log
    assert rep1.shed_ids == rep2.shed_ids
    assert rep1.metrics() == rep2.metrics()
    assert svc1.stats()["latency_p99_s"] == svc2.stats()["latency_p99_s"]
    assert rep1.n_retired + rep1.n_shed + rep1.n_rejected == len(trace)
    assert rep1.n_converged == rep1.n_retired
    assert [a.t for a in _mixed_trace(seed=1)] != \
        [a.t for a in _mixed_trace(seed=2)]


def test_work_stealing_and_replication():
    """A hot key scales out to a replica sharing ONE slab program, idle
    replicas steal from their sibling's tail, and every retired solution
    solves its system."""
    svc = _service(replicate_watermark=0.25)
    rng = np.random.default_rng(0)
    ii, jj = np.meshgrid(np.arange(1, 9), np.arange(1, 9), indexing="ij")
    mode = (np.sin(np.pi * ii / 9) * np.sin(np.pi * jj / 9)).reshape(-1)
    sent = {}
    for i in range(16):
        b = mode * (1.0 + i) if i % 2 == 0 else rng.standard_normal(OP.n)
        sent[svc.submit("lap", b, tol=1e-8)] = b
    results = svc.drain()
    sched = svc.scheduler
    assert len(sched._programs) == 1
    assert sched.replicas(("lap", 1e-8)) == 2
    w0, w1 = sched._by_key[("lap", 1e-8)]
    assert w0.program is w1.program
    assert sched.steal_log
    for ev in sched.steal_log:
        assert results[ev.req_id].worker == ev.thief
    for rid, b in sent.items():
        r = results[rid]
        assert r.converged and not r.shed
        x = torch.as_tensor(r.x)
        assert np.linalg.norm(b - OP.apply(x).numpy()) \
            / np.linalg.norm(b) < 1e-6


def test_shedding_and_admission_under_overload():
    """Open-loop overload: expired deadlines shed at pack time, a full
    queue rejects at the door, and goodput counts SLO-met solves only."""
    classes = [TrafficClass("lap", OP.n, tol=1e-10, deadline_s=0.012)]
    trace = poisson_trace(classes, rate_per_s=400.0, n_requests=40, seed=3)
    svc = _service(admission=AdmissionPolicy(max_pending=12),
                   max_replicas=1)
    rep = replay(svc, trace, iter_time_s=1e-3, tick_overhead_s=1e-3)
    assert rep.n_rejected > 0 and rep.n_shed > 0
    assert rep.n_shed == len(rep.shed_ids) == svc.shed
    assert rep.n_retired + rep.n_shed + rep.n_rejected == len(trace)
    for rid in rep.shed_ids:
        r = svc.results[rid]
        assert r.shed and r.x is None and not r.slo_met
    assert rep.n_slo_met <= rep.n_retired
    assert rep.goodput_per_s == rep.n_slo_met / rep.makespan_s
    assert all(ev.waited_s > 0.012 for ev in svc.scheduler.shed_log)


def test_retry_requeue_exhaustion_and_determinism():
    """A shed request with retries armed is requeued with backoff and
    retires converged; one whose deadline always blows is requeued
    max_retries times and then shed; the overload replay with retries
    armed is deterministic."""
    clock = VirtualClock()
    svc = _service(clock=clock,
                   retry=RetryPolicy(max_retries=2, backoff_base_s=0.05))
    req = svc.submit("lap", np.ones(OP.n), tol=1e-8, deadline_s=0.01)
    clock.advance(0.05)
    assert svc.step() == []
    assert (svc.retried, svc.shed, svc.pending) == (1, 0, 1)
    r = svc.drain()[req]
    assert r.converged and not r.shed and r.slo_met

    clock = VirtualClock()
    svc = _service(clock=clock,
                   retry=RetryPolicy(max_retries=2, backoff_base_s=0.05))
    req = svc.submit("lap", np.ones(OP.n), tol=1e-8, deadline_s=0.01)
    shed_seen = []
    for _ in range(6):
        clock.advance(1.0)
        svc._release_due_retries(clock.now())
        clock.advance(1.0)
        shed_seen += [r for r in svc.step() if r.shed]
        if shed_seen:
            break
    assert svc.retried == 2
    assert [r.req_id for r in shed_seen] == [req]

    classes = [TrafficClass("lap", OP.n, tol=1e-10, deadline_s=0.012)]
    trace = poisson_trace(classes, rate_per_s=400.0, n_requests=40, seed=3)
    runs = []
    for _ in range(2):
        s_ = _service(admission=AdmissionPolicy(max_pending=12),
                      max_replicas=1,
                      retry=RetryPolicy(max_retries=1, backoff_base_s=0.005))
        runs.append((s_, replay(s_, trace, iter_time_s=1e-3,
                                tick_overhead_s=1e-3)))
    (s1, r1), (s2, r2) = runs
    assert s1.retried > 0 and s1.retried == s2.retried
    assert r1.shed_ids == r2.shed_ids and r1.metrics() == r2.metrics()
    assert r1.n_retired + r1.n_shed + r1.n_rejected == len(trace)


def test_continuous_injection_beats_drain_to_empty():
    """Refilling retired slots at chunk boundaries keeps slot utilization
    above the drain-to-empty baseline on the same trace."""
    trace = _mixed_trace(seed=11, n_requests=32, rate=60.0)
    _, rep_c = _run_replay(trace, continuous=True)
    _, rep_d = _run_replay(trace, continuous=False)
    assert rep_c.n_converged == rep_c.n_retired
    assert rep_d.n_converged == rep_d.n_retired
    assert rep_c.slot_utilization > rep_d.slot_utilization


def test_no_wall_clock_dependence():
    """The harness, scheduler and service never read the wall clock; the
    injectable clock's SystemClock holds the only real reads."""
    from repro_torch.serve import clock as clock_mod
    from repro_torch.serve import replay as replay_mod
    from repro_torch.serve import scheduler as scheduler_mod
    from repro_torch.serve import service as service_mod

    for mod in (replay_mod, scheduler_mod, service_mod):
        src = inspect.getsource(mod)
        assert "perf_counter" not in src and "time.sleep" not in src
    assert "perf_counter" in inspect.getsource(clock_mod)


def test_admission_rejections_are_typed_with_retry_hint():
    """Queue-full rejections carry the retry policy's first backoff as a
    hint (none without a policy); infeasible deadlines never do."""
    svc = _service(admission=AdmissionPolicy(max_pending=1))
    svc.submit("lap", np.ones(OP.n), tol=1e-8)
    with pytest.raises(AdmissionRejected) as ei:
        svc.submit("lap", np.ones(OP.n), tol=1e-8)
    assert ei.value.reason == "queue_full" and ei.value.retry_after_s is None
    assert svc.stats()["rejected"] == 1
    pol = RetryPolicy(max_retries=2, backoff_base_s=0.05)
    svc = _service(admission=AdmissionPolicy(max_pending=1,
                                             min_deadline_s=0.001),
                   retry=pol)
    svc.submit("lap", np.ones(OP.n), tol=1e-8)
    with pytest.raises(AdmissionRejected) as ei:
        svc.submit("lap", np.ones(OP.n), tol=1e-8)
    assert ei.value.retry_after_s == pol.backoff(0)
    assert "retry after" in str(ei.value)
    svc = _service(admission=AdmissionPolicy(min_deadline_s=0.001),
                   retry=pol)
    with pytest.raises(AdmissionRejected) as ei:
        svc.submit("lap", np.ones(OP.n), tol=1e-8, deadline_s=0.0005)
    assert ei.value.reason == "deadline_infeasible"
    assert ei.value.retry_after_s is None


class _CountingBackend(LocalBackend):
    """A local backend whose every slab program's dot-block starts are
    counted by slab iteration: each program's iterations record how many
    starts they issued."""

    def __init__(self):
        super().__init__(device="cpu")
        self.per_iteration: list[tuple[int, int]] = []   # (program, starts)
        self.counters: dict[int, list[int]] = {}         # id(ops) -> starts

    def make_ops(self, op, prec=None):
        base = super().make_ops(op, prec)
        counter = [0]

        def start(mat, vec):
            counter[0] += 1
            return base.dot_block(mat, vec)

        ops = SolverOps.create(base.apply_a, base.prec, base.dot_block,
                               dot_block_start=start)
        self.counters[id(ops)] = counter
        return ops


def test_multi_slab_one_start_per_slab_iteration(monkeypatch):
    """With two slab keys live and a replicated hot key, every slab
    iteration of every slab program issues exactly ONE (s, K) reduction
    start, and replicas share their key's program."""
    be = _CountingBackend()
    real = batched.BUILDERS["plcg"]
    programs = []

    def counting_build(ops, b, **kw):
        prog = real(ops, b, **kw)
        tag = len(programs)
        programs.append(tag)
        counter = be.counters[id(ops)]

        def iteration(st, active=None):
            before = counter[0]
            out = prog.iteration(st, active)
            be.per_iteration.append((tag, counter[0] - before))
            return out

        return prog._replace(iteration=iteration)

    monkeypatch.setitem(batched.BUILDERS, "plcg", counting_build)
    svc = _service(backend=be, max_replicas=2, replicate_watermark=0.25)
    rng = np.random.default_rng(0)
    for i in range(10):
        svc.submit("lap", rng.standard_normal(OP.n),
                   tol=1e-8 if i % 3 else 1e-4)
    results = svc.drain()
    assert all(r.converged for r in results.values())
    sched = svc.scheduler
    assert len(sched._programs) == 2 and len(sched.workers) >= 3
    for key, group in sched._by_key.items():
        assert all(w.program is sched._programs[key] for w in group)
    assert len(programs) == 2
    assert {tag for tag, _ in be.per_iteration} == {0, 1}
    assert all(n == 1 for _, n in be.per_iteration)
