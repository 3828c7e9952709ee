"""The port's serving layer (``repro_torch.serve``) on the CPU at smoke
size, mirroring the JAX package's tests/test_serve.py,
tests/test_serve_recovery.py and tests/test_batcher_properties.py: the
fingerprint and setup cache, the service end to end, typed errors,
request-granular uploads, self-healing workers, and the queue's
invariants as Hypothesis properties.

Every retired solve is held against its operator: true relative
residual below 1e-6 at tol 1e-8, the JAX test's bound.  The property
tests run Hypothesis derandomized with no example database, so the
examples are the same in every run.
"""

import inspect

import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import HealthCheck, given, settings, strategies as st

torch.set_num_threads(1)

from repro_torch.linalg import DiagonalOp, Stencil2D5  # noqa: E402
from repro_torch.linalg.operators import laplacian_2d_spectrum  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.parallel.backends import get_backend  # noqa: E402
from repro_torch.serve import (AdmissionPolicy, BadRequestError,  # noqa: E402
                               ConfigError, RequestQueue, RetryPolicy,
                               ServeError, SetupCache, SolveRequest,
                               SolverService, UnknownOperatorError,
                               VirtualClock, operator_fingerprint)
from repro_torch.serve.errors import WorkerFault  # noqa: E402
from repro_torch.serve.scheduler import (WORKER_FAULT_TYPES,  # noqa: E402
                                         DeathEvent)

PROPS = dict(max_examples=50, deadline=None, derandomize=True,
             database=None,
             suppress_health_check=[HealthCheck.too_slow])


def _local():
    return get_backend("local", device="cpu")


def _rel(op, b, x) -> float:
    r = b - op.apply(torch.as_tensor(x)).numpy()
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def test_operator_fingerprint_and_setup_cache():
    """Structurally equal operators share one fingerprint and one setup;
    a different operator misses."""
    op_a = Stencil2D5(16, 16, device="cpu")
    op_b = Stencil2D5(16, 16, device="cpu")
    op_c = Stencil2D5(16, 8, device="cpu")
    assert operator_fingerprint(op_a) == operator_fingerprint(op_b)
    assert operator_fingerprint(op_a) != operator_fingerprint(op_c)
    d = torch.as_tensor(np.random.default_rng(7).standard_normal(8) ** 2
                        + 1.0)
    assert operator_fingerprint(DiagonalOp(d)) == \
        operator_fingerprint(DiagonalOp(d.clone()))
    cache = SetupCache()
    p1 = cache.block_jacobi(op_a, 16)
    assert cache.block_jacobi(op_b, 16) is p1
    cache.block_jacobi(op_c, 8)
    assert cache.stats() == {"hits": 1, "misses": 2, "entries": 2}
    s1 = cache.sigmas(op_a, 2)
    assert cache.sigmas(op_b, 2) is s1


@pytest.mark.parametrize("method", ["cg", "plcg"])
def test_service_end_to_end(method):
    """More requests than slots, two operators: the scheduler packs,
    retires and recycles, and every retired solution solves its system."""
    ops = {"lap": Stencil2D5(16, 16, device="cpu"),
           "toy": DiagonalOp(laplacian_2d_spectrum(12, 12, device="cpu"))}
    svc = SolverService(_local(), s=3, method=method, l=2, chunk_iters=25,
                        maxit=800)
    for key, op in ops.items():
        svc.register_operator(key, op)
    rng = np.random.default_rng(3)
    sent = {}
    for i in range(8):
        key = "lap" if i % 2 == 0 else "toy"
        b = rng.standard_normal(ops[key].n)
        sent[svc.submit(key, b, tol=1e-8)] = (key, b)
    results = svc.drain()
    assert set(results) == set(sent)
    for rid, (key, b) in sent.items():
        r = results[rid]
        assert r.converged, (rid, key)
        assert _rel(ops[key], b, r.x) < 1e-6
        assert r.latency_s > 0 and r.res_history[0] > 0
    st_ = svc.stats()
    assert st_["retired"] == 8 and st_["pending"] == 0
    assert st_["slabs"] == 2
    assert st_["latency_p99_s"] >= st_["latency_p50_s"] > 0


def test_typed_serve_errors():
    """Malformed traffic raises the typed ServeError hierarchy, each
    subclass still catchable as the builtin it shadows."""
    op = Stencil2D5(8, 8, device="cpu")
    svc = SolverService(_local(), s=2)
    svc.register_operator("lap", op)
    with pytest.raises(UnknownOperatorError):
        svc.submit("nope", np.ones(op.n))
    with pytest.raises(BadRequestError):
        svc.submit("lap", np.ones(op.n - 1))
    with pytest.raises(BadRequestError):
        svc.submit("lap", np.ones(op.n, dtype=np.int64))
    bad = np.ones(op.n)
    bad[3] = np.nan
    with pytest.raises(BadRequestError):
        svc.submit("lap", bad)
    with pytest.raises(BadRequestError):
        svc.submit("lap", np.ones(op.n), tol=-1.0)
    with pytest.raises(BadRequestError):
        svc.submit("lap", np.ones(op.n), tol=float("nan"))
    with pytest.raises(BadRequestError):
        svc.submit("lap", np.ones(op.n), deadline_s=float("inf"))
    assert svc.pending == 0
    with pytest.raises(ConfigError):
        svc.register_operator("bad", object())
    with pytest.raises(ConfigError):
        SolverService(_local(), prec="block_jacobi").register_operator(
            "lap", op)
    with pytest.raises(ConfigError):
        SolverService(_local(), prec="weird").register_operator("lap", op)
    assert issubclass(UnknownOperatorError, ServeError)
    assert issubclass(UnknownOperatorError, KeyError)
    assert issubclass(BadRequestError, ValueError)
    assert issubclass(ConfigError, ServeError)


def test_request_granular_uploads():
    """The whole (s, n) slab uploads once; afterwards only the rows an
    inject changed cross to the device, and idle ticks move nothing (a
    right-hand side may come as an array or a tensor)."""
    op = Stencil2D5(8, 8, device="cpu")
    svc = SolverService(_local(), s=4, method="plcg", l=2, chunk_iters=60,
                        maxit=400, clock=VirtualClock())
    svc.register_operator("lap", op)
    rng = np.random.default_rng(0)
    for _ in range(4):
        svc.submit("lap", rng.standard_normal(op.n))
    svc.drain()
    st_ = svc.stats()
    assert (st_["full_uploads"], st_["uploaded_cols"]) == (1, 4)
    svc.step()
    svc.step()
    st_ = svc.stats()
    assert (st_["full_uploads"], st_["uploaded_cols"]) == (1, 4)
    svc.submit("lap", rng.standard_normal(op.n))
    svc.submit("lap", torch.as_tensor(rng.standard_normal(op.n)))  # a tensor
    svc.drain()
    st_ = svc.stats()
    assert st_["full_uploads"] == 1
    assert st_["uploaded_cols"] == 6


# ---------------------------------------------------------- recovery -----

def _run(fault_tick, max_retries=3, n_req=4, exc=WorkerFault):
    """One drain with a one-shot fault at ``fault_tick``."""
    op = Stencil2D5(12, 12, device="cpu")
    state = {"fired": False}

    def injector(tick, worker):
        if tick == fault_tick and not state["fired"]:
            state["fired"] = True
            raise exc(f"injected at tick {tick}")

    svc = SolverService(_local(), s=4, method="plcg", l=2, chunk_iters=25,
                        maxit=600, clock=VirtualClock(),
                        retry=RetryPolicy(max_retries=max_retries),
                        fault_injector=injector)
    svc.register_operator("lap", op)
    rng = np.random.default_rng(3)
    ids = [svc.submit("lap", rng.standard_normal(op.n))
           for _ in range(n_req)]
    return svc, ids, svc.drain(), state


def test_worker_fault_heals_and_every_request_converges():
    """A faulted worker is torn down and its in-flight requests resubmit
    and converge; the death is logged and counted, the respawn reuses the
    key's program, and two runs export identical metric snapshots."""
    svc, ids, results, state = _run(fault_tick=2)
    svc2, _, _, _ = _run(fault_tick=2)
    assert svc.metrics_snapshot() == svc2.metrics_snapshot()
    assert state["fired"]
    assert svc.worker_deaths == 1 and svc.resubmitted == 4
    for rid in ids:
        assert results[rid].converged and not results[rid].shed
    st_ = svc.stats()
    assert st_["retired"] == 4 and st_["shed"] == 0
    (ev,) = svc.scheduler.death_log
    assert isinstance(ev, DeathEvent) and ev.tick == 2
    assert sorted(ev.req_ids) == sorted(ids)
    assert "injected at tick 2" in ev.reason
    assert len(svc.scheduler._programs) == 1
    svc.reset_stats()
    assert svc.resubmitted == 0 and svc.stats()["resubmitted"] == 0


def test_rank_failure_heals_and_exhausted_retries_shed():
    """torch.distributed's DistBackendError (a dead rank) heals like a
    WorkerFault; without a retry budget every stranded request is shed."""
    svc, ids, results, _ = _run(fault_tick=2, exc=dist.DistBackendError)
    assert svc.worker_deaths == 1
    assert all(results[rid].converged for rid in ids)
    svc, ids, results, state = _run(fault_tick=2, max_retries=0)
    assert state["fired"]
    assert [results[rid].shed for rid in ids] == [True] * 4
    assert svc.resubmitted == 0 and svc.shed == 4


@pytest.mark.parametrize("exc", [TypeError, RuntimeError])
def test_bugs_and_kernel_errors_propagate(exc):
    """Only WorkerFault and DistBackendError heal: a programming bug and a
    generic RuntimeError (a kernel's nonzero return code) propagate."""
    assert issubclass(WorkerFault, ServeError)
    assert WorkerFault in WORKER_FAULT_TYPES
    assert dist.DistBackendError in WORKER_FAULT_TYPES
    assert not any(issubclass(exc, t) for t in WORKER_FAULT_TYPES)
    with pytest.raises(exc, match="injected"):
        _run(fault_tick=1, exc=exc)


def test_metrics_registry_exports():
    """The registry the service reports through: labeled counters, kind
    clashes refused, and a clock-stamped snapshot."""
    reg = MetricsRegistry()
    c = reg.counter("c_total", "a counter", label_names=("k",))
    c.labels(k="a").inc()
    c.labels(k="a").inc(2)
    assert reg.counter("c_total") is c
    with pytest.raises(TypeError):
        reg.histogram("c_total")
    h = reg.histogram("h_seconds")
    for v in (3.0, 1.0, 2.0):
        h.observe(v)
    snap = reg.snapshot(VirtualClock(5.0))
    assert snap["time"] == 5.0
    assert snap["metrics"]["c_total"]["series"]['{k="a"}'] == 3.0
    assert snap["metrics"]["h_seconds"]["series"][""]["p50"] == 2.0


# ---------------------------------------------------- batcher properties --

SUBMITS = st.lists(st.tuples(st.integers(0, 3), st.integers(0, 2)),
                   min_size=0, max_size=40)
KEYS = ["opA", "opB", "opC", "opD"]
TOLS = [1e-6, 1e-8, 1e-10]


def _fill(script):
    q = RequestQueue()
    reqs = [q.submit(KEYS[ki], np.asarray([float(i)]), TOLS[ti],
                     now=float(i)) for i, (ki, ti) in enumerate(script)]
    return q, reqs


@given(script=SUBMITS)
@settings(**PROPS)
def test_monotone_req_ids_and_fifo_per_key(script):
    """Request ids are monotone in submission order, and each slab key
    drains in FIFO order."""
    q, reqs = _fill(script)
    assert [r.req_id for r in reqs] == list(range(len(script)))
    for key in {r.slab_key for r in reqs}:
        expect = [r.req_id for r in reqs if r.slab_key == key]
        assert [r.req_id for r in q.take(key, len(script) + 1)] == expect


@given(script=SUBMITS, k=st.integers(0, 10))
@settings(**PROPS)
def test_take_never_over_pops(script, k):
    """take(key, k) returns min(k, pending) requests and removes exactly
    those."""
    q, reqs = _fill(script)
    total = len(q)
    for key in {r.slab_key for r in reqs}:
        before = q.pending(key)
        got = q.take(key, k)
        assert len(got) == min(k, before)
        assert q.pending(key) == before - len(got)
        total -= len(got)
        assert len(q) == total


@given(script=SUBMITS)
@settings(**PROPS)
def test_insertion_order_key_fairness(script):
    """keys() runs in first-submission order, stable under a partial drain
    of a middle key."""
    q, reqs = _fill(script)
    first_seen = []
    for r in reqs:
        if r.slab_key not in first_seen:
            first_seen.append(r.slab_key)
    assert q.keys() == first_seen
    if len(first_seen) >= 2:
        q.take(first_seen[len(first_seen) // 2], 1)
        assert q.keys() == [k for k in first_seen if q.pending(k)]


@given(deadline=st.one_of(st.none(), st.floats(0.01, 10.0)),
       waited=st.floats(0.0, 20.0))
@settings(**PROPS)
def test_deadline_expiry(deadline, waited):
    """expired(now) is the JAX package's expression itself, now -
    submitted_at > deadline_s (so a wait of exactly deadline_s may round
    either way, as it does there); no deadline never expires."""
    req = SolveRequest(req_id=0, op_key="k", b=np.zeros(1), tol=1e-8,
                       deadline_s=deadline)
    req.submitted_at = 100.0
    now = 100.0 + waited
    assert req.expired(now) == (deadline is not None
                                and now - req.submitted_at > deadline)
    assert "now - self.submitted_at > self.deadline_s" in \
        inspect.getsource(SolveRequest.expired)


@given(pending=st.integers(0, 50),
       max_pending=st.one_of(st.none(), st.integers(1, 40)),
       deadline=st.one_of(st.none(), st.floats(-1.0, 5.0)))
@settings(**PROPS)
def test_admission_policy_verdicts(pending, max_pending, deadline):
    """Admission rejects exactly a full queue or a deadline at or below
    the floor, queue depth first."""
    verdict = AdmissionPolicy(max_pending=max_pending,
                              min_deadline_s=0.0).check(pending, deadline)
    if max_pending is not None and pending >= max_pending:
        assert verdict == "queue_full"
    elif deadline is not None and deadline <= 0.0:
        assert verdict == "deadline_infeasible"
    else:
        assert verdict is None
