"""Solver-as-a-service: continuous-batching serve over the batched CG
family (counterpart of ``repro/serve/service.py``, DESIGN.md §11/§15).

``SolverService`` is the single-threaded, deterministic serving loop the
ROADMAP's "heavy traffic" north star asks for, built on four pieces:

* the **request queue / admission layer** (``repro_torch.serve.batcher``)
  buckets incoming (op_key, b, tol, deadline) requests and applies the
  :class:`AdmissionPolicy` (queue-depth ceiling, deadline feasibility)
  at the door;
* the **multi-slab scheduler** (``repro_torch.serve.scheduler``) runs a pool
  of slab workers — per slab key, plus replicated workers for hot keys —
  with work stealing, continuous slot injection at every chunk boundary,
  and deadline-based load shedding;
* the backend's **slab program** (``make_slab_program``) steps each
  slab ``chunk_iters`` iterations at a time, amortizing the
  per-iteration global reduction over all s columns — one (s, K) start
  per iteration per slab however many requests are in flight
  (arXiv:1905.06850's amortized-reduction win);
* the **setup cache** (``repro_torch.serve.cache``) makes repeat traffic
  against a known operator skip the block-Jacobi factorization and
  Chebyshev shift estimation.

All timestamps — request submission, retirement latency, deadline
checks — come from an injectable clock (``repro_torch.serve.clock``): under a
:class:`VirtualClock` the whole service is bit-for-bit deterministic,
which is what the open-loop traffic replay harness
(``repro_torch.serve.replay``) and tests/test_torch_serve_replay.py rely
on.

Lifecycle per scheduler tick (``step``): route queued requests to
workers, pack free slots (``inject`` re-initializes exactly those
columns, uploading only the changed ones), run one chunk on every busy
slab, then retire every occupied column whose loop has stopped —
converged or iteration-capped — recording its result and latency and
freeing the slot.  Converged-but-not-yet-retired columns iterate
predicated and stay bitwise frozen (``repro_torch.core.batched``), so a
retired iterate is unaffected by however long its slab-mates keep
running.  Every slab has fixed (s, n) shapes: the request mix never
rebuilds a program.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Hashable

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.batcher import (AdmissionPolicy, RequestQueue,
                                       RetryPolicy, SlabKey, SolveRequest)
from repro_torch.serve.cache import SetupCache
from repro_torch.serve.clock import Clock, SystemClock
from repro_torch.serve.errors import (AdmissionRejected, BadRequestError,
                                      ConfigError, UnknownOperatorError)
from repro_torch.serve.scheduler import SlabScheduler


@dataclasses.dataclass
class RequestResult:
    """Retired solve: solution + per-request telemetry.

    ``shed`` results carry ``x=None`` — the request was dropped
    unstarted because its deadline expired in queue (load shedding);
    ``slo_met`` is converged-within-deadline (requests without a
    deadline count as met when converged), the numerator of goodput.
    """

    req_id: int
    op_key: Hashable
    x: np.ndarray | None
    iters: int
    converged: bool
    res_history: np.ndarray        # recorded residual norms (trimmed)
    latency_s: float               # submit -> retirement (service clock)
    worker: int = 0                # slab worker that ran it
    deadline_s: float | None = None
    shed: bool = False
    slo_met: bool = True


@dataclasses.dataclass
class OperatorEntry:
    op: Any
    prec: Any
    solver_kwargs: dict


class SolverService:
    """Batched multi-RHS solver service over one reduction backend.

    Parameters
    ----------
    backend:      a ``ReductionBackend`` with slab programs (``local``;
                  over ranks they are not ported yet, ROADMAP.md queue 1
                  item 5b) — the slab programs are built through its
                  ``make_slab_program``, and the slabs live on its
                  ``device``.
    s:            slab width (requests solved in lock-step per slab).
    method:       "cg" | "pcg" | "plcg" (the shared METHODS keys).
    l:            pipeline depth for plcg.
    chunk_iters:  iterations per scheduler tick between retirement scans.
    maxit:        iteration cap per request (fixed per slab program).
    prec:         None | "jacobi" | "block_jacobi" — per-operator setup,
                  built through the fingerprint cache.
    block_size:   block-Jacobi block size (default: one grid line /
                  shard-interior heuristic left to the caller).
    clock:        time source (default :class:`SystemClock`); inject a
                  :class:`~repro_torch.serve.clock.VirtualClock` for
                  deterministic scheduling/latency accounting.
    admission:    :class:`AdmissionPolicy` (default: admit everything —
                  the pre-§15 behavior).
    max_replicas: slab workers allowed per slab key (>1 enables hot-key
                  scale-out; replicas share the slab program).
    replicate_watermark:  spawn a replica when every existing worker's
                  backlog is >= watermark * s.
    continuous:   refill freed slots at every chunk boundary.  False =
                  drain-to-empty baseline (slots recycle only once a
                  slab is fully empty) — kept for the utilization
                  comparison in BENCH_serve.json.
    retry:        :class:`~repro_torch.serve.batcher.RetryPolicy` — requeue
                  shed requests after exponential backoff (bounded by
                  ``max_retries``, fresh SLO window per attempt) instead
                  of dropping them, and attach a ``retry_after_s`` hint
                  to queue-full :class:`AdmissionRejected`.  None
                  (default) keeps the drop-on-shed behavior.  Pure
                  service-clock arithmetic: deterministic under a
                  VirtualClock replay.
    fault_injector: ``fault_injector(tick, worker)`` runs before each
                  busy worker's chunk; raising ``WorkerFault`` simulates
                  a backing process's death (the recovery drill).

    Idle workers always steal queued requests from same-key siblings
    (deterministic; logged).  Each service reports through a
    :class:`~repro_torch.obs.metrics.MetricsRegistry` and a
    :class:`SetupCache` of its own; the stat attributes (``retired``,
    ``rejected``, ``shed``, ``slo_met``, ``_latencies``) are read-only
    views onto the registry.  The JAX service's ``telemetry_cap``,
    ``replace_every`` and shared registry and cache are not ported:
    nothing in the port sets them yet.
    """

    def __init__(self, backend, s: int = 8, method: str = "plcg",
                 l: int = 2, chunk_iters: int = 16, maxit: int = 500,
                 prec: str | None = None, block_size: int | None = None,
                 clock: Clock | None = None,
                 admission: AdmissionPolicy | None = None,
                 max_replicas: int = 1, replicate_watermark: float = 1.0,
                 continuous: bool = True,
                 retry: RetryPolicy | None = None,
                 fault_injector=None):
        self.backend = backend
        self.s = int(s)
        self.method = method
        self.l = int(l)
        self.chunk_iters = int(chunk_iters)
        self.maxit = int(maxit)
        self.prec_kind = prec
        self.block_size = block_size
        self.registry = MetricsRegistry()
        self.cache = SetupCache(registry=self.registry)
        self.clock = SystemClock() if clock is None else clock
        self.admission = AdmissionPolicy() if admission is None else admission
        self.retry = retry
        # Backoff queue of requeued shed requests: (due_t, req_id, req)
        # min-heap on the service clock — req_id tiebreak keeps the pop
        # order deterministic under a VirtualClock.
        self._retry_q: list[tuple[float, int, SolveRequest]] = []

        self.queue = RequestQueue()
        self.scheduler = SlabScheduler(
            self._make_program, device=getattr(backend, "device", None),
            max_replicas=max_replicas,
            replicate_watermark=replicate_watermark, continuous=continuous,
            shed_expired=self.admission.shed_expired,
            registry=self.registry,
            fault_injector=fault_injector)
        # Retired results are held until the caller collects them
        # (``pop_result`` / ``drain``); latency percentiles come from a
        # bounded reservoir so long-lived services don't grow stats state.
        self.results: dict[int, RequestResult] = {}
        self._operators: dict[Hashable, OperatorEntry] = {}
        # Retirement log: (req_id, worker, tick, t) in retirement order —
        # the determinism witness the replay tests compare bitwise.
        self.retirement_log: list[tuple[int, int, int, float]] = []
        # Request lifecycle stats, all registry series (DESIGN.md §16).
        m = self.registry
        self._c_retired = m.counter(
            "serve_requests_retired_total", "requests retired with a result")
        self._c_rejected = m.counter(
            "serve_requests_rejected_total", "requests refused at admission")
        self._c_shed = m.counter(
            "serve_requests_shed_total",
            "requests dropped unstarted (deadline expired in queue)")
        self._c_slo = m.counter(
            "serve_requests_slo_met_total",
            "requests converged within their deadline")
        self._c_retried = m.counter(
            "serve_requests_retried_total",
            "shed requests requeued by the retry policy")
        self._c_resubmitted = m.counter(
            "serve_requests_resubmitted_total",
            "in-flight requests of a dead worker resubmitted with a "
            "fresh SLO window")
        self._h_latency = m.histogram(
            "serve_request_latency_seconds",
            "submit -> retirement latency (bounded reservoir)")

    # -------------------------------------------------------- registry ---
    def register_operator(self, key: Hashable, op,
                          block_size: int | None = None) -> None:
        """One-time (cached) setup for an operator clients will solve
        against: preconditioner factorization + Chebyshev shifts."""
        if not hasattr(op, "n") or not hasattr(op, "apply"):
            raise ConfigError(
                f"operator for {key!r} must expose .n and .apply "
                f"(got {type(op).__name__})")
        prec = None
        if self.prec_kind == "jacobi":
            prec = self.cache.jacobi(op)
        elif self.prec_kind == "block_jacobi":
            bs = block_size or self.block_size
            if not bs:
                raise ConfigError("block_jacobi needs a block_size "
                                  "(service or register_operator kwarg)")
            prec = self.cache.block_jacobi(op, bs)
        elif self.prec_kind is not None:
            raise ConfigError(f"unknown prec kind {self.prec_kind!r}")
        kw: dict = {"maxit": self.maxit}
        if self.method == "plcg":
            kw.update(l=self.l,
                      sigmas=self.cache.sigmas(op, self.l, prec=prec))
        self._operators[key] = OperatorEntry(op=op, prec=prec,
                                             solver_kwargs=kw)

    def _make_program(self, key: SlabKey):
        """Build the slab program for one slab key (scheduler callback;
        replicas share the result)."""
        op_key, tol = key
        entry = self._operators[op_key]
        return self.backend.make_slab_program(
            entry.op, s=self.s, method=self.method, prec=entry.prec,
            chunk_iters=self.chunk_iters, tol=tol, **entry.solver_kwargs)

    # --------------------------------------------------------- clients ---
    @property
    def pending(self) -> int:
        """Admitted-but-unfinished request count (queue + worker queues +
        in-flight slots + backoff-delayed retries) — the admission
        policy's queue-depth metric."""
        return (len(self.queue) + self.scheduler.backlog()
                + self.scheduler.in_flight() + len(self._retry_q))

    def submit(self, op_key: Hashable, b, tol: float = 1e-8,
               deadline_s: float | None = None) -> int:
        """Enqueue a solve; returns the request id (see ``results``).

        ``b`` is an array or a tensor (on any device; the queue keeps a
        host copy).  Raises :class:`UnknownOperatorError` /
        :class:`BadRequestError` on malformed requests and
        :class:`AdmissionRejected` when the admission policy refuses the
        work (queue full, hopeless deadline).
        """
        entry = self._operators.get(op_key)
        if entry is None:
            raise UnknownOperatorError(op_key)
        if isinstance(b, torch.Tensor):
            b = b.detach().cpu().numpy()
        b = np.asarray(b)
        if b.shape != (entry.op.n,):
            raise BadRequestError(
                f"RHS shape {b.shape} != ({entry.op.n},) for {op_key!r}")
        if not np.issubdtype(b.dtype, np.floating):
            raise BadRequestError(f"RHS dtype {b.dtype} is not floating")
        if not np.isfinite(b).all():
            raise BadRequestError("RHS contains non-finite entries")
        tol = float(tol)
        if not (tol >= 0.0):            # NaN fails this too
            raise BadRequestError(f"tol must be >= 0 (got {tol})")
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if not np.isfinite(deadline_s):
                raise BadRequestError(f"deadline_s must be finite "
                                      f"(got {deadline_s})")
        reason = self.admission.check(self.pending, deadline_s)
        if reason is not None:
            self._c_rejected.inc()
            # Backoff hint: queue pressure drains, so suggest the retry
            # policy's first backoff; an infeasible deadline gets none
            # (resubmitting the same deadline can never be admitted).
            hint = (self.retry.backoff(0)
                    if self.retry is not None and reason == "queue_full"
                    else None)
            raise AdmissionRejected(reason, f"pending={self.pending}",
                                    retry_after_s=hint)
        return self.queue.submit(op_key, b, tol, deadline_s=deadline_s,
                                 now=self.clock.now()).req_id

    # ------------------------------------------------------- scheduler ---
    def _dispatch_queue(self) -> None:
        """Route every queued request to a slab worker (insertion-fair
        over keys; FIFO within a key)."""
        for key in self.queue.keys():
            for req in self.queue.take(key, self.queue.pending(key)):
                self.scheduler.dispatch(req)

    def _record(self, req: SolveRequest, *, worker: int, x, iters: int,
                converged: bool, res_history, shed: bool,
                now: float) -> RequestResult:
        latency = now - req.submitted_at
        met = (not shed and converged
               and (req.deadline_s is None or latency <= req.deadline_s))
        rr = RequestResult(
            req_id=req.req_id, op_key=req.op_key, x=x, iters=iters,
            converged=converged, res_history=res_history,
            latency_s=latency, worker=worker, deadline_s=req.deadline_s,
            shed=shed, slo_met=met)
        self.results[req.req_id] = rr
        if shed:
            self._c_shed.inc()
        else:
            self._h_latency.observe(latency)
            self._c_retired.inc()
            self.retirement_log.append(
                (req.req_id, worker, self.scheduler.ticks, now))
        if met:
            self._c_slo.inc()
        return rr

    def _release_due_retries(self, now: float) -> None:
        """Move backoff-expired retries back onto the workers (fresh SLO
        window: the deadline re-anchors at the release instant)."""
        while self._retry_q and self._retry_q[0][0] <= now:
            _due, _rid, req = heapq.heappop(self._retry_q)
            req.submitted_at = now
            self.scheduler.dispatch(req)

    def _maybe_requeue(self, req: SolveRequest, now: float,
                       counter=None) -> bool:
        """Shed-path retry: True when the request was requeued with
        backoff instead of dropped (bounded by the policy)."""
        if self.retry is None or req.retries >= self.retry.max_retries:
            return False
        delay = self.retry.backoff(req.retries)
        req.retries += 1
        heapq.heappush(self._retry_q, (now + delay, req.req_id, req))
        (self._c_retried if counter is None else counter).inc()
        return True

    def step(self) -> list[RequestResult]:
        """One scheduler tick over every slab with work: release due
        retries, dispatch, pack free slots, chunk all busy slabs, retire
        finished columns.  Returns the requests retired (or shed) this
        tick.

        Requests stranded by a worker death (``TickReport.failed``) are
        resubmitted through the retry policy with a fresh SLO window —
        the deadline re-anchors when the backoff releases them — and
        shed-recorded only on exhausted retries (DESIGN.md §19)."""
        self._release_due_retries(self.clock.now())
        self._dispatch_queue()
        report = self.scheduler.tick(self.clock.now())
        now = self.clock.now()
        out = []
        for rc in report.retired:
            out.append(self._record(
                rc.req, worker=rc.worker, x=rc.x, iters=rc.iters,
                converged=rc.converged, res_history=rc.res_history,
                shed=False, now=now))
        for req in report.shed:
            if self._maybe_requeue(req, now):
                continue
            out.append(self._record(
                req, worker=-1, x=None, iters=0, converged=False,
                res_history=np.empty(0), shed=True, now=now))
        for req in report.failed:
            if self._maybe_requeue(req, now, counter=self._c_resubmitted):
                continue
            out.append(self._record(
                req, worker=-1, x=None, iters=0, converged=False,
                res_history=np.empty(0), shed=True, now=now))
        return out

    def drain(self, max_ticks: int = 10_000) -> dict[int, RequestResult]:
        """Run the scheduler until queue and slabs are empty.  When the
        only remaining work is backoff-delayed retries, the clock sleeps
        to the next due instant (advancing a VirtualClock exactly)."""
        for _ in range(max_ticks):
            if self.pending == 0:
                break
            if self._retry_q and self.pending == len(self._retry_q):
                self.clock.sleep(
                    max(self._retry_q[0][0] - self.clock.now(), 0.0))
            self.step()
        else:
            raise RuntimeError("drain: max_ticks exceeded "
                               "(requests not converging?)")
        return self.results

    def pop_result(self, req_id: int) -> RequestResult:
        """Collect (and release) a retired result — the steady-state
        client path: results held in the service are freed on collection
        so sustained traffic doesn't accumulate solution vectors."""
        return self.results.pop(req_id)

    # ------------------------------------------------------- telemetry ---
    @property
    def chunks_run(self) -> int:
        return self.scheduler.chunks_run

    # Thin read-only views of the registry series.
    @property
    def retired(self) -> int:
        return int(self._c_retired.value())

    @property
    def rejected(self) -> int:
        return int(self._c_rejected.value())

    @property
    def shed(self) -> int:
        return int(self._c_shed.value())

    @property
    def retried(self) -> int:
        return int(self._c_retried.value())

    @property
    def resubmitted(self) -> int:
        return int(self._c_resubmitted.value())

    @property
    def worker_deaths(self) -> int:
        return int(self.scheduler._c_deaths.value())

    @property
    def slo_met(self) -> int:
        return int(self._c_slo.value())

    @property
    def _latencies(self):
        return self._h_latency.reservoir()

    def reset_stats(self) -> None:
        """Zero the latency reservoir and counters (e.g. after a build
        warmup, so percentiles reflect steady-state traffic only)."""
        self._h_latency.clear()
        self._c_retired.reset()
        self._c_rejected.reset()
        self._c_shed.reset()
        self._c_slo.reset()
        self._c_retried.reset()
        self._c_resubmitted.reset()
        self.retirement_log.clear()
        self.scheduler.reset_stats()

    def stats(self) -> dict:
        sched = self.scheduler
        return {
            "retired": self.retired,
            "pending": self.pending,
            "chunks_run": sched.chunks_run,
            "slabs": len(sched._programs),
            "workers": len(sched.workers),
            "rejected": self.rejected,
            "shed": self.shed,
            "retried": self.retried,
            "resubmitted": self.resubmitted,
            "worker_deaths": self.worker_deaths,
            "slo_met": self.slo_met,
            "stolen": len(sched.steal_log),
            "slot_utilization": sched.slot_utilization(),
            "uploaded_cols": sum(w.uploaded_cols for w in sched.workers),
            "full_uploads": sum(w.full_uploads for w in sched.workers),
            "latency_p50_s": self._h_latency.quantile(50),
            "latency_p99_s": self._h_latency.quantile(99),
            "setup_cache": self.cache.stats(),
        }

    def metrics_snapshot(self) -> dict:
        """Registry snapshot stamped with the SERVICE clock — under a
        VirtualClock two replays of the same trace export identical
        snapshots."""
        return self.registry.snapshot(self.clock)
