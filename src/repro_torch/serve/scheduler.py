"""Multi-slab work-stealing scheduler — continuous batching for solves
(counterpart of ``repro/serve/scheduler.py``, DESIGN.md §15).

One slab amortizes the per-iteration global reduction over its s columns
(arXiv:1905.06850's win, batched: DESIGN.md §11), but a *service* has
more than one slab's worth of traffic: several slab keys (operators ×
tolerances) in flight at once, and hot keys whose queue outruns a single
slab.  This module runs a pool of :class:`SlabWorker`\\ s — each one
slab program and state bound to a slab key — under a deterministic
work-stealing scheduler:

* **replication** — when every worker for a key has a backlog past the
  ``replicate_watermark``, a replica spawns.  Replicas SHARE the key's
  :class:`~repro_torch.core.batched.SlabProgram` (one program, separate
  state tensors), so scale-out never rebuilds one.
* **work stealing** — a worker with free slots and an empty local queue
  steals from the deepest-backlog sibling of the same key, taking from
  the TAIL of the victim's queue (the classic owner-pops-head /
  thief-pops-tail discipline, which preserves the victim's FIFO head).
  Every steal is logged; with a virtual clock two replays of the same
  trace produce identical steal logs (tests/test_torch_serve_replay.py).
* **continuous injection** — freed slots are refilled from the local
  queue at every chunk boundary (``SlabProgram.inject``, fixed shapes),
  so slot-utilization stays high mid-flight instead of
  decaying as the slab drains.  ``continuous=False`` gives the
  drain-to-empty baseline the BENCH_serve replay section compares
  against.
* **load shedding** — queued requests whose deadline already expired
  are dropped at pack time (they could no longer meet their SLO; see
  ``AdmissionPolicy.shed_expired``), keeping slots for work that still
  counts toward goodput.

Every decision — dispatch target, steal victim, shed verdict, tick
order — is a pure function of the submission sequence and the injected
clock (``repro_torch.serve.clock``): no wall-clock reads, no unordered-dict
iteration, no randomness.  That determinism is what the replay test
harness (``repro_torch.serve.replay``) asserts bit-for-bit.

A tick is planned, then run: :meth:`SlabScheduler.tick` makes every host
decision of the tick (which requests each worker packs, which are shed)
and hands the :class:`TickPlan` to ``on_plan`` before any slab program
runs; a service over several ranks broadcasts it from rank 0 there, and
the other ranks run the same plan through :meth:`SlabScheduler.follow`
(``serve.service``), so every rank makes the same slab-program calls in
the same order.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Hashable, NamedTuple

import numpy as np
import torch
from torch.distributed import DistBackendError

from repro_torch.core.batched import SlabProgram, slab_slot_iterations
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.batcher import SlabKey, SolveRequest
from repro_torch.serve.errors import WorkerFault

# Exceptions the scheduler treats as "this worker's backing
# program/process died" (tear down + resubmit) rather than a scheduler
# bug (propagate).  Injected chaos faults raise WorkerFault directly; a
# dead rank surfaces as torch.distributed's DistBackendError (the
# counterpart of the JAX package's JaxRuntimeError).  Any other
# RuntimeError (a kernel's nonzero return code, a shape error) is a bug
# and propagates.
WORKER_FAULT_TYPES = (WorkerFault, DistBackendError)


class StealEvent(NamedTuple):
    """One work-steal: ``thief`` took ``req_id`` from ``victim``'s tail."""

    tick: int
    thief: int
    victim: int
    req_id: int


class ShedEvent(NamedTuple):
    """One load-shed: ``req_id`` dropped unstarted at ``t`` — its
    deadline had already passed after ``waited_s`` in queue."""

    tick: int
    worker: int
    req_id: int
    t: float
    waited_s: float


class DeathEvent(NamedTuple):
    """One worker teardown: ``worker`` faulted at ``tick``; its
    unretired requests (``req_ids``) went back to the service for
    resubmission through the retry policy."""

    tick: int
    worker: int
    req_ids: tuple[int, ...]
    reason: str


class RetiredColumn(NamedTuple):
    """One retired slab column, before the service wraps it in a
    :class:`~repro_torch.serve.service.RequestResult`."""

    worker: int
    req: SolveRequest
    x: np.ndarray
    iters: int
    converged: bool
    res_history: np.ndarray
    telemetry: np.ndarray | None = None     # the column's ring, if any


class SlabWorker:
    """One slab's runtime state: slab program + slots + local queue.

    The slab is (s, n), one request a row (the JAX package's (n, s)
    transposed).  Host→device traffic is request-granular (DESIGN.md
    §15): the full slab uploads exactly once (first init); afterwards only
    the rows an inject actually changed cross the host boundary
    (``B_dev[rows] = ...``, in place).  ``uploaded_cols`` counts requests
    transferred, ``full_uploads`` whole-slab transfers — the regression
    test in tests/test_torch_serve.py pins both.
    """

    def __init__(self, wid: int, key: SlabKey, program: SlabProgram,
                 device=None):
        self.wid = wid
        self.key = key
        self.program = program
        self.s = program.s
        self.device = resolve_device(device)
        self.B = np.zeros((program.s, program.n))
        self.slots: list[SolveRequest | None] = [None] * program.s
        self.local: deque[SolveRequest] = deque()
        self.state = None
        self.B_dev = None
        # Utilization accounting (occupied-slot-iterations / capacity).
        self._iters_base = np.zeros(program.s, dtype=np.int64)
        self.occupied_slot_iters = 0
        self.capacity_slot_iters = 0
        # Transfer accounting.
        self.uploaded_cols = 0
        self.full_uploads = 0

    # ------------------------------------------------------------ views --
    def free_slots(self) -> list[int]:
        return [j for j, r in enumerate(self.slots) if r is None]

    def occupied(self) -> list[int]:
        return [j for j, r in enumerate(self.slots) if r is not None]

    def backlog(self) -> int:
        return len(self.local)

    def load(self) -> int:
        """Dispatch metric: queued + in-flight requests."""
        return len(self.local) + len(self.occupied())

    # ------------------------------------------------------------- pack --
    def pack(self, incoming: list[SolveRequest]) -> None:
        """Fill free slots from ``incoming`` (already admission-checked
        and shed-filtered), uploading ONLY the changed columns."""
        free = self.free_slots()
        assert len(incoming) <= len(free)
        if self.state is None:
            # First pack: one full upload, init the whole slab (zero
            # padding columns retire at iteration 0 — exact).
            for j, req in zip(free, incoming):
                self.B[j] = req.b
                self.slots[j] = req
            self.B_dev = torch.as_tensor(self.B, device=self.device)
            self.uploaded_cols += self.s
            self.full_uploads += 1
            self.state = self.program.init(self.B_dev)
            self._iters_base[:] = 0
            return
        if not incoming:
            return                      # nothing changed: zero transfer
        refresh = np.zeros((self.s,), dtype=bool)
        cols = []
        for j, req in zip(free, incoming):
            self.B[j] = req.b
            self.slots[j] = req
            refresh[j] = True
            cols.append(j)
        idx = np.asarray(cols)
        self.B_dev[torch.as_tensor(idx, device=self.device)] = \
            torch.as_tensor(self.B[idx], device=self.device)
        self.uploaded_cols += len(cols)
        self.state = self.program.inject(self.B_dev, self.state, refresh)
        self._iters_base[idx] = 0

    # ------------------------------------------------------ chunk + poll --
    def poll(self) -> list[RetiredColumn]:
        """Post-chunk bookkeeping: utilization accounting, then retire
        every occupied column whose loop has stopped."""
        stat = self.program.status(self.B_dev, self.state)
        running = stat.running.cpu().numpy()
        iters_now = stat.iters.cpu().numpy()
        self.occupied_slot_iters += slab_slot_iterations(
            self._iters_base, iters_now)
        self.capacity_slot_iters += self.s * self.program.chunk_iters
        self._iters_base = iters_now.copy()   # pack() writes zeros into
        # injected slots
        done = [j for j in self.occupied() if not running[j]]
        if not done:
            return []
        res = self.program.extract(self.B_dev, self.state)
        x = res.x.cpu().numpy()
        iters = res.iters.cpu().numpy()
        conv = res.converged.cpu().numpy()
        hist = res.res_history.cpu().numpy()
        tel = (None if res.telemetry is None
               else res.telemetry.cpu().numpy())
        out = []
        for j in done:
            req = self.slots[j]
            h = hist[j]
            out.append(RetiredColumn(
                worker=self.wid, req=req, x=x[j], iters=int(iters[j]),
                converged=bool(conv[j]), res_history=h[h >= 0],
                telemetry=None if tel is None else tel[j]))
            self.slots[j] = None
        return out

    def slot_utilization(self) -> float:
        if not self.capacity_slot_iters:
            return 0.0
        return self.occupied_slot_iters / self.capacity_slot_iters


class TickPlan(NamedTuple):
    """The host decisions of one tick, made before any slab program runs:
    ``workers`` the pool's (wid, slab key) in tick order, ``packs`` the
    requests each worker packs into its free slots (in slot order), and
    ``shed`` the requests dropped at pack time."""

    workers: list[tuple[int, SlabKey]]
    packs: list[tuple[SlabWorker, list[SolveRequest]]]
    shed: list[SolveRequest]


@dataclasses.dataclass
class TickReport:
    """What one scheduler tick did (the service turns this into results
    and telemetry).  ``failed`` are the in-flight/queued requests of
    workers that died this tick — NOT results: the service resubmits
    them through the retry policy or shed-records them."""

    retired: list[RetiredColumn]
    shed: list[SolveRequest]
    chunks_run: int
    failed: list[SolveRequest] = dataclasses.field(default_factory=list)
    deaths: list[DeathEvent] = dataclasses.field(default_factory=list)


class SlabScheduler:
    """Deterministic multi-slab scheduler (DESIGN.md §15).

    ``make_program`` builds a :class:`SlabProgram` for a slab key on
    first use; replicas of the same key share it.  ``device`` is where
    the workers keep their slabs (default ``cuda``).  Dispatch sends each
    request to the least-loaded worker of its key (ties broken by
    worker id), spawning the first worker — or a replica, when every
    existing worker's backlog is at or past
    ``replicate_watermark * s`` and ``max_replicas`` allows — on demand.
    """

    def __init__(self, make_program: Callable[[SlabKey], SlabProgram], *,
                 device=None,
                 max_replicas: int = 1, replicate_watermark: float = 1.0,
                 continuous: bool = True,
                 shed_expired: bool = True,
                 registry: MetricsRegistry | None = None,
                 fault_injector: Callable[[int, SlabWorker], None]
                 | None = None,
                 on_plan: Callable[[TickPlan], None] | None = None):
        if max_replicas < 1:
            raise ValueError(f"max_replicas must be >= 1 ({max_replicas})")
        self.make_program = make_program
        self.device = resolve_device(device)
        self.max_replicas = int(max_replicas)
        self.replicate_watermark = float(replicate_watermark)
        self.continuous = continuous
        self.shed_expired = shed_expired
        # fault_injector(tick, worker) runs before each busy worker's
        # chunk dispatch; raising WorkerFault simulates a backing
        # process death at a deterministic tick (the serve recovery
        # drill's injection point — DESIGN.md §19).
        self.fault_injector = fault_injector
        # on_plan(plan) runs once a tick, after its host decisions and
        # before any slab program call (a service over ranks broadcasts
        # the plan there).
        self.on_plan = on_plan
        self.workers: list[SlabWorker] = []
        self._next_wid = 0               # wids never reuse: a respawned
        # worker is a NEW identity (death/steal/shed logs stay unambiguous)
        self._by_key: dict[SlabKey, list[SlabWorker]] = {}
        self._programs: dict[SlabKey, SlabProgram] = {}
        # Event LOGS are the determinism witnesses the replay tests
        # compare; the registry carries the aggregate COUNTS.
        self.steal_log: list[StealEvent] = []
        self.shed_log: list[ShedEvent] = []
        self.death_log: list[DeathEvent] = []
        self.ticks = 0
        self.chunks_run = 0
        self.registry = MetricsRegistry() if registry is None else registry
        m = self.registry
        self._c_steals = m.counter(
            "serve_steals_total",
            "requests stolen from a same-key sibling's queue tail",
            label_names=("thief",))
        self._c_sheds = m.counter(
            "serve_sheds_total",
            "queued requests dropped at pack time (deadline expired)")
        self._c_ticks = m.counter(
            "serve_ticks_total", "scheduler ticks run")
        self._c_chunks = m.counter(
            "serve_chunks_total", "slab chunks dispatched")
        self._c_deaths = m.counter(
            "serve_worker_deaths_total",
            "slab workers torn down after a backing fault")

    # --------------------------------------------------------- dispatch --
    def _spawn(self, key: SlabKey) -> SlabWorker:
        # Replacement workers for a key whose predecessor died reuse the
        # cached program: respawn never rebuilds one.
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self.make_program(key)
        w = SlabWorker(self._next_wid, key, prog, self.device)
        self._next_wid += 1
        self.workers.append(w)
        self._by_key.setdefault(key, []).append(w)
        return w

    def _fail_worker(self, w: SlabWorker, exc: BaseException,
                     deaths: list[DeathEvent]) -> list[SolveRequest]:
        """Tear down a faulted worker: harvest its unretired in-flight
        slots and local queue (the service resubmits them), remove it
        from the pool, and log the death.  The key's program stays cached
        — the next dispatch for the key spawns a fresh worker without
        rebuilding it."""
        reqs = [w.slots[j] for j in w.occupied()]
        reqs.extend(w.local)
        w.slots = [None] * w.s
        w.local.clear()
        w.state = None
        w.B_dev = None
        if w in self.workers:
            self.workers.remove(w)
        group = self._by_key.get(w.key)
        if group and w in group:
            group.remove(w)
            if not group:
                del self._by_key[w.key]
        ev = DeathEvent(tick=self.ticks, worker=w.wid,
                        req_ids=tuple(r.req_id for r in reqs),
                        reason=f"{type(exc).__name__}: {exc}")
        self.death_log.append(ev)
        deaths.append(ev)
        self._c_deaths.inc()
        return reqs

    def dispatch(self, req: SolveRequest) -> SlabWorker:
        """Route one admitted request to a worker (creating/replicating
        as needed); deterministic in the submission sequence."""
        group = self._by_key.get(req.slab_key)
        if not group:
            w = self._spawn(req.slab_key)
        else:
            w = min(group, key=lambda w: (w.load(), w.wid))
            if (len(group) < self.max_replicas
                    and w.backlog() >= self.replicate_watermark * w.s):
                w = self._spawn(req.slab_key)
        w.local.append(req)
        return w

    # ------------------------------------------------------------- tick --
    def _take_local(self, w: SlabWorker, k: int, now: float,
                    shed: list[SolveRequest]) -> list[SolveRequest]:
        """Pop up to k live requests from w's own queue head, shedding
        expired ones along the way."""
        out: list[SolveRequest] = []
        while len(out) < k and w.local:
            req = w.local.popleft()
            if self.shed_expired and req.expired(now):
                self.shed_log.append(ShedEvent(
                    tick=self.ticks, worker=w.wid, req_id=req.req_id,
                    t=now, waited_s=now - req.submitted_at))
                self._c_sheds.inc()
                shed.append(req)
                continue
            out.append(req)
        return out

    def _steal(self, w: SlabWorker, k: int, now: float,
               shed: list[SolveRequest]) -> list[SolveRequest]:
        """Steal up to k live requests from same-key siblings' tails,
        deepest backlog first (ties: lowest worker id)."""
        out: list[SolveRequest] = []
        siblings = [v for v in self._by_key[w.key] if v.wid != w.wid]
        while len(out) < k:
            victims = [v for v in siblings if v.backlog() > 0]
            if not victims:
                break
            v = min(victims, key=lambda v: (-v.backlog(), v.wid))
            req = v.local.pop()         # thief takes the TAIL
            if self.shed_expired and req.expired(now):
                self.shed_log.append(ShedEvent(
                    tick=self.ticks, worker=v.wid, req_id=req.req_id,
                    t=now, waited_s=now - req.submitted_at))
                self._c_sheds.inc()
                shed.append(req)
                continue
            self.steal_log.append(StealEvent(
                tick=self.ticks, thief=w.wid, victim=v.wid,
                req_id=req.req_id))
            self._c_steals.labels(thief=str(w.wid)).inc()
            out.append(req)
        return out

    def tick(self, now: float) -> TickReport:
        """One scheduler tick: plan every worker's pack (and shed what
        expired), hand the plan to ``on_plan``, then pack every worker,
        chunk all busy slabs (back-to-back, before any poll), then
        poll/retire.

        Each phase isolates worker faults (``WORKER_FAULT_TYPES``): a
        worker whose pack/chunk/poll raises is torn down via
        :meth:`_fail_worker` and its unretired requests come back in
        ``TickReport.failed`` — the surviving workers' tick proceeds
        untouched (self-healing serve, DESIGN.md §19)."""
        self.ticks += 1
        self._c_ticks.inc()
        shed: list[SolveRequest] = []
        packs: list[tuple[SlabWorker, list[SolveRequest]]] = []
        for w in list(self.workers):
            if not self.continuous and w.occupied():
                continue                # drain-to-empty baseline
            k = len(w.free_slots())
            incoming = self._take_local(w, k, now, shed)
            if len(incoming) < k and not w.local:
                incoming += self._steal(w, k - len(incoming), now, shed)
            if incoming:
                packs.append((w, incoming))
        plan = TickPlan(workers=[(w.wid, w.key) for w in self.workers],
                        packs=packs, shed=shed)
        if self.on_plan is not None:
            self.on_plan(plan)
        return self._run(plan)

    def follow(self, workers: list[tuple[int, SlabKey]],
               packs: list[tuple[int, list[SolveRequest]]]) -> TickReport:
        """Run a tick another scheduler planned (rank 0's, over ranks):
        the pool becomes ``workers`` ((wid, slab key) in tick order,
        spawning the new ones on this scheduler's programs), then each
        worker of ``packs`` ((wid, requests)) packs its requests and the
        tick runs as :meth:`tick` runs it.  Polls read replicated slab
        status only, so this pool retires what the planner's retires."""
        self.ticks += 1
        self._c_ticks.inc()
        have = {w.wid: w for w in self.workers}
        pool = []
        for wid, key in workers:
            w = have.get(wid)
            if w is None:
                prog = self._programs.get(key)
                if prog is None:
                    prog = self._programs[key] = self.make_program(key)
                w = SlabWorker(wid, key, prog, self.device)
            pool.append(w)
        self.workers = pool
        self._by_key = {}
        for w in pool:
            self._by_key.setdefault(w.key, []).append(w)
        self._next_wid = max([self._next_wid] + [w + 1 for w, _ in workers])
        by_wid = {w.wid: w for w in pool}
        return self._run(TickPlan(
            workers=workers, packs=[(by_wid[wid], reqs)
                                    for wid, reqs in packs], shed=[]))

    def _run(self, plan: TickPlan) -> TickReport:
        """The device half of a tick: the plan's packs, every busy slab's
        chunk, then the polls."""
        failed: list[SolveRequest] = []
        deaths: list[DeathEvent] = []
        for w, incoming in plan.packs:
            try:
                w.pack(incoming)
            except WORKER_FAULT_TYPES as e:
                # pack places requests into slots before touching
                # the program, so occupied() covers ``incoming``.
                failed.extend(self._fail_worker(w, e, deaths))
        # Chunks run back-to-back, every slab's before any poll.
        live: list[SlabWorker] = []
        new_states = []
        for w in [w for w in self.workers if w.occupied()]:
            try:
                if self.fault_injector is not None:
                    self.fault_injector(self.ticks, w)
                new_states.append(w.program.chunk(w.B_dev, w.state))
                live.append(w)
            except WORKER_FAULT_TYPES as e:
                failed.extend(self._fail_worker(w, e, deaths))
        for w, st in zip(live, new_states):
            w.state = st
        self.chunks_run += len(live)
        self._c_chunks.inc(len(live))
        retired: list[RetiredColumn] = []
        for w in live:
            try:
                retired.extend(w.poll())
            except WORKER_FAULT_TYPES as e:
                # An asynchronous device error surfaces at the poll's host
                # transfer — same teardown, minus whatever retired.
                failed.extend(self._fail_worker(w, e, deaths))
        return TickReport(retired=retired, shed=plan.shed,
                          chunks_run=len(live), failed=failed, deaths=deaths)

    # -------------------------------------------------------- telemetry --
    def reset_stats(self) -> None:
        """Zero event logs, chunk/utilization accounting and the backing
        registry series (``ticks`` keeps counting: the retirement log's
        tick column must stay monotone across a stats reset)."""
        self.chunks_run = 0
        self.steal_log.clear()
        self.shed_log.clear()
        self.death_log.clear()
        self._c_steals.reset()
        self._c_sheds.reset()
        self._c_chunks.reset()
        self._c_deaths.reset()
        for w in self.workers:
            w.occupied_slot_iters = 0
            w.capacity_slot_iters = 0

    def backlog(self) -> int:
        return sum(w.backlog() for w in self.workers)

    def in_flight(self) -> int:
        return sum(len(w.occupied()) for w in self.workers)

    def slot_utilization(self) -> float:
        cap = sum(w.capacity_slot_iters for w in self.workers)
        if not cap:
            return 0.0
        occ = sum(w.occupied_slot_iters for w in self.workers)
        return occ / cap

    def replicas(self, key: SlabKey | Hashable = None) -> int:
        if key is None:
            return len(self.workers)
        return len(self._by_key.get(key, ()))
