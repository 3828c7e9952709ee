"""Overlap tracer: the staggered in-flight reductions read from the port's
own schedule and from a profile (counterpart of ``repro/utils/trace.py``).

The p(l)-CG claim is structural: the fused dot block issued at iteration
i is first consumed at iteration i + l, so up to l global reductions are
in flight at once.  The JAX package reads this from XLA's scheduled HLO,
where the entry computation's instruction order is the schedule.  The
port's schedule is the host's issue order, so it is read there:

1.  ``traced_ops(ops, recorder)`` wraps a ``SolverOps``: ``start``,
    ``start_partials``, ``wait`` and ``advance`` call the originals
    unchanged and each call appends a :class:`ChainEvent` (its ``pos`` a
    running call index) and runs inside a ``torch.profiler.
    record_function`` range named ``plwin{k}/<tag>`` (the tags of
    ``core.types``).  The production ``SolverOps`` carries no tag: the
    wrapper exists only here, so a solve's arithmetic and host time stay
    as they are.
2.  ``plcg_overlap_report`` runs a window of ``window`` p(l)-CG
    iterations on the traced ops, each inside ``plwin{k}``, and
    :func:`analyze_overlap` pairs the events with the JAX tracer's
    arithmetic: chain k runs from window k's start to window k + l's
    wait, and the peak is measured at the wait events only.
3.  ``events_from_profile`` recovers the same events from a
    ``torch.profiler`` trace of the traced run, and ``device_overlap``
    reads each chain in time: from the end of the kernel that produced
    the dot block to the start of the first kernel that consumed it.

The port's iteration waits (the scalar phase) before it starts, so a
healthy p(l)-CG schedule reports exactly l chains in flight; classic CG,
whose two blocking dots are each waited in the window that issued them,
reports 1.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import statistics
import tempfile
from contextlib import contextmanager

import torch
from torch.profiler import record_function

from repro_torch.core.types import (GLRED_START_TAG, GLRED_WAIT_TAG, HALO_TAG,
                                    REDUCE_TAG)
from repro_torch.device import as_rhs

__all__ = ["WINDOW_SCOPE", "ChainEvent", "OverlapReport", "ScheduleRecorder",
           "traced_ops", "analyze_overlap", "plcg_window", "baseline_window",
           "plcg_overlap_report", "batched_plcg_overlap_report",
           "baseline_overlap_report", "chrome_trace", "events_from_profile",
           "device_kernels", "device_time_report", "ChainTiming",
           "DeviceOverlap", "device_overlap"]

# Window range prefix of the traced harness (the JAX tracer's scope name).
WINDOW_SCOPE = "plwin"

_RANGE_RE = re.compile(
    rf"^{WINDOW_SCOPE}(\d+)/({GLRED_START_TAG}|{GLRED_WAIT_TAG}|{HALO_TAG}"
    rf"|{REDUCE_TAG}(\d+))$")


@dataclasses.dataclass(frozen=True)
class ChainEvent:
    """One tagged site of the schedule."""

    kind: str          # "start" | "wait" | "halo" | "hop"
    window: int        # plwin{k} iteration index
    pos: int           # position in the schedule (host issue order)
    opcode: str        # the SolverOps call ("start", "start_partials",
                       # "wait", "advance"), or "range" from a profile
    name: str          # the record_function range, "plwin{k}/<tag>"
    hop: int | None = None   # ladder hop index (kind == "hop" only)


@dataclasses.dataclass
class OverlapReport:
    """In-flight reduction chains recovered from one schedule (the JAX
    report's fields; positions are host issue order, not HLO
    instructions)."""

    l: int                          # pipeline depth used for chain pairing
    window: int                     # traced iteration-window length
    events: list[ChainEvent]
    chains: list[tuple[int, int, int | None]]  # (window k, start, wait pos)
    max_in_flight: int              # peak #chains issued but not consumed
    n_collectives: int              # monolithic reduction starts
    collective_bytes: float         # their payload bytes
    # Reduction handles issued per traced window: every start call is one.
    starts_per_window: dict[int, int] = dataclasses.field(
        default_factory=dict)
    # Halo exchanges, and how many sit strictly inside an open chain
    # (after its start, before its wait).  One device with no partition
    # has none: 0/0.
    n_halo_permutes: int = 0
    halos_in_flight: int = 0
    # Staged ladder: hops per window, hop-0 events per window (one
    # logical handle entering the ladder an iteration), hops in all, and
    # hops strictly inside open chains.  All zero on monolithic schedules.
    reduce_hops_per_window: dict[int, int] = dataclasses.field(
        default_factory=dict)
    staged_starts_per_window: dict[int, int] = dataclasses.field(
        default_factory=dict)
    n_reduce_hops: int = 0
    hops_in_flight: int = 0

    def __str__(self) -> str:
        staged = ""
        if self.n_reduce_hops:
            staged = (f"; staged ladder: {self.n_reduce_hops} hop(s), "
                      f"{self.hops_in_flight} inside reduction windows, "
                      f"min {min(self.reduce_hops_per_window.values())}"
                      f"/window")
        lines = [
            f"overlap trace: window={self.window} depth l={self.l} -> "
            f"max {self.max_in_flight} reduction chain(s) in flight "
            f"({self.n_collectives} all-reduce(s), "
            f"{self.collective_bytes:.3e} B payload; "
            f"{self.halos_in_flight}/{self.n_halo_permutes} halo "
            f"permute(s) inside reduction windows{staged})"
        ]
        for k, s, w in self.chains:
            tail = f"waited @ {w}" if w is not None else "open at window end"
            lines.append(f"  chain {k:>3d}: issued @ instr {s:>5d}, {tail}")
        return "\n".join(lines)


class ScheduleRecorder:
    """The event list of a traced run.  Events are recorded only inside a
    window (:meth:`in_window`), as the JAX tracer keeps only instructions
    inside a ``plwin`` scope.

    A wait is filed under the window that consumes the chain it completes:
    the window its handle was issued in plus ``depth`` (the pairing depth:
    l for p(l)-CG, 0 for the solvers that wait in the window that issued).
    Handles complete in issue order, so this is the window the wait runs in
    whenever the solver waits where it reads, as every solver here does;
    a ``SolverOps`` that waits a handle inside its own start files the
    wait early in the order, as XLA's scheduler may hoist a consumption,
    and the report shows the serialisation."""

    def __init__(self, depth: int):
        self.depth = depth
        self.events: list[ChainEvent] = []
        self.window: int | None = None
        self.payload_bytes = 0.0
        self._issued: collections.deque[int] = collections.deque()

    @contextmanager
    def in_window(self, k: int):
        with record_function(f"{WINDOW_SCOPE}{k}"):
            self.window = k
            try:
                yield self
            finally:
                self.window = None

    @contextmanager
    def site(self, kind: str, opcode: str, tag: str, hop: int | None = None):
        """One call site: an event (inside a window) and a profiler range
        around the call."""
        k = self.window
        if k is not None and kind == "start":
            self._issued.append(k)
        elif k is not None and kind == "wait" and self._issued:
            k = self._issued.popleft() + self.depth
        name = tag if k is None else f"{WINDOW_SCOPE}{k}/{tag}"
        if k is not None:
            self.events.append(ChainEvent(kind, k, len(self.events), opcode,
                                          name, hop))
        with record_function(name):
            yield


def traced_ops(ops, recorder: ScheduleRecorder, ladder=None):
    """``ops`` with ``start``, ``start_partials``, ``wait`` and ``advance``
    recorded into ``recorder``; every call goes to the original unchanged.

    ``ladder`` (a ``parallel.reduction.StagedConfig``, the backend's
    ``reduction_cfg``) names the hops: advance step j runs the hops of
    ``hop_groups(P, stages)[j]``, each a ``hop`` event with its index
    (hop 0 is the handle's first wire movement, the staged start), and a
    wait runs the steps not yet advanced, as the wire's ``staged_wait``
    does.  Each hop is an empty range before the call that runs it.  On
    the ladder oracle the hops move nothing (one device, no wire): the
    events are where a P-rank run makes them."""
    from repro_torch.parallel.reduction import hop_groups

    groups = (hop_groups(ladder.n_shards, ladder.stages)
              if ladder is not None and ladder.n_shards > 1 else [])
    stages = len(groups)

    def mark_hops(steps, opcode):
        for step in steps:
            for k in groups[step] if step < stages else []:
                with recorder.site("hop", opcode, f"{REDUCE_TAG}{k}", hop=k):
                    pass

    def payload(h):
        if ladder is None and recorder.window is not None:
            recorder.payload_bytes += h.numel() * h.element_size()
        return h

    def start(mat, vec):
        with recorder.site("start", "start", GLRED_START_TAG):
            return payload(ops.start(mat, vec))

    def start_partials(partials):
        with recorder.site("start", "start_partials", GLRED_START_TAG):
            return payload(ops.start_partials(partials))

    def advance(handle, step):
        mark_hops([step], "advance")
        return ops.advance(handle, step)

    def wait(dots, advanced=0):
        mark_hops(range(advanced, stages), "wait")
        with recorder.site("wait", "wait", GLRED_WAIT_TAG):
            return ops.wait(dots, advanced=advanced)

    return dataclasses.replace(ops, dot_block_start=start,
                               dot_block_wait=wait,
                               dot_block_advance=advance,
                               combine_partials=start_partials)


def analyze_overlap(events, l: int, window: int | None = None,
                    payload_bytes: float = 0.0) -> OverlapReport:
    """Count outstanding chains at every consumption point: the JAX
    tracer's pairing (``repro.utils.trace.analyze_overlap``) on an event
    list in place of HLO text.

    Chain k is in flight from window k's first start to window k + l's
    first wait.  The peak is measured at the wait events only: at each,
    the chains already issued and not yet consumed (the chain waited
    counts; trailing chains whose wait lies past the window count when
    issued but never form a peak alone).  A serialised schedule (start,
    wait, start, wait, ...) reports 1, the paper's staggering l.
    ``payload_bytes`` is the monolithic starts' payload
    (``ScheduleRecorder.payload_bytes``); a schedule with ladder hops moves
    its payload by hops and counts no all-reduce."""
    events = sorted(events, key=lambda e: e.pos)
    starts: dict[int, ChainEvent] = {}
    waits: dict[int, ChainEvent] = {}
    starts_per_window: dict[int, int] = {}
    halos = [e for e in events if e.kind == "halo"]
    hops = [e for e in events if e.kind == "hop"]
    for e in events:
        if e.kind == "start":
            starts.setdefault(e.window, e)
            starts_per_window[e.window] = \
                starts_per_window.get(e.window, 0) + 1
        elif e.kind == "wait":
            waits.setdefault(e.window, e)
    if window is None:
        window = max(starts, default=-1) + 1

    chains: list[tuple[int, int, int | None]] = []
    for k, s in sorted(starts.items()):
        w = waits.get(k + l)
        chains.append((k, s.pos, w.pos if w else None))

    peak = 0
    for we in sorted(waits.values(), key=lambda e: e.pos):
        n = sum(1 for _k, spos, wpos in chains
                if spos <= we.pos and (wpos is None or wpos >= we.pos))
        peak = max(peak, n)

    def inside(e):
        return any(spos < e.pos and (wpos is None or e.pos < wpos)
                   for _k, spos, wpos in chains)

    hops_per_window: dict[int, int] = {}
    staged_starts: dict[int, int] = {}
    for e in hops:
        hops_per_window[e.window] = hops_per_window.get(e.window, 0) + 1
        if e.hop == 0:
            staged_starts[e.window] = staged_starts.get(e.window, 0) + 1
    kept = sorted(list(starts.values()) + list(waits.values()) + halos + hops,
                  key=lambda e: e.pos)
    return OverlapReport(
        l=l, window=window, events=kept, chains=chains, max_in_flight=peak,
        n_collectives=0 if hops else sum(starts_per_window.values()),
        collective_bytes=0.0 if hops else float(payload_bytes),
        starts_per_window=starts_per_window,
        n_halo_permutes=len(halos),
        halos_in_flight=sum(1 for e in halos if inside(e)),
        reduce_hops_per_window=hops_per_window,
        staged_starts_per_window=staged_starts,
        n_reduce_hops=len(hops),
        hops_in_flight=sum(1 for e in hops if inside(e)))


# ----------------------------------------------------------- the harness --

def plcg_window(ops, b, l: int, window: int, recorder=None, sigmas=None,
                fused_iteration: bool = False, telemetry_cap: int = 0,
                recurrence: str = "ghysels", governor=None):
    """``window`` p(l)-CG iterations of ``b`` from x0 = 0 (tol 0, so none
    stops), each inside ``recorder.in_window(k)`` when a recorder is given;
    returns the final state (its ``hist`` is the residual history)."""
    from repro_torch.core import pipelined_cg

    prog = pipelined_cg.build(ops, b, l, tol=0.0, maxit=window + l + 2,
                              sigmas=sigmas, fused_iteration=fused_iteration,
                              telemetry_cap=telemetry_cap,
                              recurrence=recurrence, governor=governor)
    st = prog.init(torch.zeros_like(b))
    for k in range(window):
        if recorder is None:
            st = prog.iteration(st)
        else:
            with recorder.in_window(k):
                st = prog.iteration(st)
    return st


def _report(backend, op, b, l, window, prec, slab, **build_kw):
    window = l + 2 if window is None else window
    if window < 1:
        raise ValueError("window must be >= 1")
    ladder = getattr(backend, "reduction_cfg", None)
    if slab and ladder is not None:
        raise NotImplementedError(
            "reduction='staged' has no batched form (ROADMAP.md, queue 1 "
            "item 5b)")
    rec = ScheduleRecorder(depth=l)
    plcg_window(traced_ops(backend.make_ops(op, prec), rec, ladder),
                as_rhs(b, backend.device), l, window, rec, **build_kw)
    return analyze_overlap(rec.events, l, window, rec.payload_bytes)


def plcg_overlap_report(backend, op, b, l: int, window: int | None = None,
                        sigmas=None, prec=None, fused_iteration: bool = False,
                        telemetry_cap: int = 0, recurrence: str = "ghysels",
                        governor=None) -> OverlapReport:
    """Trace ``window`` (default l + 2) p(l)-CG iterations through
    ``backend``'s ``SolverOps`` and report the in-flight chains.

    ``fused_iteration``, ``telemetry_cap``, ``recurrence`` and
    ``governor`` trace the superkernel path, the instrumented solve and
    the governed solve: the reduction structure must stay one start a
    window, consumed l windows later."""
    return _report(backend, op, b, l, window, prec, False, sigmas=sigmas,
                   fused_iteration=fused_iteration,
                   telemetry_cap=telemetry_cap, recurrence=recurrence,
                   governor=governor)


def batched_plcg_overlap_report(backend, op, B, l: int,
                                window: int | None = None, sigmas=None,
                                prec=None, fused_iteration: bool = False,
                                telemetry_cap: int = 0,
                                recurrence: str = "ghysels",
                                governor=None) -> OverlapReport:
    """The report of a slab ``B`` (s, n), one right-hand side a row: the
    staggering must survive batching (``max_in_flight`` as for one column)
    and the s columns' (s, 2l+1) payload must ride ONE start a window."""
    return _report(backend, op, B, l, window, prec, True, sigmas=sigmas,
                   fused_iteration=fused_iteration,
                   telemetry_cap=telemetry_cap, recurrence=recurrence,
                   governor=governor)


def baseline_window(ops, b, method: str, window: int, recorder=None):
    """``window`` iterations of classic CG (``method="cg"``) or Ghysels
    p-CG (``"pcg"``) from x0 = 0 (tol 0), each inside
    ``recorder.in_window(k)`` when a recorder is given; the final state."""
    from repro_torch.core import classic_cg, ghysels_pcg

    builders = {"cg": classic_cg.build, "pcg": ghysels_pcg.build}
    if method not in builders:
        raise ValueError(f"unknown baseline {method!r}: 'cg' or 'pcg'")
    prog = builders[method](ops, b, tol=0.0, maxit=window + 2)
    st = prog.init(torch.zeros_like(b))
    for k in range(window):
        if recorder is None:
            st = prog.step(st)
        else:
            with recorder.in_window(k):
                st = prog.step(st)
    return st


def baseline_overlap_report(backend, op, b, method: str, window: int = 4,
                            prec=None) -> OverlapReport:
    """The report of classic CG or Ghysels p-CG over ``window`` iterations,
    paired at depth 0: each of their reductions is waited in the iteration
    that issued it, so the peak is 1 (the paper's Table 1 contrast).
    Classic CG starts two blocking reductions an iteration, p-CG one."""
    rec = ScheduleRecorder(depth=0)
    ops = traced_ops(backend.make_ops(op, prec), rec,
                     getattr(backend, "reduction_cfg", None))
    baseline_window(ops, as_rhs(b, backend.device), method, window, rec)
    return analyze_overlap(rec.events, 0, window, rec.payload_bytes)


# ------------------------------------------------------------ the profile --

def chrome_trace(prof) -> dict:
    """A Chrome trace as a dict: given as one, as a path to an exported
    trace, or as a ``torch.profiler.profile`` (exported to a temporary
    file and read back once: a profile exports only once, so the dict is
    kept on it for the next call)."""
    if isinstance(prof, dict):
        return prof
    if isinstance(prof, (str, os.PathLike)):
        with open(prof) as f:
            return json.load(f)
    kept = getattr(prof, "_chrome_trace", None)
    if kept is not None:
        return kept
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            prof._chrome_trace = json.load(f)
    finally:
        os.remove(path)
    return prof._chrome_trace


def _ranges(trace: dict) -> list[dict]:
    """Host ``record_function`` ranges, in time order."""
    evs = [e for e in trace.get("traceEvents", [])
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(evs, key=lambda e: float(e["ts"]))


def events_from_profile(prof) -> list[ChainEvent]:
    """The traced run's chain events from its profile: each
    ``plwin{k}/<tag>`` range is one event, in time order (its ``pos``),
    with the window and hop index its name carries.  ``prof`` is a
    ``torch.profiler.profile`` of a run on :func:`traced_ops`, its
    exported Chrome trace, or that trace as a dict."""
    out = []
    for e in _ranges(chrome_trace(prof)):
        m = _RANGE_RE.match(e["name"])
        if m is None:
            continue
        tag = m.group(2)
        kind = {GLRED_START_TAG: "start", GLRED_WAIT_TAG: "wait",
                HALO_TAG: "halo"}.get(tag, "hop")
        out.append(ChainEvent(kind, int(m.group(1)), len(out), "range",
                              e["name"],
                              int(m.group(3)) if kind == "hop" else None))
    return out


def _correlation(e: dict):
    args = e.get("args") or {}
    return args.get("correlation", args.get("correlation id"))


def device_kernels(prof) -> list[dict]:
    """Every device kernel, copy and memset of a profile, in launch order:
    ``name``, device ``ts``/``dur`` (µs), the host ``launch_ts`` of the
    runtime call that launched it (matched by the profiler's correlation
    id) and ``range``, the innermost host ``record_function`` range around
    that launch (None outside every range)."""
    trace = chrome_trace(prof)
    evs = trace.get("traceEvents", [])
    launches = {}
    for e in evs:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver"):
            c = _correlation(e)
            if c is not None:
                launches[c] = float(e["ts"])
    ranges = [(float(r["ts"]), float(r["ts"]) + float(r.get("dur", 0.0)),
               r["name"]) for r in _ranges(trace)]
    out = []
    for e in evs:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy",
                                                      "gpu_memset"):
            continue
        t = launches.get(_correlation(e))
        if t is None:
            continue
        around = [r for r in ranges if r[0] <= t <= r[1]]
        inner = min(around, key=lambda r: r[1] - r[0])[2] if around else None
        out.append({"name": e["name"], "ts": float(e["ts"]),
                    "dur": float(e.get("dur", 0.0)), "launch_ts": t,
                    "range": inner})
    out.sort(key=lambda k: k["launch_ts"])
    return out


@dataclasses.dataclass(frozen=True)
class ChainTiming:
    """One chain read in device time (µs)."""

    window: int
    producer: str              # the kernel that produced the dot block
    consumer: str | None       # the first kernel that consumed it
    hide_us: float | None      # producer's end to consumer's start
    busy_us: float | None      # device-busy time inside that interval


@dataclasses.dataclass
class DeviceOverlap:
    """The chains of a report read in time, and the NCCL kernels'
    overlap with compute (None when the profile has no NCCL kernel)."""

    chains: list[ChainTiming]
    nccl_kernels: int = 0
    nccl_us: float = 0.0
    nccl_overlap_us: float | None = None

    def summary(self) -> dict:
        """Median, least and most over the consumed chains of the hiding
        interval and of the busy µs inside it."""
        done = [c for c in self.chains if c.hide_us is not None]

        def stats(vals):
            if not vals:
                return None
            return {"median": statistics.median(vals), "min": min(vals),
                    "max": max(vals)}

        return {"chains": len(done),
                "hide_us": stats([c.hide_us for c in done]),
                "busy_us": stats([c.busy_us for c in done]),
                "nccl_kernels": self.nccl_kernels, "nccl_us": self.nccl_us,
                "nccl_overlap_us": self.nccl_overlap_us}


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _covered(merged, a: float, b: float) -> float:
    return sum(max(0.0, min(y, b) - max(x, a)) for x, y in merged)


def _first_ranges(trace: dict) -> dict[str, tuple[float, float]]:
    first: dict[str, tuple[float, float]] = {}
    for r in _ranges(trace):
        first.setdefault(r["name"], (float(r["ts"]),
                                     float(r["ts"]) + float(r.get("dur", 0))))
    return first


def device_time_report(report: OverlapReport, prof) -> OverlapReport:
    """``report`` with its positions in device µs from the profile's first
    kernel: a start where the kernel that produced its dot block ended, a
    wait where the first kernel launched from its range on began, a hop
    or halo where the first kernel launched from its range on began (or
    the range's own time where none was).  Its chains are then the hiding
    intervals; ``obs.timeline.schedule_track(..., units="device µs")``
    draws them."""
    trace = chrome_trace(prof)
    kernels = device_kernels(trace)
    if not kernels:
        raise ValueError("the profile holds no device kernel")
    t0 = min(k["ts"] for k in kernels)
    first = _first_ranges(trace)

    def after(t):
        k = next((k for k in kernels if k["launch_ts"] >= t), None)
        return None if k is None else k["ts"]

    def at(e):
        rng = first.get(e.name)
        if rng is None:
            raise ValueError(f"the profile has no range {e.name!r}")
        if e.kind == "start":
            prod = [k for k in kernels if k["launch_ts"] <= rng[1]]
            t = prod[-1]["ts"] + prod[-1]["dur"] if prod else rng[1]
        else:
            t = after(rng[0])
            t = rng[0] if t is None else t
        return t - t0

    pos = {e.pos: at(e) for e in report.events}
    return dataclasses.replace(
        report,
        events=[dataclasses.replace(e, pos=pos[e.pos])
                for e in report.events],
        chains=[(k, pos[s], None if w is None else pos[w])
                for k, s, w in report.chains])


def device_overlap(report: OverlapReport, prof) -> DeviceOverlap:
    """Each chain of ``report`` read in the profile of the same traced
    run: the device µs from the end of the kernel that produced the dot
    block (the last one launched by the end of the chain's start range)
    to the start of the first kernel launched from its wait range on,
    the time a real MPI_Iallreduce would have to hide in, and the
    device-busy µs inside it; and the NCCL kernels' µs that overlap
    compute kernels, where the profile has any."""
    trace = chrome_trace(prof)
    kernels = device_kernels(trace)
    first = _first_ranges(trace)
    nccl = [k for k in kernels if "nccl" in k["name"].lower()]
    compute = _union([(k["ts"], k["ts"] + k["dur"]) for k in kernels
                      if "nccl" not in k["name"].lower()])
    busy = _union([(k["ts"], k["ts"] + k["dur"]) for k in kernels])
    launched = [k["launch_ts"] for k in kernels]

    chains = []
    for k, _s, _w in report.chains:
        s_rng = first.get(f"{WINDOW_SCOPE}{k}/{GLRED_START_TAG}")
        if s_rng is None:
            raise ValueError(f"the profile has no start range of window {k}: "
                             "is it a profile of the same traced run?")
        prod = [x for x, t in zip(kernels, launched) if t <= s_rng[1]]
        if not prod:
            continue
        p = prod[-1]
        p_end = p["ts"] + p["dur"]
        w_rng = first.get(f"{WINDOW_SCOPE}{k + report.l}/{GLRED_WAIT_TAG}")
        cons = None if w_rng is None else next(
            (x for x, t in zip(kernels, launched) if t >= w_rng[0]), None)
        if cons is None:
            chains.append(ChainTiming(k, p["name"], None, None, None))
            continue
        chains.append(ChainTiming(
            k, p["name"], cons["name"], cons["ts"] - p_end,
            _covered(busy, p_end, cons["ts"])))
    return DeviceOverlap(
        chains=chains, nccl_kernels=len(nccl),
        nccl_us=sum(k["dur"] for k in nccl),
        nccl_overlap_us=(sum(_covered(compute, k["ts"], k["ts"] + k["dur"])
                             for k in nccl) if nccl else None))
