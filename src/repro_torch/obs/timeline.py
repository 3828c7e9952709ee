"""Chrome-trace timelines (counterpart of ``repro/obs/timeline.py``):
measured host phase spans, per-iteration telemetry decoded from the
solver's ring, and virtual-time serve replays, exported as catapult JSON
that loads in ``chrome://tracing`` or Perfetto.

Every process of the trace is labelled with its time base:

* measured spans (``Timeline.span``) are host wall-clock around work
  queued on the device, marked with ``torch.profiler.record_function`` so
  a profiler trace of the same run shows the same regions; wrap a
  ``torch.cuda.synchronize()`` inside the block when the span should
  cover the device's work, not only its enqueue;
* the telemetry track (``telemetry_track``) is in solver iterations;
* replay tracks (``replay_timeline``) are virtual-clock arithmetic:
  exact, deterministic, not wall time.

The JAX package's HLO schedule track (``hlo_schedule_track``) and
``solve_timeline`` read XLA's compiled schedule; they wait for a
profiler-trace counterpart (ROADMAP.md, queue 1 item 7).
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager

import numpy as np
import torch

from repro_torch.core.types import TelemetrySlab

# Process ids (one per time base) for the merged trace, the JAX package's
# numbers (its pid 2, the HLO schedule track, is not ported).
PID_HOST = 1        # measured host wall-clock (microseconds)
PID_TELEMETRY = 3   # solver iterations (index)
PID_REPLAY = 4      # virtual-clock replay (microseconds of virtual time)

_PROCESS_NAMES = {
    PID_HOST: "host phases [measured wall-clock]",
    PID_TELEMETRY: "solver telemetry [iteration index, NOT time]",
    PID_REPLAY: "serve replay [virtual clock]",
}


class Timeline:
    """A mutable catapult-JSON trace.  ``span``/``instant``/``counter``
    append events, ``merge`` combines timelines, ``to_chrome_trace`` /
    ``to_json`` / ``save`` export; metadata rides in the trace's
    ``metadata`` block."""

    def __init__(self, meta: dict | None = None):
        self.events: list[dict] = []
        self.meta: dict = dict(meta or {})
        self._pids: set[int] = set()

    # ------------------------------------------------------------ events --
    def _use(self, pid: int) -> None:
        self._pids.add(pid)

    @contextmanager
    def span(self, name: str, pid: int = PID_HOST, tid: int = 1,
             cat: str = "phase", args: dict | None = None):
        """Measured host span: wall clock around the block, marked for a
        profiler trace of the same run."""
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            try:
                yield self
            finally:
                dur = time.perf_counter() - t0
                self.add_span(name, ts_s=t0, dur_s=dur, pid=pid, tid=tid,
                              cat=cat, args=args)

    def add_span(self, name: str, ts_s: float, dur_s: float,
                 pid: int = PID_HOST, tid: int = 1, cat: str = "phase",
                 args: dict | None = None) -> None:
        """Complete-event span; ``ts_s``/``dur_s`` in the pid's time
        base."""
        self._use(pid)
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": ts_s * 1e6, "dur": dur_s * 1e6,
              "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, ts_s: float, pid: int = PID_HOST,
                tid: int = 1, cat: str = "event",
                args: dict | None = None) -> None:
        self._use(pid)
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": ts_s * 1e6, "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, ts_s: float, values: dict,
                pid: int = PID_HOST, tid: int = 1) -> None:
        """Counter sample (a stacked chart row)."""
        self._use(pid)
        self.events.append({"name": name, "ph": "C", "ts": ts_s * 1e6,
                            "pid": pid, "tid": tid, "args": values})

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        self._use(pid)
        self.events.append({"name": "thread_name", "ph": "M", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    def merge(self, other: "Timeline") -> "Timeline":
        self.events.extend(other.events)
        self.meta.update(other.meta)
        self._pids |= other._pids
        return self

    # ------------------------------------------------------------ export --
    def to_chrome_trace(self) -> dict:
        meta = dict(self.meta)
        # What ran the kernels: CUDA on a card, their plain PyTorch
        # versions on the CPU.
        meta.setdefault("kernel_mode", "compiled" if torch.cuda.is_available()
                        else "plain")
        meta.setdefault(
            "time_bases",
            {str(pid): _PROCESS_NAMES.get(pid, "custom")
             for pid in sorted(self._pids)})
        events = [{"name": "process_name", "ph": "M", "pid": pid,
                   "args": {"name": _PROCESS_NAMES.get(pid, f"pid {pid}")}}
                  for pid in sorted(self._pids)]
        return {"traceEvents": events + self.events,
                "displayTimeUnit": "ms", "metadata": meta}

    def to_json(self) -> str:
        """The exported trace as a JSON string (what ``save`` writes)."""
        return json.dumps(self.to_chrome_trace(), indent=1) + "\n"

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path


# ---------------------------------------------------------------- tracks --

def telemetry_track(telemetry, l: int) -> Timeline:
    """Per-iteration counter rows decoded from one solve's telemetry ring
    (``SolveResult.telemetry``, a tensor or an array): residual norm,
    in-flight handle age and, on governed solves, the gap estimate per
    iteration; restart, replacement and governor-action instants.  Rows in
    iteration order (the ring's "iter" column), never-written rows
    skipped."""
    tel = (telemetry.detach().cpu().numpy()
           if isinstance(telemetry, torch.Tensor) else np.asarray(telemetry))
    ts = TelemetrySlab(cap=tel.shape[-2], l=l)
    cols = ts.unpack(tel)
    tl = Timeline()
    tl.name_thread(PID_TELEMETRY, 1, "per-iteration telemetry")
    u = 1e-6
    order = np.argsort(cols["iter"], kind="stable")
    for r in order:
        it = float(cols["iter"][r])
        if it < 0:
            continue                      # never written
        vals = {"age": float(cols["age"][r])}
        if cols["rnorm"][r] >= 0:
            vals["rnorm"] = float(cols["rnorm"][r])
        if cols["gap"][r] > 0:
            vals["gap"] = float(cols["gap"][r])
        tl.counter("iteration", ts_s=it * u, values=vals,
                   pid=PID_TELEMETRY, tid=1)
        if cols["restart"][r] > 0:
            kind = ("replacement" if cols["replacement"][r] > 0
                    else "breakdown restart")
            tl.instant(kind, ts_s=it * u, pid=PID_TELEMETRY, tid=1,
                       cat="restart")
        act = float(cols["action"][r])
        if act > 0:
            kind = {1.0: "governor: gap-arm replacement",
                    2.0: "governor: patience-arm replacement",
                    3.0: "governor: stagnation declared"}.get(
                        act, f"governor: action {act:g}")
            tl.instant(kind, ts_s=it * u, pid=PID_TELEMETRY, tid=1,
                       cat="governor", args={"action": act})
    tl.meta["telemetry"] = {
        "units": "solver iteration index, NOT time",
        "cap": ts.cap, "k": ts.k, "l": l,
    }
    return tl


def replay_timeline(svc, rep=None) -> Timeline:
    """Virtual-time serve timeline from a service's logs: one row per
    slab worker, each retired request a span from submission to
    retirement, sheds and steals as instants.  Built only from the
    deterministic logs (``retirement_log``, ``steal_log``, ``shed_log``):
    the same seed and trace give byte-identical JSON."""
    tl = Timeline()
    tid_of: dict[int, int] = {}
    # Steal events carry a tick, not a time: anchor each to the first
    # retirement time seen at or after its tick.
    tick_t: dict[int, float] = {}
    for _req, _w, tick, t in svc.retirement_log:
        tick_t.setdefault(tick, t)

    def tid(worker: int) -> int:
        if worker not in tid_of:
            tid_of[worker] = worker + 1
            tl.name_thread(PID_REPLAY, worker + 1,
                           f"worker {worker}" if worker >= 0 else "shed")
        return tid_of[worker]

    for req_id, worker, tick, t in svc.retirement_log:
        rr = svc.results.get(req_id)
        lat = rr.latency_s if rr is not None else 0.0
        args = {"req_id": req_id, "tick": tick}
        if rr is not None:
            args.update(iters=rr.iters, converged=bool(rr.converged),
                        slo_met=bool(rr.slo_met))
        tl.add_span(f"req {req_id}", ts_s=t - lat, dur_s=lat,
                    pid=PID_REPLAY, tid=tid(worker), cat="request",
                    args=args)
    for ev in svc.scheduler.shed_log:
        tl.instant(f"shed req {ev.req_id}", ts_s=ev.t, pid=PID_REPLAY,
                   tid=tid(-1), cat="shed",
                   args={"waited_s": ev.waited_s, "worker": ev.worker})
    for ev in svc.scheduler.steal_log:
        anchors = [t for k, t in tick_t.items() if k >= ev.tick]
        tl.instant(f"steal req {ev.req_id}", ts_s=min(anchors, default=0.0),
                   pid=PID_REPLAY, tid=tid(ev.thief), cat="steal",
                   args={"tick": ev.tick, "victim": ev.victim})
    tl.meta["replay"] = {
        "units": "virtual-clock seconds (deterministic arithmetic, "
                 "not wall time)",
        "retired": len(svc.retirement_log),
        "shed": len(svc.scheduler.shed_log),
        "stolen": len(svc.scheduler.steal_log),
    }
    if rep is not None:
        tl.meta["replay"].update(goodput_per_s=rep.goodput_per_s,
                                 p99_s=rep.latency_p99_s,
                                 slot_utilization=rep.slot_utilization)
    return tl
