"""The port's overlap tracer (``repro_torch.utils.trace``) against the JAX
package's (``repro.utils.trace``).

* The pairing: the port's ``analyze_overlap`` on ``ChainEvent`` lists and
  JAX's on the same schedules rendered as HLO text (the format of
  tests/test_trace_analysis.py), field for field, exactly: 24 schedules
  drawn from a numpy seed (starts, waits, halos and hops interleaved over
  windows 0..l+3, l = 1..5) and that file's three cases.
* Real solves on ``Stencil2D5(16, 16)`` with the plain twins: p(l)-CG
  reports exactly l chains in flight (the JAX tests' bound is >= l) and
  one start a window, fused and unfused, with the ring and governed; the
  ladder oracle one staged start and its hops in every window; a slab of
  4 one start a window; classic CG, p-CG and serialised ops report 1; the
  traced history is bitwise the untraced one.
* The profile side on Chrome-trace dicts built here (no profiler runs on
  the CPU); one ``cuda`` test profiles a fused p(2)-CG window on a card.
"""

import dataclasses
import importlib.util

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# A card's machine has no JAX and runs only the cuda tests.
HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    from repro.utils.trace import analyze_overlap as janalyze

from repro_torch.core.chebyshev import shifts_for_operator  # noqa: E402
from repro_torch.linalg import JacobiPrec, Stencil2D5  # noqa: E402
from repro_torch.parallel.backends import LocalBackend  # noqa: E402
from repro_torch.parallel.reduction import hop_groups  # noqa: E402
from repro_torch.utils import trace as T  # noqa: E402


@pytest.fixture
def with_jax():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the reference")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


# ----------------------------------------------------------- the pairing --

_SCOPE = {"start": "glred_start", "wait": "glred_wait", "halo": "halo_xchg"}
_OPCODE = {"start": "all-reduce", "wait": "fusion",
           "halo": "collective-permute", "hop": "collective-permute"}


def _render(schedule, K=5):
    """(HLO text, port events) of one schedule: a list of (kind, window,
    hop).  Position 0 of the HLO entry is its parameter, so event i sits
    at position i + 1 in both."""
    lines = ["HloModule synthetic", "",
             f"ENTRY %main (p0: f64[{K}]) -> f64[{K}] {{",
             f"  %p0 = f64[{K}]{{0}} parameter(0)"]
    events = []
    for i, (kind, k, hop) in enumerate(schedule):
        tag = f"glred_hop{hop}" if kind == "hop" else _SCOPE[kind]
        lines.append(f'  %e.{i} = f64[{K}]{{0}} {_OPCODE[kind]}(%p0), '
                     f'metadata={{op_name="jit(h)/plwin{k}/{tag}/op"}}')
        events.append(T.ChainEvent(kind, k, i + 1, kind, f"plwin{k}/{tag}",
                                   hop if kind == "hop" else None))
    return "\n".join(lines + ["}"]), events


def _draw(rng, l):
    """A random interleaving over windows 0..l+3: per window 0-2 starts,
    0-2 waits, 0-3 halos and 0-3 hops (indices 0-3), shuffled over the
    whole schedule."""
    sched = []
    for k in range(l + 4):
        sched += [("start", k, None)] * int(rng.integers(0, 3))
        sched += [("wait", k, None)] * int(rng.integers(0, 3))
        sched += [("halo", k, None)] * int(rng.integers(0, 4))
        sched += [("hop", k, int(rng.integers(0, 4)))
                  for _ in range(int(rng.integers(0, 4)))]
    order = rng.permutation(len(sched))
    return [sched[i] for i in order]


def _fields(rep):
    return (rep.max_in_flight, rep.chains, rep.halos_in_flight,
            rep.hops_in_flight, rep.n_halo_permutes, rep.n_reduce_hops,
            rep.starts_per_window, rep.reduce_hops_per_window,
            rep.staged_starts_per_window, rep.window)


@pytest.mark.parametrize("seed", range(24))
def test_pairing_equals_jax_on_seeded_schedules(with_jax, seed):
    """Exact equality of every pairing field (integers and dicts)."""
    rng = np.random.default_rng(1000 + seed)
    l = 1 + seed % 5
    hlo, events = _render(_draw(rng, l))
    window = l + 4
    assert _fields(T.analyze_overlap(events, l, window)) == \
        _fields(janalyze(hlo, l, window))


def _serialised(l, n):
    sched = []
    for k in range(n):
        sched += [("start", k, None), ("wait", k + l, None)]
    return sched


def _staggered(l, window, interleaved):
    sched = [("start", k, None) for k in range(l if interleaved else window)]
    for k in range(l, window):
        sched.append(("wait", k, None))
        if interleaved:
            sched.append(("start", k, None))
    return sched


@pytest.mark.parametrize("case,l,window,peak", [
    ("serialised", 3, 5, 1),
    ("all issues first", 3, 5, 5),
    ("interleaved steady state", 3, 5, 3),
    ("no waits", 3, 2, 0),
])
def test_trace_analysis_cases(with_jax, case, l, window, peak):
    """tests/test_trace_analysis.py's cases: serialised 1, staggered l (all
    issued chains when every issue comes first), no waits 0."""
    sched = {"serialised": lambda: _serialised(l, window),
             "all issues first": lambda: _staggered(l, window, False),
             "interleaved steady state": lambda: _staggered(l, window, True),
             "no waits": lambda: [("start", k, None) for k in range(2)],
             }[case]()
    hlo, events = _render(sched)
    rep = T.analyze_overlap(events, l, window)
    assert rep.max_in_flight == peak, str(rep)
    assert _fields(rep) == _fields(janalyze(hlo, l, window))


# ------------------------------------------------------------ real solves --

def _problem(l):
    op = Stencil2D5(16, 16, device="cpu")
    prec = JacobiPrec.from_operator(op)
    b = torch.tensor(np.random.default_rng(0).standard_normal(op.n))
    return op, prec, b, shifts_for_operator(op, l, prec=prec)


def _one_start_a_window(rep):
    return rep.starts_per_window == {k: 1 for k in range(rep.window)}


@pytest.mark.parametrize("variant", ["unfused", "fused", "ring", "governed"])
@pytest.mark.parametrize("l", [1, 2, 3, 4])
def test_plcg_reports_l_in_flight(l, variant):
    """Exactly l chains in flight (the port waits before it starts, so the
    peak is l, never more) and one start in every window of l + 2."""
    from repro_torch.stability import GovernorConfig

    op, prec, b, sig = _problem(l)
    kw = {"unfused": {}, "fused": dict(fused_iteration=True),
          "ring": dict(fused_iteration=True, telemetry_cap=16),
          "governed": dict(recurrence="stable",
                           governor=GovernorConfig())}[variant]
    rep = T.plcg_overlap_report(LocalBackend(device="cpu"), op, b, l,
                                sigmas=sig, prec=prec, **kw)
    assert rep.window == l + 2
    assert rep.max_in_flight == l, str(rep)
    assert _one_start_a_window(rep), rep.starts_per_window
    assert rep.n_collectives == l + 2
    assert rep.collective_bytes == (l + 2) * (2 * l + 1) * 8
    assert (rep.n_halo_permutes, rep.halos_in_flight) == (0, 0)
    assert rep.n_reduce_hops == 0


@pytest.mark.parametrize("l", [2, 3])
def test_ladder_oracle_hops_every_window(l):
    """The ladder oracle over 4 virtual shards (2 stages: hop groups [0, 1]
    and [2]).  Each iteration advances the handle issued k iterations ago
    by step k - 1, k = 1..l-1 (core/pipelined_cg.py's advance loop), so
    every window runs the hops of steps 0..min(l-1, 2)-1, and a window that
    waits (k >= l) the steps the pipeline could not advance: l = 2 gives
    2 hops in windows 0-1 and 3 in windows 2-3, l = 3 gives 3 in every
    window.  Hop 0 once a window: one staged start an iteration."""
    op, prec, b, sig = _problem(l)
    be = LocalBackend(device="cpu", reduction="staged", virtual_shards=4)
    rep = T.plcg_overlap_report(be, op, b, l, sigmas=sig, prec=prec)
    groups = hop_groups(4, 2)
    adv = sum(len(g) for g in groups[:min(l - 1, len(groups))])
    rest = sum(len(g) for g in groups[l - 1:])
    want = {k: adv + (rest if k >= l else 0) for k in range(rep.window)}
    assert rep.reduce_hops_per_window == want
    assert want == ({0: 2, 1: 2, 2: 3, 3: 3} if l == 2
                    else {k: 3 for k in range(5)})
    assert rep.staged_starts_per_window == {k: 1 for k in range(rep.window)}
    assert rep.max_in_flight == l, str(rep)
    assert _one_start_a_window(rep)
    assert rep.n_collectives == 0 and rep.hops_in_flight > 0


def test_slab_one_start_a_window():
    l = 2
    op, prec, b, sig = _problem(l)
    B = torch.stack([b, 2 * b, b + 1, -b])
    rep = T.batched_plcg_overlap_report(LocalBackend(device="cpu"), op, B,
                                        l, sigmas=sig, prec=prec,
                                        fused_iteration=True)
    assert rep.max_in_flight == l, str(rep)
    assert _one_start_a_window(rep)
    # ONE handle a window carries the 4 columns' (4, 2l+1) payload.
    assert rep.collective_bytes == rep.window * 4 * (2 * l + 1) * 8


@pytest.mark.parametrize("method,starts", [("cg", 2), ("pcg", 1)])
def test_baselines_report_one(method, starts):
    """Classic CG waits each of its two blocking dots where it issues it;
    p-CG waits its one dot block in the same iteration: 1 in flight."""
    op, prec, b, _ = _problem(1)
    rep = T.baseline_overlap_report(LocalBackend(device="cpu"), op, b,
                                    method, prec=prec)
    assert rep.max_in_flight == 1, str(rep)
    assert rep.starts_per_window == {k: starts for k in range(4)}


def _serialise(t):
    """Ops that wait each handle inside its start (a blocking reduction),
    the solver's own wait then a no-op."""
    return dataclasses.replace(
        t, dot_block_start=lambda m, v: t.wait(t.start(m, v)),
        combine_partials=lambda p: t.wait(t.start_partials(p)),
        dot_block_wait=lambda d, advanced=0: d)


@pytest.mark.parametrize("l", [1, 2, 3])
def test_serialised_ops_report_one(l):
    """The measure can fail: each chain consumed before the next issue."""
    op, prec, b, sig = _problem(l)
    rec = T.ScheduleRecorder(depth=l)
    ops = _serialise(T.traced_ops(
        LocalBackend(device="cpu").make_ops(op, prec), rec))
    T.plcg_window(ops, b, l, l + 2, rec, sigmas=sig, fused_iteration=True)
    rep = T.analyze_overlap(rec.events, l, l + 2)
    assert rep.max_in_flight == 1, str(rep)
    assert [c[2] - c[1] for c in rep.chains] == [1] * (l + 2)


@pytest.mark.parametrize("fused", [False, True])
def test_traced_history_bitwise_untraced(fused):
    l = 2
    op, prec, b, sig = _problem(l)
    be = LocalBackend(device="cpu")
    rec = T.ScheduleRecorder(depth=l)
    st_t = T.plcg_window(T.traced_ops(be.make_ops(op, prec), rec), b, l, 12,
                         rec, sigmas=sig, fused_iteration=fused)
    st_p = T.plcg_window(be.make_ops(op, prec), b, l, 12, sigmas=sig,
                         fused_iteration=fused)
    assert torch.equal(st_t.hist, st_p.hist)
    assert torch.equal(st_t.cyc.S, st_p.cyc.S)
    assert len(rec.events) == 12 + 10          # 12 starts, 10 waits


# ------------------------------------------------------------ the profile --

def _synthetic_trace(events, kernel_us=3.0):
    """A Chrome trace as torch.profiler exports it, for a traced run whose
    events are ``events``: a ``plwin{k}`` range around each window, one
    range an event, 10 µs apart, and in each start range the launch of a
    "dots" kernel; a "body" kernel launched between consecutive events,
    and one NCCL kernel overlapping the first body kernel."""
    tev, corr, t = [], 0, 100.0
    kern = []

    def launch(name, ts, dev_ts, dur):
        nonlocal corr
        corr += 1
        tev.append({"ph": "X", "cat": "cuda_runtime",
                    "name": "cudaLaunchKernel", "ts": ts, "dur": 1.0,
                    "args": {"correlation": corr}})
        kern.append({"ph": "X", "cat": "kernel", "name": name, "ts": dev_ts,
                     "dur": dur, "args": {"correlation": corr}})

    spans = {}
    for e in events:
        tev.append({"ph": "X", "cat": "user_annotation", "name": e.name,
                    "ts": t, "dur": 5.0})
        if e.kind == "start":
            launch("dots", t + 1.0, 2 * t, kernel_us)
        launch("body", t + 7.0, 2 * t + 8.0, kernel_us)
        lo, hi = spans.get(e.window, (t, t))
        spans[e.window] = (min(lo, t), max(hi, t + 6.0))
        t += 10.0
    for k, (lo, hi) in spans.items():
        tev.append({"ph": "X", "cat": "user_annotation",
                    "name": f"plwin{k}", "ts": lo - 0.5,
                    "dur": hi - lo + 1.0})
    # The profiler's device-side copies of the ranges are no host range.
    tev.append({"ph": "X", "cat": "gpu_user_annotation",
                "name": events[0].name, "ts": 0.0, "dur": 1.0})
    kern.append({"ph": "X", "cat": "kernel", "name": "ncclDevKernel_X",
                 "ts": 2 * 100.0 + 9.0, "dur": 4.0,
                 "args": {"correlation": 9999}})
    tev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": 99.0, "dur": 1.0, "args": {"correlation": 9999}})
    return {"traceEvents": tev + kern}


def _recorded(l=2, window=6):
    op, prec, b, sig = _problem(l)
    rec = T.ScheduleRecorder(depth=l)
    T.plcg_window(T.traced_ops(LocalBackend(device="cpu").make_ops(op, prec),
                               rec), b, l, window, rec, sigmas=sig)
    return rec


def test_events_from_profile_same_chains_as_recorder():
    rec = _recorded()
    trace = _synthetic_trace(rec.events)
    got = T.events_from_profile(trace)
    assert [(e.kind, e.window, e.pos, e.name, e.hop) for e in got] == \
        [(e.kind, e.window, e.pos, e.name, e.hop) for e in rec.events]
    a = T.analyze_overlap(got, 2, 6)
    b = T.analyze_overlap(rec.events, 2, 6)
    assert (a.chains, a.max_in_flight, a.starts_per_window) == \
        (b.chains, b.max_in_flight, b.starts_per_window)
    ks = T.device_kernels(trace)
    assert [k["range"] for k in ks if k["name"] == "dots"] == \
        [e.name for e in rec.events if e.kind == "start"]


def test_device_overlap_reads_each_chain_in_time():
    """With events 10 µs apart on the host, kernels at twice the host time:
    a chain's dots kernel ends 3 µs after 2 t_start, and its consumer is
    the first kernel launched from its wait range, the body kernel at
    2 t_wait + 8.  Busy time inside: the 3 µs kernels in between."""
    rec = _recorded()
    rep = T.analyze_overlap(rec.events, 2, 6)
    trace = _synthetic_trace(rec.events)
    ov = T.device_overlap(rep, trace)
    t = {e.name: 100.0 + 10.0 * e.pos for e in rec.events}
    kerns = T.device_kernels(trace)
    for c in ov.chains:
        if c.hide_us is None:
            continue
        ts_s = 2 * t[f"plwin{c.window}/glred_start"]
        ts_w = 2 * t[f"plwin{c.window + 2}/glred_wait"] + 8.0
        assert c.producer == "dots" and c.consumer == "body"
        assert c.hide_us == pytest.approx(ts_w - (ts_s + 3.0), abs=1e-9)
        # the union of the kernels' intervals, clipped to the interval
        grid = np.arange(ts_s + 3.0, ts_w, 0.5) + 0.25
        want = 0.5 * sum(any(k["ts"] <= x < k["ts"] + k["dur"]
                             for k in kerns) for x in grid)
        assert c.busy_us == pytest.approx(want, abs=1e-9)
    summ = ov.summary()
    assert summ["chains"] == 4            # chains 0-3; 4-5 open
    assert summ["nccl_kernels"] == 1 and summ["nccl_us"] == 4.0
    # the NCCL kernel (209-213) overlaps the first body kernel (208-211)
    assert summ["nccl_overlap_us"] == pytest.approx(2.0, abs=1e-9)
    timed = T.device_time_report(rep, trace)
    assert [c[0] for c in timed.chains] == [c[0] for c in rep.chains]
    k0 = timed.chains[0]
    assert k0[2] - k0[1] == pytest.approx(ov.chains[0].hide_us, abs=1e-9)


class _OnceProfile:
    """Stands for a torch.profiler.profile: its trace exports once."""

    def __init__(self, trace):
        self.trace, self.exported = trace, 0

    def export_chrome_trace(self, path):
        import json

        if self.exported:
            raise RuntimeError("Trace is already saved.")
        self.exported += 1
        with open(path, "w") as f:
            json.dump(self.trace, f)


def test_a_profile_is_read_once_and_kept():
    rec = _recorded()
    prof = _OnceProfile(_synthetic_trace(rec.events))
    got = T.events_from_profile(prof)
    ov = T.device_overlap(T.analyze_overlap(rec.events, 2, 6), prof)
    assert prof.exported == 1 and len(got) == len(rec.events)
    assert ov.summary()["chains"] == 4


@pytest.mark.cuda
def test_profile_chains_equal_recorder_on_card(cuda_device):
    """A fused p(2)-CG window on the card under torch.profiler: the
    profile's events are the recorder's, and every consumed chain has a
    positive hiding interval."""
    from torch.profiler import ProfilerActivity, profile

    op = Stencil2D5(64, 64, device=cuda_device)
    prec = JacobiPrec.from_operator(op)
    b = torch.tensor(np.random.default_rng(0).standard_normal(op.n),
                     device=cuda_device)
    sig = shifts_for_operator(op, 2, prec=prec)
    be = LocalBackend()
    T.plcg_window(be.make_ops(op, prec), b, 2, 8, sigmas=sig,
                  fused_iteration=True)          # builds and warms up
    torch.cuda.synchronize()
    rec = T.ScheduleRecorder(depth=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        T.plcg_window(T.traced_ops(be.make_ops(op, prec), rec), b, 2, 16,
                      rec, sigmas=sig, fused_iteration=True)
        torch.cuda.synchronize()
    got = T.events_from_profile(prof)
    assert [(e.kind, e.window, e.hop) for e in got] == \
        [(e.kind, e.window, e.hop) for e in rec.events]
    rep = T.analyze_overlap(rec.events, 2, 16)
    assert T.analyze_overlap(got, 2, 16).chains == rep.chains
    ov = T.device_overlap(rep, prof)
    done = [c for c in ov.chains if c.hide_us is not None]
    assert len(done) == 14 and all(c.hide_us > 0 for c in done)
