"""The port's Chrome-trace timelines (``repro_torch.obs.timeline``) against
the JAX package's: the exported catapult JSON is valid, the telemetry
track of one ring is the JAX package's track of the same ring, event for
event, and replay timelines are byte-deterministic.  Mirrors
tests/test_obs_timeline.py's structure, replay-determinism and shed
tests; its HLO-schedule tests wait for a profiler-trace counterpart
(ROADMAP.md, queue 1 item 7).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

from repro.core.chebyshev import shifts_for_operator as jshifts  # noqa: E402
from repro.linalg import Stencil2D5 as JStencil  # noqa: E402
from repro.obs.timeline import telemetry_track as jtelemetry_track  # noqa: E402
from repro.parallel import get_backend as jget_backend  # noqa: E402
from repro.stability import GovernorConfig as JGov  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.types import TelemetrySlab  # noqa: E402
from repro_torch.linalg import Stencil2D5  # noqa: E402
from repro_torch.obs import Timeline, replay_timeline, telemetry_track  # noqa: E402
from repro_torch.parallel.backends import LocalBackend  # noqa: E402
from repro_torch.serve import ConfigError, SolverService, VirtualClock  # noqa: E402
from repro_torch.serve.replay import TrafficClass, poisson_trace, replay  # noqa: E402
from repro_torch.stability import GovernorConfig  # noqa: E402


def test_timeline_chrome_trace_structure(tmp_path):
    tl = Timeline()
    with tl.span("phase-a"):
        pass
    tl.instant("evt", ts_s=0.5)
    tl.counter("c", ts_s=0.5, values={"v": 1})
    doc = tl.to_chrome_trace()
    assert doc["metadata"]["kernel_mode"] in ("compiled", "plain")
    assert "time_bases" in doc["metadata"]
    phs = {e["ph"] for e in doc["traceEvents"]}
    assert {"X", "i", "C", "M"} <= phs
    p = tl.save(str(tmp_path / "t.json"))
    with open(p) as f:
        assert json.load(f) == json.loads(tl.to_json())


def test_telemetry_track_equals_jax_for_one_ring():
    """One governed ring (from a JAX solve, so it holds restarts,
    replacements, gaps and governor actions) fed to both packages'
    ``telemetry_track`` exports the same events and metadata; the JSON
    strings are equal but for ``kernel_mode``, which names what ran the
    kernels.  The port's own ring of the same solve decodes to a track
    with the same event kinds at the same iterations."""
    jop = JStencil(32, 24)
    b = np.random.default_rng(3).standard_normal(jop.n)
    sig = np.asarray(jshifts(jop, 2))
    kw = dict(method="plcg", l=2, tol=1e-8, maxit=400,
              recurrence="stable", telemetry_cap=128)
    rj = jget_backend("local").solve(jop, jnp.asarray(b),
                                     sigmas=jnp.asarray(sig),
                                     governor=JGov(), **kw)
    ring = np.asarray(rj.telemetry)
    assert (ring[:, 8] > 0).any() and (ring[:, 5] > 0).any()
    tj, tt = jtelemetry_track(ring, l=2), telemetry_track(ring, l=2)
    assert tt.events == tj.events
    assert tt.meta == tj.meta
    dj, dt = tj.to_chrome_trace(), tt.to_chrome_trace()
    dj["metadata"].pop("kernel_mode")
    dt["metadata"].pop("kernel_mode")
    assert json.dumps(dt, indent=1) == json.dumps(dj, indent=1)

    top = convert.operator("stencil2d5", nx=32, ny=24, device="cpu")
    rt = LocalBackend(device="cpu").solve(
        top, b, sigmas=convert.sigmas(sig, "cpu"), governor=GovernorConfig(),
        **kw)
    own = telemetry_track(rt.telemetry, l=2)

    def kinds(tl):
        return [(e["name"], e["ts"]) for e in tl.events if e["ph"] == "i"]

    assert kinds(own) == kinds(tj)


def _replay_once():
    op = Stencil2D5(8, 8, device="cpu")
    svc = SolverService(LocalBackend(device="cpu"), s=2, method="plcg", l=2,
                        chunk_iters=40, maxit=300, clock=VirtualClock())
    svc.register_operator("lap", op)
    classes = [TrafficClass(op_key="lap", n=op.n, tol=1e-8,
                            deadline_s=0.5)]
    trace = poisson_trace(classes, rate_per_s=50.0, n_requests=10, seed=4)
    rep = replay(svc, trace, iter_time_s=1e-4, tick_overhead_s=1e-4)
    return svc, rep


def test_replay_timeline_deterministic(tmp_path):
    """Two same-seed replays on fresh services export byte-identical
    timeline JSON (virtual clock: pure arithmetic)."""
    paths = []
    for k in range(2):
        svc, rep = _replay_once()
        p = str(tmp_path / f"replay{k}.json")
        replay_timeline(svc, rep).save(p)
        paths.append(p)
    b0, b1 = (open(p, "rb").read() for p in paths)
    assert b0 == b1
    doc = json.loads(b0)
    spans = [e for e in doc["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "request"]
    assert len(spans) == doc["metadata"]["replay"]["retired"] > 0
    assert "virtual-clock" in doc["metadata"]["replay"]["units"]
    assert doc["metadata"]["replay"]["goodput_per_s"] == rep.goodput_per_s


def test_replay_timeline_renders_sheds():
    """Deadline-starved traffic: shed instants appear on the shed row (the
    virtual clock moves past the deadlines before the first tick, so the
    requests are shed; the JAX test's clock stands still and may shed
    none)."""
    op = Stencil2D5(8, 8, device="cpu")
    clock = VirtualClock()
    svc = SolverService(LocalBackend(device="cpu"), s=2, method="plcg", l=2,
                        chunk_iters=40, maxit=300, clock=clock)
    svc.register_operator("lap", op)
    rng = np.random.default_rng(0)
    for _ in range(6):
        svc.submit("lap", rng.standard_normal(op.n), deadline_s=1e-9)
    clock.sleep(1e-3)
    svc.drain()
    tl = replay_timeline(svc)
    sheds = [e for e in tl.events if e.get("cat") == "shed"]
    assert len(sheds) == len(svc.scheduler.shed_log) > 0
    assert svc.shed == len(sheds)


def test_served_requests_carry_their_rings():
    """A service with ``telemetry_cap`` hands each retired request its own
    ring, which decodes to the request's updates; the solutions are
    bitwise those of the service without the ring, and telemetry_cap on
    a method other than plcg is a ConfigError."""
    op = Stencil2D5(8, 8, device="cpu")
    rng = np.random.default_rng(1)
    bs = [rng.standard_normal(op.n) for _ in range(5)]
    out = {}
    for cap in (0, 64):
        svc = SolverService(LocalBackend(device="cpu"), s=2, method="plcg",
                            l=2, chunk_iters=16, maxit=300,
                            clock=VirtualClock(), telemetry_cap=cap)
        svc.register_operator("lap", op)
        ids = [svc.submit("lap", bb) for bb in bs]
        res = svc.drain()
        out[cap] = [res[i] for i in ids]
    for plain, inst in zip(out[0], out[64]):
        assert plain.telemetry is None
        assert np.array_equal(plain.x, inst.x)
        assert inst.telemetry.shape == (64, 14)
        cols = TelemetrySlab(cap=64, l=2).unpack(inst.telemetry)
        assert cols["upd"].max() == inst.iters
        assert json.loads(telemetry_track(inst.telemetry, l=2).to_json())
    with pytest.raises(ConfigError, match="plcg"):
        SolverService(LocalBackend(device="cpu"), method="cg",
                      telemetry_cap=8)
