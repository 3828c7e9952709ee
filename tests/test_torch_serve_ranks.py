"""The serving layer over ranks, in ONE process with no process group:
rank 0's command (``SolverService`` with ``world_size > 1``: the tick's
plan, the retired and shed requests, the clock) and a following rank fed
only those commands; the rows of each right-hand side a rank receives;
and the service on the ladder oracle against the JAX package's on the
same virtual clock.  The runs over real gloo ranks are in
``tests/test_torch_multiprocess.py`` (``RUN_MULTIPROCESS=1``).

Here the two "ranks" share one process: their transport is a list that
rank 0's commands and row blocks go into and the follower reads after
rank 0 has finished, and each holds every row of the operator (a
replicated world), so each runs the whole slab program on its own and no
collective is needed between them.

Tolerances: the follower against rank 0, rank 0 against a one-rank
service, and the rows a rank receives against the rows its
``rank_problem`` solves: exact (the same arithmetic on the same inputs);
the staged-oracle service against the JAX package's: the replay report's
metrics, the retirement log, the shed ids and every request's iteration
count equal (an 8 x 8 Laplacian with the JAX shifts, where no request
restarts: tests/test_torch_serve_replay.py's setting).
"""

import copy

import numpy as np
import pytest
import torch

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
from repro_torch.linalg import JacobiPrec, Stencil2D5  # noqa: E402
from repro_torch.linalg.sparse import random_fem_mesh  # noqa: E402
from repro_torch.parallel import distributed as tdist  # noqa: E402
from repro_torch.parallel.backends import LocalBackend  # noqa: E402
from repro_torch.serve import (AdmissionPolicy, ConfigError,  # noqa: E402
                               SolverService, TrafficClass, VirtualClock,
                               operator_fingerprint, poisson_trace, replay)

OP = Stencil2D5(8, 8, device="cpu")
CLASSES = [(4.0, 1e-4, 2.0), (1.0, 1e-10, 8.0)]   # weight, tol, deadline
SERVICE = dict(s=4, method="plcg", l=2, chunk_iters=8, maxit=300,
               max_replicas=2, replicate_watermark=0.5)
REPLAY = dict(iter_time_s=1e-3, tick_overhead_s=1e-3)


def _trace(rate=40.0, n_requests=24, seed=7, classes=CLASSES):
    classes = [TrafficClass("lap", OP.n, weight=w, tol=t, deadline_s=d)
               for w, t, d in classes]
    return poisson_trace(classes, rate_per_s=rate, n_requests=n_requests,
                         seed=seed)


class _World:
    """One rank's view of a replicated world of two: the one-device
    backend's slab programs, this rank's number."""

    world_size = 2

    def __init__(self, rank):
        self.rank = rank
        self.inner = LocalBackend(device="cpu")
        self.device = self.inner.device

    def make_slab_program(self, *a, **k):
        return self.inner.make_slab_program(*a, **k)


# The loose class's deadline is shorter than its wait at 400 arrivals a
# second: the rush sheds some of them, rejects some at the door and steals.
RUSH = dict(rate=400.0, classes=[(4.0, 1e-4, 0.01), (1.0, 1e-10, 8.0)])


def _ranked(rank, box):
    """A service on rank ``rank`` of the replicated world whose command
    and row transport is ``box`` (rank 0 appends, the follower pops)."""

    class Ranked(SolverService):
        def _command(self, cmd):
            if self.rank == 0:
                box["commands"].append(copy.deepcopy(cmd))
                return cmd
            return box["commands"].pop(0)

        def _send_rows(self, blocks):
            box["rows"].append({r: v.copy() for r, v in blocks.items()})

        def _recv_rows(self, count):
            v = box["rows"].pop(0)[self.rank]
            assert v.size == count
            return v

        def _owned(self, op_key, rank):
            return np.arange(self._operators[op_key].op.n)

    svc = Ranked(_World(rank), clock=VirtualClock(),
                 admission=AdmissionPolicy(max_pending=20), **SERVICE)
    svc.register_operator("lap", OP)
    return svc


def test_follower_fed_only_the_commands_reaches_rank_0s_state():
    """Rank 0 replays a trace that sheds and steals, sending a command a
    tick; a follower fed only those commands retires the same requests at
    the same ticks, sheds the same ones and holds the same solutions bit
    for bit; rank 0 itself is the one-rank service's replay."""
    box = {"commands": [], "rows": []}
    lead = _ranked(0, box)
    rep = replay(lead, _trace(**RUSH), **REPLAY)
    lead.stop()
    assert rep.n_shed > 0 and rep.steal_log and rep.n_rejected > 0
    assert box["commands"][-1]["stop"]
    assert len(box["commands"]) == rep.ticks + 1
    follow = _ranked(1, box)
    with pytest.raises(ConfigError, match="follow"):
        follow.step()
    got = follow.follow()
    assert not box["commands"] and not box["rows"]
    assert sorted(got) == sorted(lead.results)
    for k, r in lead.results.items():
        f = got[k]
        assert (f.shed, f.iters, f.converged, f.worker) == \
            (r.shed, r.iters, r.converged, r.worker)
        assert (f.x is None) == (r.x is None)
        if r.x is not None:
            assert np.array_equal(f.x, r.x)
            assert np.array_equal(f.res_history, r.res_history)
    assert follow.retirement_log == lead.retirement_log
    assert follow.scheduler.chunks_run == lead.scheduler.chunks_run
    one = SolverService(LocalBackend(device="cpu"), clock=VirtualClock(),
                        admission=AdmissionPolicy(max_pending=20), **SERVICE)
    one.register_operator("lap", OP)
    rep1 = replay(one, _trace(**RUSH), **REPLAY)
    assert rep1.metrics() == rep.metrics()
    assert rep1.retirement_log == rep.retirement_log
    assert all(np.array_equal(one.results[k].x, r.x)
               for k, r in lead.results.items() if r.x is not None)


def test_follower_refuses_a_retirement_it_did_not_make():
    """A command whose retired list differs from what the follower's own
    poll retired (status that was not replicated) stops the follower."""
    box = {"commands": [], "rows": []}
    lead = _ranked(0, box)
    replay(lead, _trace(n_requests=6), **REPLAY)
    lead.stop()
    for cmd in box["commands"]:
        if cmd["retired"]:
            cmd["retired"] = cmd["retired"][1:] + [(99, 99)]
            break
    with pytest.raises(RuntimeError, match="not replicated"):
        _ranked(1, box).follow()


class _Wire:
    """The rank and size a ``rank_problem`` reads, no transport."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size


@pytest.mark.parametrize("kind", ["stencil", "ell"])
def test_each_rank_receives_the_rows_it_solves(kind):
    """The rows rank 0 sends rank r of a right-hand side (``owned_rows``,
    in the partition's order) are exactly the rows r's ``rank_problem``
    takes of it, and a follower's zero-filled vector with those rows gives
    the same block: nothing else of b reaches a rank's solve."""
    op = OP if kind == "stencil" else random_fem_mesh(5, 64, avg_degree=8.0,
                                                      device="cpu")
    prec = JacobiPrec.from_operator(op)
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(op.n))
    seen = []
    for r in range(4):
        rp = tdist.rank_problem(_Wire(r, 4), op, prec)
        own = tdist.owned_rows(op, 4, r)
        assert torch.equal(rp.rows(b), b[torch.as_tensor(own)])
        part = torch.zeros_like(b)
        part[torch.as_tensor(own)] = b[torch.as_tensor(own)]
        assert torch.equal(rp.rows(part), rp.rows(b))
        seen.append(own)
    assert np.array_equal(np.sort(np.concatenate(seen)), np.arange(op.n))


def test_service_over_ranks_refuses_fault_injection():
    """The fault injector runs on rank 0 alone, which the followers
    could not mirror: a service over ranks refuses it."""
    with pytest.raises(ConfigError, match="fault_injector"):
        SolverService(_World(0), fault_injector=lambda tick, w: None)


def test_staged_oracle_service_replays_the_jax_service():
    """The service on the ladder oracle (4 virtual shards), the
    one-process reference of a service over 4 staged ranks, replays the
    trace the JAX package's service on its staged oracle replays: the
    same metrics, retirement log, shed ids (so the same admitted, shed
    and finished sets) and per-request iterations."""
    jop = jops.Stencil2D5(8, 8)
    jtrace = jpoisson([JTraffic("lap", jop.n, weight=w, tol=t, deadline_s=d)
                       for w, t, d in CLASSES],
                      rate_per_s=40.0, n_requests=24, seed=7)
    jsvc = JService(jget_backend("local", reduction="staged",
                                 virtual_shards=4), s=4, method="plcg", l=2,
                    chunk_iters=8, maxit=300, clock=JClock(),
                    admission=JAdmission(max_pending=64), max_replicas=2,
                    replicate_watermark=0.5)
    jsvc.register_operator("lap", jop)
    jrep = jreplay(jsvc, jtrace, **REPLAY)
    svc = SolverService(LocalBackend(device="cpu", reduction="staged",
                                     virtual_shards=4), clock=VirtualClock(),
                        admission=AdmissionPolicy(max_pending=64),
                        **SERVICE)
    sig = torch.tensor(np.asarray(jshifts(jop, 2)))
    svc.cache.get("sigmas", (operator_fingerprint(OP), None, 2),
                  lambda: sig)
    svc.register_operator("lap", OP)
    rep = replay(svc, _trace(), **REPLAY)
    assert rep.metrics() == jrep.metrics()
    assert rep.retirement_log == jrep.retirement_log
    assert rep.shed_ids == jrep.shed_ids
    assert sorted(svc.results) == sorted(jsvc.results)
    assert {k for k, r in svc.results.items() if not r.shed} == \
        {k for k, r in jsvc.results.items() if not r.shed}
    assert [svc.results[k].iters for k in sorted(svc.results)] == \
        [jsvc.results[k].iters for k in sorted(jsvc.results)]
