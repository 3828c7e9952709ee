"""Checkpointed solves over ranks
(``repro_torch.parallel.distributed.distributed_checkpointed_solve``), in
ONE process with no process group: a world of one runs over an
in-process wire of size 1 (a loopback: an all-reduce or all-gather of one
rank returns its input), and the snapshot's gather and the restore's
scatter of P in {2, 4} ranks are routed in lockstep through a dict.  Held
against the one-device reference ``rank_oracle_ops`` and against the JAX
package's one-device checkpointed solve; the runs over real gloo ranks
and the kill-a-rank drill are in
``tests/test_torch_fabric_multiprocess.py`` (``RUN_MULTIPROCESS=1``).
Files are written only under ``tmp_path``.

Smoke sizes: ``Stencil2D5(24, 16)`` and ``(16, 12)``, a 96-node FEM mesh
(ELL, RCM-ordered by its partition), Jacobi or none, at most 300 updates.

Tolerances:
* the world of one against ``rank_oracle_ops`` on one device, its resume
  against its own uninterrupted run, the gather against the one-device
  payload and the scatter against each rank's rows: bitwise;
* across packages, the tolerance of ``tests/test_torch_checkpoint.py``
  (PR 26): a port snapshot passes the JAX package's ``load_checkpoint``,
  ``check_meta`` and ``state_restore`` with every restored leaf equal to
  the stored bytes, and the JAX solve resumes from it and converges; a
  JAX snapshot resumed over the port's world of one keeps the history
  bitwise up to the restore, then agrees within 1e-9 relative over the
  next 10 entries, iteration counts within 2 and x within 1e-6 relative
  (XLA contracts FMAs and sums the dot block in its own order).  Each
  package certifies the other's snapshot at the default ``certify_rtol``
  (1e-8).
"""

import importlib.util

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from repro import checkpoint as jck
    from repro.checkpoint import solve as jck_solve
    from repro.core.batched import BUILDERS as JBUILDERS
    from repro.core.types import SolverOps as JOps
    from repro.linalg.operators import Stencil2D5 as JStencil
    from repro.parallel import get_backend as jget_backend

from repro_torch.checkpoint import (LAST_RESTORE, SNAPSHOTS,  # noqa: E402
                                    CheckpointConfig,
                                    CheckpointMismatchError,
                                    checkpointed_solve, effective_kw,
                                    latest_checkpoint, load_checkpoint,
                                    run_segmented, state_payload,
                                    state_restore)
from repro_torch.checkpoint import solve as ckpt_solve  # noqa: E402
from repro_torch.core.batched import BUILDERS  # noqa: E402
from repro_torch.core.chebyshev import shifts_for_operator  # noqa: E402
from repro_torch.linalg import JacobiPrec, Stencil2D5  # noqa: E402
from repro_torch.linalg import partition as tpart  # noqa: E402
from repro_torch.linalg import sparse as tsp  # noqa: E402
from repro_torch.parallel import distributed as tdist  # noqa: E402
from repro_torch.parallel.backends import MultiprocessBackend  # noqa: E402
from repro_torch.parallel.reduction import StagedConfig  # noqa: E402

EVERY = 15
KW = {"plcg": dict(l=2, tol=1e-10, maxit=300),
      "pcg": dict(tol=1e-10, maxit=300)}


@pytest.fixture
def with_jax():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the reference")


class _Loopback:
    """The wire of a world of one rank, in process."""

    rank, size = 0, 1

    def all_reduce_async(self, t):
        class _Req:
            def wait(self):
                return t

        return _Req()

    def all_reduce(self, t):
        return t

    def all_gather(self, t, dim=0):
        return t.clone()

    def exchange(self, sends, recvs, kind):
        assert not sends and not recvs       # a world of one has no peer
        return []


def _problem(nx=24, ny=16, seed=11):
    op = Stencil2D5(nx, ny, device="cpu")
    b = torch.as_tensor(np.random.default_rng(seed).standard_normal(op.n))
    return op, b


def _same(a, b):
    assert torch.equal(a.res_history, b.res_history)
    assert torch.equal(a.x, b.x)
    assert int(a.iters) == int(b.iters)


# ------------------------------------------------------ a world of one --
CASES = [("plcg", None, True), ("plcg", None, False),
         ("plcg", "staged", True), ("plcg", "staged", False),
         ("pcg", None, False), ("pcg", "staged", False)]


@pytest.mark.parametrize("method,red,fused", CASES)
def test_world_of_one_bitwise_oracle_and_resume(tmp_path, method, red,
                                                fused):
    """A world of one over the loopback wire, checkpointed with a
    directory: history and x bitwise ``rank_oracle_ops`` (one virtual
    shard) through the one-device segmented drive; a ``resume=True`` run
    restores the last snapshot (its ``tot`` recorded) and ends bitwise the
    same.  p(2)-CG fused and unfused, monolithic and staged, and p-CG."""
    op, b = _problem()
    prec = JacobiPrec.from_operator(op)
    kw = dict(KW[method])
    if method == "plcg":
        kw.update(sigmas=shifts_for_operator(op, 2, prec=prec),
                  fused_iteration=fused, unroll=4)
    cfg1 = StagedConfig(1, stages=1)
    reduction = cfg1 if red else None
    d = str(tmp_path)
    snaps = len(SNAPSHOTS)
    full = tdist.distributed_checkpointed_solve(
        _Loopback(), op, b, method, prec, reduction,
        CheckpointConfig(every=EVERY, directory=d), **kw)
    snaps = len(SNAPSHOTS) - snaps
    oracle = checkpointed_solve(tdist.rank_oracle_ops(op, prec, cfg1), b,
                                method, None, CheckpointConfig(every=EVERY),
                                dict(kw))
    _same(full, oracle)
    assert snaps > 0 and full.host_syncs == oracle.host_syncs + snaps
    before = len(LAST_RESTORE)
    resumed = tdist.distributed_checkpointed_solve(
        _Loopback(), op, b, method, prec, reduction,
        CheckpointConfig(every=EVERY, directory=d, resume=True), **kw)
    assert len(LAST_RESTORE) == before + 1
    assert int(LAST_RESTORE[-1].meta["tot"]) > 0
    _same(resumed, full)


def test_backend_entry_point_runs_the_checkpointed_solve(tmp_path):
    """``MultiprocessBackend.solve(checkpoint=CheckpointConfig(every > 0,
    ...))`` no longer raises: over a world of one (the backend object made
    without joining a process group, its wire the loopback) it writes
    snapshots and is bitwise the oracle; a warm start ``x0`` is whole."""
    op, b = _problem(16, 12, seed=4)
    be = MultiprocessBackend.__new__(MultiprocessBackend)
    be.device, be.wire, be.reduction_cfg = (torch.device("cpu"), _Loopback(),
                                            None)
    x0 = torch.as_tensor(np.random.default_rng(5).standard_normal(op.n))
    kw = dict(KW["plcg"], x0=x0)
    res = be.solve(op, b, method="plcg",
                   checkpoint=CheckpointConfig(every=EVERY,
                                               directory=str(tmp_path)),
                   **kw)
    assert latest_checkpoint(str(tmp_path)) is not None
    ref = checkpointed_solve(
        tdist.rank_oracle_ops(op, None, StagedConfig(1, stages=1)), b,
        "plcg", x0, CheckpointConfig(every=EVERY), dict(KW["plcg"]))
    _same(res, ref)


# --------------------------------------- gather and scatter in lockstep --
def _boundary_state(op, prec, b, method):
    """The state of a one-device solve of (op, b) just after its second
    drained-ring boundary (an interrupt), a copy."""
    from repro_torch.core.types import SolverOps

    kw = effective_kw(method, dict(KW[method]), EVERY)
    if method == "plcg":
        kw["sigmas"] = shifts_for_operator(op, 2, prec=prec)
    prog = BUILDERS[method](SolverOps.local(op, prec), b, **kw)
    seen = []

    def capture(st):
        seen.append(_clone(st))

    run_segmented(prog.init(torch.zeros_like(b)), cond=prog.cond,
                  needs=prog.needs_interrupt,
                  step=prog.iteration if method == "plcg" else prog.step,
                  interrupt=prog.interrupt, method=method,
                  cfg=CheckpointConfig(every=EVERY), snapshot=capture)
    return seen[1]


def _clone(st):
    if isinstance(st, tuple) and hasattr(st, "_fields"):
        return type(st)(*(_clone(v) for v in st))
    return st.clone() if isinstance(st, torch.Tensor) else st


def _rank_state(st, method, lo, hi):
    """Rank rows [lo, hi) of the state's vector leaf, the rest as is."""
    if method == "plcg":
        return st._replace(cyc=st.cyc._replace(
            S=st.cyc.S[..., lo:hi].clone()))
    return st._replace(S=st.S[..., lo:hi].clone())


def _ops_problem(kind, p):
    """(the operator as given, the operator in the partition's row order,
    Jacobi, b in that order): a stencil keeps its order; an FEM mesh
    takes its partition's RCM permutation."""
    if kind == "stencil2d5":
        op, b = _problem(16, 12, seed=2)
        return op, op, JacobiPrec.from_operator(op), b
    raw = tsp.random_fem_mesh(5, 96, avg_degree=6.0, device="cpu")
    plan = tpart.plan_for(raw, p)
    assert not plan.identity_perm
    op = tsp.permute_spd(raw, plan.perm, ordered=True)
    b = torch.as_tensor(np.random.default_rng(3).standard_normal(raw.n))
    return raw, op, JacobiPrec.from_operator(op), b[plan.perm]


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("kind", ["stencil2d5", "ell"])
@pytest.mark.parametrize("method", ["plcg", "pcg"])
def test_gather_and_scatter_in_lockstep(p, kind, method):
    """P ranks, each holding its block of rows of a boundary state (in
    the partition's order), gather their vector leaves through one
    all-gather routed in lockstep through a dict: every rank ends with the
    one-device state's leaves, so its payload is the one-device payload.
    The scatter of that payload restores each rank's own state, bitwise;
    a stored vector leaf of the wrong length is a typed mismatch."""
    raw, op, prec, b = _ops_problem(kind, p)
    whole = _boundary_state(op, prec, b, method)
    nl = op.n // p
    # rank r holds block r of the partition's order: these rows of raw
    order = np.concatenate([tdist.owned_rows(raw, p, r) for r in range(p)])
    assert np.array_equal(np.sort(order), np.arange(raw.n))
    if raw is op:
        assert np.array_equal(order, np.arange(op.n))
    ranks = [_rank_state(whole, method, r * nl, (r + 1) * nl)
             for r in range(p)]
    hooks = [tdist.RankSnapshot(method, p, r, nl) for r in range(p)]
    leaves = [ckpt_solve._leaves(st) for st in ranks]
    box = {r: hooks[r].pack(leaves[r]) for r in range(p)}

    class _DictWire:
        def __init__(self, r):
            self.r = r

        def all_gather(self, t, dim=0):
            assert torch.equal(t, box[self.r])
            return torch.cat([box[q] for q in range(p)], dim=dim)

    mask = ckpt_solve.exclude_mask(method, whole)
    want = state_payload(whole, mask)
    for r in range(p):
        got = hooks[r].gather(leaves[r], _DictWire(r))
        payload = {f"leaf_{i:03d}": got[i].numpy()
                   for i, e in enumerate(mask) if not e}
        assert payload.keys() == want.keys()
        for k in want:
            assert payload[k].dtype == want[k].dtype
            assert payload[k].tobytes() == want[k].tobytes()
    clock = whole.t if method == "plcg" else whole.k
    for r in range(p):
        back = state_restore(ranks[r], hooks[r].scatter(want), mask, clock)
        mine = ckpt_solve._leaves(ranks[r])
        for i, e in enumerate(mask):
            if not e:
                assert torch.equal(ckpt_solve._leaves(back)[i], mine[i])
    bad = dict(want, leaf_000=want["leaf_000"][..., :-1])
    with pytest.raises(CheckpointMismatchError):
        hooks[0].scatter(bad)


# ----------------------------------------------------- across packages --
def _jax_problem():
    jop = JStencil(24, 16)
    b = np.random.default_rng(11).standard_normal(jop.n)
    return jop, b


def test_world_of_one_snapshot_passes_jax_restore(tmp_path, with_jax):
    """A snapshot written over the port's world of one passes the JAX
    package's ``load_checkpoint``, ``check_meta`` and ``state_restore`` on
    a JAX one-device template, every restored leaf the stored bytes; the
    JAX checkpointed solve resumes from it and converges."""
    method = "plcg"
    op, b = _problem()
    d = str(tmp_path)
    tdist.distributed_checkpointed_solve(
        _Loopback(), op, b, method, None, None,
        CheckpointConfig(every=EVERY, directory=d), **KW[method])
    path = latest_checkpoint(d)
    payload, meta = jck.load_checkpoint(path)
    jop, jb = _jax_problem()
    jb = jnp.asarray(jb)
    kw = jck.effective_kw(method, dict(KW[method]), EVERY)
    tpl = JBUILDERS[method](JOps.local(jop), jb, **kw).init(
        jnp.zeros_like(jb))
    expect = jck_solve.solver_meta(method, jb.shape[0], jb.dtype, kw, EVERY)
    expect["treedef"] = jck_solve.state_treedef_str(tpl)
    jck_solve.check_meta(meta, expect)
    st = jck_solve.state_restore(tpl, payload,
                                 jck_solve.exclude_mask(method, tpl))
    for k, leaf in enumerate(jax.tree_util.tree_leaves(st)):
        key = f"leaf_{k:03d}"
        if key in payload:
            assert np.asarray(leaf).tobytes() == payload[key].tobytes()
    jres = jget_backend("local").solve(
        jop, jb, method=method,
        checkpoint=jck.CheckpointConfig(every=EVERY, directory=d,
                                        resume=True), **KW[method])
    assert bool(jres.converged)
    assert jck_solve.LAST_RESTORE[-1].path == path


def test_jax_snapshot_resumes_over_the_world_of_one(tmp_path, with_jax):
    """The JAX one-device checkpointed solve writes; the port's world of
    one resumes from its latest snapshot (meta and certification
    accepted; each rank cut to its rows by the scatter) and finishes
    within the port-vs-JAX tolerances."""
    jop, b = _jax_problem()
    d = str(tmp_path)
    jres = jget_backend("local").solve(
        jop, b, method="plcg",
        checkpoint=jck.CheckpointConfig(every=EVERY, directory=d),
        **KW["plcg"])
    path = latest_checkpoint(d)
    upd = int(load_checkpoint(path)[1]["upd"])
    op, tb = _problem()
    res = tdist.distributed_checkpointed_solve(
        _Loopback(), op, tb, "plcg", None, None,
        CheckpointConfig(every=EVERY, directory=d, resume=True),
        **KW["plcg"])
    assert LAST_RESTORE[-1].path == path and upd > 0
    assert bool(res.converged) and bool(jres.converged)
    assert abs(int(res.iters) - int(jres.iters)) <= 2
    x, jx = res.x.numpy(), np.asarray(jres.x)
    assert np.linalg.norm(x - jx) <= 1e-6 * np.linalg.norm(jx)
    h, jh = res.res_history.numpy(), np.asarray(jres.res_history)
    assert np.array_equal(h[:upd + 1], jh[:upd + 1])
    seg = slice(upd + 1, upd + 11)
    np.testing.assert_allclose(h[seg], jh[seg], rtol=1e-9)


def test_vector_leaves_follow_the_vector_mask():
    """The payload's vector leaves are the state's ``vector_mask`` leaves
    in the JAX leaf order, the D ring left out: S alone, for both
    methods."""
    for method in ("plcg", "pcg"):
        assert ckpt_solve.vector_leaves(method) == (0,)
        assert ckpt_solve.LEAVES[method][0] == "S"
