"""The port's partitioned solve (``repro_torch.parallel.distributed``), its
ring-ladder schedule and halo messages, and the multiprocess backend's
registry entry, in ONE process with no process group: every wire is
replaced by the in-process halos of a (P, ...) stack of virtual shards or
by a dict that routes each rank's messages in lockstep.  Held against the
JAX package's ``repro.parallel.distributed`` and ``reduction`` on the same
numpy inputs; the runs over real gloo ranks are in
``tests/test_torch_multiprocess.py`` (``RUN_MULTIPROCESS=1``).

Tolerances:
* partition arrays, permutations, schedules, message routing and the
  ladder's gather buffers: exact;
* a shard apply against the port's global apply: bitwise (each shard
  evaluates the global expression's terms in its order on the same
  values);
* port against JAX applies: 1e-14 of the row's sum |A| |x| (XLA may
  contract a product and a difference into one FMA);
* the fused ranks' reference (``rank_oracle_ops``: the virtual shards'
  superkernel plug-ins, their plain versions here) against its unfused
  path and ``LocalBackend``'s unfused ladder oracle: bitwise on the CPU
  (the plain phase closes each shard's dots with the same
  ``dot_block_rows``); against the JAX oracle's unfused solve: iteration
  counts within 2 and residual histories, relative to the initial norm,
  within 1e-10 over the first 10 entries and 1e-8 over all (the tight
  head and bounded tail of DESIGN.md §12: the mesh's ELL products round
  differently under XLA, and the difference grows along the recurrence,
  to 1.6e-10 on the mesh here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

from repro.core import pipelined_cg as jplcg  # noqa: E402
from repro.core.chebyshev import shifts_for_operator as jshifts  # noqa: E402
from repro.linalg import operators as jops  # noqa: E402
from repro.linalg import partition as jpart  # noqa: E402
from repro.linalg import sparse as jsp  # noqa: E402
from repro.linalg.preconditioners import BlockJacobi as JBlockJacobi  # noqa: E402
from repro.linalg.preconditioners import JacobiPrec as JJacobi  # noqa: E402
from repro.parallel import distributed as jdist  # noqa: E402
from repro.parallel import reduction as jred  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import pipelined_cg as tplcg  # noqa: E402
from repro_torch.linalg import BlockJacobi  # noqa: E402
from repro_torch.linalg import partition as tpart  # noqa: E402
from repro_torch.linalg import sparse as tsp  # noqa: E402
from repro_torch.parallel import distributed as tdist  # noqa: E402
from repro_torch.parallel import reduction as tred  # noqa: E402
from repro_torch.parallel.backends import (LocalBackend,  # noqa: E402
                                           MultiprocessBackend, get_backend)

APPLY_RTOL = 1e-14
FP64_HEAD, FP64_TAIL = 1e-10, 1e-8

# (kind, fields, P): the structured operators cut into P x-slabs.
STENCILS = [
    ("stencil2d5", dict(nx=16, ny=12), 4),
    ("stencil3d7", dict(nx=8, ny=6, nz=4, eps_z=0.1), 2),
    ("stencil3d27", dict(nx=8, ny=4, nz=5, centre=15.0), 4),
]


def _jax_op(kind, fields):
    return {"stencil2d5": lambda: jops.Stencil2D5(**fields),
            "stencil3d7": lambda: jops.Stencil3D7(**fields),
            "stencil3d27": lambda: jops.Stencil3D27(**fields)}[kind]()


def _mesh(seed=5, n=120, deg=6.0):
    """An unordered FEM mesh from each package's generator (RCM happens in
    the partition)."""
    return (jsp.random_fem_mesh(seed, n, avg_degree=deg),
            tsp.random_fem_mesh(seed, n, avg_degree=deg, device="cpu"))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.cpu() if isinstance(tree, torch.Tensor) else tree)


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def _scale_check(y_t, y_j, dense, x):
    scale = np.abs(dense) @ np.abs(x)
    assert (np.abs(y_t - y_j) <= APPLY_RTOL * scale + 1e-300).all()


# ------------------------------------------------------ partition arrays --
@pytest.mark.parametrize("kind,fields,p", STENCILS)
def test_partition_arrays_structured_match_jax(kind, fields, p):
    """Stencils carry no arrays and impose no order; Jacobi's inverse
    diagonal and block-Jacobi's blocks split by rows, as in JAX."""
    jop = _jax_op(kind, fields)
    top = convert.operator(kind, device="cpu", **fields)
    ja, _, jperm = jdist._partition_op(jop, p)
    ta, _, tperm = tdist._partition_op(top, p)
    assert ja == {} and ta == {} and jperm is None and tperm is None
    jj = JJacobi.from_operator(jop)
    tj = convert.jacobi(np.asarray(jj.inv_diag), "cpu")
    _assert_tree_equal(_np(tdist._partition_prec(tj, top, p)[0]),
                       _np(jdist._partition_prec(jj, jop, p)[0]))
    bs = top.n // p // 2
    jb = JBlockJacobi.from_operator(jop, bs)
    tb = BlockJacobi(inv_blocks=torch.from_numpy(np.array(jb.inv_blocks)))
    _assert_tree_equal(_np(tdist._partition_prec(tb, top, p)[0]),
                       _np(jdist._partition_prec(jb, jop, p)[0]))


@pytest.mark.parametrize("p", [2, 4])
def test_partition_arrays_sparse_and_permutation_match_jax(p):
    """An unordered SparseOp: the port's partition arrays are the JAX
    plan's (RCM order, send sets, remapped columns), Jacobi follows the
    permutation, block-Jacobi refuses it, and the permutation wrappers
    map b in and x out as JAX's do; ``convert.partitioned_arrays`` of the
    JAX arrays gives every rank ``shard_arrays``'s tensors."""
    jop, top = _mesh()
    plan = jpart.partition_spd(jop, p)
    ta, _, tperm = tdist._partition_op(top, p)
    _assert_tree_equal(_np(ta), {f: np.asarray(getattr(plan, f)) for f in
                                 ("cols", "vals", "send_up", "send_dn")})
    np.testing.assert_array_equal(tperm, plan.perm)
    jj = JJacobi.from_operator(jop)
    tj = convert.jacobi(np.asarray(jj.inv_diag), "cpu")
    jpa, _ = jdist._partition_prec(jj, jop, p, plan.perm)
    tpa, _ = tdist._partition_prec(tj, top, p, tperm)
    _assert_tree_equal(_np(tpa), _np(jpa))
    with pytest.raises(TypeError, match="RCM"):
        tdist._partition_prec(BlockJacobi.from_operator(top, 10), top, p,
                              tperm)
    b = np.random.default_rng(1).standard_normal(top.n)
    jpre, jpost = jdist._permutation_wrappers(plan.perm)
    tpre, tpost = tdist._permutation_wrappers(tperm)
    np.testing.assert_array_equal(tpre(torch.from_numpy(b)).numpy(),
                                  np.asarray(jpre(jnp.asarray(b))))
    res = tplcg.SolveResult(x=torch.from_numpy(b), iters=None, restarts=None,
                            converged=None, res_history=None, norm0=None)
    jres = jplcg.SolveResult(x=jnp.asarray(b), iters=None, restarts=None,
                             converged=None, res_history=None, norm0=None,
                             telemetry=None, governor=None)
    np.testing.assert_array_equal(tpost(res).x.numpy(),
                                  np.asarray(jpost(jres).x))
    jarrays = {"op": {f: np.asarray(getattr(plan, f)) for f in
                      ("cols", "vals", "send_up", "send_dn")},
               "prec": _np(jpa)}
    per_rank = convert.partitioned_arrays(jarrays, p, "cpu")
    for r in range(p):
        mine = tdist.shard_arrays({"op": ta, "prec": tpa}, p, r)
        _assert_tree_equal(_np(per_rank[r]), _np(mine))
        assert per_rank[r]["op"]["cols"].dtype == torch.int32


# ---------------------------------------------------------- shard applies --
@pytest.mark.parametrize("kind,fields,p", STENCILS)
def test_stencil_shard_applies_with_in_process_halos(kind, fields, p):
    """Each rank's stencil apply, given its planes from the in-process
    ``halo_first_dim`` of the stack, stacks to the global apply bitwise,
    and to JAX's within the apply bound."""
    jop = _jax_op(kind, fields)
    top = convert.operator(kind, device="cpu", **fields)
    x = np.random.default_rng(2).standard_normal(top.n)
    nl, plane = top.n // p, top.n // top.nx
    ext = tdist.halo_first_dim(torch.from_numpy(x).reshape(p, nl), plane)
    _, build, _ = tdist._partition_op(top, p)
    ys = []
    for r in range(p):
        def halo(g, r=r):
            return (ext[r, :plane].reshape(g[:1].shape),
                    ext[r, -plane:].reshape(g[:1].shape))

        ys.append(build({}, halo)(torch.from_numpy(x[r * nl:(r + 1) * nl])))
    y = torch.cat(ys)
    assert torch.equal(y, top.apply(torch.from_numpy(x)))
    _scale_check(y.numpy(), np.asarray(jop.apply(jnp.asarray(x))),
                 jop.to_dense(), x)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("p", [2, 4])
def test_ell_shard_applies_with_in_process_halos(p, use_kernel):
    """Each rank's ELL apply over its extended vector from the stacked
    ``halo_exchange`` (plain, and through the ``ell_spmv`` wrapper, whose
    plain twin runs on the CPU) equals the RCM-ordered operator's global
    apply bitwise and the JAX package's shard emulation within the bound."""
    jop, top = _mesh()
    plan = tpart.partition_spd(top, p)
    oop = tsp.permute_spd(top, plan.perm, ordered=True)
    x = np.random.default_rng(3).standard_normal(top.n)
    xe = tpart.halo_exchange(torch.from_numpy(x).reshape(p, plan.nxl),
                             plan.send_up, plan.send_dn)
    arrays, build, _ = tdist._partition_op(
        dataclasses.replace(top, use_kernel=use_kernel), p)
    y = torch.cat([build(tdist.shard_arrays(arrays, p, r),
                         lambda xl, r=r: xe[r])(
        torch.from_numpy(x[r * plan.nxl:(r + 1) * plan.nxl]))
        for r in range(p)])
    assert torch.equal(y, oop.apply(torch.from_numpy(x)))
    jplan = jpart.partition_spd(jop, p)
    y_j = jpart.emulate_partitioned_apply(jplan, x)
    _scale_check(y.numpy(), y_j, oop.to_dense(), x)


def _route(messages):
    """Lockstep transport: ``messages[r]`` is rank r's (sends, recvs);
    returns what each rank receives, matched by (sender, receiver, tag)."""
    box = {}
    for r, (sends, _) in enumerate(messages):
        for peer, tag, t in sends:
            assert (r, peer, tag) not in box
            box[(r, peer, tag)] = t.clone()
    got = [[box.pop((peer, r, tag)) for peer, tag, _ in recvs]
           for r, (_, recvs) in enumerate(messages)]
    assert not box                    # every message was received
    return got


@pytest.mark.parametrize("p", [1, 2, 4])
def test_halo_messages_in_lockstep_equal_stacked_halos(p):
    """The wire halos' pure message lists, routed in lockstep through a
    dict and assembled per rank, give the stacked in-process halos: the
    planes of an x-partition and the ELL send sets of an RCM plan."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(16 * 12))
    g = x.reshape(p, 16 // p, 12)
    msgs = [tdist.plane_messages(g[r], r, p) for r in range(p)]
    got = _route(msgs)
    ext = tdist.halo_first_dim(x.reshape(p, -1), 12)
    for r in range(p):
        above = below = torch.zeros(12, dtype=x.dtype)
        for (peer, _, _), t in zip(msgs[r][1], got[r]):
            if peer < r:
                above = t
            else:
                below = t
        assert torch.equal(torch.cat([above, g[r].reshape(-1), below]),
                           ext[r])
    _, top = _mesh(seed=3, n=64, deg=12.0)    # two hops at P = 4
    plan = tpart.partition_spd(top, p)
    xs = torch.from_numpy(np.random.default_rng(5).standard_normal(top.n))
    xl = xs.reshape(p, plan.nxl)
    msgs = [tpart.halo_messages(xl[r], plan.send_up[r], plan.send_dn[r], r,
                                p) for r in range(p)]
    got = _route(msgs)
    stacked = tpart.halo_exchange(xl, plan.send_up, plan.send_dn)
    for r in range(p):
        assert torch.equal(tpart.halo_assemble(xl[r], plan.hops,
                                               plan.max_send, r, msgs[r][1],
                                               got[r]), stacked[r])
    assert p < 4 or plan.hops == 2


# ------------------------------------------------------ the ladder schedule --
@pytest.mark.parametrize("p", [2, 4, 8])
def test_ladder_schedule_in_lockstep_fills_the_oracle_buffer(p):
    """P ranks run ``ladder_step``'s hops in lockstep, each hop's payload
    passed through a dict: after every step each rank holds exactly the
    partials its schedule has delivered, in their origins' slots, and
    after the last step the oracle's whole gather buffer; ``hop_groups``
    is JAX's for every stage count."""
    rng = np.random.default_rng(p)
    op = convert.operator("stencil2d5", nx=16, ny=8, device="cpu")
    mat = torch.from_numpy(rng.standard_normal((5, op.n)))
    vec = torch.from_numpy(rng.standard_normal(op.n))
    for stages in range(1, p):
        assert tred.hop_groups(p, stages) == jred.hop_groups(p, stages)
        cfg = tred.StagedConfig(n_shards=p, stages=stages)
        oracle = tred.oracle_start(mat, vec, cfg)
        nl = op.n // p
        bufs = [tred.staged_start(tdist.dot_block_rows(
            mat[:, r * nl:(r + 1) * nl], vec[r * nl:(r + 1) * nl]), cfg, r)
            for r in range(p)]
        held = [{r} for r in range(p)]
        for step in range(stages + 1):           # one step past the ladder
            hops = [tred.ladder_step(r, p, stages, step) for r in range(p)]
            assert all(len(h) == len(hops[0]) for h in hops)
            for i in range(len(hops[0])):
                box = {}
                for r in range(p):
                    h = hops[r][i]
                    assert h.send_slot in held[r]
                    box[(r, h.send_to, h.k)] = bufs[r][h.send_slot].clone()
                for r in range(p):
                    h = hops[r][i]
                    bufs[r][h.recv_slot] = box.pop((h.recv_from, r, h.k))
                    held[r].add(h.recv_slot)
                assert not box
            for r in range(p):
                for s in range(p):
                    want = oracle[s] if s in held[r] else torch.zeros(5)
                    assert torch.equal(bufs[r][s], want.to(torch.float64))
        assert all(h == set(range(p)) for h in held)
        for r in range(p):
            assert torch.equal(
                tred.ordered_reduce(bufs[r], torch.float64, False),
                tred.ordered_reduce(oracle, torch.float64, False))


# ------------------------------------------------- async all-reduce handles --
class _LoopbackWire:
    """A wire of P identical ranks in one process: an all-reduce returns
    P times the tensor when waited, and counts what is in flight."""

    rank, size = 0, 3

    def __init__(self):
        self.in_flight = 0

    def all_reduce_async(self, t):
        self.in_flight += 1
        wire = self

        class _Req:
            def wait(self):
                wire.in_flight -= 1
                return t * wire.size

        return _Req()


def test_all_reduce_handles_follow_the_ring_and_restarts():
    """A ring-slot wait (``advanced`` = l - 1) completes the request
    issued l ring starts earlier and drops the older ones a restart
    abandoned; a wait on a handle ``start`` returned completes that
    request alone (a restart's or a slab column's blocking pair leaves
    the ring's requests in flight); a wait with none in flight (a
    pipeline-fill slot) returns the slot; the handle the solver copies
    into its ring is a zero token, never the buffer being reduced."""
    wire = _LoopbackWire()
    h = tdist.AllReduceHandles(wire)
    parts = [torch.full((5,), float(i)) for i in range(6)]
    toks = [h.start(p_) for p_ in parts[:3]]
    assert all(torch.equal(t, torch.zeros(5)) for t in toks)
    assert toks[0] is not toks[1] and wire.in_flight == 3
    ring = torch.zeros((2, 5))
    # l = 2: three in flight, the wait takes the one two starts back and
    # drops the abandoned oldest
    assert torch.equal(h.wait(ring[0], advanced=1), parts[1] * 3)
    assert wire.in_flight == 1 and len(h.pending) == 1
    blocking = h.start(parts[3])                          # an inject's block
    assert torch.equal(h.wait(blocking), parts[3] * 3)
    assert len(h.pending) == 1                            # [2] stays
    h.start(parts[4])
    assert torch.equal(h.wait(ring[1], advanced=1), parts[2] * 3)
    assert torch.equal(h.wait(ring[0], advanced=0), parts[4] * 3)
    assert wire.in_flight == 0 and not h.pending
    slot = ring[0]
    assert h.wait(slot) is slot and wire.in_flight == 0


# ------------------------------------------------- the oracle's fused path --
@pytest.mark.parametrize("kind", ["stencil2d5", "stencil3d7", "ell"])
def test_rank_oracle_fused_path_runs_every_virtual_shard(kind):
    """``rank_oracle_ops`` with the superkernel runs each virtual
    shard's halo plug-in (plain versions on the CPU): bitwise equal to its
    unfused path, which is ``LocalBackend(reduction="staged",
    virtual_shards=P)``'s, and within the fp64 bound of the JAX oracle's
    solve; no fused path where a rank has none.  ``LocalBackend``'s own
    fused oracle keeps the JAX package's one whole-vector partial."""
    if kind == "ell":
        jop, raw = _mesh(seed=9, n=200)
        plan = tpart.partition_spd(raw, 4)
        top = tsp.permute_spd(raw, plan.perm, ordered=True)
        jop = jsp.permute_spd(jop, plan.perm, ordered=True)
    else:
        fields = dict(STENCILS[0][1]) if kind == "stencil2d5" else \
            dict(STENCILS[1][1])
        jop = _jax_op(kind, fields)
        top = convert.operator(kind, device="cpu", **fields)
    jj = JJacobi.from_operator(jop)
    tj = convert.jacobi(np.asarray(jj.inv_diag), "cpu")
    b = np.random.default_rng(6).standard_normal(top.n)
    sig = np.asarray(jshifts(jop, 2, prec=jj))
    kw = dict(l=2, sigmas=torch.from_numpy(sig), tol=1e-9, maxit=600)
    cfg = tred.StagedConfig(4)
    ops = tdist.rank_oracle_ops(top, tj, cfg)
    bt = torch.from_numpy(b)
    fused = tplcg.solve(ops, bt, fused_iteration=True, **kw)
    plain = tplcg.solve(ops, bt, **kw)
    be = LocalBackend(device="cpu", reduction="staged", virtual_shards=4)
    local = be.solve(top, b, prec=tj, **kw)
    assert bool(fused.converged)
    for other in (plain, local):
        assert torch.equal(fused.x, other.x)
        assert torch.equal(fused.res_history, other.res_history)
    slot0 = be.make_ops(top, tj).combine_partials(torch.ones(5))
    assert torch.equal(slot0[0], torch.ones(5)) and not slot0[1:].any()
    jres = jplcg.solve(jred.oracle_solver_ops(
        jop, jj, jred.StagedConfig(n_shards=4, stages=2, axis=None)),
        jnp.asarray(b), l=2, sigmas=jnp.asarray(sig), tol=1e-9, maxit=600)
    assert abs(int(fused.iters) - int(jres.iters)) <= 2
    h_t, h_j = fused.res_history.numpy(), np.asarray(jres.res_history)
    m = (h_t >= 0) & (h_j >= 0)
    diff = np.abs(h_t[m] - h_j[m]) / float(jres.norm0)
    assert diff[:10].max() < FP64_HEAD and diff.max() < FP64_TAIL
    for no_fused in (convert.operator("stencil3d27", device="cpu",
                                      **STENCILS[2][1]),
                     dataclasses.replace(top, use_kernel=True)):
        assert tdist.rank_oracle_ops(
            no_fused, None, cfg).fused_iter_factory is None


# ------------------------------------------------------------- registry --
def test_backend_registry():
    """``multiprocess`` is the port's one multi-rank backend;
    ``shard_map`` is refused with a ValueError that names it; without a
    process group or its environment the backend refuses to start."""
    import os

    from repro_torch.parallel import backends

    assert backends.available_backends() == ("local", "multiprocess")
    assert backends._REGISTRY["multiprocess"] is MultiprocessBackend
    with pytest.raises(ValueError, match="multiprocess"):
        get_backend("shard_map", n_shards=4)
    if not any(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT")):
        with pytest.raises(ValueError, match="MASTER_ADDR"):
            get_backend("multiprocess", device="cpu")
    with pytest.raises(ValueError, match="banana"):
        get_backend("banana")
