"""Batched solves over ranks, in ONE process with no process group: the
ladder oracle's batched form (``LocalBackend(reduction="staged",
virtual_shards=P)``), the slab form of the fused ranks' reference
(``parallel.distributed.rank_oracle_ops``), the (s, 2l+1) ladder schedule
and the slab halo messages routed in lockstep through a dict, the slab
shard applies, the superkernel's halo plug-ins in the slab form, the
telemetry ring and the governor on the ladder oracle, and the state's
``vector_mask``.  Held against the JAX package's
``LocalBackend(reduction="staged", virtual_shards=P)`` on the same numpy
inputs; the runs over real gloo ranks are in
``tests/test_torch_multiprocess.py`` (``RUN_MULTIPROCESS=1``).

Smoke sizes: ``Stencil2D5(16, 16)``, ``Stencil3D7(8, 6, 4)`` and a
64-node FEM mesh (ELL), Jacobi, s = 4 right-hand sides from a numpy seed
(one of them zero), l in {1, 2, 3}, P in {2, 4}.

Tolerances:
* schedules, message routing, gather buffers, halos, shard applies
  against the whole slab's, and the port against itself (slab column j
  against the one-column oracle solve of B[j]; fused against unfused;
  a halo plug-in's slab against its single columns): exact;
* the port's batched oracle against the JAX package's: the same iteration
  count for every column, residual histories relative to the column's
  initial norm within 1e-10 over the first 10 entries and 1e-8 over all
  (the tight head and bounded tail of DESIGN.md §12, as
  tests/test_torch_distributed.py states them: XLA contracts FMAs and
  sums the dot block in its own order), x within 1e-8 of its norm;
* rings and governors against the JAX package's: the discrete ring
  columns and the governor's actions equal, rnorm within 1e-8 relative,
  each row's dot block within 1e-8 of its largest entry
  (tests/test_torch_telemetry.py).

The test marked ``cuda`` holds the halo plug-ins' slab launch against its
plain version on the card (rows bitwise, partials within 1e-12 of
sum |m u|); the card's machine has no JAX.
"""

import importlib.util

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# A card's machine has no JAX and runs only the cuda test.
HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    import jax.numpy as jnp

    from repro.core.chebyshev import shifts_for_operator as jshifts
    from repro.core.types import TelemetrySlab as JSlab
    from repro.linalg import operators as jops
    from repro.linalg import sparse as jsp
    from repro.linalg.preconditioners import JacobiPrec as JJacobi
    from repro.parallel import get_backend as jget_backend
    from repro.stability import GovernorConfig as JGov

from repro_torch import convert  # noqa: E402
from repro_torch.core import METHODS, batched, pipelined_cg  # noqa: E402
from repro_torch.core.types import TelemetrySlab, dot_block_rows  # noqa: E402
from repro_torch.kernels import fused_iter as tfi  # noqa: E402
from repro_torch.linalg import partition as tpart  # noqa: E402
from repro_torch.parallel import distributed as tdist  # noqa: E402
from repro_torch.parallel import reduction as tred  # noqa: E402
from repro_torch.parallel.backends import LocalBackend  # noqa: E402
from repro_torch.stability import GovernorConfig  # noqa: E402

FP64_HEAD, FP64_TAIL, X_RTOL = 1e-10, 1e-8, 1e-8
RNORM_RTOL = DOTS_RTOL = 1e-8
S = 4
DISCRETE = ("iter", "upd", "age", "breakdown", "restart", "replacement",
            "action")


@pytest.fixture
def with_jax():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the reference")


def _fields(kind):
    return {"2d5": ("stencil2d5", dict(nx=16, ny=16)),
            "3d7": ("stencil3d7", dict(nx=8, ny=6, nz=4, eps_z=0.1))}[kind]


def _port(kind, p=4, device="cpu"):
    """The port's operator (RCM-ordered for the mesh, as a rank partition
    of ``p`` orders it) and its Jacobi preconditioner, without JAX."""
    from repro_torch.linalg import JacobiPrec
    from repro_torch.linalg.sparse import permute_spd, random_fem_mesh

    if kind == "ell":
        raw = random_fem_mesh(3, 64, avg_degree=8.0, device=device)
        top = permute_spd(raw, tpart.partition_spd(raw, p).perm,
                          ordered=True)
    else:
        name, f = _fields(kind)
        top = convert.operator(name, device=device, **f)
    return top, JacobiPrec.from_operator(top)


def _pair(kind):
    """(JAX operator, JAX Jacobi, port operator, port Jacobi): the same
    system in both packages (the mesh's arrays carried over as they are).
    The mesh is seed 5's, whose solves run without a breakdown restart:
    seed 3's (``_port``'s, which the port-only tests take for its
    restarts) breaks down at l >= 2 near convergence, at an iteration that
    rounding decides, in each package and on either dot block."""
    if kind == "ell":
        jop = jsp.random_fem_mesh(5, 64, avg_degree=8.0)
        top = convert.operator("ell", device="cpu", cols=np.asarray(jop.cols),
                               vals=np.asarray(jop.vals))
    else:
        name, f = _fields(kind)
        jop = {"2d5": jops.Stencil2D5, "3d7": jops.Stencil3D7}[kind](**f)
        top = convert.operator(name, device="cpu", **f)
    jprec = JJacobi.from_operator(jop)
    return jop, jprec, top, convert.jacobi(np.asarray(jprec.inv_diag), "cpu")


def _slab(n, seed=7, zero=2):
    B = np.random.default_rng(seed).standard_normal((S, n))
    if zero is not None:
        B[zero] = 0.0
    return B


def _assert_close_to_jax(rt, rj):
    """Per column: iteration counts equal, histories within the head/tail
    bounds of the initial norm, x within X_RTOL of its norm."""
    for j in range(rt.x.shape[0]):
        assert int(rt.iters[j]) == int(rj.iters[j]), j
        ht, hj = rt.res_history[j].numpy(), np.asarray(rj.res_history[j])
        m = (ht >= 0) & (hj >= 0)
        norm0 = max(float(rj.norm0[j]), 1e-300)
        diff = np.abs(ht[m] - hj[m]) / norm0
        if diff.size:
            assert diff[:10].max() <= FP64_HEAD and diff.max() <= FP64_TAIL
        xj = np.asarray(rj.x[j])
        assert np.linalg.norm(rt.x[j].numpy() - xj) <= \
            X_RTOL * max(np.linalg.norm(xj), 1e-300)


# ------------------------------------------- the ladder oracle, batched --
ORACLE_CASES = [("2d5", 2, 1, "plcg"), ("2d5", 4, 2, "plcg"),
                ("3d7", 2, 3, "plcg"), ("ell", 4, 2, "plcg"),
                ("2d5", 4, 0, "cg"), ("3d7", 2, 0, "pcg")]


@pytest.mark.parametrize("kind,p,l,method", ORACLE_CASES)
def test_staged_oracle_batched_matches_jax_and_its_columns(kind, p, l, method,
                                                           with_jax):
    """``LocalBackend(reduction="staged", virtual_shards=P).solve_batched``:
    column j bitwise the one-column oracle solve of B[j], and the JAX
    package's staged oracle's batched solve of the same columns within the
    stated bounds; the zero column retires at iteration 0."""
    jop, jprec, top, tprec = _pair(kind)
    B = _slab(top.n, seed=l + p)
    kw = dict(tol=1e-9, maxit=500)
    jkw, tkw = dict(kw), dict(kw, unroll=4)
    if method == "plcg":
        sig = np.asarray(jshifts(jop, l, prec=jprec))
        jkw.update(l=l, sigmas=jnp.asarray(sig))
        tkw.update(l=l, sigmas=convert.sigmas(sig, "cpu"))
    be = LocalBackend(device="cpu", reduction="staged", virtual_shards=p)
    rt = be.solve_batched(top, torch.as_tensor(B), method=method, prec=tprec,
                          **tkw)
    for j in range(S):
        one = be.solve(top, torch.as_tensor(B[j]), method=method, prec=tprec,
                       **tkw)
        assert torch.equal(rt.x[j], one.x)
        assert torch.equal(rt.res_history[j], one.res_history)
    assert int(rt.iters[2]) == 0 and bool(rt.converged[2])
    rj = jget_backend("local", reduction="staged",
                      virtual_shards=p).solve_batched(
        jop, jnp.asarray(B.T), method=method, prec=jprec, **jkw)
    _assert_close_to_jax(rt, rj)


def test_staged_oracle_slab_program_matches_jax(with_jax):
    """The staged oracle's slab program through init, chunks, a retire
    and an inject into the freed slot: after every chunk the same
    per-column iteration counts as the JAX package's staged slab program,
    and the extracted solutions within the stated bounds; the injected
    column bitwise the one-column oracle solve of its right-hand side."""
    jop, jprec, top, tprec = _pair("2d5")
    sig = np.asarray(jshifts(jop, 2, prec=jprec))
    kw = dict(l=2, tol=1e-9, maxit=500)
    B = _slab(top.n, seed=11, zero=None)
    tb = LocalBackend(device="cpu", reduction="staged", virtual_shards=4)
    jb = jget_backend("local", reduction="staged", virtual_shards=4)
    tprog = tb.make_slab_program(top, s=S, method="plcg", prec=tprec,
                                 chunk_iters=12,
                                 sigmas=convert.sigmas(sig, "cpu"), **kw)
    jprog = jb.make_slab_program(jop, s=S, method="plcg", prec=jprec,
                                 chunk_iters=12, sigmas=jnp.asarray(sig),
                                 **kw)
    Bt, Bj = torch.as_tensor(B), jnp.asarray(B.T)
    st_t, st_j = tprog.init(Bt), jprog.init(Bj)
    injected = False
    for _ in range(40):
        st_t, st_j = tprog.chunk(Bt, st_t), jprog.chunk(Bj, st_j)
        it_t = tprog.status(Bt, st_t).iters.tolist()
        it_j = np.asarray(jprog.status(Bj, st_j).iters).tolist()
        assert it_t == it_j
        run = tprog.status(Bt, st_t).running.tolist()
        if not injected and not run[1]:
            B[1] = np.random.default_rng(5).standard_normal(top.n)
            Bt, Bj = torch.as_tensor(B), jnp.asarray(B.T)
            mask = [False, True, False, False]
            st_t = tprog.inject(Bt, st_t, mask)
            st_j = jprog.inject(Bj, st_j, jnp.asarray(mask))
            injected = True
        elif injected and not any(run):
            break
    assert injected and not any(tprog.status(Bt, st_t).running.tolist())
    rt, rj = tprog.extract(Bt, st_t), jprog.extract(Bj, st_j)
    _assert_close_to_jax(rt, rj)
    one = tb.solve(top, Bt[1], method="plcg", prec=tprec,
                   sigmas=convert.sigmas(sig, "cpu"), **kw)
    assert torch.equal(rt.x[1], one.x)
    assert int(rt.iters[1]) == int(one.iters)


# ------------------------------------- the fused ranks' reference, slab --
RANK_CASES = [("2d5", 2, 1), ("2d5", 4, 2), ("3d7", 2, 3), ("3d7", 4, 1),
              ("ell", 2, 3), ("ell", 4, 2)]


@pytest.mark.parametrize("kind,p,l", RANK_CASES)
def test_rank_oracle_slab_fused_equals_unfused(kind, p, l):
    """``rank_oracle_ops`` on a slab: every virtual shard's halo plug-in in
    the slab form on its block of every column (plain versions here) is
    bitwise the unfused slab, which is ``LocalBackend``'s staged oracle's
    batched solve; column j is bitwise the one-column fused solve of the
    reference."""
    from repro_torch.core.chebyshev import shifts_for_operator

    top, prec = _port(kind, p)
    B = torch.as_tensor(_slab(top.n, seed=3 * l + p))
    kw = dict(l=l, sigmas=shifts_for_operator(top, l, prec=prec), tol=1e-9,
              maxit=400, unroll=4)
    ops = tdist.rank_oracle_ops(top, prec,
                                tred.StagedConfig(p, stages=min(2, p - 1)))
    fused = batched.solve_batched(ops, B, "plcg", fused_iteration=True, **kw)
    plain = batched.solve_batched(ops, B, "plcg", **kw)
    local = LocalBackend(device="cpu", reduction="staged",
                         virtual_shards=p).solve_batched(top, B, prec=prec,
                                                         **kw)
    assert bool(fused.converged.all())
    for other in (plain, local):
        assert torch.equal(fused.x, other.x)
        assert torch.equal(fused.res_history, other.res_history)
    for j in (0, 3):
        one = pipelined_cg.solve(ops, B[j], fused_iteration=True, **kw)
        assert torch.equal(fused.res_history[j], one.res_history)
        assert torch.equal(fused.x[j], one.x)


# ------------------------------------------------- lockstep schedules --
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


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_slab_ladder_schedule_in_lockstep_fills_the_oracle_buffer(p, l):
    """P ranks run ``ladder_step``'s hops on an (s, P, 2l+1) gather buffer
    in lockstep, each hop ONE (s, 2l+1) message routed through a dict: the
    buffers end as the oracle's slab buffer, every column's as its
    one-column buffer, the rank-ordered sums agree, and a rank sends
    ``reduction_wire_bytes(P, l, s)`` over the ladder."""
    rng = np.random.default_rng(10 * p + l)
    K, n = 2 * l + 1, 32
    mat = torch.as_tensor(rng.standard_normal((S, K, n)))
    vec = torch.as_tensor(rng.standard_normal((S, n)))
    nl = n // p
    for stages in range(1, p):
        cfg = tred.StagedConfig(n_shards=p, stages=stages)
        oracle = tred.oracle_start(mat, vec, cfg)
        assert oracle.shape == (S, p, K)
        for c in range(S):
            assert torch.equal(oracle[c], tred.oracle_start(mat[c], vec[c],
                                                            cfg))
        bufs = [tred.staged_start(dot_block_rows(
            mat[..., r * nl:(r + 1) * nl], vec[..., r * nl:(r + 1) * nl]),
            cfg, r) for r in range(p)]
        sent = [0] * p
        for step in range(stages + 1):           # one step past the ladder
            hops = [tred.ladder_step(r, p, stages, step) for r in range(p)]
            for i in range(len(hops[0])):
                box = {}
                for r in range(p):
                    h = hops[r][i]
                    msg = bufs[r].select(-2, h.send_slot).clone()
                    assert msg.shape == (S, K)
                    sent[r] += msg.numel() * msg.element_size()
                    box[(r, h.send_to, h.k)] = msg
                for r in range(p):
                    h = hops[r][i]
                    bufs[r].select(-2, h.recv_slot).copy_(
                        box.pop((h.recv_from, r, h.k)))
                assert not box
        want = tred.ordered_reduce(oracle, torch.float64, False)
        for r in range(p):
            assert torch.equal(bufs[r], oracle)
            assert torch.equal(tred.ordered_reduce(bufs[r], torch.float64,
                                                   False), want)
            assert sent[r] == tred.reduction_wire_bytes(p, l, S)
        assert tred.hop_payload_bytes(l, S) == S * K * 8


@pytest.mark.parametrize("p", [1, 2, 4])
def test_slab_halo_messages_in_lockstep_equal_stacked_halos(p):
    """The slab halos' message lists (every column's boundary plane, or
    send set, in ONE message a neighbour), routed in lockstep through a
    dict and assembled per rank, give the stacked in-process halos of the
    slab, and each column's is its one-column halo."""
    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.standard_normal((S, 16 * 12)))
    g = X.reshape(S, p, 16 // p, 12)
    msgs = [tdist.plane_messages(g[:, r], r, p, x_axis=1) for r in range(p)]
    assert all(t.shape == (S, 12) for m in msgs for _, _, t in m[0])
    got = _route(msgs)
    ext = tdist.halo_first_dim(X.reshape(S, p, -1), 12)
    for r in range(p):
        above = below = torch.zeros((S, 12), dtype=X.dtype)
        for (peer, _, _), t in zip(msgs[r][1], got[r]):
            if peer < r:
                above = t
            else:
                below = t
        assert torch.equal(torch.cat([above, g[:, r].reshape(S, -1), below],
                                     dim=1), ext[:, r])
    for c in range(S):
        assert torch.equal(ext[c], tdist.halo_first_dim(X[c].reshape(p, -1),
                                                        12))
    top, _ = _port("ell", max(p, 2))
    plan = tpart.partition_spd(top, p)
    xl = torch.as_tensor(rng.standard_normal((S, top.n))).reshape(
        S, p, plan.nxl)
    msgs = [tpart.halo_messages(xl[:, r], plan.send_up[r], plan.send_dn[r],
                                r, p) for r in range(p)]
    got = _route(msgs)
    stacked = tpart.halo_exchange(xl, plan.send_up, plan.send_dn)
    for r in range(p):
        assert torch.equal(tpart.halo_assemble(
            xl[:, r], plan.hops, plan.max_send, r, msgs[r][1], got[r]),
            stacked[:, r])
    for c in range(S):
        assert torch.equal(stacked[c], tpart.halo_exchange(
            xl[c], plan.send_up, plan.send_dn))


@pytest.mark.parametrize("kind", ["2d5", "3d7", "3d27", "ell"])
def test_slab_shard_applies_stack_to_the_whole_slab(kind):
    """Each rank's apply of a slab (s, nl), its halo planes (or extended
    vector) taken from the whole slab, stacks to the operator's apply of
    the slab, bitwise, and each row is the rank's apply of that column."""
    p = 4
    if kind == "3d27":
        top = convert.operator("stencil3d27", device="cpu", nx=8, ny=4, nz=5,
                               centre=15.0)
    else:
        top, _ = _port(kind, p)
    X = torch.as_tensor(np.random.default_rng(8).standard_normal((S, top.n)))
    nl = top.n // p
    arrays, build, perm = tdist._partition_op(top, p)
    assert perm is None
    if kind == "ell":
        ext = tpart.halo_exchange(X.reshape(S, p, nl), arrays["send_up"],
                                  arrays["send_dn"])
    else:
        dims = (top.nx, top.ny) if kind == "2d5" else (top.nx, top.ny,
                                                       top.nz)
        G, nxl = X.reshape((S,) + dims), top.nx // p

    def halo(r, c=None):
        """Rank r's halo source for the slab (c None) or its column c."""
        if kind == "ell":
            return lambda x: ext[:, r] if c is None else ext[c, r]
        Gc = G if c is None else G[c]
        ax = Gc.dim() - len(dims)
        zero = torch.zeros_like(Gc.narrow(ax, 0, 1))
        up = Gc.narrow(ax, r * nxl - 1, 1) if r else zero
        dn = Gc.narrow(ax, (r + 1) * nxl, 1) if r + 1 < p else zero
        return lambda g: (up, dn)

    outs = []
    for r in range(p):
        loc = tdist.shard_arrays(arrays, p, r)
        y = build(loc, halo(r))(X[:, r * nl:(r + 1) * nl])
        for c in range(S):
            assert torch.equal(
                y[c], build(loc, halo(r, c))(X[c, r * nl:(r + 1) * nl]))
        outs.append(y)
    assert torch.equal(torch.cat(outs, dim=1), top.apply(X))


# ------------------------------- the halo plug-ins in the slab form --
def _slab_triple(layout, n, seed):
    """An (s, NV, n) slab, its (s, IX) index table (each column at its own
    cycle index) and (s, IS) scalars."""
    rng = np.random.default_rng(seed)
    IS = tfi.scal_layout(layout.l)
    l = layout.l
    S_ = rng.standard_normal((S, layout.nv, n))
    idx = np.asarray([tfi.host_idx(layout, i) for i in
                      (0, l, 2 * l + 3, 3 * l + 7)], np.int32)
    scal = rng.standard_normal((S, IS["size"]))
    scal[:, IS["dlt_safe"]] = 1.25
    scal[:, IS["eta_new_safe"]] = 0.75
    scal[:, IS["eta0_safe"]] = 1.5
    return S_, idx, scal


def _halo_slab_case(kind, device, col=0):
    """Shard 1 of 4 of ``kind``: its halo plug-in, whose ``prepare`` takes
    the ring-top rows, a slab's (s, nl) or column ``col``'s (nl,), to their
    operands from the in-process halo of fixed neighbour rows (each
    column's own), and its inverse diagonal."""
    top, prec = _port(kind, 4, device)
    p, r, nl = 4, 1, top.n // 4
    arrays, _, _ = tdist._partition_op(top, p)
    loc = tdist._one_shard(tdist.shard_arrays(arrays, p, r))
    others = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (S, top.n)), device=device)

    def prepare(z):
        whole = others.clone() if z.dim() == 2 else others[col].clone()
        whole[..., r * nl:(r + 1) * nl] = z
        stack = whole.reshape(tuple(whole.shape[:-1]) + (p, nl))
        if kind == "ell":
            ext = tpart.halo_exchange(stack, arrays["send_up"],
                                      arrays["send_dn"])
        else:
            ext = tdist.halo_first_dim(stack, top.n // top.nx)
        return ext[..., r, :].contiguous()

    spmv = tdist.fused_spmv_local(top, loc, p, prepare)
    return spmv, prec.inv_diag[r * nl:(r + 1) * nl], nl


@pytest.mark.parametrize("kind", ["2d5", "3d7", "ell"])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_halo_plugin_slab_is_its_columns(kind, l):
    """A halo plug-in's slab (plain version here): one ``prepare`` of the
    s columns' ring-top rows, then each column's shard expression on its
    row of the operand, bitwise the single-column plug-in on each column
    (its own cycle index, its own scalars)."""
    spmv, inv, nl = _halo_slab_case(kind, "cpu")
    for rec in ("ghysels", "stable"):
        layout = tfi.SlabLayout(l=l, RB=max(l + 1, 3), recurrence=rec)
        fiter = tfi.build_fused_iteration(layout, spmv, inv)
        S_, idx, scal = (torch.as_tensor(a) for a in
                         _slab_triple(layout, nl, seed=5 * l))
        S_s, d_s = fiter(S_.clone(), idx, scal)
        assert d_s.shape == (S, 2 * l + 1)
        for c in range(S):
            one = tfi.build_fused_iteration(
                layout, _halo_slab_case(kind, "cpu", c)[0], inv)
            S_c, d_c = one(S_[c].clone(), idx[c], scal[c])
            assert torch.equal(S_s[c], S_c)
            assert torch.equal(d_s[c], d_c)


@pytest.mark.cuda
def test_halo_plugin_slab_bitwise_on_card():
    """On the card: the halo plug-ins' slab launch (ONE launch for the s
    columns, counted under ``launch_key(kind, l, slab=True)``) against
    its plain version, rows bitwise, partials within 1e-12 of sum |m u|,
    at l in {1, 2, 9}."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref as tref

    dev = torch.device("cuda")
    for kind in ("2d5", "3d7", "ell"):
        spmv, inv, nl = _halo_slab_case(kind, dev)
        for l in (1, 2, 9):
            layout = tfi.SlabLayout(l=l, RB=max(l + 1, 3))
            fiter = tfi.build_fused_iteration(layout, spmv, inv)
            S_, idx, scal = (torch.as_tensor(a, device=dev) for a in
                             _slab_triple(layout, nl, seed=l))
            S_p, _ = fiter.plain(S_.clone(), idx, scal)
            _build.reset_launches()
            S_k, d_k = fiter(S_.clone(), idx, scal)
            torch.cuda.synchronize()
            assert _build.LAUNCHES[tfi.launch_key(spmv.kind, l, True)] == 1
            assert torch.equal(S_k, S_p)
            ext = spmv.prepare(torch.stack([S_[c, int(idx[c, 5 * l])]
                                            for c in range(S)]))
            for c in range(S):
                _, mat, u = tref.fused_iter_unfused(
                    S_[c], idx[c], scal[c],
                    lambda z, e=ext[c]: spmv.ext_expr(e),
                    lambda v: inv * v, layout)
                scale = (mat.abs() * u.abs()[None, :]).sum(dim=1)
                d_p = (mat * u[None, :]).sum(dim=1)
                assert ((d_k[c] - d_p).abs() <= 1e-12 * scale).all()


# ------------------------------------ the ring and the governor, staged --
def test_instrumented_governed_staged_oracle_matches_jax(with_jax):
    """The ladder oracle's instrumented, governed solve (``recurrence=
    "stable"``, l = 4, the JAX package's shifts): the same actions at the
    same iterations as the JAX package's staged oracle, the rings within
    the stated bounds; its slab of 4 gives each column its one-column
    ring and governor vector bitwise."""
    jop = jops.Stencil2D5(48, 24)
    jprec = JJacobi.from_operator(jop)
    top = convert.operator("stencil2d5", nx=48, ny=24, device="cpu")
    tprec = convert.jacobi(np.asarray(jprec.inv_diag), "cpu")
    b = np.random.default_rng(0).standard_normal(jop.n)
    sig = np.asarray(jshifts(jop, 4, prec=jprec))
    kw = dict(l=4, tol=1e-5, maxit=400, max_restarts=120,
              recurrence="stable", telemetry_cap=512)
    be = LocalBackend(device="cpu", reduction="staged", virtual_shards=4)
    rt = be.solve(top, b, prec=tprec, sigmas=convert.sigmas(sig, "cpu"),
                  governor=GovernorConfig(), **kw)
    rj = jget_backend("local", reduction="staged", virtual_shards=4).solve(
        jop, jnp.asarray(b), method="plcg", prec=jprec,
        sigmas=jnp.asarray(sig), governor=JGov(), **kw)
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.iters) == int(rj.iters)
    assert int(rt.restarts) == int(rj.restarts) > 0
    ct = TelemetrySlab(cap=512, l=4).unpack(rt.telemetry.numpy())
    cj = JSlab(cap=512, l=4).unpack(np.asarray(rj.telemetry))
    for name in DISCRETE:
        np.testing.assert_array_equal(ct[name], cj[name], err_msg=name)
    np.testing.assert_allclose(ct["rnorm"], cj["rnorm"], rtol=RNORM_RTOL)
    scale = np.abs(cj["dots"]).max(axis=-1, keepdims=True)
    assert (np.abs(ct["dots"] - cj["dots"])
            <= DOTS_RTOL * np.maximum(scale, 1e-300)).all()
    B = np.stack([b] + [np.random.default_rng(k).standard_normal(jop.n)
                        for k in (1, 2, 3)])
    rs = be.solve_batched(top, torch.as_tensor(B), prec=tprec,
                          sigmas=convert.sigmas(sig, "cpu"),
                          governor=GovernorConfig(), **kw)
    assert torch.equal(rs.telemetry[0], rt.telemetry)
    assert torch.equal(rs.governor[0], rt.governor)
    for j in (1, 3):
        one = be.solve(top, B[j], prec=tprec,
                       sigmas=convert.sigmas(sig, "cpu"),
                       governor=GovernorConfig(), **kw)
        assert torch.equal(rs.telemetry[j], one.telemetry)
        assert torch.equal(rs.governor[j], one.governor)
        assert torch.equal(rs.x[j], one.x)


# ------------------------------------------------------- the state mask --
@pytest.mark.parametrize("method", ["cg", "pcg", "plcg"])
def test_vector_mask_names_the_row_decomposed_leaves(method, with_jax):
    """``vector_mask`` marks the leaves the JAX package's does (the port's
    host clocks ``k`` and ``t`` are replicated); on a staged slab state
    over 4 virtual shards ``split_state`` gives the (s, ..., n) vector
    leaves and leaves out the D ring."""
    from repro.core import batched as jbatched

    tm, jm = batched.vector_mask(method), jbatched.vector_mask(method)

    def flat(m, prefix=""):
        out = {}
        for name, v in zip(m._fields, m):
            if isinstance(v, tuple) and hasattr(v, "_fields"):
                out.update(flat(v, prefix + name + "."))
            else:
                out[prefix + name] = v
        return out

    ft, fj = flat(tm), flat(jm)
    assert {k: v for k, v in ft.items() if k in fj} == fj
    assert not any(v for k, v in ft.items() if k not in fj)
    top, prec = _port("2d5")
    B = torch.as_tensor(_slab(top.n))
    ops = tdist.rank_oracle_ops(top, prec, tred.StagedConfig(4))
    kw = dict(tol=1e-9, maxit=100)
    if method == "plcg":
        from repro_torch.core.chebyshev import shifts_for_operator
        kw.update(l=2, sigmas=shifts_for_operator(top, 2, prec=prec))
    prog = batched.slab_program(ops, S, top.n, method, kw, 8)
    st = prog.chunk(B, prog.init(B))
    vec, rep = batched.split_state(st, method)
    assert vec and all(v.shape[0] == S and v.shape[-1] == top.n
                       for v in vec)
    assert all(v.shape[-1] != top.n for v in rep
               if isinstance(v, torch.Tensor))
    if method == "plcg":
        assert not any(v is st.cyc.D for v in vec + rep)

