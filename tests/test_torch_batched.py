"""Batched multi-RHS solves of the PyTorch port (``repro_torch.core.batched``)
against the port's own sequential solves and the JAX package's
``solve_batched``, on the CPU at smoke size.

Tolerances:
* batched against the port's sequential solve: the same arithmetic on the
  same device, so iteration counts are equal and histories bitwise (the
  slab's dot block sums each column's rows in the single-column order on
  the CPU);
* port against JAX: the convention of tests/test_torch_pipelined_cg.py
  (XLA contracts multiply-adds and sums the dot block in another order):
  the first 10 history entries within 1e-9 relative and the solutions
  within 1e-10 relative; the iteration counts are equal at this size;
* fused against unfused slabs: bitwise (the CPU superkernel is the plain
  vector phase applied to each column).

The slab is (s, n), one right-hand side a row; the JAX package's ``B`` is
(n, s), transposed at the boundary here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

from repro.core.chebyshev import shifts_for_operator as jshifts  # noqa: E402
from repro.linalg import operators as jops  # noqa: E402
from repro.parallel import get_backend as jget_backend  # noqa: E402
from repro_torch.core import METHODS, batched, pipelined_cg  # noqa: E402
from repro_torch.core.chebyshev import shifts_for_operator  # noqa: E402
from repro_torch.core.types import SolverOps  # noqa: E402
from repro_torch.kernels import ell_spmv, stencil_spmv  # noqa: E402
from repro_torch.linalg import JacobiPrec, Stencil2D5  # noqa: E402
from repro_torch.linalg.sparse import random_fem_mesh, rcm_reorder  # noqa: E402
from repro_torch.parallel.backends import (  # noqa: E402
    LocalBackend, MultiprocessBackend, get_backend)
from repro_torch.parallel.backends.base import ReductionBackend  # noqa: E402


def _slab(n, s=4, seed=7, zero=2):
    """(s, n) right-hand sides from a seeded generator; row ``zero`` is a
    padding column."""
    B = np.random.default_rng(seed).standard_normal((s, n))
    if zero is not None:
        B[zero] = 0.0
    return B


def _cpu():
    return get_backend("local", device="cpu")


@pytest.mark.parametrize("method", ["cg", "pcg", "plcg"])
def test_batched_matches_sequential_and_jax(method):
    """Each row of the batched solve is the port's sequential solve of that
    row (iterations equal, history bitwise) and matches the JAX package's
    batched solve of the same columns; the zero row retires at iteration 0
    converged."""
    jop = jops.Stencil2D5(16, 16)
    op = Stencil2D5(16, 16, device="cpu")
    B = _slab(op.n)
    kw = dict(tol=1e-9, maxit=800)
    jkw, tkw = dict(kw), dict(kw)
    if method == "plcg":
        sig = np.asarray(jshifts(jop, 2))
        jkw.update(l=2, sigmas=jnp.asarray(sig))
        tkw.update(l=2, sigmas=torch.tensor(sig))
    rb = _cpu().solve_batched(op, torch.as_tensor(B), method=method, **tkw)
    rj = jget_backend("local").solve_batched(jop, jnp.asarray(B.T),
                                             method=method, **jkw)
    sops = SolverOps.local(op)
    for j in range(B.shape[0]):
        rs = METHODS[method](sops, torch.as_tensor(B[j]), tkw)
        assert int(rb.iters[j]) == int(rs.iters)
        assert torch.equal(rb.res_history[j], rs.res_history)
        assert torch.equal(rb.x[j], rs.x)
        assert int(rb.iters[j]) == int(rj.iters[j])
        hj, ht = np.asarray(rj.res_history[j]), rb.res_history[j].numpy()
        np.testing.assert_allclose(ht[:10], hj[:10], rtol=1e-9)
        xj = np.asarray(rj.x[j])
        assert np.linalg.norm(rb.x[j].numpy() - xj) <= \
            1e-10 * max(np.linalg.norm(xj), 1e-300)
    assert int(rb.iters[2]) == 0 and bool(rb.converged[2])
    assert not rb.x[2].any()


@pytest.mark.parametrize("l", [1, 2, 3])
def test_batched_fused_equals_unfused_bitwise(l):
    """The slab through the superkernel's slab form and through the
    unfused slab vector phase, bit for bit, and each row the sequential
    fused solve.  Jacobi with the shifts of A (not of M^{-1}A) breaks the
    basis down: the columns restart at different iterations, so the slab
    runs with its columns at different cycle indices (several
    scalar-phase groups)."""
    op = Stencil2D5(16, 12, device="cpu")
    prec = JacobiPrec.from_operator(op)
    B = torch.as_tensor(_slab(op.n, zero=None, seed=l))
    kw = dict(method="plcg", prec=prec, l=l,
              sigmas=shifts_for_operator(op, l), tol=1e-9, maxit=300,
              unroll=4)
    pipelined_cg.SCALAR_GROUPS.clear()
    ru = _cpu().solve_batched(op, B, fused_iteration=False, **kw)
    rf = _cpu().solve_batched(op, B, fused_iteration=True, **kw)
    assert torch.equal(ru.res_history, rf.res_history)
    assert torch.equal(ru.x, rf.x)
    assert torch.equal(ru.iters, rf.iters)
    assert max(pipelined_cg.SCALAR_GROUPS) >= 2
    assert int(ru.restarts.max()) > 0
    ops = SolverOps.local(op, prec)
    skw = {k: v for k, v in kw.items() if k not in ("method", "prec")}
    rs = METHODS["plcg"](ops, B[1], dict(skw, fused_iteration=True))
    assert torch.equal(rf.res_history[1], rs.res_history)


class _Counting:
    """SolverOps whose dot-block starts and superkernel calls are counted
    (the payload shape of each start is kept)."""

    def __init__(self, op, prec):
        base = SolverOps.local(op, prec)
        self.starts, self.launches, self.shapes = 0, 0, []

        def start(mat, vec):
            self.starts += 1
            self.shapes.append(tuple(mat.shape[:-1]))
            return base.dot_block(mat, vec)

        def partials(p):
            self.starts += 1
            self.shapes.append(tuple(p.shape))
            return p

        def factory(layout):
            fiter = base.fused_iter_factory(layout)

            def counted(S, idx, scal):
                self.launches += 1
                return fiter(S, idx, scal)

            return counted

        self.ops = SolverOps.create(
            apply_a=base.apply_a, prec=base.prec, dot_block=base.dot_block,
            dot_block_start=start, combine_partials=partials,
            fused_iter_factory=factory)


@pytest.mark.parametrize("fused", [False, True])
def test_one_start_one_launch_per_slab_iteration(fused):
    """Every slab iteration issues exactly ONE (s, K) dot-block start and,
    fused, ONE superkernel call, with the s = 4 columns at different cycle
    indices (column 1 re-initialized mid-run)."""
    op = Stencil2D5(12, 12, device="cpu")
    prec = JacobiPrec.from_operator(op)
    cnt = _Counting(op, prec)
    B = torch.as_tensor(_slab(op.n, zero=None))
    kw = dict(l=2, sigmas=shifts_for_operator(op, 2, prec=prec), tol=1e-30,
              maxit=60, fused_iteration=fused)
    sl = batched._Slab(cnt.ops, B, "plcg", kw)
    st = sl.init_cols(None, B, [0, 1, 2, 3])
    seen = set()
    for k in range(24):
        if k == 5:
            st = sl.init_cols(st, B, [1])
        s0, l0, n0 = cnt.starts, cnt.launches, len(cnt.shapes)
        st = sl.step(st, sl.active(st))
        assert cnt.starts - s0 == 1
        assert cnt.launches - l0 == (1 if fused else 0)
        assert cnt.shapes[n0:] == [(4, 5)]
        seen.add(len({pipelined_cg.decision_key(i, 2) for i in st.cyc.i}))
    assert max(seen) >= 2, "the columns never sat at different indices"


def test_retired_column_bitwise_frozen():
    """Masked retirement: once a column's loop stops, further chunks leave
    its iterate unchanged to the bit while its slab-mates iterate on.
    Column 0 is an eigenmode of the Laplacian, converged in a couple of
    iterations."""
    op = Stencil2D5(16, 16, device="cpu")
    B = torch.as_tensor(_slab(op.n))
    ii, jj = np.meshgrid(np.arange(1, 17), np.arange(1, 17), indexing="ij")
    B[0] = torch.as_tensor((np.sin(np.pi * ii / 17)
                            * np.sin(np.pi * jj / 17)).reshape(-1))
    prog = _cpu().make_slab_program(op, s=4, method="plcg", chunk_iters=10,
                                    l=2, sigmas=shifts_for_operator(op, 2),
                                    tol=1e-9, maxit=800)
    st = prog.init(B)
    seen_frozen, snapshot = False, {}
    for _ in range(40):
        st = prog.chunk(B, st)
        running = prog.status(B, st).running.tolist()
        x = prog.extract(B, st).x
        for j in range(4):
            if not running[j]:
                if j in snapshot:
                    assert torch.equal(x[j], snapshot[j]), j
                    seen_frozen = True
                else:
                    snapshot[j] = x[j].clone()
        if not any(running):
            break
    assert seen_frozen
    assert not prog.status(B, st).running.any()


def test_slot_recycling_matches_direct_solve(monkeypatch):
    """Retire, inject a fresh right-hand side into slot 1, solve on: the
    recycled solve matches a direct solve, the other slots stay bitwise,
    and the slab program is built once for all of it."""
    builds = []
    real = batched.BUILDERS["plcg"]
    monkeypatch.setitem(batched.BUILDERS, "plcg",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    op = Stencil2D5(16, 16, device="cpu")
    B = torch.as_tensor(_slab(op.n))
    prog = _cpu().make_slab_program(op, s=4, method="plcg", chunk_iters=50,
                                    l=2, sigmas=shifts_for_operator(op, 2),
                                    tol=1e-9, maxit=800)
    st = prog.init(B)
    for _ in range(6):
        st = prog.chunk(B, st)
    assert not prog.status(B, st).running.any()
    res0 = prog.extract(B, st)
    b_new = np.random.default_rng(11).standard_normal(op.n)
    B2 = B.clone()
    B2[1] = torch.as_tensor(b_new)
    st = prog.inject(B2, st, [False, True, False, False])
    assert prog.status(B2, st).iters.tolist()[1] == 0
    for _ in range(6):
        st = prog.chunk(B2, st)
    res1 = prog.extract(B2, st)
    x_direct = np.linalg.solve(op.to_dense(), b_new)
    np.testing.assert_allclose(res1.x[1].numpy(), x_direct, atol=1e-6)
    for j in (0, 2, 3):
        assert torch.equal(res1.x[j], res0.x[j])
    assert len(builds) == 1


def test_zero_padded_partial_slab_retires_at_iter_zero():
    """A partial slab's zero columns retire at iteration 0 exactly, count
    no slot iterations and keep x exactly zero."""
    op = Stencil2D5(12, 12, device="cpu")
    prog = _cpu().make_slab_program(op, s=4, method="plcg", chunk_iters=20,
                                    l=2, sigmas=shifts_for_operator(op, 2),
                                    tol=1e-9, maxit=400)
    B = torch.zeros((4, op.n), dtype=torch.float64)
    B[1] = torch.as_tensor(np.random.default_rng(0).standard_normal(op.n))
    st = prog.init(B)
    stat0 = prog.status(B, st)
    assert stat0.running.tolist() == [False, True, False, False]
    assert stat0.iters.tolist() == [0, 0, 0, 0]
    for _ in range(40):
        before = prog.status(B, st).iters
        st = prog.chunk(B, st)
        after = prog.status(B, st).iters
        assert batched.slab_slot_iterations(before, after) == \
            int(after[1] - before[1])
        if not prog.status(B, st).running.any():
            break
    res = prog.extract(B, st)
    assert res.iters.tolist()[0] == 0 and res.iters[1] > 0
    for j in (0, 2, 3):
        assert not res.x[j].any()


def test_slab_spmv_plain_forms_match_single():
    """The slab forms' plain versions (what the CPU runs): each row of a
    slab apply is the single apply, bitwise, for the stencils, ELL and
    the operators' ``apply``."""
    g = torch.as_tensor(np.random.default_rng(1).standard_normal((3, 6, 5)))
    out = stencil_spmv.stencil2d5(g)
    assert all(torch.equal(out[c], stencil_spmv.stencil2d5(g[c]))
               for c in range(3))
    g3 = torch.as_tensor(
        np.random.default_rng(2).standard_normal((3, 4, 5, 6)))
    out = stencil_spmv.stencil3d7(g3, 0.1)
    assert all(torch.equal(out[c], stencil_spmv.stencil3d7(g3[c], 0.1))
               for c in range(3))
    sop, _ = rcm_reorder(random_fem_mesh(0, 60, device="cpu"))
    X = torch.as_tensor(np.random.default_rng(3).standard_normal((3, sop.n)))
    y = ell_spmv.ell_spmv(X, sop.cols, sop.vals)
    assert y.shape == (3, sop.n)
    assert all(torch.equal(y[c], ell_spmv.ell_spmv(X[c], sop.cols,
                                                   sop.vals))
               for c in range(3))
    assert all(torch.equal(sop.apply(X)[c], sop.apply(X[c]))
               for c in range(3))


def test_backends_batched_surface():
    """``get_backend("local")`` builds slab programs and batched solvers,
    on the monolithic dot block and on the ladder oracle
    (``reduction="staged"``, each column bitwise its one-column oracle
    solve); the multiprocess backend has its own batched entry points
    (tests/test_torch_batched_ranks.py runs them), so nothing refuses
    batched work over ranks."""
    op = Stencil2D5(8, 8, device="cpu")
    B = torch.as_tensor(_slab(op.n, zero=None))
    be = _cpu()
    r = be.make_batched_solver(op, method="cg", tol=1e-8, maxit=200)(B)
    assert r.x.shape == (4, op.n) and bool(r.converged.all())
    prog = be.make_slab_program(op, s=4, method="cg", tol=1e-8, maxit=200)
    assert prog.s == 4 and prog.n == op.n
    staged = LocalBackend(device="cpu", reduction="staged", virtual_shards=2)
    rs = staged.solve_batched(op, B, method="cg", tol=1e-8, maxit=200)
    for c in range(B.shape[0]):
        one = staged.solve(op, B[c], method="cg", tol=1e-8, maxit=200)
        assert torch.equal(rs.x[c], one.x)
        assert torch.equal(rs.res_history[c], one.res_history)
    assert staged.make_slab_program(op, s=4, method="cg").s == 4
    for name in ("solve_batched", "make_batched_solver",
                 "make_slab_program"):
        assert getattr(MultiprocessBackend, name) is not getattr(
            ReductionBackend, name)
