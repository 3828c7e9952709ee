"""Whole p(l)-CG solves of the PyTorch port against the JAX package's
``pipelined_cg.solve`` on the same operator, right-hand side and shifts
(the JAX objects' data carried across by ``repro_torch.convert``), and
the port's own invariants: fused == unfused and ``unroll=k`` ==
``unroll=1``, bitwise, on the CPU.

Tolerances (port vs JAX): the arithmetic differs only by XLA's FMA
contraction and the dot-block reduction order, ~1e-16 relative per op.
Rounding differences grow along the Krylov recurrence, so the residual
histories agree to 1e-9 relative over the first 10 iterations, the
iteration counts within 2 and the solutions within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

from repro.core import pipelined_cg as jpc  # noqa: E402
from repro.core.chebyshev import shifts_for_operator as jshifts  # noqa: E402
from repro.core.types import SolverOps as JOps  # noqa: E402
from repro.linalg import operators as jops  # noqa: E402
from repro.linalg.preconditioners import JacobiPrec as JJacobi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import laplace2d  # noqa: E402
from repro_torch.configs.problems import build_operator  # noqa: E402
from repro_torch.core import pipelined_cg as tpc  # noqa: E402
from repro_torch.core.chebyshev import shifts_for_operator  # noqa: E402
from repro_torch.core.types import SolverOps as TOps  # noqa: E402
from repro_torch.linalg import JacobiPrec, Stencil2D5, Stencil3D27  # noqa: E402
from repro_torch.parallel.backends import LocalBackend, get_backend  # noqa: E402


def _ops(name):
    if name == "stencil2d5":
        j = jops.Stencil2D5(16, 12)
        return j, convert.operator(name, nx=16, ny=12, device="cpu")
    if name == "stencil3d7":
        j = jops.Stencil3D7(8, 6, 4, eps_z=0.1)
        return j, convert.operator(name, nx=8, ny=6, nz=4, eps_z=0.1,
                                   device="cpu")
    j = jops.DiagonalOp(jops.laplacian_2d_spectrum(8, 6))
    return j, convert.operator("diagonal", d=np.asarray(j.d), device="cpu")


def _both(name, l, rec, jac, replace_every=0, tol=1e-8, prec_shifts=True):
    jop, top = _ops(name)
    jp = JJacobi.from_operator(jop) if jac else None
    tp = convert.jacobi(np.asarray(jp.inv_diag), "cpu") if jac else None
    sig = np.asarray(jshifts(jop, l, prec=jp if prec_shifts else None))
    b = np.random.default_rng(0).standard_normal(jop.n)
    kw = dict(tol=tol, maxit=400, recurrence=rec,
              replace_every=replace_every)
    rj = jpc.solve(JOps.local(jop, jp), jnp.asarray(b), l,
                   sigmas=jnp.asarray(sig), **kw)
    rt = tpc.solve(TOps.local(top, tp), torch.as_tensor(b), l,
                   sigmas=convert.sigmas(sig, "cpu"), **kw)
    return rj, rt


def _assert_close_to_jax(rj, rt):
    assert bool(rj.converged) and bool(rt.converged)
    assert abs(int(rj.iters) - int(rt.iters)) <= 2
    assert int(rj.restarts) == int(rt.restarts)
    hj, ht = np.asarray(rj.res_history), rt.res_history.numpy()
    np.testing.assert_allclose(ht[:10], hj[:10], rtol=1e-9)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-6 * np.linalg.norm(xj)


@pytest.mark.parametrize("l,rec,jac", [
    (1, "ghysels", False), (1, "stable", True), (2, "ghysels", True),
    (2, "stable", False), (3, "ghysels", False), (3, "stable", True),
])
def test_solve_matches_jax(l, rec, jac):
    _assert_close_to_jax(*_both("stencil2d5", l, rec, jac))


@pytest.mark.parametrize("name,l,rec,jac,replace_every", [
    ("stencil3d7", 2, "ghysels", True, 0),
    ("diagonal", 2, "ghysels", False, 0),
    ("stencil2d5", 2, "ghysels", True, 20),
    ("stencil2d5", 3, "stable", False, 15),
])
def test_solve_matches_jax_more_operators(name, l, rec, jac, replace_every):
    rj, rt = _both(name, l, rec, jac, replace_every=replace_every)
    _assert_close_to_jax(rj, rt)
    if replace_every:
        assert int(rt.restarts) >= 1


def test_restart_matches_jax():
    """Jacobi on a diagonal operator: M^{-1}A = I, the first late
    iteration breaks down and the steepest-descent guard of the restart
    lands on the exact solution (a lucky breakdown)."""
    rj, rt = _both("diagonal", 2, "ghysels", True, prec_shifts=False)
    assert int(rj.restarts) == int(rt.restarts) == 1
    _assert_close_to_jax(rj, rt)


def _assert_bitwise(ra, rb):
    assert torch.equal(ra.x, rb.x)
    assert torch.equal(ra.res_history, rb.res_history)
    for f in ("iters", "restarts", "converged", "norm0"):
        assert torch.equal(getattr(ra, f), getattr(rb, f)), f


@pytest.mark.parametrize("name,l,jac,replace_every", [
    ("stencil2d5", 2, True, 0), ("stencil3d27", 1, False, 0),
    ("diagonal", 3, False, 0), ("stencil2d5", 3, True, 20),
])
def test_fused_equals_unfused_bitwise(name, l, jac, replace_every):
    op = (Stencil3D27(6, 6, 4, device="cpu") if name == "stencil3d27"
          else _ops(name)[1])
    prec = JacobiPrec.from_operator(op) if jac else None
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(op.n))
    kw = dict(sigmas=shifts_for_operator(op, l, prec=prec), tol=1e-9,
              maxit=300, replace_every=replace_every)
    rf = tpc.solve(TOps.local(op, prec), b, l, fused_iteration=True, **kw)
    ru = tpc.solve(TOps.local(op, prec), b, l, fused_iteration=False, **kw)
    assert bool(ru.converged)
    _assert_bitwise(rf, ru)


@pytest.mark.parametrize("fused", [False, True])
def test_unroll_is_bitwise_equal_to_unroll_1(fused):
    """Predicated iterations past a stop or a due interrupt change
    nothing observable: the whole result is bitwise the same, with fewer
    host synchronisations.  Covers replacements (interrupts due inside a
    window) and convergence inside a window."""
    op = Stencil2D5(16, 12, device="cpu")
    prec = JacobiPrec.from_operator(op)
    b = torch.as_tensor(np.random.default_rng(2).standard_normal(op.n))
    kw = dict(sigmas=shifts_for_operator(op, 2, prec=prec), tol=1e-9,
              maxit=300, replace_every=17, fused_iteration=fused)
    r1 = tpc.solve(TOps.local(op, prec), b, 2, unroll=1, **kw)
    r7 = tpc.solve(TOps.local(op, prec), b, 2, unroll=7, **kw)
    assert bool(r1.converged) and int(r1.restarts) >= 2
    _assert_bitwise(r1, r7)
    assert r7.host_syncs < r1.host_syncs / 3
    # a stop by maxit inside a window
    kw.update(maxit=23, tol=1e-30)
    _assert_bitwise(tpc.solve(TOps.local(op, prec), b, 2, unroll=1, **kw),
                    tpc.solve(TOps.local(op, prec), b, 2, unroll=7, **kw))


def test_local_backend_and_refusals():
    op = build_operator(laplace2d.smoke_config(), device="cpu")
    prec = JacobiPrec.from_operator(op)
    b = np.random.default_rng(3).standard_normal(op.n)
    be = get_backend("local", device="cpu")
    assert isinstance(be, LocalBackend)
    res = be.solve(op, b, prec=prec, l=2, tol=1e-6, maxit=500,
                   sigmas=shifts_for_operator(op, 2, prec=prec),
                   fused_iteration=True, unroll=16)
    bt = torch.as_tensor(b)
    rel = torch.linalg.norm(bt - op.apply(res.x)) / torch.linalg.norm(bt)
    assert bool(res.converged) and float(rel) < 1e-5
    assert res.x.device.type == "cpu" and res.x.shape == (op.n,)
    for bad, exc in [
        (lambda: be.solve(op, b, method="cg", l=2), NotImplementedError),
        (lambda: be.solve(op, b, method="nope", l=2), ValueError),
        (lambda: be.solve(op, b, l=2, governor=object()),
         NotImplementedError),
        (lambda: be.solve(op, b, l=2, telemetry_cap=8), NotImplementedError),
        (lambda: be.solve(op, b, l=2, checkpoint=object()),
         NotImplementedError),
        (lambda: be.solve(op, b, l=2, recurrence="nope"), ValueError),
        (lambda: be.solve(Stencil2D5(32, 24, use_kernel=True, device="cpu"),
                          b, l=2, fused_iteration=True), ValueError),
        (lambda: LocalBackend(reduction="staged", device="cpu"),
         NotImplementedError),
        (lambda: get_backend("shard_map"), NotImplementedError),
    ]:
        with pytest.raises(exc):
            bad()
