"""The paper's two baselines in the PyTorch port, classic CG and Ghysels
p-CG, against the JAX package's ``classic_cg.solve`` and
``ghysels_pcg.solve`` on the same operator and right-hand side (numpy
inputs from a seed), mirroring ``tests/test_cg_convergence.py`` and
``tests/test_residual_replacement.py``; and the port's own invariant:
``unroll=k`` is bitwise equal to ``unroll=1``.

Tolerances (port vs JAX, fp64), the convention of
``tests/test_torch_pipelined_cg.py``: the arithmetic differs only by
XLA's FMA contraction and the dot-block reduction order, ~1e-16 relative
per op, growing along the recurrence; so both converge, the iteration
counts agree within 2, the residual histories to 1e-9 relative over the
first 10 iterations, and the solutions within 1e-6 relative.  Against a
direct solve: the reference tests' own bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core import classic_cg as jcg  # noqa: E402
from repro.core import ghysels_pcg as jpcg  # noqa: E402
from repro.core import pipelined_cg as jpc  # noqa: E402
from repro.core.chebyshev import shifts_for_operator as jshifts  # noqa: E402
from repro.core.types import SolverOps as JOps  # noqa: E402
from repro.linalg import operators as jops  # noqa: E402
from repro.linalg.preconditioners import BlockJacobi as JBlockJacobi  # noqa: E402
from repro.parallel import get_backend as jget_backend  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointConfig  # noqa: E402
from repro_torch.core import SOLVERS, classic_cg, ghysels_pcg  # noqa: E402
from repro_torch.core import pipelined_cg  # noqa: E402
from repro_torch.core.types import SolverOps  # noqa: E402
from repro_torch.linalg import BlockJacobi, JacobiPrec, Stencil2D5  # noqa: E402
from repro_torch.parallel.backends import LocalBackend  # noqa: E402

JAX_SOLVERS = {"cg": jcg.solve, "pcg": jpcg.solve}


@pytest.fixture(scope="module")
def lap2d():
    """The reference tests' 24x24 Laplacian, its right-hand side from
    default_rng(42), and the direct solution."""
    jop = jops.Stencil2D5(24, 24)
    top = convert.operator("stencil2d5", nx=24, ny=24, device="cpu")
    b = np.random.default_rng(42).standard_normal(jop.n)
    x_direct = np.linalg.solve(jop.to_dense(), b)
    return jop, top, b, x_direct


def _assert_close_to_jax(rj, rt):
    assert bool(rj.converged) and bool(rt.converged)
    assert abs(int(rj.iters) - int(rt.iters)) <= 2
    assert int(rj.restarts) == int(rt.restarts)
    hj, ht = np.asarray(rj.res_history), rt.res_history.numpy()
    np.testing.assert_allclose(ht[:10], hj[:10], rtol=1e-9)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-6 * np.linalg.norm(xj)


def _assert_bitwise(ra, rb):
    assert torch.equal(ra.x, rb.x)
    assert torch.equal(ra.res_history, rb.res_history)
    for f in ("iters", "restarts", "converged", "norm0"):
        assert torch.equal(getattr(ra, f), getattr(rb, f)), f


@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_baseline_matches_direct(lap2d, method):
    """Mirrors test_classic_cg_matches_direct and
    test_ghysels_pcg_matches_direct on the local backend."""
    jop, top, b, x_direct = lap2d
    kw = dict(tol=1e-10, maxit=2000)
    rt = LocalBackend(device="cpu").solve(top, b, method=method, **kw)
    assert bool(rt.converged) and int(rt.restarts) == 0
    np.testing.assert_allclose(rt.x.numpy(), x_direct, atol=1e-7)
    rj = jget_backend("local").solve(jop, jnp.asarray(b), method=method, **kw)
    _assert_close_to_jax(rj, rt)


@pytest.mark.parametrize("method", ["cg", "pcg"])
def test_backend_residual_history_parity(lap2d, method):
    """The backend reproduces the plain-SolverOps solve exactly (bitwise
    here, where the reference asserts rtol 1e-12), and the JAX package's
    history under the convention above."""
    jop, top, b, _ = lap2d
    kw = dict(tol=1e-8, maxit=2000)
    r_ref = SOLVERS[method](SolverOps.local(top), torch.as_tensor(b), **kw)
    r_be = LocalBackend(device="cpu").solve(top, b, method=method, **kw)
    _assert_bitwise(r_ref, r_be)
    rj = JAX_SOLVERS[method](JOps.local(jop), jnp.asarray(b), **kw)
    _assert_close_to_jax(rj, r_be)


def test_preconditioned_plcg_blockjacobi(lap2d):
    """The reference test's solve (the shifts of A, not of M^{-1}A) meets
    square-root breakdowns, ~10 restarts, whose timing is rounding-
    sensitive (JAX 10, port 11 on this input): both land within its
    bound of the direct solution.  Held against the JAX package with the
    shifts of the preconditioned operator (JAX's, carried across), a
    solve without breakdowns."""
    jop, top, b, x_direct = lap2d
    tbj = BlockJacobi.from_operator(top, block_size=24)
    jbj = JBlockJacobi.from_operator(jop, block_size=24)
    kw = dict(tol=1e-9, maxit=2000)
    rt = pipelined_cg.solve(SolverOps.local(top, tbj), torch.as_tensor(b), 2,
                            sigmas=convert.sigmas(jshifts(jop, 2), "cpu"),
                            **kw)
    np.testing.assert_allclose(rt.x.numpy(), x_direct, atol=1e-5)
    sig = np.asarray(jshifts(jop, 2, prec=jbj))
    rt = pipelined_cg.solve(SolverOps.local(top, tbj), torch.as_tensor(b), 2,
                            sigmas=convert.sigmas(sig, "cpu"), **kw)
    rj = jpc.solve(JOps.local(jop, jbj), jnp.asarray(b), 2,
                   sigmas=jnp.asarray(sig), **kw)
    assert int(rt.restarts) == 0
    _assert_close_to_jax(rj, rt)
    np.testing.assert_allclose(rt.x.numpy(), x_direct, atol=1e-5)


def test_pcg_replacement_tightens_attainable_accuracy():
    """fp32, tol 0, 800 iterations: without replacement the true residual
    stagnates above 1e-3, with it it drops by orders of magnitude.  Both
    packages' recursive histories agree to 1e-4 relative (fp32 rounding,
    ~6e-8 an op, grown over 10 iterations) over the first 10 entries;
    past the plateau rounding decides them, so the JAX package's true
    residuals are held to the same thresholds, not to the port's."""
    jop = jops.Stencil2D5(96, 24)
    top = convert.operator("stencil2d5", nx=96, ny=24, device="cpu")
    b32 = np.random.default_rng(0).standard_normal(jop.n).astype(np.float32)

    def true_rel_res(x):
        xd = torch.as_tensor(np.asarray(x, np.float64))
        bd = np.asarray(b32, np.float64)
        return float(np.linalg.norm(bd - top.apply(xd).numpy())
                     / np.linalg.norm(bd))

    got = {}
    for every in (0, 50):
        kw = dict(tol=0.0, maxit=800, replace_every=every)
        rt = ghysels_pcg.solve(SolverOps.local(top), torch.as_tensor(b32),
                               **kw)
        rj = jpcg.solve(JOps.local(jop), jnp.asarray(b32), **kw)
        assert rt.x.dtype == torch.float32
        np.testing.assert_allclose(rt.res_history.numpy()[:10],
                                   np.asarray(rj.res_history)[:10],
                                   rtol=1e-4)
        got[every] = (true_rel_res(rt.x), true_rel_res(rj.x))
    for side in (0, 1):
        res_plain, res_repl = got[0][side], got[50][side]
        assert res_plain > 1e-3, res_plain
        assert res_repl < 1e-3, res_repl
        assert res_repl < res_plain / 10, (res_plain, res_repl)


def test_replacement_preserves_exact_arithmetic_convergence():
    """The p-CG half: in fp64 within normal tolerances, replacement does
    not change the answer."""
    jop = jops.Stencil2D5(24, 24)
    top = convert.operator("stencil2d5", nx=24, ny=24, device="cpu")
    b = np.random.default_rng(1).standard_normal(jop.n)
    x_direct = np.linalg.solve(jop.to_dense(), b)
    kw = dict(tol=1e-10, maxit=2000, replace_every=20)
    rt = ghysels_pcg.solve(SolverOps.local(top), torch.as_tensor(b), **kw)
    assert bool(rt.converged)
    np.testing.assert_allclose(rt.x.numpy(), x_direct, atol=1e-7)
    rj = jpcg.solve(JOps.local(jop), jnp.asarray(b), **kw)
    _assert_close_to_jax(rj, rt)


@pytest.mark.parametrize("unroll", [3, 16])
@pytest.mark.parametrize("method,replace_every", [
    ("cg", 0), ("pcg", 0), ("pcg", 7)])
def test_unroll_is_bitwise_equal_to_unroll_1(method, replace_every, unroll):
    """Predicated iterations past a stop (convergence, or maxit inside a
    window) or a due replacement change nothing observable."""
    op = Stencil2D5(16, 12, device="cpu")
    prec = JacobiPrec.from_operator(op)
    b = torch.as_tensor(np.random.default_rng(2).standard_normal(op.n))
    kw = dict(tol=1e-9, maxit=300)
    if replace_every:
        kw["replace_every"] = replace_every
    solve = SOLVERS[method]
    for extra in ({}, dict(maxit=23, tol=1e-30)):
        r1 = solve(SolverOps.local(op, prec), b, unroll=1,
                   **dict(kw, **extra))
        rk = solve(SolverOps.local(op, prec), b, unroll=unroll,
                   **dict(kw, **extra))
        _assert_bitwise(r1, rk)
        assert rk.host_syncs < r1.host_syncs
    assert bool(r1.converged) is False and int(r1.iters) == 23


def test_solver_refusals():
    op = Stencil2D5(8, 6, device="cpu")
    b = torch.ones(op.n, dtype=torch.float64)
    for bad, exc in [
        (lambda: classic_cg.solve(SolverOps.local(op), b, unroll=0),
         ValueError),
        (lambda: ghysels_pcg.solve(SolverOps.local(op), b, unroll=0),
         ValueError),
        # Checkpointing is ported for p-CG (tests/test_torch_checkpoint.py);
        # classic CG has no checkpoint boundary, as in the JAX package.
        (lambda: classic_cg.solve(SolverOps.local(op), b,
                                  checkpoint=CheckpointConfig(every=5)),
         TypeError),
    ]:
        with pytest.raises(exc):
            bad()
