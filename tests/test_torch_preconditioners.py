"""Block-Jacobi in the PyTorch port against the JAX package's
``BlockJacobi``: the probed and inverted blocks, the apply, the refusal
of the fused path, and whole solves of the three methods with it on the
ice sheet's unstructured operator (the slice as a whole).

Tolerances: the probed blocks are exact (each probed entry is one
nonzero term), so the inverses differ only by the two LAPACK paths'
rounding: within 1e-12 of the largest entry.  The apply is a batched
product summed in another order: 1e-13 of the largest output.  Solves
follow ``tests/test_torch_pipelined_cg.py``'s convention: converged,
iteration counts within 2, histories 1e-9 relative over the first 10
entries, solutions within 1e-6 relative.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs import icesheet3d as jice  # noqa: E402
from repro.configs.problems import build_operator as jbuild  # noqa: E402
from repro.core import pipelined_cg as jpc  # noqa: E402
from repro.core.chebyshev import shifts_for_operator as jshifts  # noqa: E402
from repro.linalg import operators as jops  # noqa: E402
from repro.linalg import preconditioners as jprec  # noqa: E402
from repro.parallel import get_backend as jget_backend  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import icesheet3d as tice  # noqa: E402
from repro_torch.configs.problems import build_operator  # noqa: E402
from repro_torch.core import pipelined_cg as tpc  # noqa: E402
from repro_torch.core.types import SolverOps  # noqa: E402
from repro_torch.linalg import (BlockJacobi, Stencil3D7, bandwidth,  # noqa: E402
                                spd_check_blockjacobi)
from repro_torch.parallel.backends import LocalBackend  # noqa: E402

# (name, block size): the 2D Laplacian with one grid line a block, the
# anisotropic 7-point stencil with one z line a block (ny = 5: its x
# couplings lie 5 blocks away, not a multiple of the 3 colors), and the
# ice sheet's smoke mesh (240 nodes) with the reach from its bandwidth.
CASES = [("stencil2d5", 24), ("stencil3d7", 4), ("ell", 20)]


def _pair(name):
    """(JAX operator, port operator) on the same data."""
    if name == "ell":
        return (jbuild(jice.smoke_config()),
                build_operator(tice.smoke_config(), "cpu"))
    if name == "stencil2d5":
        j = jops.Stencil2D5(32, 24)
        return j, convert.operator(name, nx=32, ny=24, device="cpu")
    ny = 6 if name == "stencil3d7_ny6" else 5
    j = jops.Stencil3D7(8, ny, 4, eps_z=0.1)
    return j, convert.operator("stencil3d7", nx=8, ny=ny, nz=4, eps_z=0.1,
                               device="cpu")


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _assert_exact_blocks(bj, op, bs):
    """``inv_blocks`` are the inverses of the dense matrix's diagonal
    blocks: colored probing aliased no coupling into them."""
    a = op.to_dense()
    for k in range(op.n // bs):
        blk = a[k * bs:(k + 1) * bs, k * bs:(k + 1) * bs]
        _close(bj.inv_blocks[k].numpy() @ blk, np.eye(bs), 1e-12)


@pytest.mark.parametrize("name,bs", CASES)
def test_inv_blocks_match_jax(name, bs):
    jop, top = _pair(name)
    tb = BlockJacobi.from_operator(top, bs)
    assert tb.inv_blocks.dtype == torch.float64
    assert tuple(tb.inv_blocks.shape) == (top.n // bs, bs, bs)
    _close(tb.inv_blocks.numpy(),
           jprec.BlockJacobi.from_operator(jop, bs).inv_blocks, 1e-12)
    _assert_exact_blocks(tb, top, bs)
    assert spd_check_blockjacobi(top, bs)
    assert jprec.spd_check_blockjacobi(jop, bs)


@pytest.mark.parametrize("name,bs", CASES)
def test_apply_matches_jax(name, bs):
    jop, top = _pair(name)
    x = np.random.default_rng(3).standard_normal(top.n)
    jb = jprec.BlockJacobi.from_operator(jop, bs)
    tb = BlockJacobi(inv_blocks=torch.tensor(np.asarray(jb.inv_blocks)))
    _close(tb.apply(torch.as_tensor(x)).numpy(), jb.apply(jnp.asarray(x)),
           1e-13)
    y32 = tb.apply(torch.as_tensor(x, dtype=torch.float32))
    assert y32.dtype == torch.float32


def test_default_reach_of_a_sparse_op_is_its_bandwidth():
    """The ice sheet's bandwidth spans three 12-row blocks: probing with
    the stencil default (one block) aliases couplings into the blocks,
    probing with the measured reach, the default, does not."""
    _, top = _pair("ell")
    bs = 12
    band = bandwidth(top)
    assert band > 2 * bs
    right = BlockJacobi.from_operator(top, bs)
    assert torch.equal(
        right.inv_blocks,
        BlockJacobi.from_operator(top, bs, coupling_reach=band).inv_blocks)
    _assert_exact_blocks(right, top, bs)
    aliased = BlockJacobi.from_operator(top, bs, coupling_reach=bs)
    assert not torch.allclose(aliased.inv_blocks, right.inv_blocks)


def test_default_reach_aliases_where_the_reference_does():
    """A Stencil3D7 with z-line blocks and ny a multiple of the 3 colors
    puts its x couplings on active blocks: the default reach aliases them
    into the blocks in both packages alike; the operator's true reach
    (ny * nz) gives the exact blocks."""
    jop, top = _pair("stencil3d7_ny6")
    bs = top.nz
    _close(BlockJacobi.from_operator(top, bs).inv_blocks.numpy(),
           jprec.BlockJacobi.from_operator(jop, bs).inv_blocks, 1e-12)
    exact = BlockJacobi.from_operator(top, bs,
                                      coupling_reach=top.ny * top.nz)
    _assert_exact_blocks(exact, top, bs)
    with pytest.raises(AssertionError):
        _assert_exact_blocks(BlockJacobi.from_operator(top, bs), top, bs)


@pytest.mark.parametrize("name,bs", CASES)
def test_probing_through_the_kernel_route_is_exact(name, bs):
    """A ``use_kernel`` operator probes through its kernel's entry point
    (its plain version on the CPU): the same blocks, bit for bit."""
    _, top = _pair(name)
    kop = dataclasses.replace(top, use_kernel=True)
    assert torch.equal(BlockJacobi.from_operator(kop, bs).inv_blocks,
                       BlockJacobi.from_operator(top, bs).inv_blocks)


def test_unsupported_combination_raises():
    """The block-Jacobi half of the reference's test: no fused path."""
    op = Stencil3D7(8, 8, 8, device="cpu")
    bj = BlockJacobi.from_operator(op, block_size=8)
    ops = SolverOps.local(op, bj)
    with pytest.raises(ValueError, match="fused_iter_factory"):
        tpc.build(ops, torch.zeros(op.n, dtype=torch.float64), 2,
                  fused_iteration=True)
    with pytest.raises(ValueError, match="does not divide"):
        BlockJacobi.from_operator(op, 7)


@pytest.mark.parametrize("method", ["cg", "pcg", "plcg"])
def test_blockjacobi_solves_match_jax(method):
    """The three methods with block-Jacobi on the ice sheet's smoke mesh,
    through the local backends of both packages (JAX's shifts carried
    across for p(2)-CG)."""
    jop, top = _pair("ell")
    bs = 20
    jbj = jprec.BlockJacobi.from_operator(jop, bs)
    tbj = BlockJacobi.from_operator(top, bs)
    b = np.random.default_rng(0).standard_normal(top.n)
    kw = dict(tol=1e-8, maxit=500)
    jkw = dict(kw)
    if method == "plcg":
        sig = np.asarray(jshifts(jop, 2, prec=jbj))
        kw.update(l=2, sigmas=convert.sigmas(sig, "cpu"))
        jkw.update(l=2, sigmas=jnp.asarray(sig))
    rt = LocalBackend(device="cpu").solve(top, b, method=method, prec=tbj,
                                          unroll=4, **kw)
    rj = jget_backend("local").solve(jop, jnp.asarray(b), method=method,
                                     prec=jbj, **jkw)
    assert bool(rj.converged) and bool(rt.converged)
    assert abs(int(rj.iters) - int(rt.iters)) <= 2
    assert int(rj.restarts) == int(rt.restarts) == 0
    np.testing.assert_allclose(rt.res_history.numpy()[:10],
                               np.asarray(rj.res_history)[:10], rtol=1e-9)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(rt.x.numpy() - xj) <= 1e-6 * np.linalg.norm(xj)
    bt = torch.as_tensor(b)
    rel = torch.linalg.norm(bt - top.apply(rt.x)) / torch.linalg.norm(bt)
    assert float(rel) < 1e-6
    # block-Jacobi needs fewer iterations than Jacobi on this mesh
    if method == "cg":
        rjac = jget_backend("local").solve(
            jop, jnp.asarray(b), method="cg",
            prec=jprec.JacobiPrec.from_operator(jop), **jkw)
        assert int(rt.iters) < int(rjac.iters)

