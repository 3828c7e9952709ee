"""The PyTorch port's operators, preconditioners, shifts, data conversion
and device handling, held against the JAX package on small inputs.

Tolerances: an operator apply keeps the JAX expression's term order, but
XLA may contract a multiply and a subtract into one FMA where PyTorch
rounds twice, so applies agree to 1e-13 relative to sum(|A||x|) rather
than bitwise.  Spectra and shifts go through cos() in two libraries:
1e-13 relative.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

from repro.core import chebyshev as jcheb  # noqa: E402
from repro.linalg import operators as jops  # noqa: E402
from repro.linalg import preconditioners as jprec  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import (icesheet3d, icesheet3d_stencil,  # noqa: E402
                                 laplace2d)
from repro_torch.configs.laplace2d import CGProblem  # noqa: E402
from repro_torch.configs.problems import build_operator  # noqa: E402
from repro_torch.core import chebyshev as tcheb  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import stencil_spmv  # noqa: E402
from repro_torch.linalg import operators as tops  # noqa: E402
from repro_torch.linalg import preconditioners as tprec  # noqa: E402
from repro_torch.linalg.sparse import SparseOp  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-13


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _pair(name):
    """(JAX operator, port operator) built from the same fields."""
    if name == "stencil2d5":
        j = jops.Stencil2D5(16, 12)
        return j, convert.operator("stencil2d5", nx=j.nx, ny=j.ny,
                                   device="cpu")
    if name == "stencil3d7":
        j = jops.Stencil3D7(8, 6, 4, eps_z=0.1)
        return j, convert.operator("stencil3d7", nx=j.nx, ny=j.ny, nz=j.nz,
                                   eps_z=j.eps_z, device="cpu")
    if name == "stencil3d27":
        j = jops.Stencil3D27(6, 6, 4)
        return j, convert.operator("stencil3d27", nx=j.nx, ny=j.ny,
                                   nz=j.nz, centre=j.centre, device="cpu")
    j = jops.DiagonalOp(jops.laplacian_2d_spectrum(8, 6))
    return j, convert.operator("diagonal", d=np.asarray(j.d), device="cpu")


OPS = ["stencil2d5", "stencil3d7", "stencil3d27", "diagonal"]


def test_port_imports_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro|benchmarks)(\.|\s|$)",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO, "src",
                                                  "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path, encoding="utf-8") as f:
            hits = pat.findall(f.read())
        assert not hits, (path, hits)


@pytest.mark.parametrize("name", OPS)
def test_apply_matches_jax(name):
    jop, top = _pair(name)
    x = np.random.default_rng(3).standard_normal(jop.n)
    yj = np.asarray(jop.apply(jnp.asarray(x)))
    yt = top.apply(torch.as_tensor(x)).numpy()
    scale = np.abs(jop.to_dense()) @ np.abs(x)
    np.testing.assert_array_less(np.abs(yj - yt), RTOL * scale + 1e-300)
    np.testing.assert_allclose(top.diag().numpy(), np.asarray(jop.diag()),
                               rtol=RTOL)
    np.testing.assert_allclose(top.eig_bounds(), jop.eig_bounds(),
                               rtol=RTOL)
    np.testing.assert_allclose(top.to_dense(), jop.to_dense(), rtol=RTOL,
                               atol=RTOL)


@pytest.mark.parametrize("name", ["stencil2d5", "stencil3d7"])
def test_use_kernel_apply_on_cpu_is_the_plain_version(name):
    _, top = _pair(name)
    fields = convert.operator_fields(top)
    fields["use_kernel"] = True
    kop = convert.operator(device="cpu", **fields)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(top.n))
    assert torch.equal(kop.apply(x), top.apply(x))


def test_stencil_refs_match_jax_refs_fp32():
    from repro.kernels import ref as jref

    g2 = np.random.default_rng(5).standard_normal((16, 12)).astype(
        np.float32)
    g3 = np.random.default_rng(6).standard_normal((8, 6, 4)).astype(
        np.float32)
    for yj, yt in [
        (jref.stencil2d5_ref(jnp.asarray(g2)),
         stencil_spmv.stencil2d5(torch.as_tensor(g2))),
        (jref.stencil3d7_ref(jnp.asarray(g3), 0.01),
         stencil_spmv.stencil3d7(torch.as_tensor(g3), 0.01)),
    ]:
        assert yt.dtype == torch.float32
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6,
                                   atol=1e-6)


def test_spectrum_and_shifts_match_jax():
    np.testing.assert_allclose(
        tops.laplacian_2d_spectrum(8, 6, device="cpu").numpy(),
        np.asarray(jops.laplacian_2d_spectrum(8, 6)), rtol=RTOL)
    for l in (1, 2, 3):
        np.testing.assert_allclose(
            tcheb.chebyshev_shifts(0.1, 7.9, l, device="cpu").numpy(),
            np.asarray(jcheb.chebyshev_shifts(0.1, 7.9, l)), rtol=RTOL)
    jop, top = _pair("stencil2d5")
    np.testing.assert_allclose(
        tcheb.shifts_for_operator(top, 3).numpy(),
        np.asarray(jcheb.shifts_for_operator(jop, 3)), rtol=RTOL)


def test_power_method_estimates_lambda_max():
    # Different start vectors (numpy vs jax.random): both estimates lie
    # below the true lambda_max and within a few percent of it.
    jop, top = _pair("stencil2d5")
    lmax = jop.eig_bounds()[1]
    lam_t, _ = tcheb.power_method(top.apply, top.n, iters=200, device="cpu")
    lam_j, _ = jcheb.power_method(jop.apply, jop.n, iters=200)
    for lam in (float(lam_t), float(lam_j)):
        assert 0.95 * lmax < lam <= lmax * (1 + 1e-12)


def test_preconditioners():
    jop, top = _pair("stencil3d7")
    jj = jprec.JacobiPrec.from_operator(jop)
    tj = tprec.JacobiPrec.from_operator(top)
    np.testing.assert_array_equal(tj.inv_diag.numpy(), np.asarray(jj.inv_diag))
    x = np.random.default_rng(7).standard_normal(jop.n)
    np.testing.assert_array_equal(
        tj.apply(torch.as_tensor(x)).numpy(),
        np.asarray(jj.apply(jnp.asarray(x))))
    xt = torch.as_tensor(x)
    assert tprec.IdentityPrec().apply(xt) is xt
    # Block-Jacobi (one z line a block) as the JAX package probes and
    # inverts it, within 1e-12 of the largest entry (LAPACK rounding).
    tb = tprec.BlockJacobi.from_operator(top, 4).inv_blocks.numpy()
    jb = np.asarray(jprec.BlockJacobi.from_operator(jop, 4).inv_blocks)
    assert np.abs(tb - jb).max() <= 1e-12 * np.abs(jb).max()


@pytest.mark.parametrize("name", OPS)
def test_convert_round_trips(name):
    jop, top = _pair(name)
    fields = convert.operator_fields(top)
    again = convert.operator(device="cpu", **fields)
    assert convert.operator_fields(again).keys() == fields.keys()
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(top.n))
    assert torch.equal(again.apply(x), top.apply(x))
    # ... and back into the JAX package from the same fields.
    kind = fields.pop("kind")
    if kind == "diagonal":
        back = jops.DiagonalOp(jnp.asarray(fields["d"]))
        np.testing.assert_array_equal(np.asarray(back.d), np.asarray(jop.d))
    else:
        cls = {"stencil2d5": jops.Stencil2D5, "stencil3d7": jops.Stencil3D7,
               "stencil3d27": jops.Stencil3D27}[kind]
        assert cls(**fields) == jop
    inv = np.asarray(jprec.JacobiPrec.from_operator(jop).inv_diag)
    np.testing.assert_array_equal(convert.jacobi(inv, "cpu").inv_diag.numpy(),
                                  inv)
    sig = np.asarray(jcheb.shifts_for_operator(jop, 2))
    np.testing.assert_array_equal(convert.sigmas(sig, "cpu").numpy(), sig)
    S, idx, scal = convert.vector_phase(np.ones((3, 4)), [1, 2],
                                        np.zeros(2), "cpu")
    assert (S.dtype, idx.dtype, scal.dtype) == (torch.float64, torch.int32,
                                                torch.float64)
    with pytest.raises(ValueError):
        convert.operator("sparse", device="cpu")


def test_cuda_requests_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.core import pipelined_cg
    from repro_torch.core.types import SolverOps
    from repro_torch.parallel.backends import LocalBackend

    for make in (lambda: resolve_device(None),
                 lambda: resolve_device("cuda"),
                 lambda: tops.Stencil2D5(4, 4),
                 lambda: tops.laplacian_2d_spectrum(4, 4),
                 lambda: LocalBackend(),
                 lambda: build_operator(laplace2d.smoke_config())):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    op = tops.Stencil2D5(4, 4, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        pipelined_cg.solve(SolverOps.local(op), np.ones(op.n), 2)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_other_devices():
    g = torch.empty((4, 4), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="device"):
        stencil_spmv.stencil2d5(g)
    with pytest.raises(ValueError, match="device"):
        stencil_spmv.stencil3d7(g.reshape(2, 2, 4), 0.5)


def test_configs_build_operators():
    assert isinstance(build_operator(laplace2d.smoke_config(), "cpu"),
                      tops.Stencil2D5)
    op = build_operator(icesheet3d_stencil.smoke_config(), "cpu")
    assert isinstance(op, tops.Stencil3D7) and op.eps_z == 0.01
    d = build_operator(CGProblem("toy", "diagonal", 8, 6), "cpu")
    assert isinstance(d, tops.DiagonalOp) and d.n == 48
    assert laplace2d.config().nx * laplace2d.config().ny == 2048 ** 2
    ice = build_operator(icesheet3d.smoke_config(), "cpu")
    assert isinstance(ice, SparseOp) and ice.n == 240 and ice.ordered
    mesh = build_operator(CGProblem("mesh", "unstructured", 4, 4), "cpu")
    assert isinstance(mesh, SparseOp) and mesh.n == 16 and mesh.ordered
    assert icesheet3d.config().nx * icesheet3d.config().ny * \
        icesheet3d.config().nz == 500_000
    with pytest.raises(ValueError):
        build_operator(CGProblem("x", "nope", 4, 4), "cpu")


@pytest.mark.cuda
def test_stencil_kernels_bitwise_on_card(cuda_device):
    rng = np.random.default_rng(9)
    for dt in (torch.float64, torch.float32):
        g2 = torch.tensor(rng.standard_normal((67, 45)), dtype=dt,
                          device=cuda_device)
        assert torch.equal(stencil_spmv.stencil2d5(g2),
                           stencil_spmv.stencil2d5_plain(g2))
        g3 = torch.tensor(rng.standard_normal((9, 7, 13)), dtype=dt,
                          device=cuda_device)
        assert torch.equal(stencil_spmv.stencil3d7(g3, 0.01),
                           stencil_spmv.stencil3d7_plain(g3, 0.01))
