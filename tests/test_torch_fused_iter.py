"""The port's vector phase (``repro_torch.kernels.ref`` and the superkernel
wrapper's CPU path) against the JAX package's ``fused_iter_ref`` and its
Pallas superkernel in interpret mode, on one shared ``(S, idx, scal)``
triple.

Tolerances: rows keep the JAX expressions' term order, but XLA may
contract a multiply-add into one FMA, so a row agrees to 1e-13 relative
to the largest magnitude in its expression (the slab's and the SPMV's
scale) rather than bitwise.  Dot partials are sums over N in a different
order (torch.sum vs XLA): |diff| <= 1e-13 * sum_j |m_kj u_j|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

from repro.configs import icesheet3d as jice  # noqa: E402
from repro.configs.problems import build_operator as jbuild  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import fused_iter as jfi  # noqa: E402
from repro.kernels.ops import fused_iteration_factory as jfactory  # noqa: E402
from repro.linalg import operators as jops  # noqa: E402
from repro.linalg.preconditioners import JacobiPrec as JJacobi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import fused_iter as tfi  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.ops import fused_iteration_factory as tfactory  # noqa: E402
from repro_torch.linalg import Stencil2D5  # noqa: E402

RTOL = 1e-13


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _pair(name):
    if name == "ell":
        j = jbuild(jice.smoke_config())
        return j, convert.operator("ell", device="cpu",
                                   cols=np.asarray(j.cols),
                                   vals=np.asarray(j.vals), ordered=True)
    if name == "stencil2d5":
        j = jops.Stencil2D5(16, 12)
    elif name == "stencil3d7":
        j = jops.Stencil3D7(8, 6, 4, eps_z=0.1)
    elif name == "stencil3d27":
        j = jops.Stencil3D27(6, 6, 4)
    else:
        j = jops.DiagonalOp(jops.laplacian_2d_spectrum(8, 6))
    fields = ({"d": np.asarray(j.d)} if name == "diagonal" else
              {k: getattr(j, k) for k in ("nx", "ny", "nz", "eps_z",
                                          "centre") if hasattr(j, k)})
    return j, convert.operator(name, device="cpu", **fields)


def _triple(layout, n, i, seed):
    rng = np.random.default_rng(seed)
    IS = tfi.scal_layout(layout.l)
    S = rng.standard_normal((layout.nv, n))
    idx = np.asarray(tfi.host_idx(layout, i), np.int32)
    scal = rng.standard_normal(IS["size"])
    scal[IS["dlt_safe"]] = 1.25
    scal[IS["eta_new_safe"]] = 0.75
    scal[IS["eta0_safe"]] = 1.5
    return S, idx, scal


def _compare(S_j, d_j, S_t, d_t, scale_rows, mat, u):
    S_j, d_j = np.asarray(S_j), np.asarray(d_j)
    np.testing.assert_array_less(np.abs(S_t.numpy() - S_j),
                                 RTOL * scale_rows + 1e-300)
    abs_sum = (np.abs(mat) * np.abs(u)[None, :]).sum(axis=1)
    np.testing.assert_array_less(np.abs(d_t.numpy() - d_j),
                                 RTOL * abs_sum + 1e-300)


@pytest.mark.parametrize("name", ["stencil2d5", "stencil3d7", "stencil3d27",
                                  "diagonal", "ell"])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_vector_phase_matches_jax_ref(name, l):
    jop, top = _pair(name)
    for rec in ("ghysels", "stable"):
        for jac in (False, True):
            jl = jfi.SlabLayout(l=l, RB=max(l + 1, 3), recurrence=rec)
            tl = tfi.SlabLayout(l=l, RB=max(l + 1, 3), recurrence=rec)
            assert (jl.nv, jl.x_row, jl.p_row) == (tl.nv, tl.x_row, tl.p_row)
            jp = JJacobi.from_operator(jop) if jac else None
            tp = convert.jacobi(np.asarray(jp.inv_diag), "cpu") if jac \
                else None
            jprec = (lambda v: v) if jp is None else jp.apply
            tprec = (lambda v: v) if tp is None else tp.apply
            for i in (0, l - 1, l, l + 1, 2 * l + 3):
                S, idx, scal = _triple(tl, jop.n, i, seed=100 * l + i)
                S_j, d_j = jref.fused_iter_ref(
                    jnp.asarray(S), jnp.asarray(idx), jnp.asarray(scal),
                    jop.apply, jprec, jl)
                St, it, ct = convert.vector_phase(S, idx, scal, "cpu")
                S_t, d_t = tref.fused_iter_ref(St, it, ct, top.apply, tprec,
                                               tl)
                _, mat, u = tref.fused_iter_unfused(St, it, ct, top.apply,
                                                    tprec, tl)
                scale = 30.0 * np.abs(S).max() * max(
                    1.0, np.abs(scal).max()) ** 2
                _compare(S_j, d_j, S_t, d_t, scale, mat.numpy(), u.numpy())


@pytest.mark.parametrize("name,l,rec,jac", [
    ("stencil2d5", 1, "ghysels", False),
    ("stencil2d5", 2, "stable", True),
    ("stencil3d7", 3, "ghysels", True),
    ("diagonal", 2, "ghysels", False),
    ("ell", 2, "ghysels", True),
    ("ell", 3, "stable", False),
])
def test_port_matches_jax_superkernel_interpret(name, l, rec, jac):
    """The JAX Pallas superkernel, run in interpret mode as the JAX
    package's own tests run it, against the port's superkernel wrapper on
    the CPU (its plain version)."""
    jop, top = _pair(name)
    jp = JJacobi.from_operator(jop) if jac else None
    tp = convert.jacobi(np.asarray(jp.inv_diag), "cpu") if jac else None
    jl = jfi.SlabLayout(l=l, RB=max(l + 1, 3), recurrence=rec)
    tl = tfi.SlabLayout(l=l, RB=max(l + 1, 3), recurrence=rec)
    jfiter = jax.jit(jfactory(jop, jp)(jl))
    tfiter = tfactory(top, tp)(tl)
    for i in (0, l, 2 * l + 3):
        S, idx, scal = _triple(tl, jop.n, i, seed=7 + i)
        S_j, d_j = jfiter(jnp.asarray(S), jnp.asarray(idx),
                          jnp.asarray(scal))
        St, it, ct = convert.vector_phase(S, idx, scal, "cpu")
        S_t, d_t = tfiter(St, it, ct)
        prec = (lambda v: v) if tp is None else tp.apply
        _, mat, u = tref.fused_iter_unfused(St, it, ct, top.apply, prec, tl)
        scale = 30.0 * np.abs(S).max() * max(1.0, np.abs(scal).max()) ** 2
        _compare(S_j, d_j, S_t, d_t, scale, mat.numpy(), u.numpy())


def test_layouts_match_jax():
    for l in range(1, 7):
        assert tfi.idx_layout(l) == jfi.idx_layout(l)
        assert tfi.scal_layout(l) == jfi.scal_layout(l)
        assert tfi.tel_layout(l) == jfi.tel_layout(l)
        lay = tfi.SlabLayout(l=l, RB=max(l + 1, 3))
        jlay = jfi.SlabLayout(l=l, RB=max(l + 1, 3))
        for n in (1000, 4096):
            assert tfi.custom_call_hbm_bytes(lay, n) == \
                jfi.custom_call_hbm_bytes(jlay, n)
        for i in range(-2, 3 * l + 7):
            assert [lay.zk_row(k, i) for k in range(l + 1)] == \
                [int(jlay.zk_row(k, i)) for k in range(l + 1)]
            assert lay.u_row(i) == int(jlay.u_row(i))


def test_z_top_row_is_never_written():
    for l in range(1, 9):
        tfi.check_z_top_not_written(tfi.SlabLayout(l=l, RB=max(l + 1, 3)))
    layout = tfi.SlabLayout(l=2, RB=3)
    op = Stencil2D5(4, 4, device="cpu")
    fiter = tfactory(op)(layout)
    S, idx, scal = convert.vector_phase(*_triple(layout, op.n, 5, 0), "cpu")
    IX = tfi.idx_layout(2)
    idx[IX["z_top"]] = idx[IX["z_w"]]
    with pytest.raises(ValueError, match="z_top"):
        fiter(S, idx, scal)


def test_fused_wrapper_refusals():
    layout = tfi.SlabLayout(l=2, RB=3)
    op = Stencil2D5(4, 4, device="cpu")
    fiter = tfactory(op)(layout)
    S = torch.empty((layout.nv, op.n), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="device"):
        fiter(S, tfi.host_idx(layout, 3), S[0, :10])
    kernel_op = Stencil2D5(4, 4, use_kernel=True, device="cpu")
    assert tfactory(kernel_op) is None
    assert tfactory(op, object()) is None
    with pytest.raises(ValueError, match="recurrence"):
        tfi.build_fused_iteration(tfi.SlabLayout(2, 3, "nope"),
                                  tfi.diagonal_spmv(torch.ones(4)))


def test_min_bytes_counts_distinct_rows():
    layout = tfi.SlabLayout(l=2, RB=3)
    n = 1000
    late = tfi.host_idx(layout, 7)
    b = tfi.min_bytes(layout, late, n, has_prec=True, has_diag=False)
    # l = 2, late: reads z_top, u_i, u_im1, zl_im1, 2 mat_v + 1 mat_z,
    # rec a/b/c, p_im, x, p; writes rec_w, z_w, u_w, x, p; plus inv_diag.
    vectors = (b - (tfi.idx_layout(2)["size"] * 4
                    + tfi.scal_layout(2)["size"] * 8 + 5 * 8)) // (8 * n)
    assert 15 <= vectors <= 30
    assert b < tfi.custom_call_hbm_bytes(layout, n)


@pytest.mark.cuda
def test_superkernel_rows_bitwise_on_card(cuda_device):
    from repro_torch.linalg import Stencil3D27

    op = Stencil3D27(9, 7, 5, device=cuda_device)
    for l in (1, 2, 3):
        for rec in ("ghysels", "stable"):
            layout = tfi.SlabLayout(l=l, RB=max(l + 1, 3), recurrence=rec)
            fiter = tfactory(op)(layout)
            for i in (0, l, 2 * l + 3):
                S, idx, scal = convert.vector_phase(
                    *_triple(layout, op.n, i, seed=i), cuda_device)
                S_p, d_p = fiter.plain(S, idx, scal)
                S_k, d_k = fiter(S.clone(), idx, scal)
                assert torch.equal(S_k, S_p)
                torch.testing.assert_close(d_k, d_p, rtol=1e-12, atol=1e-12)
