"""The port's unstructured ELL operators (``repro_torch.linalg.sparse``),
its ELL kernel's plain version and the ice-sheet config, held against the
JAX package on small meshes (at most 400 nodes).

Tolerances:
* Construction is the same host numpy in both packages: ``cols``,
  ``vals``, the RCM permutation, the bandwidth and ``eig_bounds`` are
  compared for exact equality.
* ``SparseOp.apply`` keeps the ``ell_rowsum`` chain in both packages,
  but XLA may contract a multiply-add into one FMA: 1e-13 relative to
  sum(|A||x|) per row.
* ``ell_spmv_ref`` sums the slots left to right while the JAX oracle and
  its Pallas kernel use ``.sum(axis=1)``: per row |diff| <= 1e-13 *
  sum_s |v x| in fp64, and <= 1e-5 * sum_s |v x| in fp32 (about 80 ulps
  of fp32 for an 11-term sum taken in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

from repro.configs import icesheet3d as jice  # noqa: E402
from repro.configs.problems import build_operator as jbuild  # noqa: E402
from repro.kernels import ops as jkops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.linalg import sparse as jsp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import icesheet3d as tice  # noqa: E402
from repro_torch.configs.problems import build_operator as tbuild  # noqa: E402
from repro_torch.core import pipelined_cg as tpc  # noqa: E402
from repro_torch.core.types import SolverOps  # noqa: E402
from repro_torch.kernels import ell_spmv as tel  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.linalg import BlockJacobi, JacobiPrec  # noqa: E402
from repro_torch.linalg import sparse as tsp  # noqa: E402

RTOL = 1e-13


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _same_arrays(jop, top):
    np.testing.assert_array_equal(top.cols.numpy(), np.asarray(jop.cols))
    np.testing.assert_array_equal(top.vals.numpy(), np.asarray(jop.vals))
    assert top.vals.dtype == torch.float64 and top.cols.dtype == torch.int32
    assert (top.n, top.w, top.nnz, top.ordered) == (jop.n, jop.w, jop.nnz,
                                                    jop.ordered)


@pytest.mark.parametrize("gen", ["mesh", "icesheet"])
def test_generators_rcm_and_bounds_match_jax(gen):
    if gen == "mesh":
        jop = jsp.random_fem_mesh(5, 300)
        top = tsp.random_fem_mesh(5, 300, device="cpu")
    else:
        jop = jsp.random_fem_icesheet(48, 10, 6, 4, eps_z=0.01)
        top = tsp.random_fem_icesheet(48, 10, 6, 4, eps_z=0.01,
                                      device="cpu")
    _same_arrays(jop, top)
    np.testing.assert_array_equal(tsp.rcm_permutation(top),
                                  jsp.rcm_permutation(jop))
    jr, jperm = jsp.rcm_reorder(jop)
    tr, tperm = tsp.rcm_reorder(top)
    np.testing.assert_array_equal(tperm, jperm)
    _same_arrays(jr, tr)
    assert tsp.bandwidth(tr) == jsp.bandwidth(jr)
    assert tsp.bandwidth(top) == jsp.bandwidth(jop)
    assert tr.eig_bounds() == jr.eig_bounds()
    np.testing.assert_array_equal(tr.to_dense(), jr.to_dense())
    np.testing.assert_array_equal(tr.diag().numpy(), np.asarray(jr.diag()))


def test_config_builds_the_jax_operator():
    jop = jbuild(jice.smoke_config())
    top = tbuild(tice.smoke_config(), "cpu")
    assert isinstance(top, tsp.SparseOp) and top.n == 240
    _same_arrays(jop, top)
    assert dataclasses.asdict(tice.config()) == dataclasses.asdict(
        jice.config())
    assert dataclasses.asdict(tice.smoke_config()) == dataclasses.asdict(
        jice.smoke_config())


def test_coo_and_dense_packing_match_jax():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((9, 9)) * (rng.uniform(size=(9, 9)) < 0.3)
    a = a + a.T + 9 * np.eye(9)
    _same_arrays(jsp.sparse_from_dense(a), tsp.sparse_from_dense(
        a, device="cpu"))
    rows = rng.integers(0, 7, 30)
    cols = rng.integers(0, 7, 30)
    vals = rng.standard_normal(30)
    _same_arrays(jsp.sparse_from_coo(7, rows, cols, vals),
                 tsp.sparse_from_coo(7, rows, cols, vals, device="cpu"))
    with pytest.raises(ValueError):
        tsp.sparse_from_coo(3, [0, 5], [0, 1], [1.0, 2.0], device="cpu")


def test_apply_matches_jax_and_kernel_route_is_plain_on_cpu():
    jop = jbuild(jice.smoke_config())
    top = tbuild(tice.smoke_config(), "cpu")
    x = np.random.default_rng(3).standard_normal(top.n)
    yt = top.apply(torch.as_tensor(x)).numpy()
    yj = np.asarray(jop.apply(jnp.asarray(x)))
    scale = np.abs(top.to_dense()) @ np.abs(x)
    np.testing.assert_array_less(np.abs(yt - yj), RTOL * scale + 1e-300)
    kop = dataclasses.replace(top, use_kernel=True)
    assert torch.equal(kop.apply(torch.as_tensor(x)), torch.as_tensor(yt))
    np.testing.assert_allclose(yt, top.to_dense() @ x, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("r,w,nx", [(100, 7, 100), (37, 5, 60)])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ell_spmv_ref_matches_jax_kernel_and_oracle(r, w, nx, dtype):
    """``nx > r``: x longer than the row count (the distributed path's
    [own | halo] vector)."""
    rng = np.random.default_rng(r + w)
    x = rng.standard_normal(nx).astype(dtype)
    cols = rng.integers(0, nx, size=(r, w)).astype(np.int32)
    vals = rng.standard_normal((r, w)).astype(dtype)
    # zero a padding tail per row, as the ELL packer produces
    nnz = rng.integers(1, w + 1, size=(r,))
    vals[np.arange(w)[None, :] >= nnz[:, None]] = 0
    yt = tel.ell_spmv(torch.as_tensor(x), torch.as_tensor(cols),
                      torch.as_tensor(vals))
    assert yt.dtype == getattr(torch, dtype)
    assert torch.equal(yt, tref.ell_spmv_ref(torch.as_tensor(x),
                                             torch.as_tensor(cols),
                                             torch.as_tensor(vals)))
    bound = (1e-13 if dtype == "float64" else 1e-5) * (
        np.abs(vals.astype(np.float64))
        * np.abs(x.astype(np.float64)[cols])).sum(axis=1)
    for yj in (jkops.ell_spmv_apply(jnp.asarray(x), jnp.asarray(cols),
                                    jnp.asarray(vals)),
               jref.ell_spmv_ref(jnp.asarray(x), jnp.asarray(cols),
                                 jnp.asarray(vals))):
        diff = np.abs(yt.numpy().astype(np.float64)
                      - np.asarray(yj).astype(np.float64))
        np.testing.assert_array_less(diff, bound + 1e-300)


def test_convert_round_trips_sparse():
    jop = jbuild(jice.smoke_config())
    top = convert.operator("ell", device="cpu", cols=np.asarray(jop.cols),
                           vals=np.asarray(jop.vals), ordered=jop.ordered,
                           use_kernel=jop.use_kernel)
    _same_arrays(jop, top)
    fields = convert.operator_fields(top)
    assert fields.pop("kind") == "ell"
    back = jsp.SparseOp(cols=jnp.asarray(fields["cols"]),
                        vals=jnp.asarray(fields["vals"]),
                        ordered=fields["ordered"],
                        use_kernel=fields["use_kernel"])
    _same_arrays(back, top)


def test_refusals():
    op = tbuild(tice.smoke_config(), "cpu")
    kop = dataclasses.replace(op, use_kernel=True)
    b = torch.as_tensor(np.random.default_rng(4).standard_normal(op.n))
    with pytest.raises(ValueError, match="fused_iter_factory"):
        tpc.solve(SolverOps.local(kop, JacobiPrec.from_operator(op)), b, 2,
                  fused_iteration=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BlockJacobi.from_operator(op, 8)
    with pytest.raises(ValueError, match="device"):
        meta = torch.empty((4, 2), dtype=torch.int32, device="meta")
        tel.ell_spmv(torch.empty(4, device="meta"), meta,
                     torch.empty((4, 2), device="meta"))
    with pytest.raises(ValueError, match="one \\(n, w\\)"):
        tsp.SparseOp(cols=np.zeros((3, 2), np.int32), vals=np.zeros((3, 1)),
                     device="cpu")


@pytest.mark.cuda
def test_ell_kernels_bitwise_on_card(cuda_device):
    from repro_torch.kernels import fused_iter as tfi
    from repro_torch.kernels.ops import fused_iteration_factory

    op = tsp.random_fem_icesheet(48, 10, 6, 4, device=cuda_device)
    op = tsp.rcm_reorder(op)[0]
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.standard_normal(op.n + 7), device=cuda_device)
    for dt in (torch.float64, torch.float32):
        v = op.vals.to(dt)
        assert torch.equal(tel.ell_spmv(x, op.cols, v),
                           tel.ell_spmv_plain(x, op.cols, v))
    prec = JacobiPrec.from_operator(op)
    for l in (1, 2, 3):
        for rec in ("ghysels", "stable"):
            layout = tfi.SlabLayout(l=l, RB=max(l + 1, 3), recurrence=rec)
            fiter = fused_iteration_factory(op, prec)(layout)
            for i in (0, l, 2 * l + 3):
                IS = tfi.scal_layout(l)
                scal = rng.standard_normal(IS["size"])
                scal[IS["dlt_safe"]] = 1.25
                scal[IS["eta_new_safe"]] = 0.75
                scal[IS["eta0_safe"]] = 1.5
                S, idx, sc = convert.vector_phase(
                    rng.standard_normal((layout.nv, op.n)),
                    tfi.host_idx(layout, i), scal, cuda_device)
                S_p, d_p = fiter.plain(S, idx, sc)
                S_k, d_k = fiter(S.clone(), idx, sc)
                assert torch.equal(S_k, S_p)
                torch.testing.assert_close(d_k, d_p, rtol=1e-12, atol=1e-12)
