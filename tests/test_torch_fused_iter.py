"""The port's vector phase (``repro_torch.kernels.ref`` and the superkernel
wrapper's CPU path) against the JAX package's ``fused_iter_ref`` and its
Pallas superkernel in interpret mode, on one shared ``(S, idx, scal)``
triple.

Tolerances: rows keep the JAX expressions' term order, but XLA may
contract a multiply-add into one FMA, so a row agrees to 1e-13 relative
to the largest magnitude in its expression (the slab's and the SPMV's
scale) rather than bitwise.  Dot partials are sums over N in a different
order (torch.sum vs XLA): |diff| <= 1e-13 * sum_j |m_kj u_j|.

The tests marked ``cuda`` hold the kernels against the plain versions on
the card, whose machine has no JAX: they build their operators from the
port alone (``_port_op``).
"""

import dataclasses
import importlib.util

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# A card's machine has no JAX and runs only the cuda tests; where JAX is
# installed, the reference package is imported unguarded.
HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from repro.configs import icesheet3d as jice
    from repro.configs.problems import build_operator as jbuild
    from repro.kernels import ref as jref
    from repro.kernels import fused_iter as jfi
    from repro.kernels.ops import fused_iteration_factory as jfactory
    from repro.linalg import operators as jops
    from repro.linalg.preconditioners import JacobiPrec as JJacobi

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


@pytest.fixture
def with_jax():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the reference")


def _port_op(name, device="cpu", wide=False):
    """The port's operator of ``_pair(name)``, built without JAX; ``wide``
    takes wider grids, of several blocks and a ragged last one (the card
    tests)."""
    from repro_torch.configs import icesheet3d
    from repro_torch.configs.problems import build_operator
    from repro_torch.linalg import (DiagonalOp, Stencil3D7, Stencil3D27,
                                    laplacian_2d_spectrum)

    if name == "ell":
        return build_operator(icesheet3d.smoke_config(), device=device)
    if name == "stencil2d5":
        return Stencil2D5(*((40, 30) if wide else (16, 12)), device=device)
    if name == "stencil3d7":
        return Stencil3D7(*((10, 9, 7) if wide else (8, 6, 4)), eps_z=0.1,
                          device=device)
    if name == "stencil3d27":
        return Stencil3D27(*((9, 7, 5) if wide else (6, 6, 4)), device=device)
    return DiagonalOp(laplacian_2d_spectrum(*((40, 30) if wide else (8, 6)),
                                            device=device))


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
def test_vector_phase_matches_jax_ref(name, l, with_jax):
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
def test_port_matches_jax_superkernel_interpret(name, l, rec, jac, with_jax):
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


def test_layouts_match_jax(with_jax):
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


# ------------------------------------------------ deeper pipelines (l > 8) --

def test_runtime_depth_sizes():
    """The runtime-depth kernel's shared memory per block (the l fill and l
    recurrence values of 256 threads, 8 warp sums of each product): l = 9
    takes 38 612 bytes, l = 16 68 516 (three blocks an SM); on an H100
    (232 448 bytes a block) l = 54 is the deepest (230 852 bytes) and
    l = 55 (235 124 bytes) does not fit."""
    assert tfi.runtime_smem_bytes(9) == 38612
    assert tfi.runtime_smem_bytes(16) == 68516
    assert tfi.runtime_smem_bytes(54) == 230852
    assert tfi.runtime_smem_bytes(55) == 235124
    assert tfi.deepest_runtime_l(232448) == 54
    assert tfi.launch_key("stencil2d5", tfi.LMAX) == "fused_iter"
    assert tfi.launch_key("ell", 2) == "fused_iter_ell"
    assert tfi.launch_key("ell_halo", 2) == "fused_iter_ell_halo"
    assert tfi.launch_key("stencil3d7_halo", 3) == "fused_iter_halo"
    for kind in tfi.SPMV_KINDS + tfi.HALO_KINDS:
        assert tfi.launch_key(kind, tfi.LMAX + 1) == "fused_iter_runtime_l"


@pytest.mark.parametrize("name", ["stencil2d5", "ell"])
@pytest.mark.parametrize("l", [9, 12, 16, 28])
def test_deep_pipeline_fused_path_matches_jax_ref(name, l, with_jax):
    """l > 8 through the fused path's plain version on the CPU (the
    superkernel wrapper of the fused factory) against the JAX package's
    ``fused_iter_ref``; l = 28 is past the runtime-depth kernel's deepest
    before its products were summed by warps."""
    jop, top = _pair(name)
    layout = tfi.SlabLayout(l=l, RB=max(l + 1, 3))
    jl = jfi.SlabLayout(l=l, RB=max(l + 1, 3))
    jp = JJacobi.from_operator(jop)
    tp = convert.jacobi(np.asarray(jp.inv_diag), "cpu")
    fiter = tfactory(top, tp)(layout)
    for i in (0, l, 2 * l + 3):
        S, idx, scal = _triple(layout, jop.n, i, seed=31 * l + i)
        S_j, d_j = jref.fused_iter_ref(jnp.asarray(S), jnp.asarray(idx),
                                       jnp.asarray(scal), jop.apply,
                                       jp.apply, jl)
        St, it, ct = convert.vector_phase(S, idx, scal, "cpu")
        S_t, d_t = fiter(St, it, ct)
        _, mat, u = tref.fused_iter_unfused(St, it, ct, top.apply, tp.apply,
                                            layout)
        scale = 30.0 * np.abs(S).max() * max(1.0, np.abs(scal).max()) ** 2
        _compare(S_j, d_j, S_t, d_t, scale, mat.numpy(), u.numpy())


# ----------------------------------------- halo-extended plug-ins (shards) --

N_SHARDS = 4


def _shard_case(name, device="cpu"):
    """(whole operator, loc dicts, (P, nl) -> (P, ext) halo of the ring-top
    stack) for ``N_SHARDS`` virtual shards of the port operator."""
    from repro_torch.linalg import partition as tpart
    from repro_torch.parallel.distributed import halo_first_dim

    top = _port_op(name, device)
    p, nl = N_SHARDS, top.n // N_SHARDS
    if name == "ell":
        plan = tpart.partition_spd(top, p)
        assert plan.identity_perm          # the config is RCM-ordered
        locs = [{f: getattr(plan, f)[s] for f in
                 ("cols", "vals", "send_up", "send_dn")} for s in range(p)]
        return top, locs, lambda z: tpart.halo_exchange(z, plan.send_up,
                                                        plan.send_dn)
    if name == "diagonal":
        return top, [{"d": top.d[s * nl:(s + 1) * nl]} for s in range(p)], \
            None
    plane = top.n // top.nx
    return top, [{} for _ in range(p)], lambda z: halo_first_dim(z, plane)


def _shard_phase(top, locs, halo, layout, inv_diag, S, idx, scal):
    """Every shard's vector phase through its halo plug-in: (stacked rows
    (NV, n), (P, 2l+1) partials).  The shards' operands come from the
    in-process halo of the ring-top rows, read before any shard runs."""
    from repro_torch.parallel.distributed import fused_spmv_local

    p, nl = N_SHARDS, top.n // N_SHARDS
    zt = S[int(idx[tfi.idx_layout(layout.l)["z_top"]])].reshape(p, nl)
    ext = None if halo is None else halo(zt)
    rows, parts = [], []
    for s in range(p):
        def prepare(z, s=s):
            assert torch.equal(z, zt[s])
            return ext[s]

        spmv = fused_spmv_local(top, locs[s], p,
                                None if ext is None else prepare)
        inv = None if inv_diag is None else inv_diag[s * nl:(s + 1) * nl]
        fiter = tfi.build_fused_iteration(layout, spmv, inv)
        S_s, d_s = fiter(S[:, s * nl:(s + 1) * nl].contiguous(), idx, scal)
        rows.append(S_s)
        parts.append(d_s)
    return torch.cat(rows, dim=1), torch.stack(parts)


@pytest.mark.parametrize("name", ["stencil2d5", "stencil3d7", "ell",
                                  "diagonal"])
@pytest.mark.parametrize("l", [1, 2, 3])
def test_halo_plugins_stack_to_single_device_phase(name, l):
    """Stacked over the shards, the halo plug-ins' plain versions give the
    single-device plain vector phase's rows bitwise, and their partials,
    summed in rank order, its partials within 1e-13 of sum |m u|."""
    from repro_torch.parallel.reduction import ordered_reduce

    top, locs, halo = _shard_case(name)
    for rec in ("ghysels", "stable"):
        for jac in (False, True):
            layout = tfi.SlabLayout(l=l, RB=max(l + 1, 3), recurrence=rec)
            tp = convert.jacobi(1.0 / top.diag().numpy(), "cpu") if jac \
                else None
            prec = (lambda v: v) if tp is None else tp.apply
            for i in (0, l, 2 * l + 3):
                S, idx, scal = convert.vector_phase(
                    *_triple(layout, top.n, i, seed=17 * l + i), "cpu")
                S_w, d_w = tfactory(top, tp)(layout)(S, idx, scal)
                S_h, d_h = _shard_phase(top, locs, halo, layout,
                                        None if tp is None else tp.inv_diag,
                                        S, idx, scal)
                assert torch.equal(S_h, S_w)
                _, mat, u = tref.fused_iter_unfused(S, idx, scal, top.apply,
                                                    prec, layout)
                abs_sum = (mat.abs() * u.abs()[None, :]).sum(dim=1)
                total = ordered_reduce(d_h, torch.float64, False)
                assert ((total - d_w).abs() <= RTOL * abs_sum + 1e-300).all()


def test_shard_plugin_choice():
    """No fused shard path where the JAX package has none: Stencil3D27 and
    a kernel-routed operator; a stencil's halo plug-in has its operand
    length, and 3D27 has no halo form at all."""
    from repro_torch.linalg import Stencil3D27, Stencil3D7
    from repro_torch.parallel.distributed import fused_spmv_local

    ident = lambda z: z  # noqa: E731
    assert fused_spmv_local(Stencil3D27(8, 4, 4, device="cpu"), {}, 2,
                            ident) is None
    assert fused_spmv_local(Stencil2D5(8, 4, use_kernel=True, device="cpu"),
                            {}, 2, ident) is None
    ell = _port_op("ell")
    assert fused_spmv_local(
        dataclasses.replace(ell, use_kernel=True), {}, 2, ident) is None
    sp = fused_spmv_local(Stencil3D7(8, 6, 4, device="cpu"), {}, 4, ident)
    assert sp.kind == "stencil3d7_halo" and sp.ext_len == 4 * 6 * 4
    # the bound counts only the two halo planes: the own part is z_top's copy
    assert sp.n == 2 * 6 * 4 and sp.operand_bytes == 8 * 2 * 6 * 4
    with pytest.raises(ValueError, match="halo"):
        tfi.resident_spmv("stencil3d27", ident, (2, 4, 4), prepare=ident)


@pytest.mark.cuda
def test_halo_plugins_and_deep_pipelines_bitwise_on_card(cuda_device):
    """On the card: the halo plug-ins' kernels against the whole-operator
    superkernel (stacked rows bitwise) at l in {1, 2, 9}, and the
    runtime-depth kernel's refusal past the card's shared memory."""
    from repro_torch.kernels import _build

    for name in ("stencil2d5", "stencil3d7", "ell"):
        top, locs, halo = _shard_case(name, cuda_device)
        for l in (1, 2, 9):
            layout = tfi.SlabLayout(l=l, RB=max(l + 1, 3))
            S, idx, scal = convert.vector_phase(
                *_triple(layout, top.n, 2 * l + 3, seed=l), cuda_device)
            _build.reset_launches()
            S_h, _ = _shard_phase(top, locs, halo, layout, None, S.clone(),
                                  idx, scal)
            kind = "ell_halo" if name == "ell" else name + "_halo"
            assert _build.LAUNCHES[tfi.launch_key(kind, l)] == N_SHARDS
            S_w, _ = tfactory(top)(layout)(S.clone(), idx, scal)
            assert torch.equal(S_h, S_w)
    op = Stencil2D5(16, 12, device=cuda_device)
    beyond = tfi.deepest_runtime_l(
        tfi.smem_optin("fused_iter_stencil2d5", cuda_device)) + 1
    layout = tfi.SlabLayout(l=beyond, RB=beyond + 1)
    S, idx, scal = convert.vector_phase(
        *_triple(layout, op.n, 3 * beyond, 0), cuda_device)
    with pytest.raises(ValueError, match=f"l = {beyond} .* "
                       f"{tfi.runtime_smem_bytes(beyond)} bytes"):
        tfactory(op)(layout)(S, idx, scal)


def _rows_and_partials(fiter, apply_a, prec, layout, S, idx, scal):
    """One launch of ``fiter`` on the card against its plain version:
    (rows bitwise, max |partial - plain| / sum |m u|); S is (NV, n) or a
    slab (s, NV, n)."""
    S_p, _ = fiter.plain(S, idx, scal)
    S_k, d_k = fiter(S.clone(), idx, scal)
    torch.cuda.synchronize()
    pfun = (lambda v: v) if prec is None else prec
    worst = 0.0
    for c in range(S.shape[0] if S.dim() == 3 else 1):
        one = (lambda t: t[c]) if S.dim() == 3 else (lambda t: t)
        _, mat, u = tref.fused_iter_unfused(one(S), one(idx), one(scal),
                                            apply_a, pfun, layout)
        d_p = (mat * u[None, :]).sum(dim=1)
        scale = (mat.abs() * u.abs()[None, :]).sum(dim=1)
        worst = max(worst, float(((one(d_k) - d_p).abs() / scale).max()))
    return torch.equal(S_k, S_p), worst


@pytest.mark.cuda
def test_runtime_depth_bitwise_on_card(cuda_device):
    """The runtime-depth kernel on the card against the plain vector phase
    at l in {9, 16, 27, 28} (28: past its deepest before the products were
    summed by warps), every plug-in kind (the single-device ones on grids
    of several blocks, the halo ones on a shard of 4), both recurrences,
    Jacobi on and off, at several cycle positions and as a slab of 3
    columns each at its own cycle index: rows bitwise, partials within
    1e-13 sum |m u|, and every launch counted under
    ``fused_iter_runtime_l``."""
    from repro_torch.kernels import _build
    from repro_torch.linalg import JacobiPrec
    from repro_torch.parallel.distributed import fused_spmv_local

    for l in (9, 16, 27, 28):
        for rec in ("ghysels", "stable"):
            layout = tfi.SlabLayout(l=l, RB=l + 1, recurrence=rec)
            for jac in (False, True):
                for name in ("stencil2d5", "stencil3d7", "stencil3d27",
                             "diagonal", "ell"):
                    op = _port_op(name, cuda_device, wide=True)
                    prec = JacobiPrec.from_operator(op) if jac else None
                    fiter = tfactory(op, prec)(layout)
                    papply = None if prec is None else prec.apply
                    cases = [convert.vector_phase(
                        *_triple(layout, op.n, i, seed=l + i), cuda_device)
                        for i in (0, l - 1, l, 2 * l + 3)]
                    trip = [_triple(layout, op.n, 2 * l + 1 + c, seed=c)
                            for c in range(3)]
                    cases.append(tuple(torch.tensor(np.stack(a),
                                                    device=cuda_device)
                                       for a in zip(*trip)))
                    for S, idx, scal in cases:
                        _build.reset_launches()
                        same, worst = _rows_and_partials(
                            fiter, op.apply, papply, layout, S, idx, scal)
                        assert same, (name, l, rec, jac)
                        assert worst <= RTOL, (name, l, rec, jac, worst)
                        key = tfi.launch_key(name, l, slab=S.dim() == 3)
                        assert _build.LAUNCHES[key] == 1
                for name in ("stencil2d5", "stencil3d7", "ell"):
                    top, locs, halo = _shard_case(name, cuda_device)
                    nl = top.n // N_SHARDS
                    S, idx, scal = convert.vector_phase(
                        *_triple(layout, top.n, 2 * l + 3, seed=l),
                        cuda_device)
                    zt = S[int(idx[tfi.idx_layout(l)["z_top"]])]
                    ext = halo(zt.reshape(N_SHARDS, nl))
                    inv = 1.0 / top.diag() if jac else None
                    sh = 1
                    spmv = fused_spmv_local(top, locs[sh], N_SHARDS,
                                            lambda z: ext[sh])
                    inv_s = None if inv is None else \
                        inv[sh * nl:(sh + 1) * nl].contiguous()
                    fiter = tfi.build_fused_iteration(layout, spmv, inv_s)
                    S_s = S[:, sh * nl:(sh + 1) * nl].contiguous()
                    same, worst = _rows_and_partials(
                        fiter, spmv.expr,
                        None if inv_s is None else (lambda v: inv_s * v),
                        layout, S_s, idx, scal)
                    assert same and worst <= RTOL, (name, l, rec, jac, worst)
