"""The port's row partition (``repro_torch.linalg.partition``) against the
JAX package's (``repro.linalg.partition``), mirroring the partition cases
of ``tests/test_sparse.py``: each package builds its own plan from the
same seeded mesh, and the plans must agree field by field; the port's
shard-level apply over the in-process halo must equal the ordered
operator's global apply.

Tolerances:
* plans: integers and index arrays exactly, values bitwise (both packages
  run the same host numpy);
* ``apply_local`` against the permuted global ``SparseOp.apply``: bitwise
  (the same ELL slots summed by the same ``ell_rowsum`` chain);
* against ``emulate_partitioned_apply`` (numpy ``.sum`` over the slots, a
  different order) and the dense product: 1e-13 relative to the largest
  |A| |x| row sum.
"""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

from repro.linalg import partition as jpart  # noqa: E402
from repro.linalg import sparse as jsp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.linalg import partition as tpart  # noqa: E402
from repro_torch.linalg import sparse as tsp  # noqa: E402

RTOL = 1e-13

# (mesh, P): the cases of tests/test_sparse.py's partition test, plus P = 2
# and a wide-bandwidth mesh that needs two hops at P = 4.
CASES = [
    (("mesh", 0, 96, 5.0), 8),          # multi-hop halo
    (("mesh", 1, 400, 6.0), 8),         # one-hop halo
    (("ice", 2, (10, 6, 4), 0.05), 8),  # ice sheet, two hops
    (("mesh", 5, 120, 6.0), 4),
    (("mesh", 6, 75, 6.0), 1),          # degenerate P = 1
    (("mesh", 3, 64, 12.0), 4),         # wide bandwidth: two hops at P = 4
    (("mesh", 9, 200, 6.0), 2),
]
IDS = [f"{m[0]}{m[1]}-P{p}" for m, p in CASES]


def _ops(mesh):
    """The same mesh from each package's own generator."""
    kind, seed, size, arg = mesh
    if kind == "ice":
        return (jsp.random_fem_icesheet(seed, *size, eps_z=arg),
                tsp.random_fem_icesheet(seed, *size, eps_z=arg,
                                        device="cpu"))
    return (jsp.random_fem_mesh(seed, size, avg_degree=arg),
            tsp.random_fem_mesh(seed, size, avg_degree=arg, device="cpu"))


def _fields(plan):
    return {f: getattr(plan, f) for f in convert.PLAN_FIELDS}


def _scale(op, x):
    return float((np.abs(op.to_dense()) @ np.abs(x)).max())


@pytest.mark.parametrize("mesh,n_shards", CASES, ids=IDS)
def test_plan_matches_jax(mesh, n_shards):
    jop, top = _ops(mesh)
    jp = jpart.partition_spd(jop, n_shards)
    tp = tpart.partition_spd(top, n_shards)
    for f in ("n_shards", "n", "nxl", "hops", "max_send", "band"):
        assert getattr(tp, f) == getattr(jp, f), f
    np.testing.assert_array_equal(tp.perm, jp.perm)
    for f in ("cols", "vals", "send_up", "send_dn"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)
    assert tp.cols.dtype == tp.send_up.dtype == torch.int32
    assert tp.ext == jp.nxl + 2 * jp.hops * jp.max_send
    assert tp.neighbor_bytes() == jp.neighbor_bytes()
    assert tp.occupancy() == jp.occupancy()
    assert tp.halo_rows_fraction() == jp.halo_rows_fraction()
    # The JAX plan carried across applies the same as the port's own.
    cp = convert.partition_plan(device="cpu", **_fields(jp))
    for f in ("cols", "vals", "send_up", "send_dn"):
        assert torch.equal(getattr(cp, f), getattr(tp, f)), f


@pytest.mark.parametrize("mesh,n_shards", CASES, ids=IDS)
def test_apply_local_equals_permuted_global_apply(mesh, n_shards):
    jop, top = _ops(mesh)
    tp = tpart.partition_spd(top, n_shards)
    x = np.random.default_rng(11 + n_shards).standard_normal(top.n)
    xp = x[tp.perm]
    oop = tsp.permute_spd(top, tp.perm, ordered=True)
    y_global = oop.apply(torch.from_numpy(xp))
    x_local = torch.from_numpy(xp).reshape(n_shards, tp.nxl)
    for use_kernel in (False, True):      # True: the kernel's plain version
        y = tpart.apply_local(x_local, tp.cols, tp.vals, tp.send_up,
                              tp.send_dn, use_kernel=use_kernel)
        assert y.shape == (n_shards, tp.nxl)
        assert torch.equal(y.reshape(-1), y_global)
    scale = RTOL * _scale(oop, xp)
    y_emul = tpart.emulate_partitioned_apply(tp, xp)
    np.testing.assert_allclose(y.reshape(-1).numpy(), y_emul, atol=scale)
    jp = jpart.partition_spd(jop, n_shards)
    np.testing.assert_allclose(
        y.reshape(-1).numpy(), jpart.emulate_partitioned_apply(jp, xp),
        atol=scale)
    np.testing.assert_allclose(
        y.reshape(-1).numpy(),
        top.to_dense()[np.ix_(tp.perm, tp.perm)] @ xp, atol=scale)


def test_halo_exchange_slabs():
    """Shard s's extended vector: own rows, then the hop slabs from s-1..
    s-hops and s+1..s+hops, each the sender's send-set gather, zeros where
    no peer exists."""
    _, top = _ops(("mesh", 0, 96, 5.0))
    tp = tpart.partition_spd(top, 8)
    assert tp.hops == 2
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(top.n))
    xl = x.reshape(8, tp.nxl)
    xe = tpart.halo_exchange(xl, tp.send_up, tp.send_dn)
    assert xe.shape == (8, tp.ext)
    ms, nxl = tp.max_send, tp.nxl
    for s in range(8):
        assert torch.equal(xe[s, :nxl], xl[s])
        for h in (1, 2):
            prev = xe[s, nxl + (h - 1) * ms:nxl + h * ms]
            nxt = xe[s, nxl + (tp.hops + h - 1) * ms:nxl + (tp.hops + h) * ms]
            want_p = xl[s - h][tp.send_up[s - h, h - 1].long()] if s >= h \
                else torch.zeros(ms, dtype=xl.dtype)
            want_n = xl[s + h][tp.send_dn[s + h, h - 1].long()] \
                if s + h < 8 else torch.zeros(ms, dtype=xl.dtype)
            assert torch.equal(prev, want_p) and torch.equal(nxt, want_n)


def test_partition_requires_divisible_n():
    _, top = _ops(("mesh", 0, 90, 6.0))
    with pytest.raises(AssertionError, match="n % n_shards"):
        tpart.partition_spd(top, 8)


def test_plan_cache_memoizes():
    _, top = _ops(("mesh", 7, 80, 6.0))
    before = len(tpart._PLAN_CACHE)
    p1 = tpart.plan_for(top, 4)
    p2 = tpart.plan_for(tsp.SparseOp(cols=top.cols.clone(),
                                     vals=top.vals.clone()), 4)
    assert p1 is p2
    assert len(tpart._PLAN_CACHE) == before + 1
    assert tpart.plan_for(top, 2) is not p1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_apply_local_kernel_bitwise_on_card(cuda_device):
    _, top = _ops(("ice", 2, (10, 6, 4), 0.05))
    tp = tpart.partition_spd(top.to(cuda_device), 8)
    x = torch.randn(top.n, dtype=torch.float64, device=cuda_device)
    xl = x.reshape(8, tp.nxl)
    args = (tp.cols, tp.vals, tp.send_up, tp.send_dn)
    assert torch.equal(tpart.apply_local(xl, *args, use_kernel=True),
                       tpart.apply_local(xl, *args))
