"""The port's telemetry ring (``core.pipelined_cg`` with ``telemetry_cap``,
``core.types.TelemetrySlab``) against the JAX package's on the CPU, and
its invariants: bitwise invisible to the arithmetic, deterministic, the
same ring fused and unfused, one ring per slab column, no extra host
synchronisation.  Mirrors tests/test_telemetry.py (its layout, ring
contents, invisibility, determinism, batched, host-transfer and staged
tests).

Tolerances (port vs JAX, the same seeded problem, l = 2 with the JAX
package's Chebyshev shifts): the discrete columns (iter, upd, age,
breakdown, restart, replacement, action) are equal; rnorm agrees to 1e-8
relative and each row's dot block to 1e-8 of its largest entry: the two
packages differ by XLA's FMA contraction and the dot-block summation
order (tests/test_torch_pipelined_cg.py).  Everything the port holds
against itself is bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

from repro.core.chebyshev import shifts_for_operator as jshifts  # noqa: E402
from repro.core.types import TelemetrySlab as JSlab  # noqa: E402
from repro.kernels.fused_iter import tel_layout as jtel_layout  # noqa: E402
from repro.linalg import Stencil2D5 as JStencil  # noqa: E402
from repro.parallel import get_backend as jget_backend  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.types import TelemetrySlab  # noqa: E402
from repro_torch.kernels.fused_iter import tel_layout  # noqa: E402
from repro_torch.parallel.backends import LocalBackend  # noqa: E402

DISCRETE = ("iter", "upd", "age", "breakdown", "restart", "replacement",
            "action")
RNORM_RTOL = 1e-8
DOTS_RTOL = 1e-8


def _problem():
    jop = JStencil(32, 24)
    top = convert.operator("stencil2d5", nx=32, ny=24, device="cpu")
    b = np.random.default_rng(3).standard_normal(jop.n)
    sig = np.asarray(jshifts(jop, 2))
    return jop, top, b, sig


def _kw(sig, **extra):
    return dict(method="plcg", l=2, sigmas=convert.sigmas(sig, "cpu"),
                tol=1e-10, maxit=400, **extra)


def _assert_rings_close(ring_t, ring_j, l):
    """The port's ring against the JAX package's under the stated
    tolerances."""
    ct = TelemetrySlab(cap=ring_t.shape[-2], l=l).unpack(np.asarray(ring_t))
    cj = JSlab(cap=ring_j.shape[-2], l=l).unpack(np.asarray(ring_j))
    for name in DISCRETE:
        np.testing.assert_array_equal(ct[name], cj[name], err_msg=name)
    np.testing.assert_allclose(ct["rnorm"], cj["rnorm"], rtol=RNORM_RTOL)
    scale = np.abs(cj["dots"]).max(axis=-1, keepdims=True)
    assert (np.abs(ct["dots"] - cj["dots"])
            <= DOTS_RTOL * np.maximum(scale, 1e-300)).all()


# ---------------------------------------------------------------- layout --

@pytest.mark.parametrize("l", [1, 2, 3])
def test_telemetry_slab_layout(l):
    """TelemetrySlab and tel_layout are the JAX package's: K = 2l+10, the
    same offsets, unpack exposes every column and the 2l+1 dot block."""
    assert tel_layout(l) == jtel_layout(l)
    ts, js = TelemetrySlab(cap=32, l=l), JSlab(cap=32, l=l)
    assert ts.k == js.k == 2 * l + 10
    assert ts.shape == js.shape == (32, ts.k)
    assert ts.bytes_per_iter() == js.bytes_per_iter() == ts.k * 8
    ring = np.random.default_rng(l).standard_normal(ts.shape)
    cols_t, cols_j = ts.unpack(torch.as_tensor(ring)), js.unpack(ring)
    assert cols_t.keys() == cols_j.keys()
    assert cols_t["dots"].shape == (32, 2 * l + 1)
    for name in cols_t:
        np.testing.assert_array_equal(cols_t[name].numpy(), cols_j[name])


# ------------------------------------------------------- ring contents --

def test_ring_contents_match_history_and_jax():
    """The rnorm column IS the residual history (bitwise, at each row's
    update count), the ring is the JAX package's under the stated
    tolerances, and a small cap wraps without touching the arithmetic."""
    jop, top, b, sig = _problem()
    be = LocalBackend(device="cpu")
    res = be.solve(top, b, telemetry_cap=512, **_kw(sig))
    assert res.telemetry is not None and res.telemetry.shape == (512, 14)
    cols = TelemetrySlab(cap=512, l=2).unpack(res.telemetry.numpy())
    written = cols["iter"] >= 0
    assert written.sum() >= int(res.iters)
    hist = res.res_history.numpy()
    for r in np.nonzero(written & (cols["rnorm"] >= 0))[0]:
        assert hist[int(cols["upd"][r])] == cols["rnorm"][r]

    rj = jget_backend("local").solve(
        jop, jnp.asarray(b), method="plcg", l=2, sigmas=jnp.asarray(sig),
        tol=1e-10, maxit=400, telemetry_cap=512)
    assert int(rj.iters) == int(res.iters)
    _assert_rings_close(res.telemetry, rj.telemetry, 2)

    res_w = be.solve(top, b, telemetry_cap=8, **_kw(sig))
    assert res_w.telemetry.shape == (8, 14)
    assert torch.equal(res_w.res_history, res.res_history)
    assert int(res_w.iters) == int(res.iters)
    # the wrapped ring holds the last 8 rows of the long one
    last = cols["iter"].max()
    cw = TelemetrySlab(cap=8, l=2).unpack(res_w.telemetry.numpy())
    assert sorted(cw["iter"]) == list(np.arange(last - 7, last + 1))


# ---------------------------------------------------------- determinism --

@pytest.mark.parametrize("fused", [False, True])
def test_instrumented_solve_is_bitwise_invisible(fused):
    """x and the residual history are bitwise the same with and without
    the ring (and with governor=None passed explicitly), fused and
    unfused."""
    _, top, b, sig = _problem()
    be = LocalBackend(device="cpu")
    kw = _kw(sig, fused_iteration=fused, unroll=4)
    plain = be.solve(top, b, **kw)
    inst = be.solve(top, b, telemetry_cap=256, **kw)
    expl = be.solve(top, b, telemetry_cap=0, governor=None, **kw)
    assert plain.telemetry is None and expl.telemetry is None
    assert inst.telemetry is not None
    for r in (inst, expl):
        assert torch.equal(r.res_history, plain.res_history)
        assert torch.equal(r.x, plain.x)
        assert int(r.iters) == int(plain.iters)


def test_telemetry_deterministic_and_fused_parity():
    """The same solve twice writes the same ring bitwise, and the fused
    superkernel's plain version writes the unfused loop's ring."""
    _, top, b, sig = _problem()
    be = LocalBackend(device="cpu")
    kw = _kw(sig, telemetry_cap=256)
    t1 = be.solve(top, b, **kw).telemetry
    t2 = be.solve(top, b, **kw).telemetry
    tf = be.solve(top, b, fused_iteration=True, **kw).telemetry
    assert torch.equal(t1, t2)
    assert torch.equal(t1, tf)


def test_batched_telemetry_per_column():
    """A slab of 4: one (s, cap, K) ring, run-twice bitwise, column j's
    ring bitwise the sequential ring of column j, and the plain batched
    histories bitwise the instrumented ones."""
    _, top, b, sig = _problem()
    be = LocalBackend(device="cpu")
    B = np.random.default_rng(5).standard_normal((4, top.n))
    kw = _kw(sig, telemetry_cap=128)
    r1 = be.solve_batched(top, B, **kw)
    r2 = be.solve_batched(top, B, **kw)
    assert r1.telemetry.shape == (4, 128, 14)
    assert torch.equal(r1.telemetry, r2.telemetry)
    plain = be.solve_batched(top, B, **_kw(sig))
    assert plain.telemetry is None
    assert torch.equal(plain.res_history, r1.res_history)
    assert torch.equal(plain.x, r1.x)
    for j in (0, 3):
        seq = be.solve(top, B[j], **kw)
        assert torch.equal(seq.telemetry, r1.telemetry[j]), j


# ------------------------------------------------------- host transfers --

@pytest.mark.parametrize("unroll", [1, 16])
def test_ring_adds_no_host_synchronisation(unroll):
    """The ring lives on the device until the result is read: an
    instrumented solve reads device state exactly as often as the plain
    one (the port's counterpart of the JAX test's host-transfer count on
    the compiled module)."""
    _, top, b, sig = _problem()
    be = LocalBackend(device="cpu")
    kw = _kw(sig, unroll=unroll)
    plain = be.solve(top, b, **kw)
    inst = be.solve(top, b, telemetry_cap=256, **kw)
    assert inst.host_syncs == plain.host_syncs > 0


# --------------------------------------------------- the staged oracle --

def test_staged_oracle_telemetry():
    """The ladder oracle (``reduction="staged"``, 4 virtual shards)
    carries the ring like the monolithic reduction: run-twice bitwise,
    bitwise invisible, and the JAX package's staged oracle's ring under
    the stated tolerances."""
    jop, top, b, sig = _problem()
    be = LocalBackend(device="cpu", reduction="staged", virtual_shards=4)
    kw = _kw(sig, telemetry_cap=128)
    o1 = be.solve(top, b, **kw)
    o2 = be.solve(top, b, **kw)
    assert torch.equal(o1.telemetry, o2.telemetry)
    plain = be.solve(top, b, **_kw(sig))
    assert torch.equal(plain.res_history, o1.res_history)
    assert torch.equal(plain.x, o1.x)
    rj = jget_backend("local", reduction="staged", virtual_shards=4).solve(
        jop, jnp.asarray(b), method="plcg", l=2, sigmas=jnp.asarray(sig),
        tol=1e-10, maxit=400, telemetry_cap=128)
    _assert_rings_close(o1.telemetry, rj.telemetry, 2)
