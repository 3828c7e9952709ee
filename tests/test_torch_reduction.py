"""The port's staged-reduction layer (``repro_torch.parallel.reduction``) and
its ladder oracle (``LocalBackend(reduction="staged", virtual_shards=P)``)
against the JAX package's, mirroring ``tests/test_reduction.py`` case by
case.  The JAX side runs through ``oracle_solver_ops`` and
``repro.core.pipelined_cg.solve`` directly (not ``get_backend``, whose
staged path sets a process-wide metrics gauge).  Inputs come from a numpy
seed.

Tolerances:
* within the port: ladder mechanics and stage-count invariance are
  bitwise (the stage count only groups the hops; the wait's sum is one
  rank-ordered chain);
* ``ordered_reduce`` on the same partials: bitwise to the numpy chain and
  to JAX's, both being one IEEE add (or Kahan step) after another;
* oracle dot blocks against JAX's: rtol 1e-14 (torch.sum and XLA sum a
  slice in other orders);
* fp64-wire solves, port against JAX and oracle against monolithic:
  residual histories relative to the initial norm within 1e-10 over every
  entry (two fp64 solves of this size agree to ~3e-16), iteration counts
  within 2, solutions within the JAX test's bounds;
* fp32-wire solves: the reference's fp32-wire convention
  (``tests/test_reduction.py:174``): residual histories relative to the
  initial norm within 1e-5 over the first 10 entries and 5e-2 over all.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

from repro.core import pipelined_cg as jplcg  # noqa: E402
from repro.core.chebyshev import shifts_for_operator as jshifts  # noqa: E402
from repro.linalg import Stencil2D5 as JStencil2D5  # noqa: E402
from repro.parallel import reduction as jred  # noqa: E402
from repro_torch.core import pipelined_cg as tplcg  # noqa: E402
from repro_torch.core.types import SolverOps, dot_block_rows  # noqa: E402
from repro_torch.linalg import Stencil2D5  # noqa: E402
from repro_torch.parallel import reduction as tred  # noqa: E402
from repro_torch.parallel.backends import LocalBackend, get_backend  # noqa: E402

HEAD, TAIL = 1e-5, 5e-2   # fp32 wire against fp64
FP64_HIST = 1e-10         # fp64 against fp64, every entry


def _op():
    return Stencil2D5(16, 12, device="cpu")


def _jax_oracle(n_shards, stages, payload=None):
    return jred.oracle_solver_ops(
        JStencil2D5(16, 12), None,
        jred.StagedConfig(n_shards=n_shards, stages=stages, axis=None,
                          payload_dtype=payload))


def _port_oracle(n_shards, stages, payload=None):
    return tred.oracle_solver_ops(
        _op(), None, tred.StagedConfig(n_shards=n_shards, stages=stages,
                                       payload_dtype=payload))


def _problem(seed, l, dtype=np.float64):
    """b from the seed and the JAX package's shifts for l, as numpy."""
    b = np.random.default_rng(seed).standard_normal(16 * 12).astype(dtype)
    return b, np.asarray(jshifts(JStencil2D5(16, 12), l), dtype)


def _assert_head_tail(h_t, h_j, norm0, head=HEAD, tail=TAIL):
    m = (h_t >= 0) & (h_j >= 0)
    diff = np.abs(h_t[m] - h_j[m]) / norm0
    assert diff[:10].max() < head, diff[:10].max()
    assert diff.max() < tail, diff.max()


def _assert_fp64_history(h_t, h_j, norm0):
    _assert_head_tail(h_t, h_j, norm0, FP64_HIST, FP64_HIST)


# ------------------------------------------------------------- ladder shape --
def test_hop_groups_partition_the_ring():
    for p in (2, 3, 8, 16):
        for stages in range(1, p):
            groups = tred.hop_groups(p, stages)
            assert groups == jred.hop_groups(p, stages)
            assert len(groups) == stages
            assert [h for g in groups for h in g] == list(range(p - 1))
            sizes = [len(g) for g in groups]
            assert all(a >= b for a, b in zip(sizes, sizes[1:]))
            assert max(sizes) == math.ceil((p - 1) / stages)


def test_staged_config_validation():
    with pytest.raises(ValueError):
        tred.StagedConfig(n_shards=8, stages=0)
    with pytest.raises(ValueError):
        tred.StagedConfig(n_shards=8, stages=8)   # max is p-1 hops
    with pytest.raises(ValueError):
        tred.StagedConfig(n_shards=0)
    cfg = tred.StagedConfig(n_shards=8, stages=7)
    assert cfg.n_hops == 7 == jred.StagedConfig(n_shards=8, stages=7).n_hops
    assert tred.StagedConfig(n_shards=1, stages=1).n_hops == 0
    assert cfg.wire_dtype(torch.float64) == torch.float64
    cfg32 = tred.StagedConfig(n_shards=8, stages=2,
                              payload_dtype=torch.float32)
    assert cfg32.wire_dtype(torch.float64) == torch.float32
    assert cfg32.compensated(torch.float64)
    assert not cfg.compensated(torch.float64)
    assert not cfg32.compensated(torch.float32)


def test_wire_accounting():
    for args in ((2,), (3,), (2, 8), (3, 8)):
        for dsize in (4, 8):
            assert tred.hop_payload_bytes(*args, dsize=dsize) == \
                jred.hop_payload_bytes(*args, dsize=dsize)
    assert tred.hop_payload_bytes(2, dsize=8) == 5 * 8
    assert tred.hop_payload_bytes(3, s=8, dsize=4) == 7 * 8 * 4
    assert tred.hop_payload_bytes(3, dsize=4) * 2 == \
        tred.hop_payload_bytes(3, dsize=8)
    for p in (2, 4, 8):
        assert tred.reduction_wire_bytes(p, 2, dsize=8) == \
            jred.reduction_wire_bytes(p, 2, dsize=8) == (p - 1) * 5 * 8


# ------------------------------------------------- ordered / compensated sum --
def test_ordered_reduce_is_rank_order_linear():
    parts = np.random.default_rng(0).standard_normal((8, 5))
    out = tred.ordered_reduce(torch.from_numpy(parts), torch.float64,
                              compensated=False)
    ref = parts[0].copy()
    for k in range(1, 8):
        ref = ref + parts[k]
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jred.ordered_reduce(
            jnp.asarray(parts), jnp.float64, compensated=False)))


def test_compensated_reduce_beats_naive_fp32():
    rng = np.random.default_rng(1)
    parts64 = rng.standard_normal(64) * np.logspace(0, 7, 64)
    exact = math.fsum(parts64)
    parts32 = parts64.astype(np.float32).reshape(64, 1)
    kahan = float(tred.ordered_reduce(torch.from_numpy(parts32),
                                      torch.float64, compensated=True)[0])
    naive32 = float(tred.ordered_reduce(torch.from_numpy(parts32),
                                        torch.float32, compensated=False)[0])
    bound = np.abs(parts64).sum() * np.finfo(np.float32).eps
    assert abs(kahan - exact) <= bound
    assert abs(kahan - exact) <= abs(naive32 - exact) + 1e-30
    jk = float(jred.ordered_reduce(jnp.asarray(parts32), jnp.float64,
                                   compensated=True)[0])
    assert kahan == jk


# --------------------------------------------------------- the eager oracle --
def test_oracle_matches_rank_split_and_jax():
    """Every virtual shard count gives the explicit numpy rank-order
    recombination of the same slices, and JAX's oracle dot block."""
    op = _op()
    rng = np.random.default_rng(2)
    mat = rng.standard_normal((5, op.n))
    vec = rng.standard_normal(op.n)
    for v in (2, 4, 8):
        ops = _port_oracle(v, min(2, v - 1))
        dots = ops.wait(ops.start(torch.from_numpy(mat),
                                  torch.from_numpy(vec)))
        m = mat.reshape(5, v, op.n // v)
        w = vec.reshape(v, op.n // v)
        ref = (m[:, 0, :] * w[0]).sum(axis=1)
        for r in range(1, v):
            ref = ref + (m[:, r, :] * w[r]).sum(axis=1)
        np.testing.assert_allclose(dots.numpy(), ref, rtol=1e-14)
        jops = _jax_oracle(v, min(2, v - 1))
        jd = jops.wait(jops.start(jnp.asarray(mat), jnp.asarray(vec)))
        np.testing.assert_allclose(dots.numpy(), np.asarray(jd), rtol=1e-14)
    with pytest.raises(ValueError, match="divisible"):
        _port_oracle(5, 2).start(torch.from_numpy(mat),
                                 torch.from_numpy(vec))


def test_oracle_solver_parity_with_monolithic_and_jax():
    """The ladder oracle is a drop-in SolverOps: its p(2)-CG solve
    converges to the monolithic solution, and its history follows the
    monolithic one's and the JAX oracle's within the fp64 bound."""
    b, sig = _problem(3, 2)
    kw = dict(l=2, sigmas=sig, tol=1e-10, maxit=1500)
    op = _op()
    res_m = tplcg.solve(SolverOps.local(op), torch.from_numpy(b), **kw)
    res_j = jplcg.solve(_jax_oracle(4, 1), jnp.asarray(b), **kw)
    for v, stages in ((4, 1), (4, 3), (8, 2)):
        res_o = tplcg.solve(_port_oracle(v, stages), torch.from_numpy(b),
                            **kw)
        assert bool(res_o.converged)
        assert abs(int(res_o.iters) - int(res_m.iters)) <= 2
        np.testing.assert_allclose(res_o.x.numpy(), res_m.x.numpy(),
                                   atol=1e-9)
        _assert_fp64_history(res_o.res_history.numpy(),
                             res_m.res_history.numpy(), float(res_m.norm0))
        if v == 4:
            assert abs(int(res_o.iters) - int(res_j.iters)) <= 2
            _assert_fp64_history(res_o.res_history.numpy(),
                                 np.asarray(res_j.res_history),
                                 float(res_j.norm0))
            np.testing.assert_allclose(res_o.x.numpy(), np.asarray(res_j.x),
                                       atol=1e-9)


def test_oracle_stage_count_invariance_is_bitwise():
    """Stages only regroup the hops, so histories across stage counts are
    bitwise equal, through the solver ops and through the backend; the
    port's history follows the JAX oracle's within the fp64 bound."""
    b, sig = _problem(4, 3)
    kw = dict(l=3, sigmas=sig, tol=1e-9, maxit=1500)
    hists = []
    for stages in (1, 2, 3, 7):
        res = tplcg.solve(_port_oracle(8, stages), torch.from_numpy(b), **kw)
        hists.append(res.res_history.numpy())
        be = LocalBackend(device="cpu", reduction="staged",
                          reduction_stages=stages, virtual_shards=8)
        np.testing.assert_array_equal(
            be.solve(_op(), b, **kw).res_history.numpy(), hists[-1])
    for h in hists[1:]:
        np.testing.assert_array_equal(h, hists[0])
    res_j = jplcg.solve(_jax_oracle(8, 1), jnp.asarray(b), **kw)
    _assert_fp64_history(hists[0], np.asarray(res_j.res_history),
                         float(res_j.norm0))


def test_oracle_fp32_payload_bounded_tail():
    """fp32 wire + fp64 compensated accumulation: the same solution at the
    same iteration count +-2 as the fp64 wire, the history within the
    head/tail bounds of it, and of the JAX oracle's fp32-wire history."""
    b, sig = _problem(5, 2)
    kw = dict(l=2, sigmas=sig, tol=1e-8, maxit=1500)
    res64 = tplcg.solve(_port_oracle(8, 2), torch.from_numpy(b), **kw)
    res32 = tplcg.solve(_port_oracle(8, 2, torch.float32),
                        torch.from_numpy(b), **kw)
    assert bool(res32.converged)
    assert abs(int(res32.iters) - int(res64.iters)) <= 2
    _assert_head_tail(res32.res_history.numpy(), res64.res_history.numpy(),
                      float(res64.norm0))
    np.testing.assert_allclose(res32.x.numpy(), res64.x.numpy(), atol=1e-6)
    res_j = jplcg.solve(_jax_oracle(8, 2, jnp.float32), jnp.asarray(b), **kw)
    assert abs(int(res32.iters) - int(res_j.iters)) <= 2
    _assert_head_tail(res32.res_history.numpy(),
                      np.asarray(res_j.res_history), float(res_j.norm0))
    np.testing.assert_allclose(res32.x.numpy(), np.asarray(res_j.x),
                               atol=1e-6)


def test_fp32_solver_with_fp32_wire():
    """A float32 solver with an fp32 wire converges, its history in fp32:
    the wait accumulates in fp64 and the solver casts the block back.  (The
    JAX test also runs Ghysels p-CG, which the port has not yet.)"""
    b, sig = _problem(7, 2, np.float32)
    ops = _port_oracle(4, 2, torch.float32)
    res = tplcg.solve(ops, torch.from_numpy(b), l=2,
                      sigmas=torch.from_numpy(sig), tol=1e-5, maxit=400)
    assert res.res_history.dtype == torch.float32
    assert bool(res.converged)
    res_j = jplcg.solve(_jax_oracle(4, 2, jnp.float32), jnp.asarray(b), l=2,
                        sigmas=jnp.asarray(sig), tol=1e-5, maxit=400)
    assert abs(int(res.iters) - int(res_j.iters)) <= 2
    np.testing.assert_allclose(res.x.numpy(), np.asarray(res_j.x),
                               atol=1e-3)


# ------------------------------------------------------- handle API surface --
def test_handle_zeros_shapes():
    mono = SolverOps.local(_op())
    assert mono.handle_zeros((5,), torch.float64).shape == (5,)
    h = _port_oracle(8, 2).handle_zeros((5,), torch.float64)
    assert h.shape == (8, 5) and h.dtype == torch.float64
    h32 = _port_oracle(8, 2, torch.float32).handle_zeros((7,), torch.float64)
    assert h32.shape == (8, 7) and h32.dtype == torch.float32
    jh = _jax_oracle(8, 2, jnp.float32).handle_zeros((7,), jnp.float64)
    assert tuple(jh.shape) == tuple(h32.shape)


def test_advance_is_identity_on_monolithic_ops():
    op = _op()
    mono = SolverOps.local(op)
    h = torch.arange(5.0, dtype=torch.float64)
    assert torch.equal(mono.advance(h, 0), h)
    staged = _port_oracle(8, 3)
    assert torch.equal(staged.advance(h, 1), h)
    rng = np.random.default_rng(6)
    mat = torch.from_numpy(rng.standard_normal((3, op.n)))
    vec = torch.from_numpy(rng.standard_normal(op.n))
    d0 = mono.wait(mono.start(mat, vec), advanced=0)
    assert torch.equal(d0, dot_block_rows(mat, vec))


def test_local_backend_staged_registry():
    be = get_backend("local", reduction="staged", virtual_shards=8,
                     reduction_stages=3, device="cpu")
    assert be.reduction_mode == "staged"
    cfg = be.reduction_cfg
    assert cfg.n_shards == 8 and cfg.stages == 3
    # Stages clamp into [1, P - 1], as the JAX resolution does.
    assert LocalBackend(device="cpu", reduction="staged",
                        reduction_stages=9,
                        virtual_shards=4).reduction_cfg.stages == 3
    mono = LocalBackend(device="cpu")
    assert mono.reduction_mode == "monolithic" and mono.reduction_cfg is None
    with pytest.raises(ValueError):
        get_backend("local", reduction="banana", device="cpu")
    # No port backend declines the ladder, so the JAX module's downgrade
    # (its ``supports_staged_reduction`` flag) has no counterpart: a staged
    # request is always granted.
    assert not hasattr(be, "supports_staged_reduction")
    assert not hasattr(tred, "ReductionFallbackWarning")
