"""The port's stability governor (``core.pipelined_cg`` with ``governor``,
``repro_torch.stability``) and reduction-payload chaos
(``repro_torch.chaos``) against the JAX package's on the CPU.  Mirrors
tests/test_stability.py: the truth-certified clean solve, governed
recovery under payload chaos (its governed half: the ungoverned half
fails on the reference side, ROADMAP.md queue 3), the governed slab per
column, governor-off bitwise (single, batched, and on the staged ladder
oracle), the catastrophic demotion ladder and recovery without demotion.

Two kinds of comparison:

* With the JAX tests' own settings (no Chebyshev shifts, so a monomial
  basis at l = 4) rounding differences between the packages grow by
  ~1e-3 relative within 30 updates, and the governor's decisions near
  its thresholds (the sign of a measured true-vs-recursive gap of that
  size) fall differently: there the tests hold the port to the JAX
  tests' own assertions (converged, certified by the true residual,
  replacement counts, the ladder's depths), not to JAX's action rows.
* With the JAX package's shifts the action rows match: the tests hold
  the telemetry rows' iterations and actions equal, the discrete
  governor slots equal and the real ones to 1e-10 relative.

The chaos noise is the JAX package's bit for bit; the perturbed payload
agrees to 1 ulp (XLA may contract ``x * (1 + amp * noise)``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_enable_x64", True)
torch.set_num_threads(1)

from repro.chaos.inject import ChaosConfig as JChaos  # noqa: E402
from repro.chaos.inject import chaos_ops as jchaos_ops  # noqa: E402
from repro.chaos.inject import perturb_payload as jperturb  # noqa: E402
from repro.chaos.inject import _value_hash as jhash  # noqa: E402
from repro.core import pipelined_cg as jpc  # noqa: E402
from repro.core.chebyshev import shifts_for_operator as jshifts  # noqa: E402
from repro.core.types import SolverOps as JOps  # noqa: E402
from repro.linalg import Stencil2D5 as JStencil  # noqa: E402
from repro.linalg.preconditioners import JacobiPrec as JJacobi  # noqa: E402
from repro.parallel import get_backend as jget_backend  # noqa: E402
from repro.stability import GovernorConfig as JGov  # noqa: E402
from repro.stability import StagnationError as JStagnation  # noqa: E402
from repro.stability import governed_solve as jgoverned  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.chaos import (ChaosConfig, chaos_ops, payload_noise,  # noqa: E402
                               perturb_payload)
from repro_torch.chaos.inject import _value_hash  # noqa: E402
from repro_torch.core import batched, pipelined_cg  # noqa: E402
from repro_torch.core.types import SolverOps  # noqa: E402
from repro_torch.parallel.backends import LocalBackend  # noqa: E402
from repro_torch.parallel.backends.multiprocess import (  # noqa: E402
    MultiprocessBackend)
from repro_torch.stability import (GovernorConfig, StagnationError,  # noqa: E402
                                   diagnose, governed_solve)
from repro_torch.stability import model as M  # noqa: E402

GOV_RTOL = 1e-10      # real governor slots, port vs JAX, shifted problems
DISCRETE_SLOTS = (M.BEST_UPD, M.DUE, M.REPL, M.FRUITLESS, M.STAGNATED)


def _problem():
    """The JAX tests' problem: Stencil2D5(48, 24), Jacobi, b from seed 0,
    in both packages."""
    jop = JStencil(48, 24)
    jprec = JJacobi.from_operator(jop)
    top = convert.operator("stencil2d5", nx=48, ny=24, device="cpu")
    tprec = convert.jacobi(np.asarray(jprec.inv_diag), "cpu")
    b = np.random.default_rng(0).standard_normal(jop.n)
    return jop, jprec, top, tprec, b


def _true_rel(op, b, x):
    r = torch.as_tensor(b) - op.apply(torch.as_tensor(x))
    return float(torch.linalg.norm(r) / np.linalg.norm(b))


def _ops(tprec, top, chaos=None):
    ops = SolverOps.local(top, tprec)
    return ops if chaos is None else chaos_ops(ops, chaos)


# ------------------------------------------------------- governed solves --

def test_clean_governed_solve_truth_certified():
    """The JAX test's clean problem (l = 4, stable, no shifts): converged
    from the TRUE residual, at least the certifying replacement, not
    stagnated, the certified solution within tol."""
    _, _, top, tprec, b = _problem()
    res = pipelined_cg.solve(_ops(tprec, top), torch.as_tensor(b), l=4,
                             tol=1e-6, maxit=400, max_restarts=60,
                             recurrence="stable", governor=GovernorConfig())
    d = diagnose(res)
    assert d["converged"] and not d["stagnated"]
    assert d["replacements"] >= 1
    assert _true_rel(top, b, res.x) < 1e-6


def test_governed_recovery_under_payload_chaos():
    """The governed half of the JAX recovery test: a seeded 1e-5 payload
    fault at l = 4; the governed stable solve reaches tol, certified
    against the true residual, the governor doing the work."""
    _, _, top, tprec, b = _problem()
    tol = 1e-5
    ops = _ops(tprec, top, ChaosConfig(seed=7, payload_rel_amp=1e-5))
    res = pipelined_cg.solve(ops, torch.as_tensor(b), l=4, tol=tol,
                             maxit=400, max_restarts=120,
                             recurrence="stable", governor=GovernorConfig())
    d = diagnose(res)
    assert d["converged"]
    assert d["replacements"] >= 5
    assert _true_rel(top, b, res.x) < tol


@pytest.mark.parametrize("amp", [0.0, 1e-5])
def test_governed_rows_match_jax_with_shifts(amp):
    """With the JAX package's shifts the two governors take the same
    actions at the same iterations: equal iteration and restart counts,
    equal action rows in the telemetry ring, the discrete governor slots
    equal and the real ones to GOV_RTOL."""
    jop, jprec, top, tprec, b = _problem()
    sig = np.asarray(jshifts(jop, 4, prec=jprec))
    kw = dict(tol=1e-5, maxit=400, max_restarts=120, recurrence="stable",
              telemetry_cap=512)
    jops = JOps.local(jop, jprec)
    chaos = None
    if amp:
        jops = jchaos_ops(jops, JChaos(seed=7, payload_rel_amp=amp))
        chaos = ChaosConfig(seed=7, payload_rel_amp=amp)
    rj = jpc.solve(jops, jnp.asarray(b), 4, sigmas=jnp.asarray(sig),
                   governor=JGov(), **kw)
    rt = pipelined_cg.solve(_ops(tprec, top, chaos), torch.as_tensor(b), 4,
                            sigmas=convert.sigmas(sig, "cpu"),
                            governor=GovernorConfig(), **kw)
    assert bool(rt.converged) and bool(rj.converged)
    assert int(rt.iters) == int(rj.iters)
    assert int(rt.restarts) == int(rj.restarts)
    tt, tj = rt.telemetry.numpy(), np.asarray(rj.telemetry)
    acts_t = tt[tt[:, 8] > 0][:, [0, 8]]
    acts_j = tj[tj[:, 8] > 0][:, [0, 8]]
    assert len(acts_t) >= 2
    np.testing.assert_array_equal(acts_t, acts_j)
    gt, gj = rt.governor.numpy(), np.asarray(rj.governor)
    for k in DISCRETE_SLOTS:
        assert gt[k] == gj[k], k
    np.testing.assert_allclose(gt, gj, rtol=GOV_RTOL, atol=1e-15)


def test_governed_batched_per_column():
    """A governed slab of 4 (the JAX test's settings): every column
    converges truth-certified, the governor vectors are (4, N_SLOTS) with
    each column's own replacements, and each column is bitwise its
    sequential governed solve (the per-column restart path)."""
    _, _, top, tprec, b = _problem()
    B = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (4, top.n)))
    kw = dict(l=4, tol=1e-6, maxit=400, max_restarts=60,
              recurrence="stable", governor=GovernorConfig())
    res = batched.solve_batched(_ops(tprec, top), B, "plcg", **kw)
    g = res.governor.numpy()
    assert g.shape == (4, M.N_SLOTS)
    assert res.converged.all()
    assert (g[:, M.REPL] >= 1).all()
    for j in range(4):
        assert _true_rel(top, B[j].numpy(), res.x[j]) < 1e-6, j
    for j in (0, 3):
        seq = pipelined_cg.solve(_ops(tprec, top), B[j], **kw)
        assert torch.equal(seq.x, res.x[j]), j
        assert torch.equal(seq.governor, res.governor[j]), j


# ------------------------------------------------------ governor off ---

def test_governor_off_bitwise_single_and_batched():
    """recurrence='ghysels' and governor=None passed explicitly are
    bitwise the solve without them, single and for a slab of 8."""
    _, _, top, tprec, b = _problem()
    ops = _ops(tprec, top)
    kw = dict(l=3, tol=1e-8, maxit=300)
    plain = pipelined_cg.solve(ops, torch.as_tensor(b), **kw)
    expl = pipelined_cg.solve(ops, torch.as_tensor(b), recurrence="ghysels",
                              governor=None, **kw)
    assert plain.governor is None and expl.governor is None
    assert torch.equal(plain.res_history, expl.res_history)
    assert torch.equal(plain.x, expl.x)
    B = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (8, top.n)))
    bp = batched.solve_batched(ops, B, "plcg", **kw)
    be_ = batched.solve_batched(ops, B, "plcg", recurrence="ghysels",
                                governor=None, **kw)
    assert bp.governor is None and be_.governor is None
    assert torch.equal(bp.res_history, be_.res_history)
    assert torch.equal(bp.x, be_.x)


def test_governor_off_bitwise_staged_oracle():
    """The governor-off half of the JAX test on the staged ladder: on the
    port's ladder oracle (8 virtual shards) explicit defaults leave the
    history and x bitwise, and a governed staged solve converges
    truth-certified."""
    top = convert.operator("stencil2d5", nx=32, ny=24, device="cpu")
    b = np.random.default_rng(3).standard_normal(top.n)
    sig = convert.sigmas(np.asarray(jshifts(JStencil(32, 24), 2)), "cpu")
    be = LocalBackend(device="cpu", reduction="staged", virtual_shards=8)
    kw = dict(method="plcg", l=2, sigmas=sig, tol=1e-8, maxit=400)
    plain = be.solve(top, b, **kw)
    expl = be.solve(top, b, recurrence="ghysels", governor=None, **kw)
    assert torch.equal(plain.res_history, expl.res_history)
    assert torch.equal(plain.x, expl.x)
    gov = be.solve(top, b, **dict(kw, tol=1e-6, recurrence="stable",
                                  governor=GovernorConfig()))
    assert diagnose(gov)["converged"]
    assert _true_rel(top, b, gov.x) < 1e-6


# ---------------------------------------------------- demotion ladder ---

def test_catastrophic_chaos_demotes_then_raises():
    """30 % payload corruption defeats replacement at every depth: the
    port's ladder tries the JAX package's depths, 4 -> 2 -> 1, and raises
    a typed StagnationError carrying the per-depth diagnosis.  (The
    replacement counts of each rung are rounding-sensitive here, no
    shifts: they are not compared.)"""
    jop, jprec, top, tprec, b = _problem()
    kw = dict(tol=1e-6, maxit=400, max_restarts=60)
    with pytest.raises(StagnationError) as ei:
        governed_solve(LocalBackend(device="cpu"), top, b, l=4, prec=tprec,
                       ops_transform=lambda o: chaos_ops(
                           o, ChaosConfig(seed=3, payload_rel_amp=0.3)),
                       **kw)
    with pytest.raises(JStagnation) as ej:
        jgoverned(jget_backend("local"), jop, jnp.asarray(b), l=4,
                  prec=jprec, ops_transform=lambda o: jchaos_ops(
                      o, JChaos(seed=3, payload_rel_amp=0.3)), **kw)
    err = ei.value
    assert "l=1" in str(err)
    tried = [a["l"] for a in err.diagnosis["attempts"]]
    assert tried == [a["l"] for a in ej.value.diagnosis["attempts"]]
    assert tried == [4, 2, 1]
    assert not any(a["converged"] for a in err.diagnosis["attempts"])


def test_ladder_from_l16_walks_every_rung():
    """A ladder started at l = 16 (the runtime-depth superkernel's range
    on the card) under catastrophic chaos tries 16, 8, 4, 2, 1, fused,
    and raises; a small budget keeps it short."""
    _, _, top, tprec, b = _problem()
    with pytest.raises(StagnationError) as ei:
        governed_solve(LocalBackend(device="cpu"), top, b, l=16, prec=tprec,
                       ops_transform=lambda o: chaos_ops(
                           o, ChaosConfig(seed=3, payload_rel_amp=0.3)),
                       tol=1e-6, maxit=40, max_restarts=4,
                       fused_iteration=True, unroll=16)
    assert [a["l"] for a in ei.value.diagnosis["attempts"]] == \
        [16, 8, 4, 2, 1]


def test_governed_solve_recovers_without_demotion():
    """A mild fault is repaired at full depth: one attempt, converged,
    through ``LocalBackend.run`` (the ops_transform wire point)."""
    _, _, top, tprec, b = _problem()
    res, attempts = governed_solve(
        LocalBackend(device="cpu"), top, b, l=4, prec=tprec,
        ops_transform=lambda o: chaos_ops(
            o, ChaosConfig(seed=7, payload_rel_amp=1e-5)),
        tol=1e-5, maxit=400, max_restarts=120)
    assert len(attempts) == 1 and attempts[0]["l"] == 4
    assert attempts[0]["converged"]
    assert _true_rel(top, b, res.x) < 1e-5


# ----------------------------------------------------------------- chaos --

@pytest.mark.parametrize("seed,prob", [(0, 1.0), (7, 1.0), (3, 0.25),
                                       (2 ** 31 + 5, 0.5)])
def test_chaos_noise_bitwise_vs_jax(seed, prob):
    """On random fp64 payloads over 40 decades (and zeros, negatives,
    denormal float32 casts), the port's hash and noise equal the JAX
    package's bit for bit; the perturbed payload agrees to 1 ulp."""
    rng = np.random.default_rng(seed % 1000)
    x = rng.standard_normal(4096) * 10.0 ** rng.integers(-40, 40, 4096)
    x[:8] = [0.0, -0.0, 1e-45, -1e-45, 3.4e38, 1.0, -1.0, 2.0 ** -126]
    xt = torch.as_tensor(x)
    np.testing.assert_array_equal(
        _value_hash(xt, seed, 1).numpy(),
        np.asarray(jhash(jnp.asarray(x), seed, 1)).astype(np.int64))
    jcfg = JChaos(seed=seed, payload_rel_amp=0.3, payload_prob=prob)
    cfg = ChaosConfig(seed=seed, payload_rel_amp=0.3, payload_prob=prob)
    # The JAX package's noise expression (inject.py:107-113) in numpy on
    # its own hash: (h >> 8) is floor(h / 256), exact in fp64.
    jh = np.asarray(jhash(jnp.asarray(x), seed, 1)).astype(np.float64)
    jnoise = np.floor(jh / 256) * (1.0 / (1 << 24)) * 2.0 - 1.0
    if prob < 1.0:
        jg = np.asarray(jhash(jnp.asarray(x), seed, 2)).astype(np.float64)
        jnoise = np.where(np.floor(jg / 256) * (1.0 / (1 << 24)) < prob,
                          jnoise, 0.0)
    np.testing.assert_array_equal(payload_noise(xt, cfg).numpy(), jnoise)
    pj = np.asarray(jperturb(jnp.asarray(x), jcfg))
    pt = perturb_payload(xt, cfg).numpy()
    assert (np.abs(pt - pj) <= np.spacing(np.abs(pj))).all()


def test_chaos_ops_wraps_only_the_wait():
    """chaos_ops leaves SPMV, preconditioner and start alone and perturbs
    what the wait returns; amp 0 is the identity."""
    _, _, top, tprec, b = _problem()
    ops = SolverOps.local(top, tprec)
    cfg = ChaosConfig(seed=1, payload_rel_amp=1e-3)
    c = chaos_ops(ops, cfg)
    assert c.apply_a is ops.apply_a and c.prec is ops.prec
    assert c.dot_block_start is ops.dot_block_start
    d = torch.as_tensor(np.arange(1.0, 6.0))
    assert torch.equal(c.wait(d), perturb_payload(d, cfg))
    assert not torch.equal(c.wait(d), d)
    off = chaos_ops(ops, dataclasses.replace(cfg, payload_rel_amp=0.0))
    assert off.wait(d) is d


def test_process_faults_refused():
    """The process-level half of ChaosConfig is no longer refused: its
    fault plan is the ``chaos.faults.FaultPlan`` of its fields
    (tests/test_torch_faults.py holds it against the JAX package's)."""
    from repro_torch.chaos import FaultPlan

    plan = ChaosConfig(seed=4, kill_rank=1, kill_rank_at_iter=3,
                       stall_rank=0, stall_rank_at_iter=2,
                       stall_rank_for_s=0.5).fault_plan()
    assert plan == FaultPlan(kill_rank=1, kill_at_iter=3, stall_rank=0,
                             stall_at_iter=2, stall_for_s=0.5, seed=4)


@pytest.mark.parametrize("kw", [dict(governor=GovernorConfig()),
                                dict(telemetry_cap=64)])
def test_multiprocess_backend_refuses_governor_and_telemetry(kw, monkeypatch):
    """Over ranks the ring and the governor are no longer refused: the
    backend hands them to ``distributed_solve`` unchanged (whose rings and
    governor vectors are replicated: tests/test_torch_batched_ranks.py).
    A checkpointed solve, with or without them, is no longer refused: it
    goes to ``distributed_checkpointed_solve`` with its config and them
    (tests/test_torch_checkpoint_ranks.py runs it); ``every=0`` is the
    plain solve.  The backend object is made without joining a process
    group."""
    from repro_torch.checkpoint import CheckpointConfig
    from repro_torch.parallel import distributed

    be = MultiprocessBackend.__new__(MultiprocessBackend)
    be.device, be.wire, be.reduction_cfg = torch.device("cpu"), None, None
    top = convert.operator("stencil2d5", nx=8, ny=8, device="cpu")
    seen, ckpt_seen = {}, {}
    monkeypatch.setattr(distributed, "distributed_solve",
                        lambda wire, op, b, **k: seen.update(k))
    monkeypatch.setattr(distributed, "distributed_checkpointed_solve",
                        lambda wire, op, b, **k: ckpt_seen.update(k))
    be.solve(top, np.ones(top.n), method="plcg", l=2, **kw)
    assert all(seen[k] is v for k, v in kw.items())
    seen.clear()
    be.solve(top, np.ones(top.n), method="plcg", l=2,
             checkpoint=CheckpointConfig(every=0), **kw)
    assert all(seen[k] is v for k, v in kw.items()) and not ckpt_seen
    cfg = CheckpointConfig(every=4, directory="unused")
    be.solve(top, np.ones(top.n), method="plcg", l=2, checkpoint=cfg, **kw)
    assert ckpt_seen["checkpoint"] is cfg
    assert all(ckpt_seen[k] is v for k, v in kw.items())
