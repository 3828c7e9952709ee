"""The port's autotuner, timing model, schedule simulator, roofline and
collective counts against the JAX package's.

Tolerances: the model functions run the same arithmetic in the same order
as the JAX module's on the same inputs, so they compare bitwise (``==``);
the copied simulator draws the same numpy random numbers and compares
bitwise too.  Where the port differs by design (``effective_depth`` is l
at every ``unroll``; the JAX model's is ``min(l, unroll - 1)``), the
comparison runs at ``unroll >= l + 1`` and the difference below is
asserted.  The rest mirrors tests/test_costs.py:41-279 on the port.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import benchmarks.schedule_sim as jsim  # noqa: E402
import benchmarks.timing_model as jtm  # noqa: E402
from repro.launch import autotune as jat  # noqa: E402
from repro.linalg import operators as jops  # noqa: E402
from repro.utils.roofline import HW_V5E, roofline_terms as jroofline  # noqa: E402
from repro_torch.launch import autotune as at  # noqa: E402
from repro_torch.launch import schedule_sim as sim  # noqa: E402
from repro_torch.launch import timing_model as tm  # noqa: E402
from repro_torch.linalg import (DiagonalOp, JacobiPrec, Stencil2D5,  # noqa: E402
                                Stencil3D7)
from repro_torch.utils import collectives as coll  # noqa: E402
from repro_torch.utils import roofline as rl  # noqa: E402

PROFILES = [("cori", jtm.CORI, tm.CORI), ("v5e", jtm.V5E, tm.V5E)]


# ------------------------------------------------ timing model, simulator --

@pytest.mark.parametrize("name,jhw,hw", PROFILES)
def test_timing_model_copy_equals_benchmarks(name, jhw, hw):
    assert {f: getattr(hw, f) for f in hw.__dataclass_fields__} == \
        {f: getattr(jhw, f) for f in jhw.__dataclass_fields__}
    for n, p in [(1_000_000, 512), (4_194_304, 1), (8_000_000, 8192)]:
        for pts in (5, 7):
            for payload in (8, 56, 65536):
                kw = dict(stencil_pts=pts, glred_payload=payload)
                assert tm.stencil_kernel_times(hw, n, p, **kw) == \
                    jtm.stencil_kernel_times(jhw, n, p, **kw)
        assert tm.diagonal_kernel_times(hw, n, p) == \
            jtm.diagonal_kernel_times(jhw, n, p)
        assert tm.tree_depth(hw, p) == jtm.tree_depth(jhw, p)
        assert tm.ring_hop_time(hw, 40) == jtm.ring_hop_time(jhw, 40)


def test_h100_profile_is_the_datasheet():
    assert tm.H100.mem_bw == 3.35e12 and tm.H100.flop_rate == 34e12
    assert tm.H100.link_bw == 450e9
    assert at.autotune_depth(n=2048 ** 2, p=1).hw_name == tm.H100.name


@pytest.mark.parametrize("method,l", [("cg", 0), ("pcg", 0), ("plcg", 1),
                                      ("plcg", 2), ("plcg", 5)])
@pytest.mark.parametrize("jitter", [0.0, 0.15, 0.6])
def test_schedule_sim_copy_bitwise(method, l, jitter):
    k = {"spmv": 10e-6, "axpy1": 1.5e-6, "glred": 120e-6}
    for seed in (0, 7):
        assert sim.iteration_time(method, l, k, n_iters=300, jitter=jitter,
                                  seed=seed) == \
            jsim.iteration_time(method, l, k, n_iters=300, jitter=jitter,
                                seed=seed)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    assert np.array_equal(sim.reduction_samples(50, 1e-5, jitter, rng_a),
                          jsim.reduction_samples(50, 1e-5, jitter, rng_b))


# ------------------------------------------------------------ model terms --

def test_payload_and_neighbor_terms_equal_jax():
    for method in ("cg", "pcg", "plcg"):
        for l in (0, 1, 3):
            for s in (1, 8):
                assert at.reduction_payload_bytes(method, l, s) == \
                    jat.reduction_payload_bytes(method, l, s)
    pairs = [(Stencil2D5(24, 16, device="cpu"), jops.Stencil2D5(24, 16)),
             (Stencil3D7(8, 6, 4, device="cpu"), jops.Stencil3D7(8, 6, 4)),
             (DiagonalOp(np.arange(1.0, 33.0), device="cpu"),
              jops.DiagonalOp(np.arange(1.0, 33.0)))]
    for top, jop in pairs:
        for p in (1, 4):
            assert at.operator_neighbor_bytes(top, p) == \
                jat.operator_neighbor_bytes(jop, p)
    for n in (4096, 2048 ** 2):
        for l in (1, 2, 8):
            assert at.fused_iteration_bytes(n, l) == \
                jat.fused_iteration_bytes(n, l)


@pytest.mark.parametrize("name,jhw,hw", PROFILES)
def test_staged_terms_and_governed_overhead_equal_jax(name, jhw, hw):
    for p in (2, 8, 512):
        for l in (1, 2, 5):
            for st in (1, 2, 4, 16):
                assert at.staged_reduction_terms(hw, p, l, st, 56) == \
                    jat.staged_reduction_terms(jhw, p, l, st, 56)
    for l in (1, 2, 8):
        for st in (None, 1, 3):
            for period in (64, 256):
                assert at.governed_overhead(l, st, period) == \
                    jat.governed_overhead(l, st, period)


@pytest.mark.parametrize("name,jhw,hw", PROFILES)
@pytest.mark.parametrize("jitter", [0.0, 0.15])
def test_model_iteration_time_equals_jax(name, jhw, hw, jitter):
    """Bitwise where the two agree: every baseline, every staged
    candidate, and p(l)-CG at unroll >= l + 1."""
    for n, p in [(1_000_000, 512), (4_194_304, 1)]:
        for method in ("cg", "pcg"):
            assert at.model_iteration_time(hw, n, p, method,
                                           jitter=jitter) == \
                jat.model_iteration_time(jhw, n, p, method, jitter=jitter)
        for l in (1, 2, 3, 5):
            for kw in ({}, {"s": 8}, {"neighbor_bytes": 80_000},
                       {"iteration_bytes": 5e6},
                       {"reduction": "staged", "stages": 2}):
                for unroll in (l + 1, 16):
                    assert at.model_iteration_time(
                        hw, n, p, "plcg", l, unroll, jitter=jitter,
                        **kw) == jat.model_iteration_time(
                            jhw, n, p, "plcg", l, unroll, jitter=jitter,
                            **kw), (l, unroll, kw)


def test_effective_depth_differs_from_xla_below_l_plus_one():
    """The port keeps l chains in flight at any unroll (the overlap report
    shows it); XLA's loop only min(l, unroll - 1).  So the port's model at
    unroll = 1 is its model at unroll = l + 1, and JAX's is slower there
    (serialised reductions on a latency-bound machine)."""
    for l in (1, 2, 3):
        assert at.effective_depth(l, 1) == l
        assert jat.xla_effective_depth(l, 1) == 0
        t1 = at.model_iteration_time(tm.CORI, 1_000_000, 512, "plcg", l, 1,
                                     jitter=0.0)
        tl = at.model_iteration_time(tm.CORI, 1_000_000, 512, "plcg", l,
                                     l + 1, jitter=0.0)
        assert t1 == tl
        assert jat.model_iteration_time(jtm.CORI, 1_000_000, 512, "plcg", l,
                                        1, jitter=0.0) > t1


@pytest.mark.parametrize("name,jhw,hw", PROFILES)
@pytest.mark.parametrize("reduction", ["monolithic", "both"])
def test_autotune_ranking_equals_jax(name, jhw, hw, reduction):
    kw = dict(n=1_000_000, p=512, ls=(1, 2, 3, 5), unrolls=(8,),
              jitter=0.15, reduction=reduction)
    got = at.autotune_depth(hw=hw, **kw)
    want = jat.autotune_depth(hw=jhw, **kw)
    key = [(c.method, c.l, c.unroll, c.reduction, c.stages, c.model_s)
           for c in got.candidates]
    assert key == [(c.method, c.l, c.unroll, c.reduction, c.stages,
                    c.model_s) for c in want.candidates]
    assert (got.best.method, got.best.l, got.best.unroll, got.best.stages) \
        == (want.best.method, want.best.l, want.best.unroll,
            want.best.stages)
    assert got.table().splitlines()[2:] == want.table().splitlines()[2:]
    # with measurements, the measured time ranks (the same in both)
    def meas(method, l, unroll):
        return 1e-3 / (1 + l) if method == "plcg" else 1e-2
    got = at.autotune_depth(hw=hw, measure=meas, governed=True, **kw)
    want = jat.autotune_depth(hw=jhw, measure=meas, governed=True, **kw)
    assert [c.score for c in got.candidates] == \
        [c.score for c in want.candidates]
    assert got.best == want.best or got.best.score == want.best.score


# ------------------------------------------- tests/test_costs.py, mirrored --

def test_autotune_reduction_payload_term():
    assert at.reduction_payload_bytes("cg", 0, s=1) == 8
    assert at.reduction_payload_bytes("pcg", 0, s=4) == 2 * 4 * 8
    assert at.reduction_payload_bytes("plcg", 3, s=8) == 7 * 8 * 8
    k0 = tm.stencil_kernel_times(tm.CORI, 1_000_000, 512, glred_payload=0)
    kp = tm.stencil_kernel_times(
        tm.CORI, 1_000_000, 512,
        glred_payload=at.reduction_payload_bytes("plcg", 3, s=2048))
    dp = kp["glred"] - k0["glred"]
    assert abs(dp - 7 * 2048 * 8 / tm.CORI.link_bw) < 1e-12
    assert dp > k0["glred"]
    args = (tm.CORI, 1_000_000, 512, "plcg")
    # The JAX test's serialised path (its unroll = 1) is the port's
    # blocking classic CG: the reduction latency amortizes over the slab,
    # so the per-column time falls strictly.  The port's p(2)-CG keeps 2
    # reductions in flight at unroll = 1 too (effective_depth), hidden
    # under the body here: flat per column.
    per_col = [at.model_iteration_time(tm.CORI, 1_000_000, 512, "cg", s=s,
                                       jitter=0.0) / s
               for s in (1, 8, 64, 1024)]
    assert all(a > b for a, b in zip(per_col, per_col[1:]))
    flat = {at.model_iteration_time(*args, l=2, unroll=1, s=s,
                                    jitter=0.0) / s for s in (1, 8, 64)}
    assert len(flat) == 1
    t_slab = [at.model_iteration_time(*args, l=2, unroll=3, s=s, jitter=0.0)
              for s in (1, 8, 64)]
    assert t_slab[0] < t_slab[1] < t_slab[2]
    ls = (1, 2, 3, 5, 8)
    best_narrow = at.autotune_depth(n=1_000_000, p=512, hw=tm.CORI, s=1,
                                    ls=ls, jitter=0.0).best
    best_wide = at.autotune_depth(n=1_000_000, p=512, hw=tm.CORI, s=4096,
                                  ls=ls, jitter=0.0).best
    assert best_narrow.method == "plcg" and best_narrow.l >= 2
    assert best_wide.l < best_narrow.l, (best_narrow, best_wide)


def test_autotune_neighbor_bytes_term():
    def t(l, nb):
        return at.model_iteration_time(tm.CORI, 4_000_000, 512, "plcg", l=l,
                                       unroll=l + 1, jitter=0.0,
                                       neighbor_bytes=nb)

    for l in (1, 2, 3):
        assert t(l, 8_000_000) > t(l, 8_000)
    d2 = t(2, 8_000_000) - t(2, 8_000)
    d3 = t(3, 8_000_000) - t(3, 8_000)
    assert abs(d2 - d3) / d2 < 1e-9


def test_iteration_bytes_calibration():
    n, p = 4_000_000, 512
    n_loc = n / p
    unfused_b = 150 * 8 * n_loc
    fused_b = float(at.fused_iteration_bytes(int(n_loc), 2))
    assert fused_b < unfused_b / 2

    def t(l, ib):
        return at.model_iteration_time(tm.CORI, n, p, "plcg", l=l,
                                       unroll=l + 1, jitter=0.0,
                                       iteration_bytes=ib)

    for l in (1, 2, 3):
        assert t(l, at.fused_iteration_bytes(int(n_loc), l)) < \
            t(l, unfused_b)
    res = at.autotune_depth(n, p, hw=tm.CORI, ls=(1, 2), jitter=0.0,
                            iteration_bytes=lambda l: float(
                                at.fused_iteration_bytes(int(n_loc), l)))
    assert res.best.model_s > 0


def test_staged_reduction_model():
    p, payload = 512, 56
    assert tm.ring_hop_time(tm.CORI, payload) < \
        tm.CORI.alpha + payload / tm.CORI.link_bw + 1e-18
    for l in (2, 3, 5):
        bursts, fills = [], []
        for st in (1, 2, 4, 8, 16, 32):
            t = at.staged_reduction_terms(tm.CORI, p, l, st, payload)
            bursts.append(t["t_advance_burst"])
            fills.append(t["fill_iters"])
        assert all(a >= b for a, b in zip(bursts, bursts[1:])), bursts
        assert all(a < b for a, b in zip(fills, fills[1:])), fills
        for st in range(1, l):
            assert at.staged_reduction_terms(
                tm.CORI, p, l, st, payload)["t_wait_stall"] == 0.0
        assert at.staged_reduction_terms(
            tm.CORI, p, l, l + 3, payload)["t_wait_stall"] > 0.0
    for st in (1, 3, 7, 31):
        t = at.staged_reduction_terms(tm.CORI, p, 3, st, payload)
        assert t["n_hops"] == p - 1
        assert t["group_hops"] == -(-(p - 1) // min(st, p - 1))
    t_deep = at.model_iteration_time(tm.CORI, 4_000_000, p, "plcg", l=8,
                                     jitter=0.0, reduction="staged",
                                     stages=7)
    # the port's monolithic model at unroll 1 is already pipelined (l in
    # flight); the serialised reference of the JAX test is the body plus a
    # blocking reduction, which the staged deep pipeline beats
    k = tm.stencil_kernel_times(tm.CORI, 4_000_000, p,
                                glred_payload=at.reduction_payload_bytes(
                                    "plcg", 8))
    assert t_deep < k["spmv"] + 19 * k["axpy1"] + k["glred"]


def test_schedule_sim_limits():
    k = {"spmv": 10e-6, "axpy1": 0.0, "glred": 600e-6}
    t1 = sim.iteration_time("plcg", 1, k, n_iters=500)
    t3 = sim.iteration_time("plcg", 3, k, n_iters=500)
    assert abs(t1 - 600e-6) / 600e-6 < 0.05
    assert abs(t3 - 200e-6) / 200e-6 < 0.05
    tcg = sim.iteration_time("cg", 0, k, n_iters=500)
    assert abs(tcg - (10e-6 + 1200e-6)) / 1210e-6 < 0.05


def _payloads():
    it = {"device": "cuda", "kernel": "fused_iter", "bytes": 8.0e6,
          "seconds": 1e-5}
    sp = {"device": "cuda", "kernel": "ell_spmv", "nnz": 50_000,
          "seconds": 2e-6}
    rd = {"device": "cuda", "kernel": "sum_partials", "devices": 8,
          "payload_bytes": 40, "hop_s": 3e-6, "allreduce_s": 9e-6}
    return it, sp, rd


def test_recalibrate_profile_math():
    it, sp, rd = _payloads()
    hw = at.recalibrate_profile(tm.H100, it, sp, rd)
    assert hw.name == "nvidia-h100-sxm+measured"
    assert abs(hw.mem_bw - 8.0e6 / 1e-5) < 1.0
    assert abs(hw.flop_rate - 2.0 * 50_000 / 2e-6) < 1.0
    assert abs(tm.ring_hop_time(hw, 40) - 3e-6) < 1e-12
    assert abs(hw.alpha * tm.tree_depth(hw, 8) + 40 / hw.link_bw
               - 9e-6) < 1e-10
    assert hw.link_bw == tm.H100.link_bw
    # the same numbers give the JAX module's profile from its payloads
    jhw = jat.recalibrate_profile(
        jtm.CORI,
        {"kernel_mode": "compiled", "fused_wall_time_comparable": True,
         "fused_bytes_per_iter": 8.0e6, "fused_time_per_iter_s": 1e-5},
        {"kernel_mode": "compiled", "problem": {"nnz": 50_000},
         "kernel_spmv_s": 2e-6},
        {"kernel_mode": "compiled", "mesh_devices": 8,
         "staged_hop_payload_bytes_fp64": 40, "measured_hop_time_s": 3e-6,
         "measured_allreduce_time_s": 9e-6})
    cori = at.recalibrate_profile(tm.CORI, it, sp, rd)
    assert {f: getattr(cori, f) for f in cori.__dataclass_fields__} == \
        {f: getattr(jhw, f) for f in jhw.__dataclass_fields__}
    assert at.recalibrate_profile(tm.H100) is tm.H100


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("bad,match", [
    ({"device": "cpu"}, "not on a card"),
    ({"device": None}, "not on a card"),
    ({"plain": True}, "plain PyTorch twin"),
])
def test_recalibrate_profile_refusals(which, bad, match):
    payloads = list(_payloads())
    payloads[which] = dict(payloads[which], **bad)
    args = [None, None, None]
    args[which] = payloads[which]
    with pytest.raises(ValueError, match=match):
        at.recalibrate_profile(tm.H100, *args)


# --------------------------------------------------- counted bytes, runner --

def _stencil(l=2):
    from repro_torch.core.chebyshev import shifts_for_operator

    op = Stencil2D5(16, 16, device="cpu")
    prec = JacobiPrec.from_operator(op)
    return op, prec, shifts_for_operator(op, l, prec=prec)


def test_measured_iteration_bytes():
    from repro_torch.kernels import fused_iter as fi

    for l in (1, 2, 3):
        op, prec, sig = _stencil(l)
        fused = at.measured_iteration_bytes(op, l, prec, fused=True)
        layout = fi.SlabLayout(l=l, RB=max(l + 1, 3))
        assert fused == fi.min_bytes(layout, fi.host_idx(layout, 3 * l + 3),
                                     op.n, has_prec=True, has_diag=False)
        unfused = at.measured_iteration_bytes(op, l, prec, sigmas=sig)
        # one PyTorch operation a pass moves several times the fused pass
        assert unfused > 3 * fused, (l, unfused, fused)
        assert unfused == at.measured_iteration_bytes(op, l, prec,
                                                      sigmas=sig)
    d = DiagonalOp(np.arange(1.0, 257.0), device="cpu")
    # the diagonal plug-in reads its d vector beside the slab rows
    assert at.measured_iteration_bytes(d, 2, fused=True) == \
        at.measured_iteration_bytes(op, 2, None, fused=True) + 256 * 8


def test_count_cost_counts_operands_and_arithmetic():
    x = torch.ones(100, dtype=torch.float64)
    y = torch.ones(100, dtype=torch.float64)
    out, cost = rl.count_cost(lambda a, b: (a + b)[:50].sum(), x, y)
    assert float(out) == 100.0
    # add: 2 reads + 1 write of 800 B; the slice is a view; the sum reads
    # 400 B and writes 8
    assert cost["bytes accessed"] == 3 * 800 + 400 + 8
    assert cost["flops"] == 100 + 50


def test_measured_runner_and_make_solver():
    from repro_torch.parallel.backends import LocalBackend

    op, prec, sig = _stencil()
    b = torch.tensor(np.random.default_rng(0).standard_normal(op.n))
    be = LocalBackend(device="cpu")
    kw = dict(l=2, tol=1e-8, maxit=300, sigmas=sig, unroll=4)
    r1 = be.make_solver(op, "plcg", prec, **kw)(b)
    r2 = be.solve(op, b, prec=prec, **kw)
    assert torch.equal(r1.x, r2.x) and torch.equal(r1.res_history,
                                                   r2.res_history)
    measure = at.measured_runner(be, op, b, prec=prec, iters=(4, 12),
                                 repeats=1, sigmas_for=lambda l: sig
                                 if l == 2 else None)
    res = at.autotune_depth(n=op.n, p=1, ls=(2,), unrolls=(4,),
                            measure=measure)
    assert all(c.measured_s > 0 for c in res.candidates)
    assert "meas/us" in res.table()


# ----------------------------------------------------- roofline, collectives --

def test_roofline_terms_math_equals_jax():
    cost = {"flops": 197e12, "bytes accessed": 819e9}
    hlo = "%ar = f32[12500000]{0} all-reduce(f32[12500000]{0} %x)\n"
    v5e = rl.Hardware(name=HW_V5E.name, peak_flops=HW_V5E.peak_flops,
                      hbm_bw=HW_V5E.hbm_bw, link_bw=HW_V5E.link_bw,
                      hbm_per_chip=HW_V5E.hbm_per_chip)
    t = rl.roofline_terms(cost, {"all-reduce": {"count": 1,
                                                "bytes": 50_000_000}},
                          chips=256, hw=v5e)
    j = jroofline(cost, hlo, chips=256, hw=HW_V5E)
    assert (t.t_compute, t.t_memory, t.t_collective, t.dominant) == \
        (j.t_compute, j.t_memory, j.t_collective, j.dominant)
    assert t.useful_fraction(197e12 * 256) == j.useful_fraction(197e12 * 256)
    assert t.mfu(1e15) == j.mfu(1e15) and t.t_bound == j.t_bound
    assert abs(t.t_compute - 1.0) < 1e-6
    assert rl.dense_model_flops(10, 3) == 180.0
    assert rl.forward_model_flops(10, 3) == 60.0
    h = rl.roofline_terms({"flops": 17e9, "bytes accessed": 3.35e9})
    assert h.hw is rl.HW_H100 and h.dominant == "memory"
    assert h.t_memory == pytest.approx(1e-3, rel=1e-12)


def test_collectives_from_wire_counts_and_a_profile():
    counts = {"bytes_sent": {"halo": 4096, "hop": 120, "all_reduce": 40},
              "messages": {"halo": 8, "hop": 3, "all_reduce": 1},
              "staging_host_syncs": 0}
    per = coll.count_collectives(counts)
    assert per == {"collective-permute": {"count": 11, "bytes": 4216},
                   "all-reduce": {"count": 1, "bytes": 40}}
    assert coll.collective_bytes(counts) == 4256
    summ = coll.summarize_collectives(counts)
    assert (summ.total_count, summ.total_bytes) == (12, 4256)
    assert "all-reduce" in str(summ)
    trace = {"traceEvents": [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1.0, "dur": 1.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel",
         "name": "ncclDevKernel_AllReduce_Sum_f64_RING_LL", "ts": 5.0,
         "dur": 7.5, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 2.0, "dur": 1.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "ncclKernel_SendRecv_x",
         "ts": 20.0, "dur": 2.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 3.0, "dur": 1.0, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "fused_iter_kernel",
         "ts": 25.0, "dur": 2.0, "args": {"correlation": 3}}]}
    assert coll.profile_collectives(trace) == {
        "all-reduce": {"count": 1, "device_us": 7.5},
        "collective-permute": {"count": 1, "device_us": 2.0}}
