"""Event-driven schedule simulator — paper Fig. 4 + §4.2 'staggering'
(the port's copy of ``benchmarks/schedule_sim.py``, kept inside the
package so that the autotuner needs no ``sys.path`` edit; the arithmetic
and the random draws are the same, bit for bit).

Simulates the per-iteration kernel schedule of CG / p-CG / p(l)-CG:

  CG     : SPMV ; GLRED(block) ; AXPY ; GLRED(block)
  p-CG   : one fused GLRED overlapping the SAME iteration's SPMV+PREC
  p(l)-CG: GLRED initiated at end of iter i (after K5), first READ at the
           start of iter i+l (K2); body work = SPMV + (2l+2) AXPYs + SCALAR.
           Up to l reductions are IN FLIGHT simultaneously (staggering).

Optional log-normal jitter on each reduction models OS/network noise; the
paper's observation that l >= 2 'absorbs' glred run-time variance is
reproduced quantitatively (mean iteration time vs jitter).
"""

from __future__ import annotations

import numpy as np


def simulate_cg(n_iters, t_spmv, t_axpy1, t_glred, jitter=0.0, rng=None):
    rng = rng or np.random.default_rng(0)
    dur = _glred_samples(n_iters * 2, t_glred, jitter, rng)
    # 2 blocking reductions + spmv + ~3 axpy/dot passes
    t = 0.0
    for i in range(n_iters):
        t += t_spmv + 3 * t_axpy1 + dur[2 * i] + dur[2 * i + 1]
    return t


def simulate_pcg(n_iters, t_spmv, t_axpy1, t_glred, jitter=0.0, rng=None):
    rng = rng or np.random.default_rng(0)
    dur = _glred_samples(n_iters, t_glred, jitter, rng)
    # fused reduction overlaps the iteration's own SPMV; 8 AXPY updates
    t = 0.0
    for i in range(n_iters):
        t += max(dur[i], t_spmv) + 8 * t_axpy1
    return t


def simulate_plcg(n_iters, l, t_spmv, t_axpy1, t_glred, jitter=0.0, rng=None,
                  body_l=None):
    """Event-driven Alg. 2 schedule: the K1 SPMV runs FIRST, then
    MPI_Wait(req(i-l)) before K2, then the AXPY/SCALAR tail; the new
    reduction is issued at the end of the body (K5) and progresses
    asynchronously.

    ``body_l`` sizes the AXPY tail when the *overlap* depth differs from
    the algorithmic depth (the JAX autotuner models XLA's effective
    depth min(l, unroll-1) while the solver still pays the full
    2l+3-pass body); defaults to ``l``."""
    rng = rng or np.random.default_rng(0)
    dur = _glred_samples(n_iters, t_glred, jitter, rng)
    body_l = l if body_l is None else body_l
    t_rest = (2 * body_l + 2 + 1) * t_axpy1          # K2-K6 AXPYs + dots
    glred_done = [-np.inf] * n_iters
    body_end = 0.0
    for i in range(n_iters):
        spmv_end = body_end + t_spmv                 # K1
        start_rest = spmv_end
        if i >= l:
            start_rest = max(start_rest, glred_done[i - l])  # MPI_Wait
        body_end = start_rest + t_rest
        glred_done[i] = body_end + dur[i]            # MPI_Iallreduce(req(i))
    return body_end


def _glred_samples(k, t_glred, jitter, rng):
    if jitter <= 0:
        return np.full(k, t_glred)
    sigma = np.sqrt(np.log(1 + jitter ** 2))
    return t_glred * rng.lognormal(-sigma ** 2 / 2, sigma, size=k)


def reduction_samples(k, t_red, jitter, rng):
    """Mean-preserving log-normal jitter on a reduction duration — the
    SAME noise model every reduction flavour is scored under, so the
    autotuner's monolithic-vs-staged ranking (``launch.autotune``,
    DESIGN.md §14) compares like with like."""
    return _glred_samples(k, t_red, jitter, rng)


def iteration_time(method, l, kernels, n_iters=200, jitter=0.0, seed=0,
                   body_l=None):
    rng = np.random.default_rng(seed)
    k = kernels
    if method == "cg":
        tot = simulate_cg(n_iters, k["spmv"], k["axpy1"], k["glred"], jitter, rng)
    elif method == "pcg":
        tot = simulate_pcg(n_iters, k["spmv"], k["axpy1"], k["glred"], jitter, rng)
    else:
        tot = simulate_plcg(n_iters, l, k["spmv"], k["axpy1"], k["glred"],
                            jitter, rng, body_l=body_l)
    return tot / n_iters
