#!/usr/bin/env python3
"""Time the fused-iteration superkernel of one checkout of the port on one
NVIDIA card, so that two versions of ``csrc/fused_iter.cuh`` can be set
side by side in one machine's run.

At ``laplace2d`` 2048^2 (fp64, Jacobi, a late iteration of the cycle) it
times the compile-time kernel at l = 2 and the runtime-depth kernel at
l = 9 (``--depths``).  With ``--ell`` it adds the ELL kernels at the ice
sheet (``icesheet3d.config()``, 500 000 rows, W = 11): the superkernel's
ELL plug-in at l = 2 for one column and slabs of 2, 4, 8 and 32 (each
column at its own cycle index), at l = 9 (the runtime-depth kernel), the
same plug-in on a quarter of the sheet (125 000 rows, a shard's row count,
for one column and a slab of 8), its halo plug-in on shard 1 of 4 for one
column (``ell_halo_l2``) and in the slab form at s = 1, 2, 4 and 8
(``ell_halo_l2_s{s}``, as ``chip_smoke.halo_slab_checks`` builds it), and
``ell_spmv`` for one vector and a slab of 8.  Each is checked first (rows
bitwise against the plain version; a slab's columns, partials included,
bitwise against single-column launches), then timed by CUDA events and
``torch.profiler`` device time over 20 calls, in turns
(``chip_smoke.in_turns``), beside its bound (bytes over 3.35 TB/s,
``fused_iter.min_bytes``: a slab's columns, the preconditioner and the
operator data once; ``ell_spmv`` has none here), and its device time split
by kernel (the superkernel, its partials sum, ``ell_spmv``, the rest: a
halo plug-in's ring-top copy and operand).
With ``--solve`` it then runs ``chip_smoke.py``'s main solve
(``laplace2d.config()``, p(2)-CG, Jacobi, fused, ``unroll=16``, tol
1e-6) and reports its updates, restarts, vector phases, wall seconds, ms
per vector phase and host syncs per vector phase: the host-side cost of
the iteration, which the kernel timing does not see.  With ``--rung`` it
runs the depth ladder's first rung as ``chip_smoke.py``'s phase 17
profiles it (a governed stable l = 16 solve of ``laplace2d`` 2048^2
under 30 % payload noise, cut to 16 updates and one restart) and reports
the runtime-depth kernel's device ms a launch, the wall ms a launch (one
a vector phase) and the device's busy share.  ``--src`` names the
``src`` directory whose ``repro_torch`` is timed (default: this
checkout's); its kernels are built there.  Prints the card's name and
power limit, then one JSON line.

    python3 scripts/superkernel_ab.py [--src DIR] [--tag T] [--depths 2,9]
                                      [--ell] [--solve] [--rung]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELL_SLABS = (1, 2, 4, 8, 32)   # the whole ice sheet's ELL slab widths
HALO_SLABS = (1, 2, 4, 8)      # the ELL halo plug-in's, on one shard of 4
QUARTER_SLABS = (1, 8)         # a quarter sheet's (a shard's row count)
# the kernels whose device time a case is split into (the rest: "other")
KERNEL_NAMES = ("fused_iter_kernel", "sum_partials", "ell_spmv")
SPLIT_REPS = 20


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--depths", default="2,9",
                    help="comma-separated l (a checkout from before the "
                         "runtime-depth kernel takes only l <= 8)")
    ap.add_argument("--ell", action="store_true",
                    help="also time the ELL kernels at the ice sheet")
    ap.add_argument("--solve", action="store_true",
                    help="also time chip_smoke.py's main solve")
    ap.add_argument("--rung", action="store_true",
                    help="also profile the depth ladder's l = 16 rung")
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    from chip_smoke import PEAK_BYTES_PER_S, device_split, gpu_line, in_turns
    from repro_torch.kernels import fused_iter as fi, ops as kops, ref
    from repro_torch.linalg import JacobiPrec, Stencil2D5

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    op = Stencil2D5(2048, 2048)
    prec = JacobiPrec.from_operator(op)
    fns, rows_bitwise, nbytes = {}, {}, {}
    for l in [int(v) for v in args.depths.split(",")]:
        layout = fi.SlabLayout(l=l, RB=l + 1)
        fiter = kops.fused_iteration_factory(op, prec)(layout)
        IS = fi.scal_layout(l)
        scal = torch.randn(IS["size"], generator=gen, dtype=torch.float64,
                           device=dev)
        scal[IS["dlt_safe"]] = 1.25
        scal[IS["eta_new_safe"]] = 0.75
        scal[IS["eta0_safe"]] = 1.5
        host = fi.host_idx(layout, 2 * l + 3)
        idx = torch.tensor(host, dtype=torch.int32, device=dev)
        nbytes[f"l{l}"] = fi.min_bytes(layout, host, op.n, has_prec=True,
                                       has_diag=False)
        S = torch.randn(layout.nv, op.n, generator=gen, dtype=torch.float64,
                        device=dev) * 1e-3
        S_p, _, _ = ref.fused_iter_unfused(S, idx, scal, op.apply,
                                           prec.apply, layout)
        S_k, _ = fiter(S.clone(), idx, scal)
        rows_bitwise[f"l{l}"] = bool(torch.equal(S_k, S_p))
        del S_p, S_k
        fns[f"l{l}"] = (lambda f=fiter, S=S, i=idx, s=scal: f(S, i, s))
    if args.ell:
        ell_cases(dev, gen, fns, rows_bitwise, nbytes)
    times = in_turns(fns)
    for k, f in fns.items():
        split = device_split(lambda f=f: [f() for _ in range(SPLIT_REPS)],
                             KERNEL_NAMES)
        times[k]["device_us_by_kernel"] = {
            n: us / SPLIT_REPS for n, us in split["device_us"].items()}
    solve = main_solve(dev) if args.solve else None
    rung = ladder_rung(dev) if args.rung else None
    print(gpu_line())
    print(json.dumps({"tag": args.tag, "src": args.src,
                      "rows_bitwise": rows_bitwise, "times": times,
                      "bound_ms": {k: 1e3 * nbytes[k] / PEAK_BYTES_PER_S
                                   if k in nbytes else None for k in fns},
                      "main_solve": solve, "ladder_rung": rung}))
    return 0 if all(rows_bitwise.values()) else 1


def ell_cases(dev, gen, fns: dict, rows_bitwise: dict, nbytes: dict) -> None:
    """The ELL kernels at ``icesheet3d`` (see the module's docstring),
    checked, into ``fns``, ``rows_bitwise`` and (the superkernel's bytes
    bound) ``nbytes``."""
    import torch

    from chip_smoke import N_SHARDS
    from repro_torch.configs import icesheet3d
    from repro_torch.configs.problems import build_operator
    from repro_torch.kernels import ell_spmv, fused_iter as fi, ops as kops
    from repro_torch.kernels import ref
    from repro_torch.linalg import JacobiPrec
    from repro_torch.linalg.partition import halo_exchange, partition_spd
    from repro_torch.parallel.distributed import fused_spmv_local

    op = build_operator(icesheet3d.config())
    prec = JacobiPrec.from_operator(op)
    # the same sheet at a quarter of its nodes: a shard's row count on the
    # single-device plug-in (no halo, no prepared operand)
    quarter = build_operator(dataclasses.replace(icesheet3d.config(), nx=50,
                                                 ny=50))

    def phase(l, s, n):
        layout = fi.SlabLayout(l=l, RB=l + 1)
        IS = fi.scal_layout(l)
        hosts = [fi.host_idx(layout, 2 * l + 3 + c) for c in range(s)]
        scal = torch.randn(s, IS["size"], generator=gen, dtype=torch.float64,
                           device=dev)
        scal[:, IS["dlt_safe"]] = 1.25
        scal[:, IS["eta_new_safe"]] = 0.75
        scal[:, IS["eta0_safe"]] = 1.5
        idx = torch.tensor(hosts, dtype=torch.int32, device=dev)
        S = torch.randn(s, layout.nv, n, generator=gen,
                        dtype=torch.float64, device=dev) * 1e-3
        return layout, S, idx, scal, hosts

    cases = [("ell", op, 2, s) for s in ELL_SLABS] + [("ell", op, 9, 1)] + \
        [("ell_quarter", quarter, 2, s) for s in QUARTER_SLABS]
    for name, a_op, l, s in cases:
        layout, S, idx, scal, hosts = phase(l, s, a_op.n)
        fiter = kops.fused_iteration_factory(
            a_op, JacobiPrec.from_operator(a_op))(layout)
        S_p, _ = fiter.plain(S, idx, scal)
        S_k, d_k = fiter(S.clone(), idx, scal)
        same = bool(torch.equal(S_k, S_p))
        for c in range(s if s > 1 else 0):
            S_1, d_1 = fiter(S[c].clone(), idx[c], scal[c])
            same = same and bool(torch.equal(S_1, S_k[c])
                                 and torch.equal(d_1, d_k[c]))
        key = f"{name}_l{l}_s{s}"
        rows_bitwise[key] = same
        nbytes[key] = sum(fi.min_bytes(layout, h, a_op.n, has_prec=False,
                                       has_diag=False) for h in hosts) \
            + 8 * a_op.n + fiter.spmv.operand_bytes
        del S_p, S_k
        if s == 1:
            S, idx, scal = S[0], idx[0], scal[0]
        fns[key] = (lambda f=fiter, S=S, i=idx, c=scal: f(S, i, c))
        del S, idx, scal
        torch.cuda.empty_cache()

    # the halo plug-in on shard 1 of 4, fed the in-process halo
    plan = partition_spd(op, N_SHARDS)
    layout, S, idx, scal, hosts = phase(2, 1, op.n)
    S, idx, scal = S[0], idx[0], scal[0]
    nl = op.n // N_SHARDS
    pos = fi.idx_layout(2)["z_top"]
    zt = S.index_select(0, idx[pos:pos + 1])[0].reshape(N_SHARDS, nl)
    ext = halo_exchange(zt, plan.send_up, plan.send_dn)
    loc = {f: getattr(plan, f)[1]
           for f in ("cols", "vals", "send_up", "send_dn")}
    inv = prec.inv_diag[nl:2 * nl].contiguous()
    halo = fi.build_fused_iteration(
        layout, fused_spmv_local(op, loc, N_SHARDS, lambda z: ext[1]), inv)
    S_s = S[:, nl:2 * nl].contiguous()
    S_p, _, _ = ref.fused_iter_unfused(S_s, idx, scal, halo.spmv.expr,
                                       lambda v: inv * v, layout)
    rows_bitwise["ell_halo_l2"] = bool(torch.equal(
        halo(S_s.clone(), idx, scal)[0], S_p))
    nbytes["ell_halo_l2"] = fi.min_bytes(
        layout, hosts[0], nl, has_prec=True, has_diag=False,
        operand_bytes=halo.spmv.operand_bytes)
    fns["ell_halo_l2"] = (lambda: halo(S_s, idx, scal))
    for s in HALO_SLABS:
        halo_slab_case(s, op, prec, plan, loc, gen, dev, fns, rows_bitwise,
                       nbytes)

    for s in (1, 8):
        X = torch.randn(s, op.n, generator=gen, dtype=torch.float64,
                        device=dev)
        if s == 1:
            X = X[0]
        rows_bitwise[f"ell_spmv_s{s}"] = bool(torch.equal(
            ell_spmv.ell_spmv(X, op.cols, op.vals),
            ell_spmv.ell_spmv_plain(X, op.cols, op.vals)))
        fns[f"ell_spmv_s{s}"] = (
            lambda X=X: ell_spmv.ell_spmv(X, op.cols, op.vals))


def halo_slab_case(s, op, prec, plan, loc, gen, dev, fns, rows_bitwise,
                   nbytes) -> None:
    """The ELL halo plug-in's slab form on shard 1 of N_SHARDS (key
    ``ell_halo_l2_s{s}``), as ``chip_smoke.halo_slab_checks`` builds it:
    l = 2, Jacobi, columns at cycle indices 2l + 3, 2l + 4, ... and the
    last (of s > 1) at 1, every column's operand from the in-process halo
    of the whole slab's ring-top rows.  Checked before timing: rows
    bitwise against the plain version, each column's rows and partials
    bitwise against its single-column launch.  Bound: ``min_bytes`` of
    every column (its rows and halo), the inverse diagonal and the
    shard's cols and vals once."""
    import torch

    from chip_smoke import N_SHARDS
    from repro_torch.kernels import fused_iter as fi
    from repro_torch.linalg.partition import halo_exchange
    from repro_torch.parallel.distributed import fused_spmv_local

    layout = fi.SlabLayout(l=2, RB=3)
    IS = fi.scal_layout(2)
    p, nl = N_SHARDS, op.n // N_SHARDS
    hosts = [fi.host_idx(layout, 2 * layout.l + 3 + c)
             for c in range(s - 1)] + \
        [fi.host_idx(layout, 1 if s > 1 else 2 * layout.l + 3)]
    idx = torch.tensor(hosts, dtype=torch.int32, device=dev)
    scal = torch.randn(s, IS["size"], generator=gen, dtype=torch.float64,
                       device=dev)
    scal[:, IS["dlt_safe"]] = 1.25
    scal[:, IS["eta_new_safe"]] = 0.75
    scal[:, IS["eta0_safe"]] = 1.5
    S = torch.randn(s, layout.nv, op.n, generator=gen, dtype=torch.float64,
                    device=dev) * 1e-3
    zt = fi.ring_top(S, idx, fi.idx_layout(2)["z_top"]).reshape(s, p, nl)
    e_r = halo_exchange(zt, plan.send_up, plan.send_dn)[:, 1].contiguous()
    inv = prec.inv_diag[nl:2 * nl].contiguous()
    f = fi.build_fused_iteration(
        layout, fused_spmv_local(op, loc, p, lambda z: e_r), inv)
    S_r = S[..., nl:2 * nl].contiguous()
    del S, zt
    S_p, _ = f.plain(S_r.clone(), idx, scal)
    S_k, d_k = f(S_r.clone(), idx, scal)
    same = bool(torch.equal(S_k, S_p))
    for c in range(s):
        one = fi.build_fused_iteration(layout, fused_spmv_local(
            op, loc, p, lambda z, e=e_r[c]: e), inv)
        S_1, d_1 = one(S_r[c].clone(), idx[c], scal[c])
        same = same and bool(torch.equal(S_1, S_k[c])
                             and torch.equal(d_1, d_k[c]))
    key = f"ell_halo_l2_s{s}"
    rows_bitwise[key] = same
    halo = f.spmv.ext_len - nl
    nbytes[key] = sum(fi.min_bytes(layout, h, nl, has_prec=False,
                                   has_diag=False, operand_bytes=8 * halo)
                      for h in hosts) + 8 * nl + \
        f.spmv.cols.numel() * 4 + f.spmv.vals.numel() * 8
    fns[key] = (lambda: f(S_r, idx, scal))


def main_solve(dev) -> dict:
    """``chip_smoke.py``'s phase 3 solve, timed the same way."""
    import time

    import numpy as np
    import torch

    from chip_smoke import TOL
    from repro_torch.configs import laplace2d
    from repro_torch.configs.problems import build_operator
    from repro_torch.core.chebyshev import shifts_for_operator
    from repro_torch.kernels import _build
    from repro_torch.linalg import JacobiPrec
    from repro_torch.parallel.backends import LocalBackend

    lap = laplace2d.config()
    op = build_operator(lap)
    prec = JacobiPrec.from_operator(op)
    b = torch.tensor(np.random.default_rng(0).standard_normal(op.n),
                     device=dev)
    kw = dict(l=lap.l, tol=TOL, maxit=20000, max_restarts=50,
              sigmas=shifts_for_operator(op, lap.l, prec=prec),
              fused_iteration=True, unroll=16)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = LocalBackend().solve(op, b, prec=prec, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    phases = _build.LAUNCHES.get("fused_iter", 0)
    return {"converged": bool(res.converged), "iters": int(res.iters),
            "restarts": int(res.restarts), "vector_phases": phases,
            "wall_s": wall, "ms_per_iter": 1e3 * wall / max(phases, 1),
            "host_syncs_per_iter": res.host_syncs / max(phases, 1)}


def ladder_rung(dev) -> dict:
    """``chip_smoke.py``'s profiled first rung of the depth ladder, run once
    to warm up and once under the profiler."""
    import numpy as np
    import torch

    from chip_smoke import (CHAOS_CATASTROPHIC, LADDER_L, TOL, device_split,
                            per_iter)
    from repro_torch.chaos import ChaosConfig, chaos_ops
    from repro_torch.configs import laplace2d
    from repro_torch.configs.problems import build_operator
    from repro_torch.core import pipelined_cg
    from repro_torch.kernels import _build
    from repro_torch.linalg import JacobiPrec
    from repro_torch.parallel.backends import LocalBackend
    from repro_torch.stability import GovernorConfig

    op = build_operator(laplace2d.config())
    prec = JacobiPrec.from_operator(op)
    b = torch.tensor(np.random.default_rng(0).standard_normal(op.n),
                     device=dev)
    be = LocalBackend(device=dev)
    noise = ChaosConfig(**CHAOS_CATASTROPHIC)

    def rung():
        return be.run(lambda ops, bb: pipelined_cg.solve(
            chaos_ops(ops, noise), bb, l=LADDER_L, recurrence="stable",
            governor=GovernorConfig(), tol=TOL, maxit=16, max_restarts=1,
            fused_iteration=True, unroll=16), op, b, prec=prec)

    rung()
    _build.reset_launches()
    split = device_split(rung, ("fused_iter_kernel_rt",))
    n = _build.LAUNCHES.get("fused_iter_runtime_l", 0)
    it = per_iter(split, n)
    return {"rt_launches": n,
            "rt_device_ms_per_launch":
                it["device_us_per_iter"]["fused_iter_kernel_rt"] * 1e-3,
            "wall_ms_per_launch": it["wall_ms_per_iter"],
            "device_kernels_per_launch": it["device_kernels_per_iter"],
            "device_busy_share": it["device_busy_share"]}


if __name__ == "__main__":
    sys.exit(main())
