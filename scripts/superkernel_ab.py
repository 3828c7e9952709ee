#!/usr/bin/env python3
"""Time the fused-iteration superkernel of one checkout of the port on one
NVIDIA card, so that two versions of ``csrc/fused_iter.cuh`` can be set
side by side in one machine's run.

At ``laplace2d`` 2048^2 (fp64, Jacobi, a late iteration of the cycle) it
times the compile-time kernel at l = 2 and the runtime-depth kernel at
l = 9 (``--depths``): CUDA events and ``torch.profiler`` device time over
20 calls, in turns (``chip_smoke.in_turns``), and checks both against the
plain vector phase (rows bitwise) first.  With ``--solve`` it then runs
``chip_smoke.py``'s main solve (``laplace2d.config()``, p(2)-CG, Jacobi,
fused, ``unroll=16``, tol 1e-6) and reports its updates, restarts, vector
phases, wall seconds, ms per vector phase and host syncs per vector
phase: the host-side cost of the iteration, which the kernel timing does
not see.  ``--src`` names the ``src`` directory whose
``repro_torch`` is timed (default: this checkout's); its kernels are built
there.  Prints the card's name and power limit, then one JSON line.

    python3 scripts/superkernel_ab.py [--src DIR] [--tag T] [--depths 2,9]
                                      [--solve]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--depths", default="2,9",
                    help="comma-separated l (a checkout from before the "
                         "runtime-depth kernel takes only l <= 8)")
    ap.add_argument("--solve", action="store_true",
                    help="also time chip_smoke.py's main solve")
    args = ap.parse_args()
    sys.path[:0] = [os.path.abspath(args.src), ROOT]
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    from chip_smoke import gpu_line, in_turns
    from repro_torch.kernels import fused_iter as fi, ops as kops, ref
    from repro_torch.linalg import JacobiPrec, Stencil2D5

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    op = Stencil2D5(2048, 2048)
    prec = JacobiPrec.from_operator(op)
    fns, rows_bitwise = {}, {}
    for l in [int(v) for v in args.depths.split(",")]:
        layout = fi.SlabLayout(l=l, RB=l + 1)
        fiter = kops.fused_iteration_factory(op, prec)(layout)
        IS = fi.scal_layout(l)
        scal = torch.randn(IS["size"], generator=gen, dtype=torch.float64,
                           device=dev)
        scal[IS["dlt_safe"]] = 1.25
        scal[IS["eta_new_safe"]] = 0.75
        scal[IS["eta0_safe"]] = 1.5
        idx = torch.tensor(fi.host_idx(layout, 2 * l + 3), dtype=torch.int32,
                           device=dev)
        S = torch.randn(layout.nv, op.n, generator=gen, dtype=torch.float64,
                        device=dev) * 1e-3
        S_p, _, _ = ref.fused_iter_unfused(S, idx, scal, op.apply,
                                           prec.apply, layout)
        S_k, _ = fiter(S.clone(), idx, scal)
        rows_bitwise[f"l{l}"] = bool(torch.equal(S_k, S_p))
        del S_p, S_k
        fns[f"l{l}"] = (lambda f=fiter, S=S, i=idx, s=scal: f(S, i, s))
    times = in_turns(fns)
    solve = main_solve(dev) if args.solve else None
    print(gpu_line())
    print(json.dumps({"tag": args.tag, "src": args.src,
                      "rows_bitwise": rows_bitwise, "times": times,
                      "main_solve": solve}))
    return 0 if all(rows_bitwise.values()) else 1


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


if __name__ == "__main__":
    sys.exit(main())
