#!/usr/bin/env python
"""Square-root breakdowns of p(l)-CG on the 2D Laplacian (KSP ex2), with
Jacobi and shifts for the preconditioned operator: how many restarts and
solution updates a solve to tol 1e-6 takes, per grid size and depth.

    # the PyTorch port on the card (fused superkernel path):
    PYTHONPATH=src python scripts/plcg_breakdowns.py --n 2048 --l 1 2 \\
        --recurrence ghysels stable
    # the JAX package and the port side by side on the CPU:
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/plcg_breakdowns.py \\
        --jax --n 512 --l 2

Each line reports the run's updates, restarts, convergence, true relative
residual and wall seconds.  The right-hand side is
``default_rng(0).standard_normal``, as in ``examples/solve_poisson_4m.py``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def port_run(n: int, l: int, device: str, max_restarts: int,
             shifts=None, recurrence: str = "ghysels") -> dict:
    import torch

    from repro_torch.core.chebyshev import shifts_for_operator
    from repro_torch.linalg import JacobiPrec, Stencil2D5
    from repro_torch.parallel.backends import LocalBackend

    op = Stencil2D5(n, n, device=device)
    prec = JacobiPrec.from_operator(op)
    b = torch.tensor(np.random.default_rng(0).standard_normal(op.n),
                     device=device)
    sig = shifts_for_operator(op, l, prec=prec) if shifts is None else shifts
    t0 = time.perf_counter()
    res = LocalBackend(device=device).solve(
        op, b, prec=prec, l=l, tol=1e-6, maxit=20000, sigmas=sig,
        max_restarts=max_restarts, fused_iteration=True, unroll=16,
        recurrence=recurrence)
    rel = float(torch.linalg.norm(b - op.apply(res.x)) / torch.linalg.norm(b))
    return {"package": "repro_torch", "device": device, "n": n, "l": l,
            "recurrence": recurrence,
            "max_restarts": max_restarts, "updates": int(res.iters),
            "restarts": int(res.restarts),
            "converged": bool(res.converged), "true_rel": rel,
            "wall_s": time.perf_counter() - t0}


def jax_run(n: int, l: int, max_restarts: int) -> tuple[dict, np.ndarray]:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from repro.core import pipelined_cg
    from repro.core.chebyshev import shifts_for_operator
    from repro.core.types import SolverOps
    from repro.linalg.operators import Stencil2D5
    from repro.linalg.preconditioners import JacobiPrec

    op = Stencil2D5(n, n)
    prec = JacobiPrec.from_operator(op)
    b = jnp.asarray(np.random.default_rng(0).standard_normal(op.n))
    sig = shifts_for_operator(op, l, prec=prec)
    ops = SolverOps.local(op, prec)
    t0 = time.perf_counter()
    res = jax.jit(lambda bb: pipelined_cg.solve(
        ops, bb, l, sigmas=sig, tol=1e-6, maxit=20000,
        max_restarts=max_restarts))(b)
    x = np.asarray(res.x)
    bn = np.asarray(b)
    rel = float(np.linalg.norm(bn - np.asarray(op.apply(jnp.asarray(x))))
                / np.linalg.norm(bn))
    return ({"package": "repro", "device": "cpu", "n": n, "l": l,
             "max_restarts": max_restarts, "updates": int(res.iters),
             "restarts": int(res.restarts),
             "converged": bool(res.converged), "true_rel": rel,
             "wall_s": time.perf_counter() - t0}, np.asarray(sig))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[2048])
    ap.add_argument("--l", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--max-restarts", type=int, default=100)
    ap.add_argument("--recurrence", nargs="+", default=["ghysels"],
                    choices=["ghysels", "stable"],
                    help="card runs only; the CPU comparison uses ghysels")
    ap.add_argument("--jax", action="store_true",
                    help="run the JAX package and the port on the CPU, "
                         "from the same shifts")
    args = ap.parse_args()
    for n in args.n:
        for l in args.l:
            if args.jax:
                row, sig = jax_run(n, l, args.max_restarts)
                print(row, flush=True)
                print(port_run(n, l, "cpu", args.max_restarts, sig),
                      flush=True)
            else:
                for rec in args.recurrence:
                    print(port_run(n, l, "cuda", args.max_restarts,
                                   recurrence=rec), flush=True)


if __name__ == "__main__":
    main()
