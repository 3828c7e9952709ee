#!/usr/bin/env python3
"""What the NCCL dot block costs one rank on the card.

    python3 scripts/nccl_overlap.py

Joins a world of one rank over NCCL (``MultiprocessBackend``) and prints
JSON lines:

* ``nccl_wait``: with ~50 ms of matrix products queued on the stream, the
  host time to issue ``all_reduce(async_op=True)`` and to ``wait()`` on
  it, and whether the stream was still busy after the wait returned (a
  wait that blocked the host would find it idle): the MPI_Iallreduce /
  MPI_Wait split the p(l)-CG ring relies on;
* ``host_us_per_allreduce_wait``: the host time of one issue and wait on
  an idle card, over 1 000;
* one ``run`` line each for a 300-update p(2)-CG solve of ``laplace2d``
  (2048^2, Jacobi, fused, tol 1e-30) on ``LocalBackend`` and on the world
  of one: ms an update, and the host ops with the most self time per
  update under ``torch.profiler``.

Needs a card; exits non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("nccl_overlap: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import laplace2d
    from repro_torch.configs.problems import build_operator
    from repro_torch.core.chebyshev import shifts_for_operator
    from repro_torch.linalg import JacobiPrec
    from repro_torch.parallel.backends import LocalBackend, get_backend
    from repro_torch.parallel.fabric import free_port

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_port()))
    be = get_backend("multiprocess")
    a = torch.randn(4096, 4096, device="cuda")
    x = torch.ones(5, dtype=torch.float64, device="cuda")
    for _ in range(3):
        dist.all_reduce(x, async_op=True).wait()
    torch.cuda.synchronize()
    trials = []
    for _ in range(3):
        for _ in range(20):
            a = a @ a * 1e-4
        t0 = time.perf_counter()
        work = dist.all_reduce(x, async_op=True)
        t1 = time.perf_counter()
        work.wait()
        t2 = time.perf_counter()
        busy = not torch.cuda.current_stream().query()
        torch.cuda.synchronize()
        trials.append({"issue_ms": 1e3 * (t1 - t0),
                       "wait_ms": 1e3 * (t2 - t1),
                       "stream_busy_after_wait": busy,
                       "drain_ms": 1e3 * (time.perf_counter() - t2)})
    print(json.dumps({"nccl_wait": trials}), flush=True)
    t0 = time.perf_counter()
    for _ in range(1000):
        dist.all_reduce(x, async_op=True).wait()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    print(json.dumps({"host_us_per_allreduce_wait": 1e3 * (t1 - t0)}),
          flush=True)

    op = build_operator(laplace2d.config())
    prec = JacobiPrec.from_operator(op)
    b = torch.tensor(np.random.default_rng(0).standard_normal(op.n),
                     device="cuda")
    kw = dict(l=2, tol=1e-30, maxit=300, max_restarts=50,
              sigmas=shifts_for_operator(op, 2, prec=prec),
              fused_iteration=True, unroll=16)
    for name, solve in (("local", LocalBackend().solve),
                        ("world1_nccl", be.solve)):
        solve(op, b, prec=prec, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(op, b, prec=prec, **kw)
        torch.cuda.synchronize()
        n = int(res.iters)
        ms = 1e3 * (time.perf_counter() - t0) / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            solve(op, b, prec=prec, **kw)
            torch.cuda.synchronize()
        top = sorted(prof.key_averages(),
                     key=lambda e: -e.self_cpu_time_total)[:12]
        print(json.dumps({
            "run": name, "updates": n, "ms_per_update": ms,
            "self_cpu_us_per_update": {e.key[:60]: e.self_cpu_time_total / n
                                       for e in top},
            "calls_per_update": {e.key[:60]: e.count / n for e in top}}),
            flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
