#!/usr/bin/env python3
"""Time the fused-iteration superkernel of one checkout of the port on one
NVIDIA card, so that two versions of ``csrc/fused_iter.cuh`` can be set
side by side in one machine's run.

At ``laplace2d`` 2048^2 (fp64, Jacobi, a late iteration of the cycle) it
times the compile-time kernel at l = 2 and the runtime-depth kernel at
l = 9 (``--depths``): CUDA events and ``torch.profiler`` device time over
20 calls, in turns (``chip_smoke.in_turns``), and checks both against the
plain vector phase (rows bitwise) first.  ``--src`` names the ``src`` directory whose
``repro_torch`` is timed (default: this checkout's); its kernels are built
there.  Prints the card's name and power limit, then one JSON line.

    python3 scripts/superkernel_ab.py [--src DIR] [--tag T] [--depths 2,9]
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
    print(gpu_line())
    print(json.dumps({"tag": args.tag, "src": args.src,
                      "rows_bitwise": rows_bitwise, "times": times}))
    return 0 if all(rows_bitwise.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
