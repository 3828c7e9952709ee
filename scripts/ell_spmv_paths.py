#!/usr/bin/env python3
"""Time the three paths of the port's ELL SpMV kernel against each other
on one NVIDIA card, at the ice sheet's operator (``icesheet3d.config()``,
500 000 rows, W = 11, fp64, RCM-ordered):

* ``bulk``: the launch plan as ``ell_spmv`` makes it, every full tile
  brought into shared memory by 1-D bulk copies;
* ``loads``: the same plan with no bulk tile, so every tile is staged by
  coalesced ordinary loads (the path of a misaligned operator);
* ``direct``: the direct kernel, one thread a row straight from device
  memory (the path of an operator too wide to stage);

and cuSPARSE's CSR product over the same nonzeros as the yardstick.  Each
path is checked bitwise against the plain version first.  Times are CUDA
events over 20 calls and ``torch.profiler`` device time, in turns (see
``chip_smoke.in_turns``).  Prints the card's name and power limit, then
one JSON line.

With ``--slab S`` it times the slab form instead, on an (S, n) slab: every
group width a thread can sum together (1, 2, 4 vectors; 1 is one vector
after the other) with a ring of 1 and of 2 stages, each plan's grid one
wave at its own occupancy, beside cuSPARSE's CSR by an (n, S) block.

    PYTHONPATH=src python3 scripts/ell_spmv_paths.py [--slab S]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--slab", type=int, default=0,
                    help="time the slab form on this many vectors")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    from chip_smoke import PEAK_BYTES_PER_S, gpu_line, in_turns
    from repro_torch.configs import icesheet3d
    from repro_torch.configs.problems import build_operator
    from repro_torch.kernels import _build
    from repro_torch.kernels import ell_spmv as el

    dev = torch.device("cuda")
    op = build_operator(icesheet3d.config())
    cols, vals = op.cols, op.vals
    x = torch.randn(op.n, dtype=vals.dtype, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    lib = _build.load("ell_spmv", el._SIGS)
    if args.slab:
        return slab_sweep(args.slab, op, lib, dev)
    bulk = el._plan_for(lib, cols, vals, 1)
    if not (bulk.staged and bulk.bulk_tiles > 0):
        raise AssertionError(f"the ice sheet's plan stages no bulk tile: "
                             f"{bulk}")
    plans = {"bulk": bulk,
             "loads": dataclasses.replace(bulk, bulk_tiles=0),
             "direct": dataclasses.replace(bulk, staged=False)}
    plain = el.ell_spmv_plain(x, cols, vals)
    same = {k: bool(torch.equal(el._launch(lib, p, x, cols, vals, 1),
                                plain))
            for k, p in plans.items()}
    if not all(same.values()):
        raise AssertionError(f"a path differs from the plain version: {same}")
    keep = vals != 0
    crow = torch.zeros(op.n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(keep.sum(dim=1), 0)
    csr = torch.sparse_csr_tensor(crow, cols[keep].long(), vals[keep],
                                  size=(op.n, op.n))
    t = in_turns({**{k: (lambda p=p: el._launch(lib, p, x, cols, vals, 1))
                     for k, p in plans.items()},
                  "cusparse": lambda: csr @ x})
    nbytes = cols.numel() * 4 + vals.numel() * 8 + 2 * op.n * 8
    print(gpu_line(), flush=True)
    print(json.dumps({"n": op.n, "w": op.w, "plan": dataclasses.asdict(bulk),
                      "bitwise_equal": same,
                      "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
                      "timings": t}), flush=True)
    return 0


def slab_sweep(s: int, op, lib, dev) -> int:
    """Each (group, stages) plan of the slab form, checked then timed."""
    import torch

    from chip_smoke import PEAK_BYTES_PER_S, gpu_line, in_turns
    from repro_torch.kernels import _build
    from repro_torch.kernels import ell_spmv as el

    cols, vals = op.cols, op.vals
    X = torch.randn(s, op.n, dtype=vals.dtype, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    plain = el.ell_spmv_plain(X, cols, vals)
    base = el._plan_for(lib, cols, vals, 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans, same = {}, {}
    for group in (1, 2, 4):
        for stages in (1, 2):
            smem = stages * base.tile_rows * op.w * (vals.element_size() + 4)
            out = ctypes.c_int(0)
            _build.check(lib.ell_spmv_occupancy(0, group, base.tile_rows,
                                                smem, ctypes.byref(out)),
                         "ell_spmv occupancy")
            p = dataclasses.replace(
                base, stages=stages, smem_bytes=smem,
                grid=max(1, min(base.tiles, sms * max(1, out.value))))
            key = f"g{group}_st{stages}"
            plans[key] = (p, group, out.value)
            same[key] = bool(torch.equal(
                el._launch(lib, p, X, cols, vals, group), plain))
    if not all(same.values()):
        raise AssertionError(f"a plan differs from the plain version: {same}")
    keep = vals != 0
    crow = torch.zeros(op.n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(keep.sum(dim=1), 0)
    csr = torch.sparse_csr_tensor(crow, cols[keep].long(), vals[keep],
                                  size=(op.n, op.n))
    Xt = X.T.contiguous()
    t = in_turns({**{k: (lambda p=p, g=g: el._launch(lib, p, X, cols, vals,
                                                       g))
                     for k, (p, g, _) in plans.items()},
                  "cusparse": lambda: torch.sparse.mm(csr, Xt)})
    nbytes = cols.numel() * 4 + vals.numel() * 8 + 2 * X.numel() * 8
    print(gpu_line(), flush=True)
    print(json.dumps({"n": op.n, "w": op.w, "s": s,
                      "chosen_group": el.slab_group(s),
                      "blocks_per_sm": {k: v[2] for k, v in plans.items()},
                      "bitwise_equal": same,
                      "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
                      "timings": t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
