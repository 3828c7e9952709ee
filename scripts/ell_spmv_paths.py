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

    PYTHONPATH=src python3 scripts/ell_spmv_paths.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    import torch

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
    bulk = el._plan_for(lib, cols, vals)
    if not (bulk.staged and bulk.bulk_tiles > 0):
        raise AssertionError(f"the ice sheet's plan stages no bulk tile: "
                             f"{bulk}")
    plans = {"bulk": bulk,
             "loads": dataclasses.replace(bulk, bulk_tiles=0),
             "direct": dataclasses.replace(bulk, staged=False)}
    plain = el.ell_spmv_plain(x, cols, vals)
    same = {k: bool(torch.equal(el._launch(lib, p, x, cols, vals), plain))
            for k, p in plans.items()}
    if not all(same.values()):
        raise AssertionError(f"a path differs from the plain version: {same}")
    keep = vals != 0
    crow = torch.zeros(op.n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(keep.sum(dim=1), 0)
    csr = torch.sparse_csr_tensor(crow, cols[keep].long(), vals[keep],
                                  size=(op.n, op.n))
    t = in_turns({**{k: (lambda p=p: el._launch(lib, p, x, cols, vals))
                     for k, p in plans.items()},
                  "cusparse": lambda: csr @ x})
    nbytes = cols.numel() * 4 + vals.numel() * 8 + 2 * op.n * 8
    print(gpu_line(), flush=True)
    print(json.dumps({"n": op.n, "w": op.w, "plan": dataclasses.asdict(bulk),
                      "bitwise_equal": same,
                      "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
                      "timings": t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
