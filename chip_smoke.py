#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line; every phase raises on failure:

1. build: compile every CUDA kernel from ``src/repro_torch/kernels/csrc``;
2. kernels vs plain: each kernel against its plain PyTorch version at the
   main path's shapes (rows bitwise; dot partials within the stated bound),
   the superkernel at l in {1, 2, 3} and, on the main stencil, at the two
   deepest pipelines it is built for (l = 7, 8);
3. main solve: ``LocalBackend().solve`` on ``laplace2d.config()`` (2048^2,
   fp64) with p(2)-CG, Jacobi and the fused superkernel, to tol 1e-6
   (maxit and max_restarts raised from the config's, see below);
4. fused vs plain: the same problem for 200 iterations through the
   superkernel and through the plain vector phase;
5. standalone stencils: unfused Jacobi solves through ``stencil2d5`` and
   ``stencil3d7`` (``use_kernel=True``) against the plain operators;
6. small reference: the card's fused solve of the smoke-size problem
   against the port's CPU path;
7. the unstructured ice sheet (``icesheet3d.config()``, 500 000 FEM
   nodes, ELL, RCM-ordered): ``ell_spmv`` bitwise against its plain
   version at its shape, with x longer than R, with misaligned bases
   (staging by ordinary loads), and on random operators that reach every
   other path (ragged tiles, odd and even W, the direct kernel for a W too
   wide to stage); the superkernel's ELL
   plug-in against its plain version (l in {1, 2, 3, 7, 8}); the fused
   p(2)-CG solve with Jacobi (block-Jacobi, the config's, has no fused
   path: phase 14), fused vs plain vector phase, an unfused solve through the
   ELL kernel against the plain operator, and the smoke-size ice sheet
   on the card against the port's CPU path;
8. timings per kernel (CUDA events), their bounds and yardsticks, and a
   profiler split of one solve iteration; ``ell_spmv`` and its cuSPARSE
   yardstick also by device time (``torch.profiler``), in turns;
9. the kernel entry points of ``repro_torch.kernels.ops``: ``fused_dots``
   and ``fused_dots_mrhs`` at the ``laplace2d`` slab's width (K = 5,
   N = 2048^2, S in {1, 8}, fp64 and fp32) within an fp32 accumulation
   bound of their plain version, the same bits on a second call, and at
   tail shapes (K in {1, 17}, N not a multiple of the vector width,
   misaligned bases); ``fused_axpy3`` (N = 2048^2, fp32)
   bitwise equal to its plain version; ``decode_attention`` and
   ``decode_attention_stats`` at Qwen3-1.7B's attention (H = 16, Hkv = 8,
   D = 128, fp32) and the two decode shapes (``decode_32k``: B = 16,
   S = 32 768, kv_len 32 768 and 30 001; ``long_500k``: B = 1,
   S = 524 288) within 2e-4 of their plain version, and the 32k cache split
   into 8 shards, merged by ``merge_decode_shards``, against the
   whole-cache decode; then the timings of the three kernels, with
   ``fused_dots`` and its cuBLAS yardstick also by device time, in turns;
10. pipelines deeper than the compile-time kernels (l > 8): the
   runtime-depth superkernel against the plain vector phase at l in {9, 12,
   16} on laplace2d and at l in {9, 12, 16, 27, 32} and the deepest l whose
   shared memory fits on icesheet3d (with the check's peak device memory),
   the next depth refused with both byte counts, a 100-update l = 9
   solve, and times (laplace2d at l = 9, 12, 16; icesheet3d at 27, 32);
11. decode attention with kv_len a tensor on the card, under
   ``torch.cuda.set_sync_debug_mode("error")``, bit for bit against the
   integer path (kv_len in {S, 30 001, 0, -1, S + 5, S_padded + 7, 12 345}
   on the decode_32k cache and on a B = 2, S = 30 001 cache);
12. the row partition of icesheet3d over 4 shards (``partition_spd``),
   ``apply_local(use_kernel=True)`` over the in-process halo bitwise
   against the global apply; the superkernel's halo-extended plug-ins at 4
   shards of laplace2d, the icesheet3d-stencil grid and icesheet3d, l in
   {1, 2, 3, 8}, against their plain shard expressions and, stacked,
   against the whole-operator superkernel; their times;
13. the ladder oracle (``LocalBackend(reduction="staged",
   virtual_shards=4)``) on laplace2d: the fused full solve against the
   monolithic fused solve of phase 3, and 300-update unfused solves through
   the stencil kernel across stage counts (bitwise), against the
   monolithic unfused solve (within 1e-10 of the initial norm) and with an
   fp32 wire;
14. the paper's baselines and block-Jacobi (``baselines_phase``): classic
   CG and Ghysels p-CG on laplace2d 2048^2 through ``stencil2d5`` beside
   phase 3's p(2)-CG; block-Jacobi (100-row blocks, probed through
   ``ell_spmv``) on icesheet3d with CG, p-CG and unfused p(2)-CG, and the
   same three with Jacobi; classic CG with z-line block-Jacobi on the
   icesheet3d-stencil grid through ``stencil3d7``; each solve bitwise
   against its plain-operator solve, with its launch counts, and
   block-Jacobi's set-up and apply times.

15. p(l)-CG over real ranks (``distributed_phase``): ``launch_fabric``
   starts the ranks, each a ``MultiprocessBackend``.  A world of one rank
   over NCCL solves laplace2d with phase 3's settings (its updates and
   restarts) and icesheet3d; four ranks over gloo share the card (NCCL
   refuses two ranks on one GPU; payloads cross pinned host buffers):
   200 laplace2d updates staged (2 stages) bitwise against the fused
   ranks' one-process reference (``rank_oracle_ops``) and monolithic
   within ORACLE_HIST, icesheet3d staged and
   monolithic to convergence, its ``use_kernel`` operator through
   ``ell_spmv``, and the split-KV decode merge at ``decode_32k``'s heads
   against the single-process merge.  Every fused run launches its halo
   plug-in each vector phase on every rank; each run reports its wire,
   ms per iteration, host syncs and halo and hop bytes per iteration.

16. batched multi-RHS solves and the serve layer (``batched_serve_phase``,
   after every earlier phase): ``LocalBackend.solve_batched`` for a slab
   of 8 right-hand sides at phase 3's settings, column 0 phase 3's b
   (every column converged, column 0's updates phase 3's; ms per slab
   and per column iteration, host syncs, scalar-phase groups, a profiler
   split) and at icesheet3d's (column 0 bitwise equal to phase 7's
   solve, a profiler split, and a slab of 32 beside it); the slab fused
   against unfused for 200 updates; the slab forms of the superkernel
   (stencil and ELL), ``stencil2d5``, ``stencil3d7`` and ``ell_spmv`` at
   s in {1, 8} (the two ELL kernels also at 32), bitwise against their
   plain versions and their single-column launches, timed beside s
   single-column launches, their bounds and a library call;
   ``SolverService`` serving
   16 requests at laplace2d 2048^2 through ``stencil2d5``'s slab form,
   every solve held against the operator, and batched CG through the
   ``stencil3d7`` and ``ell_spmv`` slab forms bitwise against the plain
   operators; the ``BENCH_serve.json`` replay, column by column.

17. the telemetry ring, the stability governor and reduction-payload
   chaos (``stability_phase``, after every earlier phase): phase 3's
   solve with a telemetry ring, bitwise equal to it; the governed stable
   solve of the same problem; profiler splits of plain, instrumented,
   stable and governed iterations; icesheet3d at l = 4 under a 1e-5
   payload fault, governed and not; the depth ladder from l = 16 under
   30 % payload noise (the runtime-depth superkernel on its first rung,
   attempts 16, 8, 4, 2, 1, a StagnationError); a governed slab of 8 ice
   sheets; ``SolverService`` with ``telemetry_cap``, each retired request
   carrying its ring.

18. checkpoint and restore (``checkpoint_phase``): phase 3's settings on
   a 1024^2 grid (cut from 2048^2 to keep the script inside its limit)
   through ``CheckpointConfig(every=2000)``: the segmented oracle bitwise the plain
   solve of its effective config (equal host syncs and launches); the
   same with snapshots (bitwise, two host reads a boundary, each snapshot
   timed: true residual, copy, hash, write); killed at its third
   boundary and resumed from the second snapshot, bitwise the oracle and
   converged; a byte-flipped snapshot and a tol-mismatched resume refused
   with their typed errors; Ghysels p-CG on icesheet3d killed and resumed
   (``every=15``), bitwise.

19. sliced ELL (``sliced_ell_phase``): ``sliced_ell_reorder`` of the
   icesheet3d operator (slices of 64 rows): occupancy before and after,
   the width groups, the grouped apply bitwise against the per-slice loop
   and timed beside ``ell_spmv`` and its bytes bound, and an unfused
   p(2)-CG + Jacobi solve of the permuted system.

20. the measurement layer (``overlap_phase``): overlap reports read from
   the traced schedule at laplace2d 2048^2 (p(l)-CG fused at l in {1, 2,
   3, 9}, unfused through ``stencil2d5``, with a ring, governed, on the
   ladder oracle, a slab of 8; classic CG and p-CG), each with l chains
   in flight (1 for the baselines) and one start a window; a fused
   p(2)-CG window of 64 under ``torch.profiler``: the profile's events and
   chains the recorder's, the history bitwise the untraced window's, each
   chain's hiding interval and busy device µs, classic CG's beside it;
   the roofline of one fused iteration; ``measured_runner`` at l in {1,
   2, 3, 4} and ``autotune_depth`` on the H100 profile recalibrated from
   this run (its table on stderr).

21. batched solves, the ring and the governor, and the service over
   ranks (``ranks_slab_phase``): the superkernel's halo plug-ins in the
   slab form (s = 8, l = 2, Jacobi) on 4 shards of laplace2d 2048^2, the
   icesheet3d-stencil grid and icesheet3d, rows bitwise against the plain
   version, timed beside 8 single-column launches; a world of one over
   NCCL (phase 16's slab at ``main_solve``'s settings and phase 17's
   governed, instrumented solve, each to 2 000 updates, bitwise the same
   on one device, the slab's column 0 the sequential solve;
   phase 16's service of 16 requests
   bitwise); four gloo ranks on the card (laplace2d slabs of 8, 200
   updates, staged bitwise against the slab ``rank_oracle_ops`` and
   monolithic within ORACLE_HIST, with the overlap report's counts on
   every rank; an icesheet3d slab staged to convergence, bitwise; a
   governed, instrumented icesheet3d solve, its ring and governor the
   same on every rank and bitwise the oracle's; a service replay of 8
   requests at 1024^2, the same sets on every rank and bitwise the
   one-device staged-oracle service).

22. checkpointed solves over ranks and the kill-a-rank recovery drill
   (``ranks_recovery_phase``): a world of one over NCCL at ``main_solve``'s
   settings to 3 000 updates with ``CheckpointConfig(every=1000)``,
   bitwise the one-device ``rank_oracle_ops`` run, its resume bitwise,
   its snapshot in the JAX format and restored on one device bitwise;
   four gloo ranks on the card (laplace2d 1024^2, fused p(2)-CG staged,
   ``every=200``, 1 000 updates) under ``run_resilient``: rank 2 killed
   at update 600 (exit 137, the others 143 with their flush sentinels),
   the second attempt restored from the last snapshot and bitwise the
   uninterrupted 4-shard oracle on every rank; that run's last snapshot
   restored by ``LocalBackend(reduction="staged", virtual_shards=4)``.

23. LM serving through ``repro_torch.models.LM`` (``lm_serve_phase``):
   qwen3-1.7b at its published config, full width and depth (28 layers,
   fp32, random weights from a seed), 4 requests of 512 prompt tokens and
   64 new tokens each (prefill, then 63 greedy decode steps, every step's
   attention a launch of the decode kernel: 1 764), with no host sync in
   a step (``set_sync_debug_mode("error")``); the plain path
   teacher-forced on the same tokens within LM_KERNEL_TOL, one forward
   over prompt and generated tokens against the prefill's and every
   step's logits within LM_FORWARD_TOL, all logits finite; prefill ms,
   decode ms a step (CUDA events), a profiled split of 4 steps, the
   decode kernel's device time at the model's shape, peak memory.  Then
   the other nine LM configs at their published widths with their depth
   cut (LM_CUTS): B = 2, 64 prompt tokens (16 encoder frames), 8 decode
   steps, the same checks (MoE's forward check on a drop-free capacity).

Every kernel row of phases 8 and 9 carries its device time (profiler)
beside its event time.

It then prints the card's name and power limit, a ``kernels`` line, and
as the last line ``{"ok": true, "device": {...}}``.  Without a card, or
without the repository beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, NVIDIA data sheet
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32 outside the tensor cores
TOL = 1e-6
PARTIAL_BOUND = 1e-13           # |partial - plain| <= bound * sum_j |m_kj u_j|
ORACLE_HIST = 1e-10             # fp64 oracle vs monolithic history / norm0
HISTORY_RTOL = 1e-8             # fused vs plain residual histories
# fused_dots vs its plain version: both cast to fp32 and accumulate in fp32
# in other orders (the kernel in per-thread chains and fixed trees, cuBLAS
# in its own), so |kernel - plain| <= DOTS_BOUND * sum_j |m_kj v_js|: about
# 80 fp32 ulps of the sum of magnitudes, above either order's error on
# these inputs and far below any error in the logic.
DOTS_BOUND = 1e-5
ATT_TOL = 2e-4                  # decode attention, the JAX tests' bound


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int = 20, warmup: int = 3, tries: int = 3):
    """The device time of one call of ``fn`` from ``torch.profiler`` over
    ``reps`` calls: for each kernel (or copy) name, its mean duration times
    the number of times one call runs it.  Unlike ``cuda_ms`` it leaves out
    the host's time to enqueue.  The profiler can drop device events (on
    the H100's machine it often misses the window's first kernel), so a
    name's count may fall short of a whole number per call by up to a
    tenth of ``reps``; a window with no device time, or a count further
    off, is taken again, up to ``tries`` times; None (and the counts seen,
    on stderr) if none was usable."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    seen = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per_call_us, usable, counts = 0.0, True, {}
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != \
                    torch.autograd.DeviceType.CUDA or not e.count:
                continue
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = getattr(e, "self_cuda_time_total", 0.0)
            k = round(e.count / reps)
            usable = usable and k >= 1 and \
                abs(e.count - k * reps) <= max(1, reps // 10)
            per_call_us += t / e.count * max(k, 1)
            counts[e.key[:48]] = e.count
        if per_call_us > 0 and usable:
            return per_call_us / 1e3
        seen.append({"device_us_per_call": per_call_us, "events": counts})
    print(json.dumps({"device_ms_not_whole": seen}), file=sys.stderr,
          flush=True)
    return None


def in_turns(fns: dict, reps: int = 20) -> dict:
    """Event time and device time of each function, measured in turns (the
    order forward, then backward), so that no function is always timed
    first: {name: {"ms", "device_ms", "ms_turns", "device_ms_turns"}}, the
    first two the means of the two turns."""
    names = list(fns)
    got = {n: {"ms_turns": [], "device_ms_turns": []} for n in names}
    for order in (names, names[::-1]):
        for n in order:
            got[n]["ms_turns"].append(cuda_ms(fns[n], reps=reps))
            got[n]["device_ms_turns"].append(device_ms(fns[n], reps=reps))
    for g in got.values():
        g["ms"] = sum(g["ms_turns"]) / 2
        d = g["device_ms_turns"]
        g["device_ms"] = None if None in d else sum(d) / 2
    return got


def bound_fields(nbytes: float, flops: float) -> dict:
    """The least time for the work: bytes over the memory rate or fp32
    operations over the fp32 rate, whichever is larger."""
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    t_ops = 1e3 * flops / PEAK_FP32_FLOPS
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# Qwen3-1.7B's attention (src/repro/configs/qwen3_1p7b.py: 16 heads, 8 KV
# heads, head_dim 128) in fp32, its compute type, at the two decode cells
# of src/repro/launch/cells.py: decode_32k (global batch 128, one card's
# share 16) and long_500k (batch 1).
DECODE_HEADS, DECODE_KV_HEADS, DECODE_HEAD_DIM = 16, 8, 128
DECODE_SHAPES = (("decode_32k", 16, 32768, (32768, 30001)),
                 ("long_500k", 1, 524288, (524288,)))
SPLIT_KV_SHARDS = 8


def entry_points_phase(dev, gen, n: int, k: int) -> tuple[dict, dict, dict]:
    """Phase 9: the kernel entry points of ``repro_torch.kernels.ops`` on the
    card, each held against its plain version, then timed.  ``n`` and ``k``
    are the slab width and dot-block height of the main problem.  Returns
    (launches on the path, max abs errors, timings)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import fused_axpy as fa
    from repro_torch.kernels import fused_dots as fd
    from repro_torch.kernels import ops as kops
    from repro_torch.models.attention import merge_decode_shards

    def randn(*shape, dtype=torch.float64):
        return torch.randn(*shape, generator=gen, dtype=dtype, device=dev)

    def dots_err(got, mat, vecs):
        plain = fd.fused_dots_plain(mat, vecs).double()
        scale = mat.abs().double() @ vecs.abs().double()
        diff = (got.double() - plain).abs()
        return float(diff.max()), float((diff / scale).max())

    def att_err(got, want):
        diff = (got - want).abs()
        return (float(diff.max()),
                bool((diff <= ATT_TOL + ATT_TOL * want.abs()).all()))

    h, hkv, d = DECODE_HEADS, DECODE_KV_HEADS, DECODE_HEAD_DIM
    err = {"fused_dots": 0.0, "fused_axpy3": 0.0, "decode_attention": 0.0}
    torch.cuda.synchronize()
    _build.reset_launches()

    # -- the path: every entry point at its shapes, checked as it goes ----
    dots = {}
    for dt in (torch.float64, torch.float32):
        mat = randn(k, n, dtype=dt)
        vec = randn(n, dtype=dt)
        vecs = randn(n, 8, dtype=dt)
        name = str(dt).replace("torch.", "")
        for label, got, v2 in (
                ("fused_dots", kops.fused_dots(mat, vec)[:, None], vec[:, None]),
                ("mrhs_s1", kops.fused_dots_mrhs(mat, vec[:, None]),
                 vec[:, None]),
                ("mrhs_s8", kops.fused_dots_mrhs(mat, vecs), vecs)):
            abs_err, rel = dots_err(got, mat, v2)
            dots[f"{label}_{name}"] = {"max_abs_diff": abs_err,
                                       "max_diff_over_abs_sum": rel}
            err["fused_dots"] = max(err["fused_dots"], abs_err)
            if not rel <= DOTS_BOUND:
                raise AssertionError(f"fused_dots {label} {name} exceeds "
                                     "its accumulation bound")
        del mat, vec, vecs
    emit({"phase": "fused_dots_vs_plain", "k": k, "n": n, "cases": dots,
          "bound": DOTS_BOUND})

    x, y, z = (randn(n, dtype=torch.float32) for _ in range(3))
    axpy = {}
    for coeffs in ((0.5, -1.25, 2.0), (0.0, 0.0, 1.0), (1e3, -1e-3, 0.1)):
        got = kops.fused_axpy3(x, y, z, *coeffs)
        plain = fa.fused_axpy3_plain(x, y, z, *coeffs)
        axpy[str(coeffs)] = {"bitwise_equal": bool(torch.equal(got, plain)),
                             "max_abs_diff": float((got - plain).abs().max())}
        if not axpy[str(coeffs)]["bitwise_equal"]:
            raise AssertionError(f"fused_axpy3 {coeffs} differs from its "
                                 "plain version")
    emit({"phase": "fused_axpy3_vs_plain", "n": n, "cases": axpy})
    del x, y, z

    for shape, b, s, kv_lens in DECODE_SHAPES:
        q = randn(b, h, d, dtype=torch.float32)
        kc = randn(b, s, hkv, d, dtype=torch.float32)
        vc = randn(b, s, hkv, d, dtype=torch.float32)
        qg = q.reshape(b, hkv, h // hkv, d)
        for kv_len in kv_lens:
            out = kops.decode_attention(q, kc, vc, kv_len)
            o, m, l = kops.decode_attention_stats(q, kc, vc, kv_len)
            op, mp, lp = da.decode_attention_stats_plain(qg, kc, vc, kv_len)
            want = op / lp
            e_stats, ok_stats = att_err(o / l, want)
            e_out, ok_out = att_err(out, want.reshape(b, h, d))
            rec = {"phase": "decode_attention_vs_plain", "shape": shape,
                   "b": b, "s": s, "kv_len": kv_len, "heads": h,
                   "kv_heads": hkv, "head_dim": d,
                   "stats_max_abs_diff": e_stats, "out_max_abs_diff": e_out,
                   "m_max_abs_diff": float((m - mp).abs().max()),
                   "finite": bool(torch.isfinite(out).all()), "tol": ATT_TOL}
            err["decode_attention"] = max(err["decode_attention"], e_stats,
                                          e_out)
            if shape == "decode_32k":
                w = s // SPLIT_KV_SHARDS
                stats = []
                for i in range(SPLIT_KV_SHARDS):
                    stats.append(kops.decode_attention_stats(
                        q, kc[:, i * w:(i + 1) * w].contiguous(),
                        vc[:, i * w:(i + 1) * w].contiguous(),
                        min(max(kv_len - i * w, 0), w)))
                merged = merge_decode_shards(
                    *(torch.stack([st[j] for st in stats]) for j in range(3)))
                e_split, ok_split = att_err(merged.reshape(b, h, d), out)
                rec.update(split_kv_shards=SPLIT_KV_SHARDS,
                           split_kv_max_abs_diff=e_split)
                if not ok_split:
                    raise AssertionError("split-KV merge differs from the "
                                         "whole-cache decode")
                del stats, merged
            emit(rec)
            if not (ok_stats and ok_out and rec["finite"]):
                raise AssertionError(f"decode_attention {shape} kv_len "
                                     f"{kv_len} differs from its plain "
                                     "version")
            del out, o, m, l, op, mp, lp, want
        del q, kc, vc, qg
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)

    # -- fused_dots: the same bits twice, and the redesign's tail paths ----
    # (after the path's counts are read: these launches are checks only).
    # The main shape in both dtypes and S in {1, 8}; then one row and 17
    # rows (three row chunks), N not a multiple of the vector width, bases
    # one element off the 16-byte grid, S not a multiple of it.
    tails = {}
    cases = [(k, n, ss, 0, dt) for ss in (1, 8)
             for dt in (torch.float64, torch.float32)]
    cases += [(kk, nn, ss, off, dt)
              for kk, nn, ss, off in ((1, n + 1, 1, 1), (17, 4099, 1, 0),
                                      (17, 4099, 8, 1), (5, 100003, 3, 0))
              for dt in (torch.float64, torch.float32)]
    for kk, nn, ss, off, dt in cases:
        mat = randn(kk * nn + off, dtype=dt)[off:].view(kk, nn)
        vecs = randn(nn * ss + off, dtype=dt)[off:].view(nn, ss)
        got = kops.fused_dots_mrhs(mat, vecs)
        abs_err, rel = dots_err(got, mat, vecs)
        same = bool(torch.equal(got, kops.fused_dots_mrhs(mat, vecs)))
        tails[f"k{kk}_n{nn}_s{ss}_off{off}_{str(dt)[6:]}"] = {
            "max_abs_diff": abs_err, "max_diff_over_abs_sum": rel,
            "same_bits_twice": same}
        if not rel <= DOTS_BOUND or not same:
            raise AssertionError(f"fused_dots k={kk} n={nn} s={ss} off={off} "
                                 f"{dt}: beyond its bound or not the same "
                                 "bits twice")
        del mat, vecs, got
    emit({"phase": "fused_dots_tails_vs_plain", "cases": tails,
          "bound": DOTS_BOUND})

    # -- timings (CUDA events) --------------------------------------------
    # The redesigned fused_dots against cuBLAS, in turns, with device time.
    # fp32 is the same function as torch.matmul on the same inputs; for fp64
    # the yardstick runs on fp32 copies made outside the timed window (it
    # skips the two casts and reads half the bytes).
    timings = {}
    mat = randn(k, n)
    vec = randn(n)
    m32, v32 = mat.float(), vec.float()
    vecs = randn(n, 8)
    V32 = vecs.float()
    for key, a, b, lib_b, nbytes in (
            ("fused_dots", mat, vec, v32, (k * n + n) * 8 + k * 8),
            ("fused_dots_fp32", m32, v32, v32, (k * n + n) * 4 + k * 4),
            ("fused_dots_mrhs_s8", mat, vecs, V32,
             (k * n + 8 * n) * 8 + 8 * k * 8)):
        call = fd.fused_dots if b.dim() == 1 else fd.fused_dots_mrhs
        t = in_turns({"kernel": lambda: call(a, b),
                      "library": lambda: torch.matmul(m32, lib_b)})
        timings[key] = dict(
            ms=t["kernel"]["ms"], device_ms=t["kernel"]["device_ms"],
            ms_turns=t["kernel"]["ms_turns"],
            device_ms_turns=t["kernel"]["device_ms_turns"],
            plain_ms=cuda_ms(lambda: fd.fused_dots_plain(a, b)),
            library_ms=t["library"]["ms"],
            library_device_ms=t["library"]["device_ms"],
            library_same_function=a.dtype == torch.float32,
            **bound_fields(nbytes, 2 * k * n * (1 if b.dim() == 1 else
                                                b.shape[1])))
    del mat, vec, vecs, m32, v32, V32, a, b, lib_b
    x, y, z = (randn(n, dtype=torch.float32) for _ in range(3))
    timings["fused_axpy3"] = dict(
        ms=cuda_ms(lambda: fa.fused_axpy3(x, y, z, 0.5, -1.25, 2.0)),
        device_ms=device_ms(lambda: fa.fused_axpy3(x, y, z, 0.5, -1.25, 2.0)),
        plain_ms=cuda_ms(lambda: fa.fused_axpy3_plain(x, y, z, 0.5, -1.25,
                                                      2.0)),
        library_ms=None, **bound_fields(4 * n * 4, 4 * n))
    del x, y, z
    for shape, b, s, kv_lens in DECODE_SHAPES:
        q = randn(b, h, d, dtype=torch.float32)
        kc = randn(b, s, hkv, d, dtype=torch.float32)
        vc = randn(b, s, hkv, d, dtype=torch.float32)
        qg = q.reshape(b, hkv, h // hkv, d)
        # The library yardstick takes (B, H, S, D): the layout change is made
        # here, outside the timed window.
        kt, vt = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
        q4 = q[:, :, None, :]
        sdpa = F.scaled_dot_product_attention(q4, kt, vt, enable_gqa=True)
        err[f"sdpa_vs_decode_attention_{shape}"] = float(
            (sdpa[:, :, 0] - kops.decode_attention(q, kc, vc, s)).abs().max())
        del sdpa
        for kv_len in kv_lens:
            key = "decode_attention" if (shape, kv_len) == ("decode_32k",
                                                            32768) else \
                f"decode_attention_{shape}_kv{kv_len}"
            reps = 10 if s > 100000 else 20
            timings[key] = dict(
                ms=cuda_ms(lambda: da.decode_attention_stats(qg, kc, vc,
                                                            kv_len),
                           reps=reps),
                device_ms=device_ms(lambda: da.decode_attention_stats(
                    qg, kc, vc, kv_len), reps=reps),
                plain_ms=cuda_ms(lambda: da.decode_attention_stats_plain(
                    qg, kc, vc, kv_len), reps=reps),
                library_ms=(cuda_ms(lambda: F.scaled_dot_product_attention(
                    q4, kt, vt, enable_gqa=True), reps=reps)
                    if kv_len == s else None),
                **bound_fields(2 * b * kv_len * hkv * d * 4 + 2 * b * h * d * 4,
                               4 * b * h * kv_len * d))
        del q, kc, vc, qg, kt, vt, q4
        torch.cuda.empty_cache()
    return launches, err, timings


def device_split(run, names) -> dict:
    """Wall time of ``run()`` under ``torch.profiler`` and the device time
    of its kernels, bucketed by the first of ``names`` each kernel's name
    holds (else "other"), with the count of kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev_us = {k: 0.0 for k in (*names, "other")}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_kernels = 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if not t or getattr(e, "device_type", None) != \
                torch.autograd.DeviceType.CUDA:
            continue
        n_kernels += e.count
        dev_us[next((k for k in names if k in e.key), "other")] += t
    return {"wall_s": wall, "device_us": dev_us, "kernels": n_kernels}


def per_iter(split: dict, iters: int) -> dict:
    """A ``device_split`` per iteration, with the device's busy share."""
    n = max(iters, 1)
    busy_us = sum(split["device_us"].values())
    return {"iterations": iters, "wall_ms_per_iter": 1e3 * split["wall_s"] / n,
            "device_us_per_iter": {k: v / n
                                   for k, v in split["device_us"].items()},
            "device_kernels_per_iter": split["kernels"] / n,
            "device_busy_share": (busy_us * 1e-6 / split["wall_s"]
                                  if split["wall_s"] else None)}


def history_head_tail(h_a, h_b, norm0: float) -> tuple[float, float]:
    """Relative differences of two residual histories where both hold an
    entry: the largest over the first 10, and over all."""
    import numpy as np

    m = (h_a >= 0) & (h_b >= 0)
    diff = np.abs(h_a[m] - h_b[m]) / norm0
    return float(diff[:10].max()), float(diff.max())


def timed(fn, nbytes: float, plain=None, plain_reps: int = 5) -> dict:
    """Event time, device time (profiler) and, given, the plain version's
    event time of one call, beside the bytes bound."""
    out = {"ms": cuda_ms(fn), "device_ms": device_ms(fn),
           "plain_ms": None if plain is None else cuda_ms(plain,
                                                          reps=plain_reps),
           "library_ms": None}
    out.update(bound_fields(nbytes, 0.0))
    return out


def runtime_depth_phase(dev, randn, phase_scal, superkernel_vs_plain,
                        lap_op, lap_prec, ice_op, ice_prec, lap_b,
                        lap_sig_fn) -> tuple[dict, float, dict]:
    """Pipelines deeper than the compile-time kernels (l > LMAX) through
    the runtime-depth superkernel: rows bitwise against the plain vector
    phase at l in {9, 12, 16} on laplace2d (2048^2) and at l in {9, 12, 16,
    27, 32} and the deepest l whose shared memory fits on icesheet3d
    (laplace2d's slab at l = 27 alone is 26.5 GB; the check's peak device
    memory is reported); the first depth past it refused with both byte
    counts; a 100-update l = 9 solve (the path whose launches are counted)
    against the unfused solve; and the times at l in {9, 12, 16}
    (laplace2d) and {27, 32} (icesheet3d).
    Returns (launches, max abs error, timings)."""
    import torch

    from repro_torch.kernels import _build, fused_iter as fi, ops as kops
    from repro_torch.linalg import Stencil2D5

    t0 = time.perf_counter()
    deepest = fi.deepest_runtime_l(fi.smem_optin("fused_iter_stencil2d5",
                                                 dev))
    depths = {"laplace2d": (9, 12, 16),
              "icesheet3d": (9, 12, 16, 27, 32, deepest)}
    cases, row_err, part_err = {}, 0.0, 0.0
    for name, op in (("laplace2d", lap_op), ("icesheet3d", ice_op)):
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        r, p_, c = superkernel_vs_plain([op], depths=depths[name])
        tot = {"depths": list(depths[name]), "cases": c,
               "rows_max_abs_diff": r,
               "partials_max_diff_over_abs_sum": p_,
               "device_bytes_held_before": held,
               "peak_device_bytes": torch.cuda.max_memory_allocated(dev)}
        cases[name] = tot
        row_err = max(row_err, tot["rows_max_abs_diff"])
        part_err = max(part_err, tot["partials_max_diff_over_abs_sum"])
    beyond = deepest + 1
    layout = fi.SlabLayout(l=beyond, RB=beyond + 1)
    small = Stencil2D5(64, 64)
    fiter = kops.fused_iteration_factory(small)(layout)
    try:
        fiter(torch.zeros((layout.nv, small.n), dtype=torch.float64,
                          device=dev),
              torch.tensor(fi.host_idx(layout, 3 * beyond), dtype=torch.int32,
                           device=dev), phase_scal(beyond))
        refusal = None
    except ValueError as e:
        refusal = str(e)
    need = str(fi.runtime_smem_bytes(beyond))
    if refusal is None or need not in refusal:
        raise AssertionError(f"l = {beyond} was not refused with its "
                             f"{need} bytes of shared memory")

    # The path: a short l = 9 solve through the runtime-depth kernel.
    from repro_torch.parallel.backends import LocalBackend

    be = LocalBackend()
    kw = dict(l=9, tol=1e-30, maxit=100, max_restarts=50,
              sigmas=lap_sig_fn(9), fused_iteration=True, unroll=16)
    torch.cuda.synchronize()
    _build.reset_launches()
    r_f = be.solve(lap_op, lap_b, prec=lap_prec, **kw)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    r_p = be.solve(lap_op, lap_b, prec=lap_prec,
                   **dict(kw, fused_iteration=False))
    h_f, h_p = r_f.res_history.cpu().numpy(), r_p.res_history.cpu().numpy()
    m = int(min((h_f >= 0).sum(), (h_p >= 0).sum()))
    hist_rel = float((abs(h_f[:m] - h_p[:m]) / abs(h_p[:m])).max())
    counts = [[int(r.iters), int(r.restarts)] for r in (r_f, r_p)]
    head, _ = history_head_tail(h_f, h_p, float(r_p.norm0))
    solve_ok = bool(torch.isfinite(r_f.x).all()) and head < 1e-5
    del r_f, r_p

    timings = {}
    for key, op, pr, l in [
            *((f"fused_iter_runtime_l{l}", lap_op, lap_prec, l)
              for l in (9, 12, 16)),
            *((f"fused_iter_runtime_icesheet3d_l{l}", ice_op, ice_prec, l)
              for l in (27, 32))]:
        layout = fi.SlabLayout(l=l, RB=l + 1)
        fiter = kops.fused_iteration_factory(op, pr)(layout)
        host = fi.host_idx(layout, 2 * l + 3)
        idx = torch.tensor(host, dtype=torch.int32, device=dev)
        scal = phase_scal(l)
        S = randn(layout.nv, op.n) * 1e-3
        timings[key] = timed(
            lambda: fiter(S, idx, scal),
            fi.min_bytes(layout, host, op.n, has_prec=True, has_diag=False,
                         operand_bytes=fiter.spmv.operand_bytes),
            plain=lambda: fiter.plain(S, idx, scal), plain_reps=2)
        del S
        torch.cuda.empty_cache()
    rec = {"phase": "runtime_depth_vs_plain", "lmax_compile_time": fi.LMAX,
           "lmax_runtime": deepest,
           "smem_bytes": {str(l): fi.runtime_smem_bytes(l)
                          for l in sorted({*depths["icesheet3d"],
                                           beyond})},
           "refused_beyond": refusal, "cases": cases,
           "partials_bound": PARTIAL_BOUND, "solve_l9": {
               "launches": launches, "iters_restarts_fused_unfused": counts,
               "history_head_max_vs_unfused": head, "head_bound": 1e-5,
               "history_max_rel_diff_vs_unfused": hist_rel},
           "timings": timings, "seconds": time.perf_counter() - t0}
    emit(rec)
    if row_err != 0 or not part_err <= PARTIAL_BOUND:
        raise AssertionError("runtime-depth superkernel differs from its "
                             "plain version")
    if not solve_ok or launches.get("fused_iter_runtime_l", 0) == 0:
        raise AssertionError("l = 9 solve is not finite, its first residuals "
                             "differ from the unfused solve's, or it never "
                             "launched the runtime-depth kernel")
    return launches, row_err, timings


def decode_kv_len_phase(dev, gen) -> dict:
    """Decode attention with kv_len a (1, 1) int32 tensor on the card,
    under ``torch.cuda.set_sync_debug_mode("error")`` (a host sync raises),
    against the integer path, bit for bit: the decode_32k cache (S =
    32 768, a multiple of block_s) and a (B = 2, S = 30 001) cache whose
    padded length is 30 208, so that kv_len past S folds in padding."""
    import torch

    from repro_torch.kernels import _build, ops as kops

    h, hkv, d = DECODE_HEADS, DECODE_KV_HEADS, DECODE_HEAD_DIM
    got_cases = {}
    launches = 0
    for b, s in ((16, 32768), (2, 30001)):
        padded = -(-s // 512) * 512
        q = torch.randn(b, h, d, generator=gen, device=dev)
        kc = torch.randn(b, s, hkv, d, generator=gen, device=dev)
        vc = torch.randn(b, s, hkv, d, generator=gen, device=dev)
        lens = sorted({s, 30001, 0, -1, s + 5, padded + 7, 12345})
        for kv_len in lens:
            want = kops.decode_attention_stats(q, kc, vc, kv_len)
            kt = torch.tensor([[kv_len]], dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            before = _build.LAUNCHES["decode_attention"]
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = kops.decode_attention_stats(q, kc, vc, kt)
                out = kops.decode_attention(q, kc, vc, kt)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            launches += _build.LAUNCHES["decode_attention"] - before
            same = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
            same = same and bool(torch.equal(
                out, kops.decode_attention(q, kc, vc, kv_len)))
            got_cases[f"b{b}_s{s}_kv{kv_len}"] = {
                "same_bits_as_int": same,
                "max_abs_diff": max(float((g - w).abs().max())
                                    for g, w in zip(got, want))}
            if not same:
                raise AssertionError(f"device kv_len {kv_len} (S = {s}) "
                                     "differs from the integer path")
        del q, kc, vc
        torch.cuda.empty_cache()
    emit({"phase": "decode_kv_len_on_device", "sync_debug_mode": "error",
          "block_s": 512, "cases": got_cases,
          "launches_under_sync_check": launches})
    return got_cases


N_SHARDS = 4


def partition_phase(dev, iop) -> tuple[object, dict]:
    """The row partition of icesheet3d (500 000 nodes, RCM-ordered) over 4
    shards, and the shard-level SpMV over the in-process halo through the
    ELL kernel, bitwise against the ordered operator's global apply."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.linalg.partition import apply_local, partition_spd

    t0 = time.perf_counter()
    plan = partition_spd(iop, N_SHARDS)
    setup_s = time.perf_counter() - t0
    x = torch.randn(iop.n, dtype=torch.float64, device=dev)
    y_global = iop.apply(x)
    args = (plan.cols, plan.vals, plan.send_up, plan.send_dn)
    torch.cuda.synchronize()
    before = _build.LAUNCHES["ell_spmv"]
    y = apply_local(x.reshape(N_SHARDS, plan.nxl), *args, use_kernel=True)
    torch.cuda.synchronize()
    launched = _build.LAUNCHES["ell_spmv"] - before
    y_plain = apply_local(x.reshape(N_SHARDS, plan.nxl), *args)
    rec = {"phase": "partition_vs_plain", "problem": "icesheet3d",
           "n": iop.n, "n_shards": N_SHARDS, "nxl": plan.nxl,
           "hops": plan.hops, "max_send": plan.max_send, "ext": plan.ext,
           "band": plan.band, "identity_perm": plan.identity_perm,
           "host_setup_s": setup_s, "ell_spmv_launches": launched,
           "bitwise_vs_global_apply": bool(torch.equal(y.reshape(-1),
                                                       y_global)),
           "plain_bitwise_vs_global_apply": bool(torch.equal(
               y_plain.reshape(-1), y_global))}
    emit(rec)
    if not (rec["bitwise_vs_global_apply"]
            and rec["plain_bitwise_vs_global_apply"]) or launched == 0:
        raise AssertionError("partitioned apply differs from the global "
                             "apply or never launched the ELL kernel")
    return plan, rec


def shard_plugins_phase(dev, randn, phase_scal, operators: dict,
                        plan) -> tuple[dict, float, dict]:
    """The superkernel's halo-extended plug-ins at 4 shards of laplace2d
    (2048^2), the icesheet3d-stencil grid (256 x 200 x 152) and icesheet3d
    (ELL, through ``plan``), l in {1, 2, 3, 8}, both recurrences, Jacobi
    and identity, early and late cycle positions.  Each shard's kernel
    against its plain shard expression (rows bitwise, partials within
    PARTIAL_BOUND of sum |m u|); the stacked rows against the
    whole-operator superkernel, bitwise; the shards' partials through
    ``ordered_reduce`` against the whole-operator partials.  Then each
    halo kernel's time beside the single-device plug-in's, at l = 2.
    Returns (launches, max abs error, timings)."""
    import torch

    from repro_torch.core.types import dot_block_rows
    from repro_torch.kernels import _build, fused_iter as fi, ops as kops
    from repro_torch.kernels import ref
    from repro_torch.linalg import JacobiPrec, SparseOp
    from repro_torch.linalg.partition import halo_exchange
    from repro_torch.parallel.distributed import (fused_spmv_local,
                                                  halo_first_dim)
    from repro_torch.parallel.reduction import ordered_reduce

    p = N_SHARDS

    def shard_fiters(op, layout, inv_diag, S, idx):
        """(fiter, plain preconditioner) of each shard, each fed its row
        of the in-process halo of the ring-top rows."""
        nl = op.n // p
        pos = fi.idx_layout(layout.l)["z_top"]
        zt = S.index_select(0, idx[pos:pos + 1])[0].reshape(p, nl)
        if isinstance(op, SparseOp):
            ext = halo_exchange(zt, plan.send_up, plan.send_dn)
            locs = [{f: getattr(plan, f)[s] for f in
                     ("cols", "vals", "send_up", "send_dn")}
                    for s in range(p)]
        else:
            ext = halo_first_dim(zt, op.n // op.nx)
            locs = [{} for _ in range(p)]
        out = []
        for s in range(p):
            spmv = fused_spmv_local(op, locs[s], p, lambda z, s=s: ext[s])
            inv = None if inv_diag is None else \
                inv_diag[s * nl:(s + 1) * nl].contiguous()
            pfun = (lambda v: v) if inv is None else \
                (lambda v, inv=inv: inv * v)
            out.append((fi.build_fused_iteration(layout, spmv, inv), pfun))
        return out

    def plain_phase(S, idx, scal, apply_a, pfun, layout):
        """(rows, partials, sum |m u|) of the plain vector phase."""
        rows, mat, u = ref.fused_iter_unfused(S, idx, scal, apply_a, pfun,
                                              layout)
        return rows, dot_block_rows(mat, u), \
            (mat.abs() * u.abs()[None]).sum(dim=1)

    summary, err = {}, 0.0
    torch.cuda.synchronize()
    _build.reset_launches()
    whole_launches = 0
    for name, op in operators.items():
        nl = op.n // p
        rows_err = part_err = red_err = 0.0
        stack_same, cases = True, 0
        for l in (1, 2, 3, 8):
            for rec in ("ghysels", "stable"):
                for jac in (True, False):
                    prec = JacobiPrec.from_operator(op) if jac else None
                    inv = None if prec is None else prec.inv_diag
                    layout = fi.SlabLayout(l=l, RB=max(l + 1, 3),
                                           recurrence=rec)
                    for i in sorted({0, l, 2 * l + 3}):
                        S = randn(layout.nv, op.n)
                        idx = torch.tensor(fi.host_idx(layout, i),
                                           dtype=torch.int32, device=dev)
                        scal = phase_scal(l)
                        rows, parts = [], []
                        for s, (f, pfun) in enumerate(
                                shard_fiters(op, layout, inv, S, idx)):
                            S_s = S[:, s * nl:(s + 1) * nl].contiguous()
                            S_p, d_p, scale = plain_phase(
                                S_s, idx, scal, f.spmv.expr, pfun, layout)
                            S_k, d_k = f(S_s, idx, scal)
                            rows_err = max(rows_err, float(
                                (S_k - S_p).abs().max()))
                            part_err = max(part_err, float(
                                ((d_k - d_p).abs() / scale).max()))
                            rows.append(S_k)
                            parts.append(d_k)
                            del S_p
                        _, _, scale = plain_phase(
                            S, idx, scal, op.apply,
                            (lambda v: v) if prec is None else prec.apply,
                            layout)
                        whole = kops.fused_iteration_factory(op, prec)(layout)
                        S_w, d_w = whole(S, idx, scal)
                        whole_launches += 1
                        stack_same = stack_same and bool(
                            torch.equal(torch.cat(rows, dim=1), S_w))
                        total = ordered_reduce(torch.stack(parts),
                                               torch.float64, False)
                        red_err = max(red_err, float(
                            ((total - d_w).abs() / scale).max()))
                        cases += 1
                        del S, S_w, rows, parts
            torch.cuda.empty_cache()
        summary[name] = {"own_rows": nl, "cases": cases,
                         "rows_max_abs_diff": rows_err,
                         "partials_max_diff_over_abs_sum": part_err,
                         "stacked_rows_bitwise_vs_whole": stack_same,
                         "ordered_reduce_vs_whole_max_diff_over_abs_sum":
                             red_err}
        err = max(err, rows_err)
        if rows_err != 0 or not stack_same or not part_err <= PARTIAL_BOUND \
                or not red_err <= PARTIAL_BOUND:
            emit({"phase": "shard_plugins_vs_plain", "failed": name,
                  "plugins": summary})
            raise AssertionError(f"halo plug-in of {name} differs from its "
                                 "plain version or from the whole operator")
    launches = {k: v for k, v in _build.LAUNCHES.items()
                if k in ("fused_iter_halo", "fused_iter_ell_halo")}

    timings = {}
    layout = fi.SlabLayout(l=2, RB=3)
    host = fi.host_idx(layout, 2 * layout.l + 3)
    idx = torch.tensor(host, dtype=torch.int32, device=dev)
    scal = phase_scal(2)
    for name, op in operators.items():
        prec = JacobiPrec.from_operator(op)
        nl = op.n // p
        S = randn(layout.nv, op.n) * 1e-3
        f = shard_fiters(op, layout, prec.inv_diag, S, idx)[1][0]
        S_s = S[:, nl:2 * nl].contiguous()
        timings[f"halo_{name}"] = timed(
            lambda: f(S_s, idx, scal),
            fi.min_bytes(layout, host, nl, has_prec=True, has_diag=False,
                         operand_bytes=f.spmv.operand_bytes),
            plain=lambda: f.plain(S_s, idx, scal))
        whole = kops.fused_iteration_factory(op, prec)(layout)
        timings[f"single_device_{name}"] = timed(
            lambda: whole(S, idx, scal),
            fi.min_bytes(layout, host, op.n, has_prec=True, has_diag=False,
                         operand_bytes=whole.spmv.operand_bytes))
        del S, S_s
        torch.cuda.empty_cache()
    emit({"phase": "shard_plugins_vs_plain", "n_shards": p,
          "depths": [1, 2, 3, 8], "ell_plan": {
              "nxl": plan.nxl, "hops": plan.hops, "max_send": plan.max_send,
              "ext": plan.ext},
          "plugins": summary, "partials_bound": PARTIAL_BOUND,
          "launches": launches, "whole_operator_check_launches":
              whole_launches, "timings": timings})
    return launches, err, timings


def oracle_phase(op, prec, b, sig, solve_kw, main_res) -> dict:
    """The ladder oracle on laplace2d 2048^2, p(2)-CG, Jacobi:
    ``LocalBackend(reduction="staged", virtual_shards=4)``.  The fused
    full solve (one superkernel partial filed in slot 0, the other slots
    exact zeros) against the monolithic fused solve ``main_res`` (history
    head within ORACLE_HIST of norm0; the whole history, ~11 800 updates
    whose restarts round in another grouping, within 5e-2); then
    300-update unfused solves through the stencil kernel
    (``use_kernel=True``): fp64 wire at 1 and 3 stages (bitwise), an fp32
    wire (bounded tail), and the monolithic unfused solve's time."""
    import dataclasses as dc

    import torch

    from repro_torch.kernels import _build
    from repro_torch.parallel.backends import LocalBackend

    def run(be, op_, kw):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        r = be.solve(op_, b, prec=prec, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return r, wall, dict(_build.LAUNCHES)

    staged = LocalBackend(reduction="staged", virtual_shards=N_SHARDS)
    r, wall, launches = run(staged, op, solve_kw)
    n_iter = launches.get("fused_iter", 0)
    true_rel = float(torch.linalg.norm(b - op.apply(r.x))
                     / torch.linalg.norm(b))
    fused = {"converged": bool(r.converged), "iters": int(r.iters),
             "restarts": int(r.restarts), "vector_phases": n_iter,
             "wall_s": wall, "ms_per_iter": 1e3 * wall / max(n_iter, 1),
             "true_rel_residual": true_rel, "launches": launches,
             "bitwise_vs_monolithic_fused": bool(
                 torch.equal(r.x, main_res.x)
                 and torch.equal(r.res_history, main_res.res_history))}
    fused["history_vs_monolithic_fused"] = dict(zip(
        ("head_max", "max"), history_head_tail(
            r.res_history.cpu().numpy(), main_res.res_history.cpu().numpy(),
            float(main_res.norm0))))
    if not fused["bitwise_vs_monolithic_fused"]:
        fused["why_not_bitwise"] = (
            "each iteration's superkernel partial only gains P-1 exact "
            "zeros, but the blocking reductions of the cycle start (the "
            "initial norm, each restart's block) go through start(), which "
            "the oracle sums as 4 slice partials in rank order: another "
            "grouping than the monolithic row sum")
    del r
    kop = dc.replace(op, use_kernel=True)
    kw = dict(solve_kw, maxit=300, tol=1e-30, fused_iteration=False)
    unfused = {}
    for key, be in (
            ("monolithic", LocalBackend()),
            ("fp64_stages1", LocalBackend(reduction="staged",
                                          reduction_stages=1,
                                          virtual_shards=N_SHARDS)),
            ("fp64_stages3", LocalBackend(reduction="staged",
                                          reduction_stages=3,
                                          virtual_shards=N_SHARDS)),
            ("fp32_stages2", LocalBackend(
                reduction="staged", reduction_stages=2,
                reduction_dtype=torch.float32, virtual_shards=N_SHARDS))):
        r, wall, launches = run(be, kop, kw)
        unfused[key] = {"res": r, "iters": int(r.iters),
                        "restarts": int(r.restarts), "wall_s": wall,
                        "ms_per_iter": 1e3 * wall / max(int(r.iters), 1),
                        "launches": launches}
    h = {k: v.pop("res") for k, v in unfused.items()}
    across = bool(torch.equal(h["fp64_stages1"].res_history,
                              h["fp64_stages3"].res_history)
                  and torch.equal(h["fp64_stages1"].x, h["fp64_stages3"].x))
    head, tail = history_head_tail(h["fp32_stages2"].res_history.cpu().numpy(),
                                   h["fp64_stages1"].res_history.cpu().numpy(),
                                   float(h["fp64_stages1"].norm0))
    head_m, tail_m = history_head_tail(
        h["fp64_stages1"].res_history.cpu().numpy(),
        h["monolithic"].res_history.cpu().numpy(),
        float(h["monolithic"].norm0))
    rec = {"phase": "oracle_solve", "problem": "laplace2d", "n": op.n,
           "virtual_shards": N_SHARDS, "l": solve_kw["l"], "prec": "jacobi",
           "fused": fused, "unfused_use_kernel": unfused,
           "unfused_fp64_bitwise_across_stage_counts": across,
           "unfused_fp32_wire_vs_fp64": {"head_max": head, "max": tail},
           "unfused_oracle_vs_monolithic": {"head_max": head_m,
                                            "max": tail_m},
           "bounds": {"head": 1e-5, "all": 5e-2,
                      "fp64_vs_monolithic": ORACLE_HIST}}
    emit(rec)
    fh = fused["history_vs_monolithic_fused"]
    if not (fused["converged"] and true_rel < 10 * TOL and across
            and head < 1e-5 and tail < 5e-2 and n_iter > 0
            and fh["head_max"] <= ORACLE_HIST and fh["max"] < 5e-2
            and head_m <= ORACLE_HIST and tail_m <= ORACLE_HIST
            and all(u["launches"].get("stencil2d5", 0) > 0
                    for u in unfused.values())):
        raise AssertionError("ladder oracle solve failed its checks")
    return rec


BLOCK_BOUND = 1e-10             # max |inv_block @ block - I|, sampled blocks
ICE_BLOCK = 100                 # icesheet3d block-Jacobi block size


def baselines_phase(dev, gpu, lap, ice, iop, lap_b, main) -> dict:
    """The paper's baselines beside p(2)-CG, and block-Jacobi, the ice
    sheets' own preconditioner, on the full problems:

    * ``laplace2d`` 2048^2, Jacobi: classic CG and Ghysels p-CG on
      ``Stencil2D5(use_kernel=True)`` (the ``stencil2d5`` kernel), beside
      ``main``, the fused p(2)-CG solve of phase 3;
    * ``icesheet3d`` (RCM-ordered ELL, ``SparseOp(use_kernel=True)``, the
      ``ell_spmv`` kernel): block-Jacobi with ``ICE_BLOCK``-row blocks
      (the JAX config names block-Jacobi but no size; 100 divides
      500 000), probed through the kernel; CG, p-CG and unfused p(2)-CG
      with it and with Jacobi;
    * ``icesheet3d-stencil`` (``Stencil3D7(use_kernel=True)``, the
      ``stencil3d7`` kernel): block-Jacobi with one z line (the fastest
      index) a block, and classic CG with it.

    Every solve converges to tol 1e-6 with a true relative residual below
    10 tol, and equals, bit for bit, the same solve on the plain operator;
    each records its updates, restarts, wall time, ms and host syncs per
    update, and the kernel launches counted over it.  Block-Jacobi records
    its set-up (probing, inverse), sampled blocks against the operator's
    own (``BLOCK_BOUND``), and its apply's time against its byte bound.
    Returns the solves' launches of each kernel."""
    import numpy as np
    import torch

    from repro_torch.core.chebyshev import shifts_for_operator
    from repro_torch.kernels import _build
    from repro_torch.linalg import (BlockJacobi, JacobiPrec, Stencil2D5,
                                    Stencil3D7, bandwidth)
    from repro_torch.parallel.backends import LocalBackend

    be = LocalBackend(device=dev)
    failed = []

    def solve(kop, pop, b, prec, method, **kw):
        """The kernel-routed solve, timed and counted, and the plain one."""
        kw = dict(kw, tol=TOL, unroll=16)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        r = be.solve(kop, b, method=method, prec=prec, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        r_p = be.solve(pop, b, method=method, prec=prec, **kw)
        n = max(int(r.iters), 1)
        rec = {"converged": bool(r.converged), "iters": int(r.iters),
               "restarts": int(r.restarts), "wall_s": wall,
               "ms_per_iter": 1e3 * wall / n, "host_syncs": r.host_syncs,
               "host_syncs_per_iter": r.host_syncs / n,
               "true_rel_residual": float(torch.linalg.norm(
                   b - pop.apply(r.x)) / torch.linalg.norm(b)),
               "launches": launches,
               "bitwise_equal_to_plain": bool(
                   torch.equal(r.x, r_p.x)
                   and torch.equal(r.res_history, r_p.res_history))}
        if not (rec["converged"] and rec["true_rel_residual"] < 10 * TOL
                and rec["bitwise_equal_to_plain"]):
            failed.append(f"{method} on {type(kop).__name__}")
        return rec

    def block_jacobi(kop, block_size, blocks_of):
        """Block-Jacobi probed through ``kop``, its set-up timed, sampled
        blocks checked, its apply timed against its byte bound."""
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        bj = BlockJacobi.from_operator(kop, block_size)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        probe = dict(_build.LAUNCHES)
        nb = kop.n // block_size
        err = 0.0
        eye = torch.eye(block_size, dtype=torch.float64, device=dev)
        for k in sorted(set(np.linspace(0, nb - 1, 9).astype(int))):
            blk = torch.tensor(blocks_of(k), device=dev)
            err = max(err, float((bj.inv_blocks[k] @ blk - eye).abs().max()))
        x = torch.tensor(np.random.default_rng(3).standard_normal(kop.n),
                         device=dev)
        nbytes = bj.inv_blocks.numel() * 8 + 2 * kop.n * 8
        rec = {"block_size": block_size, "n_blocks": nb,
               "inv_bytes": bj.inv_blocks.numel() * 8, "setup_s": setup_s,
               "probe_launches": probe, "sampled_block_err": err,
               "bound": BLOCK_BOUND,
               "apply": timed(lambda: bj.apply(x), nbytes)}
        if not err <= BLOCK_BOUND:
            failed.append(f"blocks of {type(kop).__name__}")
        return bj, rec

    # ---- laplace2d 2048^2: CG and p-CG beside p(2)-CG --------------------
    pop = Stencil2D5(lap.nx, lap.ny, device=dev)
    kop = Stencil2D5(lap.nx, lap.ny, use_kernel=True, device=dev)
    jac = JacobiPrec.from_operator(pop)
    lap_rec = {"n": pop.n, "prec": "jacobi", "maxit": 20000,
               "plcg_l2_fused_main_solve": {
                   k: main[k] for k in ("iters", "restarts", "wall_s",
                                        "ms_per_iter", "host_syncs_per_iter",
                                        "true_rel_residual")}}
    for method in ("cg", "pcg"):
        lap_rec[method] = solve(kop, pop, lap_b, jac, method, maxit=20000)
        # Where an update goes: 96 updates (six whole windows) under the
        # profiler.
        split = device_split(lambda: be.solve(
            kop, lap_b, method=method, prec=jac, tol=1e-30, maxit=96,
            unroll=16), ("stencil2d5",))
        lap_rec[method]["split_96_updates"] = per_iter(split, 96)
    emit({"phase": "baselines", "problem": lap.name, "gpu": gpu, **lap_rec})

    # ---- icesheet3d: the three methods, block-Jacobi and Jacobi ---------
    ikop = dataclasses.replace(iop, use_kernel=True)
    cols, vals = iop.cols.cpu().numpy(), iop.vals.cpu().numpy()

    def ell_block(k):
        lo = k * ICE_BLOCK
        blk = np.zeros((ICE_BLOCK, ICE_BLOCK))
        c, v = cols[lo:lo + ICE_BLOCK], vals[lo:lo + ICE_BLOCK]
        keep = (v != 0) & (c >= lo) & (c < lo + ICE_BLOCK)
        rows = np.nonzero(keep)[0]
        np.add.at(blk, (rows, c[keep] - lo), v[keep])
        return blk

    bj, bj_rec = block_jacobi(ikop, ICE_BLOCK, ell_block)
    bj_rec.update(reach=bandwidth(iop), n_colors=min(
        -(-bandwidth(iop) // ICE_BLOCK) + 2, iop.n // ICE_BLOCK))
    ib = torch.tensor(np.random.default_rng(0).standard_normal(iop.n),
                      device=dev)
    ice_rec = {"n": iop.n, "blockjacobi": bj_rec}
    for name, prec in (("blockjacobi", bj),
                       ("jacobi", JacobiPrec.from_operator(iop))):
        sig = shifts_for_operator(iop, 2, prec=prec)
        ice_rec[name + "_solves"] = {
            "cg": solve(ikop, iop, ib, prec, "cg", maxit=2000),
            "pcg": solve(ikop, iop, ib, prec, "pcg", maxit=2000),
            "plcg_l2_unfused": solve(ikop, iop, ib, prec, "plcg", l=2,
                                     sigmas=sig, maxit=2000)}
    emit({"phase": "baselines", "problem": "icesheet3d", "gpu": gpu,
          **ice_rec})
    del bj, ikop

    # ---- icesheet3d-stencil: classic CG with z-line block-Jacobi --------
    pop3 = Stencil3D7(ice.nx, ice.ny, ice.nz, eps_z=ice.eps_z, device=dev)
    kop3 = dataclasses.replace(pop3, use_kernel=True)
    line = (np.diag(np.full(ice.nz, 4.0 + 2.0 * ice.eps_z))
            - ice.eps_z * (np.eye(ice.nz, k=1) + np.eye(ice.nz, k=-1)))
    bj3, bj3_rec = block_jacobi(kop3, ice.nz, lambda k: line)
    bj3_rec.update(block_index="z (the fastest index: one grid line a block)",
                   reach=ice.nz, n_colors=3)
    b3 = torch.tensor(np.random.default_rng(1).standard_normal(pop3.n),
                      device=dev)
    st_rec = {"n": pop3.n, "blockjacobi": bj3_rec,
              "cg": solve(kop3, pop3, b3, bj3, "cg", maxit=20000)}
    emit({"phase": "baselines", "problem": ice.name, "gpu": gpu, **st_rec})
    del bj3
    torch.cuda.empty_cache()

    launches = {
        "stencil2d5": sum(lap_rec[m]["launches"].get("stencil2d5", 0)
                          for m in ("cg", "pcg")),
        "ell_spmv": sum(r["launches"].get("ell_spmv", 0)
                        for key in ("blockjacobi_solves", "jacobi_solves")
                        for r in ice_rec[key].values()),
        "stencil3d7": st_rec["cg"]["launches"].get("stencil3d7", 0)}
    for k, v in launches.items():
        if v == 0:
            failed.append(f"{k} never launched")
    if failed:
        raise AssertionError(f"baselines failed: {failed}")
    return launches


N_RANKS = 4                     # gloo ranks sharing the one card
WIRE_TAIL = 1e-8                # ELL: monolithic vs staged, whole history


def distributed_phase(lap_op, lap_prec, lap_b, solve_kw, main, main_digest,
                      iop, iprec, ib, ice_kw, ice_main) -> dict:
    """p(l)-CG over real ranks through ``MultiprocessBackend``: ranks
    started by ``launch_fabric`` (``python -m repro_torch.parallel.worker``),
    each building the configs' operators itself.

    * World of 1 over NCCL: ``laplace2d`` with ``main_solve``'s settings
      (monolithic: one async ``all_reduce`` a dot block), against
      ``main_solve``'s updates and restarts; ``icesheet3d``, fused.
    * 4 ranks over gloo sharing the card (``pg_backend="gloo"``: NCCL
      refuses two ranks on one GPU), every payload through pinned host
      buffers: ``laplace2d`` 200 updates (tol 1e-30) staged with 2 stages,
      bitwise against the fused ranks' reference in one process
      (``parallel.distributed.rank_oracle_ops``, 4 virtual shards), and
      monolithic within ORACLE_HIST of it; ``icesheet3d`` (RCM-ordered)
      the same to convergence (monolithic: head ORACLE_HIST, all
      WIRE_TAIL); its ``use_kernel`` operator unfused through ``ell_spmv``,
      bitwise against ``LocalBackend(reduction="staged",
      virtual_shards=4)``; the split-KV decode merge at
      ``decode_32k``'s heads (each rank 8 192 of the 32 768 positions)
      against the single-process ``merge_decode_shards`` within 1e-6.
    * Every fused run launches its halo plug-in once a vector phase on
      every rank (no unfused route where a fused one exists).

    Returns the ranks' kernel launches summed, by kernel."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import METHODS
    from repro_torch.kernels import ops as kops
    from repro_torch.models.attention import merge_decode_shards
    from repro_torch.parallel.backends import LocalBackend
    from repro_torch.parallel.distributed import rank_oracle_ops
    from repro_torch.parallel.fabric import launch_fabric
    from repro_torch.parallel.reduction import StagedConfig
    from repro_torch.parallel.worker import decode_split

    tmp = tempfile.mkdtemp(prefix="chip-smoke-ranks-")
    lap_npz, ice_npz = os.path.join(tmp, "lap.npz"), os.path.join(tmp,
                                                                 "ice.npz")
    np.savez(lap_npz, b=lap_b.cpu().numpy(),
             sig=solve_kw["sigmas"].cpu().numpy())
    np.savez(ice_npz, b=ib.cpu().numpy(), sig=ice_kw["sigmas"].cpu().numpy())
    lap_kw = {k: v for k, v in solve_kw.items() if k != "sigmas"}
    ice_solver = {k: v for k, v in ice_kw.items() if k != "sigmas"}
    short = dict(lap_kw, maxit=200, tol=1e-30)

    def task(name, cfg, npz, solver, red="monolithic", use_kernel=None):
        op_spec = {"config": cfg}
        if use_kernel is not None:
            op_spec["use_kernel"] = use_kernel
        return {"kind": "solve", "name": name, "operator": op_spec,
                "rhs": {"npz": npz, "key": "b"},
                "sigmas": {"npz": npz, "key": "sig"}, "method": "plcg",
                "reduction": red, "stages": 2,
                "solver": solver}

    def run_group(tag, p, pg, tasks):
        out = os.path.join(tmp, tag)
        os.makedirs(out)
        spec = os.path.join(out, "spec.json")
        with open(spec, "w") as f:
            json.dump({"backend": {"device": "cuda", "pg_backend": pg},
                       "out_dir": out, "threads": 2, "tasks": tasks}, f)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launch_fabric(lambda master, k: [sys.executable, "-m",
                                         "repro_torch.parallel.worker", spec],
                      p, env=dict(os.environ,
                                  PYTHONPATH=os.path.join(ROOT, "src")),
                      cwd=ROOT, timeout_s=400, build_kernels=True)
        group_s = time.perf_counter() - t0
        got = {}
        for t in tasks:
            recs = []
            for r in range(p):
                with open(os.path.join(out, f"{t['name']}.rank{r}.json")) as f:
                    recs.append(json.load(f))
            got[t["name"]] = (recs, dict(np.load(os.path.join(
                out, t["name"] + ".npz"))))
        return got, group_s

    def summary(recs, halo_key=None):
        r0 = recs[0]
        wc = r0["wire_counts"]
        phases = r0["vector_phases"] or r0["iters"]
        rec = {"wire": r0["describe"], "world": r0["world"],
               "converged": r0["converged"], "iters": r0["iters"],
               "restarts": r0["restarts"],
               "wall_s": max(r["wall_s"] for r in recs),
               "vector_phases": r0["vector_phases"],
               "ms_per_iter": 1e3 * max(r["wall_s"] for r in recs)
               / max(phases, 1),
               "host_syncs_per_iter": (r0["host_syncs"]
                                       + wc["staging_host_syncs"])
               / max(phases, 1),
               "halo_bytes_per_iter": wc["bytes_sent"].get("halo", 0)
               / max(phases, 1),
               "hop_bytes_per_iter": wc["bytes_sent"].get("hop", 0)
               / max(phases, 1),
               "all_reduce_bytes_per_iter":
                   wc["bytes_sent"].get("all_reduce", 0) / max(phases, 1),
               "setup_s": max(r["setup_s"] for r in recs),
               "ranks_agree_bitwise": len({(r["x_sha256"],
                                            r["history_sha256"])
                                           for r in recs}) == 1,
               "true_rel_residual": r0.get("true_rel_residual"),
               "launches_by_rank": [r["launches"] for r in recs]}
        if halo_key is not None:
            rec["halo_plugin_every_phase"] = all(
                r["launches"].get(halo_key, 0) == r["vector_phases"] > 0
                and set(r["launches"]) == {halo_key} for r in recs)
        return rec

    def same(arr, res):
        return bool(np.array_equal(arr["x"], res.x.cpu().numpy())
                    and np.array_equal(arr["res_history"],
                                       res.res_history.cpu().numpy()))

    dtask = dict(kind="decode_merge", name="decode", seed=11, block_s=512,
                 B=16, H=16, Hkv=8, D=128, S=32768, kv_len=30001)
    try:
        # ---- a world of one rank over NCCL ----------------------------
        w1, w1_s = run_group("w1", 1, "nccl", [
            task("lap", "laplace2d", lap_npz, lap_kw),
            task("ice", "icesheet3d", ice_npz, ice_solver)])
        lap1 = summary(w1["lap"][0], "fused_iter_halo")
        lap1["bitwise_vs_main_solve"] = (
            w1["lap"][0][0]["x_sha256"], w1["lap"][0][0]["history_sha256"]
        ) == main_digest
        lap1["main_solve"] = {k: main[k] for k in
                              ("iters", "restarts", "ms_per_iter",
                               "host_syncs_per_iter", "wall_s")}
        ice1 = summary(w1["ice"][0], "fused_iter_ell_halo")
        ice1["icesheet_solve"] = ice_main

        # ---- 4 ranks over gloo on the one card ------------------------
        g4, g4_s = run_group("g4", N_RANKS, "gloo", [
            task("lap_staged", "laplace2d", lap_npz, short, "staged"),
            task("lap_mono", "laplace2d", lap_npz, short),
            task("ice_staged", "icesheet3d", ice_npz, ice_solver, "staged"),
            task("ice_mono", "icesheet3d", ice_npz, ice_solver),
            task("ice_kernel", "icesheet3d", ice_npz,
                 dict(ice_solver, fused_iteration=False), "staged", True),
            dtask])

        ref_s = {}

        def oracle(op_, b_, prec_, kw, name):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kw.get("fused_iteration", True):
                res = METHODS["plcg"](rank_oracle_ops(
                    op_, prec_, StagedConfig(N_RANKS, stages=2)), b_, kw)
            else:
                res = LocalBackend(reduction="staged", virtual_shards=N_RANKS,
                                   reduction_stages=2).solve(
                    op_, b_, prec=prec_, **kw)
            torch.cuda.synchronize()
            ref_s[name] = time.perf_counter() - t0
            return res

        recs = {k: summary(v[0], {"lap_staged": "fused_iter_halo",
                                  "lap_mono": "fused_iter_halo",
                                  "ice_staged": "fused_iter_ell_halo",
                                  "ice_mono": "fused_iter_ell_halo"}.get(k))
                for k, v in g4.items() if k != "decode"}
        o_lap = oracle(lap_op, lap_b, lap_prec, dict(solve_kw, maxit=200,
                                                    tol=1e-30), "lap_staged")
        recs["lap_staged"]["bitwise_vs_oracle"] = same(g4["lap_staged"][1],
                                                       o_lap)
        head, tail = history_head_tail(g4["lap_mono"][1]["res_history"],
                                       o_lap.res_history.cpu().numpy(),
                                       float(o_lap.norm0))
        recs["lap_mono"]["history_vs_staged"] = {"head_max": head,
                                                 "max": tail}
        del o_lap
        o_ice = oracle(iop, ib, iprec, ice_kw, "ice_staged")
        recs["ice_staged"]["bitwise_vs_oracle"] = same(g4["ice_staged"][1],
                                                       o_ice)
        head, tail = history_head_tail(g4["ice_mono"][1]["res_history"],
                                       o_ice.res_history.cpu().numpy(),
                                       float(o_ice.norm0))
        recs["ice_mono"]["history_vs_staged"] = {"head_max": head,
                                                 "max": tail}
        kop = dataclasses.replace(iop, use_kernel=True)
        o_k = oracle(kop, ib, iprec, dict(ice_kw, fused_iteration=False),
                     "ice_kernel")
        recs["ice_kernel"]["bitwise_vs_oracle"] = same(g4["ice_kernel"][1],
                                                       o_k)
        recs["ice_kernel"]["ell_spmv_by_rank"] = [
            r["launches"].get("ell_spmv", 0) for r in g4["ice_kernel"][0]]
        del o_ice, o_k
        for name, sec in ref_s.items():
            phases = recs[name]["vector_phases"] or recs[name]["iters"]
            recs[name]["reference_in_one_process"] = {
                "wall_s": sec, "ms_per_iter": 1e3 * sec / max(phases, 1)}

        drecs, darr = g4["decode"]
        splits = [decode_split(r, N_RANKS, dtask, torch.device("cuda"))
                  for r in range(N_RANKS)]
        stats = [kops.decode_attention_stats(q, k, v, kv, dtask["block_s"])
                 for q, k, v, kv in splits]
        merged = merge_decode_shards(*(torch.stack(t) for t in zip(*stats)))
        dec_err = float(np.abs(darr["out"] - merged.reshape(
            splits[0][0].shape).cpu().numpy()).max())
        decode = {"shape": {k: dtask[k] for k in ("B", "H", "Hkv", "D",
                                                  "S", "kv_len")},
                  "max_abs_diff_vs_single_process_merge": dec_err,
                  "bound": 1e-6, "wall_s": max(r["wall_s"] for r in drecs),
                  "all_reduce_messages": drecs[0]["wire_counts"]["messages"],
                  "launches_by_rank": [r["launches"] for r in drecs]}
        del splits, stats, merged
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"phase": "distributed_solve",
           "world1_nccl": {"group_s": w1_s, "laplace2d": lap1,
                           "icesheet3d": ice1},
           "gloo_4_ranks_one_card": {"group_s": g4_s, **recs,
                                     "decode_merge": decode},
           "bounds": {"mono_vs_staged_history": ORACLE_HIST,
                      "ell_mono_vs_staged_all": WIRE_TAIL,
                      "decode": 1e-6}}
    emit(rec)
    fused = [lap1, ice1] + [recs[k] for k in ("lap_staged", "lap_mono",
                                              "ice_staged", "ice_mono")]
    checks = {
        "world1_laplace_converged": lap1["converged"]
        and lap1["true_rel_residual"] < 10 * TOL,
        "world1_laplace_as_main_solve": lap1["iters"] == main["iters"]
        and lap1["restarts"] == main["restarts"],
        "world1_icesheet_converged": ice1["converged"]
        and ice1["true_rel_residual"] < 10 * TOL,
        "halo_plugins_every_phase": all(r["halo_plugin_every_phase"]
                                        for r in fused),
        "ranks_agree": all(r["ranks_agree_bitwise"]
                           for r in recs.values()),
        "staged_bitwise": all(recs[k]["bitwise_vs_oracle"] for k in
                              ("lap_staged", "ice_staged", "ice_kernel")),
        "lap_mono_close": recs["lap_mono"]["history_vs_staged"]["max"]
        <= ORACLE_HIST,
        "ice_converged": recs["ice_staged"]["converged"]
        and recs["ice_mono"]["converged"]
        and abs(recs["ice_mono"]["iters"] - recs["ice_staged"]["iters"]) <= 2,
        "ice_mono_close": recs["ice_mono"]["history_vs_staged"]["head_max"]
        <= ORACLE_HIST and recs["ice_mono"]["history_vs_staged"]["max"]
        <= WIRE_TAIL,
        "ell_spmv_every_rank": min(recs["ice_kernel"]["ell_spmv_by_rank"])
        > 0,
        "decode_merge": dec_err <= 1e-6,
    }
    emit({"phase": "distributed_checks", **checks})
    if not all(checks.values()):
        raise AssertionError("distributed solve failed: " + ", ".join(
            k for k, v in checks.items() if not v))
    total: dict = {}
    for group in (w1, g4):
        for recs_, _ in group.values():
            for r in recs_:
                for k, v in r["launches"].items():
                    total[k] = total.get(k, 0) + v
    return total


# Results of the one-device paths that phase 21 holds its runs over ranks
# against (digests of x, histories, rings; per request of the service).
REFS: dict = {}

SLAB_S = 8                      # batched_serve: the slab width
SLAB_WIDE = 32                  # batched_serve: the wide ice-sheet slab
SERVE_REQUESTS = 16             # batched_serve: requests served at 2048^2
BATCH_SEED = 22                 # batched_serve: columns 1.. and the traces
SLAB_HISTORY_RTOL = 1e-10       # batched_serve: slab fused vs unfused
# histories (the superkernel sums a column's partials in its own order,
# torch's unfused sum in another: 1.7e-12 apart on an H100 at 2048^2)


def slab_kernel_checks(dev, randn, phase_scal, lap, ice, op, prec, iop,
                       iprec, widths=(1, SLAB_S),
                       ell_widths=(1, SLAB_S, SLAB_WIDE)) -> tuple[dict, dict]:
    """The slab forms of the superkernel (stencil and ELL plug-ins),
    ``stencil2d5``/``stencil3d7`` and ``ell_spmv`` at each slab width of
    ``widths`` (the two ELL kernels at ``ell_widths``), on the main path's
    shapes: bitwise against their plain versions (the superkernel's
    partials within PARTIAL_BOUND of the plain sums, and each column's
    rows and partials bitwise its single-column launch's), then their
    device times, the single-column kernel's time times s, the bound and a
    library yardstick where one exists.  Returns (errors, timings), keyed
    ``<kernel>_s<width>``."""
    import torch

    from repro_torch.kernels import ell_spmv, fused_iter as fi
    from repro_torch.kernels import ops as kops, ref, stencil_spmv

    errs, timings, failed = {}, {}, []

    def row(name, s, err, same, run, single, plain, nbytes, library=None):
        errs[f"{name}_s{s}"] = err
        if not same:
            failed.append(f"{name}_s{s}")
        t = {"s": s, "bitwise_equal": same, "max_abs_err": err,
             "ms": cuda_ms(run), "device_ms": device_ms(run),
             "single_column_ms": cuda_ms(single),
             "plain_ms": cuda_ms(plain, reps=3),
             "library_ms": None if library is None else cuda_ms(library),
             **bound_fields(nbytes, 0.0)}
        t["s_times_single_column_ms"] = s * t["single_column_ms"]
        timings[f"{name}_s{s}"] = t

    def ell_spmv_slab_row(s):
        """``ell_spmv`` over a slab of s vectors against its plain version
        and, row by row, the single-vector launch; cuSPARSE's CSR by an
        (n, s) block as the yardstick."""
        X = randn(s, iop.n)
        got = ell_spmv.ell_spmv(X, iop.cols, iop.vals)
        want = ell_spmv.ell_spmv_plain(X, iop.cols, iop.vals)
        keep = iop.vals != 0
        crow = torch.zeros(iop.n + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(keep.sum(dim=1), 0)
        csr = torch.sparse_csr_tensor(crow, iop.cols[keep].long(),
                                      iop.vals[keep], size=(iop.n, iop.n))
        Xt = X.T.contiguous()
        rows_same = all(bool(torch.equal(got[c], ell_spmv.ell_spmv(
            X[c], iop.cols, iop.vals))) for c in range(s))
        row("ell_spmv_slab", s, float((got - want).abs().max()),
            bool(torch.equal(got, want)) and rows_same,
            lambda: ell_spmv.ell_spmv(X, iop.cols, iop.vals),
            lambda: ell_spmv.ell_spmv(X[0], iop.cols, iop.vals),
            lambda: ell_spmv.ell_spmv_plain(X, iop.cols, iop.vals),
            iop.cols.numel() * 4 + iop.vals.numel() * 8 + 2 * X.numel() * 8,
            lambda: torch.sparse.mm(csr, Xt))
        timings[f"ell_spmv_slab_s{s}"]["library_max_abs_diff"] = float(
            (torch.sparse.mm(csr, Xt).T - got).abs().max())
        del X, Xt, got, want, csr
        torch.cuda.empty_cache()

    for s in sorted(set(widths) | set(ell_widths)):
        # ---- the superkernel's slab form, stencil and ELL plug-ins
        for name, sop, sprec in (("fused_iter_slab", op, prec),
                                 ("fused_iter_ell_slab", iop, iprec)):
            if s not in (ell_widths if sop is iop else widths):
                continue
            layout = fi.SlabLayout(l=2, RB=3)
            fiter = kops.fused_iteration_factory(sop, sprec)(layout)
            # each column at its own cycle index, fills and steady state
            hosts = [fi.host_idx(layout, i) for i in
                     [2 * layout.l + 3 + c for c in range(s - 1)] + [1]][:s]
            idx = torch.tensor(hosts, dtype=torch.int32, device=dev)
            scal = torch.stack([phase_scal(2) for _ in range(s)])
            S = randn(s, layout.nv, sop.n) * 1e-3
            S_p, d_p = fiter.plain(S, idx, scal)
            S_k, d_k = fiter(S.clone(), idx, scal)
            torch.cuda.synchronize()
            same = bool(torch.equal(S_k, S_p))
            part, single_same = 0.0, True
            for c in range(s):
                _, mat, u = ref.fused_iter_unfused(
                    S[c], idx[c], scal[c], sop.apply, sprec.apply, layout)
                scale = (mat.abs() * u.abs()[None, :]).sum(dim=1)
                part = max(part, float(((d_k[c] - d_p[c]).abs()
                                        / scale).max()))
                S_1, d_1 = fiter(S[c].clone(), idx[c], scal[c])
                single_same = single_same and bool(
                    torch.equal(S_1, S_k[c]) and torch.equal(d_1, d_k[c]))
                del S_1, mat, u
            same = same and part <= PARTIAL_BOUND and single_same
            del S_k, S_p
            nbytes = sum(fi.min_bytes(layout, h, sop.n, has_prec=False,
                                      has_diag=False) for h in hosts) \
                + 8 * sop.n + fiter.spmv.operand_bytes
            row(name, s, part, same, lambda: fiter(S, idx, scal),
                lambda: fiter(S[0], idx[0], scal[0]),
                lambda: fiter.plain(S, idx, scal), nbytes)
            timings[f"{name}_s{s}"]["partials_max_diff_over_abs_sum"] = part
            timings[f"{name}_s{s}"]["columns_bitwise_vs_single_launches"] = \
                single_same
            del S
        if s in ell_widths:
            ell_spmv_slab_row(s)
        # ---- the stencils over a slab of s grids
        if s not in widths:
            continue
        g2 = randn(s, lap.nx, lap.ny)
        w2 = torch.tensor([[0., -1., 0.], [-1., 4., -1.], [0., -1., 0.]],
                          dtype=torch.float64, device=dev)[None, None]
        got = stencil_spmv.stencil2d5(g2)
        want = stencil_spmv.stencil2d5_plain(g2)
        row("stencil2d5_slab", s, float((got - want).abs().max()),
            bool(torch.equal(got, want)), lambda: stencil_spmv.stencil2d5(g2),
            lambda: stencil_spmv.stencil2d5(g2[0]),
            lambda: stencil_spmv.stencil2d5_plain(g2), 2 * g2.numel() * 8,
            lambda: torch.nn.functional.conv2d(g2[:, None], w2, padding=1))
        del g2, got, want
        g3 = randn(s, ice.nx, ice.ny, ice.nz)
        w3 = torch.zeros((3, 3, 3), dtype=torch.float64, device=dev)
        w3[1, 1, 1] = 4.0 + 2.0 * ice.eps_z
        w3[0, 1, 1] = w3[2, 1, 1] = w3[1, 0, 1] = w3[1, 2, 1] = -1.0
        w3[1, 1, 0] = w3[1, 1, 2] = -ice.eps_z
        got = stencil_spmv.stencil3d7(g3, ice.eps_z)
        want = stencil_spmv.stencil3d7_plain(g3, ice.eps_z)
        row("stencil3d7_slab", s, float((got - want).abs().max()),
            bool(torch.equal(got, want)),
            lambda: stencil_spmv.stencil3d7(g3, ice.eps_z),
            lambda: stencil_spmv.stencil3d7(g3[0], ice.eps_z),
            lambda: stencil_spmv.stencil3d7_plain(g3, ice.eps_z),
            2 * g3.numel() * 8,
            lambda: torch.nn.functional.conv3d(g3[:, None], w3[None, None],
                                               padding=1))
        del g3, got, want
    if failed:
        raise AssertionError(f"slab kernels differ from their plain "
                             f"versions: {failed}")
    return errs, timings


def batched_serve_phase(dev, gpu, randn, phase_scal, lap, ice, op, prec, b,
                        solve_kw, main, main_digest, iop, iprec, ib,
                        ice_kw, ice_main,
                        ice_digest) -> tuple[dict, dict, dict]:
    """Phase 16, batched multi-RHS solves and the serve layer on the card:

    1. ``LocalBackend.solve_batched`` at laplace2d 2048^2 with phase 3's
       settings (p(2)-CG, Jacobi, fused) for a slab of ``SLAB_S``
       right-hand sides, column 0 phase 3's b: every column converges
       below 10 tol, column 0 takes phase 3's updates (and is compared with
       it bit for bit), with the slab's ms per slab iteration and per
       column iteration, host syncs, scalar-phase groups and a profiler
       split per slab iteration; the same for icesheet3d (the ELL
       plug-in; column 0 bitwise equal to phase 7's solve, x and history)
       and a slab of ``SLAB_WIDE`` ice-sheet right-hand sides;
    2. the same slab fused and unfused for 200 updates (iterations equal,
       histories within SLAB_HISTORY_RTOL; bitwise reported);
    3. the slab kernels at s in {1, SLAB_S}, the ELL ones also at
       ``SLAB_WIDE`` (``slab_kernel_checks``);
    4. ``SolverService`` on ``Stencil2D5(use_kernel=True)`` 2048^2 with
       Jacobi, s = SLAB_S, chunk_iters 64, under a ``VirtualClock``: a
       seeded Poisson trace of ``SERVE_REQUESTS`` requests at tol 1e-6,
       each retired solve held against the operator; and batched CG
       through the ``stencil3d7`` and ``ell_spmv`` slab forms, bitwise
       against the plain operators;
    5. the replay of ``BENCH_serve.json`` (32 x 24, 128 arrivals at
       1600/s, its two traffic classes), each ``replay_*`` column beside
       the JSON's (a record, not a check).

    Returns (launches, errors, timings) for the ``kernels`` line."""
    import numpy as np
    import torch

    from repro_torch.core import pipelined_cg
    from repro_torch.kernels import _build
    from repro_torch.linalg import JacobiPrec, Stencil2D5, Stencil3D7
    from repro_torch.parallel.backends import LocalBackend
    from repro_torch.parallel.worker import digest
    from repro_torch.serve import (AdmissionPolicy, SolverService,
                                   TrafficClass, VirtualClock, poisson_trace,
                                   replay)

    t_phase = time.perf_counter()
    be = LocalBackend(device=dev)
    launches, failed = {}, []
    rng = np.random.default_rng(BATCH_SEED)

    def slab_of(first, n, s=SLAB_S):
        B = torch.empty((s, n), dtype=torch.float64, device=dev)
        B[0] = first
        B[1:] = torch.tensor(rng.standard_normal((s - 1, n)), device=dev)
        return B

    def true_rel(aop, B, X):
        return (torch.linalg.norm(B - aop.apply(X), dim=1)
                / torch.linalg.norm(B, dim=1)).tolist()

    def batched(name, aop, aprec, B, kw, key, seq):
        """One batched solve against ``seq``, the sequential solve of
        column 0: its ms per vector phase, and its ms per update beside
        the slab's (their ratio is the update rate's gain, every column's
        updates counted once and a finished column's predicated slab
        iterations not at all)."""
        torch.cuda.synchronize()
        _build.reset_launches()
        pipelined_cg.SCALAR_GROUPS.clear()
        t0 = time.perf_counter()
        r = be.solve_batched(aop, B, prec=aprec, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lz = dict(_build.LAUNCHES)
        slab_iters = lz.get(key, 0)
        rel = true_rel(aop, B, r.x)
        updates = int(r.iters.sum())
        s = B.shape[0]
        rec = {"s": s, "iters": r.iters.tolist(),
               "restarts": r.restarts.tolist(),
               "converged": r.converged.tolist(), "true_rel_residual": rel,
               "slab_iterations": slab_iters, "wall_s": wall,
               "ms_per_slab_iteration": 1e3 * wall / max(slab_iters, 1),
               "ms_per_column_iteration": 1e3 * wall
               / max(slab_iters * s, 1),
               "ms_per_update": 1e3 * wall / max(updates, 1),
               "sequential_ms_per_vector_phase": seq["ms_per_iter"],
               "sequential_ms_per_update": seq["ms_per_update"],
               "update_rate_vs_sequential": seq["ms_per_update"]
               / max(1e3 * wall / max(updates, 1), 1e-30),
               "host_syncs": r.host_syncs,
               "host_syncs_per_slab_iteration": r.host_syncs
               / max(slab_iters, 1),
               "scalar_phase_groups": {str(k): v for k, v in sorted(
                   pipelined_cg.SCALAR_GROUPS.items())},
               "max_scalar_phase_groups": max(pipelined_cg.SCALAR_GROUPS,
                                              default=0),
               "launches": lz}
        launches[key] = launches.get(key, 0) + slab_iters
        if not (all(rec["converged"]) and max(rel) < 10 * TOL) \
                or slab_iters == 0 or lz.get(key.replace("_slab", ""), 0):
            failed.append(name)
        return r, rec

    out = {"phase": "batched_serve", "gpu": gpu, "s": SLAB_S}
    # ---- 1. batched fused solves --------------------------------------
    B = slab_of(b, op.n)
    r, rec = batched("laplace2d", op, prec, B, solve_kw, "fused_iter_slab",
                     dict(main, ms_per_update=1e3 * main["wall_s"]
                          / max(main["iters"], 1)))
    rec["column0_iters_vs_main"] = [rec["iters"][0], main["iters"]]
    rec["column0_bitwise_vs_main"] = (digest(r.x[0]), digest(
        r.res_history[0])) == main_digest
    if rec["iters"][0] != main["iters"]:
        failed.append("column 0 vs main_solve")
    out["laplace2d"] = rec
    del r
    prof_kw = dict(solve_kw, maxit=100, tol=1e-30)
    be.solve_batched(op, B, prec=prec, **prof_kw)
    _build.reset_launches()
    split = device_split(lambda: be.solve_batched(op, B, prec=prec,
                                                  **prof_kw),
                         ("fused_iter_kernel", "copy_row", "sum_partials"))
    out["laplace2d_split"] = per_iter(split,
                                      _build.LAUNCHES["fused_iter_slab"])
    IB = slab_of(ib, iop.n)
    r, rec = batched("icesheet3d", iop, iprec, IB, ice_kw,
                     "fused_iter_ell_slab", ice_main)
    rec["column0_iters_vs_icesheet_solve"] = [rec["iters"][0],
                                              ice_main["iters"]]
    rec["column0_bitwise_vs_icesheet_solve"] = (digest(r.x[0]), digest(
        r.res_history[0])) == ice_digest
    if not rec["column0_bitwise_vs_icesheet_solve"]:
        failed.append("icesheet3d column 0 vs icesheet_solve")
    out["icesheet3d"] = rec
    del r
    prof_ice = dict(ice_kw, maxit=100, tol=1e-30)
    be.solve_batched(iop, IB, prec=iprec, **prof_ice)
    _build.reset_launches()
    split = device_split(lambda: be.solve_batched(iop, IB, prec=iprec,
                                                  **prof_ice),
                         ("fused_iter_kernel", "copy_row", "sum_partials"))
    out["icesheet3d_split"] = per_iter(
        split, _build.LAUNCHES["fused_iter_ell_slab"])
    r, rec = batched(f"icesheet3d_s{SLAB_WIDE}", iop, iprec,
                     slab_of(ib, iop.n, SLAB_WIDE), ice_kw,
                     "fused_iter_ell_slab", ice_main)
    out[f"icesheet3d_s{SLAB_WIDE}"] = rec
    del r, IB

    # ---- 2. fused against unfused, 200 updates ------------------------
    short = dict(solve_kw, maxit=200, tol=1e-30)
    r_f = be.solve_batched(op, B, prec=prec, **short)
    r_u = be.solve_batched(op, B, prec=prec,
                           **dict(short, fused_iteration=False))
    h_f, h_u = r_f.res_history.cpu().numpy(), r_u.res_history.cpu().numpy()
    ok = h_u >= 0
    hist_rel = float(np.max(np.abs(h_f[ok] - h_u[ok]) / np.abs(h_u[ok])))
    out["fused_vs_unfused_200"] = {
        "iters": [r_f.iters.tolist(), r_u.iters.tolist()],
        "history_max_rel_diff": hist_rel, "rtol": SLAB_HISTORY_RTOL,
        "bitwise": bool(torch.equal(r_f.res_history, r_u.res_history)
                        and torch.equal(r_f.x, r_u.x))}
    if r_f.iters.tolist() != r_u.iters.tolist() or \
            not hist_rel <= SLAB_HISTORY_RTOL:
        failed.append("fused vs unfused")
    del r_f, r_u, B
    torch.cuda.empty_cache()

    # ---- 3. the slab kernels ------------------------------------------
    errs, timings = slab_kernel_checks(dev, randn, phase_scal, lap, ice, op,
                                       prec, iop, iprec)
    out["kernels"] = timings

    # ---- 4. serve at full width, and the other slab SPMVs on solves ----
    kop = Stencil2D5(lap.nx, lap.ny, use_kernel=True, device=dev)
    svc = SolverService(be, s=SLAB_S, method="cg", chunk_iters=64,
                        maxit=20000, prec="jacobi", clock=VirtualClock())
    svc.register_operator("laplace2d", kop)
    trace = poisson_trace([TrafficClass("laplace2d", kop.n, tol=TOL)],
                          rate_per_s=1000.0, n_requests=SERVE_REQUESTS,
                          seed=BATCH_SEED)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    rep = replay(svc, trace, iter_time_s=1e-3, tick_overhead_s=1e-3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["stencil2d5_slab"] = _build.LAUNCHES["stencil2d5_slab"]
    rels = []
    for rid, arr in enumerate(trace):
        res = svc.results[rid]
        bb = torch.as_tensor(arr.b, device=dev)
        x = torch.as_tensor(res.x, device=dev)
        rels.append(float(torch.linalg.norm(bb - op.apply(x))
                          / torch.linalg.norm(bb)))
    out["serve"] = {"method": "cg", "requests": SERVE_REQUESTS,
                    "wall_s": wall, "report": rep.metrics(),
                    "iters": [svc.results[i].iters
                              for i in range(len(trace))],
                    "true_rel_residual_max": max(rels),
                    "stats": {k: v for k, v in svc.stats().items()
                              if k != "setup_cache"},
                    "launches": dict(_build.LAUNCHES)}
    if rep.n_converged != SERVE_REQUESTS or not max(rels) < 10 * TOL \
            or launches["stencil2d5_slab"] == 0:
        failed.append("serve")
    REFS["serve_2048"] = {str(rid): [svc.results[rid].iters, digest(
        torch.as_tensor(svc.results[rid].x))] for rid in range(len(trace))}
    del svc

    def kernel_cg(name, kop_, pop_, n, iters, key):
        """Batched CG through a slab SPMV, bitwise against the plain
        operator's batched CG."""
        Bk = torch.tensor(rng.standard_normal((SLAB_S, n)), device=dev)
        pj = JacobiPrec.from_operator(pop_)
        kw = dict(method="cg", prec=pj, tol=TOL if iters is None
                  else 1e-30, maxit=iters or 2000, unroll=16)
        _build.reset_launches()
        t0 = time.perf_counter()
        rk = be.solve_batched(kop_, Bk, **kw)
        torch.cuda.synchronize()
        wall_ = time.perf_counter() - t0
        n_l = _build.LAUNCHES[key]
        rp = be.solve_batched(pop_, Bk, **kw)
        same = bool(torch.equal(rk.x, rp.x)
                    and torch.equal(rk.res_history, rp.res_history))
        launches[key] = n_l
        out[name] = {"iters": rk.iters.tolist(), "launches": n_l,
                     "wall_s": wall_, "bitwise_equal_to_plain": same}
        if not same or n_l == 0:
            failed.append(name)

    kernel_cg("cg_stencil3d7_slab",
              Stencil3D7(ice.nx, ice.ny, ice.nz, eps_z=ice.eps_z,
                         use_kernel=True, device=dev),
              Stencil3D7(ice.nx, ice.ny, ice.nz, eps_z=ice.eps_z,
                         device=dev), ice.nx * ice.ny * ice.nz, 300,
              "stencil3d7_slab")
    kernel_cg("cg_ell_spmv_slab", dataclasses.replace(iop, use_kernel=True),
              iop, iop.n, None, "ell_spmv_slab")

    # ---- 5. the BENCH_serve.json replay --------------------------------
    bop = Stencil2D5(32, 24, device=dev)
    classes = [TrafficClass("bench", bop.n, weight=4.0, tol=1e-6,
                            deadline_s=1.0),
               TrafficClass("bench", bop.n, weight=1.0, tol=1e-10,
                            deadline_s=4.0)]
    btrace = poisson_trace(classes, rate_per_s=1600.0, n_requests=128,
                           seed=0)

    def bench_run(continuous):
        svc_ = SolverService(be, s=8, method="plcg", l=2, chunk_iters=8,
                             maxit=600, clock=VirtualClock(),
                             admission=AdmissionPolicy(max_pending=64),
                             max_replicas=2, replicate_watermark=1.0,
                             continuous=continuous)
        svc_.register_operator("bench", bop)
        t0_ = time.perf_counter()
        rep_ = replay(svc_, btrace, iter_time_s=1e-4, tick_overhead_s=1e-4)
        return svc_, rep_, time.perf_counter() - t0_

    svc_c, rep_c, wall_c = bench_run(True)
    _svc_d, rep_d, wall_d = bench_run(False)
    got = rep_c.metrics()
    got["replay_slot_utilization_drain"] = rep_d.slot_utilization
    st = svc_c.stats()
    got["replay_workers"], got["replay_stolen"] = st["workers"], st["stolen"]
    with open(os.path.join(ROOT, "BENCH_serve.json")) as f:
        bench = json.load(f)
    out["bench_serve_replay"] = {
        "columns": {k: [v, bench.get(k)] for k, v in got.items()},
        "columns_order": ["port (LocalBackend, this card)",
                          "BENCH_serve.json (JAX, 8-device host mesh)"],
        "wall_s": [wall_c, wall_d]}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if failed:
        raise AssertionError(f"batched_serve failed: {failed}")
    return launches, errs, timings


# Phase 17 (stability): the telemetry ring, the governor, payload chaos and
# the depth ladder.
TEL_CAP = 512                   # stability: ring rows of the 2048^2 solves
# stability: updates of each timed turn (2 000 until phase 21 came; cut
# for the time limit, the turns' order and checks kept)
TURN_UPDATES = 1000
PROFILE_MAXIT = 100             # stability: updates of a profiled solve
CHAOS_RECOVERY = dict(seed=7, payload_rel_amp=1e-5)    # the JAX bench's
CHAOS_CATASTROPHIC = dict(seed=3, payload_rel_amp=0.3)  # the JAX bench's
LADDER_L = 16                   # stability: where the depth ladder starts
# The governor's patience at 2048^2: the default, max(32, 8l) = 32
# updates, fires on the plateaus of this solve's residual, and each
# replacement throws away the Krylov space (on the CPU at 512^2 the
# default took 51 restarts and did not converge; 256 converged in 1 622
# updates against the ungoverned 1 700).
GOV_PATIENCE = 1024
GOV_RING = 32768                # a ring that holds every governed iteration


def stability_phase(dev, gpu, op, prec, b, solve_kw, main, main_digest,
                    iop, iprec, ib, ice_kw) -> dict:
    """Phase 17, the telemetry ring, the stability governor and
    reduction-payload chaos on the card (every solve fused, Jacobi):

    1. ``main_solve`` again with ``telemetry_cap=TEL_CAP``: x, history
       and host syncs bitwise phase 3's; the ring's iter/upd/restart
       columns against the history; ms an iteration of
       ``TURN_UPDATES``-update solves in turns, plain, instrumented,
       instrumented, plain (the host's pace drifts over the script);
    2. the same problem with ``recurrence="stable"`` and
       ``GovernorConfig(patience=GOV_PATIENCE)``: converged, the true
       residual below 10 tol; updates, restarts, replacements, ms an
       iteration; ``GovernorConfig()`` as it is beside it (recorded, not
       asserted); and kernels and device us an iteration (profiler,
       ``PROFILE_MAXIT`` updates) of the plain, instrumented, stable and
       governed solves;
    3. icesheet3d at l = 4 (its Chebyshev shifts) under
       ``ChaosConfig(**CHAOS_RECOVERY)``, the JAX bench's tol 1e-5, maxit
       400, max_restarts 120: the governed stable solve converged below
       tol against the true residual (asserted), the ungoverned ghysels
       solve's true residual (printed), the gap- and patience-arm
       actions read from the ring;
    4. the depth ladder: ``governed_solve`` at laplace2d 2048^2 from
       l = ``LADDER_L`` under ``ChaosConfig(**CHAOS_CATASTROPHIC)``
       (maxit 400, max_restarts 60, no shifts: they could not follow the
       depth), fused, ``unroll=16``: attempts exactly 16, 8, 4, 2, 1 and a
       ``StagnationError``; ``fused_iter_kernel_rt``'s launches on the
       ladder, and its device ms a launch over a profiled 24-update
       l = 16 solve;
    5. a governed slab of ``SLAB_S`` ice-sheet right-hand sides (column
       0 phase 7's b): every column converged below 10 tol, governor
       vectors (SLAB_S, N_SLOTS), each column's replacements;
    6. ``SolverService`` over icesheet3d (``use_kernel``), plcg,
       ``telemetry_cap=256``, ``SERVE_REQUESTS`` requests: every retired
       request carries its ring, which decodes, and one ring's
       ``telemetry_track`` as a JSON string.

    The launch counts are reset before each path and read after it.
    Returns the launches of the phase's paths, summed."""
    import numpy as np
    import torch

    from repro_torch.chaos import ChaosConfig, chaos_ops
    from repro_torch.core import pipelined_cg
    from repro_torch.core.chebyshev import shifts_for_operator
    from repro_torch.core.types import TelemetrySlab
    from repro_torch.kernels import _build
    from repro_torch.obs import telemetry_track
    from repro_torch.parallel.backends import LocalBackend
    from repro_torch.parallel.worker import digest
    from repro_torch.serve import SolverService, VirtualClock
    from repro_torch.stability import (GovernorConfig, StagnationError,
                                       diagnose, governed_solve)
    from repro_torch.stability import model as GM

    t_phase = time.perf_counter()
    be = LocalBackend(device=dev)
    out = {"phase": "stability", "gpu": gpu}
    failed, launches = [], {}

    def true_rel(aop, bb, x):
        return float(torch.linalg.norm(bb - aop.apply(x))
                     / torch.linalg.norm(bb))

    def run(fn):
        """fn() with the launch counts zeroed before and read after; its
        wall seconds."""
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = dict(_build.LAUNCHES)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return r, wall, got

    def actions(ring, l):
        c = TelemetrySlab(cap=ring.shape[-2], l=l).unpack(
            ring.cpu().numpy())
        a = c["action"][c["iter"] >= 0]
        return {"gap_arm": int((a == GM.ACTION_GAP_REPLACE).sum()),
                "patience_arm": int((a == GM.ACTION_PATIENCE_REPLACE).sum()),
                "stagnation": int((a == GM.ACTION_STAGNATED).sum())}

    # ---- 1. telemetry, bitwise invisible --------------------------------
    turns = {"plain": [], "instrumented": []}
    for name in ("plain", "instrumented", "instrumented", "plain"):
        kw = dict(solve_kw, maxit=TURN_UPDATES, tol=1e-30,
                  telemetry_cap=TEL_CAP if name == "instrumented" else 0)
        _, wall, lz = run(lambda: be.solve(op, b, prec=prec, **kw))
        turns[name].append(1e3 * wall / max(lz.get("fused_iter", 0), 1))
    r, wall, lz = run(lambda: be.solve(op, b, prec=prec, telemetry_cap=TEL_CAP,
                                       **solve_kw))
    phases = lz.get("fused_iter", 0)
    cols = TelemetrySlab(cap=TEL_CAP, l=solve_kw["l"]).unpack(
        r.telemetry.cpu().numpy())
    hist = r.res_history.cpu().numpy()
    written = cols["iter"] >= 0
    rows = np.nonzero(written & (cols["rnorm"] >= 0))[0]
    order = np.argsort(cols["iter"][written])
    it, upd = cols["iter"][written][order], cols["upd"][written][order]
    rst = cols["restart"][written][order] > 0
    tel = {
        "x_and_history_bitwise_main": (digest(r.x), digest(r.res_history))
        == main_digest,
        "host_syncs": [r.host_syncs, main["host_syncs"]],
        "iters": int(r.iters), "restarts": int(r.restarts),
        "vector_phases": phases,
        "ms_per_iter": 1e3 * wall / max(phases, 1),
        "ms_per_iter_turns": turns,
        "main_ms_per_iter": main["ms_per_iter"],
        # the ring holds the last TEL_CAP iterations, in a row
        "ring_iter_is_last_rows": len(it) == TEL_CAP and bool(
            (np.diff(it) == 1).all()),
        "ring_rnorm_is_history": bool(all(
            hist[int(cols["upd"][k])] == cols["rnorm"][k] for k in rows)),
        "ring_upd_max_is_iters": int(upd.max()) == int(r.iters),
        # updates never fall, and a restart row adds none
        "ring_upd_steps": bool((np.diff(upd) >= 0).all()
                               and (np.diff(upd)[rst[1:]] == 0).all()),
        "ring_restart_rows": int(rst.sum()),
        "ring_last_iter": int(it[-1])}
    out["telemetry"] = tel
    if not (tel["x_and_history_bitwise_main"]
            and r.host_syncs == main["host_syncs"]
            and tel["ring_iter_is_last_rows"] and tel["ring_rnorm_is_history"]
            and tel["ring_upd_max_is_iters"] and tel["ring_upd_steps"]
            and phases > 0):
        failed.append("telemetry")
    del r

    # ---- 2. governed, clean ---------------------------------------------
    for name, cfg in (("governed_clean",
                       GovernorConfig(patience=GOV_PATIENCE)),
                      ("governed_clean_default", GovernorConfig())):
        r, wall, lz = run(lambda: be.solve(
            op, b, prec=prec, recurrence="stable", governor=cfg,
            telemetry_cap=GOV_RING, **solve_kw))
        phases = lz.get("fused_iter", 0)
        d = diagnose(r)
        rel = true_rel(op, b, r.x)
        out[name] = {
            "patience": cfg.resolved_patience(solve_kw["l"]),
            "telemetry_cap": GOV_RING,
            "converged": d["converged"], "true_rel_residual": rel,
            "iters": int(r.iters), "restarts": int(r.restarts),
            "replacements": d["replacements"], "governor": d,
            "actions_in_ring": actions(r.telemetry, solve_kw["l"]),
            "vector_phases": phases, "wall_s": wall,
            "ms_per_iter": 1e3 * wall / max(phases, 1),
            "host_syncs": r.host_syncs}
        del r
    g = out["governed_clean"]
    if not (g["converged"] and g["true_rel_residual"] < 10 * TOL
            and g["vector_phases"] > 0):
        failed.append("governed_clean")

    prof = {}
    short = dict(solve_kw, maxit=PROFILE_MAXIT, tol=1e-30)
    for name, extra in (("plain", {}), ("instrumented",
                                        {"telemetry_cap": TEL_CAP}),
                        ("stable", {"recurrence": "stable"}),
                        ("governed", {"recurrence": "stable",
                                      "governor": GovernorConfig(
                                          patience=GOV_PATIENCE)})):
        kw = dict(short, **extra)
        be.solve(op, b, prec=prec, **kw)           # warm
        _build.reset_launches()
        split = device_split(lambda: be.solve(op, b, prec=prec, **kw),
                             ("fused_iter_kernel", "copy_row",
                              "sum_partials"))
        prof[name] = per_iter(split, _build.LAUNCHES.get("fused_iter", 0))
    out["profile_per_iteration"] = prof

    # ---- 3. recovery under payload chaos: icesheet3d at l = 4 -----------
    chaos = ChaosConfig(**CHAOS_RECOVERY)
    ckw = dict(l=4, tol=1e-5, maxit=400, max_restarts=120,
               sigmas=shifts_for_operator(iop, 4, prec=iprec),
               fused_iteration=True, unroll=16, telemetry_cap=TEL_CAP)

    def chaotic(**extra):
        return be.run(lambda ops, bb: pipelined_cg.solve(
            chaos_ops(ops, chaos), bb, **dict(ckw, **extra)), iop, ib,
            prec=iprec)

    rg, wall_g, lz_g = run(lambda: chaotic(recurrence="stable",
                                           governor=GovernorConfig()))
    ru, wall_u, _ = run(lambda: chaotic())
    dg = diagnose(rg)
    rel_g, rel_u = true_rel(iop, ib, rg.x), true_rel(iop, ib, ru.x)
    out["recovery_icesheet3d"] = {
        "chaos": CHAOS_RECOVERY, "l": 4, "tol": ckw["tol"],
        "governed": {"converged": dg["converged"], "true_rel_residual":
                     rel_g, "iters": int(rg.iters),
                     "restarts": int(rg.restarts),
                     "replacements": dg["replacements"],
                     "actions_in_ring": actions(rg.telemetry, 4),
                     "wall_s": wall_g, "launches": lz_g},
        "ungoverned": {"converged": bool(ru.converged),
                       "true_rel_residual": rel_u, "iters": int(ru.iters),
                       "restarts": int(ru.restarts), "wall_s": wall_u}}
    if not (dg["converged"] and rel_g < ckw["tol"]
            and lz_g.get("fused_iter_ell", 0) > 0):
        failed.append("recovery_icesheet3d")
    del rg, ru

    # ---- 4. the depth ladder from l = 16 ---------------------------------
    catastrophic = ChaosConfig(**CHAOS_CATASTROPHIC)
    lkw = dict(tol=TOL, maxit=400, max_restarts=60, fused_iteration=True,
               unroll=16)
    err = None

    def ladder():
        try:
            governed_solve(be, op, b, l=LADDER_L, prec=prec,
                           ops_transform=lambda o: chaos_ops(o, catastrophic),
                           **lkw)
        except StagnationError as e:
            return e
        return None

    err, wall, lz = run(ladder)
    attempts = [] if err is None else err.diagnosis["attempts"]
    tried = [a["l"] for a in attempts]
    rt_launches = lz.get("fused_iter_runtime_l", 0)
    # Device time of the runtime-depth kernel on the ladder's first rung:
    # a profiled rung cut to 16 updates and one restart.
    def rung():
        return be.run(lambda ops, bb: pipelined_cg.solve(
            chaos_ops(ops, catastrophic), bb, l=LADDER_L,
            recurrence="stable", governor=GovernorConfig(),
            **dict(lkw, maxit=16, max_restarts=1)), op, b, prec=prec)

    rung()
    _build.reset_launches()
    split = device_split(rung, ("fused_iter_kernel_rt",))
    n_rt = _build.LAUNCHES.get("fused_iter_runtime_l", 0)
    out["ladder"] = {
        "start_l": LADDER_L, "chaos": CHAOS_CATASTROPHIC,
        "attempts": attempts, "depths_tried": tried,
        "stagnation_error": None if err is None else str(err),
        "wall_s": wall, "launches": lz,
        "fused_iter_runtime_l_launches": rt_launches,
        "rt_profiled_launches": n_rt,
        "rt_device_ms_per_launch": (
            split["device_us"]["fused_iter_kernel_rt"] * 1e-3 / n_rt
            if n_rt else None),
        "rt_profiled_wall_ms_per_iteration": 1e3 * split["wall_s"]
        / max(n_rt, 1),
        "rt_device_busy_share": per_iter(split, n_rt)["device_busy_share"]}
    if err is None or tried != [16, 8, 4, 2, 1] or rt_launches == 0:
        failed.append("ladder")

    # ---- 5. governed slab of SLAB_S ice-sheet right-hand sides ------------
    rng = np.random.default_rng(BATCH_SEED)
    B = torch.empty((SLAB_S, iop.n), dtype=torch.float64, device=dev)
    B[0] = ib
    B[1:] = torch.tensor(rng.standard_normal((SLAB_S - 1, iop.n)),
                         device=dev)
    r, wall, lz = run(lambda: be.solve_batched(
        iop, B, prec=iprec, recurrence="stable", governor=GovernorConfig(),
        **ice_kw))
    rels = (torch.linalg.norm(B - iop.apply(r.x), dim=1)
            / torch.linalg.norm(B, dim=1)).tolist()
    g = r.governor
    out["governed_slab_icesheet3d"] = {
        "s": SLAB_S, "governor_shape": list(g.shape),
        "converged": r.converged.tolist(), "true_rel_residual": rels,
        "iters": r.iters.tolist(), "restarts": r.restarts.tolist(),
        "replacements": g[:, GM.REPL].long().tolist(), "wall_s": wall,
        "launches": lz}
    if not (bool(r.converged.all()) and max(rels) < 10 * TOL
            and list(g.shape) == [SLAB_S, GM.N_SLOTS]
            and lz.get("fused_iter_ell_slab", 0) > 0):
        failed.append("governed_slab_icesheet3d")
    del r, B

    # ---- 6. served with telemetry ----------------------------------------
    kop = dataclasses.replace(iop, use_kernel=True)
    svc = SolverService(be, s=SLAB_S, method="plcg", l=2, chunk_iters=16,
                        maxit=ice_kw["maxit"], prec="jacobi",
                        clock=VirtualClock(), telemetry_cap=256)
    svc.register_operator("ice", kop)
    bs = [rng.standard_normal(iop.n) for _ in range(SERVE_REQUESTS)]

    def serve():
        ids = [svc.submit("ice", bb, tol=TOL) for bb in bs]
        res = svc.drain()
        return [res[i] for i in ids]

    served, wall, lz = run(serve)
    decoded, srels = [], []
    for rr, bb in zip(served, bs):
        ring = rr.telemetry
        ok = ring is not None and ring.shape == (256, 14)
        if ok:
            c = TelemetrySlab(cap=256, l=2).unpack(ring)
            ok = int(c["upd"].max()) == rr.iters
        decoded.append(ok)
        bt = torch.as_tensor(bb, device=dev)
        srels.append(true_rel(iop, bt, torch.as_tensor(rr.x, device=dev)))
    track = telemetry_track(served[0].telemetry, l=2).to_json()
    out["served_with_telemetry"] = {
        "requests": SERVE_REQUESTS, "rings_decode": decoded,
        "converged": [rr.converged for rr in served],
        "iters": [rr.iters for rr in served],
        "true_rel_residual_max": max(srels), "wall_s": wall,
        "telemetry_track_json_bytes": len(track),
        "telemetry_track_events": len(json.loads(track)["traceEvents"]),
        "launches": lz}
    if not (all(decoded) and all(rr.converged for rr in served)
            and max(srels) < 10 * TOL and lz.get("ell_spmv_slab", 0) > 0):
        failed.append("served_with_telemetry")
    del svc, served

    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if failed:
        raise AssertionError(f"stability failed: {failed}")
    return launches


# --------------------------------------------------------------------------
# Phase 18 (checkpoint): checkpoint and restore on one card.
# --------------------------------------------------------------------------

CKPT_EVERY = 2000           # laplace2d: a snapshot at least every 2 000
CKPT_EVERY_ICE = 15         # updates; icesheet3d p-CG (~40 updates)
# The grid of the five checkpointed laplace2d runs: main_solve's settings
# on 1024^2, not 2048^2, to keep the script inside its time limit once
# phase 21 ran (every check of the phase kept).
CKPT_NX = 1024


def checkpoint_phase(gpu, op, prec, b, solve_kw, main, iop, iprec, ib,
                     ice_kw) -> dict:
    """Checkpoint and restore through ``LocalBackend.solve(...,
    checkpoint=CheckpointConfig(...))`` on laplace2d at CKPT_NX^2 with
    ``main_solve``'s settings (fused p(2)-CG, Jacobi, its shifts for this
    grid, ``unroll=16``; ``op``, ``prec``, ``b`` and ``solve_kw`` are
    ``main_solve``'s and give the grid's kind and settings):

    1. the oracle: the segmented solve with no directory, bitwise the
       plain solve of ``effective_kw`` (``replace_every=2000``) with equal
       host syncs and superkernel launches;
    2. the same with a directory and a counting ``on_boundary``: bitwise
       the oracle, two host reads a boundary (the hook's and the
       snapshot's), the snapshots timed;
    3. the kill: ``on_boundary`` raises at the third boundary, after two
       snapshots (``keep=2``);
    4. the resume (``resume=True``) to convergence: ``LAST_RESTORE`` the
       second snapshot, history and x bitwise the oracle's, true residual
       below 10 tol, one superkernel launch a vector phase (the kill's
       launches those of the persisted run to its third boundary, the
       resume's those after its second);
    5. a byte-flipped copy of the snapshot: ``CheckpointCorruptError``; a
       resume with another tol: ``CheckpointMismatchError``;
    6. Ghysels p-CG on icesheet3d (Jacobi, ``every=15``): the same kill
       and resume, bitwise.

    Every directory is a temporary one, removed at the end.  Returns the
    superkernel launches of the kill and the resume."""
    import shutil
    import tempfile

    import torch

    from repro_torch.checkpoint import (LAST_RESTORE, SNAPSHOTS,
                                        CheckpointConfig,
                                        CheckpointCorruptError,
                                        CheckpointMismatchError,
                                        effective_kw, latest_checkpoint,
                                        list_checkpoints, load_checkpoint)
    from repro_torch.kernels import _build
    from repro_torch.parallel.backends import LocalBackend

    import numpy as np

    from repro_torch.core.chebyshev import shifts_for_operator
    from repro_torch.linalg import JacobiPrec

    t_phase = time.perf_counter()
    be = LocalBackend()
    op = type(op)(CKPT_NX, CKPT_NX)
    prec = JacobiPrec.from_operator(op)
    b = torch.tensor(np.random.default_rng(0).standard_normal(op.n),
                     device=b.device)
    solve_kw = dict(solve_kw, sigmas=shifts_for_operator(
        op, solve_kw["l"], prec=prec))
    out = {"phase": "checkpoint", "gpu": gpu, "problem": "laplace2d",
           "n": op.n, "every": CKPT_EVERY}
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")

    def run(label, bb, o, pr, kw, cfg=None, method="plcg"):
        """One solve, its launches read just after: (result or the
        exception it raised, record)."""
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            r = be.solve(o, bb, method=method, prec=pr, checkpoint=cfg,
                         **kw)
            torch.cuda.synchronize()
        except Exception as e:          # the kill's exception, checked
            r = e
        wall = time.perf_counter() - t0
        rec = {"wall_s": wall, "launches": dict(_build.LAUNCHES)}
        if not isinstance(r, Exception):
            rec.update(iters=int(r.iters), restarts=int(r.restarts),
                       converged=bool(r.converged),
                       host_syncs=r.host_syncs)
        out[label] = rec
        return r, rec

    def same(a, c):
        return bool(torch.equal(a.res_history, c.res_history)
                    and torch.equal(a.x, c.x))

    class Killed(Exception):
        pass

    try:
        # ---- 1. the oracle and the plain solve of its effective config --
        ck = CheckpointConfig(every=CKPT_EVERY)
        r_o, o_rec = run("oracle", b, op, prec, solve_kw, ck)
        r_e, e_rec = run("effective_plain", b, op, prec,
                         effective_kw("plcg", solve_kw, CKPT_EVERY))
        n_phases = o_rec["launches"].get("fused_iter", 0)
        out["oracle"]["vector_phases"] = n_phases
        out["oracle_bitwise_effective"] = same(r_o, r_e)
        if not (same(r_o, r_e) and o_rec["host_syncs"] == e_rec["host_syncs"]
                and n_phases == e_rec["launches"].get("fused_iter", -1) > 0):
            raise AssertionError("the segmented solve is not the plain "
                                 "solve of its effective config")
        true_rel = float(torch.linalg.norm(b - op.apply(r_o.x))
                         / torch.linalg.norm(b))
        out["oracle"]["true_rel_residual"] = true_rel
        if not bool(r_o.converged) or not true_rel < 10 * TOL:
            raise AssertionError("the checkpointed oracle did not converge")
        del r_e

        # ---- 2. persisted, every boundary counted ------------------------
        at = []         # superkernel launches at each boundary

        def count(upd):
            at.append(_build.LAUNCHES["fused_iter"])

        d_full = os.path.join(root, "full")
        n_snap0 = len(SNAPSHOTS)
        r_f, f_rec = run("persisted", b, op, prec, solve_kw,
                         CheckpointConfig(every=CKPT_EVERY,
                                          directory=d_full,
                                          on_boundary=count))
        snaps = SNAPSHOTS[n_snap0:]
        f_rec["boundaries"] = len(at)
        f_rec["extra_host_syncs"] = f_rec["host_syncs"] - o_rec["host_syncs"]
        if not (same(r_o, r_f) and len(snaps) == len(at) >= 3
                and f_rec["extra_host_syncs"] == 2 * len(at)):
            raise AssertionError("persisting changed the solve or cost "
                                 "other than two host reads a boundary")
        del r_f
        ms = {k: 1e3 * sum(s[k] for s in snaps) / len(snaps)
              for k in ("rel_s", "copy_s", "hash_s", "write_s")}
        out["snapshot"] = {
            "count": len(snaps), "bytes": snaps[-1]["bytes"],
            "ms_mean": {k[:-2]: v for k, v in ms.items()},
            "ms_total_mean": sum(ms.values()),
            "ms_max": 1e3 * max(sum(s[k] for k in ms) for s in snaps)}

        # ---- 3. the kill at the third boundary ---------------------------
        d = os.path.join(root, "killed")
        seen = []

        def kill(upd):
            seen.append(upd)
            if len(seen) == 3:
                raise Killed(f"killed at update {upd}")

        err, k_rec = run("killed", b, op, prec, solve_kw,
                         CheckpointConfig(every=CKPT_EVERY, directory=d,
                                          keep=2, on_boundary=kill))
        kept = list_checkpoints(d)
        k_rec["killed_at_update"] = seen[-1]
        k_rec["snapshots_kept"] = [os.path.basename(p) for p in kept]
        if not isinstance(err, Killed) or len(kept) != 2:
            raise AssertionError(f"the kill did not stop the solve after "
                                 f"two snapshots: {err!r}, {kept}")

        # ---- 4. the resume -------------------------------------------
        n_restore = len(LAST_RESTORE)
        r_r, r_rec = run("resumed", b, op, prec, solve_kw,
                         CheckpointConfig(every=CKPT_EVERY, directory=d,
                                          keep=2, resume=True))
        restored = LAST_RESTORE[-1] if len(LAST_RESTORE) > n_restore \
            else None
        true_rel = float(torch.linalg.norm(b - op.apply(r_r.x))
                         / torch.linalg.norm(b))
        r_rec["true_rel_residual"] = true_rel
        r_rec["restored_from"] = (os.path.basename(restored.path)
                                  if restored else None)
        r_rec["restored_tot"] = restored.meta["tot"] if restored else None
        kl = k_rec["launches"].get("fused_iter", 0)
        rl = r_rec["launches"].get("fused_iter", 0)
        f_total = f_rec["launches"].get("fused_iter", 0)
        checks = {
            "restored_second_snapshot": bool(
                restored and restored.path == kept[1]
                and restored.meta["tot"] > 0),
            "bitwise_oracle": same(r_o, r_r),
            "converged": bool(r_r.converged) and true_rel < 10 * TOL,
            "kill_launches_one_a_vector_phase": kl == at[2],
            "resume_launches_one_a_vector_phase": rl == f_total - at[1],
        }
        out["killed_plus_resumed"] = {
            "iters": int(r_r.iters), "restarts": int(r_r.restarts),
            "wall_s": k_rec["wall_s"] + r_rec["wall_s"],
            "superkernel_launches": kl + rl}
        out["main_solve_2048"] = {k: main[k] for k in
                                  ("iters", "restarts", "wall_s",
                                   "host_syncs", "vector_phases")}
        del r_r

        # ---- 5. typed refusals ----------------------------------------
        bad = os.path.join(root, "corrupt")
        os.makedirs(bad)
        flipped = os.path.join(bad, os.path.basename(kept[1]))
        shutil.copyfile(latest_checkpoint(d), flipped)
        with open(flipped, "r+b") as f:
            f.seek(os.path.getsize(flipped) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([(byte[0] + 1) % 256]))
        try:
            load_checkpoint(flipped)
            checks["byte_flip_refused"] = False
        except CheckpointCorruptError:
            checks["byte_flip_refused"] = True
        try:
            be.solve(op, b, prec=prec, **dict(solve_kw, tol=TOL / 2),
                     checkpoint=CheckpointConfig(every=CKPT_EVERY,
                                                 directory=d, resume=True))
            checks["tol_mismatch_refused"] = False
        except CheckpointMismatchError:
            checks["tol_mismatch_refused"] = True

        # ---- 6. Ghysels p-CG on icesheet3d --------------------------------
        pkw = dict(tol=TOL, maxit=ice_kw["maxit"], unroll=16)
        ice, n_b = {}, []
        ice["oracle"], _ = run("icesheet_pcg_oracle", ib, iop, iprec, pkw,
                               CheckpointConfig(every=CKPT_EVERY_ICE),
                               method="pcg")
        ice["persisted"], _ = run(
            "icesheet_pcg_persisted", ib, iop, iprec, pkw,
            CheckpointConfig(every=CKPT_EVERY_ICE,
                             directory=os.path.join(root, "ice_p"),
                             on_boundary=n_b.append), method="pcg")
        kill_at = min(3, len(n_b))
        seen = []

        def kill_ice(upd):
            seen.append(upd)
            if len(seen) == kill_at:
                raise Killed(f"killed at update {upd}")

        d_ice = os.path.join(root, "ice")
        err, _ = run("icesheet_pcg_killed", ib, iop, iprec, pkw,
                     CheckpointConfig(every=CKPT_EVERY_ICE, directory=d_ice,
                                      on_boundary=kill_ice), method="pcg")
        ice_snap = latest_checkpoint(d_ice)
        ice["resumed"], _ = run(
            "icesheet_pcg_resumed", ib, iop, iprec, pkw,
            CheckpointConfig(every=CKPT_EVERY_ICE, directory=d_ice,
                             resume=True), method="pcg")
        checks["icesheet_pcg_bitwise"] = bool(
            isinstance(err, Killed) and kill_at >= 2
            and LAST_RESTORE[-1].path == ice_snap
            and same(ice["oracle"], ice["persisted"])
            and same(ice["oracle"], ice["resumed"])
            and bool(ice["resumed"].converged))
        out["icesheet_pcg_killed_at_boundary"] = kill_at
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["checks"] = checks
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    if not all(checks.values()):
        raise AssertionError(f"checkpoint phase failed: {checks}")
    return {"fused_iter": kl + rl}


# --------------------------------------------------------------------------
# Phase 19 (sliced_ell): degree-sorted sliced ELL on icesheet3d.
# --------------------------------------------------------------------------

def sliced_ell_phase(gpu, iop, ib, ice_kw, ice_main, ell_device_ms) -> None:
    """``sliced_ell_reorder(op, 64)`` of the RCM-ordered icesheet3d
    operator (500 000 nodes, W = 11): occupancy before and after, the
    slice count and width groups; ``SlicedEllOp.apply`` bitwise against
    the per-slice loop (also as a CUDA graph), its event ms, profiler
    device ms and graph-replay ms beside ``ell_spmv``'s device ms (phase
    8) and its own bytes bound (the padded slots' vals and cols, x and y,
    once); an unfused p(2)-CG + Jacobi solve of the permuted system."""
    import numpy as np
    import torch

    from repro_torch.core.chebyshev import shifts_for_operator
    from repro_torch.kernels.ref import ell_rowsum
    from repro_torch.linalg import JacobiPrec
    from repro_torch.linalg.sparse import sliced_ell_reorder
    from repro_torch.parallel.backends import LocalBackend

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    sl, perm = sliced_ell_reorder(iop, 64)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x = torch.randn(iop.n, dtype=torch.float64, device=iop.device,
                    generator=torch.Generator(iop.device).manual_seed(19))
    # The JAX package's apply, one gather and rowsum a slice (~7 800
    # slices: host-bound), timed once.
    t_loop = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t_loop[0].record()
    loop = torch.cat([ell_rowsum(v, x[c])
                      for c, v in zip(sl.slice_cols, sl.slice_vals)])
    t_loop[1].record()
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(sl.apply(x), loop))
    nbytes = sl.padded_slots * (8 + 4) + 2 * iop.n * 8
    widths = {}
    for c in sl.slice_cols:
        widths[int(c.shape[1])] = widths.get(int(c.shape[1]), 0) + c.shape[0]
    apply_ms = cuda_ms(lambda: sl.apply(x))
    apply_dev = device_ms(lambda: sl.apply(x))
    # The apply's ~120 launches replayed as one CUDA graph: events then
    # time the device's work without the host's enqueueing.
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            sl.apply(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y_graph = sl.apply(x)
    graph_ms = cuda_ms(graph.replay)
    bitwise = bitwise and bool(torch.equal(y_graph, loop))
    del graph, y_graph

    tperm = torch.as_tensor(perm, device=iop.device)
    bp = ib[tperm]
    sp = JacobiPrec.from_operator(sl)
    kw = dict(l=2, tol=TOL, maxit=ice_kw["maxit"], unroll=16,
              sigmas=shifts_for_operator(sl, 2, prec=sp))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = LocalBackend().solve(sl, bp, prec=sp, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    true_rel = float(torch.linalg.norm(bp - sl.apply(res.x))
                     / torch.linalg.norm(bp))
    uniform = iop.nnz / (iop.n * iop.w)
    rec = {"phase": "sliced_ell", "gpu": gpu, "problem": "icesheet3d",
           "n": iop.n, "w": iop.w, "slice_rows": 64,
           "host_setup_s": setup_s,
           "occupancy_uniform": uniform, "occupancy_sliced": sl.occupancy(),
           "slices": len(sl.slice_cols), "width_groups": len(sl.groups),
           "rows_by_width": {str(k): v for k, v in sorted(widths.items())},
           "padded_slots": sl.padded_slots,
           "bitwise_per_slice_loop": bitwise,
           "apply_ms": apply_ms, "apply_device_ms": apply_dev,
           "apply_graph_replay_ms": graph_ms,
           "per_slice_loop_ms": t_loop[0].elapsed_time(t_loop[1]),
           "ell_spmv_device_ms": ell_device_ms,
           "bytes": nbytes, "bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S,
           "solve": {"method": "p(2)-CG unfused, Jacobi",
                     "converged": bool(res.converged),
                     "iters": int(res.iters),
                     "restarts": int(res.restarts),
                     "icesheet_solve_iters": ice_main["iters"],
                     "wall_s": wall, "true_rel_residual": true_rel},
           "seconds": time.perf_counter() - t_phase}
    emit(rec)
    if not (bitwise and sl.occupancy() >= 0.85 and bool(res.converged)
            and true_rel < 10 * TOL and np.isfinite(apply_ms)):
        raise AssertionError("sliced ELL phase failed")


# --------------------------------------------------------------------------
# Phase 20 (overlap): the measurement layer, on one card.
# --------------------------------------------------------------------------

def overlap_phase(gpu, lap, op, prec, b, sig, iop, ell_device_ms) -> dict:
    """The measurement layer at ``laplace2d`` 2048^2, Jacobi, ``main_solve``'s
    shifts: overlap reports from the traced schedule (p(l)-CG fused at l in
    {1, 2, 3, 9} and unfused at 2, with a 256-row ring, governed, on the
    ladder oracle over 4 virtual shards, a slab of 8, classic CG and p-CG),
    each held to ``max_in_flight >= l`` (1 for the baselines) and one start
    a window; a fused p(2)-CG window of 64 iterations under
    ``torch.profiler``, its events and chains equal the recorder's, its
    history bitwise the untraced window's, each chain's hiding interval and
    busy device µs, the same for classic CG; the roofline of one fused
    iteration from its counted FLOPs and bytes; ``measured_runner`` at l in
    {1, 2, 3, 4}, ``unroll=16``, ``recalibrate_profile(H100, ...)`` from this
    run's numbers and ``autotune_depth``'s table.  Returns the phase's
    launch counts."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.chebyshev import shifts_for_operator
    from repro_torch.kernels import _build, fused_iter as fi
    from repro_torch.kernels.ops import fused_iteration_factory
    from repro_torch.launch import autotune as at
    from repro_torch.launch.timing_model import H100
    from repro_torch.linalg import Stencil2D5
    from repro_torch.obs.timeline import schedule_track
    from repro_torch.parallel.backends import LocalBackend
    from repro_torch.stability import GovernorConfig
    from repro_torch.utils import trace as T
    from repro_torch.utils.roofline import HW_H100, count_cost, roofline_terms

    t_phase = time.perf_counter()
    _build.reset_launches()
    be = LocalBackend()
    shifts = {2: sig}

    def sig_of(l):
        if l not in shifts:
            shifts[l] = shifts_for_operator(op, l, prec=prec)
        return shifts[l]

    kop = Stencil2D5(lap.nx, lap.ny, use_kernel=True)
    failed = []

    def summary(name, rep, want_l, starts=1):
        ok = (rep.max_in_flight >= want_l
              and rep.starts_per_window == {k: starts
                                            for k in range(rep.window)})
        if rep.n_reduce_hops:
            ok = ok and rep.staged_starts_per_window == {
                k: 1 for k in range(rep.window)}
        if not ok:
            failed.append(name)
        return {"l": rep.l, "window": rep.window,
                "max_in_flight": rep.max_in_flight,
                "starts_per_window": sorted(set(
                    rep.starts_per_window.values())),
                "n_collectives": rep.n_collectives,
                "payload_bytes": rep.collective_bytes,
                "hops_per_window": rep.reduce_hops_per_window or None,
                "hops_in_flight": rep.hops_in_flight, "ok": ok}

    # ---- reports from the traced schedule ---------------------------------
    t0 = time.perf_counter()
    reports = {}
    for l in (1, 2, 3, 9):
        reports[f"fused_l{l}"] = summary(f"fused_l{l}", T.plcg_overlap_report(
            be, op, b, l, sigmas=sig_of(l), prec=prec, fused_iteration=True),
            l)
    reports["unfused_l2"] = summary("unfused_l2", T.plcg_overlap_report(
        be, kop, b, 2, sigmas=sig, prec=prec), 2)
    reports["ring_l2"] = summary("ring_l2", T.plcg_overlap_report(
        be, op, b, 2, sigmas=sig, prec=prec, fused_iteration=True,
        telemetry_cap=256), 2)
    reports["governed_l2"] = summary("governed_l2", T.plcg_overlap_report(
        be, op, b, 2, sigmas=sig, prec=prec, fused_iteration=True,
        recurrence="stable", governor=GovernorConfig()), 2)
    reports["ladder_oracle_l2"] = summary(
        "ladder_oracle_l2", T.plcg_overlap_report(
            LocalBackend(reduction="staged", virtual_shards=4), op, b, 2,
            sigmas=sig, prec=prec, fused_iteration=True), 2)
    B = torch.stack([b] + [torch.roll(b, 7919 * j) for j in range(1, 8)])
    reports["slab8_l2"] = summary("slab8_l2", T.batched_plcg_overlap_report(
        be, op, B, 2, sigmas=sig, prec=prec, fused_iteration=True), 2)
    del B
    reports["classic_cg"] = summary("classic_cg", T.baseline_overlap_report(
        be, kop, b, "cg", prec=prec), 1, starts=2)
    reports["pcg"] = summary("pcg", T.baseline_overlap_report(
        be, kop, b, "pcg", prec=prec), 1)
    torch.cuda.empty_cache()
    reports_s = time.perf_counter() - t0

    # ---- the profiled window ----------------------------------------------
    def profiled(run):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return out, prof, wall

    window = 64
    T.plcg_window(be.make_ops(op, prec), b, 2, 8, sigmas=sig,
                  fused_iteration=True)                 # warm-up
    rec = T.ScheduleRecorder(depth=2)
    st_t, prof, wall = profiled(lambda: T.plcg_window(
        T.traced_ops(be.make_ops(op, prec), rec), b, 2, window, rec,
        sigmas=sig, fused_iteration=True))
    st_p = T.plcg_window(be.make_ops(op, prec), b, 2, window, sigmas=sig,
                         fused_iteration=True)
    bitwise = bool(torch.equal(st_t.hist, st_p.hist)
                   and torch.equal(st_t.cyc.S, st_p.cyc.S))
    del st_t, st_p
    trace = T.chrome_trace(prof)
    got = T.events_from_profile(trace)
    rep = T.analyze_overlap(rec.events, 2, window)
    rep_p = T.analyze_overlap(got, 2, window)
    same_events = ([(e.kind, e.window, e.hop) for e in got]
                   == [(e.kind, e.window, e.hop) for e in rec.events])
    same_chains = rep_p.chains == rep.chains
    ov = T.device_overlap(rep, trace)
    # The same chains drawn in device µs: each span is a hiding interval.
    timed = T.device_time_report(rep, trace)
    spans = [e["dur"] for e in schedule_track(timed, units="device µs")
             .events if e.get("cat") == "reduction"]
    hides = {c.window: c.hide_us for c in ov.chains}
    track_ok = len(spans) == len(rep.chains) and all(
        abs((w - s_) - hides[k]) <= 1e-6 * max(1.0, hides[k])
        for k, s_, w in timed.chains if w is not None)
    kernels = T.device_kernels(trace)
    busy_us = sum(k["dur"] for k in kernels)
    sk = [k["dur"] for k in kernels if "fused_iter_kernel" in k["name"]]
    sp = [k["dur"] for k in kernels if "sum_partials" in k["name"]]
    plcg_timing = {"iterations": window, "wall_ms_per_iter":
                   1e3 * wall / window,
                   "device_us_per_iter": busy_us / window,
                   "kernels_per_iter": len(kernels) / window,
                   "superkernel_us": statistics.median(sk) if sk else None,
                   "sum_partials_us": statistics.median(sp) if sp else None,
                   "device_busy_share": busy_us * 1e-6 / wall}
    del prof, trace

    crec = T.ScheduleRecorder(depth=0)
    _, cprof, cwall = profiled(lambda: T.baseline_window(
        T.traced_ops(be.make_ops(kop, prec), crec), b, "cg", window, crec))
    ctrace = T.chrome_trace(cprof)
    crep = T.analyze_overlap(crec.events, 0, window)
    cov = T.device_overlap(crep, ctrace)
    cg_same = T.analyze_overlap(T.events_from_profile(ctrace), 0,
                                window).chains == crep.chains
    del cprof, ctrace

    # ---- the roofline of one fused p(2)-CG iteration ------------------------
    layout = fi.SlabLayout(l=2, RB=3)
    fiter = fused_iteration_factory(op, prec)(layout)
    host = fi.host_idx(layout, 3 * 2 + 3)
    idx = torch.tensor(host, dtype=torch.int32, device=b.device)
    IS = fi.scal_layout(2)
    scal = torch.full((IS["size"],), 0.5, dtype=torch.float64,
                      device=b.device)
    S = torch.randn(layout.nv, op.n, dtype=torch.float64, device=b.device,
                    generator=torch.Generator(b.device).manual_seed(20))
    _, counted = count_cost(fiter.plain, S, idx, scal)
    del S
    nbytes = at.measured_iteration_bytes(op, 2, prec, fused=True)
    terms = roofline_terms({"flops": counted["flops"],
                            "bytes accessed": nbytes}, None, 1, HW_H100)
    sk_s = plcg_timing["superkernel_us"] * 1e-6
    roofline = {"flops": counted["flops"], "bytes": nbytes,
                "plain_vector_phase_bytes": counted["bytes accessed"],
                "t_compute_us": terms.t_compute * 1e6,
                "t_memory_us": terms.t_memory * 1e6,
                "dominant": terms.dominant,
                "superkernel_device_us": sk_s * 1e6,
                "superkernel_share_of_bound": terms.t_bound / sk_s,
                "iteration_device_us": plcg_timing["device_us_per_iter"],
                "iteration_share_of_bound":
                    terms.t_bound * 1e6 / plcg_timing["device_us_per_iter"],
                "iteration_wall_share_of_bound":
                    terms.t_bound * 1e3 / plcg_timing["wall_ms_per_iter"]}

    # ---- the autotuner ----------------------------------------------------
    t0 = time.perf_counter()
    measure = at.measured_runner(be, op, b, sigmas_for=sig_of, prec=prec,
                                 iters=(24, 72), repeats=2,
                                 plcg_kwargs={"fused_iteration": True})
    recal = at.recalibrate_profile(
        H100,
        iter_payload={"device": b.device.type, "kernel": "fused_iter",
                      "bytes": nbytes, "seconds": sk_s},
        spmv_payload={"device": b.device.type, "kernel": "ell_spmv",
                      "nnz": int(iop.nnz), "seconds": ell_device_ms * 1e-3},
        reduce_payload={"device": b.device.type, "kernel": "sum_partials",
                        "payload_bytes": 5 * 8, "devices": 1,
                        "allreduce_s": plcg_timing["sum_partials_us"] * 1e-6})
    tuned = at.autotune_depth(
        n=op.n, p=1, hw=recal, ls=(1, 2, 3, 4), unrolls=(16,),
        measure=measure, iteration_bytes=lambda l: at.measured_iteration_bytes(
            op, l, prec, fused=True))
    autotune_s = time.perf_counter() - t0
    print(tuned.table(), file=sys.stderr, flush=True)
    launches = dict(_build.LAUNCHES)

    out = {"phase": "overlap", "gpu": gpu, "problem": lap.name, "n": op.n,
           "reports": reports, "reports_s": reports_s,
           "profiled_plcg_l2": {
               "events_equal_recorder": same_events,
               "chains_equal_recorder": same_chains,
               "history_bitwise_untraced": bitwise,
               "device_time_track_spans": len(spans),
               "device_time_track_equals_hiding": track_ok,
               "max_in_flight": rep.max_in_flight, **plcg_timing,
               **ov.summary()},
           "profiled_classic_cg": {
               "chains_equal_recorder": cg_same,
               "max_in_flight": crep.max_in_flight,
               "wall_ms_per_iter": 1e3 * cwall / window, **cov.summary()},
           "nccl_overlap": "not measured: no NCCL group in this process "
                           "(PERF.md section 7, the multi-card question)",
           "roofline": roofline,
           "recalibrated": {"name": recal.name, "mem_bw": recal.mem_bw,
                            "flop_rate": recal.flop_rate,
                            "alpha": recal.alpha},
           "autotune": {"best": {"method": tuned.best.method,
                                 "l": tuned.best.l,
                                 "unroll": tuned.best.unroll},
                        "candidates": [
                            {"method": c.method, "l": c.l,
                             "unroll": c.unroll, "model_ms": c.model_s * 1e3,
                             "measured_ms": None if c.measured_s is None
                             else c.measured_s * 1e3}
                            for c in tuned.candidates],
                        "seconds": autotune_s},
           "launches": launches,
           "seconds": time.perf_counter() - t_phase}
    emit({"overlap": out})
    if failed or not (same_events and same_chains and bitwise and cg_same
                      and track_ok
                      and rep.max_in_flight >= 2
                      and crep.max_in_flight == 1
                      and ov.summary()["chains"] == window - 2
                      and launches.get("fused_iter", 0) > 0
                      and launches.get("fused_iter_runtime_l", 0) > 0
                      and launches.get("stencil2d5", 0) > 0):
        raise AssertionError(f"overlap phase failed: {failed}")
    return launches


# --------------------------------------------------------------------------
# 21. Batched solves, the ring and governor, and the service over ranks.
# --------------------------------------------------------------------------

RANKS_SERVE_NX = 1024           # ranks_slab: the 4-rank service replay's grid
RANKS_SERVE_REQUESTS = 8        # ranks_slab: its requests (one slab of 8)
RANKS_SERVE_TOL = 1e-4          # ranks_slab: their tolerance (a check of
# the ranks' coordination: classic CG takes two ladders an iteration over
# the staged gloo wire, ~20 ms, so it runs to 1e-4, not TOL)
RANKS_SHORT = 200               # ranks_slab: laplace2d slab updates, 4 ranks
RANKS_GOV_MAXIT = 2000          # ranks_slab: the world of one's governed
                                # solve and its slab of SLAB_S, cut to a
                                # fixed depth of updates (PERF.md §4)


def halo_slab_checks(dev, randn, phase_scal, operators: dict,
                     plan) -> tuple[dict, dict, dict]:
    """The superkernel's halo plug-ins in the slab form (s = SLAB_S, l =
    2, Jacobi, each column at its own cycle index) on each of the
    N_SHARDS shards of every operator in ``operators``: one launch of the
    slab against its plain version (rows bitwise, partials within
    PARTIAL_BOUND of sum |m u|) and each column against the single-column
    launch it replaces (rows and partials bitwise), the operands every
    column's halo from the in-process halo of the whole slab's ring-top
    rows.  Then shard 1's slab launch timed (events, profiler), its plain
    version, the SLAB_S single-column launches it replaces, and its bound:
    every column's rows and halo, the inverse diagonal and the ELL
    cols/vals once (``fused_iter.min_bytes``) over PEAK_BYTES_PER_S.  Returns (launches,
    errors, timings) keyed ``fused_iter_halo_slab`` (laplace2d) and
    ``fused_iter_ell_halo_slab``."""
    import torch

    from repro_torch.kernels import _build, fused_iter as fi, ref
    from repro_torch.linalg import JacobiPrec, SparseOp
    from repro_torch.linalg.partition import halo_exchange
    from repro_torch.parallel.distributed import (fused_spmv_local,
                                                  halo_first_dim)

    p, s = N_SHARDS, SLAB_S
    layout = fi.SlabLayout(l=2, RB=3)
    pos = fi.idx_layout(2)["z_top"]
    hosts = [fi.host_idx(layout, i) for i in
             [2 * layout.l + 3 + c for c in range(s - 1)] + [1]]
    idx = torch.tensor(hosts, dtype=torch.int32, device=dev)
    scal = torch.stack([phase_scal(2) for _ in range(s)])
    out, errs, timings, failed = {}, {}, {}, []
    _build.reset_launches()
    for name, op in operators.items():
        prec = JacobiPrec.from_operator(op)
        nl = op.n // p
        S = randn(s, layout.nv, op.n) * 1e-3
        zt = fi.ring_top(S, idx, pos).reshape(s, p, nl)
        if isinstance(op, SparseOp):
            ext = halo_exchange(zt, plan.send_up, plan.send_dn)
            locs = [{f: getattr(plan, f)[r] for f in
                     ("cols", "vals", "send_up", "send_dn")}
                    for r in range(p)]
        else:
            ext = halo_first_dim(zt, op.n // op.nx)
            locs = [{} for _ in range(p)]
        rows_err, part_err, fiters = 0.0, 0.0, []
        columns_same = True
        for r in range(p):
            e_r = ext[:, r].contiguous()
            spmv = fused_spmv_local(op, locs[r], p, lambda z, e=e_r: e)
            inv = prec.inv_diag[r * nl:(r + 1) * nl].contiguous()
            f = fi.build_fused_iteration(layout, spmv, inv)
            S_r = S[..., r * nl:(r + 1) * nl].contiguous()
            S_p, _ = f.plain(S_r.clone(), idx, scal)
            S_k, d_k = f(S_r.clone(), idx, scal)
            torch.cuda.synchronize()
            rows_err = max(rows_err, float((S_k - S_p).abs().max()))
            for c in range(s):
                _, mat, u = ref.fused_iter_unfused(
                    S_r[c], idx[c], scal[c],
                    lambda z, e=e_r[c]: spmv.ext_expr(e),
                    lambda v: inv * v, layout)
                d_p = (mat * u[None, :]).sum(dim=1)
                scale = (mat.abs() * u.abs()[None, :]).sum(dim=1)
                part_err = max(part_err, float(((d_k[c] - d_p).abs()
                                                / scale).max()))
                # the single-column launch this column of the slab replaces
                S_1, d_1 = fi.build_fused_iteration(layout, fused_spmv_local(
                    op, locs[r], p, lambda z, e=e_r[c]: e), inv)(
                        S_r[c].clone(), idx[c], scal[c])
                columns_same = columns_same and bool(
                    torch.equal(S_1, S_k[c]) and torch.equal(d_1, d_k[c]))
                del S_1
            fiters.append((f, S_r, inv, e_r))
            del S_p, S_k
        key = "fused_iter_ell_halo_slab" if isinstance(op, SparseOp) \
            else "fused_iter_halo_slab"
        errs[name] = rows_err
        out[name] = {"rows_max_abs_diff": rows_err,
                     "partials_max_diff_over_abs_sum": part_err,
                     "columns_bitwise_vs_single_launches": columns_same,
                     "launch_key": key}
        if rows_err != 0 or not part_err <= PARTIAL_BOUND \
                or not columns_same:
            failed.append(name)
        f, S_r, inv, e_r = fiters[1]
        halo = f.spmv.ext_len - nl
        shared = sum(t.numel() * t.element_size()
                     for t in (f.spmv.cols, f.spmv.vals) if t is not None)
        nbytes = sum(fi.min_bytes(layout, h, nl, has_prec=False,
                                  has_diag=False, operand_bytes=8 * halo)
                     for h in hosts) + 8 * nl + shared

        # the s single-column launches the slab replaces, each reading its
        # column's operand
        ones = [fi.build_fused_iteration(layout, fused_spmv_local(
            op, locs[1], p, lambda z, e=e_r[c]: e), inv) for c in range(s)]

        def singles():
            for c in range(s):
                ones[c](S_r[c], idx[c], scal[c])

        t = {"ms": cuda_ms(lambda: f(S_r, idx, scal)),
             "device_ms": device_ms(lambda: f(S_r, idx, scal)),
             "single_columns_ms": cuda_ms(singles, reps=5),
             "single_columns_device_ms": device_ms(singles, reps=5),
             "plain_ms": cuda_ms(lambda: f.plain(S_r, idx, scal), reps=3),
             "library_ms": None, "s": s, "shard": 1, "own_rows": nl,
             "halo_rows": halo, **bound_fields(nbytes, 0.0)}
        t["share_of_bound"] = None if t["device_ms"] is None else \
            t["bound_ms"] / t["device_ms"]
        timings[name] = t
        del S, fiters, f, S_r, ext, zt, ones
        torch.cuda.empty_cache()
    launches = dict(_build.LAUNCHES)
    emit({"phase": "halo_slab_vs_plain", "s": s, "l": 2, "n_shards": p,
          "plugins": out, "partials_bound": PARTIAL_BOUND,
          "timings": timings, "launches": launches})
    if failed:
        raise AssertionError(f"halo slab plug-ins differ from their plain "
                             f"versions: {failed}")
    return launches, errs, timings


def ranks_slab_phase(dev, gpu, randn, phase_scal, lap, ice, op, prec, b,
                     solve_kw, iop, iprec, ib, ice_kw,
                     plan) -> tuple[dict, dict, dict]:
    """Phase 21, batched solves, the telemetry ring and the governor, and
    the service over ranks (``MultiprocessBackend``, ranks started by
    ``launch_fabric``):

    1. the halo plug-ins' slab form against its plain version on 4
       shards of laplace2d 2048^2, the icesheet3d-stencil grid and
       icesheet3d (``halo_slab_checks``);
    2. a world of one over NCCL: ``solve_batched`` of phase 16's slab of
       SLAB_S at ``main_solve``'s settings cut to RANKS_GOV_MAXIT updates,
       column by column bitwise the same slab on one device (column 0 the
       sequential solve of ``main_solve``'s b); phase 17's
       governed, instrumented solve (patience GOV_PATIENCE) cut to
       RANKS_GOV_MAXIT updates, bitwise the same solve on one device (its
       ring, governor vector, history and x); phase 16's service of
       SERVE_REQUESTS requests (classic CG, 2048^2), each request's
       iterations and solution bitwise;
    3. four gloo ranks sharing the card: laplace2d slabs of SLAB_S for
       RANKS_SHORT updates, staged (2 stages) bitwise against the slab
       ``rank_oracle_ops`` (4 virtual shards) and monolithic within
       ORACLE_HIST of it, each with ``batched_plcg_overlap_report``'s
       counts on every rank; an icesheet3d slab staged to convergence,
       bitwise; a governed, instrumented (stable, ring of 256) icesheet3d
       solve staged, its ring and governor vector the same on every rank
       and bitwise the oracle's; a service replay of
       RANKS_SERVE_REQUESTS requests at RANKS_SERVE_NX^2 (classic CG to
       RANKS_SERVE_TOL, staged, virtual clock), every rank with the same admitted, shed and
       finished sets and the solutions bitwise the one-device service's
       on ``LocalBackend(reduction="staged", virtual_shards=4)``;
    4. every fused run over 4 ranks launches the halo slab plug-in once a
       slab iteration on every rank.

    Returns (launches of the ranks' runs summed, errors, timings)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import METHODS, batched
    from repro_torch.linalg import Stencil2D5, Stencil3D7
    from repro_torch.parallel.backends import LocalBackend
    from repro_torch.parallel.distributed import rank_oracle_ops
    from repro_torch.parallel.fabric import launch_fabric
    from repro_torch.parallel.reduction import (StagedConfig,
                                                reduction_wire_bytes)
    from repro_torch.parallel.worker import digest
    from repro_torch.serve import (SolverService, TrafficClass, VirtualClock,
                                   poisson_trace, replay)
    from repro_torch.stability import GovernorConfig

    t_phase = time.perf_counter()
    out = {"phase": "ranks_slab", "gpu": gpu, "s": SLAB_S}
    failed = []
    launches, errs, timings = halo_slab_checks(dev, randn, phase_scal, {
        "laplace2d": Stencil2D5(lap.nx, lap.ny),
        "icesheet3d-stencil": Stencil3D7(ice.nx, ice.ny, ice.nz,
                                         eps_z=ice.eps_z),
        "icesheet3d": iop}, plan)
    launches = {}               # the rank runs' launches (the main path)

    tmp = tempfile.mkdtemp(prefix="chip-smoke-ranks-slab-")
    rng = np.random.default_rng(BATCH_SEED)
    B = np.empty((SLAB_S, op.n))
    B[0] = b.cpu().numpy()
    B[1:] = rng.standard_normal((SLAB_S - 1, op.n))    # phase 16's slab
    strace = poisson_trace([TrafficClass("laplace2d", op.n, tol=TOL)],
                           rate_per_s=1000.0, n_requests=SERVE_REQUESTS,
                           seed=BATCH_SEED)            # phase 16's trace
    irng = np.random.default_rng(BATCH_SEED + 21)
    IB = np.empty((SLAB_S, iop.n))
    IB[0] = ib.cpu().numpy()
    IB[1:] = irng.standard_normal((SLAB_S - 1, iop.n))
    small = Stencil2D5(RANKS_SERVE_NX, RANKS_SERVE_NX)
    rtrace = poisson_trace([TrafficClass("op", small.n,
                                         tol=RANKS_SERVE_TOL)],
                           rate_per_s=1000.0,
                           n_requests=RANKS_SERVE_REQUESTS,
                           seed=BATCH_SEED + 21)
    files = {k: os.path.join(tmp, k + ".npz")
             for k in ("lap", "ice", "srv16", "srv8", "small")}
    np.savez(files["lap"], B=B, b=B[0], sig=solve_kw["sigmas"].cpu().numpy())
    np.savez(files["ice"], B=IB, b=IB[0],
             sig=ice_kw["sigmas"].cpu().numpy())
    for key, tr in (("srv16", strace), ("srv8", rtrace)):
        np.savez(files[key], t=np.array([a.t for a in tr]),
                 b=np.stack([a.b for a in tr]),
                 tol=np.array([a.tol for a in tr]),
                 deadline=np.full(len(tr), -1.0))
    np.savez(files["small"], kind="stencil2d5", nx=RANKS_SERVE_NX,
             ny=RANKS_SERVE_NX)
    lap_kw = {k: v for k, v in solve_kw.items() if k != "sigmas"}
    ice_solver = {k: v for k, v in ice_kw.items() if k != "sigmas"}
    gov_kw = dict(lap_kw, recurrence="stable",
                  governor={"patience": GOV_PATIENCE},
                  telemetry_cap=GOV_RING, maxit=RANKS_GOV_MAXIT)
    ice_gov = dict(ice_solver, recurrence="stable", governor={},
                   telemetry_cap=256)
    short = dict(lap_kw, maxit=RANKS_SHORT, tol=1e-30)
    window = {"l": lap.l, "window": 2 * lap.l + 4}

    def task(kind, name, operator, npz, solver, red="monolithic",
             key="B", **extra):
        return dict({"kind": kind, "name": name, "operator": operator,
                     "rhs": {"npz": files[npz], "key": key},
                     "sigmas": {"npz": files[npz], "key": "sig"},
                     "method": "plcg", "reduction": red, "stages": 2,
                     "solver": solver}, **extra)

    def serve_task(name, operator, trace, red, service):
        return {"kind": "serve", "name": name, "operator": operator,
                "trace": {"npz": files[trace]}, "reduction": red,
                "stages": 2, "service": service,
                "replay": {"iter_time_s": 1e-3, "tick_overhead_s": 1e-3}}

    def run_group(tag, p, pg, tasks):
        gdir = os.path.join(tmp, tag)
        os.makedirs(gdir)
        spec = os.path.join(gdir, "spec.json")
        with open(spec, "w") as f:
            json.dump({"backend": {"device": "cuda", "pg_backend": pg},
                       "out_dir": gdir, "threads": 2, "tasks": tasks}, f)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launch_fabric(lambda master, k: [sys.executable, "-m",
                                         "repro_torch.parallel.worker", spec],
                      p, env=dict(os.environ,
                                  PYTHONPATH=os.path.join(ROOT, "src")),
                      cwd=ROOT, timeout_s=600, build_kernels=True)
        seconds = time.perf_counter() - t0
        got = {}
        for t in tasks:
            recs = []
            for r in range(p):
                with open(os.path.join(gdir,
                                       f"{t['name']}.rank{r}.json")) as f:
                    recs.append(json.load(f))
            npz = os.path.join(gdir, t["name"] + ".npz")
            got[t["name"]] = (recs, dict(np.load(npz)) if os.path.exists(npz)
                              else {})
            for rec in recs:
                for k, v in rec.get("launches", {}).items():
                    launches[k] = launches.get(k, 0) + v
        return got, seconds

    def agree(recs, *keys):
        return all(len({json.dumps(r.get(k), sort_keys=True)
                        for r in recs}) == 1 for k in keys)

    def slab_rec(recs, key):
        r0 = recs[0]
        wc = r0["wire_counts"]
        iters = r0["launches"].get(key, 0) or max(r0["iters_by_column"])
        wall = max(r["wall_s"] for r in recs)
        upd = sum(r0["iters_by_column"])
        return {"world": r0["world"], "wire": r0["describe"],
                "iters": r0["iters_by_column"], "converged": r0["converged"],
                "slab_iterations": iters, "wall_s": wall,
                "ms_per_slab_iteration": 1e3 * wall / max(iters, 1),
                "ms_per_update": 1e3 * wall / max(upd, 1),
                "host_syncs_per_iteration": (r0["host_syncs"]
                                             + wc["staging_host_syncs"])
                / max(iters, 1),
                "halo_bytes_per_iteration": wc["bytes_sent"].get("halo", 0)
                / max(iters, 1),
                "hop_bytes_per_iteration": wc["bytes_sent"].get("hop", 0)
                / max(iters, 1),
                "all_reduce_bytes_per_iteration":
                    wc["bytes_sent"].get("all_reduce", 0) / max(iters, 1),
                "ranks_agree_bitwise": agree(recs, "x_sha256",
                                             "history_sha256"),
                "halo_slab_plugin_every_iteration": all(
                    r["launches"].get(key, 0) == iters > 0 for r in recs)
                if key else None,
                "overlap_by_rank": [r.get("overlap") for r in recs],
                "launches_by_rank": [r["launches"] for r in recs]}

    try:
        # ---- 2. a world of one over NCCL --------------------------------
        lap_spec = {"config": "laplace2d"}
        w1, w1_s = run_group("w1", 1, "nccl", [
            task("solve_batched", "slab", lap_spec, "lap",
                 dict(lap_kw, maxit=RANKS_GOV_MAXIT)),
            task("solve", "governed", lap_spec, "lap", gov_kw, key="b"),
            serve_task("serve", {"config": "laplace2d", "use_kernel": True},
                       "srv16", "monolithic",
                       dict(s=SLAB_S, method="cg", chunk_iters=64,
                            maxit=20000))])
        recs, arr = w1["slab"]
        rec = slab_rec(recs, "fused_iter_halo_slab")
        x, h = arr["x"], arr["res_history"]
        cols = [(digest(torch.as_tensor(x[c])),
                 digest(torch.as_tensor(h[c]))) for c in range(SLAB_S)]
        # the one-device references at the same depth: phase 16's slab
        # and main_solve's sequential solve of column 0
        cut_kw = dict(solve_kw, maxit=RANKS_GOV_MAXIT)
        one = LocalBackend(device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sref = one.solve_batched(op, torch.as_tensor(B, device=dev),
                                 prec=prec, **cut_kw)
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t0
        seq = one.solve(op, b, prec=prec, **cut_kw)
        rec["maxit"] = RANKS_GOV_MAXIT
        rec["columns_bitwise_vs_one_device_slab"] = cols == [
            (digest(sref.x[c]), digest(sref.res_history[c]))
            for c in range(SLAB_S)]
        rec["column0_bitwise_vs_sequential_solve"] = cols[0] == (
            digest(seq.x), digest(seq.res_history))
        rec["one_device_slab_ms_per_update"] = 1e3 * one_s / max(
            int(sref.iters.sum()), 1)
        del sref, seq
        w1_rec = {"group_s": w1_s, "slab": rec}
        if not (rec["columns_bitwise_vs_one_device_slab"]
                and rec["column0_bitwise_vs_sequential_solve"]
                and rec["halo_slab_plugin_every_iteration"]):
            failed.append("world1 slab")
        grec = w1["governed"][0][0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gref = LocalBackend(device=dev).solve(
            op, b, prec=prec, recurrence="stable",
            governor=GovernorConfig(patience=GOV_PATIENCE),
            telemetry_cap=GOV_RING, **dict(solve_kw, maxit=RANKS_GOV_MAXIT))
        torch.cuda.synchronize()
        w1_rec["governed"] = {
            "iters": grec["iters"], "restarts": grec["restarts"],
            "maxit": RANKS_GOV_MAXIT, "wall_s": grec["wall_s"],
            "one_device_s": time.perf_counter() - t0,
            "ms_per_vector_phase": grec["ms_per_vector_phase"],
            "bitwise_vs_one_device": [grec["x_sha256"],
                                      grec["history_sha256"],
                                      grec["telemetry_sha256"],
                                      grec["governor_sha256"]]
            == [digest(t) for t in (gref.x, gref.res_history,
                                    gref.telemetry, gref.governor)]
            and grec["iters"] == int(gref.iters) > 0}
        del gref
        if not w1_rec["governed"]["bitwise_vs_one_device"]:
            failed.append("world1 governed")
        srec = w1["serve"][0][0]
        got = {k: [srec["iters"][k], srec["x_sha256"][k]]
               for k in srec["iters"]}
        w1_rec["serve"] = {"requests": len(got), "wall_s": srec["wall_s"],
                           "finished": len(srec["finished"]),
                           "bitwise_vs_one_device_service":
                               got == REFS.get("serve_2048"),
                           "chunks_run": srec["chunks_run"]}
        if not w1_rec["serve"]["bitwise_vs_one_device_service"] or \
                len(got) != SERVE_REQUESTS:
            failed.append("world1 serve")
        out["world1_nccl"] = w1_rec

        # ---- 3. four gloo ranks on the one card -------------------------
        ice_spec = {"config": "icesheet3d"}
        g4, g4_s = run_group("g4", N_RANKS, "gloo", [
            task("solve_batched", "lap_staged", lap_spec, "lap", short,
                 "staged", overlap=window),
            task("solve_batched", "lap_mono", lap_spec, "lap", short,
                 overlap=window),
            task("solve_batched", "ice_staged", ice_spec, "ice", ice_solver,
                 "staged"),
            task("solve", "ice_governed", ice_spec, "ice", ice_gov,
                 "staged", key="b"),
            serve_task("serve", {"npz": files["small"]}, "srv8", "staged",
                       dict(s=SLAB_S, method="cg", chunk_iters=64,
                            maxit=20000))])
        cfg = StagedConfig(N_RANKS, stages=2)
        g4_rec = {"group_s": g4_s}
        ref_s = {}

        def timed_ref(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            ref_s[name] = time.perf_counter() - t0
            return r

        def same(arr, res):
            return bool(np.array_equal(arr["x"], res.x.cpu().numpy())
                        and np.array_equal(arr["res_history"],
                                           res.res_history.cpu().numpy()))

        Bt = torch.as_tensor(B, device=dev)
        o_lap = timed_ref("lap_staged", lambda: batched.solve_batched(
            rank_oracle_ops(op, prec, cfg), Bt, "plcg",
            **dict(solve_kw, maxit=RANKS_SHORT, tol=1e-30)))
        for name in ("lap_staged", "lap_mono"):
            g4_rec[name] = slab_rec(g4[name][0], "fused_iter_halo_slab")
        g4_rec["lap_staged"]["bitwise_vs_oracle"] = same(g4["lap_staged"][1],
                                                         o_lap)
        head, tail = history_head_tail(
            g4["lap_mono"][1]["res_history"].reshape(-1),
            o_lap.res_history.cpu().numpy().reshape(-1),
            float(o_lap.norm0.max()))
        g4_rec["lap_mono"]["history_vs_staged"] = {"head_max": head,
                                                   "max": tail}
        del o_lap, Bt
        IBt = torch.as_tensor(IB, device=dev)
        o_ice = timed_ref("ice_staged", lambda: batched.solve_batched(
            rank_oracle_ops(iop, iprec, cfg), IBt, "plcg", **ice_kw))
        g4_rec["ice_staged"] = slab_rec(g4["ice_staged"][0],
                                        "fused_iter_ell_halo_slab")
        g4_rec["ice_staged"]["bitwise_vs_oracle"] = same(
            g4["ice_staged"][1], o_ice)
        del o_ice
        gov = GovernorConfig()
        o_gov = timed_ref("ice_governed", lambda: METHODS["plcg"](
            rank_oracle_ops(iop, iprec, cfg), IBt[0],
            dict(ice_kw, recurrence="stable", governor=gov,
                 telemetry_cap=256)))
        grecs, garr = g4["ice_governed"]
        g4_rec["ice_governed"] = {
            "iters": grecs[0]["iters"], "restarts": grecs[0]["restarts"],
            "converged": grecs[0]["converged"],
            "ring_and_governor_same_on_every_rank": agree(
                grecs, "telemetry_sha256", "governor_sha256",
                "x_sha256", "history_sha256"),
            "bitwise_vs_oracle": same(garr, o_gov) and bool(
                np.array_equal(garr["telemetry"],
                               o_gov.telemetry.cpu().numpy())
                and np.array_equal(garr["governor"],
                                   o_gov.governor.cpu().numpy()))}
        del o_gov, IBt
        srecs, sarr = g4["serve"]
        ref_svc = SolverService(
            LocalBackend(device=dev, reduction="staged",
                         virtual_shards=N_RANKS), s=SLAB_S, method="cg",
            chunk_iters=64, maxit=20000, prec="jacobi", clock=VirtualClock())
        ref_svc.register_operator("op", Stencil2D5(RANKS_SERVE_NX,
                                                   RANKS_SERVE_NX))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rrep = replay(ref_svc, rtrace, iter_time_s=1e-3, tick_overhead_s=1e-3)
        ref_s["serve"] = time.perf_counter() - t0
        want = {str(k): [r.iters, digest(torch.as_tensor(r.x))]
                for k, r in ref_svc.results.items() if not r.shed}
        got = {k: [srecs[0]["iters"][k], srecs[0]["x_sha256"][k]]
               for k in srecs[0]["iters"]}
        g4_rec["serve"] = {
            "n": small.n, "requests": RANKS_SERVE_REQUESTS,
            "wall_s": max(r["wall_s"] for r in srecs),
            "ranks_see_the_same_sets": agree(srecs, "admitted", "shed",
                                             "finished", "x_sha256",
                                             "retirement_log"),
            "admitted": len(srecs[0]["admitted"]),
            "admitted_at_the_door": srecs[0]["admitted_at_the_door"],
            "finished": len(srecs[0]["finished"]),
            "shed": len(srecs[0]["shed"]),
            "bitwise_vs_one_device_staged_service": got == want,
            "report_equal": {k: v == rrep.metrics().get(k) for k, v in
                             srecs[0]["report"].items()},
            "serve_bytes_by_rank": [r["wire_counts"]["bytes_sent"].get(
                "serve", 0) for r in srecs]}
        del ref_svc
        for name, sec in ref_s.items():
            g4_rec.setdefault(name, {})["reference_in_one_process_s"] = sec
        g4_rec["wire_bytes_per_iteration_reduction_wire_bytes"] = \
            reduction_wire_bytes(N_RANKS, lap.l, SLAB_S)
        out["gloo_4_ranks_one_card"] = g4_rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    out["halo_slab"] = timings
    emit(out)
    g4r = out["gloo_4_ranks_one_card"]
    ov = [o for name in ("lap_staged", "lap_mono")
          for o in g4r[name]["overlap_by_rank"]]
    checks = {
        "world1_slab_bitwise": "world1 slab" not in failed,
        "world1_governed_bitwise": "world1 governed" not in failed,
        "world1_serve_bitwise": "world1 serve" not in failed,
        "lap_staged_bitwise": g4r["lap_staged"]["bitwise_vs_oracle"],
        "lap_mono_close": g4r["lap_mono"]["history_vs_staged"]["max"]
        <= ORACLE_HIST,
        "ice_staged_bitwise": g4r["ice_staged"]["bitwise_vs_oracle"]
        and g4r["ice_staged"]["converged"],
        "ice_governed": g4r["ice_governed"]["bitwise_vs_oracle"]
        and g4r["ice_governed"]["ring_and_governor_same_on_every_rank"]
        and g4r["ice_governed"]["converged"],
        "serve": g4r["serve"]["ranks_see_the_same_sets"]
        and g4r["serve"]["bitwise_vs_one_device_staged_service"]
        and g4r["serve"]["finished"] == RANKS_SERVE_REQUESTS,
        "ranks_agree": all(g4r[k]["ranks_agree_bitwise"] for k in
                           ("lap_staged", "lap_mono", "ice_staged")),
        "halo_slab_plugin_every_iteration": all(
            g4r[k]["halo_slab_plugin_every_iteration"] for k in
            ("lap_staged", "lap_mono", "ice_staged")),
        "overlap": all(o["max_in_flight"] == lap.l
                       and set(o["starts_per_window"]) == {1}
                       for o in ov)
        and all(o["collective_bytes"] >= o["window"] * (2 * lap.l + 1)
                * SLAB_S * 8 for o in g4r["lap_mono"]["overlap_by_rank"]),
    }
    emit({"phase": "ranks_slab_checks", **checks})
    if not all(checks.values()):
        raise AssertionError("ranks_slab failed: " + ", ".join(
            k for k, v in checks.items() if not v))
    return launches, errs, timings


RECOVERY_W1_EVERY = 1000       # ranks_recovery: the world of one's
RECOVERY_W1_MAXIT = 3000       # snapshot interval and fixed depth (2048^2)
RECOVERY_NX = 1024             # ranks_recovery: the 4-rank drill's grid
RECOVERY_EVERY = 200           # ... its snapshot interval,
RECOVERY_KILL_AT = 600         # ... the update whose boundary kills,
RECOVERY_KILL_RANK = 2         # ... the rank that dies,
RECOVERY_MAXIT = 1000          # ... and its fixed depth


def ranks_recovery_phase(dev, gpu, lap, op, prec, b, solve_kw) -> dict:
    """Phase 22, checkpointed solves over ranks and the kill-a-rank
    recovery drill (``MultiprocessBackend.solve(checkpoint=...)``,
    ``fabric.run_resilient``, ``chaos.faults``):

    1. a world of one over NCCL at ``main_solve``'s settings (laplace2d
       2048^2, fused p(2)-CG, Jacobi, ``unroll=16``) to a fixed depth of
       RECOVERY_W1_MAXIT updates with ``CheckpointConfig(every=
       RECOVERY_W1_EVERY)`` on a fresh directory: its history and x
       bitwise the same settings through ``rank_oracle_ops`` (one virtual
       shard) on one device; a ``resume=True`` run of the same group
       continues bitwise from the last snapshot; that snapshot has the
       JAX package's treedef and leaves (``leaf_002``, the D ring, left
       out; int32 counters) and, restored on one device through the
       oracle, continues bitwise too;
    2. four gloo ranks sharing the card, laplace2d at RECOVERY_NX^2,
       fused p(2)-CG staged (2 stages), ``every=RECOVERY_EVERY``,
       ``resume=True`` on a shared directory, to RECOVERY_MAXIT updates,
       under ``launch.recovery.recovery_drill``: attempt 1 kills rank
       RECOVERY_KILL_RANK at the boundary of update RECOVERY_KILL_AT
       (exit 137), every survivor answers the SIGTERM with its flush
       sentinel and 143; attempt 2 restores at a ``tot`` of at least
       RECOVERY_KILL_AT - RECOVERY_EVERY with at most RECOVERY_EVERY
       updates computed again, and its history and x are bitwise the
       uninterrupted checkpointed run through ``rank_oracle_ops`` (4
       virtual shards) on one device, the same on every rank;
    3. the elastic restore: attempt 2's last snapshot restored by
       ``LocalBackend(reduction="staged", virtual_shards=4)`` continues
       bitwise the same snapshot restored through ``rank_oracle_ops``
       (both unfused: LocalBackend's fused oracle files one whole-vector
       partial, the JAX package's, so it is bitwise a fused rank run on
       no card), with the head of its history bitwise attempt 2's.

    Every fused rank run launches the halo plug-in (``fused_iter_halo``)
    once a vector phase.  Returns the ranks' launches (attempt 2's and the
    world of one's), by kernel."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch.chaos import ChaosConfig
    from repro_torch.checkpoint import (LAST_RESTORE, CheckpointConfig,
                                        checkpointed_solve,
                                        latest_checkpoint, load_checkpoint)
    from repro_torch.checkpoint.solve import TREEDEF
    from repro_torch.core.chebyshev import shifts_for_operator
    from repro_torch.launch.recovery import recovery_drill
    from repro_torch.linalg import JacobiPrec
    from repro_torch.parallel.backends import LocalBackend
    from repro_torch.parallel.distributed import rank_oracle_ops
    from repro_torch.parallel.fabric import SIGTERM_EXIT_CODE, launch_fabric
    from repro_torch.parallel.reduction import StagedConfig
    from repro_torch.parallel.worker import digest

    t_phase = time.perf_counter()
    out = {"phase": "ranks_recovery", "gpu": gpu}
    launches: dict = {}
    checks: dict = {}
    tmp = tempfile.mkdtemp(prefix="chip-smoke-recovery-")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def add_launches(recs):
        for rec in recs:
            for k, v in rec.get("launches", {}).items():
                launches[k] = launches.get(k, 0) + v

    def snap_row(snaps):
        if not snaps:
            return None
        return {"snapshots": len(snaps), "bytes": snaps[0]["bytes"],
                **{f"{k}_ms": [1e3 * sn[k + "_s"] for sn in snaps]
                   for k in ("rel", "gather", "copy", "hash", "write")}}

    def oracle(o, pr, bb, kw, cfg, n_shards):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = checkpointed_solve(rank_oracle_ops(
            o, pr, StagedConfig(n_shards, stages=min(2, max(n_shards - 1,
                                                                1)))),
            bb, "plcg", None, cfg, dict(kw))
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    try:
        # ---- 1. a world of one over NCCL, 2048^2 -------------------------
        w1_dir = os.path.join(tmp, "w1")
        ck1 = os.path.join(tmp, "ckpt_w1")
        os.makedirs(w1_dir)
        np.savez(os.path.join(tmp, "lap.npz"), b=b.cpu().numpy(),
                 sig=solve_kw["sigmas"].cpu().numpy())
        np.savez(os.path.join(tmp, "lap_op.npz"), kind="stencil2d5",
                 nx=op.nx, ny=op.ny)
        w1_kw = dict(solve_kw, maxit=RECOVERY_W1_MAXIT)
        solver = {k: v for k, v in w1_kw.items() if k != "sigmas"}
        ckpt = {"every": RECOVERY_W1_EVERY, "directory": ck1}
        tasks = [{"kind": "solve", "name": name,
                  "operator": {"npz": os.path.join(tmp, "lap_op.npz")},
                  "rhs": {"npz": os.path.join(tmp, "lap.npz"), "key": "b"},
                  "sigmas": {"npz": os.path.join(tmp, "lap.npz"),
                             "key": "sig"},
                  "method": "plcg", "reduction": "monolithic",
                  "solver": solver, "checkpoint": dict(ckpt, resume=resume)}
                 for name, resume in (("full", False), ("resume", True))]
        spec = os.path.join(w1_dir, "spec.json")
        with open(spec, "w") as f:
            json.dump({"backend": {"device": "cuda", "pg_backend": "nccl"},
                       "out_dir": w1_dir, "threads": 2, "tasks": tasks}, f)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launch_fabric(lambda master, k: [sys.executable, "-m",
                                         "repro_torch.parallel.worker", spec],
                      1, env=env, cwd=ROOT, timeout_s=400,
                      build_kernels=True)
        w1_s = time.perf_counter() - t0
        recs = {}
        for t in tasks:
            with open(os.path.join(w1_dir, f"{t['name']}.rank0.json")) as f:
                recs[t["name"]] = json.load(f)
        add_launches(recs.values())
        full, resumed = recs["full"], recs["resume"]
        o1, o1_s = oracle(op, prec, b, w1_kw,
                          CheckpointConfig(every=RECOVERY_W1_EVERY), 1)
        want = [digest(o1.x), digest(o1.res_history)]
        last = latest_checkpoint(ck1)
        payload, meta = load_checkpoint(last)
        keys = sorted(payload)
        # the snapshot restored on one device, through the oracle
        ck1b = os.path.join(tmp, "ckpt_w1_one_device")
        os.makedirs(ck1b)
        shutil.copy(last, ck1b)
        o1r, _ = oracle(op, prec, b, w1_kw,
                        CheckpointConfig(every=RECOVERY_W1_EVERY,
                                         directory=ck1b, resume=True), 1)
        one_device_tot = int(LAST_RESTORE[-1].meta["tot"])
        w1 = {"group_s": w1_s, "oracle_s": o1_s,
              "iters": full["iters"], "restarts": full["restarts"],
              "wall_s": full["wall_s"], "resume_wall_s": resumed["wall_s"],
              "vector_phases": full["vector_phases"],
              "ms_per_vector_phase": full["ms_per_vector_phase"],
              "host_syncs": full["host_syncs"],
              "restored": resumed["restored"],
              "snapshot": snap_row(full["snapshots"]),
              "launches": {"full": full["launches"],
                           "resume": resumed["launches"]},
              "snapshot_keys": keys, "snapshot_treedef": meta["treedef"],
              "one_device_restore_tot": one_device_tot}
        checks["world1_bitwise_vs_oracle"] = \
            [full["x_sha256"], full["history_sha256"]] == want
        checks["world1_resume_bitwise"] = (
            resumed["restored"] is not None
            and resumed["restored"]["tot"] > 0
            and [resumed["x_sha256"], resumed["history_sha256"]] == want)
        checks["world1_snapshot_jax_format"] = (
            meta["treedef"] == TREEDEF["plcg"]
            and keys == [f"leaf_{i:03d}" for i in range(19) if i != 2]
            and payload["leaf_000"].dtype == np.float64
            and payload["leaf_000"].shape[-1] == op.n
            and all(payload[f"leaf_{i:03d}"].dtype == np.int32
                    for i in (7, 9, 10, 11, 16)))
        checks["world1_one_device_restore_bitwise"] = (
            one_device_tot == resumed["restored"]["tot"]
            and [digest(o1r.x), digest(o1r.res_history)] == want)
        checks["world1_halo_plugin_every_vector_phase"] = all(
            r["launches"].get("fused_iter_halo", 0) == r["vector_phases"] > 0
            for r in recs.values())
        out["world1_nccl"] = w1
        del o1, o1r, payload

        # ---- 2. four gloo ranks on the card: the kill-a-rank drill -------
        small = type(op)(RECOVERY_NX, RECOVERY_NX, device=dev)
        sprec = JacobiPrec.from_operator(small)
        sb = torch.tensor(np.random.default_rng(31).standard_normal(small.n),
                          device=dev)
        s_kw = dict(solve_kw, maxit=RECOVERY_MAXIT,
                    sigmas=shifts_for_operator(small, lap.l, prec=sprec))
        np.savez(os.path.join(tmp, "small.npz"), b=sb.cpu().numpy(),
                 sig=s_kw["sigmas"].cpu().numpy())
        np.savez(os.path.join(tmp, "small_op.npz"), kind="stencil2d5",
                 nx=RECOVERY_NX, ny=RECOVERY_NX)
        ck4 = os.path.join(tmp, "ckpt_g4")
        g4_dir = os.path.join(tmp, "g4")
        os.makedirs(g4_dir)
        task = {"kind": "solve", "name": "drill",
                "operator": {"npz": os.path.join(tmp, "small_op.npz")},
                "rhs": {"npz": os.path.join(tmp, "small.npz"), "key": "b"},
                "sigmas": {"npz": os.path.join(tmp, "small.npz"),
                           "key": "sig"},
                "method": "plcg", "reduction": "staged", "stages": 2,
                "solver": {k: v for k, v in s_kw.items() if k != "sigmas"},
                "checkpoint": {"every": RECOVERY_EVERY, "directory": ck4,
                               "resume": True}}
        plan = ChaosConfig(seed=7, kill_rank=RECOVERY_KILL_RANK,
                           kill_rank_at_iter=RECOVERY_KILL_AT).fault_plan()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dr = recovery_drill(task, N_RANKS, g4_dir, plan,
                            backend={"device": "cuda", "pg_backend": "gloo"},
                            threads=2, env=env, cwd=ROOT, timeout_s=400,
                            build_kernels=True)
        drill_s = time.perf_counter() - t0
        add_launches(dr["records"])
        cfg4 = CheckpointConfig(every=RECOVERY_EVERY)
        o4, o4_s = oracle(small, sprec, sb, s_kw, cfg4, N_RANKS)
        want4 = [digest(o4.x), digest(o4.res_history)]
        survivors = [r for r in range(N_RANKS) if r != RECOVERY_KILL_RANK]
        codes = dr.get("attempt1_exit_codes") or []
        g4 = {k: v for k, v in dr.items() if k not in ("records", "kills",
                                                       "resumed")}
        g4.update({
            "drill_s": drill_s, "oracle_s": o4_s, "n": small.n,
            "every": RECOVERY_EVERY, "kill_at": RECOVERY_KILL_AT,
            "wall_s_by_rank": [r["wall_s"] for r in dr["records"]],
            "ms_per_vector_phase": max(r["ms_per_vector_phase"] or 0
                                       for r in dr["records"]),
            "snapshot": snap_row(dr["records"][0]["snapshots"]),
            "launches_by_rank": [r["launches"] for r in dr["records"]],
            "wire_counts_rank0": dr["records"][0]["wire_counts"]})
        checks["drill_one_planned_failure"] = (
            dr["attempts"] == 2 and dr.get("failed_rank") == RECOVERY_KILL_RANK
            and len(codes) == N_RANKS and codes[RECOVERY_KILL_RANK] == 137
            and all(codes[r] == SIGTERM_EXIT_CODE for r in survivors)
            and dr.get("attempt1_flushed_ranks") == survivors)
        checks["drill_restore_and_recompute"] = (
            dr.get("restored_tot", -1) >= RECOVERY_KILL_AT - RECOVERY_EVERY
            and 0 < dr.get("recomputed_updates", -1) <= RECOVERY_EVERY
            and dr["kill_upd"] - dr["restored_tot"] <= RECOVERY_EVERY)
        checks["drill_bitwise_vs_oracle_on_every_rank"] = (
            len(dr["results"]) == N_RANKS
            and all([r["x_sha256"], r["history_sha256"]] == want4
                    for r in dr["results"]))
        checks["drill_halo_plugin_every_vector_phase"] = all(
            r["launches"].get("fused_iter_halo", 0) == r["vector_phases"] > 0
            for r in dr["records"])
        out["gloo_4_ranks_drill"] = g4

        # ---- 3. the elastic restore on the ladder oracle -----------------
        arr = dict(np.load(os.path.join(g4_dir, "drill.npz")))
        last4 = latest_checkpoint(ck4)
        el_kw = dict(s_kw, fused_iteration=False)
        got = {}
        for name in ("local", "oracle"):
            d = os.path.join(tmp, "elastic_" + name)
            os.makedirs(d)
            shutil.copy(last4, d)
            ecfg = CheckpointConfig(every=RECOVERY_EVERY, directory=d,
                                    resume=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "local":
                r = LocalBackend(device=dev, reduction="staged",
                                 virtual_shards=N_RANKS).solve(
                    small, sb, prec=sprec, checkpoint=ecfg, **el_kw)
            else:
                r, _ = oracle(small, sprec, sb, el_kw, ecfg, N_RANKS)
            torch.cuda.synchronize()
            got[name] = (r, time.perf_counter() - t0,
                         dict(LAST_RESTORE[-1].meta))
        (re_, re_s, meta_e), (ro, _, meta_o) = got["local"], got["oracle"]
        h_e = re_.res_history.cpu().numpy()
        upd = int(meta_e["upd"])           # the history is indexed by upd
        head_ok = bool(np.array_equal(h_e[:upd + 1],
                                      arr["res_history"][:upd + 1]))
        _, tail = history_head_tail(h_e, arr["res_history"],
                                    float(re_.norm0))
        same = bool(torch.equal(re_.res_history, ro.res_history)
                    and torch.equal(re_.x, ro.x))
        out["elastic"] = {"restored_tot": int(meta_e["tot"]),
                          "restored_upd": upd, "wall_s": re_s,
                          "iters": int(re_.iters),
                          "bitwise_vs_oracle_restore": same,
                          "head_bitwise_vs_attempt2": head_ok,
                          "unfused_tail_vs_fused_ranks_max": tail}
        checks["elastic_restore_bitwise"] = (
            meta_e["tot"] == meta_o["tot"] > 0 and head_ok and same)
        del o4, re_, ro
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    emit({"phase": "ranks_recovery_checks", **checks})
    if not all(checks.values()):
        raise AssertionError("ranks_recovery failed: " + ", ".join(
            k for k, v in checks.items() if not v))
    return launches


# LM serving (phase 23).  (a) qwen3-1.7b at its published config, full
# width and depth (28 layers, fp32: 2.03 G parameters): 4 requests of 512
# random prompt tokens, 64 new tokens each (one from prefill, 63 decode
# steps), so 28 x 63 = 1 764 launches of the decode kernel.  (b) The other
# nine LM configs at their published widths, depth cut for the card's
# memory and the time limit (PERF.md section 4): B = 2, a prompt of 64
# tokens (encdec: 16 encoder frames), 8 decode steps.
LM_MAIN = "qwen3-1.7b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 512, 64
LM_OTHER_BATCH, LM_OTHER_PROMPT, LM_OTHER_STEPS, LM_ENC_FRAMES = 2, 64, 8, 16
LM_CUTS = (("smollm-135m", {}),
           ("stablelm-12b", {"n_layers": 2}),
           ("qwen2-vl-7b", {"n_layers": 2}),
           ("deepseek-moe-16b", {"n_layers": 2}),
           ("rwkv6-7b", {"n_layers": 2}),
           ("command-r-plus-104b", {"n_layers": 2}),
           ("seamless-m4t-large-v2", {"n_layers": 2, "n_enc_layers": 2}),
           ("zamba2-2.7b", {"n_layers": 6}),
           ("arctic-480b", {"n_layers": 1}))
LM_SEED = 23
# Kernel path against the plain path, teacher-forced on the kernel's
# tokens: the same fp32 model but decode attention's sums in the kernel's
# split order; rtol = atol = 2e-4, the decode kernel's own bound against
# its plain version (phase 9), which the logits share.
LM_KERNEL_TOL = 2e-4
# Prefill and each decode step against one forward over prompt and
# generated tokens: another blocking of the prompt's attention and fp32
# GEMMs of other shapes over up to 28 layers; the JAX test's decode bound.
LM_FORWARD_TOL = 2e-3


def _lm_clone(cache):
    return {k: ({kk: vv.clone() for kk, vv in v.items()}
                if isinstance(v, dict) else v.clone())
            for k, v in cache.items()}


def _lm_close(got, want, tol) -> tuple[float, bool]:
    """(max |got - want|, allclose at rtol = atol = tol)."""
    import torch

    return (float((got - want).abs().max()),
            bool(torch.allclose(got, want, rtol=tol, atol=tol)))


def lm_serve_run(model, batch, prompt_len: int, steps: int, max_seq: int,
                 forward: bool = True) -> dict:
    """Prefill ``batch``, then ``steps`` greedy decode steps through the
    decode kernel (the token fed back as a device tensor, under
    ``set_sync_debug_mode("error")``: a host sync raises), each step timed
    by CUDA events; the same steps teacher-forced through the plain path
    from a copy of the prefill cache; with ``forward``, one forward over
    the prompt and the fed-back tokens against the prefill's and each
    step's logits.  Returns the record (its ``checks`` and the final
    kernel-path cache under ``cache``)."""
    import torch

    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, max_seq)
    torch.cuda.synchronize()
    rec = {"prefill_ms": 1e3 * (time.perf_counter() - t0)}
    first = logits[:, -1]
    plain = _lm_clone(cache)
    toks = [first.argmax(-1, keepdim=True)]
    k_logits = []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    before = _build.LAUNCHES["decode_attention"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        ev[0].record()
        for i in range(steps):
            logits, cache = model.decode_step(toks[-1], cache)
            ev[i + 1].record()
            k_logits.append(logits[:, -1])
            toks.append(logits[:, -1].argmax(-1, keepdim=True))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(steps))
    rec.update({"decode_steps": steps,
                "decode_ms_median": step_ms[steps // 2],
                "decode_ms_min": step_ms[0], "decode_ms_max": step_ms[-1],
                "decode_wall_ms_per_step": 1e3 * wall / steps,
                "host_syncs_in_decode": 0,
                "launches": _build.LAUNCHES["decode_attention"] - before})
    checks = {"finite": bool(torch.isfinite(first).all()) and all(
        bool(torch.isfinite(x).all()) for x in k_logits)}
    err = 0.0
    ok = True
    for i in range(steps):
        lp, plain = model.decode_step(toks[i], plain, plain=True)
        e, c = _lm_close(k_logits[i], lp[:, -1], LM_KERNEL_TOL)
        err, ok = max(err, e), ok and c
    rec["kernel_vs_plain_max_abs"] = err
    checks["kernel_vs_plain"] = ok
    del plain
    if forward:
        full = dict(batch, tokens=torch.cat([batch["tokens"]] + toks[:steps],
                                            dim=1))
        fl, _ = model.forward(full)
        e0, c0 = _lm_close(first, fl[:, prompt_len - 1], LM_FORWARD_TOL)
        err, ok = e0, c0
        for i in range(steps):
            e, c = _lm_close(k_logits[i], fl[:, prompt_len + i],
                             LM_FORWARD_TOL)
            err, ok = max(err, e), ok and c
        rec["decode_vs_forward_max_abs"] = err
        rec["logits_max_abs"] = float(fl.abs().max())
        checks["decode_vs_forward"] = ok
        del fl
    rec["checks"] = checks
    rec["cache"] = cache
    return rec


def lm_serve_phase(dev, gpu) -> dict:
    """Phase 23: the LM side path's serving half through
    ``repro_torch.models.LM`` (``prefill`` then ``decode_step``), every
    decode step's self-attention (and zamba2's shared block, seamless's
    cross-attention) a launch of the hand-written decode kernel.  Returns
    {"launches": decode kernel launches on the model path, "model_shape":
    the kernel's device time at qwen3's decode shape}."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops as kops
    from repro_torch.models import LM
    from repro_torch.models.attention import decode_attention_torch

    t_phase = time.perf_counter()
    out = {"phase": "lm_serve", "gpu": gpu}
    checks: dict = {}
    launches = 0

    def make_batch(cfg, gen, b, t):
        batch = {"tokens": torch.randint(0, cfg.vocab, (b, t), generator=gen,
                                         device=dev)}
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.randn(
                b, cfg.n_patches, cfg.d_model, generator=gen, device=dev)
        if cfg.family == "encdec":
            batch["enc_embeds"] = torch.randn(
                b, LM_ENC_FRAMES, cfg.d_model, generator=gen, device=dev)
        return batch

    def weight_bytes(model):
        """Bytes of the weights a decode step reads: every parameter but
        the embedding table (of which it reads B rows)."""
        return sum(p.numel() * p.element_size()
                   for n, p in model.named_parameters()
                   if not n.startswith("embed"))

    # ---- (a) qwen3-1.7b, published config, full width and depth ---------
    cfg = get_config(LM_MAIN)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    t0 = time.perf_counter()
    model = LM(cfg, device=dev)
    model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = make_batch(cfg, gen, LM_BATCH, LM_PROMPT)
    max_seq = LM_PROMPT + LM_NEW
    model.prefill(batch, max_seq)                 # warm-up (GEMM choices)
    rec = lm_serve_run(model, batch, LM_PROMPT, LM_NEW - 1, max_seq)
    cache = rec.pop("cache")
    launches += rec["launches"]
    checks.update({f"{LM_MAIN}_{k}": v for k, v in rec.pop("checks").items()})
    checks[f"{LM_MAIN}_launches"] = \
        rec["launches"] == cfg.n_layers * (LM_NEW - 1)
    wb = weight_bytes(model)
    kv_bytes = 2 * LM_BATCH * max_seq * cfg.n_kv * cfg.hd * 4
    rec.update({
        "params": sum(p.numel() for p in model.parameters()),
        "init_s": init_s, "batch": LM_BATCH, "prompt": LM_PROMPT,
        "new_tokens": LM_NEW, "max_seq": max_seq,
        "step_weight_bytes": wb,
        "step_bound_ms": 1e3 * (wb + cfg.n_layers * kv_bytes)
        / PEAK_BYTES_PER_S,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    # Where a step goes: 4 decode steps under the profiler (from the last
    # cache: kv_len 576, the write clamped at the last position).
    prof_cache = _lm_clone(cache)
    tok = torch.zeros((LM_BATCH, 1), dtype=torch.int64, device=dev)

    def four_steps():
        nonlocal prof_cache
        for _ in range(4):
            _, prof_cache = model.decode_step(tok, prof_cache)

    four_steps()
    before = _build.LAUNCHES["decode_attention"]
    split = device_split(four_steps, ("decode_split", "decode_merge",
                                      "gemv", "gemm"))
    n_att = _build.LAUNCHES["decode_attention"] - before
    att_us = split["device_us"]["decode_split"] \
        + split["device_us"]["decode_merge"]
    busy_us = sum(split["device_us"].values())
    rec["profiled_4_steps"] = {
        **split, "kernels_per_step": split["kernels"] / 4,
        "device_us_per_step": busy_us / 4,
        "busy_share": busy_us / 1e6 / split["wall_s"],
        "decode_kernel_launches": n_att}
    # The decode kernel alone at the model's shape (layer 0's cache).
    q = torch.randn(LM_BATCH, cfg.n_heads, cfg.hd, generator=gen, device=dev)
    k0, v0 = cache["k"][0], cache["v"][0]
    kv_t = torch.full((), max_seq, dtype=torch.int64, device=dev)
    bound_ms = 1e3 * kv_bytes / PEAK_BYTES_PER_S
    model_shape = {
        "B": LM_BATCH, "S": max_seq, "kv_len": max_seq, "H": cfg.n_heads,
        "Hkv": cfg.n_kv, "D": cfg.hd,
        "device_us_per_launch_in_step": att_us / max(n_att, 1),
        "ms": cuda_ms(lambda: kops.decode_attention(q, k0, v0, kv_t)),
        "device_ms": device_ms(lambda: kops.decode_attention(q, k0, v0,
                                                             kv_t)),
        "plain_ms": cuda_ms(lambda: decode_attention_torch(q, k0, v0, kv_t)),
        "bytes": kv_bytes, "bound_ms": bound_ms, "bound_by": "bytes"}
    rec["decode_kernel_at_model_shape"] = model_shape
    out[LM_MAIN] = rec
    del model, cache, prof_cache, k0, v0, batch
    torch.cuda.empty_cache()

    # ---- (b) the other nine at their published widths -------------------
    for arch, cut in LM_CUTS:
        cfg = get_config(arch).replace(**cut)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev).manual_seed(LM_SEED)
        t0 = time.perf_counter()
        model = LM(cfg, device=dev)
        model.init(gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batch = make_batch(cfg, gen, LM_OTHER_BATCH, LM_OTHER_PROMPT)
        max_seq = LM_OTHER_PROMPT + LM_OTHER_STEPS + (
            cfg.n_patches if cfg.family == "vlm" else 0)
        moe = cfg.family == "moe"
        rec = lm_serve_run(model, batch, LM_OTHER_PROMPT, LM_OTHER_STEPS,
                           max_seq, forward=not moe)
        rec.pop("cache")
        if moe:
            # GShard drops depend on the group's tokens and their order,
            # which a prefill, a decode step and a forward do not share:
            # the forward check runs on the same weights with a capacity
            # that drops nothing (E / k), the serving run above at the
            # published 1.25.
            free = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
            twin = LM(free, device=dev).load_params(model.params)
            rec_f = lm_serve_run(twin, batch, LM_OTHER_PROMPT,
                                 LM_OTHER_STEPS, max_seq)
            rec_f.pop("cache")
            rec["drop_free_capacity"] = rec_f
            launches += rec_f["launches"]
            rec["checks"].update({f"drop_free_{k}": v
                                  for k, v in rec_f.pop("checks").items()})
            del twin
        launches += rec["launches"]
        n_att = {"hybrid": cfg.n_layers // cfg.shared_attn_period, "ssm": 0,
                 "encdec": 2 * cfg.n_layers}.get(cfg.family, cfg.n_layers)
        rec["checks"]["launches"] = rec["launches"] == n_att * LM_OTHER_STEPS
        checks.update({f"{arch}_{k}": v for k, v in rec.pop("checks").items()})
        rec.update({"cut": cut, "n_layers": cfg.n_layers,
                    "params": sum(p.numel() for p in model.parameters()),
                    "init_s": init_s,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        out[arch] = rec
        del model, batch
        torch.cuda.empty_cache()

    out["decode_kernel_launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    emit({"phase": "lm_serve_checks", **checks})
    if not all(checks.values()):
        raise AssertionError("lm_serve failed: " + ", ".join(
            k for k, v in checks.items() if not v))
    return {"launches": launches, "model_shape": model_shape}



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, src)

    import numpy as np

    from repro_torch.configs import icesheet3d, icesheet3d_stencil, laplace2d
    from repro_torch.configs.problems import build_operator
    from repro_torch.core.chebyshev import shifts_for_operator
    from repro_torch.kernels import _build, fused_iter as fi, ops as kops
    from repro_torch.kernels import ell_spmv, ref, stencil_spmv
    from repro_torch.linalg import (DiagonalOp, JacobiPrec, Stencil2D5,
                                    Stencil3D7, Stencil3D27,
                                    laplacian_2d_spectrum)
    from repro_torch.parallel.backends import LocalBackend
    from repro_torch.parallel.worker import digest

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           device=dev)

    def phase_scal(l):
        """A random scalar vector for one vector phase, its divisors kept
        away from 0."""
        IS = fi.scal_layout(l)
        scal = randn(IS["size"])
        scal[IS["dlt_safe"]] = 1.25
        scal[IS["eta_new_safe"]] = 0.75
        scal[IS["eta0_safe"]] = 1.5
        return scal

    def superkernel_vs_plain(operators, depths=(1, 2, 3)):
        """The superkernel against the plain vector phase for each
        operator, each depth l, both recurrences, Jacobi and identity,
        at several cycle positions: (rows' max abs diff, partials' max
        |diff| / sum |m u|, cases)."""
        row_err, part_err, cases = 0.0, 0.0, 0
        for op in operators:
            for l in depths:
                for rec in ("ghysels", "stable"):
                    for jac in (True, False):
                        prec = JacobiPrec.from_operator(op) if jac else None
                        layout = fi.SlabLayout(l=l, RB=max(l + 1, 3),
                                               recurrence=rec)
                        fiter = kops.fused_iteration_factory(op, prec)(layout)
                        pfun = (lambda v: v) if prec is None else prec.apply
                        for i in sorted({0, l - 1, l, l + 1, 2 * l + 3}):
                            S = randn(layout.nv, op.n)
                            idx = torch.tensor(fi.host_idx(layout, i),
                                               dtype=torch.int32, device=dev)
                            scal = phase_scal(l)
                            S_p, mat, u_new = ref.fused_iter_unfused(
                                S, idx, scal, op.apply, pfun, layout)
                            d_p = (mat * u_new[None, :]).sum(dim=1)
                            scale = (mat.abs()
                                     * u_new.abs()[None, :]).sum(dim=1)
                            S_k, d_k = fiter(S, idx, scal)
                            torch.cuda.synchronize()
                            # in row chunks: at l = 27 on 2048^2 a whole
                            # difference slab (24.7 GiB) does not fit
                            # beside S and S_p
                            for r0 in range(0, layout.nv, 8):
                                row_err = max(row_err, float(
                                    (S_k[r0:r0 + 8] - S_p[r0:r0 + 8])
                                    .abs().max()))
                            part_err = max(part_err, float(
                                ((d_k - d_p).abs() / scale).max()))
                            cases += 1
                            del S, S_p, S_k, mat
        torch.cuda.empty_cache()
        return row_err, part_err, cases

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    build_dir = _build.build_all()
    gpu = gpu_line()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "build_dir": os.path.relpath(build_dir, ROOT), "gpu": gpu})

    # ---- 2. kernels vs plain --------------------------------------------
    lap = laplace2d.config()
    ice = icesheet3d_stencil.config()
    err = {}
    g2 = randn(lap.nx, lap.ny)
    err["stencil2d5"] = float((stencil_spmv.stencil2d5(g2)
                               - stencil_spmv.stencil2d5_plain(g2))
                              .abs().max())
    g3 = randn(ice.nx, ice.ny, ice.nz)
    err["stencil3d7"] = float((stencil_spmv.stencil3d7(g3, ice.eps_z)
                               - stencil_spmv.stencil3d7_plain(g3, ice.eps_z))
                              .abs().max())
    g2f = g2.float()
    err32 = float((stencil_spmv.stencil2d5(g2f)
                   - stencil_spmv.stencil2d5_plain(g2f)).abs().max())
    emit({"phase": "stencils_vs_plain", "stencil2d5_fp64": err["stencil2d5"],
          "stencil3d7_fp64": err["stencil3d7"], "stencil2d5_fp32": err32})
    if err["stencil2d5"] != 0 or err["stencil3d7"] != 0 or err32 != 0:
        raise AssertionError("stencil kernel differs from its plain version")
    del g2, g3, g2f

    row_err, part_err, cases = superkernel_vs_plain([
        Stencil2D5(lap.nx, lap.ny), Stencil3D7(64, 50, 38, eps_z=ice.eps_z),
        Stencil3D27(64, 64, 32),
        DiagonalOp(laplacian_2d_spectrum(lap.nx, lap.ny))])
    # The deepest pipelines the kernel is instantiated for (LMAX = 8), on
    # the main problem's stencil at full size.
    deep_row, deep_part, deep_cases = superkernel_vs_plain(
        [Stencil2D5(lap.nx, lap.ny)], depths=(fi.LMAX - 1, fi.LMAX))
    row_err, part_err = max(row_err, deep_row), max(part_err, deep_part)
    emit({"phase": "superkernel_vs_plain", "cases": cases + deep_cases,
          "depths": [1, 2, 3, fi.LMAX - 1, fi.LMAX],
          "deep_cases": deep_cases, "deep_rows_max_abs_diff": deep_row,
          "deep_partials_max_diff_over_abs_sum": deep_part,
          "rows_max_abs_diff": row_err,
          "partials_max_diff_over_abs_sum": part_err,
          "partials_bound": PARTIAL_BOUND})
    if row_err != 0 or not part_err <= PARTIAL_BOUND:
        raise AssertionError("superkernel differs from its plain version")
    err["fused_iter"] = row_err

    # ---- 3. main solve ---------------------------------------------------
    op = build_operator(lap)
    prec = JacobiPrec.from_operator(op)
    b = torch.tensor(np.random.default_rng(0).standard_normal(op.n),
                     device=dev)
    sig = shifts_for_operator(op, lap.l, prec=prec)
    be = LocalBackend()
    # p(2)-CG meets square-root breakdowns on this problem (the JAX package
    # does too, already at 512^2 and 1024^2); each restarts the cycle and
    # slows convergence, so the run gets the budget to finish: on an H100,
    # 16 restarts and ~11 700 updates (classic CG: 4 834, phase 14).
    solve_kw = dict(l=lap.l, tol=TOL, maxit=20000, max_restarts=50,
                    sigmas=sig, fused_iteration=True, unroll=16)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = be.solve(op, b, prec=prec, **solve_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = dict(_build.LAUNCHES)
    n_iter = main_launches.get("fused_iter", 0)
    true_rel = float(torch.linalg.norm(b - op.apply(res.x))
                     / torch.linalg.norm(b))
    main = {"phase": "main_solve", "problem": lap.name, "n": op.n,
            "l": lap.l, "prec": "jacobi", "converged": bool(res.converged),
            "iters": int(res.iters), "restarts": int(res.restarts),
            "vector_phases": n_iter, "wall_s": wall,
            "ms_per_iter": 1e3 * wall / max(n_iter, 1),
            "host_syncs": res.host_syncs,
            "host_syncs_per_iter": res.host_syncs / max(n_iter, 1),
            "true_rel_residual": true_rel, "launches": main_launches}
    emit(main)
    main_digest = (digest(res.x), digest(res.res_history))
    if not bool(res.converged) or not true_rel < 10 * TOL:
        raise AssertionError("main solve did not converge")
    if n_iter == 0:
        raise AssertionError("main solve never launched the superkernel")

    # ---- 4. fused vs plain vector phase on the card ----------------------
    short = dict(solve_kw, maxit=200, tol=1e-30)
    r_f = be.solve(op, b, prec=prec, **short)
    r_p = be.solve(op, b, prec=prec, **dict(short, fused_iteration=False))
    h_f, h_p = r_f.res_history.cpu().numpy(), r_p.res_history.cpu().numpy()
    m = int(min((h_f >= 0).sum(), (h_p >= 0).sum()))
    hist_rel = float(np.max(np.abs(h_f[:m] - h_p[:m]) / np.abs(h_p[:m])))
    emit({"phase": "fused_vs_plain", "iters": [int(r_f.iters),
                                                int(r_p.iters)],
          "history_entries": m, "history_max_rel_diff": hist_rel,
          "rtol": HISTORY_RTOL})
    if int(r_f.iters) != int(r_p.iters) or not hist_rel <= HISTORY_RTOL:
        raise AssertionError("fused and plain vector phases disagree")
    del r_f, r_p

    # ---- 5. standalone stencil kernels on a solve ------------------------
    # Jacobi on both stencils here; phase 14 runs the icesheet3d-stencil
    # config's block-Jacobi.
    _build.reset_launches()
    stencil_runs = {}
    for name, kop, pop in [
        ("stencil2d5", Stencil2D5(lap.nx, lap.ny, use_kernel=True),
         Stencil2D5(lap.nx, lap.ny)),
        ("stencil3d7", Stencil3D7(ice.nx, ice.ny, ice.nz, eps_z=ice.eps_z,
                                  use_kernel=True),
         Stencil3D7(ice.nx, ice.ny, ice.nz, eps_z=ice.eps_z)),
    ]:
        pj = JacobiPrec.from_operator(pop)
        bb = torch.tensor(np.random.default_rng(1).standard_normal(pop.n),
                          device=dev)
        kw = dict(l=2, tol=1e-30, maxit=300, unroll=16,
                  sigmas=shifts_for_operator(pop, 2, prec=pj))
        before = _build.LAUNCHES[name]
        r_k = be.solve(kop, bb, prec=pj, **kw)
        launched = _build.LAUNCHES[name] - before
        r_p = be.solve(pop, bb, prec=pj, **kw)
        same = bool(torch.equal(r_k.res_history, r_p.res_history)
                    and torch.equal(r_k.x, r_p.x))
        stencil_runs[name] = {"iters": int(r_k.iters), "launches": launched,
                              "bitwise_equal_to_plain": same}
        if not same or launched == 0:
            raise AssertionError(f"{name} solve differs from plain or never "
                                 "launched the kernel")
        del r_k, r_p
    stencil_launches = dict(_build.LAUNCHES)
    emit({"phase": "stencil_solves", "prec": "jacobi",
          "runs": stencil_runs})

    # ---- 6. small reference: card vs the port's CPU path -----------------
    sm = laplace2d.smoke_config()
    ops_small = {}
    sig_small = None
    for d in ("cpu", "cuda"):
        sop = build_operator(sm, device=d)
        sp = JacobiPrec.from_operator(sop)
        if sig_small is None:
            sig_small = shifts_for_operator(sop, 2, prec=sp).numpy()
        sb = torch.tensor(np.random.default_rng(2).standard_normal(sop.n),
                          device=d)
        ops_small[d] = LocalBackend(device=d).solve(
            sop, sb, prec=sp, l=2, tol=1e-8, maxit=500, sigmas=sig_small,
            fused_iteration=True, unroll=16)
    rc, rh = ops_small["cuda"], ops_small["cpu"]
    x_rel = float(torch.linalg.norm(rc.x.cpu() - rh.x)
                  / torch.linalg.norm(rh.x))
    small = {"phase": "small_reference", "n": sm.nx * sm.ny,
             "iters": [int(rc.iters), int(rh.iters)],
             "converged": [bool(rc.converged), bool(rh.converged)],
             "x_rel_diff": x_rel, "finite": bool(torch.isfinite(rc.x).all())}
    emit(small)
    if not (small["finite"] and all(small["converged"])
            and abs(small["iters"][0] - small["iters"][1]) <= 2
            and x_rel < 1e-6):
        raise AssertionError("card and CPU paths disagree on a small input")

    # ---- 7. the unstructured ice sheet ----------------------------------
    ice_prob = icesheet3d.config()
    t0 = time.perf_counter()
    iop = build_operator(ice_prob)
    setup_s = time.perf_counter() - t0
    ix = randn(iop.n)
    ell_err, ell_same = {}, {}

    def ell_check(key, x, cols, vals):
        """The kernel against the plain version, bitwise."""
        plain = ell_spmv.ell_spmv_plain(x, cols, vals)
        got = ell_spmv.ell_spmv(x, cols, vals)
        ell_same[key] = bool(torch.equal(got, plain))
        ell_err[key] = float((got - plain).abs().max())

    xl = randn(iop.n + 7)        # x longer than R, as the halo path passes
    for name, dt in (("fp64", torch.float64), ("fp32", torch.float32)):
        v = iop.vals.to(dt)
        ell_check(name, ix, iop.cols, v)
        ell_check(f"{name}_x_longer", xl, iop.cols, v)
    # The kernel's other paths, each bitwise: the ice sheet with both bases
    # one element off the 16-byte grid (every tile by ordinary loads);
    # random operators with a ragged or exact tile count, fewer rows than a
    # tile, odd and even W, and a W too wide to stage (the direct kernel).
    rng = np.random.default_rng(5)

    def offset_copy(t, off):
        buf = torch.zeros(t.numel() + off, dtype=t.dtype, device=dev)
        buf[off:] = t.reshape(-1)
        return buf[off:].view(t.shape)

    ell_check("icesheet_misaligned", ix, offset_copy(iop.cols, 1),
              offset_copy(iop.vals, 1))
    for rows, w, off in ((1000, 11, 0), (1000, 11, 1), (512, 12, 0),
                         (5, 11, 0), (4097, 27, 3), (100, 400, 0)):
        cols = torch.tensor(rng.integers(0, rows + 13, (rows, w)),
                            dtype=torch.int32, device=dev)
        vals = torch.tensor(rng.standard_normal((rows, w)), device=dev)
        vals[:, 1:][torch.tensor(rng.random((rows, w - 1)) < 0.2,
                                 device=dev)] = 0.0
        xx = randn(rows + 13)
        for dt in (torch.float64, torch.float32):
            ell_check(f"r{rows}_w{w}_off{off}_{str(dt)[6:]}", xx,
                      offset_copy(cols, off), offset_copy(vals.to(dt), off))
    emit({"phase": "ell_vs_plain", "n": iop.n, "w": iop.w, "nnz": iop.nnz,
          "host_setup_s": setup_s,
          "bitwise_equal": ell_same, "max_abs_diff": ell_err})
    if not all(ell_same.values()):
        raise AssertionError("ell_spmv differs from its plain version")
    err["ell_spmv"] = max(ell_err.values())

    iprec = JacobiPrec.from_operator(iop)
    depths = (1, 2, 3, fi.LMAX - 1, fi.LMAX)
    row_err, part_err, cases = superkernel_vs_plain([iop], depths=depths)
    emit({"phase": "superkernel_ell_vs_plain", "cases": cases,
          "depths": list(depths),
          "rows_max_abs_diff": row_err,
          "partials_max_diff_over_abs_sum": part_err,
          "partials_bound": PARTIAL_BOUND})
    if row_err != 0 or not part_err <= PARTIAL_BOUND:
        raise AssertionError("ELL superkernel differs from its plain version")
    err["fused_iter_ell"] = row_err

    ib = torch.tensor(np.random.default_rng(0).standard_normal(iop.n),
                      device=dev)
    ice_kw = dict(l=2, tol=TOL, maxit=ice_prob.maxit,
                  sigmas=shifts_for_operator(iop, 2, prec=iprec),
                  fused_iteration=True, unroll=16)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    ires = be.solve(iop, ib, prec=iprec, **ice_kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ice_launches = dict(_build.LAUNCHES)
    n_iter = ice_launches.get("fused_iter_ell", 0)
    true_rel = float(torch.linalg.norm(ib - iop.apply(ires.x))
                     / torch.linalg.norm(ib))
    emit({"phase": "icesheet_solve", "problem": ice_prob.name, "n": iop.n,
          "l": 2, "prec": "jacobi (the fused path)",
          "converged": bool(ires.converged), "iters": int(ires.iters),
          "restarts": int(ires.restarts), "vector_phases": n_iter,
          "wall_s": wall, "ms_per_iter": 1e3 * wall / max(n_iter, 1),
          "host_syncs": ires.host_syncs,
          "host_syncs_per_iter": ires.host_syncs / max(n_iter, 1),
          "true_rel_residual": true_rel, "launches": ice_launches})
    ice_digest = (digest(ires.x), digest(ires.res_history))
    ice_main = {"iters": int(ires.iters), "restarts": int(ires.restarts),
                "ms_per_iter": 1e3 * wall / max(n_iter, 1),
                "ms_per_update": 1e3 * wall / max(int(ires.iters), 1)}
    if not bool(ires.converged) or not true_rel < 10 * TOL:
        raise AssertionError("icesheet solve did not converge")
    if n_iter == 0:
        raise AssertionError("icesheet solve never launched the ELL "
                             "superkernel")

    r_p = be.solve(iop, ib, prec=iprec, **dict(ice_kw, fused_iteration=False))
    h_f, h_p = ires.res_history.cpu().numpy(), r_p.res_history.cpu().numpy()
    m = int(min((h_f >= 0).sum(), (h_p >= 0).sum()))
    hist_rel = float(np.max(np.abs(h_f[:m] - h_p[:m]) / np.abs(h_p[:m])))
    emit({"phase": "icesheet_fused_vs_plain",
          "iters": [int(ires.iters), int(r_p.iters)], "history_entries": m,
          "history_max_rel_diff": hist_rel, "rtol": HISTORY_RTOL})
    if int(ires.iters) != int(r_p.iters) or not hist_rel <= HISTORY_RTOL:
        raise AssertionError("icesheet fused and plain vector phases "
                             "disagree")
    del ires, r_p

    kop = dataclasses.replace(iop, use_kernel=True)
    kw = dict(ice_kw, fused_iteration=False)
    _build.reset_launches()
    r_k = be.solve(kop, ib, prec=iprec, **kw)
    torch.cuda.synchronize()
    ell_launches = dict(_build.LAUNCHES)
    r_p = be.solve(iop, ib, prec=iprec, **kw)
    same = bool(torch.equal(r_k.res_history, r_p.res_history)
                and torch.equal(r_k.x, r_p.x))
    emit({"phase": "ell_kernel_solve", "iters": int(r_k.iters),
          "converged": bool(r_k.converged), "launches": ell_launches,
          "bitwise_equal_to_plain": same})
    if not same or ell_launches.get("ell_spmv", 0) == 0:
        raise AssertionError("ell_spmv solve differs from plain or never "
                             "launched the kernel")
    del r_k, r_p

    ism = icesheet3d.smoke_config()
    runs = {}
    sig_small = None
    for d in ("cpu", "cuda"):
        sop = build_operator(ism, device=d)
        sp = JacobiPrec.from_operator(sop)
        if sig_small is None:
            sig_small = shifts_for_operator(sop, 2, prec=sp).numpy()
        sb = torch.tensor(np.random.default_rng(2).standard_normal(sop.n),
                          device=d)
        runs[d] = LocalBackend(device=d).solve(
            sop, sb, prec=sp, l=2, tol=1e-8, maxit=500, sigmas=sig_small,
            fused_iteration=True, unroll=16)
    rc, rh = runs["cuda"], runs["cpu"]
    x_rel = float(torch.linalg.norm(rc.x.cpu() - rh.x)
                  / torch.linalg.norm(rh.x))
    small = {"phase": "small_reference_icesheet", "n": sop.n,
             "iters": [int(rc.iters), int(rh.iters)],
             "converged": [bool(rc.converged), bool(rh.converged)],
             "x_rel_diff": x_rel, "finite": bool(torch.isfinite(rc.x).all())}
    emit(small)
    if not (small["finite"] and all(small["converged"])
            and abs(small["iters"][0] - small["iters"][1]) <= 2
            and x_rel < 1e-6):
        raise AssertionError("card and CPU paths disagree on the small "
                             "ice sheet")

    # ---- 8. timings ------------------------------------------------------
    # Where one iteration of the main solve goes: device time of the
    # superkernel versus everything else, over a short profiled solve,
    # taken before the timings below and their profiler windows.
    prof_kw = dict(solve_kw, maxit=100, tol=1e-30)
    be.solve(op, b, prec=prec, **prof_kw)
    _build.reset_launches()
    split = device_split(lambda: be.solve(op, b, prec=prec, **prof_kw),
                         ("fused_iter_kernel", "copy_row", "sum_partials"))
    emit({"phase": "iteration_split",
          **per_iter(split, _build.LAUNCHES["fused_iter"]), "gpu": gpu})

    timings = {}
    g2 = randn(lap.nx, lap.ny)
    w2 = torch.tensor([[0., -1., 0.], [-1., 4., -1.], [0., -1., 0.]],
                      dtype=torch.float64, device=dev)[None, None]
    n2 = g2.numel()
    timings["stencil2d5"] = {
        "ms": cuda_ms(lambda: stencil_spmv.stencil2d5(g2)),
        "device_ms": device_ms(lambda: stencil_spmv.stencil2d5(g2)),
        "plain_ms": cuda_ms(lambda: stencil_spmv.stencil2d5_plain(g2)),
        "library_ms": cuda_ms(lambda: torch.nn.functional.conv2d(
            g2[None, None], w2, padding=1)),
        "bytes": 2 * n2 * 8,
    }
    g3 = randn(ice.nx, ice.ny, ice.nz)
    w3 = torch.zeros((3, 3, 3), dtype=torch.float64, device=dev)
    w3[1, 1, 1] = 4.0 + 2.0 * ice.eps_z
    w3[0, 1, 1] = w3[2, 1, 1] = w3[1, 0, 1] = w3[1, 2, 1] = -1.0
    w3[1, 1, 0] = w3[1, 1, 2] = -ice.eps_z
    n3 = g3.numel()
    timings["stencil3d7"] = {
        "ms": cuda_ms(lambda: stencil_spmv.stencil3d7(g3, ice.eps_z)),
        "device_ms": device_ms(lambda: stencil_spmv.stencil3d7(g3, ice.eps_z)),
        "plain_ms": cuda_ms(
            lambda: stencil_spmv.stencil3d7_plain(g3, ice.eps_z)),
        "library_ms": cuda_ms(lambda: torch.nn.functional.conv3d(
            g3[None, None], w3[None, None], padding=1)),
        "bytes": 2 * n3 * 8,
    }
    err["conv2d_vs_stencil2d5"] = float(
        (torch.nn.functional.conv2d(g2[None, None], w2, padding=1)[0, 0]
         - stencil_spmv.stencil2d5(g2)).abs().max())
    del g2, g3
    layout = fi.SlabLayout(l=lap.l, RB=max(lap.l + 1, 3))
    fiter = kops.fused_iteration_factory(op, prec)(layout)
    i_late = 2 * lap.l + 3
    host = fi.host_idx(layout, i_late)
    idx = torch.tensor(host, dtype=torch.int32, device=dev)
    scal = phase_scal(lap.l)
    S = randn(layout.nv, op.n) * 1e-3
    timings["fused_iter"] = {
        "ms": cuda_ms(lambda: fiter(S, idx, scal)),
        "device_ms": device_ms(lambda: fiter(S, idx, scal)),
        "plain_ms": cuda_ms(lambda: fiter.plain(S, idx, scal), reps=5),
        "library_ms": None,
        "bytes": fi.min_bytes(layout, host, op.n, has_prec=True,
                              has_diag=False),
        "jax_custom_call_hbm_bytes": fi.custom_call_hbm_bytes(layout, op.n),
    }
    del S

    # The ELL kernels at the ice sheet's shape.  Library yardstick for
    # ell_spmv: one cuSPARSE CSR product over the same nonzeros.
    ivals = iop.vals
    keep = ivals != 0
    crow = torch.zeros(iop.n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(keep.sum(dim=1), 0)
    csr = torch.sparse_csr_tensor(crow, iop.cols[keep].long(), ivals[keep],
                                  size=(iop.n, iop.n))
    y_lib = csr @ ix
    err["csr_vs_ell_spmv"] = float((y_lib - ell_spmv.ell_spmv(
        ix, iop.cols, ivals)).abs().max())
    # The kernel and cuSPARSE, in turns, with device time.
    t = in_turns({"kernel": lambda: ell_spmv.ell_spmv(ix, iop.cols, ivals),
                  "library": lambda: csr @ ix})
    timings["ell_spmv"] = {
        "ms": t["kernel"]["ms"], "device_ms": t["kernel"]["device_ms"],
        "turns": t,
        "plain_ms": cuda_ms(
            lambda: ell_spmv.ell_spmv_plain(ix, iop.cols, ivals)),
        "library_ms": t["library"]["ms"],
        "library_device_ms": t["library"]["device_ms"],
        "bytes": (iop.cols.numel() * 4 + ivals.numel() * 8
                  + 2 * iop.n * 8),
    }
    del csr, y_lib
    layout = fi.SlabLayout(l=2, RB=3)
    fiter = kops.fused_iteration_factory(iop, iprec)(layout)
    host = fi.host_idx(layout, 2 * layout.l + 3)
    idx = torch.tensor(host, dtype=torch.int32, device=dev)
    scal = phase_scal(2)
    S = randn(layout.nv, iop.n) * 1e-3
    timings["fused_iter_ell"] = {
        "ms": cuda_ms(lambda: fiter(S, idx, scal)),
        "device_ms": device_ms(lambda: fiter(S, idx, scal)),
        "plain_ms": cuda_ms(lambda: fiter.plain(S, idx, scal), reps=5),
        "library_ms": None,
        "bytes": fi.min_bytes(layout, host, iop.n, has_prec=True,
                              has_diag=False,
                              operand_bytes=fiter.spmv.operand_bytes),
    }
    del S
    for t in timings.values():
        t["bound_ms"] = 1e3 * t["bytes"] / PEAK_BYTES_PER_S
        t["bound_by"] = "bytes"
    emit({"phase": "timings", "gpu": gpu, "timings": timings,
          "conv2d_vs_stencil2d5_max_abs_diff": err["conv2d_vs_stencil2d5"],
          "csr_vs_ell_spmv_max_abs_diff": err["csr_vs_ell_spmv"]})

    # ---- 9. kernel entry points -----------------------------------------
    t0 = time.perf_counter()
    ep_launches, ep_err, ep_timings = entry_points_phase(
        dev, gen, op.n, 2 * lap.l + 1)
    err.update(ep_err)
    timings.update(ep_timings)
    emit({"phase": "timings_entry_points", "gpu": gpu,
          "timings": ep_timings, "launches": ep_launches,
          "sdpa_vs_decode_attention_max_abs_diff": {
              k: v for k, v in ep_err.items() if k.startswith("sdpa")},
          "seconds": time.perf_counter() - t0})

    # ---- 10. pipelines deeper than the compile-time kernels -------------
    rt_launches, err["fused_iter_runtime_l"], rt_timings = runtime_depth_phase(
        dev, randn, phase_scal, superkernel_vs_plain, op, prec, iop, iprec,
        b, lambda l: shifts_for_operator(op, l, prec=prec))
    timings["fused_iter_runtime_l"] = rt_timings["fused_iter_runtime_l9"]

    # ---- 11. decode attention with kv_len on the device -----------------
    decode_kv_len_phase(dev, gen)

    # ---- 12. the row partition and the halo plug-ins (4 virtual shards) --
    plan, _ = partition_phase(dev, iop)
    halo_launches, halo_err, halo_timings = shard_plugins_phase(
        dev, randn, phase_scal, {
            "laplace2d": Stencil2D5(lap.nx, lap.ny),
            "icesheet3d-stencil": Stencil3D7(ice.nx, ice.ny, ice.nz,
                                             eps_z=ice.eps_z),
            "icesheet3d": iop}, plan)
    err["fused_iter_halo"] = err["fused_iter_ell_halo"] = halo_err
    timings["fused_iter_halo"] = halo_timings["halo_laplace2d"]
    timings["fused_iter_ell_halo"] = halo_timings["halo_icesheet3d"]
    del plan

    # ---- 13. the ladder oracle ------------------------------------------
    oracle_phase(op, prec, b, sig, solve_kw, res)

    # ---- 14. the paper's baselines and block-Jacobi ----------------------
    del res
    base_launches = baselines_phase(dev, gpu, lap, ice, iop, b, main)

    # ---- 15. p(l)-CG over real ranks -------------------------------------
    wire_launches = distributed_phase(op, prec, b, solve_kw, main,
                                      main_digest, iop, iprec, ib, ice_kw,
                                      ice_main)

    # ---- 16. batched multi-RHS solves and the serve layer ----------------
    slab_launches, slab_err, slab_timings = batched_serve_phase(
        dev, gpu, randn, phase_scal, lap, ice, op, prec, b, solve_kw, main,
        main_digest, iop, iprec, ib, ice_kw, ice_main, ice_digest)
    slab_kernels = (("fused_iter_slab", "fused_iter.cuh",
                     "src/repro/kernels/fused_iter.py:262"),
                    ("fused_iter_ell_slab", "fused_iter.cuh",
                     "src/repro/kernels/fused_iter.py:229"),
                    ("stencil2d5_slab", "stencil_spmv.cu",
                     "src/repro/kernels/stencil_spmv.py:34"),
                    ("stencil3d7_slab", "stencil_spmv.cu",
                     "src/repro/kernels/stencil_spmv.py:78"),
                    ("ell_spmv_slab", "ell_spmv.cu",
                     "src/repro/kernels/ell_spmv.py:37"))
    for name, _, _ in slab_kernels:
        timings[name] = slab_timings[f"{name}_s{SLAB_S}"]
        err[name] = slab_err[f"{name}_s{SLAB_S}"]

    # ---- 17. the telemetry ring, the governor, chaos, the ladder ---------
    stab_launches = stability_phase(dev, gpu, op, prec, b, solve_kw, main,
                                    main_digest, iop, iprec, ib, ice_kw)

    # ---- 18. checkpoint and restore ----------------------------------------
    ckpt_launches = checkpoint_phase(gpu, op, prec, b, solve_kw, main, iop,
                                     iprec, ib, ice_kw)

    # ---- 19. sliced ELL ------------------------------------------------------
    sliced_ell_phase(gpu, iop, ib, ice_kw, ice_main,
                     timings["ell_spmv"]["device_ms"])

    # ---- 20. the measurement layer: overlap, roofline, autotuner -----------
    overlap_launches = overlap_phase(gpu, lap, op, prec, b, sig, iop,
                                     timings["ell_spmv"]["device_ms"])

    # ---- 21. batched solves, the ring and governor, the service: ranks --
    from repro_torch.linalg.partition import plan_for
    rank_launches, rank_err, rank_timings = ranks_slab_phase(
        dev, gpu, randn, phase_scal, lap, ice, op, prec, b, solve_kw, iop,
        iprec, ib, ice_kw, plan_for(iop, N_SHARDS))
    timings["fused_iter_halo_slab"] = rank_timings["laplace2d"]
    timings["fused_iter_ell_halo_slab"] = rank_timings["icesheet3d"]
    err["fused_iter_halo_slab"] = max(rank_err["laplace2d"],
                                      rank_err["icesheet3d-stencil"])
    err["fused_iter_ell_halo_slab"] = rank_err["icesheet3d"]

    # ---- 22. checkpointed solves over ranks, the recovery drill ----------
    recovery_launches = ranks_recovery_phase(dev, gpu, lap, op, prec, b,
                                             solve_kw)

    # ---- 23. the LM side path: prefill and decode ------------------------
    lm = lm_serve_phase(dev, gpu)
    timings["decode_attention"]["model_shape"] = lm["model_shape"]

    # ---- contract lines --------------------------------------------------
    src_dir = "src/repro_torch/kernels/csrc/"
    kernels = []
    for name, source, replaces, launches in [
        ("fused_iter_runtime_l", src_dir + "fused_iter.cuh",
         "src/repro/kernels/fused_iter.py:262",
         rt_launches.get("fused_iter_runtime_l", 0)),
        ("fused_iter_halo", src_dir + "fused_iter.cuh",
         "src/repro/kernels/fused_iter.py:199",
         halo_launches.get("fused_iter_halo", 0)),
        ("fused_iter_ell_halo", src_dir + "fused_iter.cuh",
         "src/repro/kernels/fused_iter.py:229",
         halo_launches.get("fused_iter_ell_halo", 0)),
        ("fused_iter", src_dir + "fused_iter.cuh",
         "src/repro/kernels/fused_iter.py:262",
         main_launches.get("fused_iter", 0)),
        ("stencil2d5", src_dir + "stencil_spmv.cu",
         "src/repro/kernels/stencil_spmv.py:34",
         stencil_launches.get("stencil2d5", 0)),
        ("stencil3d7", src_dir + "stencil_spmv.cu",
         "src/repro/kernels/stencil_spmv.py:78",
         stencil_launches.get("stencil3d7", 0)),
        ("fused_iter_ell", src_dir + "fused_iter.cuh",
         "src/repro/kernels/fused_iter.py:229",
         ice_launches.get("fused_iter_ell", 0)),
        ("ell_spmv", src_dir + "ell_spmv.cu",
         "src/repro/kernels/ell_spmv.py:37",
         ell_launches.get("ell_spmv", 0)),
        ("fused_dots", src_dir + "fused_dots.cu",
         "src/repro/kernels/fused_dots.py:38",
         ep_launches.get("fused_dots", 0)),
        ("fused_axpy3", src_dir + "fused_axpy.cu",
         "src/repro/kernels/fused_axpy.py:30",
         ep_launches.get("fused_axpy3", 0)),
        ("decode_attention", src_dir + "decode_attention.cu",
         "src/repro/kernels/decode_attention.py:65", lm["launches"]),
    ] + [(name, src_dir + source, replaces, slab_launches.get(name, 0))
         for name, source, replaces in slab_kernels] + [
        ("fused_iter_halo_slab", src_dir + "fused_iter.cuh",
         "src/repro/kernels/fused_iter.py:199",
         rank_launches.get("fused_iter_halo_slab", 0)),
        ("fused_iter_ell_halo_slab", src_dir + "fused_iter.cuh",
         "src/repro/kernels/fused_iter.py:229",
         rank_launches.get("fused_iter_ell_halo_slab", 0))]:
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t.get("device_ms"),
            "library_device_ms": t.get("library_device_ms"),
            "launches_baselines": base_launches.get(name, 0),
            "launches_ranks": wire_launches.get(name, 0),
            "launches_stability": stab_launches.get(name, 0),
            "launches_checkpoint": ckpt_launches.get(name, 0),
            "launches_overlap": overlap_launches.get(name, 0),
            "launches_ranks_slab": rank_launches.get(name, 0),
            "launches_ranks_recovery": recovery_launches.get(name, 0),
            "launches_entry_points": ep_launches.get(name, 0),
            "model_shape": t.get("model_shape")})
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was never launched on its path")
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
