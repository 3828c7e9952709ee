"""One rank of a multi-rank run, driven by a JSON spec::

    python -m repro_torch.parallel.worker SPEC.json

run by every rank of a group that ``repro_torch.parallel.fabric.
launch_fabric`` starts.  The spec names the backend (``device``,
``pg_backend``), an output directory and a list of tasks:

* ``{"kind": "solve", "name": ..., "operator": ..., "rhs": ...,
  "sigmas": ..., "method": ..., "reduction": ..., "stages": ...,
  "solver": {...}}``: one ``MultiprocessBackend.solve``, Jacobi
  preconditioned.
  ``operator`` is ``{"config": "laplace2d" | "icesheet3d"}`` (the
  config's full size) or ``{"npz": path}`` (the fields of
  ``convert.operator``, with ``kind``); ``use_kernel`` overrides the
  operator's flag.  ``rhs`` and
  ``sigmas`` are ``{"npz": path, "key": name}``.
  ``solver`` may hold ``telemetry_cap``, ``recurrence`` and a
  ``governor`` (the ``stability.GovernorConfig`` fields): an
  instrumented, governed solve, whose ring and governor vector every
  rank records.
  A ``checkpoint`` dict (the ``checkpoint.CheckpointConfig`` fields
  ``every``, ``directory``, ``keep``, ``resume``, ``certify_rtol``) makes
  it a checkpointed solve; the record then holds the restore's ``tot``
  and ``upd`` and this rank's snapshots (bytes, gather / copy / hash /
  write seconds).
* ``{"kind": "governed", ...}``: as ``solve``, through
  ``stability.governed_solve`` (the depth ladder: each attempt re-enters
  the solve at its l over the same wire); ``solver`` holds ``l``.
* ``{"kind": "solve_batched", ...}``: as ``solve``, ``rhs`` naming an
  (s, n) slab, one right-hand side a row: one
  ``MultiprocessBackend.solve_batched``; ``overlap`` (``{"l", "window"}``)
  adds ``batched_plcg_overlap_report`` on the slab, traced on every rank.
* ``{"kind": "serve", "name": ..., "operator": ..., "trace": {"npz":
  path}, "service": {...}, "replay": {...}}``: a ``SolverService`` of
  the ``service`` settings (Jacobi) on a virtual clock; rank 0 replays the
  trace (``t``, ``b`` (m, n), ``tol``, ``deadline`` arrays; deadline < 0
  is none) and stops the others, which follow its commands.
* ``{"kind": "decode_merge", "name": ..., "B", "H", "Hkv", "D", "S",
  "kv_len", "seed", "block_s"}``: rank r's split of a KV cache of S
  positions (``decode_split``), its ``decode_attention_stats``, and
  ``merge_decode_shards`` over the wire.

Each rank writes ``<name>.rank<r>.json`` (counts, kernel launches, wire
traffic, times, digests of x, the history, the ring and the governor
vector) into the output directory, and rank 0 also ``<name>.npz`` (x,
res_history, norm0, telemetry, governor; the served requests' solutions;
or the merged decode output).

A spec with a ``drill`` entry (``{"sentinel_dir": path}``) makes the rank
one of a recovery drill (``repro_torch.launch.recovery``).  At start-up it
installs ``fabric.install_sigterm_handler`` with a flush that writes
``<sentinel_dir>/term.rank<r>``, touches its heartbeat, runs
``chaos.apply_from_env`` and decodes its ``chaos.install_iteration_faults``.
A checkpointed solve's ``on_boundary`` then touches the heartbeat and
ticks the faults, printing a ``RECOVERY-KILL`` line (``upd``, time) before
a scripted death; after the solve the rank prints ``RECOVERY-RESUMED``
(the restore's ``tot`` and ``upd``) when it restored and
``RECOVERY-RESULT`` (updates, restarts, converged, digests of the history
and x).  A solve that fails because a peer died waits for the launcher's
SIGTERM, so the rank leaves with 143, not with an error of its own.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

__all__ = ["decode_split", "digest", "load_npz", "main", "RECOVERY_KILL",
           "RECOVERY_RESUMED", "RECOVERY_RESULT", "TEARDOWN_WAIT_S"]

RECOVERY_KILL = "RECOVERY-KILL "
RECOVERY_RESUMED = "RECOVERY-RESUMED "
RECOVERY_RESULT = "RECOVERY-RESULT "
TEARDOWN_WAIT_S = 30.0    # a drill rank's wait for SIGTERM after a failure


def load_npz(path: str) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def _operator(spec: dict, device, cache: dict):
    """The task's operator, built once per spec (``cache`` keeps the last
    one, so consecutive tasks on one operator share it)."""
    key = json.dumps(spec, sort_keys=True)
    if key not in cache:
        cache.clear()
        cache[key] = _build_operator(spec, device)
    return cache[key]


def _build_operator(spec: dict, device):
    from repro_torch import convert
    from repro_torch.configs import icesheet3d, laplace2d
    from repro_torch.configs.problems import build_operator

    if "config" in spec:
        mod = {"laplace2d": laplace2d, "icesheet3d": icesheet3d}[
            spec["config"]]
        op = build_operator(mod.config(), device=device)
    else:
        fields = load_npz(spec["npz"])
        kind = str(fields.pop("kind"))
        fields = {k: (v.item() if v.ndim == 0 else v)
                  for k, v in fields.items()}
        op = convert.operator(kind, device=device, **fields)
    if "use_kernel" in spec:
        import dataclasses

        op = dataclasses.replace(op, use_kernel=bool(spec["use_kernel"]))
    return op


def _array(spec, device):
    if spec is None:
        return None
    return torch.from_numpy(load_npz(spec["npz"])[spec["key"]]).to(device)


def digest(t: torch.Tensor) -> str:
    """sha256 of a tensor's bytes: equal digests, equal bits."""
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def decode_split(rank: int, n_ranks: int, task: dict, device):
    """Rank ``rank``'s inputs of a split-KV decode: q (B, H, D), from the
    task's seed on every rank, and its k, v (B, S/P, Hkv, D) of the cache,
    from the seed and the rank, all fp32; and its valid length, the
    global ``kv_len`` clipped to its positions.  The same call in one
    process gives every rank's split, for the single-process merge."""
    b, h, hkv, d, s = (int(task[k]) for k in ("B", "H", "Hkv", "D", "S"))
    sl = s // n_ranks
    gen = torch.Generator(device=device)
    gen.manual_seed(int(task["seed"]))
    q = torch.randn((b, h, d), generator=gen, device=device)
    gen.manual_seed(int(task["seed"]) * 1000 + 1 + rank)
    k = torch.randn((b, sl, hkv, d), generator=gen, device=device)
    v = torch.randn((b, sl, hkv, d), generator=gen, device=device)
    kv = min(max(int(task["kv_len"]) - rank * sl, 0), sl)
    return q, k, v, kv


def _solver_kw(task: dict, dev) -> dict:
    """The task's solver keyword arguments: its ``solver`` dict, the
    shifts, and a ``governor`` dict as a ``GovernorConfig``."""
    kw = dict(task.get("solver", {}))
    if task.get("sigmas") is not None:
        kw["sigmas"] = _array(task["sigmas"], dev)
    if kw.get("governor") is not None:
        from repro_torch.stability import GovernorConfig

        kw["governor"] = GovernorConfig(**kw["governor"])
    return kw


def _marker(prefix: str, row: dict) -> None:
    print(prefix + json.dumps(row, sort_keys=True), flush=True)


def _checkpoint_cfg(task: dict, rank: int, faults):
    """The task's ``CheckpointConfig``; in a drill (``faults`` not None)
    its ``on_boundary`` touches the heartbeat and ticks the faults."""
    from repro_torch.checkpoint import CheckpointConfig
    from repro_torch.parallel.fabric import touch_heartbeat

    on_boundary = None
    if faults is not None:
        def on_boundary(upd: int) -> None:
            touch_heartbeat()
            if faults.kill_at_iter is not None and upd >= faults.kill_at_iter:
                _marker(RECOVERY_KILL, {"rank": rank, "upd": int(upd),
                                        "t": time.time()})
            faults.tick(upd)

    return CheckpointConfig(**task["checkpoint"], on_boundary=on_boundary)


def _solve(be, task: dict, out_dir: str, cache: dict,
           faults=None) -> dict:
    """A ``solve``, ``governed`` or ``solve_batched`` task."""
    from repro_torch.checkpoint import LAST_RESTORE, SNAPSHOTS
    from repro_torch.kernels import _build
    from repro_torch.linalg import JacobiPrec
    from repro_torch.linalg.partition import plan_for
    from repro_torch.linalg.sparse import SparseOp

    dev = be.device
    kind = task.get("kind", "solve")
    t0 = time.perf_counter()
    op = _operator(task["operator"], dev, cache)
    prec = JacobiPrec.from_operator(op)
    if isinstance(op, SparseOp):
        plan_for(op, be.world_size)        # the partition, memoized
    b = _array(task["rhs"], dev)
    setup_s = time.perf_counter() - t0
    kw = _solver_kw(task, dev)
    if task.get("checkpoint"):
        kw["checkpoint"] = _checkpoint_cfg(task, be.rank, faults)
    method = task.get("method", "plcg")
    restores, snaps = len(LAST_RESTORE), len(SNAPSHOTS)
    be.wire.reset_counts()
    torch.distributed.barrier()
    _sync(dev)
    _build.reset_launches()
    attempts = None
    t0 = time.perf_counter()
    if kind == "governed":
        from repro_torch.stability import governed_solve

        res, attempts = governed_solve(be, op, b, prec=prec, **kw)
    elif kind == "solve_batched":
        res = be.solve_batched(op, b, method=method, prec=prec, **kw)
    else:
        res = be.solve(op, b, method=method, prec=prec, **kw)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    iters = int(res.iters.max())
    phases = sum(v for k, v in launches.items() if k.startswith("fused_iter"))
    rec = {"task": task["name"], "rank": be.rank, "world": be.world_size,
           "describe": be.describe(), "wire": be.hop_wire(),
           "reduction": be.reduction_mode,
           "converged": bool(res.converged.all()),
           "iters": iters, "iters_by_column": res.iters.reshape(-1).tolist(),
           "restarts": int(res.restarts.max()),
           "host_syncs": res.host_syncs, "setup_s": setup_s, "wall_s": wall,
           "ms_per_update": 1e3 * wall / max(iters, 1),
           "vector_phases": phases,
           "ms_per_vector_phase": 1e3 * wall / phases if phases else None,
           "launches": launches, "wire_counts": be.wire.counts(),
           "x_sha256": digest(res.x),
           "history_sha256": digest(res.res_history),
           "telemetry_sha256": (None if res.telemetry is None
                                else digest(res.telemetry)),
           "governor_sha256": (None if res.governor is None
                               else digest(res.governor)),
           "attempts": attempts}
    if task.get("checkpoint"):
        got = LAST_RESTORE[restores:]
        rec["restored"] = ({"tot": int(got[-1].meta["tot"]),
                            "upd": int(got[-1].meta["upd"]),
                            "path": os.path.basename(got[-1].path)}
                           if got else None)
        rec["snapshots"] = [{k: v for k, v in r.items() if k != "path"}
                            for r in SNAPSHOTS[snaps:]]
        if rec["restored"] is not None:
            _marker(RECOVERY_RESUMED, dict(rec["restored"], rank=be.rank,
                                           t=time.time()))
        _marker(RECOVERY_RESULT, {
            k: rec[k] for k in ("rank", "iters", "restarts", "converged",
                                "history_sha256", "x_sha256")})
    if kind == "solve_batched" and task.get("overlap"):
        from repro_torch.utils.trace import batched_plcg_overlap_report

        ov = task["overlap"]
        torch.distributed.barrier()
        rep = batched_plcg_overlap_report(
            be, op, b, int(ov["l"]), window=int(ov["window"]),
            sigmas=kw.get("sigmas"), prec=prec,
            fused_iteration=bool(kw.get("fused_iteration", False)))
        rec["overlap"] = {
            "window": rep.window, "max_in_flight": rep.max_in_flight,
            "starts_per_window": list(rep.starts_per_window.values()),
            "staged_starts_per_window":
                list(rep.staged_starts_per_window.values()),
            "collective_bytes": rep.collective_bytes,
            "reduce_hops": rep.n_reduce_hops,
            "halo_permutes": rep.n_halo_permutes}
    if be.rank == 0:
        r = b - op.apply(res.x)
        rec["true_rel_residual"] = float(
            (torch.linalg.norm(r, dim=-1)
             / torch.linalg.norm(b, dim=-1).clamp_min(1e-300)).max())
        extra = {k: getattr(res, k).cpu().numpy()
                 for k in ("telemetry", "governor")
                 if getattr(res, k) is not None}
        np.savez(os.path.join(out_dir, task["name"] + ".npz"),
                 x=res.x.cpu().numpy(),
                 res_history=res.res_history.cpu().numpy(),
                 norm0=res.norm0.cpu().numpy(),
                 iters=res.iters.cpu().numpy(), **extra)
    return rec


def _serve(be, task: dict, out_dir: str, cache: dict) -> dict:
    """A ``serve`` task: rank 0 replays the trace on a virtual clock and
    stops the other ranks, which follow its commands."""
    from repro_torch.serve import (Arrival, SolverService, VirtualClock,
                                   replay)

    dev = be.device
    op = _operator(task["operator"], dev, cache)
    tr = load_npz(task["trace"]["npz"])
    svc = SolverService(be, clock=VirtualClock(), prec="jacobi",
                        **task.get("service", {}))
    svc.register_operator("op", op)
    be.wire.reset_counts()
    torch.distributed.barrier()
    _sync(dev)
    t0 = time.perf_counter()
    report = None
    if be.rank == 0:
        trace = [Arrival(t=float(t), op_key="op", b=tr["b"][i],
                         tol=float(tr["tol"][i]),
                         deadline_s=(None if tr["deadline"][i] < 0
                                     else float(tr["deadline"][i])))
                 for i, t in enumerate(tr["t"])]
        report = replay(svc, trace, **task.get("replay", {}))
        svc.stop()
    else:
        svc.follow()
    _sync(dev)
    wall = time.perf_counter() - t0
    res = svc.results
    done = sorted(k for k, r in res.items() if not r.shed)
    rec = {"task": task["name"], "rank": be.rank, "world": be.world_size,
           "wall_s": wall, "admitted": sorted(res), "finished": done,
           "shed": sorted(k for k, r in res.items() if r.shed),
           "iters": {str(k): res[k].iters for k in done},
           "x_sha256": {str(k): digest(torch.as_tensor(res[k].x))
                        for k in done},
           "retirement_log": [list(e) for e in svc.retirement_log],
           "chunks_run": svc.scheduler.chunks_run,
           "wire_counts": be.wire.counts()}
    if report is not None:
        rec["admitted_at_the_door"] = report.n_arrivals - report.n_rejected
        rec["report"] = {k: v for k, v in report.metrics().items()
                         if isinstance(v, (int, float))}
        np.savez(os.path.join(out_dir, task["name"] + ".npz"),
                 ids=np.asarray(done),
                 x=np.stack([res[k].x for k in done]) if done
                 else np.zeros((0, op.n)))
    return rec


def _decode_merge(be, task: dict, out_dir: str, cache: dict) -> dict:
    from repro_torch.kernels import _build, ops as kops
    from repro_torch.models.attention import merge_decode_shards

    q, k, v, kv = decode_split(be.rank, be.world_size, task, be.device)
    be.wire.reset_counts()
    _build.reset_launches()
    torch.distributed.barrier()
    _sync(be.device)
    t0 = time.perf_counter()
    o, m, l = kops.decode_attention_stats(q, k, v, kv,
                                          int(task.get("block_s", 512)))
    out = merge_decode_shards(o, m, l, wire=be.wire)
    _sync(be.device)
    wall = time.perf_counter() - t0
    rec = {"task": task["name"], "rank": be.rank, "world": be.world_size,
           "kv_len_local": kv, "wall_s": wall,
           "launches": dict(_build.LAUNCHES),
           "wire_counts": be.wire.counts(), "out_sha256": digest(out)}
    if be.rank == 0:
        np.savez(os.path.join(out_dir, task["name"] + ".npz"),
                 out=out.reshape(q.shape).cpu().numpy())
    return rec


def _drill_start(drill: dict):
    """A drill rank's start-up: the SIGTERM flush (a sentinel file), the
    heartbeat, the plan's start-up faults; returns its iteration faults."""
    from repro_torch.chaos import apply_from_env, install_iteration_faults
    from repro_torch.parallel.fabric import (install_sigterm_handler,
                                             touch_heartbeat)

    rank = int(os.environ["RANK"])
    sentinel = os.path.join(drill["sentinel_dir"], f"term.rank{rank}")

    def flush() -> None:
        with open(sentinel, "w") as f:
            f.write("flushed")

    install_sigterm_handler(flush)
    touch_heartbeat()
    apply_from_env(rank)
    faults = install_iteration_faults(rank)
    print(f"drill rank {rank}: handler armed, faults armed "
          f"{faults.armed}", flush=True)
    return faults


def _await_teardown() -> None:
    """A drill rank whose solve failed (a peer died under it) waits for
    the launcher's SIGTERM, whose handler exits 143; after
    ``TEARDOWN_WAIT_S`` it gives up and the failure propagates."""
    deadline = time.monotonic() + TEARDOWN_WAIT_S
    while time.monotonic() < deadline:
        time.sleep(0.05)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        spec = json.load(f)
    torch.set_num_threads(int(spec.get("threads", 1)))
    import torch.distributed as dist

    from repro_torch.parallel.backends import get_backend

    bk = spec.get("backend", {})
    out_dir = spec["out_dir"]
    cache: dict = {}
    faults = _drill_start(spec["drill"]) if spec.get("drill") else None
    try:
        for task in spec["tasks"]:
            be = get_backend(
                "multiprocess", device=bk.get("device"),
                pg_backend=bk.get("pg_backend"),
                reduction=task.get("reduction", "monolithic"),
                reduction_stages=int(task.get("stages", 2)),
                reduction_dtype={None: None, "float32": torch.float32}[
                    task.get("wire_dtype")])
            run = {"solve": _solve, "governed": _solve,
                   "solve_batched": _solve, "serve": _serve,
                   "decode_merge": _decode_merge}[task["kind"]]
            try:
                rec = (run(be, task, out_dir, cache, faults)
                       if run is _solve else run(be, task, out_dir, cache))
            except Exception:
                if faults is None:
                    raise
                print(f"rank {be.rank}: the solve failed; waiting for the "
                      "launcher's teardown", flush=True)
                _await_teardown()
                raise
            path = os.path.join(out_dir, f"{task['name']}.rank{be.rank}.json")
            with open(path, "w") as f:
                json.dump(rec, f)
            print(json.dumps({k: rec[k] for k in ("task", "rank", "wall_s")}),
                  flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
