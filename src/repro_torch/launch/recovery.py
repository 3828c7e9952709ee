"""The kill-a-rank recovery drill (counterpart of
``scripts/multiprocess_parity.py --recovery``, the launcher side).

Every rank runs the same checkpointed solve (``python -m
repro_torch.parallel.worker SPEC``, a spec with a ``drill`` entry and one
task that carries a ``checkpoint`` with ``resume=True`` on a shared
directory).  :func:`recovery_drill` supervises it with
``fabric.run_resilient``:

1. attempt 1 ships the fault plan (an iteration-indexed kill of one
   rank) in its environment; the rank prints ``RECOVERY-KILL`` and dies
   with 137 at its boundary, the launcher sees it and tears the others
   down with SIGTERM (each writes its flush sentinel and exits 143);
2. attempt 2 runs clean on a fresh port, restores the last snapshot and
   finishes the solve.

:func:`recovery_drill` returns what the two attempts show: the kill
update, the restore's ``tot`` and ``upd``, the updates computed again, the
seconds from the kill to the launcher's error, each attempt's wall
seconds, the exit codes and sentinels of attempt 1, and every rank's
result line and record of attempt 2.
"""

from __future__ import annotations

import json
import os
import sys
import time

__all__ = ["markers", "recovery_drill"]


def markers(outputs: list[str], prefix: str) -> list[dict]:
    """The JSON rows of every ``prefix`` line in the ranks' outputs."""
    return [json.loads(line[len(prefix):]) for out in outputs
            for line in out.splitlines() if line.startswith(prefix)]


def recovery_drill(task: dict, num_processes: int, work_dir: str, plan, *,
                   backend: dict | None = None, threads: int = 1,
                   env: dict | None = None, cwd: str | None = None,
                   timeout_s: float = 600.0, build_kernels: bool = False,
                   **launch_kw) -> dict:
    """Run the drill of one checkpointed ``task`` (a worker ``solve``
    task whose ``checkpoint`` has ``resume=True`` and a shared
    ``directory``) over ``num_processes`` ranks, ``plan`` (a
    ``chaos.FaultPlan``) armed on attempt 1 only.  ``work_dir`` holds the
    spec, the ranks' records and the flush sentinels.  Raises the fabric's
    error when attempt 2 fails too; the caller checks the returned
    record."""
    from repro_torch.parallel.fabric import run_resilient
    from repro_torch.parallel.worker import (RECOVERY_KILL, RECOVERY_RESULT,
                                             RECOVERY_RESUMED)

    sentinels = os.path.join(work_dir, "sentinels")
    os.makedirs(sentinels, exist_ok=True)
    spec = os.path.join(work_dir, "spec.json")
    with open(spec, "w") as f:
        json.dump({"backend": backend or {}, "out_dir": work_dir,
                   "threads": threads, "drill": {"sentinel_dir": sentinels},
                   "tasks": [task]}, f)
    started: dict[int, float] = {}
    flushed: dict[int, list[int]] = {}

    def attempt_env(attempt: int) -> dict:
        # called right before each launch: the time separates the
        # detection of attempt 1's failure from attempt 2's run
        started[attempt] = time.time()
        done = sorted(os.listdir(sentinels))
        flushed[attempt - 1] = [int(n.rsplit("rank", 1)[1]) for n in done]
        for n in done:
            os.remove(os.path.join(sentinels, n))
        return dict(plan.env()) if attempt == 1 else {}

    def argv(master: str, k: int, p: int, attempt: int) -> list[str]:
        return [sys.executable, "-m", "repro_torch.parallel.worker", spec]

    rr = run_resilient(argv, num_processes, max_failures=1, env=env,
                       attempt_env=attempt_env, cwd=cwd,
                       timeout_s=timeout_s, build_kernels=build_kernels,
                       **launch_kw)
    ended = time.time()
    out = {"attempts": rr.attempts,
           "procs_per_attempt": rr.procs_per_attempt,
           "results": markers(rr.result.outputs, RECOVERY_RESULT),
           "records": []}
    for r in range(rr.procs_per_attempt[-1]):
        with open(os.path.join(work_dir,
                               f"{task['name']}.rank{r}.json")) as f:
            out["records"].append(json.load(f))
    if not rr.failures:
        return out
    err = rr.failures[0]
    kills = markers(err.outputs, RECOVERY_KILL)
    resumed = markers(rr.result.outputs, RECOVERY_RESUMED)
    out.update({
        "failed_rank": err.failed_rank,
        "attempt1_exit_codes": getattr(err, "exit_codes", None),
        "attempt1_flushed_ranks": flushed.get(1, []),
        "attempt1_wall_s": started[2] - started[1],
        "attempt2_wall_s": ended - started[2],
        "kills": kills, "resumed": resumed})
    if kills and resumed:
        kill = kills[-1]
        res0 = next(r for r in resumed if r["rank"] == 0)
        out.update({
            "kill_upd": kill["upd"], "restored_tot": res0["tot"],
            "restored_upd": res0["upd"],
            "recomputed_updates": kill["upd"] - res0["upd"],
            "detection_s": max(started[2] - kill["t"], 0.0)})
    return out
