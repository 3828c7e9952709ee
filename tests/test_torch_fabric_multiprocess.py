"""The launcher's recovery pieces and checkpointed solves over real ranks:
gloo processes on the CPU started by ``repro_torch.parallel.fabric``
(``launch_fabric``, ``run_resilient``), each a ``python -c`` child or a
``python -m repro_torch.parallel.worker`` rank.

These start processes, install signal handlers in them and kill them, so
they are opt-in, gated as ``tests/test_torch_multiprocess.py`` is::

    RUN_MULTIPROCESS=1 PYTHONPATH=src python -m pytest tests/test_torch_fabric_multiprocess.py

Cases (the JAX package's ``tests/test_fabric.py`` and
``scripts/multiprocess_parity.py --recovery``, on the port):
* four gloo ranks, checkpointed and resumed, bitwise against
  ``rank_oracle_ops`` (4 virtual shards) through the one-device segmented
  drive;
* the kill-a-rank drill (``launch.recovery.recovery_drill``): rank 2
  killed at the boundary of update 120 exits 137, the survivors answer
  the SIGTERM with their flush sentinels and 143, attempt 2 restores with
  at most ``every`` updates computed again and ends bitwise the
  uninterrupted oracle on every rank;
* the shrink drill: the second attempt runs 3 ranks and ends bitwise the
  3-shard oracle restored from the same snapshot;
* the SIGTERM flush and exit 143; SIGKILL for a rank that ignores SIGTERM;
  a wedged rank named ``wedged``.

The SIGTERM case waits for the survivor's "armed" file before its peer
exits: the JAX package's ``test_sigterm_handler_flushes_before_exit``
races the handler's installation against the launcher's SIGTERM (ROADMAP
queue 3's unsteady list), and a SIGTERM that comes first kills the rank
before it can flush.

Tolerances: bitwise (digests of x and the residual history), and exact
exit codes.
"""

import json
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.skipif(
    os.environ.get("RUN_MULTIPROCESS") != "1",
    reason="set RUN_MULTIPROCESS=1 to start gloo ranks and kill them "
           "(multi-process)",
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
EVERY, KILL_AT, MAXIT = 40, 120, 240


def _env():
    return dict(os.environ, PYTHONPATH=SRC)


def _argv_script(body: str):
    def child_argv(master, k):
        return [sys.executable, "-c", body.replace("RANK", str(k))]
    return child_argv


def _problem(tmp, nx=24, ny=24):
    """A stencil that splits over 4 and 3 ranks, Jacobi, its shifts, as
    worker inputs; returns (op, prec, b, kw, task fields)."""
    from repro_torch.core.chebyshev import shifts_for_operator
    from repro_torch.linalg import JacobiPrec, Stencil2D5

    op = Stencil2D5(nx, ny, device="cpu")
    prec = JacobiPrec.from_operator(op)
    b = torch.as_tensor(np.random.default_rng(7).standard_normal(op.n))
    sig = shifts_for_operator(op, 2, prec=prec)
    np.savez(os.path.join(tmp, "in.npz"), b=b.numpy(), sig=sig.numpy())
    np.savez(os.path.join(tmp, "op.npz"), kind="stencil2d5", nx=nx, ny=ny)
    kw = dict(l=2, tol=1e-30, maxit=MAXIT, fused_iteration=True, unroll=4)
    fields = {"kind": "solve",
              "operator": {"npz": os.path.join(tmp, "op.npz")},
              "rhs": {"npz": os.path.join(tmp, "in.npz"), "key": "b"},
              "sigmas": {"npz": os.path.join(tmp, "in.npz"), "key": "sig"},
              "method": "plcg", "reduction": "staged", "stages": 2,
              "solver": kw}
    return op, prec, b, dict(kw, sigmas=sig), fields


def _oracle(op, prec, b, kw, p, cfg):
    from repro_torch.checkpoint import checkpointed_solve
    from repro_torch.parallel.distributed import rank_oracle_ops
    from repro_torch.parallel.reduction import StagedConfig
    from repro_torch.parallel.worker import digest

    res = checkpointed_solve(rank_oracle_ops(op, prec, StagedConfig(p)), b,
                             "plcg", None, cfg, dict(kw))
    return [digest(res.x), digest(res.res_history)]


def test_four_ranks_checkpointed_and_resumed(tmp_path):
    from repro_torch.checkpoint import CheckpointConfig
    from repro_torch.parallel.fabric import launch_fabric

    op, prec, b, kw, fields = _problem(str(tmp_path))
    ck = str(tmp_path / "ckpt")
    tasks = [dict(fields, name=name,
                  checkpoint={"every": EVERY, "directory": ck,
                              "resume": resume})
             for name, resume in (("full", False), ("resume", True))]
    spec = str(tmp_path / "spec.json")
    with open(spec, "w") as f:
        json.dump({"backend": {"device": "cpu", "pg_backend": "gloo"},
                   "out_dir": str(tmp_path), "tasks": tasks}, f)
    launch_fabric(lambda m, k: [sys.executable, "-m",
                                "repro_torch.parallel.worker", spec],
                  4, env=_env(), timeout_s=300)
    want = _oracle(op, prec, b, kw, 4, CheckpointConfig(every=EVERY))
    for name in ("full", "resume"):
        for r in range(4):
            with open(tmp_path / f"{name}.rank{r}.json") as f:
                rec = json.load(f)
            assert [rec["x_sha256"], rec["history_sha256"]] == want
            if name == "resume":
                assert rec["restored"]["tot"] > 0
            elif r == 0:
                assert rec["snapshots"] and all(
                    s["bytes"] > 0 for s in rec["snapshots"])


def _drill(tmp_path, **kw):
    from repro_torch.chaos import FaultPlan
    from repro_torch.launch.recovery import recovery_drill

    op, prec, b, skw, fields = _problem(str(tmp_path))
    ck = str(tmp_path / "ckpt")
    task = dict(fields, name="drill",
                checkpoint={"every": EVERY, "directory": ck, "resume": True,
                            "keep": 100})
    work = str(tmp_path / "work")
    os.makedirs(work)
    out = recovery_drill(task, 4, work, FaultPlan(kill_rank=2,
                                                  kill_at_iter=KILL_AT,
                                                  seed=7),
                         backend={"device": "cpu", "pg_backend": "gloo"},
                         env=_env(), timeout_s=300, **kw)
    return out, (op, prec, b, skw, ck)


def test_kill_a_rank_drill(tmp_path):
    from repro_torch.checkpoint import CheckpointConfig
    from repro_torch.parallel.fabric import SIGTERM_EXIT_CODE

    out, (op, prec, b, kw, _) = _drill(tmp_path)
    assert out["attempts"] == 2 and out["procs_per_attempt"] == [4, 4]
    assert out["failed_rank"] == 2
    assert out["attempt1_exit_codes"] == [SIGTERM_EXIT_CODE] * 2 + [137] + [
        SIGTERM_EXIT_CODE]
    assert out["attempt1_flushed_ranks"] == [0, 1, 3]
    assert out["kill_upd"] >= KILL_AT
    assert out["restored_tot"] >= KILL_AT - EVERY
    assert 0 < out["recomputed_updates"] <= EVERY
    assert out["detection_s"] < 30
    want = _oracle(op, prec, b, kw, 4, CheckpointConfig(every=EVERY))
    assert len(out["results"]) == 4
    for row in out["results"]:
        assert [row["x_sha256"], row["history_sha256"]] == want


def test_shrink_drill(tmp_path):
    """With ``shrink=True`` the second group has 3 ranks: it restores the
    4-rank snapshot (the stencil keeps its row order) and ends bitwise
    the 3-shard oracle restored from the same file."""
    from repro_torch.checkpoint import CheckpointConfig

    out, (op, prec, b, kw, ck) = _drill(tmp_path, shrink=True)
    assert out["procs_per_attempt"] == [4, 3]
    res0 = next(r for r in out["resumed"] if r["rank"] == 0)
    d = str(tmp_path / "one_process")
    os.makedirs(d)
    shutil.copy(os.path.join(ck, res0["path"]), d)
    want = _oracle(op, prec, b, kw, 3, CheckpointConfig(
        every=EVERY, directory=d, resume=True, keep=100))
    assert len(out["results"]) == 3
    for row in out["results"]:
        assert [row["x_sha256"], row["history_sha256"]] == want


def test_sigterm_handler_flushes_before_exit(tmp_path):
    from repro_torch.parallel.fabric import (SIGTERM_EXIT_CODE,
                                             FabricProcessError,
                                             launch_fabric)

    sentinel, armed = tmp_path / "flushed_rank0", tmp_path / "armed_rank0"
    body = (f"import os, sys, time\n"
            f"if RANK == 1:\n"
            f"    while not os.path.exists({str(armed)!r}):\n"
            f"        time.sleep(0.02)\n"
            f"    sys.exit(7)\n"
            f"from repro_torch.parallel.fabric import install_sigterm_handler\n"
            f"install_sigterm_handler(\n"
            f"    lambda: open({str(sentinel)!r}, 'w').write('flushed'))\n"
            f"open({str(armed)!r}, 'w').close()\n"
            f"print('handler armed', flush=True)\n"
            f"time.sleep(120)\n")
    with pytest.raises(FabricProcessError, match="rank 1 of 2 exited 7") as e:
        launch_fabric(_argv_script(body), 2, env=_env(), timeout_s=60,
                      poll_s=0.05, term_grace_s=5.0)
    assert sentinel.read_text() == "flushed"
    assert e.value.exit_codes == [SIGTERM_EXIT_CODE, 7]


def test_sigkill_escalation_for_sigterm_ignoring_rank():
    from repro_torch.parallel.fabric import FabricProcessError, launch_fabric

    body = ("import signal, sys, time\n"
            "if RANK == 1:\n"
            "    time.sleep(1.0); sys.exit(9)\n"
            "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
            "print('sigterm ignored', flush=True)\n"
            "time.sleep(120)\n")
    t0 = time.monotonic()
    with pytest.raises(FabricProcessError, match="rank 1 of 2 exited 9") as e:
        launch_fabric(_argv_script(body), 2, env=_env(), timeout_s=300,
                      poll_s=0.05, term_grace_s=0.5)
    assert time.monotonic() - t0 < 30
    assert e.value.exit_codes == [-9, 9]


def test_wedged_rank_distinguished_from_slow_one():
    from repro_torch.parallel.fabric import (ENV_HEARTBEAT,
                                             FabricProcessError,
                                             launch_fabric)

    body = ("import os, sys, time\n"
            "hb = os.environ.get('" + ENV_HEARTBEAT + "')\n"
            "open(hb, 'a').close(); os.utime(hb, None)\n"
            "if RANK == 1:\n"
            "    time.sleep(1.5); sys.exit(5)\n"
            "time.sleep(120)\n")
    with pytest.raises(FabricProcessError) as ei:
        launch_fabric(_argv_script(body), 2, env=_env(), timeout_s=300,
                      poll_s=0.05, wedge_after_s=0.5)
    msg = str(ei.value)
    assert "rank 1 of 2 exited 5" in msg
    assert "(wedged," in msg and "(exit 5," in msg
    assert "last heartbeat" in msg
