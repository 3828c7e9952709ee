"""The launcher's recovery pieces (``repro_torch.parallel.fabric``), held
against the JAX package's ``repro.parallel.fabric`` on the same inputs, in
ONE process: no process is started, no signal handler installed, no
environment variable written.  ``run_resilient`` runs with
``launch_fabric`` replaced, in both packages, by the same scripted
sequence of results and typed errors; the heartbeat writes only under
``tmp_path``.  The launches of real ranks (SIGTERM flush, SIGKILL
escalation, wedge detection, the drill) are in
``tests/test_torch_fabric_multiprocess.py`` (``RUN_MULTIPROCESS=1``).

Tolerances: none; status lines, ages and the supervisor's record are
compared exactly.
"""

import importlib.util
import os

import pytest

from repro_torch.parallel import fabric

HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    from repro.parallel import fabric as jfabric


@pytest.fixture
def with_jax():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the reference")


def test_constants_match_jax(with_jax):
    assert fabric.ENV_HEARTBEAT == jfabric.ENV_HEARTBEAT
    assert fabric.SIGTERM_EXIT_CODE == jfabric.SIGTERM_EXIT_CODE == 143


def test_touch_heartbeat(tmp_path):
    """Outside a launch (no variable) a no-op returning None; inside, the
    assigned file is created, then touched again."""
    assert fabric.touch_heartbeat({}) is None
    assert fabric.touch_heartbeat({fabric.ENV_HEARTBEAT: ""}) is None
    p = str(tmp_path / "rank0.hb")
    assert fabric.touch_heartbeat({fabric.ENV_HEARTBEAT: p}) == p
    assert os.path.exists(p)
    os.utime(p, (1.0, 1.0))
    assert fabric.touch_heartbeat({fabric.ENV_HEARTBEAT: p}) == p
    assert os.path.getmtime(p) > 1.0


@pytest.mark.parametrize("code", [None, 0, 1, 137, 143, -9, -15])
@pytest.mark.parametrize("age", [0.0, 0.04, 0.5, 0.51, 5.0, 7.25, 123.456])
def test_rank_status_lines_match_jax(code, age, with_jax):
    for wedge in (0.5, 5.0):
        got = fabric._rank_status(code, age, wedge)
        assert got == jfabric._rank_status(code, age, wedge)
    if code is None:
        assert fabric._rank_status(None, 6.0, 5.0).startswith("wedged,")
        assert fabric._rank_status(None, 4.0, 5.0).startswith("running,")


def test_heartbeat_age_matches_jax(tmp_path, with_jax):
    p = tmp_path / "rank1.hb"
    p.touch()
    os.utime(p, (1000.0, 1000.0))
    for path in (str(p), None, str(tmp_path / "never-touched.hb")):
        for now, spawned in ((1000.0, 990.0), (1012.5, 1001.0),
                             (999.0, 998.0)):
            assert (fabric._heartbeat_age(path, now, spawned)
                    == jfabric._heartbeat_age(path, now, spawned))


# ------------------------------------------------------- run_resilient --
def _scripted(mod, script, calls):
    """A ``launch_fabric`` for ``mod`` that plays ``script``: one entry
    per launch, ``"ok"`` for a result, ``("fail", rank)`` or
    ``("timeout", rank)`` for a typed error.  Each call records the group
    size, the argv of every rank and the environment it was given."""
    def launch(child_argv, num_processes, *, env=None, **kw):
        step = script[len(calls)]
        calls.append({"procs": num_processes,
                      "argv": [child_argv("m:1", k)
                               for k in range(num_processes)],
                      "armed": (env or {}).get("FAULT_ARMED"),
                      "kw": sorted(kw)})
        if step == "ok":
            return (mod.FabricResult(outputs=["ok"] * num_processes,
                                     master="m:1", attempts=1)
                    if mod is fabric else
                    mod.FabricResult(outputs=["ok"] * num_processes,
                                     coordinator="m:1", attempts=1))
        kind, rank = step
        err = (mod.FabricProcessError if kind == "fail"
               else mod.FabricTimeoutError)(f"rank {rank} {kind}")
        err.failed_rank = rank
        err.outputs = []
        raise err
    return launch


SCRIPTS = [
    (["ok"], dict(max_failures=1)),
    ([("fail", 2), "ok"], dict(max_failures=1)),
    ([("timeout", 0), "ok"], dict(max_failures=2)),
    ([("fail", 1), ("fail", 0), "ok"], dict(max_failures=2, shrink=True,
                                            min_processes=1)),
    ([("fail", 3), ("fail", 2), ("fail", 1), "ok"],
     dict(max_failures=3, shrink=True, min_processes=3)),
    ([("fail", 1), ("timeout", 1)], dict(max_failures=1)),
    ([("fail", 0), ("fail", 0), ("fail", 0)], dict(max_failures=2,
                                                   shrink=True)),
]


def _run(mod, script, kw, monkeypatch):
    calls: list = []
    monkeypatch.setattr(mod, "launch_fabric", _scripted(mod, script, calls))
    seen = []

    def attempt_env(a):
        seen.append(a)
        return {"FAULT_ARMED": "1"} if a == 1 else {}

    def argv(master, k, p, a):
        return [master, str(k), str(p), str(a)]

    try:
        rr = mod.run_resilient(argv, 4, env={"BASE": "1"},
                               attempt_env=attempt_env, timeout_s=9.0,
                               poll_s=0.01, **kw)
        out = {"attempts": rr.attempts,
               "procs_per_attempt": rr.procs_per_attempt,
               "failures": [(type(e).__name__, e.failed_rank)
                            for e in rr.failures],
               "outputs": rr.result.outputs, "raised": None}
    except mod.FabricError as e:
        out = {"raised": (type(e).__name__, e.failed_rank)}
    out["calls"], out["attempt_env"] = calls, seen
    return out


@pytest.mark.parametrize("script,kw", SCRIPTS)
def test_run_resilient_matches_jax(script, kw, monkeypatch, with_jax):
    """Attempts, failures (type and rank), ranks per attempt (one fewer a
    failure with ``shrink``, never below ``min_processes``), the argv of
    each rank (the attempt and the group size), ``attempt_env`` called
    once an attempt and armed on the first only, the launch keywords
    passed through, and the last error raised again when the budget is
    spent: the JAX package's, step for step."""
    ours = _run(fabric, script, kw, monkeypatch)
    theirs = _run(jfabric, script, kw, monkeypatch)
    assert ours == theirs
    n = len(ours["calls"])
    assert ours["attempt_env"] == list(range(1, n + 1))
    assert [c["armed"] for c in ours["calls"]] == ["1"] + [None] * (n - 1)
    for a, c in enumerate(ours["calls"], start=1):
        assert c["argv"] == [["m:1", str(k), str(c["procs"]), str(a)]
                             for k in range(c["procs"])]
        assert c["kw"] == ["poll_s", "timeout_s"]
