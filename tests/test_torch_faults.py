"""Process-level fault plans (``repro_torch.chaos.faults``), held against
the JAX package's ``repro.chaos.faults`` on the same inputs, in ONE
process: no signal handler, no process, no write to ``os.environ``.
Every plan is read from an ``environ`` dict, and every kill goes through
``_die`` replaced by a function that raises, so nothing here can end the
process.  The one timed kill (``apply_from_env``'s daemon thread) runs
with ``_die`` replaced and its thread joined before the test ends.  The
launches that really kill ranks are in
``tests/test_torch_fabric_multiprocess.py`` (``RUN_MULTIPROCESS=1``).

Tolerances: none; every value is compared exactly (the jitter is the
same float, bit for bit).
"""

import importlib.util
import threading
import types

import pytest

from repro_torch.chaos import ChaosConfig, faults

# The card's machine has no JAX; nothing here needs the card either.
HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    from repro.chaos import ChaosConfig as JChaosConfig
    from repro.chaos import faults as jfaults

PLANS = [
    dict(),
    dict(kill_rank=2, kill_at_iter=600, seed=7),
    dict(kill_rank=1, kill_after_s=0.25),
    dict(stall_rank=3, stall_at_iter=40, stall_for_s=1.5, jitter_s=0.5,
         seed=11),
    dict(delay_rank=0, delay_s=0.125, jitter_s=0.0625, seed=3),
    dict(kill_rank=0, kill_at_iter=5, stall_rank=0, stall_at_iter=2,
         stall_for_s=0.0, delay_rank=1, delay_s=0.5, seed=2 ** 31 + 5),
]


class Died(Exception):
    """What the replaced ``_die`` raises."""


@pytest.fixture
def with_jax():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the reference")


@pytest.fixture
def no_death(monkeypatch):
    """``_die`` raises ``Died`` instead of ending the process."""
    def die():
        raise Died()

    monkeypatch.setattr(faults, "_die", die)


def test_env_names_and_exit_code(with_jax):
    names = [n for n in dir(jfaults) if n.startswith("ENV_")]
    assert len(names) == 10
    for n in names:
        assert getattr(faults, n) == getattr(jfaults, n)
    assert faults.KILL_EXIT_CODE == jfaults.KILL_EXIT_CODE == 137


@pytest.mark.parametrize("plan", PLANS)
def test_fault_plan_env_and_chaos_config_match_jax(plan, with_jax):
    """``FaultPlan.env()`` is the JAX dict; ``ChaosConfig.fault_plan()``
    (which no longer raises) gives the JAX plan's fields and env."""
    assert faults.FaultPlan(**plan).env() == jfaults.FaultPlan(**plan).env()
    cfg = dict(seed=plan.get("seed", 0), kill_rank=plan.get("kill_rank"),
               kill_rank_at_iter=plan.get("kill_at_iter"),
               stall_rank=plan.get("stall_rank"),
               stall_rank_at_iter=plan.get("stall_at_iter", 0),
               stall_rank_for_s=plan.get("stall_for_s", 0.0))
    ours, theirs = (ChaosConfig(**cfg).fault_plan(),
                    JChaosConfig(**cfg).fault_plan())
    assert isinstance(ours, faults.FaultPlan)
    assert vars(ours) == vars(theirs)
    assert ours.env() == theirs.env()


def test_jitter_is_the_jax_float(with_jax):
    for seed in (0, 1, 7, 12345, 2 ** 32 - 1, 2 ** 40 + 3):
        for rank in range(9):
            for cap in (0.0, -1.0, 0.5, 3.0):
                got = faults._jitter(seed, rank, cap)
                want = jfaults._jitter(seed, rank, cap)
                assert got == want and type(got) is type(want)
                assert 0.0 <= got < max(cap, 1e-300) or got == 0.0


@pytest.mark.parametrize("plan", PLANS)
def test_install_iteration_faults_decodes_like_jax(plan, with_jax):
    env = faults.FaultPlan(**plan).env()
    for rank in range(5):
        ours = faults.install_iteration_faults(rank, environ=env)
        theirs = jfaults.install_iteration_faults(rank, environ=env)
        assert (ours.kill_at_iter, ours.stall_at_iter, ours.stall_for_s,
                ours.armed) == (theirs.kill_at_iter, theirs.stall_at_iter,
                                theirs.stall_for_s, theirs.armed)
    assert not faults.install_iteration_faults(0, environ={}).armed


def test_tick_kills_at_the_first_boundary_reaching_the_count(no_death):
    f = faults.install_iteration_faults(
        2, environ=faults.FaultPlan(kill_rank=2, kill_at_iter=600).env())
    assert f.armed
    for upd in (0, 200, 400, 599):
        f.tick(upd)
    with pytest.raises(Died):
        f.tick(600)
    with pytest.raises(Died):
        f.tick(800)
    other = faults.install_iteration_faults(
        1, environ=faults.FaultPlan(kill_rank=2, kill_at_iter=600).env())
    assert not other.armed
    other.tick(10 ** 6)                  # another rank's plan: no-op


def test_stall_is_one_shot(monkeypatch, no_death):
    """The stall sleeps once, at the first boundary reaching its count
    (a wedge, not a crawl), for ``stall_for_s`` plus the seeded jitter
    (whose cap the plan ships with its delay fault, here on rank 0)."""
    slept = []
    monkeypatch.setattr(faults, "time", types.SimpleNamespace(
        sleep=slept.append))
    env = faults.FaultPlan(stall_rank=1, stall_at_iter=40, stall_for_s=2.0,
                           delay_rank=0, jitter_s=0.5, seed=9).env()
    f = faults.install_iteration_faults(1, environ=env)
    f.tick(39)
    assert slept == [] and not f.stalled
    f.tick(40)
    f.tick(80)
    f.tick(120)
    assert slept == [2.0 + faults._jitter(9, 1, 0.5)] and f.stalled


def test_apply_from_env_without_a_timed_kill(monkeypatch):
    """No plan, another rank's plan, and an iteration-indexed kill arm
    nothing; a delay plan sleeps its skew inline (the module's ``time``
    replaced, so nothing waits) and reports it."""
    slept = []
    monkeypatch.setattr(faults, "time", types.SimpleNamespace(
        sleep=slept.append))
    before = set(threading.enumerate())
    assert faults.apply_from_env(0, environ={}) == {}
    assert faults.apply_from_env(
        1, environ=faults.FaultPlan(kill_rank=2, kill_after_s=0.1).env()) == {}
    assert faults.apply_from_env(
        2, environ=faults.FaultPlan(kill_rank=2, kill_at_iter=6).env()) == {}
    env = faults.FaultPlan(delay_rank=3, delay_s=0.25, jitter_s=0.125,
                           seed=5).env()
    got = faults.apply_from_env(3, environ=env)
    want = 0.25 + faults._jitter(5, 3, 0.125)
    assert got == {"delayed_s": want} and slept == [want]
    assert set(threading.enumerate()) == before


def test_apply_from_env_timed_kill_runs_die_on_its_thread(monkeypatch):
    """The timed kill: a daemon thread sleeps ``kill_after_s`` and calls
    ``_die``.  Here ``_die`` is replaced by a recorder and the thread is
    joined before the test returns."""
    done = threading.Event()
    monkeypatch.setattr(faults, "_die", done.set)
    before = set(threading.enumerate())
    got = faults.apply_from_env(
        4, environ=faults.FaultPlan(kill_rank=4, kill_after_s=0.0).env())
    assert got == {"kill_after_s": 0.0}
    for t in set(threading.enumerate()) - before:
        assert t.daemon
        t.join(timeout=10)
        assert not t.is_alive()
    assert done.wait(timeout=10)
