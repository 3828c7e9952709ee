"""Process-level fault plans for a group of ranks (counterpart of
``repro/chaos/faults.py``).

The payload layer (``repro_torch.chaos.inject``) perturbs VALUES; it
cannot make a rank slow or dead.  Those faults live at the process level,
where ``repro_torch.parallel.fabric`` supervises the group.  A
:class:`FaultPlan` describes one scripted fault a group and ships it to
every rank in environment variables; each rank calls
:func:`apply_from_env` once at start-up and wires the ``tick`` of
:func:`install_iteration_faults`'s :class:`IterationFaults` into
``CheckpointConfig.on_boundary``.

As in the JAX package, the delay fault is a start-up skew (the delayed
rank joins the group late, which stalls every collective after it), and
the kill is a hard ``os._exit`` with no unwinding, which the launcher's
watchdog must turn into a typed error.  Iteration-indexed faults fire at
drained-ring segment boundaries, the only points where the host sees the
solve, so two drills kill at the same boundary bit for bit.

Every function reads ``environ`` when it is given (a dict) and
``os.environ`` only when it is not.  ``_die`` is module-level so that a
test can replace it.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time

__all__ = ["ENV_KILL_RANK", "ENV_KILL_AFTER", "ENV_KILL_AT_ITER",
           "ENV_STALL_RANK", "ENV_STALL_AT_ITER", "ENV_STALL_FOR_S",
           "ENV_DELAY_RANK", "ENV_DELAY_S", "ENV_JITTER_S", "ENV_SEED",
           "KILL_EXIT_CODE", "FaultPlan", "apply_from_env",
           "IterationFaults", "install_iteration_faults"]

ENV_KILL_RANK = "REPRO_CHAOS_KILL_RANK"
ENV_KILL_AFTER = "REPRO_CHAOS_KILL_AFTER_S"
ENV_KILL_AT_ITER = "REPRO_CHAOS_KILL_AT_ITER"
ENV_STALL_RANK = "REPRO_CHAOS_STALL_RANK"
ENV_STALL_AT_ITER = "REPRO_CHAOS_STALL_AT_ITER"
ENV_STALL_FOR_S = "REPRO_CHAOS_STALL_FOR_S"
ENV_DELAY_RANK = "REPRO_CHAOS_DELAY_RANK"
ENV_DELAY_S = "REPRO_CHAOS_DELAY_S"
ENV_JITTER_S = "REPRO_CHAOS_JITTER_S"
ENV_SEED = "REPRO_CHAOS_SEED"

KILL_EXIT_CODE = 137          # SIGKILL's conventional exit status


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One scripted process-level fault for a launch of ranks.

    ``kill_rank``/``kill_after_s``   hard-kill that rank after the delay;
    ``kill_rank``/``kill_at_iter``   hard-kill that rank at the first
                                     segment boundary whose count reaches
                                     ``kill_at_iter`` (overrides the timed
                                     kill);
    ``stall_rank``/``stall_at_iter``/``stall_for_s``
                                     one sleep of ``stall_for_s`` (plus the
                                     seeded jitter) at the first boundary
                                     reaching ``stall_at_iter``: the
                                     wedged-but-alive rank the heartbeat
                                     watchdog must name;
    ``delay_rank``/``delay_s``       start-up skew for that rank, plus a
                                     seed-derived jitter of up to
                                     ``jitter_s``.
    """

    kill_rank: int | None = None
    kill_after_s: float = 1.0
    kill_at_iter: int | None = None
    stall_rank: int | None = None
    stall_at_iter: int = 0
    stall_for_s: float = 0.0
    delay_rank: int | None = None
    delay_s: float = 0.0
    jitter_s: float = 0.0
    seed: int = 0

    def env(self) -> dict[str, str]:
        """The environment fragment of this plan, the same for every rank
        (each rank matches its own rank against the plan)."""
        out = {ENV_SEED: str(self.seed)}
        if self.kill_rank is not None:
            out[ENV_KILL_RANK] = str(self.kill_rank)
            if self.kill_at_iter is not None:
                out[ENV_KILL_AT_ITER] = str(self.kill_at_iter)
            else:
                out[ENV_KILL_AFTER] = repr(float(self.kill_after_s))
        if self.stall_rank is not None:
            out[ENV_STALL_RANK] = str(self.stall_rank)
            out[ENV_STALL_AT_ITER] = str(self.stall_at_iter)
            out[ENV_STALL_FOR_S] = repr(float(self.stall_for_s))
        if self.delay_rank is not None:
            out[ENV_DELAY_RANK] = str(self.delay_rank)
            out[ENV_DELAY_S] = repr(float(self.delay_s))
            out[ENV_JITTER_S] = repr(float(self.jitter_s))
        return out


def _jitter(seed: int, rank: int, cap: float) -> float:
    """A deterministic jitter in [0, cap) from the seed and the rank (the
    JAX package's hash, the same floats)."""
    if cap <= 0:
        return 0.0
    h = (seed * 2654435761 + rank * 40503) & 0xFFFFFFFF
    h ^= h >> 16
    return cap * ((h & 0xFFFF) / float(1 << 16))


def apply_from_env(process_id: int, environ=None) -> dict:
    """Install this rank's share of the fault plan (rank side): sleep the
    start-up skew inline and arm the timed kill on a daemon thread.
    Returns what was installed (``delayed_s``, ``kill_after_s``); a no-op
    without a plan.  An iteration-indexed kill arms no thread (it is
    :class:`IterationFaults`'s)."""
    env = os.environ if environ is None else environ
    seed = int(env.get(ENV_SEED, "0"))
    installed: dict = {}

    delay_rank = env.get(ENV_DELAY_RANK)
    if delay_rank is not None and int(delay_rank) == process_id:
        delay = float(env.get(ENV_DELAY_S, "0"))
        delay += _jitter(seed, process_id, float(env.get(ENV_JITTER_S, "0")))
        time.sleep(delay)
        installed["delayed_s"] = delay

    kill_rank = env.get(ENV_KILL_RANK)
    if (kill_rank is not None and int(kill_rank) == process_id
            and ENV_KILL_AT_ITER not in env):
        after = float(env.get(ENV_KILL_AFTER, "1.0"))

        def _timed_die():
            time.sleep(after)
            _die()

        threading.Thread(target=_timed_die, daemon=True).start()
        installed["kill_after_s"] = after

    return installed


def _die() -> None:
    """Hard process death without unwinding (no atexit, no flushes): what
    an OOM-killed or power-lost rank looks like to its peers."""
    os._exit(KILL_EXIT_CODE)


class IterationFaults:
    """This rank's iteration-indexed faults (kill and stall), decoded by
    :func:`install_iteration_faults`.

    ``tick(it)`` is shaped for ``CheckpointConfig.on_boundary``: the
    checkpointed solve calls it with the solution-update count at every
    drained-ring boundary.  The stall fires once (a wedge, not a crawl);
    the kill at the first boundary whose count reaches ``kill_at_iter``.
    """

    def __init__(self, kill_at_iter: int | None = None,
                 stall_at_iter: int | None = None,
                 stall_for_s: float = 0.0):
        self.kill_at_iter = kill_at_iter
        self.stall_at_iter = stall_at_iter
        self.stall_for_s = stall_for_s
        self.stalled = False

    @property
    def armed(self) -> bool:
        return self.kill_at_iter is not None or self.stall_at_iter is not None

    def tick(self, it: int) -> None:
        if (self.stall_at_iter is not None and not self.stalled
                and it >= self.stall_at_iter):
            self.stalled = True
            time.sleep(self.stall_for_s)
        if self.kill_at_iter is not None and it >= self.kill_at_iter:
            _die()


def install_iteration_faults(process_id: int,
                             environ=None) -> IterationFaults:
    """Decode this rank's iteration-indexed faults (rank side): an
    :class:`IterationFaults` whose ``tick`` the caller wires into
    ``CheckpointConfig.on_boundary``; unarmed when the plan names another
    rank or there is no plan."""
    env = os.environ if environ is None else environ
    seed = int(env.get(ENV_SEED, "0"))
    kill_at = None
    kill_rank = env.get(ENV_KILL_RANK)
    if kill_rank is not None and int(kill_rank) == process_id:
        at = env.get(ENV_KILL_AT_ITER)
        kill_at = int(at) if at is not None else None
    stall_at, stall_for = None, 0.0
    stall_rank = env.get(ENV_STALL_RANK)
    if stall_rank is not None and int(stall_rank) == process_id:
        stall_at = int(env.get(ENV_STALL_AT_ITER, "0"))
        stall_for = float(env.get(ENV_STALL_FOR_S, "0"))
        stall_for += _jitter(seed, process_id,
                             float(env.get(ENV_JITTER_S, "0")))
    return IterationFaults(kill_at_iter=kill_at, stall_at_iter=stall_at,
                           stall_for_s=stall_for)
