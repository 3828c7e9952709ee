"""Injectable time source for the serving layer (counterpart of
``repro/serve/clock.py``, DESIGN.md §15).

Everything time-shaped in ``repro_torch.serve`` — request ``submitted_at``
stamps, latency accounting, admission deadlines, shed decisions — reads
the clock through this one seam.  Production uses :class:`SystemClock`
(``time.perf_counter`` / ``time.sleep``); tests and the open-loop replay
harness (``repro_torch.serve.replay``) use :class:`VirtualClock`, whose time
only moves when the harness advances it.  That is what makes scheduler
behavior — packing order, steal decisions, shed decisions, latency
percentiles — bit-for-bit reproducible in CI: two replays of the same
seeded trace observe the *identical* sequence of timestamps, so every
time-dependent branch resolves the same way (tests/test_torch_serve_replay.py
asserts equal retirement logs).

Both clocks share one interface, so the replay loop has a single code
path: ``clock.sleep(dt)`` really sleeps on the system clock and simply
advances virtual time on the virtual one.
"""

from __future__ import annotations

import time


class Clock:
    """Time-source interface: monotonic ``now()`` plus ``sleep(dt)``."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, dt: float) -> None:
        raise NotImplementedError


class SystemClock(Clock):
    """Wall-clock time (monotonic): the production default."""

    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


class VirtualClock(Clock):
    """Deterministic manually-advanced time for tests and replay.

    ``sleep`` advances time instantly — the replay harness models the
    cost of a scheduler tick as a deterministic function of the work it
    ran and "sleeps" that long, so latency percentiles are exact
    arithmetic on the trace, never measurements.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"cannot sleep a negative duration ({dt})")
        self._t += dt

    # alias: harness code reads better as clock.advance(dt)
    advance = sleep
