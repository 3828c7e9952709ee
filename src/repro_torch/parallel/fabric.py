"""Launch and supervise a group of ranks (counterpart of
``repro/parallel/fabric.py``).

``launch_fabric`` starts P ranks as fresh processes (``subprocess``:
fork and exec, so no rank inherits a started CUDA context), each with
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` set for ``torch.distributed``'s ``env://`` rendezvous, and
waits for all of them.  Ranks run the same program, and every collective
blocks until each peer joins it, so a rank that dies leaves the others
waiting for ever; the launcher turns that into typed errors:

* a rank exits nonzero: the survivors are killed and
  :class:`FabricProcessError` names the rank and shows every rank's
  output tail; if the dead rank's output shows that the rendezvous port
  was taken, the whole group starts again on a fresh port;
* the group outlives ``timeout_s``: it is killed and
  :class:`FabricTimeoutError` is raised.

Each rank's output goes to a file (no pipe to fill) and comes back in
:class:`FabricResult`.  With ``build_kernels=True`` the launcher compiles
the CUDA kernels once before any rank starts, so ranks that start cold do
not race on the build directory.

The recovery pieces are the JAX package's:

* each rank gets a heartbeat file (``ENV_HEARTBEAT``) that it touches at
  progress points (:func:`touch_heartbeat`); every error gives one status
  line a rank, its exit status or ``running``/``wedged`` (alive but
  silent past ``wedge_after_s``) and the age of its last heartbeat;
* the teardown sends SIGTERM first, which a rank that called
  :func:`install_sigterm_handler` answers by running its flushes and
  exiting ``SIGTERM_EXIT_CODE`` (143), and SIGKILL after
  ``term_grace_s``;
* :func:`run_resilient` starts a fresh group after a failed one (a new
  rendezvous port, each rank partitioning the problem anew), up to
  ``max_failures`` times, optionally one rank fewer each time; ranks that
  checkpoint on a shared directory with ``resume=True`` continue from the
  last snapshot (``repro_torch.launch.recovery`` is the drill).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import signal
import socket
import subprocess
import tempfile
import time
from typing import Callable, Sequence

__all__ = ["FabricError", "FabricProcessError", "FabricTimeoutError",
           "FabricResult", "RecoveryResult", "ENV_HEARTBEAT",
           "SIGTERM_EXIT_CODE", "free_port", "install_sigterm_handler",
           "launch_fabric", "run_resilient", "touch_heartbeat"]

# Output fragments of a rendezvous port that another process took: the
# one start-up failure that a fresh port cures.
BIND_COLLISION_MARKERS = ("address already in use", "eaddrinuse",
                          "failed to bind")
HOST = "127.0.0.1"       # every rank runs on this machine
PORT_RETRIES = 3         # fresh ports tried after a collision
POLL_S = 0.1             # how often the launcher looks at its ranks
TERM_GRACE_S = 5.0       # SIGTERM to SIGKILL
WEDGE_AFTER_S = 5.0      # a live rank this long silent is "wedged"

# The variable that holds rank k's heartbeat file: the launcher sets it a
# rank, and a rank that touches the file at progress points lets every
# error tell a WEDGED rank (alive but silent, e.g. blocked in a collective)
# from a dead or merely slow one.
ENV_HEARTBEAT = "REPRO_FABRIC_HEARTBEAT"

# The exit status of a rank that shut down on the launcher's SIGTERM (128 +
# SIGTERM), distinct from a crash and from SIGKILL's 137: "a peer died and
# the launcher tore me down" against "I am the one that died".
SIGTERM_EXIT_CODE = 143


def install_sigterm_handler(*flushes: Callable[[], None],
                            exit_code: int = SIGTERM_EXIT_CODE) -> None:
    """Rank side: on SIGTERM, run ``flushes`` (a ring dump, a timeline
    save, a sentinel file) and exit with ``exit_code`` without unwinding.
    A flush that raises is skipped: it must not block the teardown.  The
    handler runs when the interpreter next gets control, so a rank blocked
    in a collective runs it once the collective fails or returns."""

    def _on_term(signum, frame):
        for fn in flushes:
            try:
                fn()
            except Exception:
                pass
        os._exit(exit_code)

    signal.signal(signal.SIGTERM, _on_term)


def touch_heartbeat(environ=None) -> str | None:
    """Rank side: touch the heartbeat file the launcher assigned this rank
    (``ENV_HEARTBEAT`` in ``environ``, default ``os.environ``) and return
    its path; None outside a launch.  Cheap enough to call at every
    boundary."""
    env = os.environ if environ is None else environ
    path = env.get(ENV_HEARTBEAT)
    if not path:
        return None
    with open(path, "a"):
        os.utime(path, None)
    return path


def _heartbeat_age(path: str | None, now: float, spawned: float) -> float:
    """Seconds since the rank last touched its heartbeat file, or since it
    was started when it never did."""
    if path:
        try:
            return max(now - os.path.getmtime(path), 0.0)
        except OSError:
            pass
    return max(now - spawned, 0.0)


def _rank_status(code: int | None, hb_age: float, wedge_after_s: float
                 ) -> str:
    """One line a rank: its exit status, or ``running``/``wedged`` (alive,
    heartbeat silent past ``wedge_after_s``), and its heartbeat age."""
    if code is None:
        state = "wedged" if hb_age > wedge_after_s else "running"
    else:
        state = f"exit {code}"
    return f"{state}, last heartbeat {hb_age:.1f}s ago"


class FabricError(RuntimeError):
    """Base class of a failed group of ranks."""


class FabricTimeoutError(FabricError):
    """The group outlived its wall-clock budget (a rank was still running,
    typically blocked in a collective whose peer never came); it was
    killed before this was raised."""


class FabricProcessError(FabricError):
    """A rank exited nonzero; the survivors, who would block in their next
    collective, were torn down before this was raised.  ``failed_rank``
    is the rank that failed, ``outputs`` every rank's output and
    ``exit_codes`` every rank's exit status after the teardown (143 for a
    rank that answered the SIGTERM, -9 for one that needed SIGKILL)."""


@dataclasses.dataclass
class FabricResult:
    """A group that finished: each rank's combined stdout and stderr, the
    rendezvous address it used, and 1 + the port retries."""

    outputs: list[str]
    master: str
    attempts: int


def free_port() -> int:
    """A port of ``HOST`` free at the time of asking.  Another process
    may take it before rank 0 binds it, which is why :func:`launch_fabric`
    retries a collision on a fresh port."""
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def _tail(text: str, n: int = 3000) -> str:
    return text[-n:]


def _kill_all(procs: Sequence[subprocess.Popen],
              grace_s: float = TERM_GRACE_S) -> None:
    """SIGTERM every live rank (its :func:`install_sigterm_handler` flushes
    and exits 143), SIGKILL those still alive after ``grace_s``, and reap
    them all."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        p.terminate()
    deadline = time.monotonic() + max(grace_s, 0.0)
    while live and time.monotonic() < deadline:
        time.sleep(0.05)
        live = [p for p in live if p.poll() is None]
    for p in live:
        p.kill()
    for p in procs:
        p.wait()


def _read(paths: Sequence[str]) -> list[str]:
    out = []
    for path in paths:
        with open(path, errors="replace") as f:
            out.append(f.read())
    return out


def launch_fabric(child_argv: Callable[[str, int], list[str]],
                  num_processes: int, *, env: dict | None = None,
                  cwd: str | None = None, timeout_s: float = 900.0,
                  build_kernels: bool = False, poll_s: float = POLL_S,
                  wedge_after_s: float = WEDGE_AFTER_S,
                  term_grace_s: float = TERM_GRACE_S) -> FabricResult:
    """Run one group of ``num_processes`` ranks to completion.

    ``child_argv(master, rank)`` builds rank ``rank``'s argv (``master`` is
    ``"host:port"``); each rank gets ``env`` (default: this process's
    environment) plus the rendezvous variables and its heartbeat file
    (``ENV_HEARTBEAT``).  The launcher looks at the ranks every ``poll_s``.
    Returns the outputs when every rank exits 0; raises
    :class:`FabricProcessError` or :class:`FabricTimeoutError` otherwise,
    with one status line a rank taken when the failure was seen (no rank
    is left running: the teardown waits ``term_grace_s`` between SIGTERM
    and SIGKILL)."""
    if num_processes < 1:
        raise ValueError(f"num_processes must be >= 1, got {num_processes}")
    if build_kernels:
        from repro_torch.kernels import _build

        _build.build_all()
    base_env = dict(os.environ if env is None else env)
    last: list[str] = []
    for attempt in range(1, PORT_RETRIES + 2):
        port = free_port()
        master = f"{HOST}:{port}"
        logdir = tempfile.mkdtemp(prefix="repro-torch-fabric-")
        logs = [os.path.join(logdir, f"rank{k}.log")
                for k in range(num_processes)]
        beats = [os.path.join(logdir, f"rank{k}.hb")
                 for k in range(num_processes)]
        procs: list[subprocess.Popen] = []

        def statuses(codes, spawned):
            now = time.time()
            return [_rank_status(c, _heartbeat_age(hb, now, spawned),
                                 wedge_after_s)
                    for c, hb in zip(codes, beats)]

        def detail(stat, outs):
            return "\n".join(f"--- rank {k} ({stat[k]}) ---\n{_tail(o)}"
                             for k, o in enumerate(outs))

        try:
            spawned = time.time()
            for k in range(num_processes):
                rank_env = {**base_env, "RANK": str(k),
                            "WORLD_SIZE": str(num_processes),
                            "LOCAL_RANK": str(k),
                            "LOCAL_WORLD_SIZE": str(num_processes),
                            "MASTER_ADDR": HOST, "MASTER_PORT": str(port),
                            ENV_HEARTBEAT: beats[k]}
                with open(logs[k], "w") as log:
                    procs.append(subprocess.Popen(
                        child_argv(master, k), env=rank_env, cwd=cwd,
                        stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout_s
            while True:
                codes = [p.poll() for p in procs]
                if all(c == 0 for c in codes):
                    return FabricResult(outputs=_read(logs), master=master,
                                        attempts=attempt)
                dead = [(k, c) for k, c in enumerate(codes)
                        if c is not None and c != 0]
                if dead:
                    # the statuses at detection are the diagnosis, not
                    # what the teardown leaves
                    stat = statuses(codes, spawned)
                    _kill_all(procs, term_grace_s)
                    last = _read(logs)
                    k0, c0 = dead[0]
                    if any(m in last[k0].lower()
                           for m in BIND_COLLISION_MARKERS):
                        break        # a fresh port, the same group
                    err = FabricProcessError(
                        f"rank {k0} of {num_processes} exited {c0} "
                        f"(master {master}); the other ranks were torn "
                        f"down\n{detail(stat, last)}")
                    err.outputs, err.failed_rank = last, k0
                    err.exit_codes = [p.poll() for p in procs]
                    raise err
                if time.monotonic() > deadline:
                    stat = statuses(codes, spawned)
                    running = [k for k, c in enumerate(codes) if c is None]
                    _kill_all(procs, term_grace_s)
                    last = _read(logs)
                    err = FabricTimeoutError(
                        f"the group of {num_processes} rank(s) outlived "
                        f"{timeout_s:.0f} s (ranks {running} still running, "
                        f"master {master}) and was killed\n"
                        f"{detail(stat, last)}")
                    err.outputs = last
                    err.failed_rank = running[0] if running else None
                    err.exit_codes = [p.poll() for p in procs]
                    raise err
                time.sleep(poll_s)
        finally:
            _kill_all(procs, term_grace_s)
            shutil.rmtree(logdir, ignore_errors=True)
    raise FabricProcessError(
        f"the rendezvous port was taken in {PORT_RETRIES + 1} attempts\n"
        + "\n".join(f"--- rank {k} ---\n{_tail(o)}"
                    for k, o in enumerate(last)))


@dataclasses.dataclass
class RecoveryResult:
    """What :func:`run_resilient` supervised: the group that finished,
    the launches made (the last included), the error of each failed one in
    order, and each launch's number of ranks."""

    result: FabricResult
    attempts: int
    failures: list[FabricError]
    procs_per_attempt: list[int]


def run_resilient(child_argv: Callable[[str, int, int, int], list[str]],
                  num_processes: int, *, max_failures: int = 1,
                  shrink: bool = False, min_processes: int = 1,
                  env: dict | None = None,
                  attempt_env: Callable[[int], dict] | None = None,
                  **launch_kw) -> RecoveryResult:
    """Run :func:`launch_fabric` and, after a :class:`FabricProcessError`
    or :class:`FabricTimeoutError` (a dead or wedged rank; the launcher has
    torn the group down), start a fresh group: a new rendezvous port, and
    each rank building its partition of the problem anew.  Ranks that
    checkpoint on a shared directory with ``resume=True`` continue from the
    last snapshot.

    ``child_argv(master, rank, num_processes, attempt)`` builds a rank's
    argv (a shrunk group tells its ranks the new world size).
    ``shrink=True`` drops one rank a failure, never below
    ``min_processes``; ``attempt_env(attempt)`` merges variables over
    ``env`` for one attempt (a fault plan armed on the first only).  After
    ``max_failures`` failures the last error is raised again; the other
    keyword arguments go to :func:`launch_fabric`."""
    failures: list[FabricError] = []
    procs_hist: list[int] = []
    procs = num_processes
    for attempt in range(1, max_failures + 2):
        procs_hist.append(procs)
        aenv = dict(os.environ if env is None else env)
        if attempt_env is not None:
            aenv.update(attempt_env(attempt))

        def argv(master: str, k: int, _p=procs, _a=attempt) -> list[str]:
            return child_argv(master, k, _p, _a)

        try:
            result = launch_fabric(argv, procs, env=aenv, **launch_kw)
            return RecoveryResult(result=result, attempts=attempt,
                                  failures=failures,
                                  procs_per_attempt=procs_hist)
        except (FabricProcessError, FabricTimeoutError) as e:
            failures.append(e)
            if attempt > max_failures:
                raise
            if shrink and procs > min_processes:
                procs -= 1
    raise AssertionError("unreachable")
