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
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import socket
import subprocess
import tempfile
import time
from typing import Callable, Sequence

__all__ = ["FabricError", "FabricProcessError", "FabricTimeoutError",
           "FabricResult", "free_port", "launch_fabric"]

# Output fragments of a rendezvous port that another process took: the
# one start-up failure that a fresh port cures.
BIND_COLLISION_MARKERS = ("address already in use", "eaddrinuse",
                          "failed to bind")
HOST = "127.0.0.1"       # every rank runs on this machine
PORT_RETRIES = 3         # fresh ports tried after a collision
POLL_S = 0.1             # how often the launcher looks at its ranks
TERM_GRACE_S = 5.0       # SIGTERM to SIGKILL


class FabricError(RuntimeError):
    """Base class of a failed group of ranks."""


class FabricTimeoutError(FabricError):
    """The group outlived its wall-clock budget (a rank was still running,
    typically blocked in a collective whose peer never came); it was
    killed before this was raised."""


class FabricProcessError(FabricError):
    """A rank exited nonzero; the survivors, who would block in their next
    collective, were killed before this was raised."""


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


def _kill_all(procs: Sequence[subprocess.Popen]) -> None:
    """SIGTERM every live rank, SIGKILL those still alive after
    ``TERM_GRACE_S``, and reap them all."""
    live = [p for p in procs if p.poll() is None]
    for p in live:
        p.terminate()
    deadline = time.monotonic() + TERM_GRACE_S
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
                  build_kernels: bool = False) -> FabricResult:
    """Run one group of ``num_processes`` ranks to completion.

    ``child_argv(master, rank)`` builds rank ``rank``'s argv (``master`` is
    ``"host:port"``); each rank gets ``env`` (default: this process's
    environment) plus the rendezvous variables.  Returns the outputs when
    every rank exits 0; raises :class:`FabricProcessError` or
    :class:`FabricTimeoutError` otherwise (no rank is left running)."""
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
        procs: list[subprocess.Popen] = []
        try:
            for k in range(num_processes):
                rank_env = {**base_env, "RANK": str(k),
                            "WORLD_SIZE": str(num_processes),
                            "LOCAL_RANK": str(k),
                            "LOCAL_WORLD_SIZE": str(num_processes),
                            "MASTER_ADDR": HOST, "MASTER_PORT": str(port)}
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
                    _kill_all(procs)
                    last = _read(logs)
                    k0, c0 = dead[0]
                    if any(m in last[k0].lower()
                           for m in BIND_COLLISION_MARKERS):
                        break        # a fresh port, the same group
                    err = FabricProcessError(
                        f"rank {k0} of {num_processes} exited {c0} "
                        f"(master {master}); the other ranks were killed\n"
                        + "\n".join(f"--- rank {k} (exit {procs[k].poll()})"
                                    f" ---\n{_tail(o)}"
                                    for k, o in enumerate(last)))
                    err.outputs, err.failed_rank = last, k0
                    raise err
                if time.monotonic() > deadline:
                    running = [k for k, c in enumerate(codes) if c is None]
                    _kill_all(procs)
                    last = _read(logs)
                    err = FabricTimeoutError(
                        f"the group of {num_processes} rank(s) outlived "
                        f"{timeout_s:.0f} s (ranks {running} still running, "
                        f"master {master}) and was killed\n"
                        + "\n".join(f"--- rank {k} ---\n{_tail(o)}"
                                    for k, o in enumerate(last)))
                    err.outputs = last
                    err.failed_rank = running[0] if running else None
                    raise err
                time.sleep(POLL_S)
        finally:
            _kill_all(procs)
            shutil.rmtree(logdir, ignore_errors=True)
    raise FabricProcessError(
        f"the rendezvous port was taken in {PORT_RETRIES + 1} attempts\n"
        + "\n".join(f"--- rank {k} ---\n{_tail(o)}"
                    for k, o in enumerate(last)))
