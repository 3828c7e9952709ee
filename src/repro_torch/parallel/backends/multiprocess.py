"""The torch.distributed reduction backend: one process per rank, the
counterpart of both ``repro/parallel/backends/shard_map.py`` and
``repro/parallel/backends/multiprocess.py`` (in PyTorch one process per
device is the model, so the two JAX substrates are one here).

Every rank runs the same program::

    # rank k of P, with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set
    # (``repro_torch.parallel.fabric.launch_fabric`` sets them):
    be = get_backend("multiprocess", reduction="staged",
                     reduction_stages=2)
    res = be.solve(op, b, method="plcg", l=2, sigmas=sig,
                   fused_iteration=True)

The backend joins the process group the caller or the launcher set up
(``env://``: the four variables above).  Its wire follows the device, as the
JAX backend's ``_configure_collectives`` does: NCCL for ``cuda``, gloo for
the CPU.  ``pg_backend="gloo"`` with a ``cuda`` device is the one way to
put several ranks on one card (NCCL refuses two ranks on one GPU): each
rank's kernels run on the card and every payload crosses host memory in
pinned staging buffers (``repro_torch.parallel.wire``).  Nothing falls back:
a wire that does not start raises.

The dot block is an asynchronous ``all_reduce`` (monolithic), or the
staged ring ladder of point-to-point hops (``reduction="staged"``), which
is bitwise equal to its one-process reference
(``parallel.distributed.rank_oracle_ops``; unfused, to
``LocalBackend(reduction="staged", virtual_shards=P)``).

Batched solves and slab programs run over the ranks as one column does
(``solve_batched``, ``make_batched_solver``, ``make_slab_program``): the
s columns' (s, 2l+1) dot block is ONE all-reduce or one ladder an
iteration, and ``repro_torch.serve.SolverService`` serves over a backend
of several ranks with rank 0 leading (``serve.service``).  Instrumented
(``telemetry_cap > 0``) and governed solves return their ring and
governor vector replicated, the same bits on every rank.  A
checkpointed solve (``checkpoint=CheckpointConfig(every > 0, ...)``)
snapshots at drained-ring boundaries, the vector leaves gathered and rank
0 writing, in the one-device file format; with ``resume=True`` on a shared
directory a fresh group continues from the last snapshot
(``parallel.distributed.distributed_checkpointed_solve``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.device import as_rhs, resolve_device
from repro_torch.parallel.backends.base import METHODS, ReductionBackend

ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_device(device=None) -> torch.device:
    """``None`` means ``cuda`` on card ``LOCAL_RANK`` modulo the card
    count (several ranks share a card when there are fewer cards)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def join_process_group(pg_backend: str, device: torch.device) -> None:
    """Join the default process group with ``pg_backend`` from the
    environment (``env://``), or adopt one that is already up (its backend
    must be the one asked for)."""
    if dist.is_initialized():
        have = str(dist.get_backend())
        if have != pg_backend:
            raise ValueError(f"a {have!r} process group is already up; "
                             f"this backend asks for {pg_backend!r}")
        return
    missing = [k for k in ENV_VARS if k not in os.environ]
    if missing:
        raise ValueError(
            "no process group: set " + ", ".join(missing) + " (or run "
            "under repro_torch.parallel.fabric.launch_fabric)")
    kw = dict(backend=pg_backend, init_method="env://")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if pg_backend == "nccl":
            kw["device_id"] = device
    dist.init_process_group(**kw)


class MultiprocessBackend(ReductionBackend):
    name = "multiprocess"

    def __init__(self, device=None, pg_backend: str | None = None,
                 reduction: str = "monolithic", reduction_stages: int = 2,
                 reduction_dtype=None):
        """``device``: where this rank computes (default ``cuda`` on card
        ``LOCAL_RANK``); ``pg_backend``: ``"nccl"`` or ``"gloo"`` (default:
        NCCL on a card, gloo on the CPU).  ``reduction="staged"`` runs the
        ring ladder with ``reduction_stages`` advance steps and
        ``reduction_dtype`` on the wire (e.g. ``torch.float32``, summed
        fp64-compensated)."""
        from repro_torch.parallel.reduction import resolve_backend_reduction
        from repro_torch.parallel.wire import Wire

        self.device = default_device(device)
        if pg_backend is None:
            pg_backend = "nccl" if self.device.type == "cuda" else "gloo"
        if pg_backend not in ("nccl", "gloo"):
            raise ValueError(f"unknown process-group backend {pg_backend!r} "
                             "(want 'nccl' or 'gloo')")
        if pg_backend == "nccl" and self.device.type != "cuda":
            raise ValueError("NCCL needs a cuda device")
        self.pg_backend = pg_backend
        join_process_group(pg_backend, self.device)
        self.wire = Wire(self.device)
        self.rank, self.world_size = self.wire.rank, self.wire.size
        self.reduction_cfg = resolve_backend_reduction(
            self, reduction, reduction_stages, reduction_dtype,
            self.world_size)

    def _check_method(self, method: str) -> None:
        if method not in METHODS:
            raise ValueError(f"unknown method {method!r}; "
                             f"available: {', '.join(METHODS)}")

    def rank_problem(self, op, prec=None):
        """This rank's ``parallel.distributed.RankProblem``: its SolverOps,
        its block of a right-hand side's rows, and the gather of a
        result."""
        from repro_torch.parallel.distributed import rank_problem

        return rank_problem(self.wire, op, prec, self.reduction_cfg)

    def solve(self, op, b, method: str = "plcg", prec=None,
              **solver_kwargs):
        """Solve A x = b over the group's ranks; every rank passes the
        same global ``op`` and ``b``.  ``x`` of the result is the whole
        solution on every rank; an instrumented or governed solve's ring
        and governor vector are replicated.  ``checkpoint`` with
        ``every > 0`` runs the checkpointed solve over the ranks."""
        from repro_torch.parallel import distributed

        self._check_method(method)
        ckpt = solver_kwargs.pop("checkpoint", None)
        if ckpt is not None and ckpt.armed:
            return distributed.distributed_checkpointed_solve(
                self.wire, op, as_rhs(b, self.device), method=method,
                prec=prec, reduction=self.reduction_cfg, checkpoint=ckpt,
                **solver_kwargs)
        return distributed.distributed_solve(
            self.wire, op, as_rhs(b, self.device), method=method, prec=prec,
            reduction=self.reduction_cfg, **solver_kwargs)

    def run(self, fn, op, b, prec=None, x0=None):
        """``fn(ops, b_local)`` on this rank's SolverOps and block of
        ``b``'s rows (``fn(ops, b_local, x0=x0_local)`` with a warm start,
        given whole), its SolveResult gathered: the hook
        ``stability.governed_solve``'s ``ops_transform`` takes."""
        rp = self.rank_problem(op, prec)
        kw = {} if x0 is None else {"x0": rp.rows(as_rhs(x0, self.device))}
        return rp.result(fn(rp.ops, rp.rows(as_rhs(b, self.device)), **kw))

    def solve_batched(self, op, B, method: str = "plcg", prec=None,
                      **solver_kwargs):
        """Solve A X = B for the global slab B (s, n), one right-hand side
        a row, over the ranks: ONE (s, 2l+1) dot block an iteration."""
        from repro_torch.parallel.distributed import distributed_solve_batched

        self._check_method(method)
        return distributed_solve_batched(
            self.wire, op, as_rhs(B, self.device), method=method, prec=prec,
            reduction=self.reduction_cfg, **solver_kwargs)

    def make_batched_solver(self, op, method: str = "plcg", prec=None,
                            **solver_kwargs):
        """``B -> SolveResult`` over the ranks, the partition built once."""
        from repro_torch.core import batched as batched_mod

        self._check_method(method)
        rp = self.rank_problem(op, prec)
        return lambda B: rp.result(batched_mod.solve_batched(
            rp.ops, rp.rows(as_rhs(B, self.device)), method,
            **solver_kwargs))

    def make_slab_program(self, op, s: int, method: str = "plcg", prec=None,
                          chunk_iters: int = 16, dtype=None,
                          **solver_kwargs):
        """The serving layer's slab program over the ranks
        (``parallel.distributed.distributed_slab_program``)."""
        from repro_torch.parallel.distributed import distributed_slab_program

        self._check_method(method)
        return distributed_slab_program(
            self.wire, op, s, method, prec, reduction=self.reduction_cfg,
            chunk_iters=chunk_iters, **solver_kwargs)

    # ------------------------------------------------- wire introspection --
    def hop_wire(self) -> str:
        """What carries one ladder hop between ranks: ``"nccl"``,
        ``"gloo"``, ``"gloo, pinned host staging"`` (gloo ranks computing
        on a card), or ``"none"`` on a world of one rank."""
        if self.world_size == 1:
            return "none"
        return self.pg_backend + (", pinned host staging"
                                  if self.wire.staged else "")

    def cross_process_edges(self) -> int:
        """Ring edges of the ladder that cross a process boundary, each one
        point-to-point message a hop: every edge, one rank a process."""
        return self.world_size if self.world_size > 1 else 0

    def describe(self) -> str:
        base = (f"multiprocess (torch.distributed {self.pg_backend}, rank "
                f"{self.rank} of {self.world_size}, {self.device})")
        cfg = self.reduction_cfg
        if cfg is not None:
            base += (f" staged ring dot block: {cfg.n_hops} hops / "
                     f"{cfg.stages} stage(s), {self.cross_process_edges()} "
                     f"cross-process edge(s)/hop over {self.hop_wire()}")
        else:
            base += " async all_reduce dot block"
        return base
