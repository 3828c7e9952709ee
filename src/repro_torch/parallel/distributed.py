"""The row-partitioned solve over ranks (counterpart of
``repro/parallel/distributed.py``).

This is the paper's MPI rank layout on a ``torch.distributed`` group, one
process per rank:

* the solution vector is DOMAIN-DECOMPOSED: each rank owns a contiguous
  block of rows, the structured stencils by x-planes (``nx % P == 0``), a
  ``SparseOp`` by a :class:`~repro_torch.linalg.partition.PartitionPlan`;
* the SPMV is a halo exchange (point-to-point messages of boundary planes
  or ELL send sets over a :class:`~repro_torch.parallel.wire.Wire`)
  followed by a purely local apply;
* the preconditioner is communication-free (Jacobi, or block-Jacobi with
  blocks interior to a rank);
* ALL inner products of an iteration form ONE dot block, reduced as one
  asynchronous ``all_reduce`` (the MPI_Iallreduce, waited l iterations
  later by p(l)-CG) or as the staged ring ladder
  (``repro_torch.parallel.reduction``).

The solvers (``repro_torch.core``) are the single-device ones: every
global operation goes through ``SolverOps``.  Each rank's fused vector
phase is the superkernel with its halo-extended plug-in, whose ``prepare``
is the wire halo (:func:`fused_spmv_local`); ``Stencil3D27``, a
``use_kernel`` operator and block-Jacobi have no fused shard path, as in
the JAX package, and run unfused.

The shard applies take their halo from a callable, so one process can
feed them the in-process halos of a (P, ...) stack of virtual shards
(:func:`halo_first_dim`, ``partition.halo_exchange``), as the fused ranks'
reference does (:func:`rank_oracle_ops`).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import METHODS
from repro_torch.core.types import SolveResult, SolverOps, dot_block_rows
from repro_torch.kernels import fused_iter as fi
from repro_torch.kernels import ref
from repro_torch.linalg import partition as partition_mod
from repro_torch.linalg.operators import (DiagonalOp, LinearOperator,
                                          Stencil2D5, Stencil3D7, Stencil3D27)
from repro_torch.linalg.preconditioners import (BlockJacobi, IdentityPrec,
                                                JacobiPrec)
from repro_torch.linalg.sparse import SparseOp

__all__ = ["halo_first_dim", "plane_messages", "halo_planes",
           "fused_spmv_local", "shard_arrays", "partitioned_solver_ops",
           "stacked_fused_factory", "rank_oracle_ops",
           "distributed_solve", "distributed_solve_batched",
           "distributed_slab_program", "distributed_checkpointed_solve",
           "rank_problem", "owned_rows", "RankSnapshot",
           "AllReduceHandles"]


# --------------------------------------------------------------------------
# Halo planes of an x-partitioned grid.
# --------------------------------------------------------------------------

def halo_first_dim(z_local: torch.Tensor, plane: int) -> torch.Tensor:
    """Every shard's halo-extended operand of an x-partitioned grid, in
    one process.  ``z_local`` is the (P, nxl * plane) stack of the shards'
    own planes, or a slab's (s, P, nxl * plane); shard s's operand is
    [last plane of s-1 | own | first plane of s+1], with zeros where no
    neighbour exists (the homogeneous Dirichlet boundary).  Returns
    (P, (nxl + 2) * plane), or (s, P, ...)."""
    g = z_local.reshape(tuple(z_local.shape[:-1]) + (-1, plane))
    zero = g.new_zeros(tuple(g.shape[:-3]) + (1, 1, plane))
    above = torch.cat([zero, g[..., :-1, -1:, :]], dim=-3)
    below = torch.cat([g[..., 1:, :1, :], zero], dim=-3)
    return torch.cat([above, g, below], dim=-2).reshape(
        tuple(z_local.shape[:-1]) + (-1,))


def plane_messages(g: torch.Tensor, rank: int, size: int, x_axis: int = 0):
    """Rank ``rank``'s boundary-plane messages for a grid ``g`` whose axis
    ``x_axis`` is the partitioned one ((nxl, ...), or a slab's (s, nxl,
    ...) with ``x_axis=1``, every column's plane in one message): its last
    plane goes to rank+1 (that rank's plane above), its first to rank-1
    (its plane below), and one plane arrives from each neighbour.
    ``(sends, recvs)`` as ``partition.halo_messages`` lists them."""
    sends, recvs = [], []
    up, dn = partition_mod.halo_tag(1, True), partition_mod.halo_tag(1, False)
    last, first = g.select(x_axis, -1), g.select(x_axis, 0)
    if rank + 1 < size:
        sends.append((rank + 1, up, last))
        recvs.append((rank + 1, dn, last))
    if rank > 0:
        sends.append((rank - 1, dn, first))
        recvs.append((rank - 1, up, first))
    return sends, recvs


def halo_planes(g: torch.Tensor, wire, x_axis: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exchange one boundary plane along the partitioned grid axis
    ``x_axis`` over ``wire`` (the JAX package's ``_halo_first_dim``):
    returns this rank's (plane above, plane below), each of extent 1 on
    ``x_axis``, zeros where no neighbour exists."""
    sends, recvs = plane_messages(g, wire.rank, wire.size, x_axis)
    got = wire.exchange(sends, recvs, kind="halo") if sends else []
    above = below = torch.zeros_like(g.narrow(x_axis, 0, 1))
    for (peer, _, _), buf in zip(recvs, got):
        if peer < wire.rank:
            above = buf.unsqueeze(x_axis)
        else:
            below = buf.unsqueeze(x_axis)
    return above, below


# --------------------------------------------------------------------------
# Shard applies: plain torch, as in the JAX package.  Each takes one
# vector (nl,) or a slab (s, nl), one vector a row; ``halo(g)`` returns the
# planes above and below the grid g, (nxl, ...) or (s, nxl, ...).
# --------------------------------------------------------------------------

def _grid(x, dims):
    return x.reshape(tuple(x.shape[:-1]) + tuple(dims))


def _apply_2d5_local(x, nxl: int, ny: int, halo) -> torch.Tensor:
    g = _grid(x, (nxl, ny))
    up, dn = halo(g)
    gp = torch.cat([up, g, dn], dim=-2)                # (..., nxl+2, ny)
    gy = F.pad(g, (1, 1))
    out = (4.0 * g - gp[..., :-2, :] - gp[..., 2:, :] - gy[..., :-2]
           - gy[..., 2:])
    return out.reshape(x.shape)


def _apply_3d7_local(x, nxl: int, ny: int, nz: int, eps_z: float,
                     halo) -> torch.Tensor:
    g = _grid(x, (nxl, ny, nz))
    up, dn = halo(g)
    gp = torch.cat([up, g, dn], dim=-3)
    gy = F.pad(g, (0, 0, 1, 1))
    gz = F.pad(g, (1, 1))
    ez = torch.full((), eps_z, dtype=x.dtype, device=x.device)
    out = ((4.0 + 2.0 * ez) * g
           - gp[..., :-2, :, :] - gp[..., 2:, :, :]
           - gy[..., :-2, :] - gy[..., 2:, :]
           - ez * gz[..., :-2] - ez * gz[..., 2:])
    return out.reshape(x.shape)


def _apply_3d27_local(x, nxl: int, ny: int, nz: int, centre: float,
                      halo) -> torch.Tensor:
    g = _grid(x, (nxl, ny, nz))
    up, dn = halo(g)
    # pad y, z of the halo too
    gp = F.pad(torch.cat([up, g, dn], dim=-3), (1, 1, 1, 1))
    out = centre * g
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                order = abs(di) + abs(dj) + abs(dk)
                if order == 0:
                    continue
                w = {1: 1.0, 2: 0.5, 3: 0.25}[order]
                out = out - w * gp[..., 1 + di:1 + di + nxl,
                                   1 + dj:1 + dj + ny, 1 + dk:1 + dk + nz]
    return out.reshape(x.shape)


# --------------------------------------------------------------------------
# Partitioning of operators and preconditioners.
# --------------------------------------------------------------------------

def _partition_op(op: LinearOperator, n_shards: int, reorder: bool = True):
    """Return ``(arrays, build, perm)``: ``arrays`` the operator's arrays
    whose leading axis splits over the ranks (:func:`shard_arrays`),
    ``build(loc, halo)`` the rank's apply given its arrays ``loc`` and
    its halo source, and ``perm`` the row ordering the partition imposed
    (``perm[new] = old``; None when the operator keeps its order).

    ``halo`` is a wire (:class:`~repro_torch.parallel.wire.Wire`) or, in
    one process, a callable: ``halo(g) -> (plane above, plane below)`` for
    a stencil grid, ``halo(x_local) -> extended vector`` for a
    ``SparseOp``.  A ``SparseOp`` is partitioned by ``partition.plan_for``
    (RCM unless ``reorder=False`` or already ordered)."""
    if isinstance(op, SparseOp):
        plan = partition_mod.plan_for(op, n_shards, reorder)
        arrays = {"cols": plan.cols, "vals": plan.vals,
                  "send_up": plan.send_up, "send_dn": plan.send_dn}
        use_kernel = op.use_kernel

        def build(loc, halo):
            cols, vals = loc["cols"][0], loc["vals"][0]
            su, sd = loc["send_up"][0], loc["send_dn"][0]
            if callable(halo):
                return lambda x: partition_mod.apply_extended(
                    halo(x), cols, vals, use_kernel)
            return lambda x: partition_mod.apply_shard(
                x, cols, vals, su, sd, halo, use_kernel)

        perm = None if plan.identity_perm else plan.perm
        return arrays, build, perm

    if isinstance(op, DiagonalOp):
        def build(loc, halo):
            return lambda x: loc["d"].to(x.dtype) * x

        return {"d": op.d}, build, None

    def planes(halo, nd):
        return halo if callable(halo) else \
            (lambda g: halo_planes(g, halo, g.dim() - nd))

    if isinstance(op, (Stencil2D5, Stencil3D7, Stencil3D27)):
        if op.nx % n_shards:
            raise ValueError(f"nx = {op.nx} does not split into "
                             f"{n_shards} x-slabs")
        nxl = op.nx // n_shards
    if isinstance(op, Stencil2D5):
        return {}, lambda loc, halo: (
            lambda x: _apply_2d5_local(x, nxl, op.ny, planes(halo, 2))), None
    if isinstance(op, Stencil3D7):
        return {}, lambda loc, halo: (
            lambda x: _apply_3d7_local(x, nxl, op.ny, op.nz, op.eps_z,
                                       planes(halo, 3))), None
    if isinstance(op, Stencil3D27):
        return {}, lambda loc, halo: (
            lambda x: _apply_3d27_local(x, nxl, op.ny, op.nz, op.centre,
                                        planes(halo, 3))), None
    raise TypeError(f"no distributed implementation for {type(op).__name__}")


def _partition_prec(prec, op: LinearOperator, n_shards: int, perm=None):
    """As :func:`_partition_op` for the preconditioner: ``(arrays,
    build)``.  ``perm`` is the row ordering the operator partition
    imposed: pointwise preconditioners follow it; block-structured ones
    cannot, so pre-order the operator (``sparse.rcm_reorder``) and build
    the preconditioner from the ordered operator instead."""
    if prec is None or isinstance(prec, IdentityPrec):
        return {}, lambda loc: (lambda x: x)
    if isinstance(prec, JacobiPrec):
        inv_diag = prec.inv_diag if perm is None else \
            prec.inv_diag[torch.as_tensor(perm, device=prec.inv_diag.device)]
        return {"inv_diag": inv_diag}, lambda loc: (
            lambda x: loc["inv_diag"].to(x.dtype) * x)
    if perm is not None:
        raise TypeError(
            f"{type(prec).__name__} is block-structured and cannot follow "
            "the partitioner's RCM reordering; reorder the operator first "
            "(repro_torch.linalg.sparse.rcm_reorder) and build the "
            "preconditioner from the ordered operator")
    if isinstance(prec, BlockJacobi):
        bs = prec.inv_blocks.shape[1]
        if (op.n // n_shards) % bs:
            raise ValueError("block-Jacobi blocks must be interior to a "
                             f"shard (local size {op.n // n_shards}, "
                             f"block {bs})")

        def build(loc):
            def apply(x):
                inv = loc["inv_blocks"]
                y = torch.einsum("nij,nj->ni", inv.to(x.dtype),
                                 x.reshape(inv.shape[0], bs))
                return y.reshape(-1)

            return apply

        return {"inv_blocks": prec.inv_blocks}, build
    raise TypeError(f"no distributed implementation for {type(prec).__name__}")


def shard_arrays(arrays, n_shards: int, rank: int):
    """Rank ``rank``'s part of ``arrays`` (a dict, nested or flat): each
    tensor's leading axis split into ``n_shards`` equal blocks, block
    ``rank`` kept (a plan's (P, ...) arrays give (1, ...)), as the JAX
    package's ``P(axis)`` in-spec does."""
    if isinstance(arrays, dict):
        return {k: shard_arrays(v, n_shards, rank) for k, v in arrays.items()}
    m = arrays.shape[0] // n_shards
    return arrays[rank * m:(rank + 1) * m]


# --------------------------------------------------------------------------
# The fused shard path: the superkernel's halo-extended plug-ins.
# --------------------------------------------------------------------------

def fused_spmv_local(op, loc: dict, n_shards: int,
                     prepare: Callable[[torch.Tensor], torch.Tensor] | None
                     ) -> fi.FusedSpmv | None:
    """The superkernel's plug-in for one shard of ``op``, or None where the
    JAX package has no fused path for a shard: ``Stencil3D27``, and a
    kernel-routed operator (``use_kernel``).

    ``loc`` holds the shard's arrays: ``d`` (its slice of a
    ``DiagonalOp``'s diagonal), or ``cols``/``vals`` and
    ``send_up``/``send_dn`` (its rows of a ``PartitionPlan``).
    ``prepare(z_top)`` builds the halo-extended operand from the shard's
    ring-top row: (nxl + 2) x-planes for the stencils, [own | from prev |
    from next] for a ``SparseOp``; the diagonal needs none.  The plug-in
    evaluates the shard expression of the JAX package's
    ``_fused_spmv_local`` term by term."""
    if isinstance(op, DiagonalOp):
        return fi.diagonal_spmv(loc["d"])
    if getattr(op, "use_kernel", False):
        return None                  # kernel-in-kernel: no fused mirror
    if isinstance(op, SparseOp):
        cols, vals = loc["cols"], loc["vals"]
        hops, max_send = loc["send_up"].shape[-2:]
        return fi.ell_spmv(cols, vals, prepare,
                           int(cols.shape[0]) + 2 * hops * max_send)
    if isinstance(op, Stencil2D5):
        nxl, ny = op.nx // n_shards, op.ny
        return fi.resident_spmv(
            "stencil2d5", lambda z: ref.stencil2d5_halo_ref(z, nxl, ny),
            (nxl, ny), prepare=prepare)
    if isinstance(op, Stencil3D7):
        nxl, ny, nz, ez = op.nx // n_shards, op.ny, op.nz, op.eps_z
        return fi.resident_spmv(
            "stencil3d7",
            lambda z: ref.stencil3d7_halo_ref(z, nxl, ny, nz, ez),
            (nxl, ny, nz), ez, prepare=prepare)
    return None


def _one_shard(loc: dict) -> dict:
    """A rank's plug-in arrays: the plan's (1, ...) blocks as one shard's."""
    return {k: (v[0] if k in ("cols", "vals", "send_up", "send_dn") else v)
            for k, v in loc.items()}


def _wire_prepare(op, loc: dict, n_shards: int, wire):
    """``prepare(z_top)`` of a rank's halo plug-in: the wire halo, of one
    ring-top row (nl,) or of a slab's (s, nl), every column's boundary in
    one message a neighbour."""
    if isinstance(op, SparseOp):
        su, sd = loc["send_up"], loc["send_dn"]
        return lambda z: partition_mod.halo_exchange_shard(z, su, sd, wire)
    if isinstance(op, (Stencil2D5, Stencil3D7)):
        shape = (op.nx // n_shards,) + ((op.ny,) if isinstance(op, Stencil2D5)
                                        else (op.ny, op.nz))

        def prep(z):
            g = _grid(z, shape)
            ax = g.dim() - len(shape)
            up, dn = halo_planes(g, wire, ax)
            return torch.cat([up, g, dn], dim=ax).reshape(
                tuple(z.shape[:-1]) + (-1,))

        return prep
    return None


def _pointwise_inv_diag(prec, loc: dict):
    """(ok, inv_diag): the superkernel takes identity or Jacobi only."""
    if prec is None or isinstance(prec, IdentityPrec):
        return True, None
    if isinstance(prec, JacobiPrec):
        return True, loc["inv_diag"]
    return False, None


def _fused_factory_dist(op, prec, loc: dict, n_shards: int, wire):
    """``SolverOps.fused_iter_factory`` of one rank, or None for an
    (operator, preconditioner) pair with no fused shard path."""
    ok, inv_diag = _pointwise_inv_diag(prec, loc)
    if not ok:
        return None                  # block solves are not pointwise
    one = _one_shard(loc)
    spmv = fused_spmv_local(op, one, n_shards,
                            _wire_prepare(op, one, n_shards, wire))
    if spmv is None:
        return None

    def factory(layout):
        return fi.build_fused_iteration(layout, spmv, inv_diag)

    return factory


def stacked_fused_factory(op, prec, n_shards: int):
    """The fused ranks' reference path: ``factory(layout)`` returns
    ``fiter(S, idx, scal) -> (S, partials (P, 2l+1))`` running, in one
    process, every virtual shard's halo plug-in on its contiguous block of
    the slab's columns, with the halos taken from the ring-top row of the
    whole slab (:func:`halo_first_dim`, ``partition.halo_exchange``; no
    phase writes that row).  Row r of ``partials`` is what rank r's own
    superkernel gives, so the reference's gather buffer is a staged P-rank
    run's.  Each shard's superkernel updates its block of columns in
    place (the kernel takes the slab's row stride).  A batched solve's
    3-D slab (s, NV, n) runs the same way, every shard's plug-in on its
    block of every column in the slab form, the partials (s, P, 2l+1).
    None where a rank has no fused path (or the operator does not split
    into ``n_shards`` blocks)."""
    if not _pointwise_inv_diag(prec, {"inv_diag": None})[0]:
        return None
    if getattr(op, "use_kernel", False) or not isinstance(
            op, (DiagonalOp, SparseOp, Stencil2D5, Stencil3D7)):
        return None
    if op.n % n_shards or (not isinstance(op, (DiagonalOp, SparseOp))
                           and op.nx % n_shards):
        return None

    def factory(layout):
        op_arrays, _, _ = _partition_op(op, n_shards, reorder=False)
        pr_arrays, _ = _partition_prec(prec, op, n_shards)
        locs = [_one_shard(shard_arrays({**op_arrays, **pr_arrays},
                                        n_shards, r))
                for r in range(n_shards)]
        current: dict = {}           # this phase's stacked operands
        fiters = [fi.build_fused_iteration(
            layout,
            fused_spmv_local(op, locs[r], n_shards,
                             lambda z, r=r: current["ext"][r]),
            _pointwise_inv_diag(prec, locs[r])[1])
            for r in range(n_shards)]
        if isinstance(op, SparseOp):
            su, sd = op_arrays["send_up"], op_arrays["send_dn"]

            def stack(z):
                return partition_mod.halo_exchange(
                    _grid(z, (n_shards, -1)), su, sd)
        elif isinstance(op, DiagonalOp):
            stack = None             # no halo
        else:
            plane = op.ny if isinstance(op, Stencil2D5) else op.ny * op.nz

            def stack(z):
                return halo_first_dim(_grid(z, (n_shards, -1)), plane)
        pos = fi.idx_layout(layout.l)["z_top"]

        def fiter(S, idx, scal):
            if stack is not None:
                ext = stack(fi.ring_top(S, idx, pos))
                current["ext"] = [ext.select(-2, r).contiguous()
                                  for r in range(n_shards)]
            nl = S.shape[-1] // n_shards
            parts = []
            for r in range(n_shards):
                view = S[..., r * nl:(r + 1) * nl]  # the kernel writes it
                S_r, p_r = fiters[r](view, idx, scal)
                if S_r is not view:               # the plain version's copy
                    view.copy_(S_r)
                parts.append(p_r)
            current.clear()
            return S, torch.stack(parts, dim=-2)

        return fiter

    return factory


def rank_oracle_ops(op, prec, cfg) -> SolverOps:
    """The bitwise reference, in one process, of a staged run over
    ``cfg.n_shards`` ranks (``cfg`` a ``StagedConfig``), fused or not: the
    ladder oracle (``reduction.oracle_solver_ops``) whose fused path runs
    every virtual shard's halo plug-in (:func:`stacked_fused_factory`) and
    files rank r's partial in slot r (``reduction.oracle_gather``).
    ``LocalBackend``'s oracle keeps the JAX package's fused path (the
    whole-vector partial in slot 0), so it is bitwise a staged run over
    ranks on the unfused path only."""
    from repro_torch.parallel import reduction as reduction_mod

    return dataclasses.replace(
        reduction_mod.oracle_solver_ops(op, prec, cfg),
        fused_iter_factory=stacked_fused_factory(op, prec, cfg.n_shards),
        combine_partials=lambda p_: reduction_mod.oracle_gather(p_, cfg))


# --------------------------------------------------------------------------
# The dot block over a wire: async all-reduce handles.
# --------------------------------------------------------------------------

class AllReduceHandles:
    """The monolithic dot block over a wire: ``start`` issues one
    asynchronous all-reduce of the partials (the MPI_Iallreduce) and keeps
    its request; ``wait`` completes it (the MPI_Wait).

    The solvers hold a handle either directly (a blocking start and wait:
    the initial norm, a restart's block, a slab column's init, Ghysels
    p-CG's one block) or as a copy in p(l)-CG's D ring, waited l
    iterations later.  So ``start`` returns a fresh alias of a zero token,
    and the requests stay here in issue order: a wait on a token returned
    by ``start`` completes that request alone; a wait on a ring slot
    (``advanced`` = l - 1) completes the request issued l ring starts
    earlier, the (advanced + 1)-th newest in flight, and drops the older
    ones, which a restart abandoned (a slab's inject or column restart
    abandons none: its blocking pairs leave the ring's requests alone);
    with none in flight (a pipeline-fill slot) it returns the slot.  The
    all-reduced tensor is never copied before its wait, and on NCCL a wait
    orders the caller's stream after the collective without blocking the
    host."""

    def __init__(self, wire):
        self.wire = wire
        self.pending: collections.deque = collections.deque()
        self._tokens: dict = {}

    def start(self, partials: torch.Tensor) -> torch.Tensor:
        key = (tuple(partials.shape), partials.dtype, partials.device)
        tok = self._tokens.get(key)
        if tok is None:
            tok = self._tokens[key] = torch.zeros_like(partials)
        handle = tok.view(tok.shape)
        self.pending.append((handle, self.wire.all_reduce_async(partials)))
        return handle

    def wait(self, handle: torch.Tensor, advanced: int = 0) -> torch.Tensor:
        for pos, (tok, req) in enumerate(self.pending):
            if tok is handle:
                del self.pending[pos]
                return req.wait()
        if not self.pending:
            return handle
        for _ in range(max(len(self.pending) - advanced - 1, 0)):
            self.pending.popleft()[1].wait()
        return self.pending.popleft()[1].wait()


def partitioned_solver_ops(op, prec, n_shards: int, reduction=None):
    """``(arrays, build, perm)`` of a full SolverOps: ``build(loc, wire)``
    gives rank ``wire.rank``'s ops from its arrays ``loc``
    (``shard_arrays(arrays, n_shards, rank)``).  ``perm`` (``perm[new] =
    old``, or None) is the row ordering the partition imposed: callers
    permute b on the way in and x on the way out (every scalar the solver
    derives is permutation-invariant).

    The dot block is one asynchronous all-reduce
    (:class:`AllReduceHandles`), or, with ``reduction`` a
    ``StagedConfig``, the staged ring ladder over the wire."""
    from repro_torch.parallel import reduction as reduction_mod

    op_arrays, op_build, perm = _partition_op(op, n_shards)
    pr_arrays, pr_build = _partition_prec(prec, op, n_shards, perm)
    arrays = {"op": op_arrays, "prec": pr_arrays}

    def build(loc, wire) -> SolverOps:
        if reduction is None:
            handles = AllReduceHandles(wire)
            red = dict(dot_block_start=lambda m, v: handles.start(
                dot_block_rows(m, v)), dot_block_wait=handles.wait,
                combine_partials=handles.start)
        else:
            cfg = dataclasses.replace(reduction, n_shards=n_shards)
            red = reduction_mod.staged_ops_pieces(cfg, wire)
        return SolverOps.create(
            apply_a=op_build(loc["op"], wire), prec=pr_build(loc["prec"]),
            dot_block=lambda m, v: wire.all_reduce(dot_block_rows(m, v)),
            fused_iter_factory=_fused_factory_dist(
                op, prec, {**loc["op"], **loc["prec"]}, n_shards, wire),
            **red)

    return arrays, build, perm


def _permutation_wrappers(perm):
    """(pre, post) for a partition-imposed row ordering: ``pre`` maps an
    (n,) operand, or an (s, n) slab, into the permuted basis, ``post``
    maps a SolveResult's (gathered) solution back.  Pass-throughs for
    None."""
    if perm is None:
        return (lambda b: b), (lambda res: res)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)

    def pre(b):
        return b[..., torch.as_tensor(perm, device=b.device)]

    def post(res: SolveResult) -> SolveResult:
        return res._replace(
            x=res.x[..., torch.as_tensor(inv, device=res.x.device)])

    return pre, post


def owned_rows(op, n_shards: int, rank: int) -> np.ndarray:
    """The operator-order indices of the rows rank ``rank`` of
    ``n_shards`` holds: its contiguous block of the partition's order
    (``perm[new] = old`` where the partition imposed one)."""
    _, _, perm = _partition_op(op, n_shards)
    nl = op.n // n_shards
    rows = np.arange(rank * nl, (rank + 1) * nl)
    return rows if perm is None else np.asarray(perm)[rows]


class RankProblem(NamedTuple):
    """One rank's share of a solve over ``wire``'s group: its ``ops``, the
    map ``rows`` from a global right-hand side (n,) or slab (s, n) to the
    rank's block of rows in the partition's order, and ``result``, which
    gathers a SolveResult's x, (nl,) or (s, nl), into the whole solution
    in the operator's order (one all-gather)."""

    ops: SolverOps
    rows: Callable[[torch.Tensor], torch.Tensor]
    result: Callable[[SolveResult], SolveResult]
    nl: int


def rank_problem(wire, op, prec=None, reduction=None) -> RankProblem:
    """Rank ``wire.rank``'s :class:`RankProblem` for ``op`` and ``prec``
    (every rank passes the same global ones) with the monolithic dot block
    or, with ``reduction`` a ``StagedConfig``, the staged ladder."""
    p = wire.size
    if op.n % p:
        raise ValueError(f"n = {op.n} does not split over {p} ranks")
    arrays, build, perm = partitioned_solver_ops(op, prec, p,
                                                 reduction=reduction)
    pre, post = _permutation_wrappers(perm)
    ops = build(shard_arrays(arrays, p, wire.rank), wire)
    nl = op.n // p
    lo = wire.rank * nl

    def rows(b):
        if b.shape[-1] != op.n:
            raise ValueError(f"right-hand side of length {b.shape[-1]}, "
                             f"want {op.n}")
        return pre(b)[..., lo:lo + nl].contiguous()

    def result(res: SolveResult) -> SolveResult:
        return post(res._replace(x=wire.all_gather(res.x, dim=-1)))

    return RankProblem(ops=ops, rows=rows, result=result, nl=nl)


def distributed_solve(wire, op, b, method: str = "plcg", prec=None,
                      reduction=None, **kwargs) -> SolveResult:
    """Solve A x = b with the chosen CG variant on this rank's block of
    rows; every rank of ``wire``'s group calls it with the same global
    ``op``, ``b`` and arguments.  ``kwargs`` go to the solver (l, tol,
    maxit, sigmas, fused_iteration, unroll, telemetry_cap, governor, x0
    (whole, like b), ...); ``reduction`` (StagedConfig or None) picks the
    staged ladder.  Every
    host decision of the solvers reads reduced values only, which every
    rank holds bit for bit, so the ranks take the same branches; the
    telemetry ring and the governor vector are built from those values
    only, so they come back the same on every rank (replicated, the JAX
    package's ``P()`` out-specs).  The result's x is the whole solution in
    the operator's order (one all-gather at the end)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; "
                         f"available: {', '.join(METHODS)}")
    rp = rank_problem(wire, op, prec, reduction)
    if kwargs.get("x0") is not None:          # a whole warm start
        kwargs["x0"] = rp.rows(torch.as_tensor(kwargs["x0"], device=b.device,
                                               dtype=b.dtype))
    return rp.result(METHODS[method](rp.ops, rp.rows(b), kwargs))


class RankSnapshot:
    """The checkpoint hooks of rank ``rank`` of ``n_shards``, each rank
    holding its block of ``nl`` rows of a state's vector leaves
    (``checkpoint.solve.vector_leaves``; the rest is replicated).

    ``pack`` stacks the rank's vector leaves into one (m, nl) block,
    ``unpack`` takes the whole (m, n) block (every rank's, in rank order:
    what one all-gather along the last axis gives) back into whole leaves,
    and ``scatter`` cuts a stored payload to the rank's rows.  Rows are in
    the partition's order (``perm``), as the state holds them."""

    def __init__(self, method: str, n_shards: int, rank: int, nl: int):
        from repro_torch.checkpoint.solve import vector_leaves

        self.index = vector_leaves(method)
        self.n_shards, self.rank, self.nl = n_shards, rank, nl

    def pack(self, leaves: list) -> torch.Tensor:
        return torch.cat([leaves[i].reshape(-1, self.nl)
                          for i in self.index])

    def unpack(self, leaves: list, whole: torch.Tensor) -> list:
        out, row = list(leaves), 0
        for i in self.index:
            lead = tuple(leaves[i].shape[:-1])
            m = int(np.prod(lead, dtype=np.int64))
            out[i] = whole[row:row + m].reshape(lead + (-1,))
            row += m
        return out

    def gather(self, leaves: list, wire) -> list:
        """Whole vector leaves on every rank: ONE all-gather."""
        if not self.index:
            return list(leaves)
        return self.unpack(leaves, wire.all_gather(self.pack(leaves),
                                                   dim=-1))

    def scatter(self, payload: dict) -> dict:
        from repro_torch.checkpoint.format import CheckpointMismatchError

        n, lo = self.nl * self.n_shards, self.rank * self.nl
        out = dict(payload)
        for i in self.index:
            key = f"leaf_{i:03d}"
            a = payload.get(key)
            if a is None or a.ndim < 1 or a.shape[-1] != n:
                raise CheckpointMismatchError(
                    f"{key}: stored {None if a is None else a.shape}, "
                    f"want a trailing axis of {n} rows")
            out[key] = np.ascontiguousarray(a[..., lo:lo + self.nl])
        return out


def distributed_checkpointed_solve(wire, op, b, method: str = "plcg",
                                   prec=None, reduction=None,
                                   checkpoint=None, x0=None,
                                   **kwargs) -> SolveResult:
    """The checkpointed solve over ranks (the JAX package's
    ``distributed_checkpointed_solve``): each rank runs its
    :func:`rank_problem` ops through the one-device segmented drive
    (``checkpoint.solve.checkpointed_solve``), whose host decisions read
    replicated scalars only, so every rank takes the same branch; the
    true-residual recompute reduces over the wire (its dot through the
    solver's start and wait).  At each drained-ring boundary the vector
    leaves are gathered (one all-gather, :class:`RankSnapshot`) in the
    partition's row order and rank 0 alone writes; a restore hands each
    rank its rows.  The payload excludes the D ring, so a snapshot written
    by P ranks restores on another rank count or on one device
    (``LocalBackend(reduction="staged", virtual_shards=P)``) through the
    gather alone.  ``x0`` is whole, like ``b``; the result's x is the
    whole solution in the operator's order."""
    from repro_torch.checkpoint.solve import checkpointed_solve

    rp = rank_problem(wire, op, prec, reduction)
    if x0 is not None:
        x0 = rp.rows(torch.as_tensor(x0, device=b.device, dtype=b.dtype))
    hooks = RankSnapshot(method, wire.size, wire.rank, rp.nl)
    res = checkpointed_solve(
        rp.ops, rp.rows(b), method, x0, checkpoint, kwargs, n=op.n,
        gather=lambda leaves: hooks.gather(leaves, wire),
        scatter=hooks.scatter, is_writer=wire.rank == 0)
    return rp.result(res)


def distributed_solve_batched(wire, op, B, method: str = "plcg", prec=None,
                              reduction=None, **kwargs) -> SolveResult:
    """Solve A X = B for every row of the global slab B (s, n), one
    right-hand side a row, in lock step on this rank's block of rows (the
    JAX package's ``distributed_solve_batched``, its (n, s) B transposed):
    ONE dot block of the s columns an iteration, an async all-reduce of
    the (s, 2l+1) block or one ladder of it.  The result's tensors carry a
    leading s axis; x is (s, n), gathered, in the operator's order."""
    from repro_torch.core import batched as batched_mod

    if B.dim() != 2:
        raise ValueError(f"B must be (s, n), got {tuple(B.shape)}")
    rp = rank_problem(wire, op, prec, reduction)
    return rp.result(batched_mod.solve_batched(rp.ops, rp.rows(B), method,
                                               **kwargs))


def distributed_slab_program(wire, op, s: int, method: str = "plcg",
                             prec=None, reduction=None,
                             chunk_iters: int = 16, **kwargs):
    """The serving layer's slab program over ranks (the JAX package's
    ``ShardMapBackend.make_slab_program``): every piece takes the GLOBAL
    (s, n) slab B in the operator's order and runs ``core.batched``'s
    program on this rank's block of its rows; the state lives in the
    partition's order on each rank, its vector leaves (``vector_mask``)
    the rank's rows, the rest replicated.  ``status`` reads replicated
    values only; ``extract`` gathers x (one all-gather).  Every rank must
    make the same calls in the same order (``serve.service``'s command
    does that for a service)."""
    from repro_torch.core import batched as batched_mod

    rp = rank_problem(wire, op, prec, reduction)
    prog = batched_mod.slab_program(rp.ops, s, rp.nl, method, dict(kwargs),
                                    chunk_iters)
    rows = rp.rows
    return prog._replace(
        n=op.n,
        init=lambda B: prog.init(rows(B)),
        chunk=lambda B, st: prog.chunk(rows(B), st),
        inject=lambda B, st, mask: prog.inject(rows(B), st, mask),
        status=lambda B, st: prog.status(rows(B), st),
        extract=lambda B, st: rp.result(prog.extract(rows(B), st)))
