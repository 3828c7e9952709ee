"""Staged ring reduction (counterpart of ``repro/parallel/reduction.py``,
DESIGN.md §14).

The paper hides one global reduction per iteration behind l iterations of
work.  The staged form makes the reduction's progress explicit: the
(2l+1)-entry dot block is a ring ALLGATHER of raw per-shard partials,
P-1 hops grouped into ``stages`` advance steps that the solver runs, and
the wait sums the gathered partials IN RANK ORDER.  Two properties follow:

1.  **Stage-count invariance.**  ``stages`` only groups the hops; the
    wait's summation is the same for every stage count, so residual
    histories are bitwise identical across ladder configurations.
2.  **Mixed precision.**  With ``payload_dtype=torch.float32`` each
    partial is rounded to fp32 once (every hop carries half the bytes)
    and the wait accumulates the fp32 partials into an fp64 compensated
    (Kahan) sum, so the error stays at one fp32 rounding per partial.

A slab of s right-hand sides (``core.batched``) carries each column's
block in one payload: the partials are (s, K), one row a column, and every
gather buffer puts the shard axis just before the K dot entries, (P, K) for
one column and (s, P, K) for a slab (one (s, K) message a hop, whatever s
is, summed in the same rank order as one column).

The ladder keeps its schedule apart from its transport.
:func:`ladder_step` is a pure function: rank r's hops of one advance
step, each a (send slot, receive slot, next rank, previous rank) tuple.
:func:`staged_start`, :func:`staged_advance` and :func:`staged_wait` run
it over a ``wire`` (``repro_torch.parallel.wire.Wire``: point-to-point
messages between ranks of a ``torch.distributed`` group) and finish with
:func:`ordered_reduce`.  The single-device *ladder oracle*
(``oracle_solver_ops``) splits the vector into ``virtual_shards``
contiguous slices whose partials fill the gather buffer directly, so one
device reproduces a staged P-rank unfused run bit for bit without a wire.
Its fused path is the JAX package's: the whole-vector superkernel's one
partial in slot 0.  The bitwise reference of a fused run over ranks,
whose slots hold each rank's own superkernel partial, is
``parallel.distributed.rank_oracle_ops``.  Nothing here records a
metric: the JAX module's ``backend_reduction_fallback`` gauge belongs to
``obs/``, which is not ported, and no port backend declines the ladder.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core.types import SolverOps, dot_block_rows

__all__ = ["StagedConfig", "Hop", "HOP_TAG", "hop_groups", "ladder_step",
           "ordered_reduce", "staged_start", "staged_advance",
           "staged_wait", "staged_ops_pieces", "oracle_start",
           "oracle_partials", "oracle_gather", "oracle_ops_pieces",
           "oracle_solver_ops",
           "resolve_backend_reduction", "hop_payload_bytes",
           "reduction_wire_bytes"]

# Message tag of ladder hop k is HOP_TAG + k (the halo's tags lie below).
HOP_TAG = 1000


@dataclasses.dataclass(frozen=True)
class StagedConfig:
    """Shape of one staged ring reduction.

    ``n_shards`` is the ring size P; ``stages`` groups the P-1 allgather
    hops into that many advance steps (``hop_groups``); ``payload_dtype``
    is the wire dtype (None = the solver dtype); a payload narrower than
    the solver dtype switches the wait to fp64 compensated accumulation.
    The ring's ranks are those of the wire it runs over (or the oracle's
    virtual shards).
    """

    n_shards: int
    stages: int = 2
    payload_dtype: torch.dtype | None = None

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if not (1 <= self.stages <= max(self.n_shards - 1, 1)):
            raise ValueError(
                f"stages must be in [1, {max(self.n_shards - 1, 1)}] "
                f"for {self.n_shards} shards, got {self.stages}")

    @property
    def n_hops(self) -> int:
        """Wire hops of one reduction: the P-1 ring-allgather steps."""
        return self.n_shards - 1

    def wire_dtype(self, solver_dtype: torch.dtype) -> torch.dtype:
        return solver_dtype if self.payload_dtype is None \
            else self.payload_dtype

    def compensated(self, solver_dtype: torch.dtype) -> bool:
        """fp64-compensated wait accumulation when the wire narrows."""
        return (self.wire_dtype(solver_dtype).itemsize
                < solver_dtype.itemsize)


def hop_groups(n_shards: int, stages: int) -> list[list[int]]:
    """Partition the ring's ``n_shards - 1`` hop indices into ``stages``
    contiguous advance steps, earlier steps no smaller than later ones
    (ceil-split), so the ladder front-loads while the window is widest."""
    n_hops = n_shards - 1
    groups: list[list[int]] = []
    start = 0
    for step in range(stages):
        size = math.ceil((n_hops - start) / (stages - step))
        groups.append(list(range(start, start + size)))
        start += size
    assert start == n_hops, (n_shards, stages, groups)
    return groups


def ordered_reduce(gathered: torch.Tensor, out_dtype: torch.dtype,
                   compensated: bool) -> torch.Tensor:
    """Sum the gathered partials, (P, K) or a slab's (s, P, K), over shard
    rank 0..P-1 (the axis before the dot entries).

    The explicit rank-ascending add chain is the determinism anchor: the
    same order on every shard and in the local oracle, and for a slab the
    same for every column as for one.  ``compensated`` switches to Kahan
    accumulation in ``out_dtype`` (the fp32-payload path: one compensated
    fp64 sum of P fp32 partials)."""
    p = gathered.shape[-2]
    if not compensated:
        acc = gathered.select(-2, 0).to(out_dtype)
        for k in range(1, p):
            acc = acc + gathered.select(-2, k).to(out_dtype)
        return acc
    acc = torch.zeros(gathered.shape[:-2] + gathered.shape[-1:],
                      dtype=out_dtype, device=gathered.device)
    comp = torch.zeros_like(acc)
    for k in range(p):
        y = gathered.select(-2, k).to(out_dtype) - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
    return acc


# --------------------------------------------------------------------------
# The ladder over a wire: a pure schedule and a transport.
# --------------------------------------------------------------------------

class Hop(NamedTuple):
    """Rank r's part in ring hop ``k``: it sends gather slot ``send_slot``
    to rank ``send_to`` and files what rank ``recv_from`` sends in slot
    ``recv_slot``."""

    k: int
    send_slot: int
    recv_slot: int
    send_to: int
    recv_from: int


def ladder_step(rank: int, n_shards: int, stages: int,
                step: int) -> list[Hop]:
    """Rank ``rank``'s hops of advance step ``step`` (none past the last
    step, nor on a ring of one).  Hop k forwards the partial received k
    hops ago (origin rank r-k) one rank up the ring and files the one
    arriving from below under its origin r-k-1, so after the P-1 hops
    every rank holds every partial in its origin's slot: the JAX module's
    ``staged_advance`` schedule, with the ppermute's send and receive
    named."""
    p = n_shards
    if p == 1 or step >= stages:
        return []
    return [Hop(k, (rank - k) % p, (rank - k - 1) % p, (rank + 1) % p,
                (rank - 1) % p)
            for k in hop_groups(p, stages)[step]]


def _gather_buffer(partials: torch.Tensor, cfg: StagedConfig,
                   slot: int) -> torch.Tensor:
    """A fresh gather buffer of the wire dtype for ``partials`` (K,) or
    (s, K): (P, K) or (s, P, K), slot ``slot`` filled, zeros elsewhere."""
    wire = cfg.wire_dtype(partials.dtype)
    shape = tuple(partials.shape[:-1]) + (cfg.n_shards, partials.shape[-1])
    buf = torch.zeros(shape, dtype=wire, device=partials.device)
    buf.select(-2, slot).copy_(partials)
    return buf


def staged_start(partials: torch.Tensor, cfg: StagedConfig,
                 rank: int) -> torch.Tensor:
    """Park this rank's dot-block partials, (K,) or a slab's (s, K), in a
    fresh gather buffer of the wire dtype, (P, K) or (s, P, K), own slot
    filled: the posted, not yet progressed Iallreduce.  Nothing goes on
    the wire here."""
    return _gather_buffer(partials, cfg, rank)


def staged_advance(handle: torch.Tensor, step: int, cfg: StagedConfig,
                   wire) -> torch.Tensor:
    """Run advance step ``step`` of the ladder on ``handle`` in place:
    each of its hops is one send to the next rank and one receive from the
    previous one (``wire.exchange``, tag ``HOP_TAG + k``), a slot of the
    shard axis: (K,) for one column, (s, K) for a slab, in one message.
    Steps past the ladder are a no-op, so solvers can advance
    unconditionally."""
    for hop in ladder_step(wire.rank, cfg.n_shards, cfg.stages, step):
        tag = HOP_TAG + hop.k
        (got,) = wire.exchange(
            [(hop.send_to, tag, handle.select(-2, hop.send_slot))],
            [(hop.recv_from, tag, handle.select(-2, hop.recv_slot))],
            kind="hop")
        handle.select(-2, hop.recv_slot).copy_(got)
    return handle


def staged_wait(handle: torch.Tensor, advanced: int, cfg: StagedConfig,
                out_dtype: torch.dtype, wire) -> torch.Tensor:
    """Finish the ladder and combine (MPI_Wait).  ``advanced`` is how many
    advance steps the solver already ran on this handle (p(l)-CG: l-1; a
    blocking start and wait: 0); the rest run here, back to back, then the
    gathered partials are summed in rank order."""
    for step in range(advanced, cfg.stages):
        handle = staged_advance(handle, step, cfg, wire)
    return ordered_reduce(handle, out_dtype, cfg.compensated(out_dtype))


def staged_ops_pieces(cfg: StagedConfig, wire, solver_dtype=None) -> dict:
    """The ``SolverOps.create`` overrides of a staged rank: ``start``
    computes the local partials with ``dot_block_rows`` (the expression
    every substrate uses) and parks them; ``advance``/``wait`` drive the
    ladder over ``wire``; ``handle_zeros`` is the (P, K) wire-dtype shape
    of an in-flight D-ring slot (a slab's ring holds (s, P, K) slots); ``combine_partials`` parks the
    superkernel's partials in the same ladder."""
    out_default = torch.float64 if solver_dtype is None else solver_dtype

    def start(mat, vec):
        return staged_start(dot_block_rows(mat, vec), cfg, wire.rank)

    def advance(handle, step):
        return staged_advance(handle, step, cfg, wire)

    def wait(handle, advanced=0):
        out = handle.dtype if cfg.payload_dtype is None else out_default
        return staged_wait(handle, advanced, cfg, out, wire)

    def handle_zeros(shape, dtype, device=None):
        return torch.zeros((cfg.n_shards,) + tuple(shape),
                           dtype=cfg.wire_dtype(dtype), device=device)

    return dict(dot_block_start=start, dot_block_advance=advance,
                dot_block_wait=wait, handle_zeros=handle_zeros,
                combine_partials=lambda p_: staged_start(p_, cfg, wire.rank))


# --------------------------------------------------------------------------
# The ladder oracle (single device, no wire).
# --------------------------------------------------------------------------

def oracle_start(mat: torch.Tensor, vec: torch.Tensor,
                 cfg: StagedConfig) -> torch.Tensor:
    """Local partials of all ``n_shards`` virtual slices at once: (K, n)
    and (n,) give the (P, K) gather buffer, a slab's (s, K, n) and (s, n)
    the (s, P, K) one.

    The vector axis splits into P contiguous slices, the row blocks a
    P-shard partition owns, and each slice's partial is the same
    ``dot_block_rows`` expression a shard evaluates, so the gather buffer
    is a staged P-shard run's final buffer and ``ordered_reduce`` finishes
    it identically."""
    p = cfg.n_shards
    n = vec.shape[-1]
    if n % p:
        raise ValueError(f"oracle needs n divisible by virtual shards "
                         f"({n} % {p})")
    wire = cfg.wire_dtype(vec.dtype)
    nl = n // p
    return torch.stack([dot_block_rows(mat[..., r * nl:(r + 1) * nl],
                                       vec[..., r * nl:(r + 1) * nl]).to(wire)
                        for r in range(p)], dim=-2)


def oracle_partials(partials: torch.Tensor,
                    cfg: StagedConfig) -> torch.Tensor:
    """Oracle ``combine_partials``: one device has ONE partial (the
    superkernel's whole-vector sum, (K,) or a slab's (s, K)), filed as
    shard 0's slot of the gather buffer with zeros elsewhere."""
    return _gather_buffer(partials, cfg, 0)


def oracle_gather(partials: torch.Tensor,
                  cfg: StagedConfig) -> torch.Tensor:
    """``combine_partials`` of the fused ranks' reference: the (P, K)
    partials of the virtual shards' superkernels, or a slab's (s, P, K)
    (``parallel.distributed.stacked_fused_factory``), one per slot, are the
    gather buffer a staged P-rank run holds after its last hop."""
    if partials.dim() not in (2, 3) or partials.shape[-2] != cfg.n_shards:
        raise ValueError(f"oracle needs ([s,] {cfg.n_shards}, K) shard "
                         f"partials, got shape {tuple(partials.shape)}")
    return partials.to(cfg.wire_dtype(partials.dtype))


def oracle_ops_pieces(cfg: StagedConfig, solver_dtype=None) -> dict:
    """``SolverOps.create`` overrides for the local ladder oracle:
    ``advance`` is the identity (no wire on one device), ``wait`` runs the
    rank-ordered (compensated for a narrow wire) reduce into the solver
    dtype (``solver_dtype``, default fp64)."""
    out_default = torch.float64 if solver_dtype is None else solver_dtype

    def start(mat, vec):
        return oracle_start(mat, vec, cfg)

    def advance(handle, step):
        return handle

    def wait(handle, advanced=0):
        out = handle.dtype if cfg.payload_dtype is None else out_default
        return ordered_reduce(handle, out, cfg.compensated(out))

    def handle_zeros(shape, dtype, device=None):
        return torch.zeros((cfg.n_shards,) + tuple(shape),
                           dtype=cfg.wire_dtype(dtype), device=device)

    return dict(dot_block_start=start, dot_block_advance=advance,
                dot_block_wait=wait, handle_zeros=handle_zeros,
                combine_partials=lambda p_: oracle_partials(p_, cfg))


def oracle_solver_ops(op, prec, cfg: StagedConfig) -> SolverOps:
    """Single-device SolverOps running the ladder oracle, the staged
    analogue of ``SolverOps.local``: ``cfg.n_shards`` is the VIRTUAL shard
    count.  The fused path runs the whole-operator superkernel, whose one
    partial ``oracle_partials`` files in slot 0."""
    from repro_torch.kernels.ops import fused_iteration_factory

    pfun = (lambda v: v) if prec is None else (lambda v: prec.apply(v))
    return SolverOps.create(
        apply_a=lambda v: op.apply(v),
        prec=pfun,
        dot_block=dot_block_rows,
        fused_iter_factory=fused_iteration_factory(op, prec),
        **oracle_ops_pieces(cfg),
    )


def resolve_backend_reduction(backend, reduction: str, stages: int, dtype,
                              n_shards: int) -> StagedConfig | None:
    """Reduction-request resolution shared by backend constructors.

    Validates the mode, clamps ``stages`` into [1, P-1] and sets
    ``reduction_mode`` on the backend.  Returns the StagedConfig for the
    solver ops, or None for the monolithic reduction.  Every port backend
    runs the ladder (the local oracle and the torch.distributed wire), so
    the JAX module's downgrade of a declining backend has no counterpart
    here."""
    if reduction == "monolithic":
        backend.reduction_mode = "monolithic"
        return None
    if reduction != "staged":
        raise ValueError(f"unknown reduction mode {reduction!r} "
                         "(want 'monolithic' or 'staged')")
    backend.reduction_mode = "staged"
    n_shards = max(n_shards, 1)
    stages = max(1, min(stages, max(n_shards - 1, 1)))
    return StagedConfig(n_shards=n_shards, stages=stages,
                        payload_dtype=dtype)


# --------------------------------------------------------------------------
# Wire accounting.
# --------------------------------------------------------------------------

def hop_payload_bytes(l: int, s: int = 1, dsize: int = 8) -> int:
    """Bytes ONE ladder hop carries: the (2l+1)[, s] dot block in the wire
    dtype (the fp32 option halves exactly this); a slab's s columns ride
    the one message (``staged_advance`` sends an (s, 2l+1) slot)."""
    return (2 * l + 1) * max(s, 1) * dsize


def reduction_wire_bytes(n_shards: int, l: int, s: int = 1,
                         dsize: int = 8) -> int:
    """Bytes one shard sends per staged reduction: P-1 hops x the hop
    payload (more in total than a tree all-reduce; the regime is
    latency-bound, tiny K)."""
    return (n_shards - 1) * hop_payload_bytes(l, s, dsize)
