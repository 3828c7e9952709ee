"""Row partition of unstructured sparse operators (counterpart of
``repro/linalg/partition.py``, DESIGN.md §12).

A :class:`~repro_torch.linalg.sparse.SparseOp` split over P shards needs
its halo computed: which of my rows do my neighbours reference, and where
do their values land in my local gather?  :func:`partition_spd` answers
with a :class:`PartitionPlan`, built by the JAX package's host numpy,
copied unchanged, so both packages give the same plan:

1.  **Order**: reverse Cuthill-McKee, so contiguous row blocks are a good
    partition (the remote columns of shard i sit in the adjacent shards).
2.  **Split**: P contiguous blocks of ``nxl = n / P`` rows.
3.  **Index sets**: per shard and hop distance h (1..hops, ``hops =
    ceil(bandwidth / nxl)``), the send sets: the local rows shard i±h
    references, padded to one width.  The local ELL columns are remapped
    into the extended local vector ``[own rows | from prev (hops slabs) |
    from next (hops slabs)]``.

In one process the P shards are a stack: :func:`halo_exchange` builds
every shard's extended vector from the (P, nxl) stack by slicing, and
:func:`apply_local` is the shard-level SpMV over it, through the ported ELL
kernel with ``use_kernel=True``.  Over a wire each rank holds one shard:
:func:`halo_messages` lists the buffers it sends and receives (one per
direction and hop, a pure function of its rank), :func:`halo_assemble`
builds its extended vector from what arrived, :func:`halo_exchange_shard`
runs the two over a ``repro_torch.parallel.wire.Wire``, and
:func:`apply_shard` is the rank's SpMV.  :func:`emulate_partitioned_apply`
is the pure-numpy reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.ref import ell_rowsum
from repro_torch.linalg.sparse import (SparseOp, bandwidth, permute_spd,
                                       rcm_permutation)

__all__ = ["PartitionPlan", "partition_spd", "halo_exchange", "apply_local",
           "halo_tag", "halo_messages", "halo_assemble",
           "halo_exchange_shard", "apply_extended", "apply_shard",
           "emulate_partitioned_apply", "operator_fingerprint", "plan_for"]


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Static per-shard data for a partitioned unstructured SpMV, stacked
    on a leading shard axis and padded to uniform sizes.

    cols : (P, nxl, w) int32 — ELL column slots remapped into the
        extended local vector [0, nxl + 2*hops*max_send).
    vals : (P, nxl, w) — ELL values (padded slots 0.0).
    send_up : (P, hops, max_send) int32 — local rows shard i ships to
        shard i+h (hop slab h-1); send_dn symmetrically to i-h.
    perm : (n,) int64 numpy — the ordering used (``perm[new] = old``);
        identity when the operator was pre-ordered.
    """

    n_shards: int
    n: int
    nxl: int
    hops: int
    max_send: int
    cols: torch.Tensor
    vals: torch.Tensor
    send_up: torch.Tensor
    send_dn: torch.Tensor
    perm: np.ndarray
    band: int                      # post-ordering bandwidth (diagnostics)

    @property
    def ext(self) -> int:
        """Length of a shard's extended local vector."""
        return self.nxl + 2 * self.hops * self.max_send

    @property
    def inv_perm(self) -> np.ndarray:
        inv = np.empty_like(self.perm)
        inv[self.perm] = np.arange(self.perm.size)
        return inv

    @property
    def identity_perm(self) -> bool:
        return bool((self.perm == np.arange(self.perm.size)).all())

    def neighbor_bytes(self, dsize: int = 8) -> int:
        """Per-iteration halo send bytes of one shard (both directions, all
        hops), the structured operators' convention."""
        return 2 * self.hops * self.max_send * dsize

    def occupancy(self) -> float:
        """Useful fraction of ELL slots (1.0 = no padding waste)."""
        v = self.vals.cpu().numpy()
        return float(np.count_nonzero(v) / v.size)

    def halo_rows_fraction(self) -> float:
        """Halo rows shipped per shard relative to rows owned."""
        return 2.0 * self.hops * self.max_send / self.nxl


def partition_spd(op: SparseOp, n_shards: int,
                  reorder: bool = True) -> PartitionPlan:
    """Build the :class:`PartitionPlan` for ``op`` over ``n_shards``.

    Requires ``op.n % n_shards == 0``.  The hop count is
    ``ceil(band / nxl)`` with ``band`` the post-RCM bandwidth.  The plan's
    tensors lie on ``op``'s device.  ``reorder=False`` keeps ``op``'s own
    row order even when it is not RCM-ordered (the ladder oracle's virtual
    shards are contiguous slices of the operator as given)."""
    n = op.n
    assert n % n_shards == 0, (
        f"unstructured partition needs n % n_shards == 0 (n={n}, "
        f"S={n_shards}); pad the mesh generator's node count")
    if op.ordered or n_shards == 1 or not reorder:
        perm = np.arange(n, dtype=np.int64)
        oop = op
    else:
        perm = rcm_permutation(op)
        oop = permute_spd(op, perm, ordered=True)
    nxl = n // n_shards
    band = bandwidth(oop)
    hops = min(max(-(-band // nxl), 1), n_shards - 1) if n_shards > 1 else 1

    cols = oop.cols.cpu().numpy()
    vals = oop.vals.cpu().numpy()
    w = oop.w
    nz = vals != 0.0
    starts = np.arange(n_shards) * nxl

    # --- send sets: which of shard s's rows does shard s±h touch? -------
    def _referenced(reader: int, owner: int) -> np.ndarray:
        """Column indices (local to ``owner``) that ``reader`` references."""
        rlo, rhi = starts[reader], starts[reader] + nxl
        olo, ohi = starts[owner], starts[owner] + nxl
        c = cols[rlo:rhi][nz[rlo:rhi]]
        c = c[(c >= olo) & (c < ohi)]
        return np.unique(c) - olo

    empty = np.empty(0, dtype=np.int64)
    send_up = [[_referenced(s + h, s) if s + h < n_shards else empty
                for h in range(1, hops + 1)] for s in range(n_shards)]
    send_dn = [[_referenced(s - h, s) if s - h >= 0 else empty
                for h in range(1, hops + 1)] for s in range(n_shards)]
    max_send = max(
        1, max((len(a) for row in send_up + send_dn for a in row),
               default=1))

    # --- remap ELL columns into the extended local vector ----------------
    # From-prev slab h-1 holds the up(h)-send buffer of shard s-h, so a
    # column owned by s-h maps to nxl + (h-1)*max_send + its position in
    # send_up[s-h][h-1]; symmetrically for s+h via send_dn[s+h][h-1].
    ext = nxl + 2 * hops * max_send
    cols_l = np.zeros((n_shards, nxl, w), dtype=np.int32)
    vals_l = np.zeros((n_shards, nxl, w), dtype=vals.dtype)
    for s in range(n_shards):
        lo, hi = starts[s], starts[s] + nxl
        c = cols[lo:hi].astype(np.int64)
        v = vals[lo:hi]
        rnz = v != 0.0
        local = (c >= lo) & (c < hi)
        out = np.zeros_like(c)
        out[local] = c[local] - lo
        covered = local | ~rnz
        for h in range(1, hops + 1):
            if s - h >= 0:
                olo = starts[s - h]
                m = rnz & (c >= olo) & (c < olo + nxl)
                pos = np.searchsorted(send_up[s - h][h - 1], c[m] - olo)
                out[m] = nxl + (h - 1) * max_send + pos
                covered |= m
            if s + h < n_shards:
                olo = starts[s + h]
                m = rnz & (c >= olo) & (c < olo + nxl)
                pos = np.searchsorted(send_dn[s + h][h - 1], c[m] - olo)
                out[m] = nxl + (hops + h - 1) * max_send + pos
                covered |= m
        assert covered.all(), "halo remap missed a referenced column"
        assert (out[rnz] < ext).all()
        cols_l[s] = out
        vals_l[s] = v

    def _pad(sets):
        a = np.zeros((n_shards, hops, max_send), dtype=np.int32)
        for s in range(n_shards):
            for h in range(hops):
                idx = sets[s][h]
                a[s, h, :len(idx)] = idx
        return a

    dev = op.device
    return PartitionPlan(
        n_shards=n_shards, n=n, nxl=nxl, hops=hops, max_send=max_send,
        cols=torch.from_numpy(cols_l).to(dev),
        vals=torch.from_numpy(vals_l).to(dev),
        send_up=torch.from_numpy(_pad(send_up)).to(dev),
        send_dn=torch.from_numpy(_pad(send_dn)).to(dev),
        perm=perm, band=band,
    )


# --------------------------------------------------------------------------
# Shard-level apply over the (P, nxl) stack of virtual shards.
# --------------------------------------------------------------------------

def halo_exchange(x_local: torch.Tensor, send_up: torch.Tensor,
                  send_dn: torch.Tensor) -> torch.Tensor:
    """Every shard's extended local vector, in one process.

    ``x_local`` is the (P, nxl) stack of the shards' own rows, or a slab's
    (s, P, nxl), and ``send_up``/``send_dn`` the plan's (P, hops,
    max_send) send sets.  Shard s's vector is [own | from s-1, ...,
    s-hops | from s+1, ..., s+hops], each slab the sender's buffer
    ``x_local[s∓h][send[s∓h, h-1]]`` (slicing stands in for the wire),
    zeros where no peer exists: the empty halo at the domain's ends.
    Returns (P, nxl + 2*hops*max_send), or (s, P, ...) for a slab."""
    p = x_local.shape[-2]
    lead = tuple(x_local.shape[:-2])
    hops, max_send = send_up.shape[1], send_up.shape[2]
    zeros = x_local.new_zeros(lead + (p, max_send))
    from_prev, from_next = [], []
    for h in range(1, hops + 1):
        up_buf = torch.gather(x_local, -1, send_up[:, h - 1].long().expand(
            lead + (p, max_send)))
        dn_buf = torch.gather(x_local, -1, send_dn[:, h - 1].long().expand(
            lead + (p, max_send)))
        if p > h:
            from_prev.append(torch.cat([zeros[..., :h, :],
                                        up_buf[..., :p - h, :]], dim=-2))
            from_next.append(torch.cat([dn_buf[..., h:, :],
                                        zeros[..., :h, :]], dim=-2))
        else:
            from_prev.append(zeros)
            from_next.append(zeros)
    return torch.cat([x_local] + from_prev + from_next, dim=-1)


def apply_local(x_local: torch.Tensor, cols: torch.Tensor,
                vals: torch.Tensor, send_up: torch.Tensor,
                send_dn: torch.Tensor, use_kernel: bool = False
                ) -> torch.Tensor:
    """Shard-level unstructured SpMV of every shard: the halo exchange,
    then the local ELL product over the extended vector.  ``x_local`` is
    (P, nxl), the plan's arrays (P, ...); returns (P, nxl).
    ``use_kernel=True`` routes each shard's product through the ported ELL
    kernel (``kernels.ops.ell_spmv_apply``); otherwise the product sums the
    slots with ``ell_rowsum``'s chain, as ``SparseOp.apply`` does, so the
    stacked result equals the ordered operator's apply bitwise."""
    xe = halo_exchange(x_local, send_up, send_dn)
    if use_kernel:
        from repro_torch.kernels import ops as kops

        return torch.stack([kops.ell_spmv_apply(xe[s], cols[s], vals[s])
                            for s in range(xe.shape[0])])
    p, nxl, w = cols.shape
    gathered = torch.gather(xe, 1, cols.reshape(p, nxl * w).long())
    return ell_rowsum(vals.to(x_local.dtype), gathered.reshape(p, nxl, w))


# --------------------------------------------------------------------------
# One rank's shard, over a wire.
# --------------------------------------------------------------------------

def halo_tag(h: int, up: bool) -> int:
    """Message tag of a halo buffer travelling h ranks up (to rank r+h, its
    from-prev slab h-1) or down (to r-h, its from-next slab h-1)."""
    return 2 * h if up else 2 * h + 1


def halo_messages(x_local: torch.Tensor, send_up: torch.Tensor,
                  send_dn: torch.Tensor, rank: int, size: int):
    """Rank ``rank``'s halo messages: ``(sends, recvs)``, lists of
    ``(peer, tag, tensor)`` and ``(peer, tag, like)``.  For each hop h it
    sends its rows ``send_up[h-1]`` to rank+h and ``send_dn[h-1]`` to
    rank-h, and receives one ``max_send`` buffer from each of them; no
    message goes past the domain's ends.  A slab ``x_local`` (s, nxl)
    sends each set of every column in one (s, max_send) message."""
    hops, max_send = send_up.shape
    like = x_local.new_empty(tuple(x_local.shape[:-1]) + (max_send,))
    sends, recvs = [], []
    for h in range(1, hops + 1):
        if rank + h < size:
            sends.append((rank + h, halo_tag(h, True),
                          x_local[..., send_up[h - 1].long()]))
            recvs.append((rank + h, halo_tag(h, False), like))
        if rank - h >= 0:
            sends.append((rank - h, halo_tag(h, False),
                          x_local[..., send_dn[h - 1].long()]))
            recvs.append((rank - h, halo_tag(h, True), like))
    return sends, recvs


def halo_assemble(x_local: torch.Tensor, hops: int, max_send: int,
                  rank: int, recvs, got) -> torch.Tensor:
    """The extended vector [own | from rank-1, ..., rank-hops | from
    rank+1, ..., rank+hops] from the buffers ``got`` that arrived for
    ``recvs`` (as :func:`halo_messages` listed them), zeros where no peer
    exists: the one-shard form of :func:`halo_exchange` (for a slab
    (s, nxl), each column's)."""
    zero = x_local.new_zeros(tuple(x_local.shape[:-1]) + (max_send,))
    from_prev, from_next = [zero] * hops, [zero] * hops
    for (peer, _, _), buf in zip(recvs, got):
        if peer < rank:
            from_prev[rank - peer - 1] = buf
        else:
            from_next[peer - rank - 1] = buf
    return torch.cat([x_local] + from_prev + from_next, dim=-1)


def halo_exchange_shard(x_local: torch.Tensor, send_up: torch.Tensor,
                        send_dn: torch.Tensor, wire) -> torch.Tensor:
    """This rank's extended local vector over ``wire``: one send and one
    receive per (direction, hop), posted as one batch."""
    sends, recvs = halo_messages(x_local, send_up, send_dn, wire.rank,
                                 wire.size)
    got = wire.exchange(sends, recvs, kind="halo")
    hops, max_send = send_up.shape
    return halo_assemble(x_local, hops, max_send, wire.rank, recvs, got)


def apply_extended(xe: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                   use_kernel: bool = False) -> torch.Tensor:
    """One shard's ELL product over its extended vector ``xe`` (cols
    (nxl, w) index it), or over each row of a slab (s, ext): through the
    ELL kernel with ``use_kernel=True``, otherwise ``ell_rowsum``'s chain,
    as :func:`apply_local` per shard."""
    if use_kernel:
        from repro_torch.kernels import ops as kops

        return kops.ell_spmv_apply(xe, cols, vals)
    return ell_rowsum(vals.to(xe.dtype), xe[..., cols.long()])


def apply_shard(x_local: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                send_up: torch.Tensor, send_dn: torch.Tensor, wire,
                use_kernel: bool = False) -> torch.Tensor:
    """This rank's unstructured SpMV: the halo exchange over ``wire``, then
    the local ELL product (``use_kernel`` routes it through the kernel)."""
    xe = halo_exchange_shard(x_local, send_up, send_dn, wire)
    return apply_extended(xe, cols, vals, use_kernel)


def emulate_partitioned_apply(plan: PartitionPlan,
                              xp: np.ndarray) -> np.ndarray:
    """Pure-numpy reference of halo_exchange + apply_local: gather each
    shard's send sets, 'send' them by array slicing, ELL-multiply.  ``xp``
    must already be in the plan's ordering (``x[plan.perm]``)."""
    cols = plan.cols.cpu().numpy()
    vals = plan.vals.cpu().numpy()
    su = plan.send_up.cpu().numpy()
    sd = plan.send_dn.cpu().numpy()
    S, nxl, H, ms = plan.n_shards, plan.nxl, plan.hops, plan.max_send
    y = np.zeros(plan.n)
    for s in range(S):
        xl = xp[s * nxl:(s + 1) * nxl]
        fp, fn = [], []
        for h in range(1, H + 1):
            fp.append(xp[(s - h) * nxl:(s - h + 1) * nxl][su[s - h, h - 1]]
                      if s - h >= 0 else np.zeros(ms))
            fn.append(xp[(s + h) * nxl:(s + h + 1) * nxl][sd[s + h, h - 1]]
                      if s + h < S else np.zeros(ms))
        xe = np.concatenate([xl] + fp + fn)
        y[s * nxl:(s + 1) * nxl] = (vals[s] * xe[cols[s]]).sum(axis=1)
    return y


# --------------------------------------------------------------------------
# Plan memoization.
# --------------------------------------------------------------------------

def operator_fingerprint(op: Any) -> str:
    """Content hash of an operator (the JAX package's
    ``repro.serve.cache.operator_fingerprint``): dataclass fields in
    declaration order, tensor and array fields by shape, dtype and bytes,
    anything else by ``repr``."""
    h = hashlib.sha1(type(op).__name__.encode())
    if dataclasses.is_dataclass(op):
        for f in dataclasses.fields(op):
            v = getattr(op, f.name)
            h.update(f.name.encode())
            if isinstance(v, torch.Tensor):
                v = v.cpu().numpy()
            if hasattr(v, "shape") and hasattr(v, "dtype"):
                a = np.asarray(v)
                h.update(str(a.shape).encode())
                h.update(str(a.dtype).encode())
                h.update(a.tobytes())
            else:
                h.update(repr(v).encode())
    else:
        h.update(repr(op).encode())
    return h.hexdigest()


_PLAN_CACHE: dict[tuple, PartitionPlan] = {}


def plan_for(op: SparseOp, n_shards: int,
             reorder: bool = True) -> PartitionPlan:
    """Memoized :func:`partition_spd` keyed by operator fingerprint: RCM
    and the send sets are set-up work paid once per operator (a rank's
    backend partitions the operator of every solve it is given)."""
    key = (operator_fingerprint(op), n_shards, reorder)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = partition_spd(op, n_shards, reorder)
        _PLAN_CACHE[key] = plan
    return plan
