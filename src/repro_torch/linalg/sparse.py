"""Unstructured SPD sparse operators in padded-row ELL storage
(counterpart of ``repro/linalg/sparse.py``, DESIGN.md §12).

Every construction step (COO packing, reverse Cuthill-McKee, the random
FEM mesh generators, the Lanczos ``eig_bounds``) is the JAX package's
host numpy, copied unchanged, so one seed gives identical ``cols`` and
``vals`` in both packages.  The tensors go to the device only at the end:
``cols`` as int32, ``vals`` in the requested dtype.

``SparseOp.apply`` sums the slots with the explicit left-to-right chain
of :func:`ell_rowsum`; ``use_kernel=True`` routes it through the
hand-written ELL kernel (``kernels/csrc/ell_spmv.cu``), which follows
the same chain, so a kernel-routed solve is bitwise equal to a plain
one on the card.

``SlicedEllOp`` (degree-sorted rows cut into slices, each padded to its
own width) applies by width groups: the slices of one width stack into
one block, each block is one gather and one :func:`ell_rowsum` chain, and
the rows go back by a fixed permutation (a gather, never an atomic
scatter): at most ``w_max`` groups an apply where the JAX package loops
over ~n/64 slices, with every row's terms in the per-slice order, so the
result is bitwise the per-slice loop's.  The superkernel has no sliced
plug-in: a fused solve on a ``SlicedEllOp`` raises, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.ref import ell_rowsum
from repro_torch.linalg.operators import LinearOperator

__all__ = ["ell_rowsum", "SparseOp", "sparse_from_coo", "sparse_from_dense",
           "rcm_permutation", "bandwidth", "permute_spd", "rcm_reorder",
           "random_fem_mesh", "random_fem_icesheet", "SlicedEllOp",
           "degree_sort_permutation", "sliced_ell_reorder"]


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass(frozen=True, eq=False)
class SparseOp(LinearOperator):
    """SPD sparse operator in padded-row ELL storage.

    cols : (n, w) int32 — column index per slot (padded slots: 0).
    vals : (n, w)        — value per slot (padded slots: 0.0).
    ordered : True when the rows are already bandwidth-ordered (set by
        :func:`rcm_reorder`).
    use_kernel : route ``apply`` through the CUDA ELL kernel (its plain
        version on a CPU tensor).
    device : where ``cols``/``vals`` live; None means ``cuda``, or the
        device of a ``cols`` tensor.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    ordered: bool = False
    use_kernel: bool = False
    device: torch.device | str | None = None

    def __post_init__(self):
        if self.device is None and isinstance(self.cols, torch.Tensor):
            object.__setattr__(self, "device", self.cols.device)
        dev = resolve_device(self.device)
        cols, vals = self.cols, self.vals
        if not isinstance(cols, torch.Tensor):
            cols = torch.as_tensor(np.array(cols))
        if not isinstance(vals, torch.Tensor):
            vals = torch.as_tensor(np.array(vals))
        if cols.dim() != 2 or vals.shape != cols.shape:
            raise ValueError(f"cols {tuple(cols.shape)} and vals "
                             f"{tuple(vals.shape)} must be one (n, w)")
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "cols", cols.to(
            device=dev, dtype=torch.int32).contiguous())
        object.__setattr__(self, "vals", vals.to(device=dev).contiguous())

    @property
    def n(self) -> int:  # type: ignore[override]
        return int(self.cols.shape[0])

    @property
    def w(self) -> int:
        return int(self.cols.shape[1])

    @property
    def nnz(self) -> int:
        return int(torch.count_nonzero(self.vals))

    def to(self, device) -> "SparseOp":
        """The same operator with its arrays on ``device``."""
        dev = resolve_device(device)
        return dataclasses.replace(self, cols=self.cols.to(dev),
                                   vals=self.vals.to(dev), device=dev)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_kernel:
            return self.apply_kernel(x)
        return ell_rowsum(self.vals.to(x.dtype), x[..., self.cols])

    def apply_kernel(self, x: torch.Tensor) -> torch.Tensor:
        """Route the product through the ELL kernel
        (``kernels.ops.ell_spmv_apply``; its plain version on the CPU).
        An (s, n) slab goes through the kernel's slab form in one launch."""
        from repro_torch.kernels import ops as kops

        return kops.ell_spmv_apply(x, self.cols, self.vals)

    def diag(self) -> torch.Tensor:
        row = torch.arange(self.n, dtype=self.cols.dtype,
                           device=self.device)[:, None]
        return torch.where(self.cols == row, self.vals,
                           torch.zeros((), dtype=self.vals.dtype,
                                       device=self.device)).sum(dim=-1)

    def to_dense(self) -> np.ndarray:
        cols = _host(self.cols)
        vals = _host(self.vals).astype(np.float64)
        a = np.zeros((self.n, self.n))
        rows = np.repeat(np.arange(self.n), self.w)
        # += via add.at: padded slots accumulate 0.0 into column 0 — exact.
        np.add.at(a, (rows, cols.reshape(-1)), vals.reshape(-1))
        return a

    def eig_bounds(self) -> tuple[float, float]:
        """Lanczos estimates of the extremal eigenvalues (setup-time
        numpy, the JAX package's recurrence line by line), widened 15 %
        down and 5 % up for the Chebyshev shifts."""
        cols = _host(self.cols)
        vals = _host(self.vals).astype(np.float64)

        def av(x):
            return (vals * x[cols]).sum(axis=-1)

        n = self.n
        m = min(max(2, n - 1), 60)
        rng = np.random.default_rng(0)
        v = rng.standard_normal(n)
        v /= np.linalg.norm(v)
        alphas, betas = [], []
        v_prev = np.zeros(n)
        beta = 0.0
        for _ in range(m):
            w = av(v) - beta * v_prev
            alpha = float(v @ w)
            w -= alpha * v
            alphas.append(alpha)
            beta = float(np.linalg.norm(w))
            if beta < 1e-12:
                break
            betas.append(beta)
            v_prev, v = v, w / beta
        t = np.diag(alphas)
        if betas:
            k = len(alphas)
            b = np.asarray(betas[: k - 1])
            t = t + np.diag(b, 1) + np.diag(b, -1)
        ritz = np.linalg.eigvalsh(t)
        lmin, lmax = float(ritz[0]), float(ritz[-1])
        return max(lmin * 0.85, 1e-10 * lmax), lmax * 1.05


def sparse_from_coo(n: int, rows, cols, vals, dtype=torch.float64,
                    ordered: bool = False, device=None) -> SparseOp:
    """Build a :class:`SparseOp` from COO triplets (duplicates summed)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals, dtype=np.float64)
    if not rows.shape == cols.shape == vals.shape:
        raise ValueError("rows, cols and vals must have one shape")
    if rows.size and not (rows.min() >= 0 and rows.max() < n
                          and cols.min() >= 0 and cols.max() < n):
        raise ValueError(f"COO indices outside [0, {n})")
    # Coalesce duplicates, then pack rows into padded-ELL slots.
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, rows, cols, vals = key[order], rows[order], cols[order], vals[order]
    uniq, inv = np.unique(key, return_inverse=True)
    v = np.zeros(uniq.shape[0])
    np.add.at(v, inv, vals)
    r, c = uniq // n, uniq % n
    keep = v != 0.0
    r, c, v = r[keep], c[keep], v[keep]
    counts = np.bincount(r, minlength=n)
    w = max(int(counts.max(initial=0)), 1)
    slot = np.arange(r.size) - np.concatenate(
        ([0], np.cumsum(counts)))[r]
    ecols = np.zeros((n, w), dtype=np.int32)
    evals = np.zeros((n, w))
    ecols[r, slot] = c
    evals[r, slot] = v
    dev = resolve_device(device)
    return SparseOp(cols=torch.as_tensor(ecols, device=dev),
                    vals=torch.as_tensor(evals, dtype=dtype, device=dev),
                    ordered=ordered, device=dev)


def sparse_from_dense(a: np.ndarray, dtype=torch.float64, tol: float = 0.0,
                      device=None) -> SparseOp:
    """ELL-pack a dense matrix (tests / oracles)."""
    a = np.asarray(a, dtype=np.float64)
    r, c = np.nonzero(np.abs(a) > tol)
    return sparse_from_coo(a.shape[0], r, c, a[r, c], dtype=dtype,
                           device=device)


# --------------------------------------------------------------------------
# Bandwidth-reducing ordering (reverse Cuthill–McKee, pure numpy).
# --------------------------------------------------------------------------

def _neighbor_csr(op: SparseOp) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetrized adjacency: (deg, nbrs, starts) where node u's
    neighbours are ``nbrs[starts[u]:starts[u+1]]``, presorted by
    (degree, index), the visit order Cuthill–McKee wants."""
    cols = _host(op.cols)
    vals = _host(op.vals)
    n = op.n
    rr, ss = np.nonzero(vals)
    cc = cols[rr, ss].astype(np.int64)
    keep = rr != cc
    i = np.concatenate([rr[keep], cc[keep]])
    j = np.concatenate([cc[keep], rr[keep]])     # symmetrize (A is SPD)
    key = np.unique(i * n + j)                   # dedupe directed pairs
    i, j = key // n, key % n
    deg = np.bincount(i, minlength=n)
    order = np.lexsort((j, deg[j], i))           # per-node (deg, idx) order
    nbrs = j[order]
    starts = np.concatenate(([0], np.cumsum(deg)))
    return deg, nbrs, starts


def rcm_permutation(op: SparseOp) -> np.ndarray:
    """Reverse Cuthill–McKee ordering: ``perm[new] = old``.  BFS from a
    minimum-degree seed per connected component, neighbours in
    increasing-degree order, final order reversed."""
    n = op.n
    deg, nbrs, starts = _neighbor_csr(op)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    for seed in np.argsort(deg, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        queue = deque([int(seed)])
        while queue:
            u = queue.popleft()
            order[pos] = u
            pos += 1
            for v in nbrs[starts[u]:starts[u + 1]]:
                if not visited[v]:
                    visited[v] = True
                    queue.append(int(v))
    if pos != n:
        raise RuntimeError(f"RCM visited {pos} of {n} nodes")
    return order[::-1].copy()


def bandwidth(op: SparseOp) -> int:
    """max |i - j| over structural nonzeros."""
    cols = _host(op.cols)
    vals = _host(op.vals)
    rows = np.arange(op.n)[:, None]
    d = np.abs(rows - cols)
    return int(np.where(vals != 0.0, d, 0).max(initial=0))


def permute_spd(op: SparseOp, perm: np.ndarray,
                ordered: bool = False) -> SparseOp:
    """Symmetric permutation P A P^T with ``perm[new] = old``."""
    perm = np.asarray(perm, dtype=np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    cols = _host(op.cols)
    vals = _host(op.vals)
    rows = np.repeat(np.arange(op.n), op.w)
    keep = vals.reshape(-1) != 0.0
    r = inv[rows[keep]]
    c = inv[cols.reshape(-1)[keep]]
    return sparse_from_coo(op.n, r, c, vals.reshape(-1)[keep],
                           dtype=op.vals.dtype, ordered=ordered,
                           device=op.device)


def rcm_reorder(op: SparseOp) -> tuple[SparseOp, np.ndarray]:
    """(RCM-ordered operator, perm) with ``perm[new] = old``.  Solve the
    permuted system with ``b[perm]`` and map the solution back with
    ``x_orig = x_perm[np.argsort(perm)]``."""
    perm = rcm_permutation(op)
    return permute_spd(op, perm, ordered=True), perm


# --------------------------------------------------------------------------
# Sliced ELL: degree-sorted row buckets, per-slice padding.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class SlicedEllOp(LinearOperator):
    """Sliced-ELL storage: rows sorted by nonzero count and cut into slices
    of ``slice_rows`` rows, each slice padded only to its own max row
    length instead of the global one (the JAX package's class).

    slice_cols / slice_vals : per-slice (rows_s, w_s) int32 / value
        arrays, tensors or numpy (moved to ``device``).
    device : where they live; None means ``cuda``, or the device of a
        first ``slice_cols`` tensor.

    The slices of equal width form the width groups ``apply`` runs on
    (``groups``: (cols, vals) blocks; ``rows_out``: the output position of
    each group row, None when the groups are already in row order, which
    degree sorting gives).
    """

    slice_rows: int
    slice_cols: tuple
    slice_vals: tuple
    device: torch.device | str | None = None

    def __post_init__(self):
        first = self.slice_cols[0] if self.slice_cols else None
        if self.device is None and isinstance(first, torch.Tensor):
            object.__setattr__(self, "device", first.device)
        dev = resolve_device(self.device)
        cols = tuple(torch.as_tensor(np.asarray(_host(c)), dtype=torch.int32,
                                     device=dev).contiguous()
                     for c in self.slice_cols)
        vals = tuple(torch.as_tensor(np.asarray(_host(v)),
                                     device=dev).contiguous()
                     for v in self.slice_vals)
        if len(cols) != len(vals) or any(
                c.dim() != 2 or c.shape != v.shape
                for c, v in zip(cols, vals)):
            raise ValueError("slice_cols and slice_vals must be matching "
                             "(rows_s, w_s) arrays")
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "slice_cols", cols)
        object.__setattr__(self, "slice_vals", vals)
        # Width groups, in order of first appearance.
        offs = np.cumsum([0] + [c.shape[0] for c in cols])
        members: dict[int, list[int]] = {}
        for s, c in enumerate(cols):
            members.setdefault(int(c.shape[1]), []).append(s)
        groups, order = [], []
        for ss in members.values():
            groups.append((torch.cat([cols[s] for s in ss]),
                           torch.cat([vals[s] for s in ss])))
            order.extend(range(offs[s], offs[s + 1]) for s in ss)
        rows = np.concatenate([np.arange(r.start, r.stop) for r in order]
                              ) if order else np.zeros(0, np.int64)
        object.__setattr__(self, "groups", tuple(groups))
        object.__setattr__(self, "group_rows", torch.as_tensor(
            rows, dtype=torch.int64, device=dev))
        inv = np.empty_like(rows)
        inv[rows] = np.arange(rows.size)
        object.__setattr__(self, "rows_out", None if np.array_equal(
            inv, np.arange(rows.size)) else torch.as_tensor(inv, device=dev))

    @property
    def n(self) -> int:  # type: ignore[override]
        return sum(int(c.shape[0]) for c in self.slice_cols)

    @property
    def nnz(self) -> int:
        return int(sum(int(torch.count_nonzero(v)) for v in self.slice_vals))

    @property
    def padded_slots(self) -> int:
        return int(sum(c.shape[0] * c.shape[1] for c in self.slice_cols))

    def occupancy(self) -> float:
        """Useful fraction of stored slots."""
        return self.nnz / max(self.padded_slots, 1)

    def padding_waste(self) -> float:
        """Fraction of streamed slots that are padding (1 - occupancy)."""
        return 1.0 - self.occupancy()

    def _by_groups(self, parts: list[torch.Tensor]) -> torch.Tensor:
        y = torch.cat(parts, dim=-1)
        return y if self.rows_out is None else y[..., self.rows_out]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """A x for x (n,) or an (s, n) slab: one gather and one
        ``ell_rowsum`` chain a width group."""
        return self._by_groups([ell_rowsum(v.to(x.dtype), x[..., c])
                                for c, v in self.groups])

    def diag(self) -> torch.Tensor:
        parts, r0 = [], 0
        for c, v in self.groups:
            row = self.group_rows[r0:r0 + c.shape[0], None]
            parts.append(torch.where(c == row, v, torch.zeros(
                (), dtype=v.dtype, device=self.device)).sum(dim=-1))
            r0 += c.shape[0]
        return self._by_groups(parts)

    def to_dense(self) -> np.ndarray:
        n = self.n
        a = np.zeros((n, n))
        off = 0
        for c, v in zip(self.slice_cols, self.slice_vals):
            cc = _host(c)
            vv = _host(v).astype(np.float64)
            rows = np.repeat(np.arange(off, off + cc.shape[0]), cc.shape[1])
            np.add.at(a, (rows, cc.reshape(-1)), vv.reshape(-1))
            off += cc.shape[0]
        return a


def degree_sort_permutation(op: SparseOp) -> np.ndarray:
    """Stable row permutation by DESCENDING nonzero count (``perm[new] =
    old``); stability keeps the (RCM) order within a degree class."""
    lengths = np.count_nonzero(_host(op.vals), axis=1)
    return np.argsort(-lengths, kind="stable").astype(np.int64)


def sliced_ell_reorder(op: SparseOp, slice_rows: int = 64
                       ) -> tuple[SlicedEllOp, np.ndarray]:
    """(sliced operator, perm) with ``perm[new] = old`` in the ORIGINAL
    row numbering: the degree-sort permutation composed with the
    operator's RCM ordering (applied first when ``op`` is not already
    ``ordered``).  Solve with ``b[perm]``, un-permute with
    ``np.argsort(perm)``, as for :func:`rcm_reorder`."""
    if op.ordered:
        base, base_perm = op, np.arange(op.n, dtype=np.int64)
    else:
        base, base_perm = rcm_reorder(op)
    dperm = degree_sort_permutation(base)
    perm = base_perm[dperm]
    sorted_op = permute_spd(base, dperm, ordered=False)
    cols = _host(sorted_op.cols)
    vals = _host(sorted_op.vals)
    lengths = np.count_nonzero(vals, axis=1)
    sc, sv = [], []
    for r0 in range(0, op.n, slice_rows):
        r1 = min(r0 + slice_rows, op.n)
        w_s = max(int(lengths[r0:r1].max(initial=1)), 1)
        sc.append(cols[r0:r1, :w_s])
        sv.append(vals[r0:r1, :w_s])
    return SlicedEllOp(slice_rows=slice_rows, slice_cols=tuple(sc),
                       slice_vals=tuple(sv), device=op.device), perm


# --------------------------------------------------------------------------
# Random FEM-style meshes (SPD graph Laplacians).
# --------------------------------------------------------------------------

def random_fem_mesh(seed: int, n_nodes: int, avg_degree: float = 6.0,
                    shift: float = 0.05, dtype=torch.float64,
                    device=None) -> SparseOp:
    """Random FEM-style SPD system: weighted graph Laplacian + mass shift.
    Random points in the unit square, each joined to its nearest
    neighbours (symmetrized) with weights 1/distance; ``shift`` adds
    ``shift * mean(diag) * I``."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n_nodes, 2))
    k = max(int(round(avg_degree)), 2)
    # k-nearest-neighbour graph via brute-force distances (setup-time
    # numpy; fine for the test sizes this serves).
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argsort(d2, axis=1)[:, :k]
    rows = np.repeat(np.arange(n_nodes), k)
    cols = nbr.reshape(-1)
    wgt = 1.0 / np.sqrt(d2[rows, cols] + 1e-12)
    # Symmetrize: keep max weight per undirected edge.
    i = np.minimum(rows, cols)
    j = np.maximum(rows, cols)
    key = i * n_nodes + j
    order = np.argsort(key, kind="stable")
    key, i, j, wgt = key[order], i[order], j[order], wgt[order]
    uniq, first = np.unique(key, return_index=True)
    i, j, wgt = i[first], j[first], wgt[first]
    return _graph_laplacian(n_nodes, i, j, wgt, shift, dtype, device)


def random_fem_icesheet(seed: int, nx: int, ny: int, nz: int,
                        eps_z: float = 0.01, shift: float = 0.05,
                        dtype=torch.float64, device=None) -> SparseOp:
    """Unstructured thin-sheet stand-in for SNES ex48 (DESIGN.md §12): a
    jittered nx×ny footprint mesh extruded through nz layers, horizontal
    conductances O(1) and vertical conductances ``eps_z``."""
    rng = np.random.default_rng(seed)
    # Jittered structured footprint: irregular geometry, mesh-like topology.
    gx, gy = np.meshgrid(np.arange(nx, dtype=float),
                         np.arange(ny, dtype=float), indexing="ij")
    pts = np.stack([gx, gy], axis=-1).reshape(-1, 2)
    pts += rng.uniform(-0.35, 0.35, size=pts.shape)
    nf = nx * ny

    def fid(ix, iy):
        return ix * ny + iy

    fi, fj = [], []
    for ix in range(nx):
        for iy in range(ny):
            if ix + 1 < nx:
                fi.append(fid(ix, iy)); fj.append(fid(ix + 1, iy))
            if iy + 1 < ny:
                fi.append(fid(ix, iy)); fj.append(fid(ix, iy + 1))
            # Random diagonal per cell, as an unstructured triangulation.
            if ix + 1 < nx and iy + 1 < ny:
                if rng.uniform() < 0.5:
                    fi.append(fid(ix, iy)); fj.append(fid(ix + 1, iy + 1))
                else:
                    fi.append(fid(ix + 1, iy)); fj.append(fid(ix, iy + 1))
    fi = np.asarray(fi); fj = np.asarray(fj)
    dist = np.sqrt(((pts[fi] - pts[fj]) ** 2).sum(-1))
    fw = 1.0 / (dist + 1e-6)

    # Extrude: node (f, iz) = f * nz + iz; horizontal edges per layer,
    # weak vertical edges between layers.
    i = (fi[:, None] * nz + np.arange(nz)[None, :]).reshape(-1)
    j = (fj[:, None] * nz + np.arange(nz)[None, :]).reshape(-1)
    w = np.repeat(fw, nz)
    vf = np.arange(nf)
    vi = (vf[:, None] * nz + np.arange(nz - 1)[None, :]).reshape(-1)
    i = np.concatenate([i, vi])
    j = np.concatenate([j, vi + 1])
    w = np.concatenate([w, np.full(vi.shape, eps_z)])
    return _graph_laplacian(nf * nz, i, j, w, shift, dtype, device)


def _graph_laplacian(n: int, i, j, w, shift: float, dtype,
                     device) -> SparseOp:
    """SPD operator  L + shift*mean(deg)*I  from undirected edges."""
    rows = np.concatenate([i, j, i, j])
    cols = np.concatenate([j, i, i, j])
    vals = np.concatenate([-w, -w, w, w])
    deg = np.zeros(n)
    np.add.at(deg, i, w)
    np.add.at(deg, j, w)
    c = shift * float(deg.mean())
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, np.full(n, c)])
    return sparse_from_coo(n, rows, cols, vals, dtype=dtype, device=device)
