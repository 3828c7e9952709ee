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

``SlicedEllOp`` and ``sliced_ell_reorder`` are not ported yet (ROADMAP.md,
queue 1 item 4b).
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
           "random_fem_mesh", "random_fem_icesheet"]


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
