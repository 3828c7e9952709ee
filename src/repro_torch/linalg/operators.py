"""SPD linear operators used by the CG solvers (counterpart of
``repro/linalg/operators.py``).

All operators act on flat vectors of length ``n``, or on an (s, n) slab
of them, one vector a row: the port's batched layout, the transpose of
the JAX package's (n, s) ``B`` (the JAX operators see one column at a
time under ``vmap``).  A slab row's result is bitwise that of the same
vector applied alone, on the plain path and through the kernels' slab
forms alike (``DenseSPD``, a test helper, excepted).  Each ``apply`` keeps
the exact term order of the JAX package's expression
(``repro/kernels/ops.py:53-94``), which the superkernel mirrors.  The
stencil operators optionally route their apply through the standalone
CUDA stencil kernels (``use_kernel=True``).

Constructors take ``device``: ``None`` means ``cuda``, which raises where
there is no card; tensors an operator builds (its diagonal, a
``DiagonalOp``'s entries) live there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import as_tensor, resolve_device
from repro_torch.kernels import ref


class LinearOperator:
    """SPD operator interface consumed by the solvers."""

    n: int
    device: torch.device

    def apply(self, x: torch.Tensor) -> torch.Tensor:  # A @ x
        raise NotImplementedError

    def diag(self) -> torch.Tensor:  # diagonal of A
        raise NotImplementedError

    def to_dense(self) -> np.ndarray:  # small problems only (tests)
        eye = torch.eye(self.n, dtype=torch.float64, device=self.device)
        cols = [self.apply(eye[:, j]).cpu().numpy() for j in range(self.n)]
        return np.stack(cols, axis=1)

    def eig_bounds(self) -> tuple[float, float]:
        raise NotImplementedError

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)


def _resolve(obj) -> None:
    object.__setattr__(obj, "device", resolve_device(obj.device))


@dataclasses.dataclass(frozen=True)
class DiagonalOp(LinearOperator):
    """A = diag(d), the paper's "one-point stencil" toy."""

    d: torch.Tensor
    device: torch.device | str | None = None

    def __post_init__(self):
        if self.device is None and isinstance(self.d, torch.Tensor):
            object.__setattr__(self, "device", self.d.device)
        _resolve(self)
        object.__setattr__(self, "d", as_tensor(self.d, self.device))

    @property
    def n(self) -> int:  # type: ignore[override]
        return int(self.d.shape[0])

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.d.to(x.dtype) * x

    def diag(self) -> torch.Tensor:
        return self.d

    def eig_bounds(self) -> tuple[float, float]:
        return float(self.d.min()), float(self.d.max())


def laplacian_2d_spectrum(nx: int, ny: int, dtype=torch.float64,
                          device=None) -> torch.Tensor:
    """Eigenvalues of the unscaled 2D 5-point Laplacian (Dirichlet), flat,
    length nx*ny:  4 - 2cos(i pi/(nx+1)) - 2cos(j pi/(ny+1))."""
    dev = resolve_device(device)
    i = torch.arange(1, nx + 1, dtype=dtype, device=dev)
    j = torch.arange(1, ny + 1, dtype=dtype, device=dev)
    li = 2.0 - 2.0 * torch.cos(i * np.pi / (nx + 1))
    lj = 2.0 - 2.0 * torch.cos(j * np.pi / (ny + 1))
    return (li[:, None] + lj[None, :]).reshape(-1)


@dataclasses.dataclass(frozen=True)
class Stencil2D5(LinearOperator):
    """Unscaled 2D 5-point Laplacian with homogeneous Dirichlet BCs on an
    nx-by-ny grid (row-major, x outer / y inner):  (A x)_{ij} =
    4 x_{ij} - x_{i±1,j} - x_{i,j±1}.  PETSc KSP ex2's matrix."""

    nx: int
    ny: int
    use_kernel: bool = False
    device: torch.device | str | None = None

    def __post_init__(self):
        _resolve(self)

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.nx * self.ny

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(x.shape[:-1] + (self.nx, self.ny))
        if self.use_kernel:
            from repro_torch.kernels import ops as kops

            return kops.stencil2d5_apply(g).reshape(x.shape)
        return ref.stencil2d5_ref(g).reshape(x.shape)

    def diag(self) -> torch.Tensor:
        return torch.full((self.n,), 4.0, dtype=torch.float64,
                          device=self.device)

    def eig_bounds(self) -> tuple[float, float]:
        lmin = (2 - 2 * np.cos(np.pi / (self.nx + 1))) + (
            2 - 2 * np.cos(np.pi / (self.ny + 1)))
        lmax = (2 - 2 * np.cos(self.nx * np.pi / (self.nx + 1))) + (
            2 - 2 * np.cos(self.ny * np.pi / (self.ny + 1)))
        return float(lmin), float(lmax)


@dataclasses.dataclass(frozen=True)
class Stencil3D7(LinearOperator):
    """Anisotropic 3D 7-point Laplacian, Dirichlet BCs, nx×ny×nz grid:
    (A x) = 2(1+1+eps_z) x - x_{i±1} - x_{j±1} - eps_z x_{k±1}."""

    nx: int
    ny: int
    nz: int
    eps_z: float = 1.0
    use_kernel: bool = False
    device: torch.device | str | None = None

    def __post_init__(self):
        _resolve(self)

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.nx * self.ny * self.nz

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(x.shape[:-1] + (self.nx, self.ny, self.nz))
        if self.use_kernel:
            from repro_torch.kernels import ops as kops

            return kops.stencil3d7_apply(g, self.eps_z).reshape(x.shape)
        return ref.stencil3d7_ref(g, self.eps_z).reshape(x.shape)

    def diag(self) -> torch.Tensor:
        return torch.full((self.n,), 4.0 + 2.0 * self.eps_z,
                          dtype=torch.float64, device=self.device)

    def eig_bounds(self) -> tuple[float, float]:
        def b(n):
            return (2 - 2 * np.cos(np.pi / (n + 1)),
                    2 - 2 * np.cos(n * np.pi / (n + 1)))

        (ax, bx), (ay, by), (az, bz) = b(self.nx), b(self.ny), b(self.nz)
        return (float(ax + ay + self.eps_z * az),
                float(bx + by + self.eps_z * bz))


@dataclasses.dataclass(frozen=True)
class Stencil3D27(LinearOperator):
    """3D 27-point stencil: centre weight ``c``, face -1, edge -1/2,
    corner -1/4, kept diagonally dominant (SPD).  Its only kernel form is
    the superkernel's SPMV; ``use_kernel`` is refused by the fused path
    as in the JAX package."""

    nx: int
    ny: int
    nz: int
    centre: float = 13.0
    use_kernel: bool = False
    device: torch.device | str | None = None

    def __post_init__(self):
        if self.centre <= 14.0:
            object.__setattr__(self, "centre", 14.5)
        _resolve(self)

    @property
    def n(self) -> int:  # type: ignore[override]
        return self.nx * self.ny * self.nz

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        g = x.reshape(x.shape[:-1] + (self.nx, self.ny, self.nz))
        return ref.stencil3d27_ref(g, self.centre).reshape(x.shape)

    def diag(self) -> torch.Tensor:
        return torch.full((self.n,), self.centre, dtype=torch.float64,
                          device=self.device)

    def eig_bounds(self) -> tuple[float, float]:
        # Gershgorin: centre ± 14.
        return float(self.centre - 14.0), float(self.centre + 14.0)


@dataclasses.dataclass(frozen=True)
class DenseSPD(LinearOperator):
    """Explicit dense SPD matrix (tests)."""

    a: torch.Tensor
    device: torch.device | str | None = None

    def __post_init__(self):
        if self.device is None and isinstance(self.a, torch.Tensor):
            object.__setattr__(self, "device", self.a.device)
        _resolve(self)
        object.__setattr__(self, "a", as_tensor(self.a, self.device))

    @property
    def n(self) -> int:  # type: ignore[override]
        return int(self.a.shape[0])

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.a @ x if x.dim() == 1 else x @ self.a.T

    def diag(self) -> torch.Tensor:
        return torch.diagonal(self.a)

    def to_dense(self) -> np.ndarray:
        return self.a.cpu().numpy().astype(np.float64)

    def eig_bounds(self) -> tuple[float, float]:
        w = np.linalg.eigvalsh(self.to_dense())
        return float(w[0]), float(w[-1])
