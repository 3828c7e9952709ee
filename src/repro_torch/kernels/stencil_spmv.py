"""Standalone stencil SPMV kernels (``csrc/stencil_spmv.cu``), the
counterparts of the Pallas kernels in ``repro/kernels/stencil_spmv.py``.

``stencil2d5(g)`` and ``stencil3d7(g, eps_z)`` launch the CUDA kernel on
a CUDA tensor (fp64 or fp32) and run the plain PyTorch version,
``stencil2d5_plain`` / ``stencil3d7_plain``, on a CPU tensor.  Any other
device raises.

Each takes one grid, (nx, ny) or (nx, ny, nz), or a slab of s grids,
(s, nx, ny) or (s, nx, ny, nz), one grid a request: the slab form is one
launch for all s grids (the JAX package vmaps the Pallas kernel over the
slab), each grid's result bitwise the single-grid one.  A launch adds one
to ``_build.LAUNCHES`` under ``stencil2d5`` / ``stencil3d7`` for one grid
and ``stencil2d5_slab`` / ``stencil3d7_slab`` for a slab.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import stencil2d5_ref as stencil2d5_plain
from repro_torch.kernels.ref import stencil3d7_ref as stencil3d7_plain

_SIGS = {
    "stencil2d5_launch": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p],
    "stencil3d7_launch": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_double, ctypes.c_void_p],
}
MAX_SLAB = 65535      # grids in one launch (the second grid dimension)


def _checked(g: torch.Tensor, ndim: int) -> int:
    """Check a grid of ``ndim`` dimensions or a slab of them; returns the
    number of grids."""
    if g.dim() not in (ndim, ndim + 1):
        raise ValueError(f"expected a {ndim}-D grid or a slab of them, got "
                         f"shape {tuple(g.shape)}")
    if g.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"unsupported dtype {g.dtype} (want fp64 or fp32)")
    if not g.is_contiguous():
        raise ValueError("grid tensor is not contiguous")
    s = g.shape[0] if g.dim() == ndim + 1 else 1
    if not 1 <= s <= MAX_SLAB:
        raise ValueError(f"a slab of {s} grids (want 1 to {MAX_SLAB})")
    if g.numel() // s >= 2 ** 31:
        raise ValueError("grid too large for the kernel's int sizes")
    return s


def _lib():
    return _build.load("stencil_spmv", _SIGS)


def stencil2d5(g: torch.Tensor) -> torch.Tensor:
    """5-point Dirichlet Laplacian of an (nx, ny) grid or (s, nx, ny)
    slab."""
    if g.device.type == "cpu":
        return stencil2d5_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"no stencil2d5 for device {g.device}")
    s = _checked(g, 2)
    out = torch.empty_like(g)
    nx, ny = g.shape[-2:]
    with torch.cuda.device(g.device):
        rc = _lib().stencil2d5_launch(
            int(g.dtype == torch.float32), g.data_ptr(), out.data_ptr(),
            s, nx, ny, torch.cuda.current_stream(g.device).cuda_stream)
    _build.LAUNCHES["stencil2d5" if g.dim() == 2 else "stencil2d5_slab"] += 1
    _build.check(rc, "stencil2d5")
    return out


def stencil3d7(g: torch.Tensor, eps_z: float = 1.0) -> torch.Tensor:
    """Anisotropic 7-point Dirichlet Laplacian of an (nx, ny, nz) grid or
    (s, nx, ny, nz) slab."""
    if g.device.type == "cpu":
        return stencil3d7_plain(g, eps_z)
    if g.device.type != "cuda":
        raise ValueError(f"no stencil3d7 for device {g.device}")
    s = _checked(g, 3)
    out = torch.empty_like(g)
    nx, ny, nz = g.shape[-3:]
    with torch.cuda.device(g.device):
        rc = _lib().stencil3d7_launch(
            int(g.dtype == torch.float32), g.data_ptr(), out.data_ptr(),
            s, nx, ny, nz, float(eps_z),
            torch.cuda.current_stream(g.device).cuda_stream)
    _build.LAUNCHES["stencil3d7" if g.dim() == 3 else "stencil3d7_slab"] += 1
    _build.check(rc, "stencil3d7")
    return out
