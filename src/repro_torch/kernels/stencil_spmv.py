"""Standalone stencil SPMV kernels (``csrc/stencil_spmv.cu``), the
counterparts of the Pallas kernels in ``repro/kernels/stencil_spmv.py``.

``stencil2d5(g)`` and ``stencil3d7(g, eps_z)`` launch the CUDA kernel on
a CUDA tensor (fp64 or fp32) and run the plain PyTorch version,
``stencil2d5_plain`` / ``stencil3d7_plain``, on a CPU tensor.  Any other
device raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import stencil2d5_ref as stencil2d5_plain
from repro_torch.kernels.ref import stencil3d7_ref as stencil3d7_plain

_SIGS = {
    "stencil2d5_launch": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "stencil3d7_launch": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_double, ctypes.c_void_p],
}


def _checked(g: torch.Tensor, ndim: int) -> None:
    if g.dim() != ndim:
        raise ValueError(f"expected a {ndim}-D grid, got shape {tuple(g.shape)}")
    if g.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"unsupported dtype {g.dtype} (want fp64 or fp32)")
    if not g.is_contiguous():
        raise ValueError("grid tensor is not contiguous")
    if g.numel() >= 2 ** 31:
        raise ValueError("grid too large for the kernel's int sizes")


def _lib():
    return _build.load("stencil_spmv", _SIGS)


def stencil2d5(g: torch.Tensor) -> torch.Tensor:
    """5-point Dirichlet Laplacian of an (nx, ny) grid."""
    if g.device.type == "cpu":
        return stencil2d5_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"no stencil2d5 for device {g.device}")
    _checked(g, 2)
    out = torch.empty_like(g)
    nx, ny = g.shape
    with torch.cuda.device(g.device):
        rc = _lib().stencil2d5_launch(
            int(g.dtype == torch.float32), g.data_ptr(), out.data_ptr(),
            nx, ny, torch.cuda.current_stream(g.device).cuda_stream)
    _build.LAUNCHES["stencil2d5"] += 1
    _build.check(rc, "stencil2d5")
    return out


def stencil3d7(g: torch.Tensor, eps_z: float = 1.0) -> torch.Tensor:
    """Anisotropic 7-point Dirichlet Laplacian of an (nx, ny, nz) grid."""
    if g.device.type == "cpu":
        return stencil3d7_plain(g, eps_z)
    if g.device.type != "cuda":
        raise ValueError(f"no stencil3d7 for device {g.device}")
    _checked(g, 3)
    out = torch.empty_like(g)
    nx, ny, nz = g.shape
    with torch.cuda.device(g.device):
        rc = _lib().stencil3d7_launch(
            int(g.dtype == torch.float32), g.data_ptr(), out.data_ptr(),
            nx, ny, nz, float(eps_z),
            torch.cuda.current_stream(g.device).cuda_stream)
    _build.LAUNCHES["stencil3d7"] += 1
    _build.check(rc, "stencil3d7")
    return out
