"""Standalone padded-row ELL SpMV kernel (``csrc/ell_spmv.cu``), the
counterpart of the Pallas kernel in ``repro/kernels/ell_spmv.py``.

``ell_spmv(x, cols, vals)`` launches the CUDA kernel on CUDA tensors
(``vals`` fp64 or fp32, ``cols`` int32, both (R, W); ``x`` at least R
long) and runs the plain PyTorch version ``ell_spmv_plain`` on CPU
tensors.  Any other device raises.  The result has ``vals``' dtype; ``x``
is cast to it first, as the plain version does.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ell_spmv_ref as ell_spmv_plain

_SIGS = {
    "ell_spmv_launch": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_void_p],
}


def _checked(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor):
    if cols.dim() != 2 or tuple(vals.shape) != tuple(cols.shape):
        raise ValueError(f"cols {tuple(cols.shape)} and vals "
                         f"{tuple(vals.shape)} must be one (R, W)")
    if cols.shape[1] < 1:
        raise ValueError("an ELL operator needs at least one slot per row")
    if cols.dtype != torch.int32:
        raise ValueError(f"cols has dtype {cols.dtype}, expected int32")
    if vals.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"unsupported dtype {vals.dtype} (want fp64 or fp32)")
    if x.dim() != 1 or x.shape[0] < cols.shape[0]:
        raise ValueError(f"x of shape {tuple(x.shape)} is shorter than the "
                         f"{cols.shape[0]} rows")
    for name, t in (("x", x), ("cols", cols), ("vals", vals)):
        if t.device != cols.device:
            raise ValueError(f"{name} is on {t.device}, cols on {cols.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if cols.numel() >= 2 ** 31 or x.numel() >= 2 ** 31:
        raise ValueError("operator too large for the kernel's int32 columns")


def ell_spmv(x: torch.Tensor, cols: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_s vals[r, s] * x[cols[r, s]], slots summed left to right."""
    if cols.device.type == "cpu":
        return ell_spmv_plain(x, cols, vals)
    if cols.device.type != "cuda":
        raise ValueError(f"no ell_spmv for device {cols.device}")
    x = x.to(vals.dtype).contiguous()
    _checked(x, cols, vals)
    rows, w = cols.shape
    out = torch.empty(rows, dtype=vals.dtype, device=vals.device)
    with torch.cuda.device(vals.device):
        rc = _build.load("ell_spmv", _SIGS).ell_spmv_launch(
            int(vals.dtype == torch.float32), x.data_ptr(), cols.data_ptr(),
            vals.data_ptr(), out.data_ptr(), rows, w,
            torch.cuda.current_stream(vals.device).cuda_stream)
    _build.LAUNCHES["ell_spmv"] += 1
    _build.check(rc, "ell_spmv")
    return out
