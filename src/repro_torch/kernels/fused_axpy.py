"""Fused three-term recurrence kernel (``csrc/fused_axpy.cu``), the
counterpart of the Pallas kernel in ``repro/kernels/fused_axpy.py``.

``fused_axpy3(zk1, zm1, zm2, c1, c2, scale)`` launches the CUDA kernel on
CUDA tensors and runs the plain PyTorch version ``fused_axpy3_plain`` on
CPU tensors; any other device raises.  Inputs are 1-D, of one length and
one dtype (fp32 or fp64); the result has that dtype.  The arithmetic is
fp32 with each scalar rounded to fp32 first, as in the Pallas kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_axpy3_ref as fused_axpy3_plain

_SIGS = {
    "fused_axpy3_launch": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                           ctypes.c_float, ctypes.c_void_p],
}


def _checked(zk1, zm1, zm2):
    if zk1.dim() != 1:
        raise ValueError(f"expected 1-D vectors, got shape {tuple(zk1.shape)}")
    if zk1.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {zk1.dtype} (want fp32 or fp64)")
    for name, t in (("zm1", zm1), ("zm2", zm2)):
        if tuple(t.shape) != tuple(zk1.shape) or t.dtype != zk1.dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, zk1 "
                             f"{zk1.dtype} {tuple(zk1.shape)}")
        if t.device != zk1.device:
            raise ValueError(f"{name} is on {t.device}, zk1 on {zk1.device}")
    for name, t in (("zk1", zk1), ("zm1", zm1), ("zm2", zm2)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def fused_axpy3(zk1: torch.Tensor, zm1: torch.Tensor, zm2: torch.Tensor,
                c1, c2, scale) -> torch.Tensor:
    """((zk1 + c1*zm1) + c2*zm2) * scale in one pass.  The scalars are
    host numbers (a 0-d device tensor is read to the host)."""
    if zk1.device.type == "cpu":
        return fused_axpy3_plain(zk1, zm1, zm2, c1, c2, scale)
    if zk1.device.type != "cuda":
        raise ValueError(f"no fused_axpy3 for device {zk1.device}")
    _checked(zk1, zm1, zm2)
    c1, c2, scale = (float(np.float32(float(c))) for c in (c1, c2, scale))
    out = torch.empty_like(zk1)
    with torch.cuda.device(zk1.device):
        rc = _build.load("fused_axpy", _SIGS).fused_axpy3_launch(
            int(zk1.dtype == torch.float32), zk1.data_ptr(), zm1.data_ptr(),
            zm2.data_ptr(), out.data_ptr(), zk1.numel(), c1, c2, scale,
            torch.cuda.current_stream(zk1.device).cuda_stream)
    _build.LAUNCHES["fused_axpy3"] += 1
    _build.check(rc, "fused_axpy3")
    return out
