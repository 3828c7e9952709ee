"""Fused dot-product block kernel (``csrc/fused_dots.cu``), the counterpart
of the Pallas kernels ``fused_dots_mrhs`` and ``fused_dots`` in
``repro/kernels/fused_dots.py``.

``fused_dots_mrhs(mat, vecs)`` computes (K, N) x (N, S) -> (K, S) and
``fused_dots(mat, vec)`` its S = 1 case (K,).  On CUDA tensors they launch
the kernel, on CPU tensors they run the plain PyTorch version
``fused_dots_plain``; any other device raises.  ``mat`` and ``vecs`` share
one dtype (fp32 or fp64); both are cast to fp32, products and sums are
fp32, and the result is cast back to ``mat``'s dtype, as in the Pallas
kernel.  The kernel's sums run in a fixed order (no atomics), so a call
gives the same bits every time.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_dots_ref as fused_dots_plain

BLOCK = 256          # threads of a pass-1 block (csrc/fused_dots.cu)
MAX_BLOCKS = 1024    # pass-1 blocks: min(ceil(N / BLOCK), MAX_BLOCKS)

_SIGS = {
    "fused_dots_launch": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p],
}


def _checked(mat: torch.Tensor, vecs: torch.Tensor) -> None:
    if mat.dim() != 2 or vecs.dim() != 2 or vecs.shape[0] != mat.shape[1]:
        raise ValueError(f"mat {tuple(mat.shape)} and vecs "
                         f"{tuple(vecs.shape)} must be (K, N) and (N, S)")
    if mat.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {mat.dtype} (want fp32 or fp64)")
    if vecs.dtype != mat.dtype:
        raise ValueError(f"vecs is {vecs.dtype}, mat {mat.dtype}")
    if vecs.device != mat.device:
        raise ValueError(f"vecs is on {vecs.device}, mat on {mat.device}")
    for name, t in (("mat", mat), ("vecs", vecs)):
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if mat.shape[0] * vecs.shape[1] >= 2 ** 31:
        raise ValueError("K * S too large for the kernel's int sizes")


def fused_dots_mrhs(mat: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """All K*S inner products mat @ vecs in one pass over ``mat``."""
    if mat.device.type == "cpu":
        return fused_dots_plain(mat, vecs)
    if mat.device.type != "cuda":
        raise ValueError(f"no fused_dots for device {mat.device}")
    _checked(mat, vecs)
    k, n = mat.shape
    s = vecs.shape[1]
    out = torch.empty((k, s), dtype=mat.dtype, device=mat.device)
    if n == 0 or out.numel() == 0:
        return out.zero_()
    nb = min(-(-n // BLOCK), MAX_BLOCKS)
    part = torch.empty(nb * k * s, dtype=torch.float32, device=mat.device)
    with torch.cuda.device(mat.device):
        rc = _build.load("fused_dots", _SIGS).fused_dots_launch(
            int(mat.dtype == torch.float32), mat.data_ptr(), vecs.data_ptr(),
            part.data_ptr(), out.data_ptr(), n, k, s, nb,
            torch.cuda.current_stream(mat.device).cuda_stream)
    _build.LAUNCHES["fused_dots"] += 1
    _build.check(rc, "fused_dots")
    return out


def fused_dots(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """All K inner products mat @ vec in one pass: the S = 1 case."""
    if vec.dim() != 1:
        raise ValueError(f"vec must be 1-D, got shape {tuple(vec.shape)}")
    return fused_dots_mrhs(mat, vec[:, None])[:, 0]
