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
gives the same bits every time on one card.

:func:`plan` is the kernel's launch plan (register tile, row and column
chunks, work items, persistent grid, which loads are 16-byte vectors).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_dots_ref as fused_dots_plain

BLOCK = 256          # threads of a block (csrc/fused_dots.cu)
KC_MAX = 8           # rows of a register tile
SB_SIZES = (1, 8)    # columns of a register tile
VEC_BYTES = 16       # one vector load
UNIFORM, VECS_VEC, STAGE_VECS = 1, 2, 4  # flag bits (csrc/fused_dots.cu)

_SIGS = {
    "fused_dots_launch": [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "fused_dots_occupancy": [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
}


@dataclasses.dataclass(frozen=True)
class DotsPlan:
    """One launch over (K, N) x (N, S).

    A block of row chunk y and column chunk z holds a ``kc`` x ``sb``
    register tile a thread; ``grid`` blocks per chunk walk ``items`` work
    items with a grid stride.  Item q covers elements
    ``heads[k] + (q - 1) * vec`` .. ``+ vec - 1`` of row k (those in
    [0, N)), read as one 16-byte vector when all are in range.  ``uniform``:
    every row has the same head, so one vecs read serves all rows;
    ``vecs_vec``: vecs is read in 16-byte vectors too; ``stage_vecs``
    (S = 8): a warp reads its items' vecs rows, one contiguous 4 KB block,
    in coalesced vectors through shared memory."""
    k: int
    n: int
    s: int
    kc: int
    sb: int
    gy: int
    gz: int
    vec: int
    heads: tuple
    uniform: bool
    vecs_vec: bool
    stage_vecs: bool
    items: int
    grid: int

    @property
    def flags(self) -> int:
        return (UNIFORM * self.uniform + VECS_VEC * self.vecs_vec
                + STAGE_VECS * self.stage_vecs)

    @property
    def partials(self) -> int:
        return self.k * self.s * self.grid


def head(offset: int, itemsize: int) -> int:
    """Elements from byte address ``offset`` to the next 16-byte boundary."""
    return (-offset % VEC_BYTES) // itemsize


def plan(k: int, n: int, s: int, itemsize: int, mat_offset: int,
         vecs_offset: int, sms: int, occupancy) -> DotsPlan:
    """The launch plan.  ``mat_offset``/``vecs_offset`` are the base
    addresses (only their residue mod 16 matters); ``occupancy(kc, sb,
    stage_vecs)`` gives the blocks of that kernel one SM holds, ``sms``
    the SMs, so all blocks run in one wave."""
    if itemsize not in (4, 8) or mat_offset % itemsize or \
            vecs_offset % itemsize:
        raise ValueError("mat and vecs must be fp32 or fp64 and aligned to "
                         "their element size")
    vec = VEC_BYTES // itemsize
    gy = -(-k // KC_MAX)
    kc = -(-k // gy)
    sb = next(b for b in SB_SIZES if b >= min(s, SB_SIZES[-1]))
    gz = -(-s // sb)
    heads = tuple(head(mat_offset + r * n * itemsize, itemsize)
                  for r in range(k))
    uniform = len(set(heads)) == 1
    if s == 1:   # vec read along N: aligned where the rows' vectors are
        vecs_vec = uniform and head(vecs_offset, itemsize) == heads[0]
    else:        # each vecs row read in whole vectors along S
        vecs_vec = (s % vec == 0 and sb % vec == 0
                    and vecs_offset % VEC_BYTES == 0)
    stage_vecs = s == SB_SIZES[-1] and uniform and \
        vecs_offset % VEC_BYTES == 0
    items = (n - 1) // vec + 2 if n > 0 else 0
    per_sm = max(1, int(occupancy(kc, sb, stage_vecs)))
    grid = max(1, min(-(-items // BLOCK), sms * per_sm // (gy * gz)))
    return DotsPlan(k, n, s, kc, sb, gy, gz, vec, heads, uniform, vecs_vec,
                    stage_vecs, items, grid)


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


_plans: dict = {}
_scratch: dict = {}


def _plan_for(lib, mat: torch.Tensor, vecs: torch.Tensor) -> DotsPlan:
    """The launch plan of this call, cached by what it depends on."""
    dev = mat.device
    k, n = mat.shape
    s = vecs.shape[1]
    key = (dev.index, k, n, s, mat.dtype, mat.data_ptr() % VEC_BYTES,
           vecs.data_ptr() % VEC_BYTES)
    p = _plans.get(key)
    if p is None:
        is_f32 = int(mat.dtype == torch.float32)

        def occupancy(kc: int, sb: int, stage: bool) -> int:
            out = ctypes.c_int(0)
            with torch.cuda.device(dev):
                _build.check(lib.fused_dots_occupancy(
                    is_f32, kc, sb, STAGE_VECS * stage, ctypes.byref(out)),
                    "fused_dots occupancy")
            return out.value

        p = _plans[key] = plan(
            k, n, s, mat.element_size(), mat.data_ptr(), vecs.data_ptr(),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            occupancy)
    return p


def _scratch_for(dev: torch.device, stream: int, partials: int):
    """(ticket, partials) buffers of a device and stream, reused by every
    launch on that stream (which runs them in order).  The ticket is the
    counter the kernel's last block is found by; it is 0 between launches
    because that block resets it."""
    key = (dev.index, stream)
    got = _scratch.get(key)
    if got is None or got[1].numel() < partials:
        got = _scratch[key] = (
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.empty(max(partials, 1 << 16), dtype=torch.float32,
                        device=dev))
    return got


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
    dev = mat.device
    lib = _build.load("fused_dots", _SIGS)
    p = _plan_for(lib, mat, vecs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ticket, part = _scratch_for(dev, stream, p.partials)
    with torch.cuda.device(dev):
        rc = lib.fused_dots_launch(
            int(mat.dtype == torch.float32), mat.data_ptr(), vecs.data_ptr(),
            part.data_ptr(), out.data_ptr(), ticket.data_ptr(), n, k, s,
            p.kc, p.sb, p.items, p.flags, p.grid, stream)
    _build.LAUNCHES["fused_dots"] += 1
    _build.check(rc, "fused_dots")
    return out


def fused_dots(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """All K inner products mat @ vec in one pass: the S = 1 case."""
    if vec.dim() != 1:
        raise ValueError(f"vec must be 1-D, got shape {tuple(vec.shape)}")
    return fused_dots_mrhs(mat, vec[:, None])[:, 0]
