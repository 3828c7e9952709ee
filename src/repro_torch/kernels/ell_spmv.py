"""Standalone padded-row ELL SpMV kernel (``csrc/ell_spmv.cu``), the
counterpart of the Pallas kernel in ``repro/kernels/ell_spmv.py``.

``ell_spmv(x, cols, vals)`` launches the CUDA kernel on CUDA tensors
(``vals`` fp64 or fp32, ``cols`` int32, both (R, W); ``x`` at least R
long) and runs the plain PyTorch version ``ell_spmv_plain`` on CPU
tensors.  Any other device raises.  The result has ``vals``' dtype; ``x``
is cast to it first, as the plain version does.

``x`` may be an (s, n) slab of s vectors, one a request (the JAX package
vmaps its kernel over the slab): one launch reads each tile of cols and
vals once for all s vectors and returns (s, R), each row bitwise the
single-vector result.  A launch counts under ``ell_spmv`` for one vector
and ``ell_spmv_slab`` for a slab.

The kernel stages tiles of rows through shared memory; :func:`plan` is its
launch plan (tile rows, ring stages, which tiles go by bulk copy, grid),
chosen from the operator alone.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ell_spmv_ref as ell_spmv_plain

TILE_ROWS = (256, 128, 64, 32)  # rows a tile (threads a block), in order
STAGES = 2                      # ring buffers a block
STAGE_BUDGET = 110 * 1024       # staged bytes a block: two blocks an SM
BULK_ALIGN = 16                 # the bulk copy's address and size unit
DIRECT_BLOCK = 256              # threads a block of the direct kernel

_SIGS = {
    "ell_spmv_launch": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_void_p],
    "ell_spmv_occupancy": [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_int)],
}


@dataclasses.dataclass(frozen=True)
class EllPlan:
    """How one launch covers an (R, W) operator.

    ``staged``: tiles of ``tile_rows`` rows, tile t = b, b + grid, ... for
    block b, held in a ring of ``stages`` shared buffers of ``smem_bytes``
    in all; tiles ``0 .. bulk_tiles - 1`` arrive by bulk copy, the rest by
    ordinary loads.  Otherwise the direct kernel runs one thread a row from
    device memory on blocks of ``tile_rows`` threads."""
    staged: bool
    rows: int
    w: int
    tile_rows: int
    stages: int
    tiles: int
    bulk_tiles: int
    grid: int
    smem_bytes: int


def plan(rows: int, w: int, itemsize: int, cols_offset: int,
         vals_offset: int, sms: int, occupancy) -> EllPlan:
    """The launch plan for ``rows`` x ``w`` slots of ``itemsize``-byte
    values.  ``cols_offset`` and ``vals_offset`` are the base addresses
    (only their residue mod 16 matters); ``occupancy(threads, smem_bytes)``
    gives the blocks one SM holds, and ``sms`` the SMs, so the grid is one
    wave.  Full tiles of an operator whose bases are both 16-byte aligned
    go by bulk copy; the ragged last tile, and every tile of a misaligned
    operator, by ordinary loads; an operator too wide for two stages of 32
    rows in ``STAGE_BUDGET`` runs the direct kernel."""
    slot_bytes = w * (itemsize + 4)
    tile_rows = next((rb for rb in TILE_ROWS
                      if STAGES * rb * slot_bytes <= STAGE_BUDGET), None)
    if tile_rows is None:
        blocks = max(1, -(-rows // DIRECT_BLOCK))
        return EllPlan(False, rows, w, DIRECT_BLOCK, 0, blocks, 0, blocks, 0)
    tiles = -(-rows // tile_rows)
    smem = STAGES * tile_rows * slot_bytes
    aligned = (cols_offset % BULK_ALIGN == 0 and vals_offset % BULK_ALIGN == 0)
    # tile_rows is a multiple of 32, so a full tile's spans (tile_rows * w
    # elements of 4 or 8 bytes) start and end on 16-byte boundaries.
    bulk = rows // tile_rows if aligned else 0
    grid = max(1, min(tiles, sms * max(1, int(occupancy(tile_rows, smem)))))
    return EllPlan(True, rows, w, tile_rows, STAGES, tiles, bulk, grid, smem)


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
    if x.dim() not in (1, 2) or x.shape[-1] < cols.shape[0] \
            or x.dim() == 2 and x.shape[0] < 1:
        raise ValueError(f"x of shape {tuple(x.shape)} is not a vector or a "
                         f"slab of vectors at least {cols.shape[0]} long")
    for name, t in (("x", x), ("cols", cols), ("vals", vals)):
        if t.device != cols.device:
            raise ValueError(f"{name} is on {t.device}, cols on {cols.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    if cols.numel() >= 2 ** 31 or x.shape[-1] >= 2 ** 31:
        raise ValueError("operator too large for the kernel's int32 columns")


_plans: dict = {}


def _plan_for(lib, cols: torch.Tensor, vals: torch.Tensor) -> EllPlan:
    """The launch plan of this call, cached by what it depends on."""
    dev = vals.device
    rows, w = cols.shape
    key = (dev.index, rows, w, vals.dtype, cols.data_ptr() % BULK_ALIGN,
           vals.data_ptr() % BULK_ALIGN)
    p = _plans.get(key)
    if p is None:
        is_f32 = int(vals.dtype == torch.float32)

        def occupancy(threads: int, smem: int) -> int:
            out = ctypes.c_int(0)
            with torch.cuda.device(dev):
                _build.check(lib.ell_spmv_occupancy(is_f32, threads, smem,
                                                    ctypes.byref(out)),
                             "ell_spmv occupancy")
            return out.value

        p = _plans[key] = plan(
            rows, w, vals.element_size(), cols.data_ptr(), vals.data_ptr(),
            torch.cuda.get_device_properties(dev).multi_processor_count,
            occupancy)
    return p


def ell_spmv(x: torch.Tensor, cols: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """y[r] = sum_s vals[r, s] * x[cols[r, s]], slots summed left to right;
    for an (s, n) slab ``x``, the same for each row of it, (s, R)."""
    if cols.device.type == "cpu":
        return ell_spmv_plain(x, cols, vals)
    if cols.device.type != "cuda":
        raise ValueError(f"no ell_spmv for device {cols.device}")
    x = x.to(vals.dtype).contiguous()
    _checked(x, cols, vals)
    lib = _build.load("ell_spmv", _SIGS)
    return _launch(lib, _plan_for(lib, cols, vals), x, cols, vals)


def _launch(lib, p: EllPlan, x: torch.Tensor, cols: torch.Tensor,
            vals: torch.Tensor) -> torch.Tensor:
    """One launch of plan ``p`` on checked CUDA tensors (``x`` a vector or
    an (s, n) slab)."""
    dev = vals.device
    out = torch.empty(x.shape[:-1] + (p.rows,), dtype=vals.dtype, device=dev)
    s = x.shape[0] if x.dim() == 2 else 1
    with torch.cuda.device(dev):
        rc = lib.ell_spmv_launch(
            int(vals.dtype == torch.float32), int(p.staged),
            x.data_ptr(), cols.data_ptr(), vals.data_ptr(), out.data_ptr(),
            p.rows, p.w, p.tile_rows, p.stages, p.bulk_tiles, p.grid,
            p.smem_bytes, s, x.shape[-1],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.LAUNCHES["ell_spmv" if x.dim() == 1 else "ell_spmv_slab"] += 1
    _build.check(rc, "ell_spmv")
    return out
