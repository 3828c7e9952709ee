"""Fused-iteration superkernel: the whole p(l)-CG vector phase in one pass
over the (NV, N) state slab, written in CUDA C++ for Hopper
(``csrc/fused_iter.cuh``).

Counterpart of ``repro/kernels/fused_iter.py``.  The positional layouts
(``SlabLayout``, ``idx_layout``, ``scal_layout``, ``tel_layout``) are
copied verbatim, so one ``(S, idx, scal)`` triple feeds both packages.

``build_fused_iteration`` returns ``fiter(S, idx, scal) -> (S', partials)``.
On a CUDA slab it launches the superkernel, which updates ``S`` in place
(``S'`` is ``S``); on a CPU slab it runs the plain version
``ref.fused_iter_ref``.  Any other device raises.  A launch adds one to
``_build.LAUNCHES`` under ``launch_key(kind, l)``: ``fused_iter`` for the
single-device stencils and diagonal, ``fused_iter_ell`` for the ELL
plug-in, ``fused_iter_halo`` and ``fused_iter_ell_halo`` for the
halo-extended plug-ins of a shard, and ``fused_iter_runtime_l`` for any
plug-in at a depth l > ``LMAX`` (the runtime-depth kernel).

The same ``fiter`` takes the SLAB form of a batched solve (the JAX
package vmaps its superkernel over the slab): ``S`` (s, NV, N), ``idx``
(s, IX) and ``scal`` (s, IS), one row a column, each column at its own
cycle index, returning (s, 2l+1) partials from ONE launch whose second
grid dimension runs over the columns.  Each column's rows and partials are
bitwise those of a single-column launch on that column.  Its plain
version is ``ref.fused_iter_ref_slab`` (the single-column plain version
applied to each column), and a launch counts under
``launch_key(kind, l, slab=True)`` (the single-column key + ``_slab``).
Single-device plug-ins only: batched solves over ranks are not ported.

Plug-ins come in two forms, as in the JAX package: single-device (the
operand is the ring-top row itself) and halo-extended (a shard of a row
partition: ``prepare(z_top)`` builds the extended operand outside the
kernel, and the plug-in's expression reads it).

The single-device ELL plug-in at l <= ``LMAX`` runs the staged ELL kernel
when :func:`ell_tile_plan` stages it: one block a 256-row tile, its cols
and vals copied to shared memory once and read there by every column of
the slab in turn.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (ell_rowsum, fused_iter_ref,
                                     fused_iter_ref_slab)


# ---------------------------------------------------------------- layout --

@dataclasses.dataclass(frozen=True)
class SlabLayout:
    """Row map of the contiguous p(l)-CG state slab (NV, N).

    Rows 0 .. (l+1)*RB-1 hold the l+1 auxiliary-basis ring buffers
    (basis k, ring slot j -> row k*RB + j), followed by the 3-deep u
    ring, the search direction p and the iterate x.

    ``recurrence`` selects the top-basis update of the vector phase:
    ``"ghysels"`` recurs z^(l) through its own three-term recurrence (the
    paper's Alg. 1 line 22); ``"stable"`` recurs u first and recomputes
    z^(l)_{i+1} = M^{-1} u_{i+1} from it (arXiv:1902.03100).
    """

    l: int
    RB: int
    recurrence: str = "ghysels"

    @property
    def u_off(self) -> int:
        return (self.l + 1) * self.RB

    @property
    def p_row(self) -> int:
        return self.u_off + 3

    @property
    def x_row(self) -> int:
        return self.u_off + 4

    @property
    def nv(self) -> int:
        return self.u_off + 5

    def zk_row(self, k: int, j: int) -> int:
        """Slab row of basis k's ring slot for iterate index j."""
        return k * self.RB + j % self.RB

    def u_row(self, j: int) -> int:
        return self.u_off + j % 3


# Index-vector layout (all entries are PRE-MODDED slab rows except the
# trailing flags).  Consumed positionally by the kernel, so both sides
# share these offsets.
def idx_layout(l: int) -> dict[str, int]:
    return {
        "fill": 0,            # l entries : write rows zk(k, i+1)
        "rec_w": l,           # l entries : write rows zk(k, i-l+k+1)
        "rec_a": 2 * l,       # l entries : read  rows zk(k+1, i-l+k+1)
        "rec_b": 3 * l,       # l entries : read  rows zk(k, i-l+k)
        "rec_c": 4 * l,       # l entries : read  rows zk(k, i-l+k-1)
        "z_top": 5 * l,       # zk(l, i)
        "zl_im1": 5 * l + 1,  # zk(l, i-1)
        "z_w": 5 * l + 2,     # zk(l, i+1)   (write)
        "u_i": 5 * l + 3,     # u(i)
        "u_im1": 5 * l + 4,   # u(i-1)
        "u_w": 5 * l + 5,     # u(i+1)       (write)
        "p_im": 5 * l + 6,    # zk(0, i-l)
        "mat_v": 5 * l + 7,   # l entries : dot rows zk(0, i-2l+1+t), t<l
        "mat_z": 6 * l + 7,   # l-1 entries: dot rows zk(l, i-l+2+t), t<l-1
        "f_fill": 7 * l + 6,  # l flags    : pipeline-fill copy masks
        "f_late": 8 * l + 6,  # i >= l
        "f_first": 8 * l + 7,  # i == l
        "f_upd": 8 * l + 8,   # i >= l+1
        "size": 8 * l + 9,
    }


# Scalar-vector layout (solver dtype).
def scal_layout(l: int) -> dict[str, int]:
    return {
        "sig_i": 0,
        "gam_new": 1,
        "d2": 2,
        "dlt_safe": 3,
        "zet_prev": 4,
        "d_prev": 5,
        "eta_new_safe": 6,
        "eta0_safe": 7,
        "c1": 8,              # l entries : sig[k] - gam_new
        "size": 8 + l,
    }


# Telemetry-row layout (solver dtype).  One row of the (cap, K) telemetry
# ring per iteration, every entry a scalar the iteration already computed:
# written by ``core.pipelined_cg`` (``telemetry_cap > 0``), decoded by
# ``core.types.TelemetrySlab`` and ``obs.timeline``; the same positional
# contract as ``idx_layout``/``scal_layout``.
def tel_layout(l: int) -> dict[str, int]:
    return {
        "iter": 0,         # global iteration counter (tot) of this row
        "upd": 1,          # solution updates after this iteration
        "rnorm": 2,        # recursive residual M-norm |zeta| (-1: none)
        "age": 3,          # in-flight reduction handles after this iter
        "breakdown": 4,    # square-root breakdown flag (line 11)
        "restart": 5,      # 1.0 on a restart boundary row
        "replacement": 6,  # 1.0 when the restart was a due residual
                           # replacement (not a breakdown)
        "gap": 7,          # governor's attainable-accuracy gap estimate
        "action": 8,       # governor action on this row: 0 none,
                           # 1 gap-arm replacement, 2 patience-arm
                           # replacement, 3 stagnation declared
        "dots": 9,         # 2l+1 entries: the arrived dot block consumed
                           # this iteration (zeros during pipeline fill)
        "size": 9 + (2 * l + 1),
    }


def host_idx(layout: SlabLayout, i: int) -> list[int]:
    """The ``idx_layout`` vector of cycle iteration ``i``, built on the
    host (the expressions of ``repro.core.pipelined_cg``'s iteration)."""
    l = layout.l
    IX = idx_layout(l)
    zk_row, u_row = layout.zk_row, layout.u_row
    idx = [0] * IX["size"]
    for k in range(l):
        idx[IX["fill"] + k] = zk_row(k, i + 1)
        idx[IX["rec_w"] + k] = zk_row(k, i - l + k + 1)
        idx[IX["rec_a"] + k] = zk_row(k + 1, i - l + k + 1)
        idx[IX["rec_b"] + k] = zk_row(k, i - l + k)
        idx[IX["rec_c"] + k] = zk_row(k, i - l + k - 1)
        idx[IX["f_fill"] + k] = int(i < l - 1 and k >= i + 1)
        idx[IX["mat_v"] + k] = zk_row(0, i - 2 * l + 1 + k)
    for t in range(l - 1):
        idx[IX["mat_z"] + t] = zk_row(l, i - l + 2 + t)
    idx[IX["z_top"]] = zk_row(l, i)
    idx[IX["zl_im1"]] = zk_row(l, i - 1)
    idx[IX["z_w"]] = zk_row(l, i + 1)
    idx[IX["u_i"]] = u_row(i)
    idx[IX["u_im1"]] = u_row(i - 1)
    idx[IX["u_w"]] = u_row(i + 1)
    idx[IX["p_im"]] = zk_row(0, i - l)
    idx[IX["f_late"]] = int(i >= l)
    idx[IX["f_first"]] = int(i == l)
    idx[IX["f_upd"]] = int(i >= l + 1)
    return idx


def written_rows(layout: SlabLayout, idx) -> set[int]:
    """Slab rows one vector phase writes for the index vector ``idx``."""
    IX = idx_layout(layout.l)
    rows = {idx[IX["fill"] + k] for k in range(layout.l)}
    rows |= {idx[IX["rec_w"] + k] for k in range(layout.l)}
    return rows | {idx[IX["z_w"]], idx[IX["u_w"]], layout.x_row,
                   layout.p_row}


def check_z_top_not_written(layout: SlabLayout) -> None:
    """The superkernel reads the ring-top row at other blocks' columns
    from a copy taken before the launch (the staged ELL kernel from the
    row itself); either holds the row's values for the whole launch only
    if no write targets it.  Verified here for every
    cycle iteration index (the index vector is periodic in i past 2l)."""
    period = 3 * layout.RB
    for i in range(2 * layout.l + 2 * period):
        idx = host_idx(layout, i)
        if idx[idx_layout(layout.l)["z_top"]] in written_rows(layout, idx):
            raise AssertionError(f"z_top row is written at i={i}: {layout}")


# ------------------------------------------------------------ SPMV plug-ins --

SPMV_KINDS = ("stencil2d5", "stencil3d7", "stencil3d27", "diagonal", "ell")
HALO_KINDS = ("stencil2d5_halo", "stencil3d7_halo", "ell_halo")


@dataclasses.dataclass(frozen=True)
class FusedSpmv:
    """Operator plug-in for the superkernel.

    ``kind`` selects the kernel's SPMV template; ``dims``/``coef``/``d``/
    ``cols``/``vals`` are its parameters (grid sizes, eps_z or the
    27-point centre weight, the diagonal, the ELL arrays); ``expr`` is the
    operator's plain apply of the ring-top row, which the CPU path
    evaluates and which the kernel mirrors term by term.  A halo plug-in
    (``kind`` in ``HALO_KINDS``) also has ``prepare(z_top)``, which builds
    its ``ext_len``-long operand outside the kernel; its ``expr`` is the
    shard-level expression applied to that operand.
    """

    kind: str
    expr: Callable[[torch.Tensor], torch.Tensor]
    n: int
    dims: tuple[int, int, int] = (0, 0, 0)
    coef: float = 0.0
    d: torch.Tensor | None = None
    cols: torch.Tensor | None = None
    vals: torch.Tensor | None = None
    prepare: Callable[[torch.Tensor], torch.Tensor] | None = None
    ext_len: int = 0

    @property
    def operand_bytes(self) -> int:
        """Bytes of operator data the SPMV reads beside the slab: an ELL
        operator's cols and vals, and a halo plug-in's halo, the part of
        its extended operand past the shard's own ``n`` rows (those are a
        copy of the ring-top row, which ``min_bytes`` counts once already,
        as it leaves out the single-device plug-in's copy; it counts a
        diagonal by ``has_diag``)."""
        halo = self.ext_len - self.n if self.ext_len else 0
        return sum(t.numel() * t.element_size()
                   for t in (self.cols, self.vals) if t is not None) + \
            8 * halo


def _with_prepare(expr, prepare):
    return lambda z: expr(prepare(z))


def resident_spmv(kind: str, expr: Callable[[torch.Tensor], torch.Tensor],
                  dims: tuple[int, ...], coef: float = 0.0,
                  prepare: Callable[[torch.Tensor], torch.Tensor] | None = None
                  ) -> FusedSpmv:
    """Stencil SPMV.  Single-device (``prepare`` None): the ring-top row is
    copied to its own buffer before the launch and read there by every
    block (the Pallas plug-in's resident operand), and ``expr`` is the
    operator's apply.  Halo-extended (``stencil2d5``/``stencil3d7`` of one
    shard, ``dims`` the shard's grid (nxl, ny[, nz])): ``prepare(z_top)``
    returns the (nxl + 2)-plane operand whose first and last planes are the
    neighbours' boundary planes (zero at the domain's ends), and ``expr``
    is the shard-level expression on it (``ref.stencil2d5_halo_ref``,
    ``ref.stencil3d7_halo_ref``)."""
    if kind not in SPMV_KINDS[:3]:
        raise ValueError(f"unknown stencil kind {kind!r}")
    dims3 = tuple(dims) + (1,) * (3 - len(dims))
    if prepare is None:
        return FusedSpmv(kind=kind, expr=expr, n=math.prod(dims3),
                         dims=dims3, coef=float(coef))
    if kind == "stencil3d27":
        raise ValueError("stencil3d27 has no halo-extended plug-in (the JAX "
                         "package's distributed fused path has none)")
    return FusedSpmv(kind=kind + "_halo", expr=_with_prepare(expr, prepare),
                     n=math.prod(dims3), dims=dims3, coef=float(coef),
                     prepare=prepare,
                     ext_len=(dims3[0] + 2) * dims3[1] * dims3[2])


def diagonal_spmv(d: torch.Tensor) -> FusedSpmv:
    """A = diag(d): az is elementwise, no halo and no copy."""
    return FusedSpmv(kind="diagonal", expr=lambda z: d.to(z.dtype) * z,
                     n=int(d.shape[0]), d=d)


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor,
             prepare: Callable[[torch.Tensor], torch.Tensor] | None = None,
             ext_len: int = 0) -> FusedSpmv:
    """Padded-row ELL SPMV (``SparseOp``): each row gathers its W slots
    from the ring-top copy and sums them in ``ref.ell_rowsum``'s order.
    ``vals`` is held in fp64, the slab's type (exact for fp32 values, and
    the cast the plain apply makes).  Halo-extended (one shard of a
    ``PartitionPlan``): ``prepare(z_top)`` returns the ``ext_len``-long
    vector [own | from prev | from next] that the plan's remapped ``cols``
    index."""
    vals64 = vals.to(torch.float64)

    def expr(z):
        return ell_rowsum(vals64.to(z.dtype), z[cols])

    if prepare is None:
        return FusedSpmv(kind="ell", expr=expr, n=int(cols.shape[0]),
                         cols=cols, vals=vals64)
    return FusedSpmv(kind="ell_halo", expr=_with_prepare(expr, prepare),
                     n=int(cols.shape[0]), cols=cols, vals=vals64,
                     prepare=prepare, ext_len=int(ext_len))


# ---------------------------------------------------------------- kernel --

_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
MAX_SLAB = 65535     # columns of one slab launch (the second grid dimension)
BLOCK = 256          # threads per block, fixed in csrc/fused_iter.cuh
NWARP = BLOCK // 32  # warps per block
LMAX = 8             # deepest pipeline instantiated at compile time
ELL_TILE_BYTES = 64 * 1024   # most shared memory a staged ELL tile takes
BULK_ALIGN = 16      # the bulk copy's address and size unit


@dataclasses.dataclass(frozen=True)
class EllTilePlan:
    """How the ELL plug-in's launch covers an (n, w) operator.

    ``staged``: the staged ELL kernel, one block for each of the ``tiles``
    BLOCK-row tiles, looping over the slab's columns; tiles
    ``0 .. bulk_tiles - 1`` arrive by bulk copy, the rest (the ragged last
    tile, every tile of a misaligned operator) by ordinary loads, into
    ``tile_bytes`` of dynamic shared memory.  Otherwise the direct kernel:
    a (tiles, s) grid, one block a tile of one column, reading the slots
    from device memory."""
    staged: bool
    tiles: int
    bulk_tiles: int
    tile_bytes: int


def ell_tile_plan(n: int, w: int, cols_offset: int,
                  vals_offset: int) -> EllTilePlan:
    """The ELL plug-in's launch plan for ``n`` rows of ``w`` slots (fp64
    values, int32 columns), from the operator alone.  ``cols_offset`` and
    ``vals_offset`` are the base addresses (only their residue mod 16
    matters).  A tile of BLOCK rows takes BLOCK * w * 12 bytes; wider than
    ``ELL_TILE_BYTES``, the direct kernel runs.  A full tile's spans
    (BLOCK * w elements of 4 or 8 bytes) start and end on 16-byte
    boundaries when both bases do.  A few integer operations: no cache."""
    tiles = -(-n // BLOCK)
    tile_bytes = BLOCK * w * (8 + 4)
    if tile_bytes > ELL_TILE_BYTES:
        return EllTilePlan(False, tiles, 0, 0)
    aligned = cols_offset % BULK_ALIGN == 0 and vals_offset % BULK_ALIGN == 0
    return EllTilePlan(True, tiles, n // BLOCK if aligned else 0, tile_bytes)


def runtime_smem_bytes(l: int) -> int:
    """Dynamic shared memory a block of the runtime-depth kernel takes at
    depth l (``rt_smem_bytes`` in csrc/fused_iter.cuh): the l fill and l
    recurrence values of each of the BLOCK threads, the 2l+1 products'
    NWARP warp sums, the scalar vector, the index vector and two store
    masks."""
    return (2 * l * BLOCK * 8 + (2 * l + 1) * NWARP * 8 + (8 + l) * 8
            + (8 * l + 9) * 4 + 2 * l * 4)


def deepest_runtime_l(smem_optin: int) -> int:
    """The deepest l whose runtime-depth kernel fits ``smem_optin`` bytes
    of shared memory a block."""
    return (smem_optin - runtime_smem_bytes(0)) // (runtime_smem_bytes(1)
                                                     - runtime_smem_bytes(0))


def launch_key(kind: str, l: int, slab: bool = False) -> str:
    """The ``_build.LAUNCHES`` key one launch of plug-in ``kind`` at depth
    ``l`` counts under; ``slab`` for the slab form."""
    if l > LMAX:
        key = "fused_iter_runtime_l"
    elif kind in ("ell", "ell_halo"):
        key = "fused_iter_" + kind
    elif kind in HALO_KINDS:
        key = "fused_iter_halo"
    else:
        key = "fused_iter"
    return key + "_slab" if slab else key


def smem_optin(lib_name: str, device: torch.device) -> int:
    """The card's largest dynamic shared memory a block can opt in to."""
    fn = getattr(_build.load(lib_name, {lib_name + "_smem_optin":
                                        [ctypes.c_void_p]}),
                 lib_name + "_smem_optin")
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        _build.check(fn(ctypes.byref(out)), lib_name + "_smem_optin")
    return int(out.value)


def _check(t: torch.Tensor, name: str, dtype, shape, device,
           rows_strided: bool = False) -> None:
    """Refuse a tensor a kernel cannot take.  ``rows_strided`` admits a
    2-D tensor whose rows are contiguous but lie further apart (a block of
    a wider tensor's columns)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if rows_strided and t.dim() == 2 and t.stride(1) == 1 \
            and t.stride(0) >= t.shape[1]:
        return
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def build_fused_iteration(
    layout: SlabLayout,
    spmv: FusedSpmv,
    inv_diag: torch.Tensor | None = None,
) -> Callable:
    """Assemble ``fiter(S, idx, scal) -> (S', partials)`` for one
    (operator, preconditioner, depth) configuration.

    ``inv_diag`` enables the pointwise (Jacobi) preconditioner; None means
    identity.
    """
    l, nv = layout.l, layout.nv
    IX = idx_layout(l)
    IS = scal_layout(l)
    nd = 2 * l + 1
    if layout.recurrence not in ("ghysels", "stable"):
        raise ValueError(f"unknown recurrence {layout.recurrence!r} "
                         "(want 'ghysels' or 'stable')")
    check_z_top_not_written(layout)
    n = spmv.n
    name = "fused_iter_" + spmv.kind
    prec = (lambda v: v) if inv_diag is None else \
        (lambda v: inv_diag.to(v.dtype) * v)

    def plain(S, idx, scal):
        host = idx.tolist() if isinstance(idx, torch.Tensor) else list(idx)
        for row in (host if S.dim() == 3 else [host]):
            if row[IX["z_top"]] in written_rows(layout, row):
                raise ValueError("z_top row is among the rows this phase "
                                 "writes")
        ref_fn = fused_iter_ref if S.dim() == 2 else fused_iter_ref_slab
        return ref_fn(S, idx, scal, spmv.expr, prec, layout)

    def launch(S, idx, scal):
        dev = S.device
        slab = S.dim() == 3
        s = S.shape[0] if slab else 1
        if slab and spmv.prepare is not None:
            raise ValueError("the slab form takes single-device plug-ins "
                             "only: batched solves over ranks are not ported "
                             "(ROADMAP.md, queue 1 item 5b)")
        if not 1 <= s <= MAX_SLAB:
            raise ValueError(f"a slab of {s} columns (want 1 to {MAX_SLAB})")
        if l > LMAX:
            need, have = runtime_smem_bytes(l), smem_optin(name, dev)
            if need > have:
                raise ValueError(
                    f"pipeline depth l = {l} exceeds the superkernel's "
                    f"deepest, l = {deepest_runtime_l(have)}: the "
                    f"runtime-depth kernel needs {need} bytes of shared "
                    f"memory a block, the card allows {have}")
        lead = (s,) if slab else ()
        if slab:
            _check(S, "S", torch.float64, (s, nv, n), dev)
        else:
            _check(S, "S", torch.float64, (nv, n), dev, rows_strided=True)
        _check(idx, "idx", torch.int32, lead + (IX["size"],), dev)
        _check(scal, "scal", torch.float64, lead + (IS["size"],), dev)
        inv = None
        if inv_diag is not None:
            inv = inv_diag
            _check(inv, "inv_diag", torch.float64, (n,), dev)
        d = spmv.d
        if d is not None:
            _check(d, "d", torch.float64, (n,), dev)
        cols, vals, w = spmv.cols, spmv.vals, 0
        tile_bytes, bulk_tiles = 0, 0
        if cols is not None:
            w = int(cols.shape[1])
            _check(cols, "cols", torch.int32, (n, w), dev)
            _check(vals, "vals", torch.float64, (n, w), dev)
            if spmv.kind == "ell" and l <= LMAX:
                tp = ell_tile_plan(n, w, cols.data_ptr(), vals.data_ptr())
                if tp.staged:
                    tile_bytes, bulk_tiles = tp.tile_bytes, tp.bulk_tiles
        nb = (n + BLOCK - 1) // BLOCK
        zs = n
        if spmv.prepare is not None:
            # The halo plug-ins read the operand ``prepare`` builds from the
            # ring-top row (selected on the device: no host sync).
            pos = IX["z_top"]
            zbuf = spmv.prepare(S.index_select(0, idx[pos:pos + 1])[0])
            _check(zbuf, "prepared operand", torch.float64,
                   (spmv.ext_len,), dev)
            zs = spmv.ext_len
        elif spmv.kind == "diagonal" or tile_bytes:
            zbuf = None     # no operand, or the staged ELL kernel's in place
        else:
            zbuf = torch.empty(lead + (n,), dtype=S.dtype, device=dev)
        part = torch.empty(lead + (nd, nb), dtype=S.dtype, device=dev)
        partials = torch.empty(lead + (nd,), dtype=S.dtype, device=dev)
        fn = getattr(_build.load(name, {name: _ARGTYPES}), name)
        nx, ny, nz = spmv.dims
        ld = S.stride(-2)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(l, int(layout.recurrence == "stable"),
                    int(inv is not None), S.data_ptr(), n, ld, s,
                    S.stride(0) if slab else nv * ld, layout.RB,
                    idx.data_ptr(), scal.data_ptr(),
                    None if zbuf is None else zbuf.data_ptr(), zs,
                    None if inv is None else inv.data_ptr(),
                    part.data_ptr(), nb, partials.data_ptr(), nx, ny, nz,
                    spmv.coef, None if d is None else d.data_ptr(),
                    None if cols is None else cols.data_ptr(),
                    None if vals is None else vals.data_ptr(), w,
                    tile_bytes, bulk_tiles, stream)
        _build.LAUNCHES[launch_key(spmv.kind, l, slab)] += 1
        _build.check(rc, name)
        return S, partials

    def fiter(S: torch.Tensor, idx, scal: torch.Tensor):
        if S.device.type == "cpu":
            return plain(S, idx, scal)
        if S.device.type == "cuda":
            return launch(S, idx, scal)
        raise ValueError(f"no fused iteration for device {S.device}")

    fiter.plain = plain
    fiter.spmv = spmv
    return fiter


def custom_call_hbm_bytes(layout: SlabLayout, n: int, dsize: int = 8,
                          extra_bytes: int = 0, n_tiles: int = 1) -> int:
    """The JAX package's reckoning of the superkernel's HBM traffic (its
    ``custom_call_hbm_bytes``): the slab once in, once out, the resident
    SPMV operand per tile, and the O(l) scalar/partial bundles."""
    slab = layout.nv * n * dsize
    idx_scal = (idx_layout(layout.l)["size"] * 4
                + scal_layout(layout.l)["size"] * dsize)
    partials = (2 * layout.l + 1) * dsize
    resident = n_tiles * (n * dsize + extra_bytes)
    return 2 * slab + resident + idx_scal + partials


def min_bytes(layout: SlabLayout, idx, n: int, has_prec: bool,
              has_diag: bool, dsize: int = 8, operand_bytes: int = 0) -> int:
    """Least device-memory bytes one vector phase must move for the index
    vector ``idx``: each distinct slab row it reads once, each distinct row
    it changes once, the preconditioner and diagonal vectors once, the
    SPMV's other operator data (``operand_bytes``: an ELL operator's cols
    and vals, ``FusedSpmv.operand_bytes``) once, plus the idx/scal inputs
    and the partials output.  The bound of the superkernel on the card."""
    l = layout.l
    IX = idx_layout(l)
    late = idx[IX["f_late"]] != 0
    do_upd = idx[IX["f_upd"]] != 0
    first = idx[IX["f_first"]] != 0
    reads = {idx[IX[k]] for k in ("z_top", "u_i", "u_im1")}
    if layout.recurrence != "stable":
        reads.add(idx[IX["zl_im1"]])
    reads |= {idx[IX["mat_v"] + t] for t in range(l)}
    reads |= {idx[IX["mat_z"] + t] for t in range(l - 1)}
    writes = {idx[IX["fill"] + k] for k in range(l)
              if idx[IX["f_fill"] + k] != 0}
    writes |= {idx[IX["z_w"]], idx[IX["u_w"]]}
    if late:
        for k in range(l):
            reads |= {idx[IX[r] + k] for r in ("rec_a", "rec_b", "rec_c")}
        writes |= {idx[IX["rec_w"] + k] for k in range(l)}
    else:
        reads.add(idx[IX["rec_w"]])
    if do_upd:
        reads |= {layout.x_row, layout.p_row, idx[IX["p_im"]]}
        writes |= {layout.x_row, layout.p_row}
    elif first:
        reads.add(0)
        writes.add(layout.p_row)
    vectors = len(reads) + len(writes) + int(has_prec) + int(has_diag)
    return (vectors * n * dsize + operand_bytes + IX["size"] * 4
            + scal_layout(l)["size"] * dsize + (2 * l + 1) * dsize)
