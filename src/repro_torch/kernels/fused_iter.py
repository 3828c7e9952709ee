"""Fused-iteration superkernel: the whole p(l)-CG vector phase in one pass
over the (NV, N) state slab, written in CUDA C++ for Hopper
(``csrc/fused_iter.cuh``).

Counterpart of ``repro/kernels/fused_iter.py``.  The positional layouts
(``SlabLayout``, ``idx_layout``, ``scal_layout``, ``tel_layout``) are
copied verbatim, so one ``(S, idx, scal)`` triple feeds both packages.

``build_fused_iteration`` returns ``fiter(S, idx, scal) -> (S', partials)``.
On a CUDA slab it launches the superkernel, which updates ``S`` in place
(``S'`` is ``S``); on a CPU slab it runs the plain version
``ref.fused_iter_ref``.  Any other device raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_iter_ref


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
# ring per iteration; the port does not record telemetry yet, the layout
# is kept so both packages share one positional contract.
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
        "action": 8,       # governor action on this row
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
    from a copy taken before the launch; that copy equals the slab row for
    the whole launch only if no write targets it.  Verified here for every
    cycle iteration index (the index vector is periodic in i past 2l)."""
    period = 3 * layout.RB
    for i in range(2 * layout.l + 2 * period):
        idx = host_idx(layout, i)
        if idx[idx_layout(layout.l)["z_top"]] in written_rows(layout, idx):
            raise AssertionError(f"z_top row is written at i={i}: {layout}")


# ------------------------------------------------------------ SPMV plug-ins --

SPMV_KINDS = ("stencil2d5", "stencil3d7", "stencil3d27", "diagonal")


@dataclasses.dataclass(frozen=True)
class FusedSpmv:
    """Operator plug-in for the superkernel.

    ``kind`` selects the kernel's SPMV template; ``dims``/``coef``/``d``
    are its parameters (grid sizes, eps_z or the 27-point centre weight,
    the diagonal); ``expr`` is the operator's plain apply, which the CPU
    path evaluates and which the kernel mirrors term by term.
    """

    kind: str
    expr: Callable[[torch.Tensor], torch.Tensor]
    n: int
    dims: tuple[int, int, int] = (0, 0, 0)
    coef: float = 0.0
    d: torch.Tensor | None = None


def resident_spmv(kind: str, expr: Callable[[torch.Tensor], torch.Tensor],
                  dims: tuple[int, ...], coef: float = 0.0) -> FusedSpmv:
    """Stencil SPMV: the ring-top row is copied to its own buffer before
    the launch and read there by every block (the Pallas plug-in's
    resident operand)."""
    if kind not in SPMV_KINDS[:3]:
        raise ValueError(f"unknown stencil kind {kind!r}")
    dims3 = tuple(dims) + (1,) * (3 - len(dims))
    return FusedSpmv(kind=kind, expr=expr, n=math.prod(dims3),
                     dims=dims3, coef=float(coef))


def diagonal_spmv(d: torch.Tensor) -> FusedSpmv:
    """A = diag(d): az is elementwise, no halo and no copy."""
    return FusedSpmv(kind="diagonal", expr=lambda z: d.to(z.dtype) * z,
                     n=int(d.shape[0]), d=d)


# ---------------------------------------------------------------- kernel --

_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p,
             ctypes.c_void_p]
BLOCK = 256          # threads per block, fixed in csrc/fused_iter.cuh
LMAX = 6             # deepest pipeline the kernel is instantiated for


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
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
    prec = (lambda v: v) if inv_diag is None else \
        (lambda v: inv_diag.to(v.dtype) * v)

    def plain(S, idx, scal):
        host = idx.tolist() if isinstance(idx, torch.Tensor) else list(idx)
        if host[IX["z_top"]] in written_rows(layout, host):
            raise ValueError("z_top row is among the rows this phase writes")
        return fused_iter_ref(S, idx, scal, spmv.expr, prec, layout)

    def launch(S, idx, scal):
        if l > LMAX:
            raise NotImplementedError(
                f"the CUDA superkernel is instantiated for l <= {LMAX}")
        dev = S.device
        _check(S, "S", torch.float64, (nv, n), dev)
        _check(idx, "idx", torch.int32, (IX["size"],), dev)
        _check(scal, "scal", torch.float64, (IS["size"],), dev)
        inv = None
        if inv_diag is not None:
            inv = inv_diag
            _check(inv, "inv_diag", torch.float64, (n,), dev)
        d = spmv.d
        if d is not None:
            _check(d, "d", torch.float64, (n,), dev)
        nb = (n + BLOCK - 1) // BLOCK
        zbuf = None if spmv.kind == "diagonal" else \
            torch.empty(n, dtype=S.dtype, device=dev)
        part = torch.empty((nd, nb), dtype=S.dtype, device=dev)
        partials = torch.empty((nd,), dtype=S.dtype, device=dev)
        name = "fused_iter_" + spmv.kind
        fn = getattr(_build.load(name, {name: _ARGTYPES}), name)
        nx, ny, nz = spmv.dims
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(l, int(layout.recurrence == "stable"),
                    int(inv is not None), S.data_ptr(), n, layout.RB,
                    idx.data_ptr(), scal.data_ptr(),
                    None if zbuf is None else zbuf.data_ptr(),
                    None if inv is None else inv.data_ptr(),
                    part.data_ptr(), nb, partials.data_ptr(), nx, ny, nz,
                    spmv.coef, None if d is None else d.data_ptr(), stream)
        _build.LAUNCHES["fused_iter"] += 1
        _build.check(rc, name)
        return S, partials

    def fiter(S: torch.Tensor, idx, scal: torch.Tensor):
        if S.device.type == "cpu":
            return plain(S, idx, scal)
        if S.device.type == "cuda":
            return launch(S, idx, scal)
        raise ValueError(f"no fused iteration for device {S.device}")

    fiter.plain = plain
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
              has_diag: bool, dsize: int = 8) -> int:
    """Least device-memory bytes one vector phase must move for the index
    vector ``idx``: each distinct slab row it reads once, each distinct row
    it changes once, the preconditioner and diagonal vectors once, plus the
    idx/scal inputs and the partials output.  The bound of the superkernel
    on the card."""
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
    return (vectors * n * dsize + IX["size"] * 4
            + scal_layout(l)["size"] * dsize + (2 * l + 1) * dsize)
