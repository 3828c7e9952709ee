"""Plain PyTorch versions of the port's kernels (the CPU path and the
references the CUDA kernels are held against on the card).

Each expression keeps the term order of its counterpart in
``repro/kernels/ref.py``, so that with FMA contraction off a kernel that
follows the same order is bitwise equal to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def stencil2d5_ref(g: torch.Tensor) -> torch.Tensor:
    p = F.pad(g, (1, 1, 1, 1))
    return 4.0 * g - p[:-2, 1:-1] - p[2:, 1:-1] - p[1:-1, :-2] - p[1:-1, 2:]


def stencil3d7_ref(g: torch.Tensor, eps_z: float = 1.0) -> torch.Tensor:
    p = F.pad(g, (1, 1, 1, 1, 1, 1))
    ez = torch.full((), eps_z, dtype=g.dtype, device=g.device)
    return (
        (4.0 + 2.0 * ez) * g
        - p[:-2, 1:-1, 1:-1] - p[2:, 1:-1, 1:-1]
        - p[1:-1, :-2, 1:-1] - p[1:-1, 2:, 1:-1]
        - ez * p[1:-1, 1:-1, :-2] - ez * p[1:-1, 1:-1, 2:]
    )


def stencil3d27_ref(g: torch.Tensor, centre: float) -> torch.Tensor:
    nx, ny, nz = g.shape
    p = F.pad(g, (1, 1, 1, 1, 1, 1))
    out = centre * g
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                order = abs(di) + abs(dj) + abs(dk)
                if order == 0:
                    continue
                w = {1: 1.0, 2: 0.5, 3: 0.25}[order]
                out = out - w * p[1 + di:1 + di + nx, 1 + dj:1 + dj + ny,
                                  1 + dk:1 + dk + nz]
    return out


def _sel(flag, a, b):
    """``jnp.where`` for a host or device flag: a select, never a multiply,
    so a NaN in the discarded value stays discarded."""
    if isinstance(flag, torch.Tensor):
        return torch.where(flag, a, b)
    return a if flag else b


def fused_iter_unfused(S, idx, scal, apply_a, prec, layout):
    """UNFUSED p(l)-CG vector phase: one PyTorch op per SPMV /
    preconditioner / fill copy / recurrence / solution update.  Returns
    ``(S', mat, u_new)`` with the dot-block operands left unreduced.

    ``idx`` is the ``idx_layout`` vector: a tensor (read to the host), or a
    list of ints whose flag entries may be 0-d device tensors.  ``S`` is
    not modified; ``S'`` is a new slab (every read is of the original, as
    in the functional reference).  A flag ``v != 0`` is a Python bool or,
    for a device entry, a bool tensor."""
    from repro_torch.kernels.fused_iter import idx_layout, scal_layout

    l = layout.l
    IX = idx_layout(l)
    IS = scal_layout(l)
    if isinstance(idx, torch.Tensor):
        idx = idx.tolist()

    def get(row):
        return S[row]

    late = idx[IX["f_late"]] != 0
    z_top = get(idx[IX["z_top"]])
    u_i = get(idx[IX["u_i"]])
    u_im1 = get(idx[IX["u_im1"]])

    az = apply_a(z_top)
    u_new0 = az - scal[IS["sig_i"]] * u_i
    u_new = _sel(
        late,
        (u_new0 - scal[IS["gam_new"]] * u_i
         - scal[IS["d2"]] * u_im1) / scal[IS["dlt_safe"]],
        u_new0)
    if layout.recurrence == "stable":
        z_new = prec(u_new)
        z_fill = z_new
    else:
        z_new0 = prec(u_new0)
        zl_im1 = get(idx[IX["zl_im1"]])
        z_new = _sel(
            late,
            (z_new0 - scal[IS["gam_new"]] * z_top
             - scal[IS["d2"]] * zl_im1) / scal[IS["dlt_safe"]],
            z_new0)
        z_fill = z_new0

    out = S.clone()
    for k in range(l):
        row = idx[IX["fill"] + k]
        out[row] = _sel(idx[IX["f_fill"] + k] != 0, z_fill, get(row))

    recs = []
    for k in range(l):
        zk1 = get(idx[IX["rec_a"] + k])
        zm1 = get(idx[IX["rec_b"] + k])
        zm2 = get(idx[IX["rec_c"] + k])
        rec = (zk1 + scal[IS["c1"] + k] * zm1
               - scal[IS["d2"]] * zm2) / scal[IS["dlt_safe"]]
        val = _sel(late, rec, get(idx[IX["rec_w"] + k]))
        recs.append(val)
        out[idx[IX["rec_w"] + k]] = val

    out[idx[IX["z_w"]]] = z_new
    out[idx[IX["u_w"]]] = u_new

    rows = [get(idx[IX["mat_v"] + t]) for t in range(l)] + [recs[0]]
    rows += [get(idx[IX["mat_z"] + t]) for t in range(l - 1)] + [z_new]
    mat = torch.stack(rows)

    x_old = S[layout.x_row]
    p_old = S[layout.p_row]
    p_first = S[0] / scal[IS["eta0_safe"]]
    p_new = (get(idx[IX["p_im"]])
             - scal[IS["d_prev"]] * p_old) / scal[IS["eta_new_safe"]]
    x_new = x_old + scal[IS["zet_prev"]] * p_old
    do_upd = idx[IX["f_upd"]] != 0
    is_first = idx[IX["f_first"]] != 0
    out[layout.x_row] = _sel(do_upd, x_new, x_old)
    out[layout.p_row] = _sel(is_first, p_first, _sel(do_upd, p_new, p_old))
    return out, mat, u_new


def fused_iter_ref(S, idx, scal, apply_a, prec, layout):
    """Unfused vector phase with the local dot partials closed through
    ``core.types.dot_block_rows``: the plain version of the superkernel."""
    from repro_torch.core.types import dot_block_rows

    out, mat, u_new = fused_iter_unfused(S, idx, scal, apply_a, prec, layout)
    return out, dot_block_rows(mat, u_new)
