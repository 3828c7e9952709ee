"""Plain PyTorch versions of the port's kernels (the CPU path and the
references the CUDA kernels are held against on the card).

Each expression keeps the term order of its counterpart in
``repro/kernels/ref.py``, so that with FMA contraction off a kernel that
follows the same order is bitwise equal to it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

NEG_FILL = -1e30      # the Pallas decode kernel's mask value


def stencil2d5_ref(g: torch.Tensor) -> torch.Tensor:
    """5-point Laplacian of an (nx, ny) grid, or of each grid of an
    (s, nx, ny) slab (the slab form applies the same expression to every
    leading index, so each grid's result is bitwise the single-grid one)."""
    p = F.pad(g, (1, 1, 1, 1))
    return (4.0 * g - p[..., :-2, 1:-1] - p[..., 2:, 1:-1]
            - p[..., 1:-1, :-2] - p[..., 1:-1, 2:])


def stencil3d7_ref(g: torch.Tensor, eps_z: float = 1.0) -> torch.Tensor:
    """Anisotropic 7-point stencil of an (nx, ny, nz) grid or an
    (s, nx, ny, nz) slab of them."""
    p = F.pad(g, (1, 1, 1, 1, 1, 1))
    ez = torch.full((), eps_z, dtype=g.dtype, device=g.device)
    return (
        (4.0 + 2.0 * ez) * g
        - p[..., :-2, 1:-1, 1:-1] - p[..., 2:, 1:-1, 1:-1]
        - p[..., 1:-1, :-2, 1:-1] - p[..., 1:-1, 2:, 1:-1]
        - ez * p[..., 1:-1, 1:-1, :-2] - ez * p[..., 1:-1, 1:-1, 2:]
    )


def stencil2d5_halo_ref(zext: torch.Tensor, nxl: int, ny: int) -> torch.Tensor:
    """The 5-point Laplacian of one shard of an x-partition, on its
    halo-extended operand (nxl + 2, ny) flattened: planes 0 and nxl + 1 are
    the neighbours' boundary rows (zero at the domain's ends), so x needs no
    edge test.  The JAX package's shard expression
    (``repro/parallel/distributed.py``, ``_fused_spmv_local``), term by
    term; stacked over the shards it equals :func:`stencil2d5_ref`."""
    gp = zext.reshape(nxl + 2, ny)
    g = gp[1:-1]
    gy = F.pad(g, (1, 1))
    return (4.0 * g - gp[:-2] - gp[2:] - gy[:, :-2] - gy[:, 2:]).reshape(-1)


def stencil3d7_halo_ref(zext: torch.Tensor, nxl: int, ny: int, nz: int,
                        eps_z: float) -> torch.Tensor:
    """The anisotropic 7-point stencil of one shard on its (nxl + 2, ny, nz)
    halo-extended operand (see :func:`stencil2d5_halo_ref`)."""
    gp = zext.reshape(nxl + 2, ny, nz)
    g = gp[1:-1]
    gy = F.pad(g, (0, 0, 1, 1))
    gz = F.pad(g, (1, 1))
    ez = torch.full((), eps_z, dtype=zext.dtype, device=zext.device)
    out = ((4.0 + 2.0 * ez) * g
           - gp[:-2] - gp[2:]
           - gy[:, :-2, :] - gy[:, 2:, :]
           - ez * gz[:, :, :-2] - ez * gz[:, :, 2:])
    return out.reshape(-1)


def stencil3d27_ref(g: torch.Tensor, centre: float) -> torch.Tensor:
    """27-point stencil of an (nx, ny, nz) grid or an (s, nx, ny, nz) slab."""
    nx, ny, nz = g.shape[-3:]
    p = F.pad(g, (1, 1, 1, 1, 1, 1))
    out = centre * g
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            for dk in (-1, 0, 1):
                order = abs(di) + abs(dj) + abs(dk)
                if order == 0:
                    continue
                w = {1: 1.0, 2: 0.5, 3: 0.25}[order]
                out = out - w * p[..., 1 + di:1 + di + nx,
                                  1 + dj:1 + dj + ny, 1 + dk:1 + dk + nz]
    return out


def ell_rowsum(vals: torch.Tensor, gathered: torch.Tensor) -> torch.Tensor:
    """sum_s vals[..., s] * gathered[..., s] with an explicit left-to-right
    add chain over the (small) slot axis, as ``repro/linalg/sparse.py``'s
    ``ell_rowsum``: a fixed order that the CUDA ELL kernel and the
    superkernel's ELL plug-in follow term by term."""
    acc = vals[..., 0] * gathered[..., 0]
    for s in range(1, vals.shape[-1]):
        acc = acc + vals[..., s] * gathered[..., s]
    return acc


def ell_spmv_ref(x: torch.Tensor, cols: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """Padded-row ELL SpMV: y[r] = sum_s vals[r,s] * x[cols[r,s]], in
    ``vals``' dtype.  Padded slots carry vals 0.  ``x`` may be longer than
    the row count, and may be an (s, n) slab of vectors (one a row; the
    result is then (s, R)).  The JAX oracle sums the slots with
    ``.sum(axis=1)``; this version takes the :func:`ell_rowsum` chain of
    ``SparseOp.apply`` (the two differ by rounding only)."""
    return ell_rowsum(vals, x[..., cols].to(vals.dtype))


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


def fused_iter_unfused_slab(S, idx, scal, apply_a, prec, layout):
    """The unfused vector phase of a SLAB of s columns, in place: ``S`` is
    (s, NV, N), ``idx`` the (s, IX) index table on S's device (one
    ``idx_layout`` row a column, each column at its own cycle index) and
    ``scal`` (s, IS).  ``apply_a`` and ``prec`` take an (s, N) slab.

    Per column it is :func:`fused_iter_unfused` term by term: every row is
    gathered per column (one advanced-indexing gather for all s columns),
    every flag is a per-column select, and every operand row is read before
    the first write, so writing into ``S`` in place equals the functional
    version's fresh slab.  Returns ``(S, mat (s, K, N), u_new (s, N))``."""
    from repro_torch.kernels.fused_iter import idx_layout, scal_layout

    l = layout.l
    IX = idx_layout(l)
    IS = scal_layout(l)
    ar = torch.arange(S.shape[0], device=S.device)
    rows = idx.to(torch.long)

    def row(name, k=0):
        return rows[:, IX[name] + k]

    def flag(name, k=0):
        return (idx[:, IX[name] + k] != 0)[:, None]

    def get(name, k=0):
        return S[ar, row(name, k)]

    def sc(name, k=0):
        return scal[:, IS[name] + k, None]

    late = flag("f_late")
    z_top, u_i, u_im1 = get("z_top"), get("u_i"), get("u_im1")

    az = apply_a(z_top)
    u_new0 = az - sc("sig_i") * u_i
    u_new = torch.where(
        late,
        (u_new0 - sc("gam_new") * u_i - sc("d2") * u_im1) / sc("dlt_safe"),
        u_new0)
    if layout.recurrence == "stable":
        z_new = prec(u_new)
        z_fill = z_new
    else:
        z_new0 = prec(u_new0)
        zl_im1 = get("zl_im1")
        z_new = torch.where(
            late,
            (z_new0 - sc("gam_new") * z_top - sc("d2") * zl_im1)
            / sc("dlt_safe"),
            z_new0)
        z_fill = z_new0

    fills = [torch.where(flag("f_fill", k), z_fill, get("fill", k))
             for k in range(l)]
    recs = []
    for k in range(l):
        rec = (get("rec_a", k) + sc("c1", k) * get("rec_b", k)
               - sc("d2") * get("rec_c", k)) / sc("dlt_safe")
        recs.append(torch.where(late, rec, get("rec_w", k)))
    mat = torch.stack([get("mat_v", t) for t in range(l)] + [recs[0]]
                      + [get("mat_z", t) for t in range(l - 1)] + [z_new],
                      dim=1)
    x_old = S[:, layout.x_row]           # views: no write below hits them
    p_old = S[:, layout.p_row]           # before they are read
    p_first = S[:, 0] / sc("eta0_safe")
    p_new = (get("p_im") - sc("d_prev") * p_old) / sc("eta_new_safe")
    x_new = x_old + sc("zet_prev") * p_old

    # Every operand is read; the writes follow in the functional order.
    for k in range(l):
        S[ar, row("fill", k)] = fills[k]
    for k in range(l):
        S[ar, row("rec_w", k)] = recs[k]
    S[ar, row("z_w")] = z_new
    S[ar, row("u_w")] = u_new
    S[:, layout.x_row] = torch.where(flag("f_upd"), x_new, x_old)
    S[:, layout.p_row] = torch.where(
        flag("f_first"), p_first, torch.where(flag("f_upd"), p_new, p_old))
    return S, mat, u_new


def fused_iter_ref_slab(S, idx, scal, apply_a, prec, layout):
    """The plain version of the superkernel's slab form: the single-column
    :func:`fused_iter_ref` applied to each column ``c`` with its own
    ``idx[c]`` and ``scal[c]``; ``apply_a``/``prec`` act on one column.
    Returns a fresh (s, NV, N) slab and the (s, 2l+1) partials."""
    outs, parts = [], []
    for c in range(S.shape[0]):
        out, part = fused_iter_ref(S[c], idx[c], scal[c], apply_a, prec,
                                   layout)
        outs.append(out)
        parts.append(part)
    return torch.stack(outs), torch.stack(parts)


def fused_dots_ref(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """(K, N) x (N,) or (N, S) in fp32, cast back to ``mat``'s dtype: the
    plain version of ``csrc/fused_dots.cu``."""
    return (mat.float() @ vec.float()).to(mat.dtype)


def fused_axpy3_ref(zk1, zm1, zm2, c1, c2, scale):
    """((zk1 + c1*zm1) + c2*zm2) * scale in fp32, each scalar rounded to
    fp32 first, cast back to ``zk1``'s dtype: the plain version of
    ``csrc/fused_axpy.cu``, one rounding per operation in this order."""
    c1, c2, scale = (float(np.float32(float(c))) for c in (c1, c2, scale))
    out = (zk1.float() + c1 * zm1.float() + c2 * zm2.float()) * scale
    return out.to(zk1.dtype)


def decode_attention_ref(q, k, v, kv_len):
    """q (B,Hkv,G,D), k/v (B,Hkv,S,D), kv_len an int -> (B,Hkv,G,D) fp32:
    the normalized oracle, as in the JAX package (``-inf`` mask fill, so a
    row with no valid column is NaN)."""
    d = q.shape[-1]
    s = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) * scale
    mask = torch.arange(s, device=q.device)[None, None, None, :] < kv_len
    scores = torch.where(mask, scores, -math.inf)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhgs,bhsd->bhgd", w, v.float())


def decode_attention_stats_ref(q, k, v, kv_len):
    """The plain version of ``csrc/decode_attention.cu``: q (B,Hkv,G,D),
    k/v in the callers' (B,S,Hkv,D) layout, kv_len an int ->
    ``(o_unnorm (B,Hkv,G,D), m (B,Hkv,G,1), l (B,Hkv,G,1))``, all fp32.

    Masked scores are -1e30, as in the Pallas kernel: with no valid column
    m is -1e30, every column weighs exp(0) = 1, l counts the S columns and
    o is the sum of v.  The softmax statistics are taken over the whole row
    at once; the kernel's online form equals them up to rounding."""
    d = q.shape[-1]
    s = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bhgd,bshd->bhgs", q.float(), k.float()) * scale
    mask = torch.arange(s, device=q.device)[None, None, None, :] < kv_len
    scores = torch.where(mask, scores, NEG_FILL)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return o, m, l
