"""Public wrappers around the port's kernels (counterpart of
``repro/kernels/ops.py``): the fused-iteration factory with its operator
plug-ins, the standalone stencil and ELL applies, the fused dot block and
three-term recurrence, and single-token decode attention.

The signatures and layouts are the JAX package's, without ``interpret``.
The CUDA kernels take any length, so nothing is padded to a block
multiple here."""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import ell_spmv as _el
from repro_torch.kernels import fused_axpy as _fa
from repro_torch.kernels import fused_dots as _fd
from repro_torch.kernels import fused_iter as _fi
from repro_torch.kernels import stencil_spmv as _ss


def _local_fused_spmv(op):
    """Single-device :class:`~repro_torch.kernels.fused_iter.FusedSpmv`
    for the operator, mirroring its plain ``apply`` term by term; None when
    unsupported.  ``use_kernel`` operators are refused as in the JAX
    package: their apply goes through a standalone kernel, and the
    superkernel mirrors the plain expressions instead."""
    from repro_torch.linalg.operators import (DiagonalOp, Stencil2D5,
                                              Stencil3D7, Stencil3D27)
    from repro_torch.linalg.sparse import SparseOp

    if isinstance(op, DiagonalOp):
        return _fi.diagonal_spmv(op.d)
    if getattr(op, "use_kernel", False):
        return None
    if isinstance(op, SparseOp):
        return _fi.ell_spmv(op.cols, op.vals)
    if isinstance(op, Stencil2D5):
        return _fi.resident_spmv("stencil2d5", op.apply, (op.nx, op.ny))
    if isinstance(op, Stencil3D7):
        return _fi.resident_spmv("stencil3d7", op.apply,
                                 (op.nx, op.ny, op.nz), op.eps_z)
    if isinstance(op, Stencil3D27):
        return _fi.resident_spmv("stencil3d27", op.apply,
                                 (op.nx, op.ny, op.nz), op.centre)
    return None


def fused_iteration_factory(op, prec=None):
    """Factory for the fused-iteration superkernel on one device, or None
    when the (operator, preconditioner) pair has no fused path: an
    unsupported operator kind, a kernel-routed stencil, or a
    preconditioner that is not pointwise.  ``factory(layout)`` returns
    the per-iteration ``fiter(S, idx, scal)``."""
    from repro_torch.linalg.preconditioners import IdentityPrec, JacobiPrec

    if prec is None or isinstance(prec, IdentityPrec):
        inv_diag = None
    elif isinstance(prec, JacobiPrec):
        inv_diag = prec.inv_diag
    else:
        return None
    spmv = _local_fused_spmv(op)
    if spmv is None:
        return None

    def factory(layout):
        return _fi.build_fused_iteration(layout, spmv, inv_diag)

    return factory


def stencil2d5_apply(g: torch.Tensor) -> torch.Tensor:
    """The CUDA stencil kernel needs no padding or blocking on the host:
    it reads its neighbours and the Dirichlet zeros itself."""
    return _ss.stencil2d5(g.contiguous())


def stencil3d7_apply(g: torch.Tensor, eps_z: float = 1.0) -> torch.Tensor:
    return _ss.stencil3d7(g.contiguous(), eps_z)


def ell_spmv_apply(x: torch.Tensor, cols: torch.Tensor,
                   vals: torch.Tensor) -> torch.Tensor:
    """Padded-row ELL SpMV (DESIGN.md §12).  ``x`` may be longer than the
    row count.  The CUDA kernel bounds-checks its rows, so no padding to a
    block multiple is needed."""
    return _el.ell_spmv(x, cols.contiguous(), vals.contiguous())


def fused_dots(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """(K, N) x (N,) -> (K,) in ``mat``'s dtype, accumulated in fp32."""
    return _fd.fused_dots(mat.contiguous(), vec.contiguous())


def fused_dots_mrhs(mat: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """(K, N) x (N, S) -> (K, S): the slab dot block, ``mat`` streamed once
    for all S right-hand sides (DESIGN.md §11)."""
    return _fd.fused_dots_mrhs(mat.contiguous(), vecs.contiguous())


def fused_axpy3(zk1, zm1, zm2, c1, c2, scale) -> torch.Tensor:
    """(zk1 + c1*zm1 + c2*zm2) * scale in one pass, in fp32."""
    return _fa.fused_axpy3(zk1.contiguous(), zm1.contiguous(),
                           zm2.contiguous(), c1, c2, scale)


def decode_attention_stats(q, k, v, kv_len, block_s: int = 512):
    """Unnormalized ``(o, m, l)`` of one query token for the cross-shard
    split-KV merge: q (B, H, D), k/v (B, S, Hkv, D); o is (B, Hkv, G, D),
    m and l (B, Hkv, G, 1), all fp32.  ``block_s`` is the number of cache
    positions one CUDA block reduces (the kernel's split of S) and sets the
    padded length S_p (S rounded up to a multiple of ``block_s``) that the
    edges below report.

    The JAX wrapper pads S to S_p with zero k/v and masks positions at or
    past ``kv_len``; this wrapper gives its results at the edges:
    * ``kv_len`` <= 0: no valid position; m = -1e30, o = the sum of v and
      l = S_p (a negative ``kv_len`` counts as 0).
    * ``kv_len`` > S: the kernel runs over all S positions, and the
      e = min(kv_len, S_p) - S padding positions the JAX wrapper counts
      as valid (score 0, value 0) are folded in: m' = max(m, 0),
      l' = l exp(m - m') + e exp(-m'), o' = o exp(m - m').

    ``kv_len`` is a host integer, or a 0-d or (1, 1) integer tensor on the
    cache's device (the JAX wrappers' device scalar).  A tensor is never
    read on the host: the clamps and the edge folding run as tensor
    selects, and the kernel reads the length from device memory, with the
    same bits as the integer path."""
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    qg = q.reshape(b, hkv, h // hkv, d)
    padded = -(-s // block_s) * block_s
    if isinstance(kv_len, torch.Tensor):
        if kv_len.numel() != 1:
            raise ValueError(f"kv_len must hold one integer, got shape "
                             f"{tuple(kv_len.shape)}")
        want = kv_len.reshape(()).to(torch.int64).clamp_min(0)
        o, m, l = _da.decode_attention_stats(
            qg, k, v, want.clamp_max(s).to(torch.int32), block_s)
        o_e, m_e, l_e = _fold_padding(o, m, l, want.clamp_max(padded) - s)
        over = want > s if padded > s else torch.zeros_like(want, dtype=bool)
        l = torch.where(want == 0, l + (padded - s),
                        torch.where(over, l_e, l))
        return torch.where(over, o_e, o), torch.where(over, m_e, m), l
    want = max(int(kv_len), 0)
    o, m, l = _da.decode_attention_stats(qg, k, v, min(want, s), block_s)
    if want == 0:
        l = l + (padded - s)
    elif want > s and padded > s:
        o, m, l = _fold_padding(o, m, l, min(want, padded) - s)
    return o, m, l


def _fold_padding(o, m, l, extra):
    """Fold ``extra`` positions of score 0 and value 0 into (o, m, l):
    m' = max(m, 0), l' = l exp(m - m') + extra exp(-m'), o' = o exp(m - m').
    ``extra`` is an int or an integer tensor (converted to fp32 exactly)."""
    if isinstance(extra, torch.Tensor):
        extra = extra.to(torch.float32)
    m_new = torch.clamp_min(m, 0.0)
    alpha = torch.exp(m - m_new)
    return o * alpha, m_new, l * alpha + extra * torch.exp(-m_new)


def decode_attention(q, k, v, kv_len, block_s: int = 512) -> torch.Tensor:
    """Single-token GQA decode attention over a (possibly padded) KV cache:
    q (B, H, D), k/v (B, S, Hkv, D) -> (B, H, D) in q's dtype."""
    o, _, l = decode_attention_stats(q, k, v, kv_len, block_s)
    out = o / torch.clamp_min(l, 1e-30)
    return out.reshape(q.shape).to(q.dtype)
