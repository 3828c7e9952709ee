"""Mixture-of-Experts FFN (the port's counterpart of
``repro/models/moe.py``: GShard-style capacity dispatch).

Covers both MoE flavours of the registry:
  arctic-480b    : 128 experts, top-2, PLUS a dense-FFN residual branch
  deepseek-moe   : 64 fine-grained routed experts top-6 PLUS 2 shared
                   (always-on) experts

Dispatch is the capacity-based einsum formulation (no sorting or
gather): top-k masks -> position-in-expert by cumsum -> one-hot capacity
slot -> dispatch/combine einsums.  Tokens over capacity are dropped (the
residual passes them through), GShard's semantics.  The routing is
discrete, so the masks are built from exact 0/1 arithmetic and a one-hot
by comparison with ``arange(C)`` (``jax.nn.one_hot`` of an index >= C is a
zero row; ``F.one_hot`` would raise or widen).

The JAX module's ``CONSTRAIN_EP`` (expert-parallel sharding constraints
on a TPU mesh) has no meaning on one card and is left out: the experts'
products run unsharded.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm

GROUP_SIZE = 1024        # tokens per dispatch group (GShard "S")


def moe_params(gen, cfg, dtype, out_scale=1.0, device=None):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    std = 0.02
    p = {
        "router": cm.normal(gen, (d, e), dtype, std, device),
        "wi": cm.normal(gen, (e, d, f), dtype, std, device),
        "wg": cm.normal(gen, (e, d, f), dtype, std, device),
        "wo": cm.normal(gen, (e, f, d), dtype, std * out_scale, device),
    }
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        p["shared"] = cm.mlp_params(gen, d, fs, "swiglu", dtype,
                                    out_scale=out_scale, device=device)
    if cfg.dense_residual:
        fd = cfg.dense_ff or f
        p["dense"] = cm.mlp_params(gen, d, fd, "swiglu", dtype,
                                   out_scale=out_scale, device=device)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a zero row where idx is outside [0, n)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _top_k_dispatch(probs: torch.Tensor, k: int, capacity: int):
    """probs (G, S, E) -> (dispatch, combine) both (G, S, E, C).

    Position-in-expert via per-GROUP cumsum (GShard top-2 generalized to
    top-k by sequential choice peeling)."""
    g, s, e = probs.shape
    remaining = probs
    fill = torch.zeros((g, e), dtype=torch.int32, device=probs.device)
    dispatch = torch.zeros((g, s, e, capacity), dtype=probs.dtype,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)                # (G, S)
        mask = _one_hot(idx, e, probs.dtype)                 # (G, S, E)
        pos = torch.cumsum(mask, dim=1) - mask + fill[:, None, :]
        in_cap = pos < capacity
        mask_kept = mask * in_cap
        slot = _one_hot((pos * mask).sum(-1).to(torch.int32), capacity,
                        probs.dtype)                         # (G, S, C)
        sel = mask_kept[..., None] * slot[:, :, None, :]     # (G, S, E, C)
        gate = (probs * mask).sum(-1, keepdim=True)          # (G, S, 1)
        dispatch = dispatch + sel
        combine = combine + sel * gate[..., None]
        fill = fill + mask_kept.sum(1).to(torch.int32)
        remaining = remaining * (1.0 - mask)
    return dispatch, combine


def moe_apply(p, cfg, x):
    """x (B, T, D) -> (out (B, T, D), aux_loss scalar)."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n = b * t
    sg = min(GROUP_SIZE, n)
    if n % sg:
        raise ValueError(f"{n} tokens do not split into dispatch groups of "
                         f"{sg}")
    ng = n // sg
    xg = x.reshape(ng, sg, d)

    logits = (xg @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                    # (G, S, E)

    # load-balance aux loss (Switch/GShard): E * sum_e(frac_e * prob_e),
    # averaged over groups; == 1 exactly at perfect balance
    top1 = _one_hot(torch.argmax(probs, -1), e, torch.float32)
    aux = e * (top1.mean(dim=1) * probs.mean(dim=1)).sum(dim=-1).mean()

    capacity = max(int(cfg.capacity_factor * k * sg / e), 4)
    dispatch, combine = _top_k_dispatch(probs.to(x.dtype), k, capacity)

    # The experts' products as batched matmuls over E on an (E, G·C, D)
    # operand, so the (E, D, F) weights are read in place, never copied
    # (at arctic's width one of them is 17.8 GB).
    xe = torch.einsum("gsd,gsec->gecd", xg, dispatch)
    xe = xe.transpose(0, 1).reshape(e, ng * capacity, d)
    h = torch.matmul(xe, p["wi"].to(x.dtype))
    gt = torch.matmul(xe, p["wg"].to(x.dtype))
    h = F.silu(h) * gt
    ye = torch.matmul(h, p["wo"].to(x.dtype))
    ye = ye.reshape(e, ng, capacity, d).transpose(0, 1)      # (G, E, C, D)
    out = torch.einsum("gecd,gsec->gsd", ye, combine)

    if "shared" in p:
        out = out + cm.mlp_apply(p["shared"], xg, "swiglu")
    if "dense" in p:
        out = out + cm.mlp_apply(p["dense"], xg, "swiglu")
    return out.reshape(b, t, d), aux
