"""Shared building blocks of the LM side path (the port's counterpart of
``repro/models/common.py``): norms, MLPs, rotary embeddings, embeddings,
the loss.

Where torch's defaults differ from JAX's, the JAX form is the one kept:
``jnp.var`` is the population variance (``correction=0`` here),
``jax.nn.gelu`` is the tanh approximation, and ``.astype(x.dtype)`` is
``.to(x.dtype)``, which returns the tensor itself when the dtypes already
match (no weight is copied on a call).  Initializers draw from an explicit
``torch.Generator``; their shapes, dtypes and scales are the JAX
package's, their values are not (the tests carry JAX's weights across
with ``repro_torch.convert.lm_params``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def normal(gen: torch.Generator, shape, dtype, std: float,
           device=None) -> torch.Tensor:
    """N(0, std²) of ``shape`` drawn from ``gen`` on its own device, then
    placed on ``device`` (``gen``'s when None); scaled in place, so a
    large leaf is never held twice on the generator's device."""
    t = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
    t.mul_(std)
    return t if device is None else t.to(device)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def apply_norm(cfg, x, p):
    if cfg.norm == "rms":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p.get("bias"))


def norm_params(cfg, d, dtype, device=None):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if cfg.norm == "layer":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


# ------------------------------------------------------------------ MLP ---

def mlp_params(gen, d_model, d_ff, act, dtype, bias=False, out_scale=1.0,
               device=None):
    std = 0.02
    p = {"wi": normal(gen, (d_model, d_ff), dtype, std, device)}
    if act == "swiglu":
        p["wg"] = normal(gen, (d_model, d_ff), dtype, std, device)
    p["wo"] = normal(gen, (d_ff, d_model), dtype, std * out_scale, device)
    if bias:
        p["bi"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["bo"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def mlp_apply(p, x, act: str):
    h = x @ p["wi"].to(x.dtype)
    if "bi" in p:
        h = h + p["bi"].to(x.dtype)
    if act == "swiglu":
        h = F.silu(h) * (x @ p["wg"].to(x.dtype))
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        h = F.relu(h)
    out = h @ p["wo"].to(x.dtype)
    if "bo" in p:
        out = out + p["bo"].to(x.dtype)
    return out


# ---------------------------------------------------------------- rotary --

def _inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor) -> tuple:
    """positions (..., T) -> cos/sin (..., T, head_dim//2) in f32."""
    inv = _inv_freq(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D); cos/sin (B, T, half) or (T, half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mrope_freqs(head_dim: int, theta: float, pos3: torch.Tensor,
                sections) -> tuple:
    """M-RoPE (qwen2-vl): pos3 (B, 3, T) = (t, h, w) position ids; the
    half-dim frequency bands are split into ``sections`` (sum =
    head_dim//2), each band rotated by its own coordinate."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} do not sum to {half}")
    inv = _inv_freq(head_dim, theta, pos3.device)
    ang = pos3.float()[..., None] * inv                    # (B, 3, T, half)
    pieces_c, pieces_s = [], []
    start = 0
    for axis, sec in enumerate(sections):
        a = ang[:, axis, :, start:start + sec]
        pieces_c.append(torch.cos(a))
        pieces_s.append(torch.sin(a))
        start += sec
    return torch.cat(pieces_c, -1), torch.cat(pieces_s, -1)


def text_pos3(positions: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, 3, T): text tokens use t = h = w = pos (qwen2-vl)."""
    return positions[:, None, :].expand(positions.shape[0], 3,
                                        positions.shape[1])


# ------------------------------------------------------------- embedding --

def embed_params(gen, vocab_padded, d_model, dtype, device=None):
    return {"table": normal(gen, (vocab_padded, d_model), dtype, 0.02,
                            device)}


def embed_lookup(p, tokens):
    return p["table"][tokens]


def unembed(p, x):
    """Logits (B, T, Vp). Vocab-padded entries are masked by the loss."""
    return x @ p["table"].to(x.dtype).T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Mean CE over all positions; padded vocab tail masked out (the value
    only: no gradient is taken in the port yet)."""
    vp = logits.shape[-1]
    logits = logits.float()
    if vp > vocab:
        logits = torch.cat([logits[..., :vocab],
                            logits[..., vocab:] + (-1e30)], dim=-1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
