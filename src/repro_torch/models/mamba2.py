"""Mamba2 (SSD) block, the zamba2-2.7b backbone (the port's counterpart of
``repro/models/mamba2.py``).

State-space recurrence per head (P = head channels, N = ssm_state):

    S_t = a_t · S_{t-1} + dt_t · (x_t ⊗ B_t)        a_t = exp(-dt_t·exp(A_log))
    y_t = S_t · C_t + D ⊙ x_t

The sequence form is a Python loop over time (the JAX package's
``lax.scan``); decode carries S and the convolution's last CONV_W - 1
inputs, O(1) state a token.  ``jax.nn.softplus`` is ``logaddexp(x, 0)``,
kept here in that form (``F.softplus`` switches to x past 20).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm

CONV_W = 4


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba2_params(gen, cfg, dtype, out_scale=1.0, device=None):
    d = cfg.d_model
    d_in = 2 * d
    n = cfg.ssm_state
    hp = cfg.ssm_head_dim
    h = d_in // hp
    std = 0.02

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        # fused input projection: [z, x, B, C, dt]
        "w_in": cm.normal(gen, (d, 2 * d_in + 2 * n + h), dtype, std, device),
        "conv_x": cm.normal(gen, (CONV_W, d_in), dtype, std, device),
        "conv_b": cm.normal(gen, (CONV_W, n), dtype, std, device),
        "conv_c": cm.normal(gen, (CONV_W, n), dtype, std, device),
        "a_log": const((h,), 0.0),
        "dt_bias": const((h,), 0.0),
        "d_skip": const((h,), 1.0),
        "norm": const((d_in,), 1.0),
        "w_out": cm.normal(gen, (d_in, d), dtype, std * out_scale, device),
    }


def _causal_conv(x, w):
    """Depthwise causal conv: x (B, T, C), w (W, C)."""
    xs = F.pad(x, (0, 0, CONV_W - 1, 0))
    out = xs[:, 0:x.shape[1]] * w[0][None, None, :]
    for i in range(1, CONV_W):
        out = out + xs[:, i:i + x.shape[1]] * w[i][None, None, :]
    return F.silu(out)


def _split_in(cfg, proj):
    d_in = 2 * cfg.d_model
    n = cfg.ssm_state
    h = d_in // cfg.ssm_head_dim
    return torch.split(proj, [d_in, d_in, n, n, h], dim=-1)


def mamba2_apply(p, cfg, x, return_state: bool = False):
    """Training/prefill pass.  x (B, T, D) -> (B, T, D)
    (+ decode-ready state when ``return_state``)."""
    b, t, d = x.shape
    d_in = 2 * d
    hp = cfg.ssm_head_dim
    h = d_in // hp

    proj = x @ p["w_in"].to(x.dtype)
    z, xi, bm, cmat, dt = _split_in(cfg, proj)
    xbc_raw = torch.cat([xi, bm, cmat], dim=-1)         # pre-conv history
    xi = _causal_conv(xi, p["conv_x"].to(x.dtype))
    bm = _causal_conv(bm, p["conv_b"].to(x.dtype))
    cmat = _causal_conv(cmat, p["conv_c"].to(x.dtype))

    dt = softplus(dt.float() + p["dt_bias"].float())
    a = torch.exp(-dt * torch.exp(p["a_log"].float()))              # (B,T,H)
    xh = xi.reshape(b, t, h, hp).float()
    bm32, cm32 = bm.float(), cmat.float()

    s = torch.zeros((b, h, hp, cfg.ssm_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for i in range(t):
        s = s * a[:, i, :, None, None] + (
            dt[:, i, :, None, None] * xh[:, i, ..., None]
            * bm32[:, i, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", s, cm32[:, i]))
    y = torch.stack(ys, dim=1)                                      # (B,T,H,P)
    y = y + p["d_skip"].float()[None, None, :, None] * xh
    y = y.reshape(b, t, d_in).to(x.dtype)
    y = cm.rms_norm(y * F.silu(z), p["norm"])
    out = y @ p["w_out"].to(x.dtype)
    if not return_state:
        return out
    pad = torch.zeros((b, max(CONV_W - 1 - t, 0), xbc_raw.shape[-1]),
                      dtype=x.dtype, device=x.device)
    conv_hist = torch.cat([pad, xbc_raw[:, -(CONV_W - 1):]], dim=1)
    return out, {"ssm": s, "conv": conv_hist}


def mamba2_init_state(cfg, batch, dtype=torch.float32, device=None):
    d_in = 2 * cfg.d_model
    h = d_in // cfg.ssm_head_dim
    return {
        "ssm": torch.zeros((batch, h, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_W - 1, d_in + 2 * cfg.ssm_state),
                            dtype=dtype, device=device),
    }


def mamba2_decode(p, cfg, x, state):
    """One-token step.  x (B, 1, D) -> ((B, 1, D), new_state)."""
    b, _, d = x.shape
    d_in = 2 * d
    n = cfg.ssm_state
    hp = cfg.ssm_head_dim
    h = d_in // hp

    proj = x @ p["w_in"].to(x.dtype)
    z, xi, bm, cmat, dt = _split_in(cfg, proj)
    xbc = torch.cat([xi, bm, cmat], dim=-1)[:, 0]                   # (B, C)
    hist = torch.cat([state["conv"], xbc[:, None]], dim=1)          # (B, W, C)
    wfull = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]],
                      dim=-1).to(x.dtype)
    conv = F.silu(torch.einsum("bwc,wc->bc", hist, wfull))
    xi, bm, cmat = torch.split(conv, [d_in, n, n], dim=-1)

    dt = softplus(dt[:, 0].float() + p["dt_bias"].float())          # (B, H)
    a = torch.exp(-dt * torch.exp(p["a_log"].float()))
    xh = xi.reshape(b, h, hp).float()
    s = state["ssm"] * a[:, :, None, None] + (
        dt[:, :, None, None] * xh[..., None]
        * bm.float()[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", s, cmat.float())
    y = y + p["d_skip"].float()[None, :, None] * xh
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = cm.rms_norm(y * F.silu(z), p["norm"])
    out = y @ p["w_out"].to(x.dtype)
    return out, {"ssm": s, "conv": hist[:, 1:]}
