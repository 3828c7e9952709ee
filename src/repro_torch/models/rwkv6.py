"""RWKV6 "Finch" block (rwkv6-7b), attention-free with data-dependent
decay (the port's counterpart of ``repro/models/rwkv6.py``).

Time mixing per head (N = head dim, state S is N×N):

    y_t = r_t · (diag(u)·k_t v_tᵀ + S_{t-1})
    S_t = diag(w_t) · S_{t-1} + k_t v_tᵀ          w_t = exp(-exp(w0 + lora(x)))

Token-shift interpolations use the ddlerp form with low-rank adapters.
The sequence form loops over time in Python (the JAX package's
``lax.scan``); decode is the same block on one token, carrying
(S, x_prev): O(1) state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm

LORA_SHIFT = 32
LORA_DECAY = 64


def rwkv6_params(gen, cfg, dtype, out_scale=1.0, device=None):
    d = cfg.d_model
    std = 0.02

    def rnd(shape, scale=1.0):
        return cm.normal(gen, shape, dtype, std * scale, device)

    def const(shape, value):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "mu_base": const((d,), 0.5),
        "lora_a": rnd((d, 5 * LORA_SHIFT)),
        "lora_b": rnd((5, LORA_SHIFT, d)),
        "w0": const((d,), -2.0),
        "wlora_a": rnd((d, LORA_DECAY)),
        "wlora_b": rnd((LORA_DECAY, d)),
        "u": rnd((d,)),                                     # bonus
        "wr": rnd((d, d)),
        "wk": rnd((d, d)),
        "wv": rnd((d, d)),
        "wg": rnd((d, d)),
        "wo": rnd((d, d), out_scale),
        "ln_x": const((d,), 1.0),
        # channel mix
        "mu_ck": const((d,), 0.5),
        "mu_cr": const((d,), 0.5),
        "cm_k": rnd((d, int(3.5 * d))),
        "cm_v": rnd((int(3.5 * d), d), out_scale),
        "cm_r": rnd((d, d)),
        "mu_mix": rnd((5, d)),
    }


def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift: five mixed inputs (r,k,v,g,w)."""
    xx = x_prev - x
    base = x + xx * p["mu_base"].to(x.dtype)
    lo = torch.tanh(base @ p["lora_a"].to(x.dtype))          # (..., 5*R)
    lo = lo.reshape(*lo.shape[:-1], 5, LORA_SHIFT)
    dyn = torch.einsum("...fr,frd->...fd", lo, p["lora_b"].to(x.dtype))
    mu = p["mu_mix"].to(x.dtype) + dyn                       # (..., 5, D)
    return x[..., None, :] + xx[..., None, :] * mu           # (..., 5, D)


def _decay(p, xw):
    lo = torch.tanh(xw @ p["wlora_a"].to(xw.dtype)) \
        @ p["wlora_b"].to(xw.dtype)
    return torch.exp(-torch.exp(torch.clamp(
        p["w0"].float() + lo.float(), -8.0, 2.0)))           # (..., D) in (0,1)


def time_mix(p, cfg, x, x_prev, state):
    """Sequence form.  x (B, T, D); x_prev (B, D) last token of the previous
    chunk; state (B, H, N, N) f32.  Returns (y, x_last, state)."""
    b, t, d = x.shape
    n = cfg.ssm_head_dim if cfg.ssm_head_dim else 64
    h = d // n

    xs = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    mixed = _ddlerp(p, x, xs)                                # (B,T,5,D)
    xr, xk, xv, xg, xw = (mixed[:, :, i] for i in range(5))
    r = (xr @ p["wr"].to(x.dtype)).reshape(b, t, h, n).float()
    k = (xk @ p["wk"].to(x.dtype)).reshape(b, t, h, n).float()
    v = (xv @ p["wv"].to(x.dtype)).reshape(b, t, h, n).float()
    g = F.silu(xg @ p["wg"].to(x.dtype))
    w = _decay(p, xw).reshape(b, t, h, n)                    # f32
    u = p["u"].float().reshape(h, n)

    ys = []
    for i in range(t):
        kv = k[:, i, ..., None] * v[:, i, :, None, :]        # (B,H,N,N)
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, i],
                               u[None, :, :, None] * kv + state))
        state = w[:, i, ..., None] * state + kv
    y = torch.stack(ys, dim=1).reshape(b, t, d)              # f32
    y = cm.rms_norm(y.to(x.dtype), p["ln_x"])                # group-norm stand-in
    y = (y * g) @ p["wo"].to(x.dtype)
    return y, x[:, -1], state


def channel_mix(p, x, x_prev):
    xs = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    xx = xs - x
    xk = x + xx * p["mu_ck"].to(x.dtype)
    xr = x + xx * p["mu_cr"].to(x.dtype)
    kk = torch.square(F.relu(xk @ p["cm_k"].to(x.dtype)))
    return torch.sigmoid(xr @ p["cm_r"].to(x.dtype)) * (
        kk @ p["cm_v"].to(x.dtype)), x[:, -1]


def rwkv6_init_state(cfg, batch, device=None):
    d = cfg.d_model
    n = cfg.ssm_head_dim if cfg.ssm_head_dim else 64
    h = d // n

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"s": zeros(batch, h, n, n), "x_tm": zeros(batch, d),
            "x_cm": zeros(batch, d)}


def rwkv6_block(p, cfg, x, state):
    """Full block (time mix + channel mix) in sequence form."""
    dt = x.dtype
    y, x_tm, s = time_mix(p, cfg, x, state["x_tm"].to(dt), state["s"])
    x = x + y
    y2, x_cm = channel_mix(p, x, state["x_cm"].to(dt))
    return x + y2, {"s": s, "x_tm": x_tm.float(), "x_cm": x_cm.float()}
