"""GQA attention of the LM side path (the port's counterpart of
``repro/models/attention.py``): prefill and training attention (blocked
causal flash, exact T²/2 work), single-token decode over a KV cache, and
the split-KV merge of decode statistics.

Decode attention dispatches by device: on a CUDA tensor it launches the
hand-written split-KV kernel (``kernels.ops.decode_attention``,
``csrc/decode_attention.cu``), on a CPU tensor it runs
:func:`decode_attention_torch`, the plain form of the JAX package's
``decode_attention_jnp``.  ``plain=True`` is the one way to run the plain
form on the card (for holding the kernel against it); a kernel that cannot
build or launch raises.

The cache is written in place, one position a step, at ``min(pos, S - 1)``,
and attended over its first ``min(pos + 1, S)`` positions, both as device
tensors: JAX's ``dynamic_update_slice`` clamps its start the same way and
``decode_attention_jnp`` counts all S positions once ``kv_len`` passes S,
so the three agree one step past the end, and a decode step reads no
value back to the host.

The JAX module's ``DECODE_UPCAST`` (the port upcasts, JAX's default),
``SPLIT_KV_AXIS`` and ``split_kv_decode`` (mesh knobs of the TPU dry-run)
have no counterpart here: a split over ranks merges through
:func:`merge_decode_shards` with a wire.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_FILL
from repro_torch.models import common as cm


def attn_params(gen, cfg, d_model=None, dtype=torch.float32, out_scale=1.0,
                device=None):
    d = d_model or cfg.d_model
    hd, h, hkv = cfg.hd, cfg.n_heads, cfg.n_kv
    std = 0.02
    p = {
        "wq": cm.normal(gen, (d, h * hd), dtype, std, device),
        "wk": cm.normal(gen, (d, hkv * hd), dtype, std, device),
        "wv": cm.normal(gen, (d, hkv * hd), dtype, std, device),
        "wo": cm.normal(gen, (h * hd, d), dtype, std * out_scale, device),
    }
    if cfg.bias:
        for name, n in (("bq", h * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def qkv(p, cfg, x):
    b, t, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, t, h, hd)
    k = k.reshape(b, t, hkv, hd)
    v = v.reshape(b, t, hkv, hd)
    if cfg.qk_norm:
        q = cm.rms_norm(q, p["q_norm"])
        k = cm.rms_norm(k, p["k_norm"])
    return q, k, v


# ------------------------------------------------- blocked causal attn ----

def _block_attn(q, k, v, *, causal_offset=None):
    """q (B,Hkv,G,Tq,D), k/v (B,Hkv,Tk,D) -> (out, m, l) online-softmax
    stats.  causal_offset: (q_start, k_start) for the causal mask, or None
    (full)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhgqd,bhkd->bhgqk", q, k).float() * scale
    if causal_offset is not None:
        q0, k0 = causal_offset
        qi = q0 + torch.arange(q.shape[3], device=q.device)
        ki = k0 + torch.arange(k.shape[2], device=q.device)
        s = torch.where(qi[:, None] >= ki[None, :], s, NEG_FILL)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p.to(q.dtype), v)
    return out, m[..., 0], l[..., 0]


def flash_attention(
    q: torch.Tensor,            # (B, T, H, D)
    k: torch.Tensor,            # (B, Tk, Hkv, D)
    v: torch.Tensor,
    causal: bool = True,
    q_block: int = 512,
    kv_block: int = 512,
) -> torch.Tensor:
    """Memory-efficient exact attention, the JAX package's blocking: a
    loop over query blocks, each scanning only its causally visible KV
    blocks with an online softmax; padded keys are masked by the causal
    offset or, without it, by an explicit length mask."""
    b, t, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    q_block = min(q_block, t)
    kv_block = min(kv_block, tk)
    tp = ((t + q_block - 1) // q_block) * q_block
    tkp = ((tk + kv_block - 1) // kv_block) * kv_block
    qp = F.pad(q, (0, 0, 0, 0, 0, tp - t))
    kp = F.pad(k, (0, 0, 0, 0, 0, tkp - tk))
    vp = F.pad(v, (0, 0, 0, 0, 0, tkp - tk))

    qg = qp.reshape(b, tp, hkv, g, d).permute(0, 2, 3, 1, 4)
    kg = kp.permute(0, 2, 1, 3)                     # (B, Hkv, Tk, D)
    vg = vp.permute(0, 2, 1, 3)
    scale = 1.0 / math.sqrt(d)

    outs = []
    for q0 in range(0, tp, q_block):
        qblk = qg[:, :, :, q0:q0 + q_block]
        # causally visible KV prefix for this query block
        k_hi = min(tkp, ((q0 + q_block + kv_block - 1) // kv_block)
                   * kv_block) if causal else tkp
        acc = torch.zeros((b, hkv, g, q_block, d), dtype=q.dtype,
                          device=q.device)
        m_run = torch.full((b, hkv, g, q_block), NEG_FILL,
                           dtype=torch.float32, device=q.device)
        l_run = torch.zeros((b, hkv, g, q_block), dtype=torch.float32,
                            device=q.device)
        for k0 in range(0, k_hi, kv_block):
            kblk = kg[:, :, k0:k0 + kv_block]
            vblk = vg[:, :, k0:k0 + kv_block]
            if causal:
                o, m_new, l_new = _block_attn(qblk, kblk, vblk,
                                              causal_offset=(q0, k0))
            else:
                s = torch.einsum("bhgqd,bhkd->bhgqk", qblk,
                                 kblk).float() * scale
                valid = (k0 + torch.arange(kv_block, device=q.device)) < tk
                s = torch.where(valid, s, NEG_FILL)
                m_new = s.amax(dim=-1)
                pw = torch.exp(s - m_new[..., None])
                l_new = pw.sum(dim=-1)
                o = torch.einsum("bhgqk,bhkd->bhgqd", pw.to(qblk.dtype),
                                 vblk)
            m_tot = torch.maximum(m_run, m_new)
            a_old = torch.exp(m_run - m_tot)
            a_new = torch.exp(m_new - m_tot)
            acc = acc * a_old[..., None].to(acc.dtype) \
                + o * a_new[..., None].to(o.dtype)
            l_run = l_run * a_old + l_new * a_new
            m_run = m_tot
        outs.append(acc / torch.clamp_min(l_run, 1e-30)[..., None]
                    .to(acc.dtype))

    out = torch.cat(outs, dim=3)                     # (B, Hkv, G, Tp, D)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, tp, h, d)
    return out[:, :t]


def attention_train(p, cfg, x, cos_sin=None, kv_override=None, causal=True):
    """Full attention sub-block: qkv -> rope -> flash -> out proj.
    kv_override: (k, v) from the encoder for cross-attention."""
    b, t, _ = x.shape
    q, k, v = qkv(p, cfg, x)
    if kv_override is not None:
        k, v = kv_override
    if cos_sin is not None:
        cos, sin = cos_sin
        q = cm.apply_rope(q, cos, sin)
        if kv_override is None:
            k = cm.apply_rope(k, cos, sin)
    o = flash_attention(q, k, v, causal=causal)
    return o.reshape(b, t, -1) @ p["wo"].to(x.dtype)


# -------------------------------------------------------------- decode ----

def decode_attention_torch(q, k_cache, v_cache, kv_len):
    """One-token GQA decode in plain PyTorch, the cache operands upcast to
    fp32 before the products (the JAX package's ``DECODE_UPCAST = True``).
    q (B, H, D); caches (B, S, Hkv, D); kv_len the valid prefix length.
    Returns (B, H, D) in q's dtype."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d)
    scale = 1.0 / math.sqrt(d)
    s_ = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) * scale
    mask = torch.arange(s, device=q.device) < kv_len
    s_ = torch.where(mask[None, None, None, :], s_, NEG_FILL)
    w = torch.softmax(s_, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", w, v_cache.float())
    return o.reshape(b, h, d).to(q.dtype)


def merge_decode_shards(o, m, l, wire=None):
    """Split-KV combine of P shards' unnormalized decode statistics.

    Without ``wire``, held in one process: o (P, ..., D), m and l
    (P, ..., 1), each shard's stats stacked on the leading axis; one max and
    one sum over the shards, each a left-to-right chain in shard order, as
    the JAX package's one pmax and one fused psum of [o * scale,
    l * scale].  With ``wire`` (``repro_torch.parallel.wire.Wire``), one
    shard per rank: o (..., D), m and l (..., 1) are this rank's (from
    ``kernels.ops.decode_attention_stats`` on its part of the cache), and
    every rank gets the merged output from one ``all_reduce(MAX)`` of m
    and one ``all_reduce(SUM)`` of [o * scale, l * scale].  Returns the
    normalized (..., D) output."""
    d = o.shape[-1]
    if wire is not None:
        import torch.distributed as dist

        m_glob = wire.all_reduce(m.clone(), op=dist.ReduceOp.MAX)
        scale = torch.exp(m - m_glob)
        num_den = wire.all_reduce(torch.cat([o * scale, l * scale], dim=-1))
        return num_den[..., :d] / torch.clamp_min(num_den[..., d:], 1e-30)
    m_glob = m[0]
    for p in range(1, m.shape[0]):
        m_glob = torch.maximum(m_glob, m[p])
    scale = torch.exp(m - m_glob)
    num_den = torch.cat([o * scale, l * scale], dim=-1)
    total = num_den[0]
    for p in range(1, num_den.shape[0]):
        total = total + num_den[p]
    return total[..., :d] / torch.clamp_min(total[..., d:], 1e-30)


def decode_attention(q, k_cache, v_cache, kv_len, plain: bool = False):
    """One-token GQA decode over a padded cache: the hand-written kernel
    on a CUDA tensor, :func:`decode_attention_torch` on a CPU tensor or
    when ``plain``.  q (B, H, D); caches (B, S, Hkv, D), contiguous for the
    kernel; kv_len an int or a one-element integer tensor on the cache's
    device, in [0, S].  Returns (B, H, D) in q's dtype."""
    if plain or q.device.type == "cpu":
        return decode_attention_torch(q, k_cache, v_cache, kv_len)
    return kops.decode_attention(q, k_cache, v_cache, kv_len)


def cache_attend(q, k, v, k_cache, v_cache, pos, plain: bool = False):
    """Write one token's k/v (B, 1, Hkv, D) into the caches (B, S, Hkv, D)
    in place at ``min(pos, S - 1)`` and attend q (B, H, D) over the first
    ``min(pos + 1, S)`` positions; ``pos`` a 0-d integer tensor on the
    cache's device (no host read)."""
    s = k_cache.shape[1]
    slot = pos.clamp(0, s - 1).reshape(1).long()
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))
    return decode_attention(q, k_cache, v_cache, (pos + 1).clamp_max(s),
                            plain=plain)


def decode_step(p, cfg, x, k_cache, v_cache, pos, cos_sin,
                plain: bool = False):
    """Append one token to the cache and attend.  x (B, 1, D); pos a 0-d
    integer tensor.  Returns (out (B, 1, D), k_cache, v_cache), the caches
    written in place."""
    b = x.shape[0]
    q, k, v = qkv(p, cfg, x)                        # (B,1,H,D)/(B,1,Hkv,D)
    cos, sin = cos_sin
    q = cm.apply_rope(q, cos, sin)
    k = cm.apply_rope(k, cos, sin)
    o = cache_attend(q[:, 0], k, v, k_cache, v_cache, pos, plain)
    out = o.reshape(b, 1, -1) @ p["wo"].to(x.dtype)
    return out, k_cache, v_cache
