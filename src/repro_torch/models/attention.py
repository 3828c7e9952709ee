"""Single-token decode attention and the split-KV merge (counterparts of
``repro/models/attention.py``'s ``decode_attention_jnp`` and
``merge_decode_shards``): :func:`merge_decode_shards` merges the shards'
statistics held in one process, or, given a wire, each rank's own over a
``torch.distributed`` group.  The rest of the JAX module
(prefill, flash attention, the model's decode step) is not ported yet."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.ref import NEG_FILL


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

