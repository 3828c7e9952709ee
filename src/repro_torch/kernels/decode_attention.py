"""Split-KV decode attention kernel (``csrc/decode_attention.cu``), the
counterpart of the Pallas kernel ``decode_attention_stats`` in
``repro/kernels/decode_attention.py``.

``decode_attention_stats(q, k, v, kv_len, block_s)`` takes the grouped
query q (B, Hkv, G, D) and the cache k/v in the callers' (B, S, Hkv, D)
layout, fp32 or bf16, and returns ``(o_unnorm, m, l)`` in fp32 with the
Pallas kernel's shapes (B, Hkv, G, D), (B, Hkv, G, 1), (B, Hkv, G, 1).  On
CUDA tensors it launches the kernel, on CPU tensors it runs the plain
PyTorch version ``decode_attention_stats_plain``; any other device raises.

``block_s`` is the number of cache positions one CUDA block reduces
before the split pass hands its partial (m, l, o) to the merge pass (the
Pallas kernel's sequence block).  It sets how the work is spread over the
card and so the order of the fp32 sums, never which positions count.

``kv_len`` is a host integer or a one-element integer tensor on the
cache's device, in [0, S].  On the card the kernel reads a tensor
``kv_len`` from device memory (no host synchronisation) and gives the
integer path's bits; on the CPU the plain version takes it as it is.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (
    decode_attention_stats_ref as decode_attention_stats_plain)

_SIGS = {
    "decode_attention_launch": (
        [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
        + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]),
}


def _values_per_lane(d: int) -> int:
    """Values of a cache row each of a warp's 32 lanes holds: the smallest
    of 1, 2, 4, 8 with 32 * dpl >= d."""
    for dpl in (1, 2, 4, 8):
        if 32 * dpl >= d:
            return dpl
    raise ValueError(f"head dim {d} > 256 is not supported by the kernel")


def _check_shapes(q, k, v, kv_len, block_s: int) -> None:
    """The argument checks the kernel and the plain version share."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)} must be (B, Hkv, G, D) and k "
                         f"{tuple(k.shape)} (B, S, Hkv, D)")
    b, hkv, _, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, hkv, d):
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v {tuple(v.shape)} differs from k {tuple(k.shape)}")
    if k.shape[1] < 1:
        raise ValueError("empty cache (S = 0)")
    if isinstance(kv_len, torch.Tensor):
        if kv_len.numel() != 1 or kv_len.dtype.is_floating_point \
                or kv_len.dtype == torch.bool:
            raise ValueError(f"a tensor kv_len must be one integer, got "
                             f"{kv_len.dtype} {tuple(kv_len.shape)}")
        if kv_len.device != k.device:
            raise ValueError(f"kv_len is on {kv_len.device}, k on "
                             f"{k.device}")
    elif not 0 <= kv_len <= k.shape[1]:
        raise ValueError(f"kv_len {kv_len} outside [0, S = {k.shape[1]}]")
    if block_s < 1:
        raise ValueError(f"block_s must be positive, got {block_s}")


def _checked_cuda(q, k, v, block_s: int) -> int:
    b, hkv, g, d = q.shape
    if k.dtype not in (torch.float32, torch.bfloat16) or v.dtype != k.dtype:
        raise ValueError(f"cache dtypes {k.dtype}/{v.dtype} (want fp32 or "
                         "bf16, both the same)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != k.device:
            raise ValueError(f"{name} is on {t.device}, k on {k.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    dpl = _values_per_lane(d)
    if d % dpl:
        raise ValueError(f"head dim {d} is not a multiple of {dpl}")
    align = dpl * k.element_size()
    if k.data_ptr() % align or v.data_ptr() % align:
        raise ValueError(f"k/v must be {align}-byte aligned")
    if b * hkv > 65535 or b * hkv * g >= 2 ** 31:
        raise ValueError("B * Hkv too large for the kernel's grid")
    if k.shape[1] + block_s >= 2 ** 31:
        raise ValueError("S too large for the kernel's int positions")
    return dpl


def decode_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kv_len, block_s: int = 512):
    """Unnormalized (o, m, l) of one query token over the first ``kv_len``
    positions of the cache (the split-KV statistics).  A tensor ``kv_len``
    must already lie in [0, S]; it is not read on the host."""
    on_device = isinstance(kv_len, torch.Tensor)
    if not on_device:
        kv_len = int(kv_len)
    _check_shapes(q, k, v, kv_len, block_s)
    if k.device.type == "cpu":
        return decode_attention_stats_plain(q, k, v, kv_len)
    if k.device.type != "cuda":
        raise ValueError(f"no decode_attention for device {k.device}")
    q = q.float().contiguous()
    dpl = _checked_cuda(q, k, v, block_s)
    b, hkv, g, d = q.shape
    s = k.shape[1]
    if on_device:
        kv_dev = kv_len.reshape(1).to(torch.int32)
        kv_len, eff = 0, s             # read from kv_dev by the kernel
    else:
        kv_dev = None
        eff = kv_len if kv_len > 0 else s
    nsplit = -(-eff // block_s)
    o = torch.empty((b, hkv, g, d), dtype=torch.float32, device=k.device)
    m = torch.empty((b, hkv, g, 1), dtype=torch.float32, device=k.device)
    l = torch.empty((b, hkv, g, 1), dtype=torch.float32, device=k.device)
    part = torch.empty(b * hkv * g * nsplit * (d + 2), dtype=torch.float32,
                       device=k.device)
    with torch.cuda.device(k.device):
        rc = _build.load("decode_attention", _SIGS).decode_attention_launch(
            int(k.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), part.data_ptr(), o.data_ptr(), m.data_ptr(),
            l.data_ptr(), b, s, hkv, g, d, kv_len, eff, block_s, nsplit, dpl,
            1.0 / math.sqrt(d), None if kv_dev is None else kv_dev.data_ptr(),
            torch.cuda.current_stream(k.device).cuda_stream)
    _build.LAUNCHES["decode_attention"] += 1
    _build.check(rc, "decode_attention")
    return o, m, l
