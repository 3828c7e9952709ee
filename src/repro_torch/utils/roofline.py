"""Roofline terms from counted FLOPs and bytes (counterpart of
``repro/utils/roofline.py``).

    compute term    = FLOPs        / (chips x peak FLOP/s)
    memory term     = HBM bytes    / (chips x HBM bytes/s)
    collective term = ring-model wire seconds of the collectives' payload

The JAX package reads FLOPs and bytes from XLA's ``cost_analysis()`` of a
compiled program (its ``cost_analysis_dict``); PyTorch compiles nothing
it could ask, so that function has no counterpart.  The port counts
instead:

* :func:`count_cost` runs a function under a dispatch mode that adds up
  every ATen operation's operands and results (bytes) and its arithmetic
  (FLOPs): the unfused vector phase, one PyTorch operation a pass;
* a CUDA kernel is no ATen operation, so its bytes are its own count:
  the superkernel's least bytes (``kernels/fused_iter.py`` ``min_bytes``),
  the SpMV kernels' byte bounds (``chip_smoke.py``'s ``bound_fields``).

Collective bytes come from ``utils.collectives`` (a rank's ``Wire``), with
the JAX package's ring factors.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Hardware", "HW_H100", "RooflineTerms", "roofline_terms",
           "count_cost", "dense_model_flops", "forward_model_flops"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float        # per chip, FLOP/s
    hbm_bw: float            # per chip, bytes/s
    link_bw: float           # per chip, bytes/s one way
    hbm_per_chip: float      # bytes
    links_per_chip: int = 18


# NVIDIA's H100 SXM datasheet figures, not measurements of this port: fp64
# outside the tensor cores 34 TFLOP/s (the solver's arithmetic), 3.35 TB/s
# of HBM3 (the rate behind every bound in PERF.md), 80 GB, NVLink 4 with
# 18 links and 900 GB/s both ways (450 GB/s one way).  All at the full
# 700 W power limit.
HW_H100 = Hardware(
    name="nvidia-h100-sxm (datasheet)",
    peak_flops=34e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_per_chip=80e9,
    links_per_chip=18,
)

_RING_FACTOR = {
    "all-reduce": lambda n: 2.0 * (n - 1) / max(n, 1),
    "all-gather": lambda n: (n - 1) / max(n, 1),
    "reduce-scatter": lambda n: (n - 1) / max(n, 1),
    "all-to-all": lambda n: (n - 1) / max(n, 1),
    "collective-permute": lambda n: 1.0,
}


@dataclasses.dataclass
class RooflineTerms:
    flops: float             # per-device FLOPs
    hbm_bytes: float         # per-device bytes moved
    coll_bytes: float        # per-device collective payload bytes
    t_compute: float         # seconds
    t_memory: float          # seconds
    t_collective: float      # seconds
    chips: int
    hw: Hardware
    per_kind: dict

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Lower-bound step time if the two non-dominant terms fully
        overlap the dominant one (perfect latency hiding)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def useful_fraction(self, model_flops: float) -> float:
        """MODEL_FLOPS / (FLOPs x chips): the useful share of the counted
        compute."""
        tot = self.flops * self.chips
        return model_flops / tot if tot else float("nan")

    def mfu(self, model_flops: float) -> float:
        """Model-FLOPs utilization at the roofline-bound step time."""
        denom = self.t_bound * self.chips * self.hw.peak_flops
        return model_flops / denom if denom else float("nan")

    def row(self) -> str:
        return (
            f"compute {self.t_compute:.3e}s | memory {self.t_memory:.3e}s | "
            f"collective {self.t_collective:.3e}s | dominant={self.dominant}"
        )


def roofline_terms(cost: dict, collectives: dict | None = None,
                   chips: int = 1, hw: Hardware = HW_H100) -> RooflineTerms:
    """The three terms of one step: ``cost`` holds the per-device
    ``"flops"`` and ``"bytes accessed"`` (the JAX package's cost-analysis
    keys; :func:`count_cost` gives them), ``collectives`` the per-kind
    ``{count, bytes}`` of ``utils.collectives.count_collectives``."""
    flops = float(cost.get("flops", 0.0) or 0.0)
    hbm = float(cost.get("bytes accessed", 0.0) or 0.0)
    per_kind = dict(collectives or {})
    t_coll = 0.0
    coll_bytes = 0.0
    for kind, v in per_kind.items():
        coll_bytes += v["bytes"]
        t_coll += _RING_FACTOR[kind](chips) * v["bytes"] / hw.link_bw
    return RooflineTerms(
        flops=flops,
        hbm_bytes=hbm,
        coll_bytes=coll_bytes,
        t_compute=flops / hw.peak_flops,
        t_memory=hbm / hw.hbm_bw,
        t_collective=t_coll,
        chips=chips,
        hw=hw,
        per_kind=per_kind,
    )


# ATen operations counted as arithmetic: FLOPs per element of the result
# (reductions: per element of the input).
_ELEMENTWISE = {"add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1, "neg": 1,
                "abs": 1, "sqrt": 1, "rsqrt": 1, "reciprocal": 1, "pow": 1,
                "exp": 1, "log": 1, "addcmul": 2, "addcdiv": 2,
                "maximum": 1, "minimum": 1, "clamp": 1}
_REDUCTIONS = {"sum": 1, "mean": 1, "linalg_vector_norm": 2, "dot": 2}


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


def count_cost(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` and count what its ATen operations move
    and compute: returns ``(result, {"flops": F, "bytes accessed": B})``.
    Each operation reads each operand and writes each result once (views
    move nothing); FLOPs are one an element for elementwise arithmetic,
    one an input element for a sum.  A custom CUDA kernel is no ATen
    operation and is not seen."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cost = {"flops": 0.0, "bytes accessed": 0.0}

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if func.is_view:
                return out
            ins = list(_tensors((args, kwargs)))
            outs = list(_tensors(out))
            cost["bytes accessed"] += sum(t.numel() * t.element_size()
                                          for t in ins + outs)
            name = func.overloadpacket.__name__.rstrip("_")
            if name in _ELEMENTWISE and outs:
                cost["flops"] += _ELEMENTWISE[name] * outs[0].numel()
            elif name in _REDUCTIONS and ins:
                cost["flops"] += _REDUCTIONS[name] * ins[0].numel()
            return out

    with _Count():
        result = fn(*args, **kwargs)
    return result, cost


def dense_model_flops(n_params: float, tokens: float) -> float:
    """MODEL_FLOPS = 6·N·D for a training step over D tokens."""
    return 6.0 * n_params * tokens


def forward_model_flops(n_params: float, tokens: float) -> float:
    """2·N·D for inference (prefill/decode) steps."""
    return 2.0 * n_params * tokens
