"""Collective operations and their bytes, counted from what the port has
(counterpart of ``repro/utils/hlo.py``).

The JAX package parses XLA's HLO text for every collective and its tensor
shape (``parse_shape_bytes``, ``_canon_kind``).  A PyTorch program has no
such text: its collectives are calls on a ``torch.distributed`` group, so
the port counts them where they happen instead.

* A rank's ``Wire`` (``parallel/wire.py``) counts its messages and bytes
  sent by kind; :func:`count_collectives` maps them to the JAX kinds
  (``all_reduce`` -> ``all-reduce``, ``gather`` -> ``all-gather``, the
  point-to-point ``halo`` and ladder ``hop`` -> ``collective-permute``),
  the byte convention being the JAX one (a payload counted once).
* A profile holds the NCCL kernels that ran: :func:`profile_collectives`
  counts them by kind with their device µs.  Their payload is not in the
  kernel's record, so bytes come from the wire.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

__all__ = ["WIRE_KINDS", "count_collectives", "collective_bytes",
           "profile_collectives", "CollectiveSummary",
           "summarize_collectives"]

# The Wire's kinds and the JAX package's collective kinds they count as.
WIRE_KINDS = {"all_reduce": "all-reduce", "gather": "all-gather",
              "halo": "collective-permute", "hop": "collective-permute"}

# NCCL kernel-name fragments (``ncclDevKernel_AllReduce_Sum_f64_RING_LL``,
# ``ncclKernel_SendRecv_...``) and their kinds.
_NCCL_KINDS = (("allreduce", "all-reduce"), ("allgather", "all-gather"),
               ("reducescatter", "reduce-scatter"),
               ("alltoall", "all-to-all"), ("sendrecv", "collective-permute"),
               ("send", "collective-permute"), ("recv", "collective-permute"),
               ("broadcast", "broadcast"))


def count_collectives(wire_counts: dict) -> dict[str, dict[str, float]]:
    """Per-kind ``{count, bytes}`` from a ``Wire.counts()`` dict (or any
    dict with ``messages`` and ``bytes_sent`` by wire kind)."""
    out: dict[str, dict[str, float]] = defaultdict(
        lambda: {"count": 0, "bytes": 0})
    msgs = wire_counts.get("messages", {})
    sent = wire_counts.get("bytes_sent", {})
    for kind in set(msgs) | set(sent):
        canon = WIRE_KINDS.get(kind, kind)
        out[canon]["count"] += msgs.get(kind, 0)
        out[canon]["bytes"] += sent.get(kind, 0)
    return dict(out)


def collective_bytes(wire_counts: dict) -> int:
    """Total collective payload bytes (all kinds)."""
    return int(sum(v["bytes"]
                   for v in count_collectives(wire_counts).values()))


def profile_collectives(prof) -> dict[str, dict[str, float]]:
    """Per-kind ``{count, device_us}`` of the NCCL kernels in a profile
    (a ``torch.profiler.profile``, an exported Chrome trace or its dict)."""
    from repro_torch.utils.trace import device_kernels

    out: dict[str, dict[str, float]] = defaultdict(
        lambda: {"count": 0, "device_us": 0.0})
    for k in device_kernels(prof):
        name = k["name"].lower()
        if "nccl" not in name:
            continue
        kind = next((v for frag, v in _NCCL_KINDS
                     if frag in name.replace("_", "")), "other")
        out[kind]["count"] += 1
        out[kind]["device_us"] += k["dur"]
    return dict(out)


@dataclasses.dataclass
class CollectiveSummary:
    per_kind: dict[str, dict[str, float]]

    @property
    def total_bytes(self) -> int:
        return int(sum(v["bytes"] for v in self.per_kind.values()))

    @property
    def total_count(self) -> int:
        return int(sum(v["count"] for v in self.per_kind.values()))

    def __str__(self) -> str:
        rows = [
            f"  {k:<20s} count={int(v['count']):5d} bytes={v['bytes']:.3e}"
            for k, v in sorted(self.per_kind.items())
        ]
        return "\n".join(rows) if rows else "  (no collectives)"


def summarize_collectives(wire_counts: dict) -> CollectiveSummary:
    return CollectiveSummary(per_kind=count_collectives(wire_counts))
