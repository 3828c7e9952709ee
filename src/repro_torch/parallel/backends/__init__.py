"""Reduction-backend registry: ``local`` (one device, with the ladder
oracle over virtual shards) and ``multiprocess`` (torch.distributed, one
process per rank; the JAX package's ``shard_map`` and ``multiprocess``
backends in one)."""

from __future__ import annotations

from repro_torch.parallel.backends.base import (BATCHED_OVER_RANKS, METHODS,
                                                ReductionBackend)
from repro_torch.parallel.backends.local import LocalBackend
from repro_torch.parallel.backends.multiprocess import MultiprocessBackend

_REGISTRY: dict[str, type[ReductionBackend]] = {
    LocalBackend.name: LocalBackend,
    MultiprocessBackend.name: MultiprocessBackend,
}


def available_backends() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def get_backend(name: str, **kwargs) -> ReductionBackend:
    """Instantiate a reduction backend by name; ``kwargs`` go to its
    constructor."""
    if name == "shard_map":
        raise ValueError(
            "backend 'shard_map' has no counterpart in the port: one process "
            "per rank is PyTorch's model, so use 'multiprocess' "
            "(torch.distributed, NCCL on the card, gloo on the CPU)")
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown reduction backend {name!r}; "
                         f"available: {', '.join(_REGISTRY)}") from None
    return cls(**kwargs)


__all__ = ["BATCHED_OVER_RANKS", "METHODS", "ReductionBackend", "LocalBackend",
           "MultiprocessBackend", "available_backends", "get_backend"]
