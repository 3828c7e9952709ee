"""Reduction-backend registry (only ``local`` is ported so far)."""

from __future__ import annotations

from repro_torch.parallel.backends.base import METHODS, ReductionBackend
from repro_torch.parallel.backends.local import LocalBackend

_REGISTRY: dict[str, type[ReductionBackend]] = {
    LocalBackend.name: LocalBackend,
}


def available_backends() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def get_backend(name: str, **kwargs) -> ReductionBackend:
    if name in ("shard_map", "multiprocess"):
        raise NotImplementedError(
            f"backend {name!r} is not ported yet (ROADMAP.md, queue 1 "
            "item 5: one torch.distributed backend)")
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown reduction backend {name!r}; "
                         f"available: {', '.join(_REGISTRY)}") from None
    return cls(**kwargs)


__all__ = ["METHODS", "ReductionBackend", "LocalBackend",
           "available_backends", "get_backend"]
