"""Operator / preconditioner setup cache (counterpart of
``repro/serve/cache.py``, DESIGN.md §11).

Production solve traffic is repetitive: many right-hand sides against few
operators.  The expensive per-operator setup — probing + factorizing the
block-Jacobi preconditioner (``BlockJacobi.from_operator`` costs
``n_colors * block_size`` operator applications plus ``nb`` dense
inversions), estimating spectral bounds for the Chebyshev shift schedule —
must be paid once per *operator*, not once per request.  The cache keys on
a content fingerprint of the operator (type + dataclass fields, arrays
hashed by bytes), so two structurally identical operators share one setup
even when they are distinct Python objects.
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.core.chebyshev import shifts_for_operator
# The content hash the partition memo keys on (dataclass fields, tensors
# and arrays by shape, dtype and bytes), shared so both caches agree.
from repro_torch.linalg.partition import operator_fingerprint
from repro_torch.linalg.preconditioners import BlockJacobi, JacobiPrec
from repro_torch.obs.metrics import MetricsRegistry


class SetupCache:
    """Memoizes per-operator solver setup keyed by operator fingerprint.

    Hit/miss accounting lives on a :class:`MetricsRegistry`
    (``SolverService`` passes its own so the cache shares the serve
    registry); ``hits``/``misses`` are read-only views of it.
    """

    def __init__(self, registry: MetricsRegistry | None = None):
        self._store: dict[tuple, Any] = {}
        self.registry = MetricsRegistry() if registry is None else registry
        m = self.registry
        self._c_hits = m.counter(
            "serve_setup_cache_hits_total",
            "operator setups served from the fingerprint cache",
            label_names=("kind",))
        self._c_misses = m.counter(
            "serve_setup_cache_misses_total",
            "operator setups built (cache miss)", label_names=("kind",))

    @property
    def hits(self) -> int:
        return int(sum(v[0] for v in self._c_hits.series().values()))

    @property
    def misses(self) -> int:
        return int(sum(v[0] for v in self._c_misses.series().values()))

    def get(self, kind: str, key: tuple, builder: Callable[[], Any]) -> Any:
        k = (kind, *key)
        if k in self._store:
            self._c_hits.labels(kind=kind).inc()
            return self._store[k]
        self._c_misses.labels(kind=kind).inc()
        val = builder()
        self._store[k] = val
        return val

    # ------------------------------------------------- cached setups ----
    def block_jacobi(self, op, block_size: int) -> BlockJacobi:
        # from_operator picks the right coupling reach per operator type
        # (stencils: block_size; SparseOp: measured bandwidth).
        fp = operator_fingerprint(op)
        return self.get("block_jacobi", (fp, block_size),
                        lambda: BlockJacobi.from_operator(op, block_size))

    def jacobi(self, op) -> JacobiPrec:
        fp = operator_fingerprint(op)
        return self.get("jacobi", (fp,),
                        lambda: JacobiPrec.from_operator(op))

    def partition(self, op, n_shards: int):
        """Partition plan of an unstructured operator (DESIGN.md §12):
        RCM ordering + send/recv index-set construction is setup-time
        numpy work on the same once-per-operator footing as the
        block-Jacobi factorization.  Keyed by operator fingerprint +
        shard count, and shared with the module-level memo the
        distributed path uses directly
        (``repro_torch.linalg.partition.plan_for``), so a solve that
        already partitioned the operator is a hit here and vice versa."""
        from repro_torch.linalg.partition import plan_for

        fp = operator_fingerprint(op)
        return self.get("partition", (fp, n_shards),
                        lambda: plan_for(op, n_shards))

    def sigmas(self, op, l: int, prec=None):
        """Chebyshev shift schedule — for the PRECONDITIONED operator when
        ``prec`` is given (the basis polynomial acts on M^{-1}A; shifts
        from the bare spectrum would be mis-scaled and break the basis
        down)."""
        fp = operator_fingerprint(op)
        pfp = None if prec is None else operator_fingerprint(prec)
        return self.get("sigmas", (fp, pfp, l),
                        lambda: shifts_for_operator(op, l, prec=prec))

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._store)}
