"""repro_torch.serve — continuous-batching multi-RHS solver service
(counterpart of ``repro/serve``, DESIGN.md §11/§15), on one device through
``LocalBackend``.

The serving layer over the batched CG family: a request queue +
admission layer buckets (operator, b, tol, deadline) traffic, a
multi-slab work-stealing scheduler packs it into fixed-width slabs —
refilling retired slots at every chunk boundary so utilization stays
high mid-flight — each slab steps with ONE amortized (K, s) global
reduction per iteration, deadline-expired work is shed before it wastes
a slot, and a fingerprint-keyed setup cache makes repeat operators skip
their block-Jacobi / shift setup.  Every timestamp flows through an
injectable clock, so the whole scheduler is deterministic under the
open-loop traffic-replay harness (``repro_torch.serve.replay``).

    from repro_torch.parallel.backends import get_backend
    from repro_torch.serve import AdmissionPolicy, SolverService

    svc = SolverService(get_backend("local"),     # device="cpu" for the CPU
                        s=8, method="plcg", l=2, prec="jacobi",
                        max_replicas=2,
                        admission=AdmissionPolicy(max_pending=256))
    svc.register_operator("poisson", op)
    rid = svc.submit("poisson", b, tol=1e-8, deadline_s=2.0)
    results = svc.drain()
    print(results[rid].iters, svc.stats())

``chip_smoke.py``'s ``batched_serve`` phase drives it on the card.
"""

from repro_torch.serve.batcher import (AdmissionPolicy, RequestQueue,
                                       RetryPolicy, SolveRequest)
from repro_torch.serve.cache import SetupCache, operator_fingerprint
from repro_torch.serve.clock import Clock, SystemClock, VirtualClock
from repro_torch.serve.errors import (AdmissionRejected, BadRequestError,
                                      ConfigError, ServeError,
                                      UnknownOperatorError)
from repro_torch.serve.replay import (Arrival, ReplayReport, TrafficClass,
                                      poisson_trace, replay)
from repro_torch.serve.scheduler import SlabScheduler, SlabWorker
from repro_torch.serve.service import RequestResult, SolverService

__all__ = [
    "AdmissionPolicy",
    "AdmissionRejected",
    "Arrival",
    "BadRequestError",
    "Clock",
    "ConfigError",
    "ReplayReport",
    "RequestQueue",
    "RequestResult",
    "RetryPolicy",
    "ServeError",
    "SetupCache",
    "SlabScheduler",
    "SlabWorker",
    "SolveRequest",
    "SolverService",
    "SystemClock",
    "TrafficClass",
    "UnknownOperatorError",
    "VirtualClock",
    "operator_fingerprint",
    "poisson_trace",
    "replay",
]
