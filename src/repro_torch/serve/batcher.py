"""Request queue + dynamic batcher for the solver service (counterpart
of ``repro/serve/batcher.py``, DESIGN.md §11/§15).

Incoming ``(operator key, b, tol)`` requests are bucketed by *slab key*
``(op_key, tol)`` — every request in a slab shares the slab program
(operator, tolerance, method, pipeline depth are fixed when it is built;
the RHS row is runtime data).  The batcher is dynamic in the serving
sense: it never waits to fill a slab.  Free slots are handed whatever is
queued right now, partial slabs run with zero-padded columns (a zero RHS
has ``norm0 == 0`` and retires at iteration 0 — exact, not approximate),
and slots freed by retirement are re-packed from the queue between
chunks.

The batcher is also the *admission* layer: requests
carry an optional ``deadline_s`` SLO, timestamps come from an injectable
clock (``repro_torch.serve.clock``), and :class:`AdmissionPolicy` decides at
submit time whether a request is accepted (queue-depth ceiling,
deadline feasibility) — overload is refused at the door instead of
silently inflating every queued request's latency.  Requests that were
admitted but whose deadline expires while they wait are *shed* by the
scheduler at pack time (``SolveRequest.expired``): work that can no
longer meet its SLO never occupies a slab slot.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Hashable

import numpy as np

SlabKey = tuple[Hashable, float]       # (op_key, tol)


@dataclasses.dataclass
class SolveRequest:
    """One queued solve: right-hand side ``b`` against operator ``op_key``.

    ``submitted_at`` is in the submitting clock's timeframe (virtual
    seconds under a ``VirtualClock``); ``deadline_s`` is the SLO budget
    *relative to submission* — the request should retire by
    ``submitted_at + deadline_s`` (None: no deadline).
    """

    req_id: int
    op_key: Hashable
    b: np.ndarray
    tol: float
    submitted_at: float = dataclasses.field(default_factory=time.perf_counter)
    deadline_s: float | None = None
    # Times this request has been requeued by the service's RetryPolicy
    # (shed -> backoff -> resubmit); drives the exponential backoff and
    # the bounded give-up.
    retries: int = 0

    @property
    def slab_key(self) -> SlabKey:
        return (self.op_key, self.tol)

    def expired(self, now: float) -> bool:
        """Deadline already blown at time ``now`` (shed candidates).

        The JAX package's expression, ``now - submitted_at >
        deadline_s``, kept as it is so that virtual-clock replays shed
        what the JAX package's do: with float arithmetic a request that
        waited exactly ``deadline_s`` can already count as expired (the
        subtraction rounds), which is the reference's own edge."""
        return (self.deadline_s is not None
                and now - self.submitted_at > self.deadline_s)


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """SLO-aware admission control (DESIGN.md §15).

    ``max_pending``:    reject new work once this many requests are
                        queued or in flight (None: unbounded).  Bounding the queue bounds
                        worst-case latency: under open-loop overload an
                        unbounded queue grows without limit and EVERY
                        request misses its SLO; rejecting early keeps
                        the served fraction fast (goodput over
                        throughput).
    ``min_deadline_s``: reject deadlines at or below this floor — a
                        deadline the service cannot possibly meet is
                        refused immediately rather than accepted and
                        shed later.
    ``shed_expired``:   scheduler-side load shedding: drop queued
                        requests whose deadline already passed instead
                        of packing them into slab slots.
    """

    max_pending: int | None = None
    min_deadline_s: float = 0.0
    shed_expired: bool = True

    def check(self, pending: int, deadline_s: float | None) -> str | None:
        """Admission verdict: None to accept, else the rejection reason
        (``"queue_full"`` / ``"deadline_infeasible"``)."""
        if self.max_pending is not None and pending >= self.max_pending:
            return "queue_full"
        if deadline_s is not None and deadline_s <= self.min_deadline_s:
            return "deadline_infeasible"
        return None


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff for shed requests
    (DESIGN.md §15).

    A request whose deadline expired in queue is shed by the scheduler;
    with a retry policy armed the service REQUEUES it instead of
    dropping it — after ``backoff(retries)`` seconds of service-clock
    delay and with a fresh SLO window — up to ``max_retries`` times.
    The backoff is pure arithmetic on the service clock, so replays
    under a :class:`~repro_torch.serve.clock.VirtualClock` retry at exactly
    the same virtual instants (tests/test_torch_serve_replay.py).

    ``max_retries = 0`` disables requeueing;
    the policy then only supplies the :class:`AdmissionRejected`
    ``retry_after_s`` hint.
    """

    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_cap_s: float = 1.0

    def backoff(self, retries: int) -> float:
        """Delay before retry number ``retries + 1`` (exponential,
        capped)."""
        return min(self.backoff_cap_s,
                   self.backoff_base_s * self.backoff_factor ** retries)


class RequestQueue:
    """FIFO request buckets per slab key.

    ``submit`` assigns monotone request ids; ``take`` pops up to ``k``
    requests for one slab key (the batcher's packing step).  Iteration
    order over keys is insertion order — old traffic is not starved by
    new operators.
    """

    def __init__(self):
        self._buckets: "OrderedDict[SlabKey, deque[SolveRequest]]" = \
            OrderedDict()
        self._next_id = 0

    def submit(self, op_key: Hashable, b: np.ndarray, tol: float,
               deadline_s: float | None = None,
               now: float | None = None) -> SolveRequest:
        """Enqueue a request.  ``now`` is the submitting clock's
        timestamp (defaults to the system clock for standalone use —
        the service always passes its own clock's reading)."""
        req = SolveRequest(req_id=self._next_id, op_key=op_key,
                           b=np.asarray(b), tol=float(tol),
                           deadline_s=deadline_s)
        if now is not None:
            req.submitted_at = float(now)
        self._next_id += 1
        self._buckets.setdefault(req.slab_key, deque()).append(req)
        return req

    def take(self, key: SlabKey, k: int) -> list[SolveRequest]:
        bucket = self._buckets.get(key)
        if not bucket:
            return []
        out = [bucket.popleft() for _ in range(min(k, len(bucket)))]
        if not bucket:
            del self._buckets[key]
        return out

    def keys(self) -> list[SlabKey]:
        return list(self._buckets.keys())

    def pending(self, key: SlabKey | None = None) -> int:
        if key is not None:
            return len(self._buckets.get(key, ()))
        return sum(len(b) for b in self._buckets.values())

    def __len__(self) -> int:
        return self.pending()
