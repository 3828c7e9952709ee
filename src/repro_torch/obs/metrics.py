"""Metrics registry: counters and histograms with labeled series
(counterpart of ``repro/obs/metrics.py``, the part the serving layer
uses: it has no JAX in it).

The serving layer reports through it: a :class:`MetricsRegistry` holds
named metrics, each with LABELED series (``counter.labels(worker="3")
.inc()``), the Prometheus data model without its client library.
Everything is plain deterministic arithmetic, with no wall-clock read and
no thread: ``snapshot(clock=...)`` stamps an export with an injected
clock, so under a ``VirtualClock`` two replays of one trace export the
same snapshot.  :class:`Histogram` is a bounded reservoir whose
``quantile`` is the service's nearest-rank percentile.

Each ``SolverService`` creates its own registry, so two services never
share counters.  The JAX package's gauges and text exporters are not
ported (nothing in the port reads them); its timelines are in
``repro_torch.obs.timeline`` (the HLO schedule track read from the port's
own schedule, ``schedule_track``).
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Mapping

LabelKey = tuple[tuple[str, str], ...]


def _label_key(labels: Mapping[str, str] | None) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _Metric:
    """Shared labeled-series machinery; subclasses define the series
    payload and exposition."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._series: dict[LabelKey, object] = {}

    def _new_series(self):
        raise NotImplementedError

    def _get(self, labels: Mapping[str, str] | None = None):
        key = _label_key(labels)
        if labels and self.label_names:
            extra = set(dict(key)) - set(self.label_names)
            if extra:
                raise KeyError(f"{self.name}: unknown label(s) {sorted(extra)}")
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = self._new_series()
        return s

    def labels(self, **labels):
        """Bound view on one labeled series (created on first use)."""
        return _Bound(self, labels)

    def series(self) -> dict[LabelKey, object]:
        return dict(self._series)

    def reset(self) -> None:
        self._series.clear()


class _Bound:
    """A metric bound to one label set: forwards the write/read API."""

    def __init__(self, metric: _Metric, labels: Mapping[str, str]):
        self._metric = metric
        self._labels = dict(labels)

    def __getattr__(self, attr):
        fn = getattr(type(self._metric), attr)
        return lambda *a, **kw: fn(self._metric, *a,
                                   labels=self._labels, **kw)


class Counter(_Metric):
    """Monotone counter.  ``inc`` only — a decreasing counter is a bug."""

    kind = "counter"

    def _new_series(self):
        return [0.0]

    def inc(self, amount: float = 1.0, *, labels=None) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counter inc must be >= 0")
        self._get(labels)[0] += amount

    def value(self, *, labels=None) -> float:
        return self._get(labels)[0]


class _Reservoir:
    __slots__ = ("obs", "count", "sum")

    def __init__(self, maxlen: int):
        self.obs: deque[float] = deque(maxlen=maxlen)
        self.count = 0
        self.sum = 0.0


class Histogram(_Metric):
    """Bounded-reservoir distribution metric.

    ``count``/``sum`` are exact over all observations; quantiles come
    from the most recent ``maxlen`` (so a long-lived service does not
    grow its stats state).  ``quantile(p)`` is nearest-rank arithmetic:
    the sorted reservoir indexed at ``int(p/100 * n)``.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 label_names: Iterable[str] = (), maxlen: int = 4096):
        super().__init__(name, help, label_names)
        self.maxlen = int(maxlen)

    def _new_series(self):
        return _Reservoir(self.maxlen)

    def observe(self, value: float, *, labels=None) -> None:
        r = self._get(labels)
        r.obs.append(float(value))
        r.count += 1
        r.sum += float(value)

    def reservoir(self, *, labels=None) -> deque[float]:
        return self._get(labels).obs

    def quantile(self, p: float, *, labels=None) -> float:
        obs = sorted(self._get(labels).obs)
        if not obs:
            return 0.0
        return obs[min(int(p / 100 * len(obs)), len(obs) - 1)]

    def clear(self, *, labels=None) -> None:
        r = self._get(labels)
        r.obs.clear()
        r.count = 0
        r.sum = 0.0


class MetricsRegistry:
    """Named metrics with idempotent registration.

    ``counter/histogram`` return the existing metric when the name is
    already registered with the same kind (so components can declare
    their metrics independently against a shared registry) and raise on
    a kind mismatch — silently returning a counter where a histogram was
    asked for is how stats go quietly wrong.
    """

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _register(self, cls, name, help, label_names, **kw):
        cur = self._metrics.get(name)
        if cur is not None:
            if not isinstance(cur, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{cur.kind}, requested {cls.kind}")
            return cur
        m = self._metrics[name] = cls(name, help, label_names, **kw)
        return m

    def counter(self, name: str, help: str = "",
                label_names: Iterable[str] = ()) -> Counter:
        return self._register(Counter, name, help, label_names)

    def histogram(self, name: str, help: str = "",
                  label_names: Iterable[str] = (),
                  maxlen: int = 4096) -> Histogram:
        return self._register(Histogram, name, help, label_names,
                              maxlen=maxlen)

    def metrics(self) -> list[_Metric]:
        return [self._metrics[k] for k in sorted(self._metrics)]

    # ------------------------------------------------------------ export --
    def snapshot(self, clock=None) -> dict:
        """Deterministic export: sorted metrics, sorted series, stamped
        with the injected clock (None -> no timestamp; never reads the
        wall clock itself)."""
        out: dict = {"time": clock.now() if clock is not None else None,
                     "metrics": {}}
        for m in self.metrics():
            series = {}
            for key in sorted(m.series()):
                if isinstance(m, Histogram):
                    r = m._series[key]
                    series[_label_str(key)] = {
                        "count": r.count, "sum": r.sum,
                        "p50": m.quantile(50, labels=dict(key)),
                        "p90": m.quantile(90, labels=dict(key)),
                        "p99": m.quantile(99, labels=dict(key)),
                    }
                else:
                    series[_label_str(key)] = m._series[key][0]
            out["metrics"][m.name] = {"type": m.kind, "help": m.help,
                                      "series": series}
        return out
