"""Observability for the port: the metrics registry the serving layer
reports through (``metrics``) and Chrome-trace timelines: measured host
spans, the telemetry track decoded from the solver's on-device ring, and
virtual-time serve replays (``timeline``).  The ring itself lives with
the solver (``core.pipelined_cg``, ``core.types.TelemetrySlab``)."""

from repro_torch.obs.metrics import Counter, Histogram, MetricsRegistry
from repro_torch.obs.timeline import (Timeline, replay_timeline,
                                      telemetry_track)

__all__ = ["Counter", "Histogram", "MetricsRegistry", "Timeline",
           "replay_timeline", "telemetry_track"]
