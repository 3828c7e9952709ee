"""Observability for the port: the metrics registry the serving layer
reports through (``metrics``) and Chrome-trace timelines: measured host
spans, the solver's schedule track (``schedule_track``, read by
``utils.trace``), the telemetry track decoded from the solver's on-device
ring, virtual-time serve replays and ``solve_timeline`` (``timeline``).
The ring itself lives with the solver (``core.pipelined_cg``,
``core.types.TelemetrySlab``)."""

from repro_torch.obs.metrics import Counter, Histogram, MetricsRegistry
from repro_torch.obs.timeline import (Timeline, replay_timeline,
                                      schedule_track, solve_timeline,
                                      telemetry_track)

__all__ = ["Counter", "Histogram", "MetricsRegistry", "Timeline",
           "replay_timeline", "schedule_track", "solve_timeline",
           "telemetry_track"]
