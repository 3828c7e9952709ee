"""Observability for the port: the metrics registry the serving layer
reports through."""

from repro_torch.obs.metrics import Counter, Histogram, MetricsRegistry

__all__ = ["Counter", "Histogram", "MetricsRegistry"]
