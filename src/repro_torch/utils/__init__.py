"""Measurement utilities (counterpart of ``repro/utils``): the overlap
tracer (``trace``), collective counts (``collectives``) and roofline
terms (``roofline``)."""
