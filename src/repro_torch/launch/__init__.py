"""Launch-time helpers (counterpart of ``repro/launch``): the timing model
and schedule simulator the pipeline-depth autotuner reads
(``timing_model``, ``schedule_sim``) and the autotuner (``autotune``)."""
