"""The paper's CG benchmark problems (the LM configs of ``repro.configs``
wait for ROADMAP.md queue 1, item 8)."""
