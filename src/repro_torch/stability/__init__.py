"""Stability-governed deep pipelines (counterpart of ``repro.stability``):
the attainable-accuracy gap model and governor policy (``model``) and the
host-side depth-demotion ladder with its typed stagnation diagnosis
(``governor``).  The solver side lives in ``repro_torch.core.
pipelined_cg`` (``recurrence=`` / ``governor=``); ``repro_torch.chaos``
exercises it."""

from repro_torch.stability.model import (ACTION_GAP_REPLACE, ACTION_NONE,
                                         ACTION_PATIENCE_REPLACE,
                                         ACTION_STAGNATED, BEST, BEST_UPD,
                                         DUE, FRUITLESS, GAP, LAST_REL,
                                         N_SLOTS, RATE, REPL, STAGNATED,
                                         GovernorConfig, gap_step, gov_init)
from repro_torch.stability.governor import (StagnationError, diagnose,
                                            governed_solve)

__all__ = [
    "GovernorConfig", "gap_step", "gov_init",
    "StagnationError", "diagnose", "governed_solve",
    "GAP", "BEST", "BEST_UPD", "DUE", "REPL", "FRUITLESS", "STAGNATED",
    "LAST_REL", "RATE", "N_SLOTS",
    "ACTION_NONE", "ACTION_GAP_REPLACE", "ACTION_PATIENCE_REPLACE",
    "ACTION_STAGNATED",
]
