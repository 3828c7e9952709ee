"""Deterministic fault injection (counterpart of ``repro.chaos``): the
seeded reduction-payload perturbation that exercises the stability
governor (``inject``), and process-level fault plans, slow and killed
ranks, for the launcher's watchdog and the recovery drill (``faults``)."""

from repro_torch.chaos.faults import (KILL_EXIT_CODE, FaultPlan,
                                      IterationFaults, apply_from_env,
                                      install_iteration_faults)
from repro_torch.chaos.inject import (ChaosConfig, chaos_ops,
                                      payload_noise, perturb_payload)

__all__ = ["ChaosConfig", "chaos_ops", "payload_noise", "perturb_payload",
           "FaultPlan", "apply_from_env", "KILL_EXIT_CODE",
           "IterationFaults", "install_iteration_faults"]
