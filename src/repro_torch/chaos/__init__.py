"""Deterministic fault injection (counterpart of ``repro.chaos``): the
seeded reduction-payload perturbation that exercises the stability
governor.  Process-level fault plans (``repro/chaos/faults.py``) are not
ported (``ChaosConfig.fault_plan`` raises, naming the roadmap item)."""

from repro_torch.chaos.inject import (ChaosConfig, chaos_ops,
                                      payload_noise, perturb_payload)

__all__ = ["ChaosConfig", "chaos_ops", "payload_noise", "perturb_payload"]
