"""The LM side path of the port: ``ArchConfig`` and ``LM`` (prefill and
decode for the dense, vlm, moe, hybrid, ssm and encdec families), with
their blocks in ``common``, ``attention``, ``moe``, ``mamba2`` and
``rwkv6``.  Training (gradients, the optimizer, the pipelined gradient
ring) is not ported yet."""

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import LM

__all__ = ["ArchConfig", "LM"]
