"""Deterministic reduction-payload fault injection (counterpart of
``repro/chaos/inject.py``).

The one place the paper's algorithm meets the network is the pipelined
global reduction: a corrupted or noisy payload poisons the scalar phase,
then the recurrences, and caps the attainable accuracy.  ``chaos_ops``
wraps a backend's :class:`~repro_torch.core.types.SolverOps` so that
every reduction WAIT, where the combined payload becomes scalar-phase
input, returns a deterministically perturbed value:

* multiplicative and relative (``x * (1 + amp * noise)``), so ULP-scale
  through catastrophic corruption share one knob;
* ``noise`` is a pure hash of the payload's float32 bits mixed with the
  seed: no RNG state, and the same noise wherever the same payload is
  combined.  The hash is the JAX package's, bit for bit: its uint32
  arithmetic runs here in int64 masked to 32 bits after each multiply
  (each multiply split in 16-bit halves so no product overflows), and a
  float32 subnormal hashes as the signed zero XLA flushes it to.

Only the wait is wrapped: ``apply_a`` and ``prec`` stay clean, so a
residual replacement recomputes ``b - A x`` in clean arithmetic, which is
what makes governed recovery possible.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import SolverOps

MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Seeded reduction-payload perturbation and process-level faults.

    Value level (this module): ``payload_rel_amp`` the relative
    amplitude (0 disables), ``payload_prob`` the fraction of payload
    entries perturbed (chosen by a second value hash), ``seed`` mixed into
    both hashes.

    Process level (executed by ``repro_torch.chaos.faults`` in the ranks
    of a group; iteration-indexed faults fire at checkpoint segment
    boundaries, so a recovery drill is deterministic):
    ``kill_rank``/``kill_rank_at_iter`` hard-kill that rank at the first
    boundary reaching the update count; ``stall_rank``/
    ``stall_rank_at_iter``/``stall_rank_for_s`` one seeded-jitter sleep
    at a boundary, the wedged rank the heartbeat watchdog names.

    ``fault_plan()`` turns the process-level fields into the
    :class:`repro_torch.chaos.faults.FaultPlan` a launch ships to its
    ranks."""

    seed: int = 0
    payload_rel_amp: float = 0.0
    payload_prob: float = 1.0
    kill_rank: int | None = None
    kill_rank_at_iter: int | None = None
    stall_rank: int | None = None
    stall_rank_at_iter: int = 0
    stall_rank_for_s: float = 0.0

    def fault_plan(self):
        from repro_torch.chaos.faults import FaultPlan

        return FaultPlan(kill_rank=self.kill_rank,
                         kill_at_iter=self.kill_rank_at_iter,
                         stall_rank=self.stall_rank,
                         stall_at_iter=self.stall_rank_at_iter,
                         stall_for_s=self.stall_rank_for_s,
                         seed=self.seed)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``h * c mod 2^32`` for h < 2^32 in int64, without overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _mix(h: torch.Tensor) -> torch.Tensor:
    """32-bit integer finalizer (splitmix-style avalanche) on int64
    values below 2^32."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h


def _value_hash(x: torch.Tensor, seed: int, salt: int) -> torch.Tensor:
    """The uint32 hash (as int64) of each element's float32 bit pattern,
    the seed and the salt.  A float32 subnormal hashes as a zero of its
    sign: XLA's conversion flushes it, so the JAX package's hash does."""
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64) & MASK32
    bits = torch.where((bits & 0x7F800000) == 0, bits & 0x80000000, bits)
    key = (seed * 2654435761 + salt * 40503) & MASK32
    return _mix(bits ^ key)


def payload_noise(x: torch.Tensor, cfg: ChaosConfig) -> torch.Tensor:
    """The noise in [-1, 1) that ``perturb_payload`` applies to ``x`` (0
    where the ``payload_prob`` gate leaves an entry alone)."""
    h = _value_hash(x, cfg.seed, salt=1)
    noise = (h >> 8).to(x.dtype) * (1.0 / (1 << 24)) * 2.0 - 1.0
    if cfg.payload_prob < 1.0:
        g = _value_hash(x, cfg.seed, salt=2)
        gate = (g >> 8).to(x.dtype) * (1.0 / (1 << 24)) < cfg.payload_prob
        noise = torch.where(gate, noise, torch.zeros_like(noise))
    return noise


def perturb_payload(x: torch.Tensor, cfg: ChaosConfig) -> torch.Tensor:
    """Deterministically perturb a reduction payload, dtype-preserving."""
    if cfg.payload_rel_amp == 0.0:
        return x
    return (x * (1.0 + cfg.payload_rel_amp * payload_noise(x, cfg))
            ).to(x.dtype)


def chaos_ops(ops: SolverOps, cfg: ChaosConfig) -> SolverOps:
    """``ops`` with every reduction wait returning a perturbed payload.

    The wrap sits after the substrate's own wait, on the combined value;
    everything else (SPMV, preconditioner, start/advance) passes through,
    so the solve keeps one reduction start an iteration."""
    base_wait = ops.dot_block_wait

    if base_wait is None:
        def wrapped(dots, advanced=0):
            return perturb_payload(dots, cfg)
    else:
        def wrapped(dots, advanced=0, _wait=base_wait):
            return perturb_payload(_wait(dots, advanced=advanced), cfg)

    return dataclasses.replace(ops, dot_block_wait=wrapped)
