"""Attainable-accuracy gap model and the governor's state layout
(counterpart of ``repro/stability/model.py``).

Deep pipelines trade synchronisation for rounding: the recursive residual
of p(l)-CG drifts away from the true residual ``b - A x`` as rounding
errors propagate through the multi-term basis recurrences (the
attainable-accuracy analysis of Cools et al., arXiv:1804.02962).  The
governor tracks a cheap bound on that drift, the predicted
true-vs-recursive residual gap, from scalars the scalar phase already
holds (the arrived dot block, the fresh Hessenberg entries): no extra
reduction, no vector traffic.

Two detection arms, both on scalar state:

* **gap arm**: ``safety * gap >= rnorm/norm0`` (or the recursion claims
  ``rel < tol``): the recursive residual cannot be told from its own
  rounding noise, so a residual replacement (a cycle re-init from the
  current iterate, which recomputes ``b - A x``) is scheduled.  Every
  restart measures the real true-vs-recursive discrepancy and turns it
  into a per-iteration drift RATE that floors the next cycle's gap
  growth, so corrupted reductions (``repro_torch.chaos``) are caught at
  the first restart.
* **patience arm**: the relative recursive residual has not improved by
  ``improve_ratio`` for ``patience`` solution updates.

A governed solve certifies convergence against the TRUE residual: only a
replacement whose measured true residual is below tol sets ``converged``.
``demote_after`` consecutive replacements that do not improve the true
residual set the terminal ``STAGNATED`` flag (``repro_torch.stability.
governor`` then halves the depth or raises ``StagnationError``).

The state is one flat (N_SLOTS,) vector ((s, N_SLOTS) in a slab, one row
a column); the solver builds each step's new vector in a few whole-vector
operations (``core.pipelined_cg``).
"""

from __future__ import annotations

import dataclasses

import torch

# ---------------------------------------------------------------- slots --
GAP = 0          # accumulated relative true-vs-recursive residual gap
BEST = 1         # best rnorm/norm0 seen so far (patience reference)
BEST_UPD = 2     # solution-update count when BEST last improved
DUE = 3          # pending action code: 0 none, 1 gap arm, 2 patience arm
REPL = 4         # governor-triggered residual replacements so far
FRUITLESS = 5    # consecutive replacements without true-residual progress
STAGNATED = 6    # terminal: demote_after fruitless replacements (0/1)
LAST_REL = 7     # true rnorm/norm0 recorded at the last replacement
RATE = 8         # measured per-iteration gap growth from the last cycle
N_SLOTS = 9

# Telemetry "action" column codes (kernels.fused_iter.tel_layout).
ACTION_NONE = 0.0
ACTION_GAP_REPLACE = 1.0
ACTION_PATIENCE_REPLACE = 2.0
ACTION_STAGNATED = 3.0


@dataclasses.dataclass(frozen=True)
class GovernorConfig:
    """Stability-governor policy.

    ``safety``        gap-arm margin: act when ``safety * gap >= rel``.
    ``patience``      solution updates without an ``improve_ratio``
                      improvement before the patience arm fires; 0
                      resolves to ``max(32, 8l)``.
    ``improve_ratio`` "improved" means rel < ratio * best.
    ``demote_after``  consecutive fruitless replacements before the solve
                      is declared stagnated.
    ``eps``           unit roundoff seeding the gap model; None takes the
                      solve dtype's machine epsilon.
    ``kappa``         gap-model scale factor (1.0: the first-order model).
    """

    safety: float = 4.0
    patience: int = 0
    improve_ratio: float = 0.99
    demote_after: int = 3
    eps: float | None = None
    kappa: float = 1.0

    def resolved_patience(self, l: int) -> int:
        return int(self.patience) if self.patience > 0 else max(32, 8 * l)

    def resolved_eps(self, dtype) -> float:
        return (float(torch.finfo(dtype).eps) if self.eps is None
                else float(self.eps))


def gov_init(dtype, device=None, batch: tuple = ()) -> torch.Tensor:
    """The initial governor vector (one per column of ``batch``): gap 0,
    BEST = 1 (the relative residual starts at 1), LAST_REL = 1, the rest
    0."""
    g = torch.zeros(tuple(batch) + (N_SLOTS,), dtype=dtype, device=device)
    g[..., BEST] = 1.0
    g[..., LAST_REL] = 1.0
    return g


def gap_increment(mags, basis, eps, kappa=1.0):
    """The increment of :func:`gap_step`, ``kappa * eps * amp *
    max(basis, 1)``, from ``mags``: |gam_new|, |d2|, |dlt_safe| on the last
    axis (the solver takes them from its scalar vector in one ``abs``)."""
    denom = torch.where(mags[..., 2] == 0, 1.0, mags[..., 2])
    amp = (1.0 + mags[..., 0] + mags[..., 1]) / denom
    return kappa * eps * amp * torch.clamp(basis, min=1.0)


def gap_step(gap, gam_new, d2, dlt_safe, basis, eps, kappa=1.0):
    """One first-order update of the accumulated gap estimate:

        amp  = (1 + |gam_new| + |d2|) / |dlt_safe|   (|dlt_safe| = 0 -> 1)
        gap' = gap + kappa * eps * amp * max(basis, 1)

    with ``basis`` the current basis-vector scale.  Monotone
    non-decreasing in ``gap`` and in each magnitude input, the property the
    trigger logic relies on (tests/test_torch_stability_properties.py).
    Kept as the JAX package has it, including its overflow to inf for huge
    finite inputs."""
    mags = torch.abs(torch.stack(torch.broadcast_tensors(
        torch.as_tensor(gam_new), torch.as_tensor(d2),
        torch.as_tensor(dlt_safe)), -1))
    return gap + gap_increment(mags, basis, eps, kappa)
