"""Preconditioners M^{-1} for the CG family (counterpart of
``repro/linalg/preconditioners.py``)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.linalg.operators import LinearOperator


class Preconditioner:
    def apply(self, x: torch.Tensor) -> torch.Tensor:  # M^{-1} x
        raise NotImplementedError

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(x)


@dataclasses.dataclass(frozen=True)
class IdentityPrec(Preconditioner):
    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return x


@dataclasses.dataclass(frozen=True)
class JacobiPrec(Preconditioner):
    inv_diag: torch.Tensor

    @staticmethod
    def from_operator(op: LinearOperator) -> "JacobiPrec":
        return JacobiPrec(inv_diag=1.0 / op.diag())

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.inv_diag.to(x.dtype) * x


class BlockJacobi(Preconditioner):
    """Not ported yet: block-Jacobi waits for ROADMAP.md queue 1, item 4
    (with the unstructured operators whose bandwidth its probing needs)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "BlockJacobi is not ported yet (ROADMAP.md, queue 1 item 4)")

    @staticmethod
    def from_operator(*args, **kwargs):
        raise NotImplementedError(
            "BlockJacobi is not ported yet (ROADMAP.md, queue 1 item 4)")
