"""Auxiliary-basis shifts for p(l)-CG (paper §2.2, Eq. 25); counterpart of
``repro/core/chebyshev.py``.

The power method's start vector comes from numpy (``default_rng(seed)``),
so it differs from the JAX package's ``jax.random`` vector; tests that
compare the packages hand the JAX shifts across (``repro_torch.convert``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def chebyshev_shifts(lam_min: float, lam_max: float, l: int,
                     dtype=torch.float64, device=None) -> torch.Tensor:
    """sigma_i = (lmax+lmin)/2 + (lmax-lmin)/2 * cos((2i+1)pi/(2l))."""
    i = torch.arange(l, dtype=dtype, device=resolve_device(device))
    mid = (lam_max + lam_min) / 2.0
    rad = (lam_max - lam_min) / 2.0
    return mid + rad * torch.cos((2.0 * i + 1.0) * np.pi / (2.0 * l))


def power_method(apply_a, n: int, iters: int = 20, seed: int = 0,
                 dtype=torch.float64, device=None):
    """Estimate lambda_max of the SPD operator with a few power
    iterations.  Returns (lam_max_estimate, final_vector)."""
    dev = resolve_device(device)
    v = torch.as_tensor(np.random.default_rng(seed).standard_normal(n),
                        dtype=dtype, device=dev)
    v = v / torch.linalg.norm(v)
    lam = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(iters):
        w = apply_a(v)
        lam = torch.dot(v, w)
        nw = torch.linalg.norm(w)
        v = w / torch.where(nw == 0, torch.ones_like(nw), nw)
    return lam, v


def shifts_for_operator(op, l: int, safety: float = 1.05,
                        dtype=torch.float64, prec=None,
                        device=None) -> torch.Tensor:
    """Shift vector for an operator: analytic bounds if available, else a
    power-method lambda_max and lambda_min ~ 0.  With ``prec`` the bounds
    are estimated for the preconditioned operator M^{-1}A."""
    dev = op.device if device is None else resolve_device(device)
    if prec is not None:
        lam, _ = power_method(lambda v: prec.apply(op.apply(v)), op.n,
                              iters=30, dtype=dtype, device=dev)
        return chebyshev_shifts(0.0, float(lam) * safety, l, dtype=dtype,
                                device=dev)
    try:
        lmin, lmax = op.eig_bounds()
    except NotImplementedError:
        lam, _ = power_method(op.apply, op.n, dtype=dtype, device=dev)
        lmin, lmax = 0.0, float(lam) * safety
    return chebyshev_shifts(lmin, lmax, l, dtype=dtype, device=dev)
