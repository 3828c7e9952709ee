"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  A ``cuda`` request on a machine without a
    usable card raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def as_tensor(x, device=None, dtype=torch.float64) -> torch.Tensor:
    """``x`` (tensor, numpy array or sequence) as a tensor of ``dtype``.

    A tensor keeps its own device unless ``device`` is given; anything
    else goes to :func:`resolve_device`'s default."""
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else resolve_device(device)
        return x.to(device=dev, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype,
                           device=resolve_device(device))
