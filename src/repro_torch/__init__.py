"""PyTorch/CUDA port of the p(l)-CG solver package ``repro``.

The package mirrors ``repro``'s layout (``core/``, ``kernels/``,
``linalg/``, ``parallel/backends/``, ``configs/``) so each module's
counterpart is easy to find.  It imports ``torch`` and numpy only.
Entry points place their tensors on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` where there is none raises.

On a CUDA tensor the three hand-written kernels in ``kernels/csrc``
(the fused-iteration superkernel, ``stencil2d5`` and ``stencil3d7``)
run; on a CPU tensor their plain PyTorch versions run instead.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
