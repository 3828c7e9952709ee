"""PyTorch/CUDA port of the p(l)-CG solver package ``repro``.

The package mirrors ``repro``'s layout (``core/``, ``kernels/``,
``linalg/``, ``parallel/backends/``, ``configs/``) so each module's
counterpart is easy to find.  It imports ``torch`` and numpy only.
Entry points place their tensors on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` where there is none raises.

On a CUDA tensor the hand-written kernels in ``kernels/csrc`` (the
fused-iteration superkernel with its stencil, diagonal and ELL plug-ins,
``stencil2d5``, ``stencil3d7``, ``ell_spmv``, ``fused_dots``,
``fused_axpy3`` and split-KV ``decode_attention``) run; on a CPU tensor
their plain PyTorch versions run instead.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
