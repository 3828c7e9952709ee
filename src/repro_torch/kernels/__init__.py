"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

CUDA is built and loaded only inside the call that first launches a
kernel (``_build``), never at import, so the modules import on a machine
without ``nvcc`` or a card.
"""
