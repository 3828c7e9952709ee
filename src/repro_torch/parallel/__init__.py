from repro_torch.parallel.backends import get_backend

__all__ = ["get_backend"]
