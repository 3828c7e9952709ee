"""Structured stand-in for the ice-sheet system: anisotropic 3D 7-point
stencil with thin-sheet eps_z, at the paper's larger grid sizes."""
from repro_torch.configs.laplace2d import CGProblem


def config():
    return CGProblem(name="icesheet3d-stencil", kind="stencil3d",
                     nx=256, ny=200, nz=152, eps_z=0.01, prec="blockjacobi")


def smoke_config():
    return CGProblem(name="icesheet3d-stencil-smoke", kind="stencil3d",
                     nx=16, ny=12, nz=8, eps_z=0.01)
