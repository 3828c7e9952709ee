"""The Blatter/Pattyn ice-sheet system (PETSc SNES ex48) as an
unstructured problem (DESIGN.md §12): a random extruded FEM mesh with
thin-sheet vertical/horizontal anisotropy, ELL-packed and RCM-ordered
(``configs/problems.py``).  Counterpart of ``repro/configs/icesheet3d.py``.

Size: the paper's smallest ice-sheet run (100x100x50 finite elements),
500 000 nodes.
"""
from repro_torch.configs.laplace2d import CGProblem


def config():
    return CGProblem(name="icesheet3d", kind="unstructured",
                     nx=100, ny=100, nz=50, eps_z=0.01, prec="blockjacobi",
                     seed=48)


def smoke_config():
    return CGProblem(name="icesheet3d-smoke", kind="unstructured",
                     nx=10, ny=6, nz=4, eps_z=0.01, seed=48)
