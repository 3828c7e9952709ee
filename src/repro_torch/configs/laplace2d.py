"""The paper's own benchmark problem: 2D 5-point Laplacian (PETSc KSP ex2)
+ the diagonal "communication-bound toy" with the same spectrum (Fig. 3)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class CGProblem:
    name: str
    kind: str          # stencil2d | stencil3d | diagonal | unstructured
    nx: int
    ny: int
    nz: int = 1
    eps_z: float = 1.0
    l: int = 2
    tol: float = 1e-6
    maxit: int = 2000
    prec: str = "none"  # none | jacobi | blockjacobi
    seed: int = 0       # mesh-generator seed (unstructured kinds only)


def config():
    # 2048x2048 = 4.19M unknowns, the paper's Fig. 3 problem size
    return CGProblem(name="laplace2d", kind="stencil2d", nx=2048, ny=2048)


def smoke_config():
    return CGProblem(name="laplace2d-smoke", kind="stencil2d", nx=32, ny=24)
