"""Carry the JAX package's data across into the port's objects.

The JAX objects are handed over as numpy arrays and plain fields (this
module imports nothing of ``repro``); the tests extract them, so both
packages solve the identical system from the identical shifts:

* operators: ``kind`` plus grid sizes, ``eps_z``/``centre``, a
  ``DiagonalOp``'s ``d``, or a ``SparseOp``'s ELL ``cols``/``vals`` with
  its ``ordered``/``use_kernel`` flags (:func:`operator`, and
  :func:`operator_fields` for the way back);
* ``JacobiPrec.inv_diag`` (:func:`jacobi`);
* Chebyshev ``sigmas`` (:func:`sigmas`);
* a vector-phase ``(S, idx, scal)`` triple (:func:`vector_phase`);
* a ``PartitionPlan``'s fields (:func:`partition_plan`), so both packages
  apply one plan;
* the arrays of the JAX package's ``partitioned_solver_ops``
  (``{"op": ..., "prec": ...}``, as numpy) as the port's per-rank tensors
  (:func:`partitioned_arrays`), so both packages solve one sharded
  problem;
* an LM's parameter tree (``LM(cfg).init(key)``, as numpy) as the port's
  (:func:`lm_params`), so both packages compute with the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import as_tensor, resolve_device
from repro_torch.linalg.operators import (DenseSPD, DiagonalOp, Stencil2D5,
                                          Stencil3D7, Stencil3D27)
from repro_torch.linalg.partition import PartitionPlan
from repro_torch.linalg.preconditioners import JacobiPrec
from repro_torch.linalg.sparse import SparseOp

OPERATOR_KINDS = ("stencil2d5", "stencil3d7", "stencil3d27", "diagonal",
                  "dense", "ell")


def operator(kind: str, device=None, **fields):
    """A port operator from the fields of its JAX counterpart:
    ``stencil2d5`` (nx, ny[, use_kernel]), ``stencil3d7`` (nx, ny, nz,
    eps_z[, use_kernel]), ``stencil3d27`` (nx, ny, nz, centre),
    ``diagonal`` (d), ``dense`` (a), ``ell`` (cols, vals[, ordered,
    use_kernel]: a ``SparseOp``, vals keeping their dtype)."""
    if kind == "stencil2d5":
        return Stencil2D5(int(fields["nx"]), int(fields["ny"]),
                          use_kernel=bool(fields.get("use_kernel", False)),
                          device=device)
    if kind == "stencil3d7":
        return Stencil3D7(int(fields["nx"]), int(fields["ny"]),
                          int(fields["nz"]), eps_z=float(fields["eps_z"]),
                          use_kernel=bool(fields.get("use_kernel", False)),
                          device=device)
    if kind == "stencil3d27":
        return Stencil3D27(int(fields["nx"]), int(fields["ny"]),
                           int(fields["nz"]),
                           centre=float(fields["centre"]), device=device)
    if kind == "diagonal":
        return DiagonalOp(as_tensor(np.asarray(fields["d"]), device),
                          device=resolve_device(device))
    if kind == "dense":
        return DenseSPD(as_tensor(np.asarray(fields["a"]), device),
                        device=resolve_device(device))
    if kind == "ell":
        return SparseOp(cols=np.asarray(fields["cols"]),
                        vals=np.asarray(fields["vals"]),
                        ordered=bool(fields.get("ordered", False)),
                        use_kernel=bool(fields.get("use_kernel", False)),
                        device=resolve_device(device))
    raise ValueError(f"unknown operator kind {kind!r}; "
                     f"available: {', '.join(OPERATOR_KINDS)}")


def operator_fields(op) -> dict:
    """The plain fields :func:`operator` takes, for a port operator."""
    if isinstance(op, Stencil2D5):
        return {"kind": "stencil2d5", "nx": op.nx, "ny": op.ny,
                "use_kernel": op.use_kernel}
    if isinstance(op, Stencil3D7):
        return {"kind": "stencil3d7", "nx": op.nx, "ny": op.ny, "nz": op.nz,
                "eps_z": op.eps_z, "use_kernel": op.use_kernel}
    if isinstance(op, Stencil3D27):
        return {"kind": "stencil3d27", "nx": op.nx, "ny": op.ny,
                "nz": op.nz, "centre": op.centre}
    if isinstance(op, DiagonalOp):
        return {"kind": "diagonal", "d": op.d.cpu().numpy()}
    if isinstance(op, DenseSPD):
        return {"kind": "dense", "a": op.a.cpu().numpy()}
    if isinstance(op, SparseOp):
        return {"kind": "ell", "cols": op.cols.cpu().numpy(),
                "vals": op.vals.cpu().numpy(), "ordered": op.ordered,
                "use_kernel": op.use_kernel}
    raise TypeError(f"no field form for {type(op).__name__}")


def jacobi(inv_diag, device=None) -> JacobiPrec:
    return JacobiPrec(inv_diag=as_tensor(np.asarray(inv_diag), device))


def sigmas(sig, device=None) -> torch.Tensor:
    return as_tensor(np.asarray(sig), device)


def vector_phase(S, idx, scal, device=None):
    """A ``(S, idx, scal)`` triple: fp64 slab, int32 index vector, fp64
    scalar vector, all on ``device``."""
    return (as_tensor(np.asarray(S), device),
            as_tensor(np.asarray(idx), device, torch.int32),
            as_tensor(np.asarray(scal), device))


PLAN_FIELDS = ("n_shards", "n", "nxl", "hops", "max_send", "cols", "vals",
               "send_up", "send_dn", "perm", "band")


def partition_plan(device=None, **fields) -> PartitionPlan:
    """A port ``PartitionPlan`` from the fields of a JAX one (integers, and
    numpy arrays for ``cols``/``vals``/``send_up``/``send_dn``/``perm``):
    cols and the send sets as int32, vals keeping their dtype, all on
    ``device``; ``perm`` stays an int64 numpy array."""
    dev = resolve_device(device)

    def t(name, dtype=None):
        a = torch.from_numpy(np.array(fields[name]))
        return a.to(device=dev, dtype=dtype)

    return PartitionPlan(
        n_shards=int(fields["n_shards"]), n=int(fields["n"]),
        nxl=int(fields["nxl"]), hops=int(fields["hops"]),
        max_send=int(fields["max_send"]), cols=t("cols", torch.int32),
        vals=t("vals"), send_up=t("send_up", torch.int32),
        send_dn=t("send_dn", torch.int32),
        perm=np.asarray(fields["perm"], dtype=np.int64),
        band=int(fields["band"]))


def partitioned_arrays(arrays: dict, n_shards: int, device=None) -> list:
    """Rank r's arrays for each of ``n_shards`` ranks, from the arrays of
    the JAX package's ``partitioned_solver_ops`` (a nested dict of numpy
    arrays): each array's leading axis split into ``n_shards`` equal
    blocks, as its ``P(axis)`` in-spec splits it (a plan's (P, ...) arrays
    give (1, ...) blocks); integer arrays as int32, floats keeping their
    dtype, on ``device``."""
    dev = resolve_device(device)

    def block(a, r):
        if isinstance(a, dict):
            return {k: block(v, r) for k, v in a.items()}
        a = np.asarray(a)
        m = a.shape[0] // n_shards
        t = torch.from_numpy(np.array(a[r * m:(r + 1) * m]))
        if not t.is_floating_point():
            t = t.to(torch.int32)
        return t.to(dev)

    return [block(arrays, r) for r in range(n_shards)]


def lm_params(cfg, tree: dict, device=None) -> dict:
    """The port's LM parameters from the JAX package's ``LM(cfg).init``
    tree handed over as numpy arrays: the same nested keys, each leaf a
    tensor of its dtype and shape on ``device`` (per-layer leaves stay
    stacked on their leading L).  A tree of another config (embedding
    table other than (vocab_padded, d_model), or layers not stacked
    ``n_layers`` deep) raises.  Load the result with
    ``LM(cfg, device).load_params``."""
    dev = resolve_device(device)
    table = np.shape(tree["embed"]["table"])
    if table != (cfg.vocab_padded, cfg.d_model):
        raise ValueError(f"embedding table {table} is not {cfg.name}'s "
                         f"({cfg.vocab_padded}, {cfg.d_model})")

    def leaf(a, depth=None):
        if isinstance(a, dict):
            return {k: leaf(v, depth) for k, v in a.items()}
        if depth is not None and np.shape(a)[0] != depth:
            raise ValueError(f"a layer leaf of shape {np.shape(a)} is not "
                             f"stacked {depth} deep")
        return torch.from_numpy(np.array(a)).to(dev)

    depths = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers}
    return {k: leaf(v, depths.get(k)) for k, v in tree.items()}
