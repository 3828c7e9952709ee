"""The port's torch.distributed backend over real ranks: 2 and 4 gloo
processes on the CPU, started by ``repro_torch.parallel.fabric.
launch_fabric``, each running ``python -m repro_torch.parallel.worker``.

Starting process groups is too heavy for every tier-1 run, so this is
opt-in, gated as ``tests/test_multiprocess.py`` is::

    RUN_MULTIPROCESS=1 PYTHONPATH=src python -m pytest tests/test_torch_multiprocess.py

One group per rank count runs every case; each test reads its case's
results.  Tolerances:
* staged (ring ladder) solves against their one-process reference on the
  same inputs: bitwise (x and the residual history), fp64 and fp32 wire;
  unfused against ``LocalBackend(reduction="staged", virtual_shards=P)``,
  fused against ``parallel.distributed.rank_oracle_ops`` (each virtual
  shard's superkernel partial in its own slot; ``LocalBackend``'s fused
  oracle files one whole-vector partial, as the JAX package's does); the
  reference runs the RCM-ordered operator for an unordered ``SparseOp``;
* every rank returns the same x and history: bitwise;
* monolithic (async all_reduce) solves, and every method, against the JAX
  package's single-device solve on the same numpy inputs: converged, the
  same restarts, updates within 2, residual histories within 1e-9
  relative over the first 10 entries, x within 1e-6 relative (the
  convention of ``tests/test_torch_baselines.py``: gloo sums the ranks'
  partials in its own order, XLA contracts FMAs);
* the decode merge over ranks against the single-process
  ``merge_decode_shards`` of the same splits: within 1e-6 (fp32; the
  all-reduce sums the ranks in its own order), and against the plain
  whole-cache decode within 2e-4 (the JAX tests' decode bound).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.skipif(
    os.environ.get("RUN_MULTIPROCESS") != "1",
    reason="set RUN_MULTIPROCESS=1 to run the torch.distributed backend "
           "over real gloo ranks (multi-process)",
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = [2, 4]
DECODE = dict(B=2, H=4, Hkv=2, D=8, seed=3, block_s=16)


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    from repro.core import classic_cg, ghysels_pcg, pipelined_cg
    from repro.core.chebyshev import shifts_for_operator
    from repro.core.types import SolverOps
    from repro.linalg import operators, sparse
    from repro.linalg.preconditioners import JacobiPrec

    return dict(cg=classic_cg, pcg=ghysels_pcg, plcg=pipelined_cg,
                shifts=shifts_for_operator, ops=SolverOps,
                operators=operators, sparse=sparse, jacobi=JacobiPrec)


def _problems():
    """name -> (JAX operator, port operator fields): smoke sizes that split
    over 4 ranks."""
    J = _jax()
    from repro_torch import convert

    mesh_j = J["sparse"].random_fem_mesh(5, 120, avg_degree=6.0)
    mesh_t = convert.operator_fields(
        convert.operator("ell", device="cpu",
                         cols=np.asarray(mesh_j.cols),
                         vals=np.asarray(mesh_j.vals)))
    return {
        "stencil2d5": (J["operators"].Stencil2D5(16, 12),
                       dict(kind="stencil2d5", nx=16, ny=12)),
        "stencil3d7": (J["operators"].Stencil3D7(8, 6, 4, eps_z=0.1),
                       dict(kind="stencil3d7", nx=8, ny=6, nz=4, eps_z=0.1)),
        "stencil3d27": (J["operators"].Stencil3D27(8, 4, 5, centre=15.0),
                        dict(kind="stencil3d27", nx=8, ny=4, nz=5,
                             centre=15.0)),
        "ell": (mesh_j, mesh_t),
    }


# (case, problem, method, reduction, fused, extra)
CASES = [
    ("plcg_2d5_staged_fused", "stencil2d5", "plcg", "staged", True, {}),
    ("plcg_2d5_staged_fp32", "stencil2d5", "plcg", "staged", True,
     {"wire_dtype": "float32"}),
    ("plcg_2d5_mono_fused", "stencil2d5", "plcg", "monolithic", True, {}),
    ("plcg_3d7_staged_fused", "stencil3d7", "plcg", "staged", True, {}),
    ("plcg_3d7_mono_fused", "stencil3d7", "plcg", "monolithic", True, {}),
    ("plcg_ell_staged_fused", "ell", "plcg", "staged", True, {}),
    ("plcg_ell_staged_kernel", "ell", "plcg", "staged", False,
     {"use_kernel": True}),
    ("plcg_ell_mono_fused", "ell", "plcg", "monolithic", True, {}),
    ("plcg_3d27_staged", "stencil3d27", "plcg", "staged", False, {}),
    ("plcg_3d27_mono", "stencil3d27", "plcg", "monolithic", False, {}),
    ("cg_2d5_mono", "stencil2d5", "cg", "monolithic", False, {}),
    ("cg_2d5_staged", "stencil2d5", "cg", "staged", False, {}),
    ("pcg_2d5_mono", "stencil2d5", "pcg", "monolithic", False, {}),
    ("pcg_2d5_staged", "stencil2d5", "pcg", "staged", False, {}),
]
KW = {"plcg": dict(l=2, tol=1e-9, maxit=600, unroll=4),
      "cg": dict(tol=1e-9, maxit=600, unroll=4),
      "pcg": dict(tol=1e-9, maxit=600, unroll=4)}


@pytest.fixture(scope="module", params=RANKS, ids=[f"P{p}" for p in RANKS])
def group(request, tmp_path_factory):
    """Run every case over P gloo ranks once; returns (P, out_dir,
    inputs)."""
    from repro_torch.parallel.fabric import launch_fabric

    p = request.param
    out = str(tmp_path_factory.mktemp(f"ranks{p}"))
    J = _jax()
    inputs, tasks = {}, []
    for name, (jop, fields) in _problems().items():
        np.savez(os.path.join(out, f"{name}.op.npz"), **fields)
        b = np.random.default_rng(7).standard_normal(jop.n)
        sig = np.asarray(J["shifts"](jop, 2, prec=J["jacobi"].from_operator(
            jop)))
        np.savez(os.path.join(out, f"{name}.rhs.npz"), b=b, sig=sig)
        inputs[name] = (jop, fields, b, sig)
    for case, prob, method, red, fused, extra in CASES:
        solver = dict(KW[method])
        if method == "plcg":
            solver["fused_iteration"] = fused
        op_spec = {"npz": os.path.join(out, f"{prob}.op.npz")}
        if "use_kernel" in extra:
            op_spec["use_kernel"] = extra["use_kernel"]
        rhs = os.path.join(out, f"{prob}.rhs.npz")
        tasks.append({"kind": "solve", "name": case, "operator": op_spec,
                      "rhs": {"npz": rhs, "key": "b"},
                      "sigmas": {"npz": rhs, "key": "sig"}
                      if method == "plcg" else None,
                      "method": method, "reduction": red,
                      "stages": 2, "wire_dtype": extra.get("wire_dtype"),
                      "solver": solver})
    tasks.append(dict(DECODE, kind="decode_merge", name="decode",
                      S=16 * 3 * p, kv_len=16 * 3 * p - 21))
    spec = os.path.join(out, "spec.json")
    with open(spec, "w") as f:
        json.dump({"backend": {"device": "cpu"}, "out_dir": out,
                   "threads": 1, "tasks": tasks}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    launch_fabric(lambda master, k: [sys.executable, "-m",
                                     "repro_torch.parallel.worker", spec],
                  p, env=env, cwd=ROOT, timeout_s=600)
    return p, out, inputs


def _case(group, name):
    p, out, _ = group
    recs = []
    for r in range(p):
        with open(os.path.join(out, f"{name}.rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs, dict(np.load(os.path.join(out, f"{name}.npz")))


def _port_inputs(group, prob, use_kernel=False):
    from repro_torch import convert
    from repro_torch.linalg import JacobiPrec

    _, fields, b, sig = group[2][prob]
    fields = {k: v for k, v in fields.items() if k != "kind"}
    if use_kernel:
        fields["use_kernel"] = True
    top = convert.operator(group[2][prob][1]["kind"], device="cpu", **fields)
    return top, JacobiPrec.from_operator(top), b, np.array(sig)


def _assert_ranks_agree(recs, p):
    assert len(recs) == p and all(r["world"] == p for r in recs)
    assert len({r["x_sha256"] for r in recs}) == 1
    assert len({r["history_sha256"] for r in recs}) == 1
    assert all(r["converged"] for r in recs)


STAGED = [c for c in CASES if c[3] == "staged"]


@pytest.mark.parametrize("case,prob,method,red,fused,extra", STAGED,
                         ids=[c[0] for c in STAGED])
def test_staged_bitwise_against_the_oracle(group, case, prob, method, red,
                                           fused, extra):
    """Over P ranks the staged ladder gives the virtual-shards oracle's x
    and history bit for bit, with the ladder's hops on the wire and no
    all-reduce in the dot block."""
    from repro_torch.core import METHODS
    from repro_torch.linalg.partition import partition_spd
    from repro_torch.linalg.sparse import SparseOp, permute_spd
    from repro_torch.parallel.backends import LocalBackend
    from repro_torch.parallel.distributed import rank_oracle_ops
    from repro_torch.parallel.reduction import StagedConfig

    p = group[0]
    recs, arr = _case(group, case)
    _assert_ranks_agree(recs, p)
    top, prec, b, sig = _port_inputs(group, prob,
                                     extra.get("use_kernel", False))
    bt = torch.from_numpy(b)
    perm = None
    if isinstance(top, SparseOp):
        perm = partition_spd(top, p).perm
        top = permute_spd(top, perm, ordered=True)
        prec = type(prec).from_operator(top)
        bt = bt[torch.from_numpy(perm)]
    kw = dict(KW[method])
    if method == "plcg":
        kw.update(sigmas=torch.from_numpy(sig), fused_iteration=fused)
    dtype = torch.float32 if extra.get("wire_dtype") else None
    if fused:
        ref = METHODS[method](rank_oracle_ops(top, prec, StagedConfig(
            p, stages=min(2, p - 1), payload_dtype=dtype)), bt, kw)
    else:
        ref = LocalBackend(device="cpu", reduction="staged",
                           virtual_shards=p, reduction_stages=2,
                           reduction_dtype=dtype).solve(
            top, bt, method=method, prec=prec, **kw)
    x = torch.from_numpy(arr["x"])
    if perm is not None:
        x = x[torch.from_numpy(perm)]
    assert torch.equal(x, ref.x)
    assert torch.equal(torch.from_numpy(arr["res_history"]), ref.res_history)
    wire = recs[0]["wire_counts"]
    assert wire["messages"]["hop"] > 0 and "all_reduce" not in wire["messages"]
    if recs[0]["iters"] and prob != "stencil3d27":
        assert wire["messages"]["halo"] > 0


MONO = [c for c in CASES if c[3] == "monolithic"] + \
    [c for c in CASES if c[3] == "staged" and c[1] == "stencil3d27"]


@pytest.mark.parametrize("case,prob,method,red,fused,extra", MONO,
                         ids=[c[0] for c in MONO])
def test_solve_within_tolerance_of_jax(group, case, prob, method, red,
                                       fused, extra):
    """Monolithic solves (and the unfused Stencil3D27) over P ranks against
    the JAX package's single-device solve of the same system."""
    J = _jax()
    import jax.numpy as jnp

    p = group[0]
    recs, arr = _case(group, case)
    _assert_ranks_agree(recs, p)
    jop, _, b, sig = group[2][prob]
    jops = J["ops"].local(jop, J["jacobi"].from_operator(jop))
    kw = {k: v for k, v in KW[method].items() if k != "unroll"}
    if method == "plcg":
        kw["sigmas"] = jnp.asarray(sig)
    rj = J[method].solve(jops, jnp.asarray(b), **kw)
    assert bool(rj.converged) and recs[0]["converged"]
    assert abs(int(rj.iters) - recs[0]["iters"]) <= 2
    assert int(rj.restarts) == recs[0]["restarts"]
    hj, ht = np.asarray(rj.res_history), arr["res_history"]
    np.testing.assert_allclose(ht[:10], hj[:10], rtol=1e-9)
    xj = np.asarray(rj.x)
    assert np.linalg.norm(arr["x"] - xj) <= 1e-6 * np.linalg.norm(xj)
    if red == "monolithic":
        assert recs[0]["wire_counts"]["messages"]["all_reduce"] > 0


def test_decode_merge_over_ranks(group):
    """Each rank's split-KV stats merged over the wire equal the
    single-process merge of the same splits, and the whole-cache decode."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models.attention import (decode_attention_torch,
                                              merge_decode_shards)
    from repro_torch.parallel.worker import decode_split

    p = group[0]
    recs, arr = _case(group, "decode")
    assert len({r["out_sha256"] for r in recs}) == 1
    task = dict(DECODE, S=16 * 3 * p, kv_len=16 * 3 * p - 21)
    splits = [decode_split(r, p, task, torch.device("cpu")) for r in range(p)]
    stats = [kops.decode_attention_stats(q, k, v, kv, task["block_s"])
             for q, k, v, kv in splits]
    merged = merge_decode_shards(*(torch.stack(t) for t in zip(*stats)))
    q = splits[0][0]
    np.testing.assert_allclose(arr["out"], merged.reshape(q.shape).numpy(),
                               rtol=0, atol=1e-6)
    k = torch.cat([s[1] for s in splits], dim=1)
    v = torch.cat([s[2] for s in splits], dim=1)
    whole = decode_attention_torch(q, k, v, task["kv_len"])
    np.testing.assert_allclose(arr["out"], whole.numpy(), rtol=0, atol=2e-4)
    assert recs[0]["wire_counts"]["messages"]["all_reduce"] == 2
