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


# ------------------------------------------ batched, governed, served ----
# Batched solves (slabs of 4, one zero column), the instrumented and
# governed solve, and the service over the same P gloo ranks.  Staged:
# bitwise against the slab ``rank_oracle_ops`` (fused) or
# ``LocalBackend(reduction="staged", virtual_shards=P)`` (unfused);
# monolithic: within the tolerances above of the JAX package's batched
# solve; the service: the same admitted, shed and finished sets on every
# rank, each solution bitwise the one-device service's on the staged
# oracle.
SLAB_CASES = [
    ("slab_2d5_staged_fused", "stencil2d5", "plcg", "staged", True),
    ("slab_3d7_staged_fused", "stencil3d7", "plcg", "staged", True),
    ("slab_ell_staged_fused", "ell", "plcg", "staged", True),
    ("slab_2d5_mono_fused", "stencil2d5", "plcg", "monolithic", True),
    ("slab_2d5_cg_staged", "stencil2d5", "cg", "staged", False),
    ("slab_ell_pcg_mono", "ell", "pcg", "monolithic", False),
]
GOV = dict(l=2, tol=1e-9, maxit=600, unroll=4, recurrence="stable",
           telemetry_cap=128, fused_iteration=True)
SERVE = dict(s=4, method="plcg", l=2, chunk_iters=8, maxit=400)


def _slab_rhs(n):
    B = np.random.default_rng(17).standard_normal((4, n))
    B[2] = 0.0
    return B


@pytest.fixture(scope="module", params=RANKS, ids=[f"P{p}" for p in RANKS])
def slab_group(request, tmp_path_factory):
    """Every batched, governed and served case over P gloo ranks once."""
    from repro_torch.parallel.fabric import launch_fabric

    p = request.param
    out = str(tmp_path_factory.mktemp(f"slab{p}"))
    J = _jax()
    inputs, tasks = {}, []
    for name, (jop, fields) in _problems().items():
        if name == "stencil3d27":
            continue
        np.savez(os.path.join(out, f"{name}.op.npz"), **fields)
        B = _slab_rhs(jop.n)
        sig = np.asarray(J["shifts"](jop, 2, prec=J["jacobi"].from_operator(
            jop)))
        np.savez(os.path.join(out, f"{name}.rhs.npz"), B=B, b=B[0], sig=sig)
        inputs[name] = (jop, fields, B, sig)

    def spec(prob, key="B"):
        rhs = os.path.join(out, f"{prob}.rhs.npz")
        return {"operator": {"npz": os.path.join(out, f"{prob}.op.npz")},
                "rhs": {"npz": rhs, "key": key},
                "sigmas": {"npz": rhs, "key": "sig"}}

    for case, prob, method, red, fused in SLAB_CASES:
        solver = dict(KW[method])
        if method == "plcg":
            solver["fused_iteration"] = fused
        task = dict(spec(prob), kind="solve_batched", name=case,
                    method=method, reduction=red, stages=2, solver=solver,
                    overlap={"l": 2, "window": 6})
        if method != "plcg":
            task.update(sigmas=None, overlap=None)
        tasks.append(task)
    tasks.append(dict(spec("stencil2d5", "b"), kind="solve", name="governed",
                      method="plcg", reduction="staged", stages=2,
                      solver=dict(GOV, governor={"patience": 40})))
    rng = np.random.default_rng(23)
    n = inputs["stencil2d5"][0].n
    np.savez(os.path.join(out, "trace.npz"),
             t=np.cumsum(rng.exponential(2e-3, 10)),
             b=rng.standard_normal((10, n)), tol=np.full(10, 1e-8),
             deadline=np.where(np.arange(10) % 5 == 4, 1e-9, -1.0))
    tasks.append({"kind": "serve", "name": "serve",
                  "operator": spec("stencil2d5")["operator"],
                  "trace": {"npz": os.path.join(out, "trace.npz")},
                  "reduction": "staged", "stages": 2, "service": SERVE,
                  "replay": {"iter_time_s": 1e-3, "tick_overhead_s": 1e-3}})
    with open(os.path.join(out, "spec.json"), "w") as f:
        json.dump({"backend": {"device": "cpu"}, "out_dir": out,
                   "threads": 1, "tasks": tasks}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    launch_fabric(lambda master, k: [sys.executable, "-m",
                                     "repro_torch.parallel.worker",
                                     os.path.join(out, "spec.json")],
                  p, env=env, cwd=ROOT, timeout_s=600)
    return p, out, inputs


def _slab_inputs(group, prob):
    """The port's operator, Jacobi, slab and shifts (the mesh RCM-ordered
    as the ranks' partition orders it, with the permutation)."""
    from repro_torch import convert
    from repro_torch.linalg import JacobiPrec
    from repro_torch.linalg.partition import partition_spd
    from repro_torch.linalg.sparse import SparseOp, permute_spd

    p = group[0]
    _, fields, B, sig = group[2][prob]
    top = convert.operator(fields["kind"], device="cpu",
                           **{k: v for k, v in fields.items() if k != "kind"})
    perm = None
    if isinstance(top, SparseOp):
        perm = partition_spd(top, p).perm
        top = permute_spd(top, perm, ordered=True)
    Bt = torch.from_numpy(B)
    if perm is not None:
        Bt = Bt[:, torch.from_numpy(perm)]
    return top, JacobiPrec.from_operator(top), Bt, sig, perm


STAGED_SLABS = [c for c in SLAB_CASES if c[3] == "staged"]


@pytest.mark.parametrize("case,prob,method,red,fused", STAGED_SLABS,
                         ids=[c[0] for c in STAGED_SLABS])
def test_batched_staged_bitwise_against_the_slab_oracle(slab_group, case,
                                                        prob, method, red,
                                                        fused):
    """A staged batched solve over P ranks: every rank the same bits, and
    the slab oracle's x and histories bit for bit; no hop payload larger
    than the s columns' (s, 2l+1) block, one staged start a window and l
    chains in flight on every rank."""
    from repro_torch.core import batched
    from repro_torch.parallel.backends import LocalBackend
    from repro_torch.parallel.distributed import rank_oracle_ops
    from repro_torch.parallel.reduction import StagedConfig

    p = slab_group[0]
    recs, arr = _case(slab_group, case)
    _assert_ranks_agree(recs, p)
    top, prec, Bt, sig, perm = _slab_inputs(slab_group, prob)
    kw = dict(KW[method])
    if method == "plcg":
        kw.update(sigmas=torch.from_numpy(sig), fused_iteration=fused)
    if fused:
        ref = batched.solve_batched(rank_oracle_ops(
            top, prec, StagedConfig(p, stages=min(2, p - 1))), Bt, method,
            **kw)
    else:
        ref = LocalBackend(device="cpu", reduction="staged",
                           virtual_shards=p, reduction_stages=2).solve_batched(
            top, Bt, method=method, prec=prec, **kw)
    x = torch.from_numpy(arr["x"])
    if perm is not None:
        x = x[:, torch.from_numpy(perm)]
    assert torch.equal(x, ref.x)
    assert torch.equal(torch.from_numpy(arr["res_history"]), ref.res_history)
    wire = recs[0]["wire_counts"]
    assert "all_reduce" not in wire["messages"]
    # no hop carries more than the s columns' (s, 2l+1) block (the
    # columns' inits and restarts send one column's)
    assert 0 < wire["bytes_sent"]["hop"] <= \
        wire["messages"]["hop"] * 4 * 5 * 8
    if method == "plcg":
        for r in recs:
            ov = r["overlap"]
            assert ov["max_in_flight"] == 2
            assert set(ov["staged_starts_per_window"]) == {1}


def test_batched_monolithic_within_tolerance_of_jax(slab_group):
    """Monolithic batched solves over P ranks (one async all-reduce of the
    (s, 2l+1) block an iteration; p-CG's block) against the JAX package's
    single-device batched solve of the same columns."""
    J = _jax()
    import jax.numpy as jnp

    from repro.parallel import get_backend as jget_backend

    p = slab_group[0]
    for case, prob, method, red, fused in SLAB_CASES:
        if red != "monolithic":
            continue
        recs, arr = _case(slab_group, case)
        _assert_ranks_agree(recs, p)
        jop, _, B, sig = slab_group[2][prob]
        kw = {k: v for k, v in KW[method].items() if k != "unroll"}
        if method == "plcg":
            kw["sigmas"] = jnp.asarray(sig)
        rj = jget_backend("local").solve_batched(
            jop, jnp.asarray(B.T), method=method,
            prec=J["jacobi"].from_operator(jop), **kw)
        for j in range(B.shape[0]):
            assert abs(int(rj.iters[j]) - recs[0]["iters_by_column"][j]) <= 2
            hj, ht = np.asarray(rj.res_history[j]), arr["res_history"][j]
            np.testing.assert_allclose(ht[:10], hj[:10], rtol=1e-9)
            xj = np.asarray(rj.x[j])
            assert np.linalg.norm(arr["x"][j] - xj) <= \
                1e-6 * max(np.linalg.norm(xj), 1e-300)
        if method == "plcg":
            ov = recs[0]["overlap"]
            assert ov["max_in_flight"] == 2
            assert ov["collective_bytes"] >= ov["window"] * 5 * 4 * 8


def test_governed_instrumented_over_ranks(slab_group):
    """The instrumented, governed staged solve: its ring and governor
    vector the same on every rank, and with x and the history bitwise the
    one-process reference's (``rank_oracle_ops``)."""
    from repro_torch.core import METHODS
    from repro_torch.parallel.distributed import rank_oracle_ops
    from repro_torch.parallel.reduction import StagedConfig
    from repro_torch.stability import GovernorConfig

    p = slab_group[0]
    recs, arr = _case(slab_group, "governed")
    _assert_ranks_agree(recs, p)
    assert len({(r["telemetry_sha256"], r["governor_sha256"])
                for r in recs}) == 1
    top, prec, Bt, sig, _ = _slab_inputs(slab_group, "stencil2d5")
    ref = METHODS["plcg"](rank_oracle_ops(top, prec, StagedConfig(
        p, stages=min(2, p - 1))), Bt[0], dict(
        GOV, sigmas=torch.from_numpy(sig),
        governor=GovernorConfig(patience=40)))
    for k in ("x", "res_history", "telemetry", "governor"):
        assert np.array_equal(arr[k], getattr(ref, k).numpy()), k


def test_service_over_ranks(slab_group):
    """``SolverService`` over P ranks (rank 0 leading, a virtual clock, a
    trace that sheds): every rank the same admitted, shed and finished
    sets and solutions, each the one-device service's on the staged
    oracle bit for bit; rank 0 sends each other rank its rows only."""
    from repro_torch.parallel.backends import LocalBackend
    from repro_torch.parallel.worker import digest
    from repro_torch.serve import (Arrival, SolverService, VirtualClock,
                                   replay)

    p, out, _ = slab_group
    recs, arr = _case(slab_group, "serve")
    for k in ("admitted", "finished", "shed", "x_sha256", "iters",
              "retirement_log"):
        assert len({json.dumps(r[k], sort_keys=True) for r in recs}) == 1, k
    assert recs[0]["shed"] and recs[0]["finished"]
    top, _, _, _, _ = _slab_inputs(slab_group, "stencil2d5")
    tr = dict(np.load(os.path.join(out, "trace.npz")))
    svc = SolverService(LocalBackend(device="cpu", reduction="staged",
                                     virtual_shards=p), clock=VirtualClock(),
                        prec="jacobi", **SERVE)
    svc.register_operator("op", top)
    replay(svc, [Arrival(t=float(t), op_key="op", b=tr["b"][i],
                         tol=float(tr["tol"][i]),
                         deadline_s=None if tr["deadline"][i] < 0
                         else float(tr["deadline"][i]))
                 for i, t in enumerate(tr["t"])],
           iter_time_s=1e-3, tick_overhead_s=1e-3)
    assert sorted(k for k, r in svc.results.items() if r.shed) == \
        recs[0]["shed"]
    assert {str(k): digest(torch.as_tensor(r.x))
            for k, r in svc.results.items() if not r.shed} == \
        recs[0]["x_sha256"]
    sent = [r["wire_counts"]["bytes_sent"].get("serve", 0) for r in recs]
    assert sent[0] == len(recs[0]["finished"]) * (top.n // p) * 8 * (p - 1)
    assert all(s == 0 for s in sent[1:])
