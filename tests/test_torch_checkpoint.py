"""Checkpoint and restore of the port's one-device solves
(``repro_torch.checkpoint``), mirroring the one-device tests of
``tests/test_checkpoint.py``, and held against the JAX package's file
format and snapshots.

Port against port, on the CPU: a resumed solve's residual history and x
are BITWISE the uninterrupted segmented solve's, the segmented drive with
no directory is bitwise the plain solve of the effective configuration
(same host syncs), and ``every=0`` / None is the untouched solve.

Port against JAX: the files are read both ways bitwise, and the payload's
leaves, dtypes, shapes and treedef text are the JAX state's.  A JAX
snapshot resumes in the port; from there the two solvers' arithmetic
differs by XLA's FMA contraction and reduction order, so the finished
solves agree to the tolerances of tests/test_torch_pipelined_cg.py:
iteration counts within 2, solutions within 1e-6 relative, and histories
within 1e-9 relative over the 10 entries after the restore.  Each
package's restore certifies the other's snapshot at the default
``certify_rtol`` (1e-8): at this size the two packages' true-residual
recomputes agree to well below it.
"""

import dataclasses
import importlib.util
import json
import os
import zipfile

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# A card's machine has no JAX and runs only the cuda tests.
HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from repro import checkpoint as jck
    from repro.checkpoint import solve as jck_solve
    from repro.core.batched import BUILDERS as JBUILDERS
    from repro.core.types import SolverOps as JOps
    from repro.linalg.operators import Stencil2D5 as JStencil
    from repro.parallel import get_backend as jget_backend

from repro_torch.checkpoint import (LAST_RESTORE, SNAPSHOTS,  # noqa: E402
                                    CheckpointCertificationError,
                                    CheckpointConfig, CheckpointCorruptError,
                                    CheckpointMismatchError,
                                    CheckpointVersionError, CKPT_VERSION,
                                    latest_checkpoint, list_checkpoints,
                                    load_checkpoint, load_slab_checkpoint,
                                    save_checkpoint, save_slab_checkpoint)
from repro_torch.checkpoint import solve as ckpt_solve  # noqa: E402
from repro_torch.core import ghysels_pcg, pipelined_cg  # noqa: E402
from repro_torch.core.batched import BUILDERS  # noqa: E402
from repro_torch.core.chebyshev import shifts_for_operator  # noqa: E402
from repro_torch.core.types import SolverOps  # noqa: E402
from repro_torch.linalg import JacobiPrec, Stencil2D5  # noqa: E402
from repro_torch.parallel.backends import LocalBackend  # noqa: E402
from repro_torch.stability import GovernorConfig  # noqa: E402

KW = {"plcg": dict(l=2, tol=1e-10, maxit=300),
      "pcg": dict(tol=1e-10, maxit=300)}


@pytest.fixture
def with_jax():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the reference")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _problem(device="cpu", nx=24, ny=16, seed=11):
    op = Stencil2D5(nx, ny, device=device)
    b = torch.tensor(np.random.default_rng(seed).standard_normal(op.n),
                     device=device)
    return op, b


def _same(a, b):
    assert torch.equal(a.res_history, b.res_history)
    assert torch.equal(a.x, b.x)
    assert int(a.iters) == int(b.iters)


# --------------------------------------------------------------------------
# Port against port: save -> kill -> resume, bitwise.
# --------------------------------------------------------------------------

_CASES = {
    "plcg": ("plcg", {}, {}),
    "pcg": ("pcg", {}, {}),
    "plcg_staged": ("plcg", dict(reduction="staged", virtual_shards=4), {}),
    "plcg_governed_ring": ("plcg", {}, dict(
        telemetry_cap=64, recurrence="stable", governor=GovernorConfig())),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_resume_bitwise_local(tmp_path, case):
    """Save every 15 updates, resume from the last snapshot: the resumed
    history (and ring, and governor vector) equals the uninterrupted
    segmented oracle bitwise, and persisting changes nothing."""
    method, be_kw, extra = _CASES[case]
    op, b = _problem()
    be = LocalBackend(device="cpu", **be_kw)
    kw = dict(KW[method], **extra)
    oracle = be.solve(op, b, method=method,
                      checkpoint=CheckpointConfig(every=15), **kw)
    d = str(tmp_path)
    n0 = len(SNAPSHOTS)
    full = be.solve(op, b, method=method,
                    checkpoint=CheckpointConfig(every=15, directory=d), **kw)
    n_snap = len(SNAPSHOTS) - n0
    assert list_checkpoints(d) and n_snap >= 3, "no snapshots written"
    resumed = be.solve(op, b, method=method,
                       checkpoint=CheckpointConfig(every=15, directory=d,
                                                   resume=True), **kw)
    assert bool(full.converged) and bool(resumed.converged)
    _same(oracle, full)
    assert LAST_RESTORE, "restore never happened"
    rtot = int(LAST_RESTORE[-1].meta["tot"])
    assert rtot > 0 and LAST_RESTORE[-1].path == latest_checkpoint(d)
    _same(oracle, resumed)
    for name in ("telemetry", "governor"):
        a, r = getattr(oracle, name), getattr(resumed, name)
        assert (a is None) == (r is None) == (not extra)
        if a is not None:
            assert torch.equal(a, r), name
    # One host read a snapshot.
    assert full.host_syncs == oracle.host_syncs + n_snap


@pytest.mark.parametrize("method", ["plcg", "pcg"])
@pytest.mark.parametrize("unroll", [1, 16])
def test_every_zero_and_none_untouched(method, unroll):
    """``checkpoint=None`` and ``every=0`` are the plain solve: bitwise,
    with equal host syncs."""
    op, b = _problem()
    ops = SolverOps.local(op)
    solve = pipelined_cg.solve if method == "plcg" else ghysels_pcg.solve
    kw = dict(KW[method], unroll=unroll, replace_every=40)
    plain = solve(ops, b, **kw)
    for ck in (None, CheckpointConfig(every=0)):
        r = solve(ops, b, checkpoint=ck, **kw)
        _same(plain, r)
        assert r.host_syncs == plain.host_syncs


@pytest.mark.parametrize("method", ["plcg", "pcg"])
@pytest.mark.parametrize("unroll", [1, 16])
def test_segmented_is_the_effective_solve(method, unroll):
    """With no directory and no hook the checkpointed solve is
    ``solve(**effective_kw(...))``: bitwise, with the same host syncs."""
    op, b = _problem()
    ops = SolverOps.local(op)
    solve = pipelined_cg.solve if method == "plcg" else ghysels_pcg.solve
    kw = dict(KW[method], unroll=unroll)
    seg = solve(ops, b, checkpoint=CheckpointConfig(every=15), **kw)
    eff = solve(ops, b, **ckpt_solve.effective_kw(method, kw, 15))
    _same(seg, eff)
    assert seg.host_syncs == eff.host_syncs


_GOVERNED = dict(telemetry_cap=64, recurrence="stable",
                 governor=GovernorConfig())


def _clone(st):
    def c(v):
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*(c(f) for f in v))
        return v.clone() if isinstance(v, torch.Tensor) else v

    return c(st)


@pytest.mark.parametrize("method,extra,unroll", [
    ("plcg", {}, 1), ("plcg", {}, 16), ("pcg", {}, 16),
    ("plcg", _GOVERNED, 1), ("plcg", _GOVERNED, 16)])
def test_restore_rebuilds_what_the_payload_lacks(tmp_path, method, extra,
                                                 unroll):
    """The restored state equals the uninterrupted drive's state at the
    same boundary, field by field: the clock ``t`` (``k``), the drained D
    ring and the ring's sink row included.  (The sink takes the writes of
    predicated iterations, which nothing reads: with ``unroll=1`` there
    are none, so it equals the uninterrupted run's; with ``unroll=16`` the
    test compares the ring's other rows.)"""
    op, b = _problem()
    ops = SolverOps.local(op)
    kw = ckpt_solve.effective_kw(method, dict(KW[method], **extra), 15)
    prog = BUILDERS[method](ops, b, **kw)
    step = prog.iteration if method == "plcg" else prog.step
    seen = {}
    d = str(tmp_path)
    cfg = CheckpointConfig(every=15, directory=d, keep=100)
    mask = ckpt_solve.exclude_mask(method, prog.init(torch.zeros_like(b)))
    snap = ckpt_solve.make_snapshot_fn(
        cfg, {"kind": "solve"}, mask, method,
        lambda s: ckpt_solve.make_rel_fn(method, kw)(ops, b, s))

    def capture(s):
        seen[int(ckpt_solve.iter_count(method, s))] = _clone(s)
        snap(s)

    ckpt_solve.run_segmented(
        prog.init(torch.zeros_like(b)), cond=prog.cond,
        needs=prog.needs_interrupt, step=step, interrupt=prog.interrupt,
        method=method, cfg=cfg, snapshot=capture, unroll=unroll)
    assert len(list_checkpoints(d)) == len(seen) >= 3
    for path in list_checkpoints(d):
        payload, meta = load_checkpoint(path)
        st = ckpt_solve.state_restore(prog.init(torch.zeros_like(b)),
                                      payload, mask, meta["clock"])
        ref = seen[meta["tot"]]
        for name, a in _fields(st).items():
            o = _fields(ref)[name]
            if name == "tel" and a is not None and unroll > 1:
                assert torch.equal(a[:-1], o[:-1]), (path, name)
            elif isinstance(a, torch.Tensor):
                assert torch.equal(a, o), (path, name)
            else:
                assert a == o, (path, name)
        if method == "plcg":
            assert st.cyc.i == 0 and not bool(st.cyc.D.any())


def _fields(st) -> dict:
    """A state's fields by name, the cycle's flattened in."""
    out = dict(st._asdict())
    if "cyc" in out:
        out.update(out.pop("cyc")._asdict())
    return out


def test_effective_kw_validation():
    """The checkpoint cadence must exceed plcg's pipeline depth, and
    every=0 never reaches the segmented drive."""
    with pytest.raises(ValueError):
        ckpt_solve.effective_kw("plcg", dict(l=3, maxit=100), every=3)
    with pytest.raises(ValueError):
        ckpt_solve.effective_kw("plcg", dict(l=2, maxit=100), every=0)
    kw = ckpt_solve.effective_kw("plcg", dict(l=2, maxit=100,
                                              replace_every=40), every=15)
    assert kw["replace_every"] == 15
    kw = ckpt_solve.effective_kw("pcg", dict(maxit=100, replace_every=10),
                                 every=25)
    assert kw["replace_every"] == 10
    with pytest.raises(ValueError):
        LocalBackend(device="cpu").solve(
            *_problem(), l=2, checkpoint=CheckpointConfig(every=2))


def test_methods_without_interrupt_rejected():
    """Classic CG has no interrupt boundary: checkpointing it is a typed
    refusal, not a silent no-op."""
    with pytest.raises(KeyError):
        ckpt_solve.make_rel_fn("cg", {})
    with pytest.raises(TypeError):
        LocalBackend(device="cpu").solve(
            *_problem(), method="cg", checkpoint=CheckpointConfig(every=5))


# --------------------------------------------------------------------------
# Typed failure modes.
# --------------------------------------------------------------------------

def test_corrupt_truncated_version_errors(tmp_path):
    path = str(tmp_path / "ckpt_0000000001.npz")
    payload = {"leaf_000": np.arange(6, dtype=np.float64).reshape(2, 3)}
    meta = save_checkpoint(path, payload, {"kind": "test"})
    assert meta["version"] == CKPT_VERSION and "sha256" in meta
    back, _ = load_checkpoint(path)
    assert np.array_equal(back["leaf_000"], payload["leaf_000"])

    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "missing.npz"))

    raw = open(path, "rb").read()
    trunc = str(tmp_path / "trunc.npz")
    with open(trunc, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(trunc)

    garbage = str(tmp_path / "garbage.npz")
    with open(garbage, "wb") as f:
        f.write(b"not a zip file at all")
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(garbage)

    # a tampered payload under the original meta: the hash refuses
    flipped = str(tmp_path / "flipped.npz")
    tampered = {k: v.copy() for k, v in payload.items()}
    tampered["leaf_000"][0, 0] += 1.0
    save_checkpoint(flipped, tampered, {"kind": "test"})
    assert load_checkpoint(flipped)[1]["sha256"] != meta["sha256"]
    forged = str(tmp_path / "forged.npz")
    with zipfile.ZipFile(flipped) as zin, \
            zipfile.ZipFile(forged, "w") as zout:
        for item in zin.namelist():
            data = zin.read(item)
            if item == "__meta__.npy":
                import io
                buf = io.BytesIO()
                np.save(buf, np.frombuffer(
                    json.dumps(meta, sort_keys=True).encode(),
                    dtype=np.uint8))
                data = buf.getvalue()
            zout.writestr(item, data)
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(forged)

    # version skew refuses before anything else is trusted
    vpath = str(tmp_path / "version.npz")
    save_checkpoint(vpath, payload, {"kind": "test"})
    pl, mv = load_checkpoint(vpath)
    mv["version"] = CKPT_VERSION + 1
    with open(vpath, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(
            json.dumps(mv, sort_keys=True).encode(), dtype=np.uint8), **pl)
    with pytest.raises(CheckpointVersionError):
        load_checkpoint(vpath)

    # the repair: a corrupted zip version byte (zipfile's
    # NotImplementedError) is a corrupt checkpoint too
    vb = bytearray(raw)
    cd = vb.index(b"PK\x01\x02")    # the first central directory entry
    vb[cd + 6] = 64                  # its "version needed to extract": 6.4
    badv = str(tmp_path / "zipversion.npz")
    with open(badv, "wb") as f:
        f.write(bytes(vb))
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(badv)


def test_meta_mismatch_refuses_resume(tmp_path):
    """A checkpoint written by one solver config refuses to resume a
    different one (another tolerance here): typed, never silent."""
    op, b = _problem()
    be = LocalBackend(device="cpu")
    d = str(tmp_path)
    be.solve(op, b, l=2, maxit=300, tol=1e-10,
             checkpoint=CheckpointConfig(every=15, directory=d))
    with pytest.raises(CheckpointMismatchError):
        be.solve(op, b, l=2, maxit=300, tol=1e-8,
                 checkpoint=CheckpointConfig(every=15, directory=d,
                                             resume=True))


def test_certification_catches_tampered_state(tmp_path):
    """A state altered under a fresh, valid hash fails the restore-time
    true-residual certification."""
    op, b = _problem()
    be = LocalBackend(device="cpu")
    d = str(tmp_path)
    kw = KW["plcg"]
    be.solve(op, b, checkpoint=CheckpointConfig(every=15, directory=d), **kw)
    path = latest_checkpoint(d)
    payload, meta = load_checkpoint(path)
    for k, v in payload.items():
        if v.ndim >= 1 and v.dtype == np.float64 and v.shape[-1] == op.n:
            payload[k] = v * (1.0 + 1e-3)       # perturb the iterate
    save_checkpoint(path, payload, meta)
    with pytest.raises(CheckpointCertificationError):
        be.solve(op, b, checkpoint=CheckpointConfig(every=15, directory=d,
                                                    resume=True), **kw)


def test_gc_keeps_newest(tmp_path):
    op, b = _problem()
    d = str(tmp_path)
    LocalBackend(device="cpu").solve(
        op, b, l=2, tol=1e-10, maxit=300,
        checkpoint=CheckpointConfig(every=15, directory=d, keep=2))
    paths = list_checkpoints(d)
    assert len(paths) == 2
    tots = [int(os.path.basename(p)[5:15]) for p in paths]
    assert tots == sorted(tots)


def test_slab_checkpoint_roundtrip(tmp_path):
    """A mid-flight slab persisted at a chunk boundary and reloaded onto a
    fresh template keeps solving bitwise like the original (30 more
    chunks): iterates and statuses."""
    op = Stencil2D5(16, 16, device="cpu")
    B = torch.tensor(np.random.default_rng(11).standard_normal((4, op.n)))
    sig = shifts_for_operator(op, 2)
    prog = LocalBackend(device="cpu").make_slab_program(
        op, s=4, method="plcg", chunk_iters=20, l=2, sigmas=sig, tol=1e-9,
        maxit=800)
    st = prog.init(B)
    for _ in range(3):
        st = prog.chunk(B, st)
    path = str(tmp_path / "slab.npz")
    meta = dict(s=4, method="plcg", n=int(op.n))
    save_slab_checkpoint(path, B, st, meta)
    B2, st2, m2 = load_slab_checkpoint(path, prog.init(B), expect_meta=meta)
    assert m2["kind"] == "slab" and torch.equal(B2, B)
    assert st2.t == st.t and st2.cyc.i == st.cyc.i
    for _ in range(30):
        st = prog.chunk(B, st)
        st2 = prog.chunk(B2, st2)
    x1, x2 = prog.extract(B, st).x, prog.extract(B2, st2).x
    assert x1.numpy().tobytes() == x2.numpy().tobytes()
    assert torch.equal(prog.status(B, st).running,
                       prog.status(B2, st2).running)
    with pytest.raises(CheckpointMismatchError):
        load_slab_checkpoint(path, prog.init(B),
                             expect_meta=dict(s=8, method="plcg"))


# --------------------------------------------------------------------------
# Port against JAX: the file format and the snapshots.
# --------------------------------------------------------------------------

def test_format_parity_both_ways(tmp_path, with_jax):
    """A JAX ``save_checkpoint`` file loads bitwise in the port, and the
    reverse, with the same content hash."""
    rng = np.random.default_rng(5)
    payload = {"leaf_000": rng.standard_normal((3, 4)),
               "leaf_001": np.int32(7) * np.ones((), np.int32),
               "leaf_002": rng.standard_normal(5) > 0,
               "leaf_003": rng.standard_normal((0, 14)).astype(np.float32)}
    for save, load in ((jck.save_checkpoint, load_checkpoint),
                       (save_checkpoint, jck.load_checkpoint)):
        path = str(tmp_path / f"{save.__module__}.npz")
        stored = save(path, payload, {"kind": "parity", "x": [1, 2]})
        back, meta = load(path)
        assert meta == stored and set(back) == set(payload)
        for k, v in payload.items():
            assert back[k].dtype == v.dtype and back[k].shape == v.shape
            assert back[k].tobytes() == v.tobytes()
    assert ckpt_solve.content_hash(payload) == jck.content_hash(payload)


def _jax_problem():
    jop = JStencil(24, 16)
    b = np.random.default_rng(11).standard_normal(jop.n)
    return jop, b


@pytest.mark.parametrize("method", ["plcg", "pcg"])
def test_jax_snapshot_resumes_in_port(tmp_path, with_jax, method):
    """JAX's checkpointed solve writes; the port resumes from its latest
    snapshot (meta and certification accepted) and finishes within the
    port-vs-JAX tolerances."""
    jop, b = _jax_problem()
    d = str(tmp_path)
    jres = jget_backend("local").solve(
        jop, b, method=method,
        checkpoint=jck.CheckpointConfig(every=15, directory=d), **KW[method])
    path = latest_checkpoint(d)
    jtot = int(load_checkpoint(path)[1]["tot"])
    op, tb = _problem()
    res = LocalBackend(device="cpu").solve(
        op, tb, method=method,
        checkpoint=CheckpointConfig(every=15, directory=d, resume=True),
        **KW[method])
    assert LAST_RESTORE[-1].path == path
    assert bool(res.converged) and bool(jres.converged)
    assert abs(int(res.iters) - int(jres.iters)) <= 2
    x, jx = res.x.numpy(), np.asarray(jres.x)
    assert np.linalg.norm(x - jx) <= 1e-6 * np.linalg.norm(jx)
    h, jh = res.res_history.numpy(), np.asarray(jres.res_history)
    upd = int(load_checkpoint(path)[1]["upd"])
    assert np.array_equal(h[:upd + 1], jh[:upd + 1])    # restored as saved
    seg = slice(upd + 1, upd + 11)
    np.testing.assert_allclose(h[seg], jh[seg], rtol=1e-9)
    assert jtot > 0


@pytest.mark.parametrize("method", ["plcg", "pcg"])
def test_port_snapshot_passes_jax_restore(tmp_path, with_jax, method):
    """A port snapshot passes JAX's ``load_checkpoint``, ``check_meta``
    and ``state_restore`` on a JAX template: the treedef text, leaf
    names, dtypes and shapes are the JAX package's; and the JAX solver
    resumes from it."""
    op, b = _problem()
    d = str(tmp_path)
    LocalBackend(device="cpu").solve(
        op, b, method=method,
        checkpoint=CheckpointConfig(every=15, directory=d), **KW[method])
    path = latest_checkpoint(d)
    payload, meta = jck.load_checkpoint(path)

    jop, jb = _jax_problem()
    jb = jnp.asarray(jb)
    kw = jck.effective_kw(method, dict(KW[method]), 15)
    jprog = JBUILDERS[method](JOps.local(jop), jb, **kw)
    tpl = jprog.init(jnp.zeros_like(jb))
    expect = jck_solve.solver_meta(method, jb.shape[0], jb.dtype, kw, 15)
    expect["treedef"] = jck_solve.state_treedef_str(tpl)
    assert expect["treedef"] == ckpt_solve.TREEDEF[method]
    jck_solve.check_meta(meta, expect)
    mask = jck_solve.exclude_mask(method, tpl)
    st = jck_solve.state_restore(tpl, payload, mask)
    for k, leaf in enumerate(jax.tree_util.tree_leaves(st)):
        key = f"leaf_{k:03d}"
        if key in payload:
            assert np.asarray(leaf).tobytes() == payload[key].tobytes()
    jres = jget_backend("local").solve(
        jop, jb, method=method,
        checkpoint=jck.CheckpointConfig(every=15, directory=d, resume=True),
        **KW[method])
    assert bool(jres.converged)
    assert jck_solve.LAST_RESTORE[-1].path == path


# --------------------------------------------------------------------------
# On the card.
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_checkpointed_fused_resume_bitwise_on_card(tmp_path, cuda_device):
    """A checkpointed fused p(2)-CG solve (the superkernel, Jacobi) at a
    small grid, killed after two snapshots and resumed, is bitwise the
    uninterrupted segmented solve on the card."""
    op, b = _problem(cuda_device, 64, 48)
    prec = JacobiPrec.from_operator(op)
    kw = dict(l=2, tol=1e-10, maxit=2000, fused_iteration=True, unroll=16,
              sigmas=shifts_for_operator(op, 2, prec=prec))
    be = LocalBackend()
    oracle = be.solve(op, b, prec=prec,
                      checkpoint=CheckpointConfig(every=40), **kw)
    d = str(tmp_path)
    seen = []

    def kill(upd):
        seen.append(upd)
        if len(seen) == 3:
            raise RuntimeError("killed")

    with pytest.raises(RuntimeError, match="killed"):
        be.solve(op, b, prec=prec, checkpoint=CheckpointConfig(
            every=40, directory=d, on_boundary=kill), **kw)
    assert len(list_checkpoints(d)) == 2
    resumed = be.solve(op, b, prec=prec, checkpoint=CheckpointConfig(
        every=40, directory=d, resume=True), **kw)
    assert LAST_RESTORE[-1].meta["tot"] > 0
    assert bool(resumed.converged)
    _same(oracle, resumed)


def test_config_is_frozen():
    """``CheckpointConfig`` is the JAX package's frozen dataclass:
    ``armed`` follows ``every``."""
    cfg = CheckpointConfig(every=5)
    assert cfg.armed and not dataclasses.replace(cfg, every=0).armed
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.every = 3
