"""Segmented checkpointed solves on one device: the counterpart of the
one-device half of ``repro/checkpoint/solve.py``.

The cycle-boundary invariant is the JAX package's: a p(l)-CG state can be
copied to the host only where its in-flight D ring is empty, and every
interrupt (breakdown restart, residual replacement, governor action)
re-inits the cycle with a drained ring and a true-residual recompute.
``CheckpointConfig(every=k)`` therefore arms an effective replacement
period of at most ``k`` solution updates, and the solve snapshots AFTER
each interrupt.

The segmented drive is the solvers' own host loop
(``core.types.host_loop``): it already runs the iteration under ``cond &
~needs_interrupt`` and applies the interrupt on the host, which is what
the JAX ``run_segmented`` does.  The checkpointed solve hands it an
interrupt wrapped with the boundary hooks (``on_boundary`` before, the
snapshot after), so with no directory and no hook it is the plain solve
of the effective configuration, bitwise, with the same host syncs.  A
boundary adds one host read for ``on_boundary`` (``upd``) and one for a
snapshot (the true residual and the state copied together).

The file is the JAX package's: a sequential snapshot carries the JAX
state's leaves (``leaf_NNN`` in its flatten order, its dtypes and shapes,
its treedef text), so a JAX snapshot resumes here and a port snapshot
passes the JAX package's ``load_checkpoint``, ``check_meta`` and
``state_restore``.  The port's state differs from the JAX one, and the
conversion is explicit:

* int64 counters are stored as the JAX int32; the cycle index ``i`` (a
  host int here) as an int32 0-d array;
* the windows (G, gamma, delta, the D ring) turn with the program's clock
  ``t`` here and with ``i`` in the JAX package: they are stored rotated to
  the JAX positions and rotated back on restore;
* the telemetry ring drops its sink row ((cap, K), (0, K) when off) and the
  governor vector is zeros when off;
* what the payload lacks is rebuilt on restore: the clock ``t`` (p(l)-CG)
  or ``k`` (p-CG) from the meta's ``clock`` where a port snapshot wrote it,
  else from the counters; the ring's sink row and the drained D ring from
  the restoring program's own fresh state.

Over ranks (``parallel.distributed.distributed_checkpointed_solve``) each
rank holds its rows of the vector leaves (:func:`vector_leaves`) and the
rest replicated.  Two hooks make the one-device drive serve a rank: the
snapshot's ``gather`` makes the vector leaves whole on every rank before
the copy to the host, and only the writer (rank 0) hashes and writes;
``try_restore``'s ``scatter`` hands each rank its rows of the stored
vector leaves.  The file is the one-device file, its rows in the
partition's order, so it restores on any rank count whose partition keeps
that order, and on one device.

Slab snapshots (``save_slab_checkpoint``) hold the port's (s, n) slab
state as it is at a chunk boundary, its per-column host counters as
arrays: port to port only (the JAX slab state is vmapped).
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.format import (CheckpointCertificationError,
                                           CheckpointError,
                                           CheckpointMismatchError,
                                           _write_checkpoint, content_hash,
                                           load_checkpoint, save_checkpoint)

_CKPT_RE = re.compile(r"^ckpt_(\d{10})\.npz$")

# Meta keys that must match between a checkpoint and the restoring
# solver: a disagreement is a config mismatch, never a silent resume.
_STRUCT_KEYS = ("kind", "method", "n", "dtype", "treedef", "maxit", "tol",
                "replace_every", "max_restarts", "l", "recurrence",
                "telemetry_cap", "governed", "every")

# The JAX package's state pytrees: their treedef text and their leaves in
# flatten order (``repro/core/pipelined_cg.py`` ``_State``/``_Cycle``,
# ``repro/core/ghysels_pcg.py`` ``PcgState``).
TREEDEF = {
    "plcg": ("PyTreeDef(CustomNode(namedtuple[_State], [CustomNode("
             "namedtuple[_Cycle], [*, *, *, *, *, *, *, *, *]), *, *, *, *, "
             "*, *, *, *, *, *]))"),
    "pcg": "PyTreeDef(CustomNode(namedtuple[PcgState], [*, *, *, *, *, *, *]))",
}
LEAVES = {
    "plcg": ("S", "G", "D", "gam", "dlt", "eta_prev", "zet_prev", "i",
             "norm0_cycle", "tot", "upd", "restarts", "converged",
             "breakdown", "hist", "norm0", "since_rr", "tel", "gov"),
    "pcg": ("S", "gamma", "alpha", "it", "conv", "hist", "since_rr"),
}


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Checkpoint policy for a solve (the JAX package's).

    every:        snapshot at least every ``every`` solution updates (0
                  disables checkpointing: the solver's untouched path).
                  Arming checkpoints forces an effective residual-
                  replacement period of ``min(replace_every or inf,
                  every)``: a checkpoint boundary IS a replacement.
    directory:    where snapshots go (``ckpt_<tot>.npz``); None keeps the
                  segmented drive without persisting (the uninterrupted
                  oracle of the parity checks).
    keep:         on-disk snapshots retained (oldest removed first).
    resume:       load the latest checkpoint in ``directory`` before
                  solving (no-op when none exists yet).
    certify_rtol: tolerance of the restore-time true-residual
                  certification (a same-device restore reproduces the
                  saved value bitwise).
    on_boundary:  host callback called with the solution-update count at
                  every segment boundary, before the interrupt.
    """

    every: int = 0
    directory: str | None = None
    keep: int = 2
    resume: bool = False
    certify_rtol: float = 1e-8
    on_boundary: Callable[[int], None] | None = None

    @property
    def armed(self) -> bool:
        return self.every > 0


# --------------------------------------------------------------------------
# Directory layout.
# --------------------------------------------------------------------------

def checkpoint_path(directory: str, tot: int) -> str:
    return os.path.join(directory, f"ckpt_{tot:010d}.npz")


def list_checkpoints(directory: str) -> list[str]:
    """Checkpoint files in ``directory``, oldest first."""
    if not os.path.isdir(directory):
        return []
    names = sorted(n for n in os.listdir(directory) if _CKPT_RE.match(n))
    return [os.path.join(directory, n) for n in names]


def latest_checkpoint(directory: str) -> str | None:
    paths = list_checkpoints(directory)
    return paths[-1] if paths else None


def _gc(directory: str, keep: int) -> None:
    paths = list_checkpoints(directory)
    for p in paths[:-keep] if keep > 0 else paths:
        try:
            os.remove(p)
        except OSError:
            pass


# --------------------------------------------------------------------------
# State <-> leaves.
# --------------------------------------------------------------------------

def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def _method_of(state) -> str | None:
    """"plcg" or "pcg" for a sequential state (the JAX schema), None for a
    slab state or anything else (the port's own schema)."""
    from repro_torch.core.ghysels_pcg import PcgState
    from repro_torch.core.pipelined_cg import _State

    if isinstance(state, _State) and isinstance(state.cyc.i, int):
        return "plcg"
    if isinstance(state, PcgState) and isinstance(state.k, int):
        return "pcg"
    return None


def _roll(x: torch.Tensor, o: int, dims: tuple) -> torch.Tensor:
    if all(o % x.shape[d] == 0 for d in dims):
        return x
    return torch.roll(x, (o,) * len(dims), dims)


def _jax_leaves(state, method: str) -> list:
    """The JAX state's leaves, as tensors in the JAX dtypes and positions
    (on the state's device; nothing is read to the host)."""
    i32 = torch.int32
    if method == "pcg":
        return [state.S, state.gamma, state.alpha, state.it.to(i32),
                state.conv, state.hist, state.since_rr.to(i32)]
    from repro_torch.kernels.fused_iter import tel_layout
    from repro_torch.stability.model import N_SLOTS

    c = state.cyc
    o = state.t - c.i           # windows: logical index k at (k + o)
    l = c.D.shape[0]
    dtype, dev = c.S.dtype, c.S.device
    tel = (state.tel[:-1] if state.tel is not None else
           torch.zeros((0, tel_layout(l)["size"]), dtype=dtype, device=dev))
    gov = (state.gov if state.gov is not None else
           torch.zeros((N_SLOTS,), dtype=dtype, device=dev))
    return [c.S, _roll(c.G, -o, (0, 1)), _roll(c.D, -o, (0,)),
            _roll(c.gam, -o, (0,)), _roll(c.dlt, -o, (0,)), c.eta_prev,
            c.zet_prev, torch.tensor(c.i, dtype=i32), c.norm0_cycle,
            state.tot.to(i32), state.upd.to(i32), state.restarts.to(i32),
            state.converged, state.breakdown, state.hist, state.norm0,
            state.since_rr.to(i32), tel, gov]


def _port_leaves(state) -> tuple[list, str]:
    """Any port state (a slab's included): its fields in order, tensors as
    they are, per-column host counters as int64 arrays, None fields kept
    out (named in the treedef text)."""
    leaves = []

    def walk(v):
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return f"{type(v).__name__}({', '.join(walk(f) for f in v)})"
        if v is None:
            return "None"
        if isinstance(v, torch.Tensor):
            leaves.append(v)
            return "*"
        if isinstance(v, tuple):
            leaves.append(torch.tensor(v, dtype=torch.int64))
            return f"cols[{len(v)}]"
        leaves.append(torch.tensor(int(v), dtype=torch.int64))
        return "int"

    return leaves, walk(state)


def state_treedef_str(state) -> str:
    method = _method_of(state)
    return TREEDEF[method] if method else _port_leaves(state)[1]


def _leaves(state) -> list:
    method = _method_of(state)
    return _jax_leaves(state, method) if method else _port_leaves(state)[0]


def _copy_async(tensors: list) -> tuple[list, bool]:
    """Start copying tensors to the host: each card tensor into pinned
    memory without waiting (the caller waits once, when the second value
    says so); a CPU tensor is cloned, since the live state changes in
    place."""
    out, wait = [], False
    for v in tensors:
        if v.device.type == "cuda":
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            out.append(h)
            wait = True
        else:
            out.append(v.detach().clone())
    return out, wait


def _to_host(tensors: list) -> list[np.ndarray]:
    """Tensors to numpy arrays with ONE host synchronisation."""
    out, wait = _copy_async(tensors)
    if wait:
        torch.cuda.synchronize()
    return [v.numpy() for v in out]


def vector_leaves(method: str) -> tuple[int, ...]:
    """Indices, in the payload's leaf order, of the leaves whose trailing
    axis is the vector axis n (``core.batched.vector_mask``): over ranks
    each rank holds its rows of them, and every other leaf is the same on
    every rank.  The D ring, which the payload excludes, is left out."""
    from repro_torch.core.batched import vector_mask

    flags: dict = {}
    todo = [vector_mask(method)]
    while todo:
        m = todo.pop()
        for name, v in m._asdict().items():
            if isinstance(v, tuple):
                todo.append(v)
            else:
                flags[name] = v
    return tuple(i for i, name in enumerate(LEAVES[method])
                 if flags.get(name) and not (method == "plcg"
                                             and name == "D"))


def exclude_mask(method: str, state) -> tuple[bool, ...]:
    """Leaves to drop from the payload, in flatten order: the in-flight D
    ring for plcg (drained at every boundary; its shape is the
    substrate's), nothing for pcg."""
    return tuple(name == "D" and method == "plcg" for name in LEAVES[method])


def state_payload(state, exclude_mask=None) -> dict[str, np.ndarray]:
    """The state's leaves as named numpy arrays (``leaf_NNN``), in the JAX
    schema for a sequential p(l)-CG or p-CG state, in the port's own for
    a slab; leaves where ``exclude_mask`` is True are dropped."""
    vals = _leaves(state)
    exc = exclude_mask or (False,) * len(vals)
    keep = [i for i, e in enumerate(exc) if not e]
    arrays = _to_host([vals[i] for i in keep])
    return {f"leaf_{i:03d}": a for i, a in zip(keep, arrays)}


def state_restore(template, payload: dict[str, np.ndarray],
                  exclude_mask=None, clock: int | None = None):
    """Rebuild a state on ``template``'s device from ``payload``: every
    leaf shape- and dtype-checked against the template's; excluded leaves
    and what the payload lacks (the clock, the ring's sink row, the
    drained D ring) come from ``template``.  ``clock`` is the program
    clock of a p(l)-CG state (``k`` of a p-CG state); None rebuilds it
    from the counters."""
    method = _method_of(template)
    tvals = _leaves(template)
    exc = exclude_mask or (False,) * len(tvals)
    got, arrs = [], []
    for i, (tv, e) in enumerate(zip(tvals, exc)):
        if e:
            got.append(None)
            arrs.append(None)
            continue
        key = f"leaf_{i:03d}"
        if key not in payload:
            raise CheckpointMismatchError(
                f"checkpoint payload is missing {key} "
                f"({len(payload)} stored leaves)")
        a = payload[key]
        want = (_np_dtype(tv.dtype), tuple(tv.shape))
        if (a.dtype, tuple(a.shape)) != want:
            raise CheckpointMismatchError(
                f"{key}: stored {a.dtype}{tuple(a.shape)} != expected "
                f"{want[0]}{want[1]}")
        arrs.append(a)
        got.append(torch.as_tensor(a, device=tv.device))
    extra = [k for k in payload if k.startswith("leaf_")
             and int(k[5:]) >= len(tvals)]
    if extra:
        raise CheckpointMismatchError(
            f"checkpoint payload has unexpected leaves {sorted(extra)}")
    if method is None:
        return _port_unflatten(template, got)
    leaf = dict(zip(LEAVES[method], got))
    host = dict(zip(LEAVES[method], arrs))
    i64 = torch.int64
    if method == "pcg":
        it = leaf["it"].to(i64)
        return template._replace(
            S=leaf["S"], gamma=leaf["gamma"], alpha=leaf["alpha"], it=it,
            conv=leaf["conv"], hist=leaf["hist"],
            since_rr=leaf["since_rr"].to(i64),
            k=int(host["it"]) if clock is None else int(clock))
    c = template.cyc
    tot, restarts = leaf["tot"].to(i64), leaf["restarts"].to(i64)
    i = int(host["i"])
    # Without a recorded clock: one tick an iteration, none a restart.
    t = (int(host["tot"]) - int(host["restarts"]) if clock is None
         else int(clock))
    o = t - i
    cyc = c._replace(
        S=leaf["S"], G=_roll(leaf["G"], o, (0, 1)),
        D=c.D if leaf["D"] is None else _roll(leaf["D"], o, (0,)),
        gam=_roll(leaf["gam"], o, (0,)), dlt=_roll(leaf["dlt"], o, (0,)),
        eta_prev=leaf["eta_prev"], zet_prev=leaf["zet_prev"], i=i,
        norm0_cycle=leaf["norm0_cycle"])
    return template._replace(
        cyc=cyc, tot=tot, upd=leaf["upd"].to(i64), restarts=restarts,
        converged=leaf["converged"], breakdown=leaf["breakdown"],
        hist=leaf["hist"], norm0=leaf["norm0"],
        since_rr=leaf["since_rr"].to(i64), t=t,
        tel=(None if template.tel is None
             else torch.cat([leaf["tel"], template.tel[-1:]])),
        gov=None if template.gov is None else leaf["gov"])


def _port_unflatten(template, leaves: list):
    it = iter(leaves)

    def build(v):
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            return type(v)(*(build(f) for f in v))
        if v is None:
            return None
        a = next(it)
        if isinstance(v, torch.Tensor):
            return a
        if isinstance(v, tuple):        # a host leaf: on the CPU
            return tuple(int(x) for x in a.tolist())
        return int(a)

    return build(template)


# --------------------------------------------------------------------------
# Per-method hooks.  Only interrupt-capable methods can checkpoint: the
# boundary IS the interrupt.
# --------------------------------------------------------------------------

def iter_count(method: str, state):
    return state.tot if method == "plcg" else state.it


def upd_count(method: str, state):
    return state.upd if method == "plcg" else state.it


def make_rel_fn(method: str, kw: dict) -> Callable:
    """``rel(ops, b, st) -> 0-d tensor``: the true relative residual
    M-norm of the state's iterate, recomputed from scratch (r = b - A x,
    z = M^{-1} r, ||r||_M / ||r0||_M) through the SAME ops at save and at
    restore, so a same-device restore certifies bitwise."""
    from repro_torch.core.types import dot1

    if method == "plcg":
        from repro_torch.kernels.fused_iter import SlabLayout

        layout = SlabLayout(l=int(kw["l"]), RB=max(int(kw["l"]) + 1, 3),
                            recurrence=kw.get("recurrence", "ghysels"))

        def rel(ops, b, st):
            x = st.cyc.S[layout.x_row]
            r = b - ops.apply_a(x)
            z = ops.prec(r)
            return torch.sqrt(torch.abs(dot1(ops, r, z))) / st.norm0

        return rel
    if method == "pcg":
        from repro_torch.core.ghysels_pcg import X_ROW

        def rel(ops, b, st):
            x = st.S[X_ROW]
            r = b - ops.apply_a(x)
            u = ops.prec(r)
            return torch.sqrt(torch.abs(dot1(ops, r, u))) / st.hist[0]

        return rel
    raise KeyError(f"method {method!r} does not support checkpointing "
                   "(no interrupt boundary)")


def effective_kw(method: str, kw: dict, every: int) -> dict:
    """Builder kwargs with the checkpoint cadence folded in: the effective
    replacement period is ``min(replace_every or inf, every)``, and
    plcg's restart budget (with it the history length) grows to cover the
    scheduled restarts, identically for every solve of the config."""
    if every <= 0:
        raise ValueError(f"checkpoint.every must be > 0 (got {every})")
    kw = dict(kw)
    base = int(kw.get("replace_every", 0) or 0)
    eff = every if base == 0 else min(base, every)
    kw["replace_every"] = eff
    if method == "plcg":
        if eff <= int(kw["l"]):
            raise ValueError(
                f"checkpoint interval {eff} must exceed the pipeline "
                f"depth l={kw['l']} (the ring must refill between "
                "boundaries)")
        maxit = int(kw.get("maxit", 1000))
        kw["max_restarts"] = (int(kw.get("max_restarts", 10))
                              + maxit // eff + 1)
    return kw


def solver_meta(method: str, n: int, dtype, kw: dict, every: int) -> dict:
    """Config identity stored with every snapshot and checked on restore
    (see ``_STRUCT_KEYS``)."""
    return {
        "kind": "solve",
        "method": method,
        "n": int(n),
        "dtype": str(_np_dtype(dtype)),
        "maxit": int(kw.get("maxit", 1000)),
        "tol": float(kw.get("tol", 1e-6)),
        "replace_every": int(kw.get("replace_every", 0)),
        "max_restarts": int(kw.get("max_restarts", 10)),
        "l": int(kw.get("l", 0)),
        "recurrence": kw.get("recurrence", "ghysels"),
        "telemetry_cap": int(kw.get("telemetry_cap", 0)),
        "governed": kw.get("governor") is not None,
        "every": int(every),
    }


def check_meta(meta: dict, expect: dict) -> None:
    bad = {k: (meta.get(k), expect.get(k)) for k in _STRUCT_KEYS
           if meta.get(k) != expect.get(k)}
    if bad:
        detail = ", ".join(f"{k}: stored {s!r} != expected {e!r}"
                           for k, (s, e) in sorted(bad.items()))
        raise CheckpointMismatchError(f"checkpoint/config mismatch: {detail}")


class _Restored:
    """Record of a successful restore (host bookkeeping for drills)."""

    def __init__(self, path: str, meta: dict):
        self.path = path
        self.meta = meta


#: Most recent successful restore in this process (path + meta).
LAST_RESTORE: list[_Restored] = []

#: One record a snapshot written in this process: its path, payload bytes
#: and seconds spent computing the true residual (``rel_s``), copying the
#: state to the host (``copy_s``), hashing (``hash_s``) and writing
#: (``write_s``).  On a card ``rel_s`` and ``copy_s`` are device times
#: (CUDA events around the launches and the copies, read after the
#: snapshot's one synchronisation).
SNAPSHOTS: list[dict] = []


def try_restore(template, cfg: CheckpointConfig, expect_meta: dict,
                mask, rel_of_state: Callable[[Any], Any],
                scatter: Callable[[dict], dict] | None = None):
    """Load + certify the latest checkpoint in ``cfg.directory`` onto
    ``template``'s device; the template unchanged when there is none.
    ``scatter`` (over ranks) maps the stored payload to this rank's: its
    rows of every vector leaf."""
    path = latest_checkpoint(cfg.directory) if cfg.directory else None
    if path is None:
        return template
    payload, meta = load_checkpoint(path)
    check_meta(meta, expect_meta)
    if scatter is not None:
        payload = scatter(payload)
    st = state_restore(template, payload, mask, meta.get("clock"))
    rel_now = float(rel_of_state(st))
    rel_saved = float(meta["rel_true"])
    tol = cfg.certify_rtol * max(abs(rel_saved), np.finfo(np.float64).tiny)
    if not abs(rel_now - rel_saved) <= tol:
        raise CheckpointCertificationError(
            f"{path}: true-residual certification failed: recomputed "
            f"rel {rel_now:.17e} vs saved {rel_saved:.17e} "
            f"(rtol {cfg.certify_rtol:g})")
    LAST_RESTORE.append(_Restored(path, meta))
    return st


def make_snapshot_fn(cfg: CheckpointConfig, meta_base: dict, mask,
                     method: str, rel_of_state,
                     gather: Callable[[list], list] | None = None,
                     is_writer: bool = True):
    """The per-boundary snapshot callback (None when ``cfg`` has no
    directory): the true residual and the state reach the host in one
    synchronisation, then the hash and an atomic write.  Over ranks
    ``gather`` maps the state's payload leaves (in leaf order) to whole
    ones on every rank, and only the writer (``is_writer``) copies,
    hashes and writes."""
    if cfg.directory is None:
        return None
    if is_writer:
        os.makedirs(cfg.directory, exist_ok=True)
    keep = [i for i, e in enumerate(mask) if not e]

    def snapshot(st):
        vals = _leaves(st)
        cuda = vals[0].device.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
        t0 = time.perf_counter()
        rel_t = rel_of_state(st).reshape(1)
        t1 = time.perf_counter()
        if cuda:
            ev[1].record()
        if gather is not None:
            vals = gather(vals)
        tg = time.perf_counter()
        if cuda:
            ev[2].record()
        if not is_writer:
            return
        host, wait = _copy_async([rel_t] + [vals[i] for i in keep])
        if cuda:
            ev[3].record()
        if wait:
            torch.cuda.synchronize()        # the snapshot's one host read
        t2 = time.perf_counter()
        host = [h.numpy() for h in host]
        payload = {f"leaf_{i:03d}": a for i, a in zip(keep, host[1:])}
        sha = content_hash(payload)
        t3 = time.perf_counter()
        named = dict(zip((LEAVES[method][i] for i in keep), host[1:]))
        meta = dict(meta_base)
        meta["tot"] = int(named["tot" if method == "plcg" else "it"])
        meta["upd"] = int(named["upd" if method == "plcg" else "it"])
        meta["clock"] = st.t if method == "plcg" else st.k
        meta["rel_true"] = float(host[0][0])
        path = checkpoint_path(cfg.directory, meta["tot"])
        _write_checkpoint(path, payload, meta, sha)
        _gc(cfg.directory, cfg.keep)
        t4 = time.perf_counter()
        SNAPSHOTS.append({
            "path": path, "bytes": sum(a.nbytes for a in payload.values()),
            "rel_s": ev[0].elapsed_time(ev[1]) / 1e3 if cuda else t1 - t0,
            "gather_s": ev[1].elapsed_time(ev[2]) / 1e3 if cuda else tg - t1,
            "copy_s": ev[2].elapsed_time(ev[3]) / 1e3 if cuda else t2 - tg,
            "hash_s": t3 - t2, "write_s": t4 - t3})

    return snapshot


# --------------------------------------------------------------------------
# The checkpointed solve, entered from pipelined_cg.solve /
# ghysels_pcg.solve when checkpoint.every > 0.
# --------------------------------------------------------------------------

def checkpointed_solve(ops, b: torch.Tensor, method: str, x0,
                       cfg: CheckpointConfig, kw: dict, *,
                       n: int | None = None,
                       gather: Callable[[list], list] | None = None,
                       scatter: Callable[[dict], dict] | None = None,
                       is_writer: bool = True):
    """The solve of ``effective_kw(method, kw, cfg.every)`` through the
    host loop, with the boundary hooks around each interrupt; resumes from
    the latest snapshot when ``cfg.resume``.  ``result.host_syncs`` counts
    the loop's reads and the hooks' (one a boundary for ``on_boundary``,
    one a snapshot, one a restore).

    Over ranks ``ops`` and ``b`` are a rank's, ``n`` is the global length
    (stored in the meta), and ``gather``, ``scatter`` and ``is_writer``
    are the snapshot's and the restore's hooks (:func:`make_snapshot_fn`,
    :func:`try_restore`)."""
    from repro_torch.core.batched import BUILDERS
    from repro_torch.device import as_tensor

    kw = effective_kw(method, kw, cfg.every)
    unroll = int(kw.get("unroll", 1))
    prog = BUILDERS[method](ops, b, **{k: v for k, v in kw.items()
                                       if k != "unroll"})
    if prog.needs_interrupt is None or prog.interrupt is None:
        raise CheckpointError(
            f"method {method!r} exposes no interrupt boundary to "
            "checkpoint at")
    st = prog.init(torch.zeros_like(b) if x0 is None
                   else as_tensor(x0, b.device, b.dtype))
    mask = exclude_mask(method, st)
    rel = make_rel_fn(method, kw)

    def rel_of_state(s):
        return rel(ops, b, s)

    meta_base = solver_meta(method, b.shape[-1] if n is None else n,
                            b.dtype, kw, cfg.every)
    meta_base["treedef"] = state_treedef_str(st)
    reads = 0
    if cfg.resume:
        restored = try_restore(st, cfg, meta_base, mask, rel_of_state,
                               scatter)
        reads += restored is not st
        st = restored
    snapshot = make_snapshot_fn(cfg, meta_base, mask, method, rel_of_state,
                                gather, is_writer)
    step = prog.iteration if method == "plcg" else prog.step
    st, syncs = run_segmented(st, cond=prog.cond, needs=prog.needs_interrupt,
                              step=step, interrupt=prog.interrupt,
                              method=method, cfg=cfg, snapshot=snapshot,
                              unroll=unroll)
    return prog.finish(st, syncs + reads)


def run_segmented(st, *, cond, needs, step, interrupt, method: str,
                  cfg: CheckpointConfig,
                  snapshot: Callable[[Any], None] | None, unroll: int = 1):
    """The JAX package's segmented drive on the solvers' host loop:
    ``unroll`` predicated steps between host checks, and at each due
    interrupt ``cfg.on_boundary`` (one host read of ``upd``), the
    interrupt, then ``snapshot`` (one host read).  Returns the final
    state and the host reads, the loop's and the hooks'."""
    from repro_torch.core.types import host_loop

    reads = 0

    def boundary(s):
        nonlocal reads
        if cfg.on_boundary is not None:
            reads += 1
            cfg.on_boundary(int(upd_count(method, s)))
        s = interrupt(s)
        if snapshot is not None:
            reads += 1
            snapshot(s)
        return s

    st, syncs = host_loop(st, cond, step, unroll, needs, boundary)
    return st, syncs + reads


# --------------------------------------------------------------------------
# Slab snapshots at chunk boundaries (port to port): the state as it is,
# in-flight ring slots included, so a round trip is bitwise on the same
# device.
# --------------------------------------------------------------------------

def save_slab_checkpoint(path: str, B, state, meta: dict) -> dict:
    leaves, treedef = _port_leaves(state)
    arrays = _to_host(leaves + [B])
    payload = {f"leaf_{i:03d}": a for i, a in enumerate(arrays[:-1])}
    payload["slab_B"] = arrays[-1]
    meta = dict(meta)
    meta["kind"] = "slab"
    meta["treedef"] = treedef
    return save_checkpoint(path, payload, meta)


def load_slab_checkpoint(path: str, template_state,
                         expect_meta: dict | None = None):
    """Returns ``(B, state, meta)`` restored onto ``template_state``'s
    device; ``expect_meta`` keys (plus kind/treedef) must match."""
    payload, meta = load_checkpoint(path)
    if meta.get("kind") != "slab":
        raise CheckpointMismatchError(
            f"{path}: kind {meta.get('kind')!r} is not a slab checkpoint")
    leaves, treedef = _port_leaves(template_state)
    expect = dict(expect_meta or {})
    expect["treedef"] = treedef
    bad = {k: (meta.get(k), v) for k, v in expect.items()
           if meta.get(k) != v}
    if bad:
        detail = ", ".join(f"{k}: stored {s!r} != expected {e!r}"
                           for k, (s, e) in sorted(bad.items()))
        raise CheckpointMismatchError(f"slab checkpoint mismatch: {detail}")
    if "slab_B" not in payload:
        raise CheckpointMismatchError(f"{path}: no slab_B entry")
    B = torch.from_numpy(payload.pop("slab_B")).to(leaves[0].device)
    return B, state_restore(template_state, payload), meta
