"""Shared harness of the ``tests/test_torch_models_*.py`` files: one LM
config at ``smoke_config()`` through the JAX package and the port on the
same weights (JAX's ``LM(cfg).init`` tree carried over by
``repro_torch.convert.lm_params``) and the same numpy-seeded inputs.

``parity_results(arch)`` runs, on both sides: the forward over a prompt of
T + 1 tokens (logits, aux; the loss as ``loss_fn`` forms it), prefill of
the first T into a cache of T + 1 positions (a vlm's patches added), one
decode step of token T (it fills the cache's last position) and one more
(past ``max_seq``: JAX clamps the write to the last position and counts
every position; the port must agree).  The JAX side runs under
``jax.jit`` (the same functions, compiled once each).

Tolerances, all fp32 on both sides with the same formulas summed in other
orders (XLA's CPU dot against torch's): logits, loss and every cache
tensor within rtol = atol = 1e-5, ~40x the largest difference seen over
the ten configs (2.4e-7 on logits of magnitude ~0.7).  The port's own
prefill -> decode consistency uses the JAX smoke test's bounds: 2e-4 for
prefill against the forward, 2e-3 for the decode step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.models import LM as JLM
from repro.models import common as jcm
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.models import LM as TLM

B, T = 2, 16
TOL = 1e-5
PREFILL_TOL = 2e-4
DECODE_TOL = 2e-3


def make_batch(cfg, t, seed=3):
    """numpy inputs for a batch of ``t`` tokens (and the family's stub
    embeddings)."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, t)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, t)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["enc_embeds"] = rng.standard_normal(
            (B, t // cfg.enc_frames_ratio, cfg.d_model)).astype(np.float32)
    return b


def _prompt(batch, t):
    return {k: (v[:, :t] if k in ("tokens", "labels") else v)
            for k, v in batch.items()}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()   # not a view of it
    return np.asarray(tree)


def parity_results(arch: str) -> dict:
    jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    jm = JLM(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = TLM(tcfg, device="cpu").load_params(
        convert.lm_params(tcfg, jax.tree.map(np.asarray, params), "cpu"))

    batch = make_batch(jcfg, T + 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    max_seq = T + 1 + (jcfg.n_patches if jcfg.family == "vlm" else 0)
    tok1 = batch["tokens"][:, T:T + 1]
    tok2 = batch["tokens"][:, :1]
    out = {"cfg": tcfg, "model": tm}

    jl, jaux = jax.jit(jm.forward)(params, jb)
    jloss = jcm.cross_entropy(jl, jb["labels"], jcfg.vocab) \
        + jcfg.router_aux_weight * jaux
    jlp, jc0 = jax.jit(lambda p, b: jm.prefill(p, b, max_seq))(
        params, _prompt(jb, T))
    step = jax.jit(jm.decode_step)
    jld1, jc1 = step(params, jnp.asarray(tok1), jc0)
    jld2, jc2 = step(params, jnp.asarray(tok2), jc1)
    out["jax"] = _np({"logits": jl, "aux": jaux, "loss": jloss,
                      "prefill": jlp, "cache0": jc0, "decode1": jld1,
                      "cache1": jc1, "decode2": jld2, "cache2": jc2})

    tl, taux = tm.forward(tb)
    tloss, _ = tm.loss(tb)
    tlp, tc = tm.prefill(_prompt(tb, T), max_seq)
    tc0 = _np(tc)                       # decode writes the KV cache in place
    tld1, tc = tm.decode_step(torch.as_tensor(tok1), tc)
    tc1 = _np(tc)
    tld2, tc = tm.decode_step(torch.as_tensor(tok2), tc)
    out["port"] = {"logits": _np(tl), "aux": _np(taux), "loss": _np(tloss),
                   "prefill": _np(tlp), "cache0": tc0, "decode1": _np(tld1),
                   "cache1": tc1, "decode2": _np(tld2), "cache2": _np(tc)}
    return out


def assert_close(got, want, tol=TOL, path="") -> None:
    """Trees of arrays with the same keys, shapes and dtype kinds, within
    rtol = atol = ``tol``."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_close(got[k], want[k], tol, f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    assert got.dtype.kind == want.dtype.kind, (path, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=path)


def check_forward(res) -> None:
    cfg, j, p = res["cfg"], res["jax"], res["port"]
    assert p["logits"].shape == (B, T + 1, cfg.vocab_padded)
    assert np.isfinite(p["logits"]).all()
    for key in ("logits", "aux", "loss"):
        assert_close(p[key], j[key], path=key)


def check_prefill(res) -> None:
    j, p = res["jax"], res["port"]
    assert_close(p["prefill"], j["prefill"], path="prefill")
    assert_close(p["cache0"], j["cache0"], path="cache0")


def check_decode(res) -> None:
    j, p = res["jax"], res["port"]
    assert_close(p["decode1"], j["decode1"], path="decode1")
    assert_close(p["cache1"], j["cache1"], path="cache1")


def check_past_max_seq(res) -> None:
    j, p = res["jax"], res["port"]
    assert int(p["cache2"]["pos"]) == int(j["cache2"]["pos"])
    assert_close(p["decode2"], j["decode2"], path="decode2")
    assert_close(p["cache2"], j["cache2"], path="cache2")


def check_consistency(res) -> None:
    """The port's own prefill -> decode against its full forward."""
    p = res["port"]
    np.testing.assert_allclose(p["prefill"][:, 0], p["logits"][:, T - 1],
                               rtol=PREFILL_TOL, atol=PREFILL_TOL)
    np.testing.assert_allclose(p["decode1"][:, 0], p["logits"][:, T],
                               rtol=DECODE_TOL, atol=DECODE_TOL)
