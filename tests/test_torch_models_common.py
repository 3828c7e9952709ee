"""The LM side path's pieces beside the per-family parity files: the
config registry, the parameter tree against JAX's, the building blocks of
``repro_torch.models.common`` (where torch's defaults differ from JAX's),
the recurrent caches' size, ``convert.lm_params``'s checks, and on the
card the model's decode attention through the hand-written kernel against
its plain form.

Tolerances (fp32 on both sides, the same formula in another order):
norms, MLPs, rotary tables and softplus within rtol = atol = 1e-6; the
cross entropy (a log-sum-exp over 512 logits) within 1e-6.  On the card,
the decode logits of the kernel path against the plain path within
rtol = atol = 2e-4, the decode kernel's own bound against its plain
version (``tests/test_torch_kernels.py``), which the two logits share.
"""

import dataclasses
import importlib.util

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# A card's machine has no JAX and runs only the cuda test.
HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models import LM as JLM
    from repro.models import common as jcm
    from repro.models import mamba2 as jmb

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, lm_arch_ids  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import LM, ArchConfig  # noqa: E402
from repro_torch.models import common as tcm  # noqa: E402
from repro_torch.models import mamba2 as tmb  # noqa: E402
from repro_torch.models.model import _leaves  # noqa: E402

TOL = 1e-6
CARD_TOL = 2e-4


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


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(a):
    return np.asarray(a, dtype=np.float32)


# ---------------------------------------------------------------- configs --

def test_registry_lists_the_lm_and_cg_ids():
    assert len(ARCH_IDS) == 13
    assert len(lm_arch_ids()) == 10
    assert get_config("laplace2d").nx == 2048
    with pytest.raises(KeyError):
        get_config("gpt-unknown")


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", lm_arch_ids())
def test_config_matches_jax(with_jax, arch, smoke):
    """Every field, the derived sizes and both analytic counts equal."""
    tcfg, jcfg = get_config(arch, smoke=smoke), jget(arch, smoke=smoke)
    assert isinstance(tcfg, ArchConfig)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.hd, tcfg.vocab_padded) == (jcfg.hd, jcfg.vocab_padded)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", lm_arch_ids())
def test_param_tree_matches_jax(with_jax, arch):
    """The port's ``init`` gives JAX's leaves: the same dotted keys, shapes
    and dtypes (JAX's by ``jax.eval_shape``, nothing drawn), and the
    analytic ``param_count`` within the JAX test's 0.6-1.4 of the actual
    count."""
    cfg = get_config(arch, smoke=True)
    model = LM(cfg, device="cpu")
    tree = model.init(torch.Generator().manual_seed(0))
    shapes = jax.eval_shape(JLM(jget(arch, smoke=True)).init,
                            jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    want = {".".join(k.key for k in path): (tuple(a.shape), str(a.dtype))
            for path, a in flat}
    got = {name: (tuple(a.shape), str(a.dtype).replace("torch.", ""))
           for name, a in _leaves(tree)}
    assert got == want
    actual = sum(p.numel() for p in model.parameters())
    assert actual == sum(int(np.prod(s)) for s, _ in want.values())
    assert 0.6 < cfg.param_count() / actual < 1.4


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-7b"])
def test_recurrent_cache_is_constant_size(arch):
    """Decode state does not grow with the sequence: all of rwkv6's, and
    zamba2's apart from its few shared-attention KV caches."""
    model = LM(get_config(arch, smoke=True), device="cpu")

    def size(cache):
        return sum(a.numel() for _, a in _leaves(cache["layers"]))

    assert size(model.init_cache(1, 64)) == size(model.init_cache(1, 128))
    if arch == "rwkv6-7b":
        assert sorted(model.init_cache(1, 64)) == ["layers", "pos"]


def test_lm_params_refuses_another_config(with_jax):
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
        JLM(jget("qwen3-1.7b", smoke=True)).init, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="embedding table"):
        convert.lm_params(get_config("smollm-135m", smoke=True), tree, "cpu")
    with pytest.raises(ValueError, match="stacked 3 deep"):
        convert.lm_params(get_config("qwen3-1.7b", smoke=True).replace(
            n_layers=3), tree, "cpu")
    params = convert.lm_params(get_config("qwen3-1.7b", smoke=True), tree,
                               "cpu")
    assert params["layers"]["attn"]["wq"].shape == (2, 64, 64)


# ---------------------------------------------------------- common pieces --

def test_layer_norm_uses_the_population_variance(with_jax):
    """``jnp.var`` divides by n; torch's default divides by n - 1, which
    at width 8 moves the output by ~7 % (checked to fail here)."""
    x = _f32(_rng(1).standard_normal((3, 5, 8)) * 2.0 + 1.5)
    scale = _f32(_rng(2).standard_normal(8))
    bias = _f32(_rng(3).standard_normal(8))
    want = np.asarray(jcm.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias)))
    xt = torch.as_tensor(x)
    got = tcm.layer_norm(xt, torch.as_tensor(scale),
                         torch.as_tensor(bias)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    unbiased = ((xt - xt.mean(-1, keepdim=True))
                * torch.rsqrt(xt.var(-1, keepdim=True) + 1e-5)
                * torch.as_tensor(scale) + torch.as_tensor(bias)).numpy()
    assert not np.allclose(unbiased, want, rtol=1e-2, atol=1e-2)
    rms = tcm.rms_norm(xt, torch.as_tensor(scale)).numpy()
    np.testing.assert_allclose(
        rms, np.asarray(jcm.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=TOL, atol=TOL)


@pytest.mark.parametrize("act", ["gelu", "relu", "swiglu"])
def test_mlp_matches_jax(with_jax, act):
    """``jax.nn.gelu`` is the tanh approximation (the exact erf form is
    checked to differ by more than the tolerance here)."""
    gen = torch.Generator().manual_seed(4)
    p = tcm.mlp_params(gen, 16, 32, act, torch.float32, bias=True)
    for v in p.values():
        v.normal_(0.0, 0.5, generator=gen)
    x = _f32(_rng(4).standard_normal((2, 3, 16)) * 2.0)
    want = np.asarray(jcm.mlp_apply(
        {k: jnp.asarray(v.numpy()) for k, v in p.items()}, jnp.asarray(x),
        act))
    got = tcm.mlp_apply(p, torch.as_tensor(x), act).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if act == "gelu":
        h = torch.as_tensor(x) @ p["wi"] + p["bi"]
        erf = torch.nn.functional.gelu(h) @ p["wo"] + p["bo"]
        assert np.abs(erf.numpy() - want).max() > 1e-4


@pytest.mark.parametrize("sections,head_dim", [((4, 2, 2), 16),
                                               ((16, 24, 24), 128)])
def test_mrope_and_rope_match_jax(with_jax, sections, head_dim):
    """M-RoPE: each band of the half dimension rotated by its own (t, h, w)
    coordinate; then the rotation applied to a (B, T, H, D) tensor."""
    pos3 = _rng(6).integers(0, 300, (2, 3, 7))
    jc, js = jcm.mrope_freqs(head_dim, 1e6, jnp.asarray(pos3), sections)
    tc, ts = tcm.mrope_freqs(head_dim, 1e6, torch.as_tensor(pos3), sections)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOL, atol=TOL)
    x = _f32(_rng(7).standard_normal((2, 7, 3, head_dim)))
    np.testing.assert_allclose(
        tcm.apply_rope(torch.as_tensor(x), tc, ts).numpy(),
        np.asarray(jcm.apply_rope(jnp.asarray(x), jc, js)),
        rtol=TOL, atol=TOL)
    jc1, js1 = jcm.rope_freqs(head_dim, 1e4, jnp.arange(7))
    tc1, ts1 = tcm.rope_freqs(head_dim, 1e4, torch.arange(7))
    np.testing.assert_allclose(tc1.numpy(), np.asarray(jc1), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(
        tcm.apply_rope(torch.as_tensor(x), tc1, ts1).numpy(),
        np.asarray(jcm.apply_rope(jnp.asarray(x), jc1, js1)),
        rtol=TOL, atol=TOL)
    t3 = tcm.text_pos3(torch.arange(5)[None].expand(2, 5))
    assert t3.shape == (2, 3, 5) and bool((t3 == torch.arange(5)).all())


def test_softplus_is_jax_form(with_jax):
    """``jax.nn.softplus`` is ``logaddexp(x, 0)`` everywhere, past 20
    too."""
    x = _f32(np.linspace(-60.0, 60.0, 241))
    np.testing.assert_allclose(
        tmb.softplus(torch.as_tensor(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=TOL, atol=TOL)
    assert jmb.CONV_W == tmb.CONV_W


def test_cross_entropy_matches_jax(with_jax):
    logits = _f32(_rng(8).standard_normal((2, 5, 512)))
    labels = _rng(9).integers(0, 500, (2, 5))
    want = float(jcm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   500))
    got = float(tcm.cross_entropy(torch.as_tensor(logits),
                                  torch.as_tensor(labels), 500))
    assert abs(got - want) <= TOL * max(1.0, abs(want))


# ------------------------------------------------------------------ card --

@pytest.mark.cuda
@pytest.mark.parametrize("arch", lm_arch_ids())
def test_decode_kernel_matches_plain_on_card(cuda_device, arch):
    """At smoke size on the card: prefill, then decode through the
    hand-written kernel and through the plain form from the same cache,
    two steps (the second past ``max_seq``), with no host sync in a
    kernel step; logits within 2e-4 and every attention launch counted."""
    cfg = get_config(arch, smoke=True)
    model = LM(cfg, device=cuda_device)
    model.init(torch.Generator(device=cuda_device).manual_seed(0))
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    t = 16
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, t), generator=gen,
                                     device=cuda_device)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn(
            2, cfg.n_patches, cfg.d_model, generator=gen, device=cuda_device)
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn(
            2, t // cfg.enc_frames_ratio, cfg.d_model, generator=gen,
            device=cuda_device)
    max_seq = t + 1 + (cfg.n_patches if cfg.family == "vlm" else 0)
    _, cache = model.prefill(batch, max_seq)
    plain = {k: (v.clone() if isinstance(v, torch.Tensor)
                 else {kk: vv.clone() for kk, vv in v.items()})
             for k, v in cache.items()}
    tok = batch["tokens"][:, :1]
    attn_per_step = {"hybrid": cfg.n_layers // cfg.shared_attn_period,
                     "ssm": 0, "encdec": 2 * cfg.n_layers}.get(
        cfg.family, cfg.n_layers)
    for _ in range(2):
        torch.cuda.synchronize()
        before = _build.LAUNCHES["decode_attention"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            lk, cache = model.decode_step(tok, cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert _build.LAUNCHES["decode_attention"] - before == attn_per_step
        lp, plain = model.decode_step(tok, plain, plain=True)
        assert bool(torch.isfinite(lk).all())
        torch.testing.assert_close(lk, lp, rtol=CARD_TOL, atol=CARD_TOL)
        tok = lk[:, -1].argmax(-1, keepdim=True)
