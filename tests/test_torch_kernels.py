"""The port's fused dot block, fused three-term recurrence, decode attention
and split-KV merge (``repro_torch.kernels.ops``, ``repro_torch.models.
attention``), held against the JAX package on the CPU at small sizes.  The
JAX side runs its Pallas kernels in interpret mode (``repro.kernels.ops``)
and its oracles (``repro.kernels.ref``); inputs come from a numpy seed.

Tolerances:
* fused dots: both sides cast to fp32 and accumulate in fp32, in other
  orders, so per entry |diff| <= 1e-5 * sum_j |m_kj v_js| (an fp32
  accumulation bound: about 80 fp32 ulps of the sum of magnitudes).
* fused_axpy3: the port rounds each multiply and add on its own; XLA may
  contract a multiply-add into one FMA, which drops up to two of the four
  roundings.  Per element |diff| <= 4 * eps32 * (|x| + |c1 y| + |c2 z|) *
  |s|.
* decode attention: fp32 softmax and products summed in other orders;
  rtol = atol = 2e-4, the JAX package's own bound for its kernel
  (``tests/test_kernels.py``).  m is a max of fp32 scores: rtol 1e-5.
* the split-KV merge of the port against JAX's on the same statistics: one
  exp and a sum over at most 8 shards in fp32, rtol = atol = 1e-6.
* ``decode_attention_torch`` against ``decode_attention_jnp``: the same
  fp32 formula with other sum orders, rtol = atol = 2e-5.
"""

import importlib.util

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

# A card's machine has no JAX and runs only the cuda tests; where JAX is
# installed, the reference package is imported unguarded.
HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import attention as jatt

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import fused_axpy as tfa  # noqa: E402
from repro_torch.kernels import fused_dots as tfd  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402

DOTS_BOUND = 1e-5
EPS32 = float(np.finfo(np.float32).eps)
ATT_TOL = 2e-4


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


def _normal(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


def _assert_dots(got, want, m, vecs):
    scale = np.abs(m.astype(np.float64)) @ np.abs(vecs.astype(np.float64))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= DOTS_BOUND * scale).all(), float((err / scale).max())


@pytest.mark.parametrize("k,n,s", [(1, 128, 1), (5, 1000, 8), (7, 16384, 3),
                                   (11, 5000, 16), (3, 777, 1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_dots_match_jax(k, n, s, dtype, with_jax):
    rng = np.random.default_rng(k * n + s)
    m = _normal(rng, (k, n), dtype)
    vecs = _normal(rng, (n, s), dtype)
    got = tops.fused_dots_mrhs(torch.tensor(m), torch.tensor(vecs))
    assert got.shape == (k, s) and got.dtype == torch.tensor(m).dtype
    _assert_dots(got.numpy(), jops.fused_dots_mrhs(jnp.asarray(m),
                                                   jnp.asarray(vecs)), m, vecs)
    _assert_dots(got.numpy(), jref.fused_dots_ref(jnp.asarray(m),
                                                  jnp.asarray(vecs)), m, vecs)
    if s == 1:
        one = tops.fused_dots(torch.tensor(m), torch.tensor(vecs[:, 0]))
        assert one.shape == (k,)
        _assert_dots(one.numpy()[:, None],
                     np.asarray(jops.fused_dots(jnp.asarray(m),
                                                jnp.asarray(vecs[:, 0])))[:, None],
                     m, vecs)


@pytest.mark.parametrize("coeffs", [(0.5, -1.25, 2.0), (0.0, 0.0, 1.0),
                                    (1e3, -1e-3, 0.1)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_axpy3_matches_jax(coeffs, dtype, with_jax):
    rng = np.random.default_rng(7)
    c1, c2, s = coeffs
    for n in (1000, 4099):
        x, y, z = (_normal(rng, (n,), dtype) for _ in range(3))
        got = tops.fused_axpy3(torch.tensor(x), torch.tensor(y),
                               torch.tensor(z), c1, c2, s)
        assert got.dtype == torch.tensor(x).dtype and got.shape == (n,)
        bound = 4 * EPS32 * (np.abs(x) + abs(c1) * np.abs(y)
                             + abs(c2) * np.abs(z)) * abs(s)
        args = tuple(jnp.asarray(a) for a in (x, y, z)) + coeffs
        for want in (jops.fused_axpy3(*args), jref.fused_axpy3_ref(*args)):
            assert np.asarray(want).dtype == x.dtype
            err = np.abs(got.numpy().astype(np.float64)
                         - np.asarray(want, np.float64))
            assert (err <= bound).all()


@pytest.mark.parametrize("b,h,hkv,d,s,kv_len,bs", [
    (2, 8, 2, 64, 1000, 900, 256),    # GQA, kv_len < S, ragged last block
    (1, 4, 4, 32, 512, 512, 128),     # MHA
    (3, 6, 1, 16, 300, 123, 512),     # MQA, one block longer than S
])
def test_decode_attention_matches_jax(b, h, hkv, d, s, kv_len, bs, with_jax):
    rng = np.random.default_rng(s + kv_len)
    q = _normal(rng, (b, h, d))
    k = _normal(rng, (b, s, hkv, d))
    v = _normal(rng, (b, s, hkv, d))
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out = tops.decode_attention(tq, tk, tv, kv_len, block_s=bs)
    assert out.shape == (b, h, d) and out.dtype == torch.float32
    np.testing.assert_allclose(
        out.numpy(), jops.decode_attention(jq, jk, jv, kv_len, block_s=bs),
        rtol=ATT_TOL, atol=ATT_TOL)
    o, m, l = tops.decode_attention_stats(tq, tk, tv, kv_len, block_s=bs)
    jo, jm, jl = jops.decode_attention_stats(jq, jk, jv, kv_len, block_s=bs)
    assert o.shape == (b, hkv, h // hkv, d) and m.shape == l.shape == (
        b, hkv, h // hkv, 1)
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((o / l).numpy(), np.asarray(jo / jl),
                               rtol=ATT_TOL, atol=ATT_TOL)
    # The oracle copy (-inf fill, (B, Hkv, S, D) layout) against JAX's.
    g = h // hkv
    want = jref.decode_attention_ref(jq.reshape(b, hkv, g, d),
                                     jnp.transpose(jk, (0, 2, 1, 3)),
                                     jnp.transpose(jv, (0, 2, 1, 3)), kv_len)
    got = tref.decode_attention_ref(tq.reshape(b, hkv, g, d),
                                    tk.permute(0, 2, 1, 3),
                                    tv.permute(0, 2, 1, 3), kv_len)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATT_TOL, atol=ATT_TOL)
    np.testing.assert_allclose(out.numpy(), got.reshape(b, h, d).numpy(),
                               rtol=ATT_TOL, atol=ATT_TOL)


def test_decode_attention_kv_len_zero_matches_jax_wrapper(with_jax):
    """With no valid position the JAX wrapper (S padded to a multiple of
    block_s, scores -1e30) returns m = -1e30, o = the sum of v and l = the
    padded length; the port returns the same, where the JAX oracle's
    -inf fill gives NaN."""
    rng = np.random.default_rng(3)
    b, h, hkv, d, s, bs = 2, 4, 2, 32, 300, 128
    q, k, v = (_normal(rng, sh) for sh in ((b, h, d), (b, s, hkv, d),
                                           (b, s, hkv, d)))
    o, m, l = tops.decode_attention_stats(torch.tensor(q), torch.tensor(k),
                                          torch.tensor(v), 0, block_s=bs)
    jo, jm, jl = jops.decode_attention_stats(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v), 0, block_s=bs)
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_array_equal(l.numpy(), jl)
    assert float(l.flatten()[0]) == 384.0
    np.testing.assert_allclose(o.numpy(), jo, rtol=ATT_TOL, atol=ATT_TOL)
    out = tops.decode_attention(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), 0, block_s=bs)
    np.testing.assert_allclose(
        out.numpy(), jops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), 0, block_s=bs),
        rtol=ATT_TOL, atol=ATT_TOL)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("shards,kv_len", [(2, 512), (8, 512), (8, 300)])
def test_split_kv_merge_identity(shards, kv_len, with_jax):
    """Each shard's stats (its own valid length, 0 for a shard past
    kv_len) merged with ``merge_decode_shards`` equal the whole-cache
    decode, and the port's merge equals JAX's (pmax + psum over a vmapped
    shard axis) on the same statistics."""
    rng = np.random.default_rng(shards + kv_len)
    b, h, hkv, d, s = 2, 4, 2, 32, 512
    q = torch.tensor(_normal(rng, (b, h, d)))
    k = torch.tensor(_normal(rng, (b, s, hkv, d)))
    v = torch.tensor(_normal(rng, (b, s, hkv, d)))
    w = s // shards
    stats = [tops.decode_attention_stats(
        q, k[:, i * w:(i + 1) * w].contiguous(),
        v[:, i * w:(i + 1) * w].contiguous(),
        min(max(kv_len - i * w, 0), w), block_s=32) for i in range(shards)]
    o, m, l = (torch.stack([st[j] for st in stats]) for j in range(3))
    merged = tatt.merge_decode_shards(o, m, l).reshape(b, h, d)
    full = tops.decode_attention(q, k, v, kv_len, block_s=128)
    np.testing.assert_allclose(merged.numpy(), full.numpy(), rtol=ATT_TOL,
                               atol=ATT_TOL)
    np.testing.assert_allclose(
        merged.numpy(), jops.decode_attention(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
            jnp.asarray(v.numpy()), kv_len, block_s=128),
        rtol=ATT_TOL, atol=ATT_TOL)
    jmerge = jax.vmap(lambda a, bb, c: jatt.merge_decode_shards(a, bb, c, "p"),
                      axis_name="p")
    jm = np.asarray(jmerge(jnp.asarray(o.numpy()), jnp.asarray(m.numpy()),
                           jnp.asarray(l.numpy())))[0]
    np.testing.assert_allclose(merged.numpy(), jm.reshape(b, h, d),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,h,hkv,d,s,kv_len", [
    (2, 8, 2, 64, 200, 150), (1, 4, 4, 32, 64, 64), (3, 6, 1, 16, 100, 1)])
def test_decode_attention_torch_matches_jnp(b, h, hkv, d, s, kv_len, with_jax):
    assert jatt.DECODE_UPCAST
    rng = np.random.default_rng(b * s + kv_len)
    q, k, v = (_normal(rng, sh) for sh in ((b, h, d), (b, s, hkv, d),
                                           (b, s, hkv, d)))
    got = tatt.decode_attention_torch(torch.tensor(q), torch.tensor(k),
                                      torch.tensor(v), kv_len)
    want = jatt.decode_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), kv_len)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    kern = tops.decode_attention(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), kv_len)
    np.testing.assert_allclose(kern.numpy(), got.numpy(), rtol=ATT_TOL,
                               atol=ATT_TOL)


@pytest.mark.parametrize("s,bs,kv_len", [
    (300, 128, 301),          # S + 1: one zero padding position counts
    (300, 128, 391),          # S_padded + 7: all 84 padding positions count
    (300, 128, -1),           # negative: no valid position, as kv_len = 0
    (256, 128, 300),          # S a multiple of block_s: nothing to fold
])
def test_decode_attention_kv_len_edges_match_jax_wrapper(s, bs, kv_len,
                                                         with_jax):
    """kv_len past S or below 0: the JAX wrapper pads S to a multiple of
    block_s with zero k/v and counts the padding below kv_len as valid
    positions (score 0, value 0), and masks everything for kv_len < 0; the
    port folds the same positions into its statistics."""
    rng = np.random.default_rng(s + kv_len)
    b, h, hkv, d = 2, 4, 2, 32
    q, k, v = (_normal(rng, sh) for sh in ((b, h, d), (b, s, hkv, d),
                                           (b, s, hkv, d)))
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o, m, l = tops.decode_attention_stats(tq, tk, tv, kv_len, block_s=bs)
    jo, jm, jl = jops.decode_attention_stats(jq, jk, jv, kv_len, block_s=bs)
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), jl, rtol=ATT_TOL, atol=ATT_TOL)
    np.testing.assert_allclose(o.numpy(), jo, rtol=ATT_TOL, atol=ATT_TOL)
    np.testing.assert_allclose((o / l).numpy(), np.asarray(jo / jl),
                               rtol=ATT_TOL, atol=ATT_TOL)
    out = tops.decode_attention(tq, tk, tv, kv_len, block_s=bs)
    np.testing.assert_allclose(
        out.numpy(), jops.decode_attention(jq, jk, jv, kv_len, block_s=bs),
        rtol=ATT_TOL, atol=ATT_TOL)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("case", ["heads_not_grouped", "meta_device"])
def test_entry_points_refuse(case):
    q = torch.zeros(1, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    if case == "heads_not_grouped":
        with pytest.raises(ValueError, match="heads"):
            tops.decode_attention(torch.zeros(1, 3, 16), k, k, 4)
    else:
        meta = torch.device("meta")
        with pytest.raises(ValueError, match="device"):
            tfd.fused_dots_mrhs(torch.zeros(2, 8, device=meta),
                                torch.zeros(8, 1, device=meta))
        with pytest.raises(ValueError, match="device"):
            tfa.fused_axpy3(*(torch.zeros(8, device=meta),) * 3, 1, 1, 1)
        with pytest.raises(ValueError, match="device"):
            tda.decode_attention_stats(q.reshape(1, 2, 2, 16).to(meta),
                                       k.to(meta), k.to(meta), 4)


def _row_pieces(p, head):
    """What the kernel's items cover of a row whose first 16-byte boundary
    is element ``head``, in item order (csrc/fused_dots.cu): item q covers
    elements head + (q - 1) * vec .. + vec - 1 of those in [0, N), one
    16-byte vector when all are in range.  Yields (first, count, "vector"
    | "elements")."""
    for q in range(p.items):
        i0 = head + (q - 1) * p.vec
        lo, hi = max(i0, 0), min(i0 + p.vec, p.n)
        if lo < hi:
            yield lo, hi - lo, ("vector" if (lo, hi) == (i0, i0 + p.vec)
                                else "elements")


@pytest.mark.parametrize("k,n", [(1, 1), (5, 4194304), (5, 1001),
                                 (17, 4099), (20, 7)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_fused_dots_plan_covers_every_element_once(k, n, itemsize):
    """The kernel's launch plan, for S in {1, 3, 8, 20} and aligned and
    misaligned bases: every row in exactly one row chunk and every column
    in one column chunk; the items cover each element of each row exactly
    once; every vector piece of mat, and of vecs where the plan reads it in
    vectors, starts on a 16-byte boundary; the grid is one wave."""
    sms, per_sm = 132, 6
    vec = 16 // itemsize
    for s in (1, 3, 8, 20):
        for mat_off, vecs_off in ((0, 0), (itemsize, 0), (0, itemsize),
                                  (8, 8)):
            p = tfd.plan(k, n, s, itemsize, mat_off, vecs_off, sms,
                         lambda kc, sb, stage: per_sm)
            assert p.vec == vec and 1 <= p.kc <= tfd.KC_MAX
            assert p.gy * p.kc >= k > (p.gy - 1) * p.kc
            assert p.sb in tfd.SB_SIZES and p.gz * p.sb >= s > \
                (p.gz - 1) * p.sb
            assert 1 <= p.grid and p.grid * p.gy * p.gz <= max(
                sms * per_sm, p.gy * p.gz)
            assert p.partials == k * s * p.grid
            if s == 1 and p.uniform and k * n > 0:
                assert p.vecs_vec == ((vecs_off - mat_off) % 16 == 0)
            # The main shape (N = 2048^2) is checked by its plan fields:
            # walking its 10^6 items here would take minutes.
            for r in range(k if n <= 5000 else 0):
                seen = np.zeros(n, np.int64)
                h = (-(mat_off + r * n * itemsize) % 16) // itemsize
                assert p.heads[r] == h
                for lo, cnt, kind in _row_pieces(p, h):
                    seen[lo:lo + cnt] += 1
                    if kind == "vector":
                        assert cnt == vec
                        assert (mat_off + (r * n + lo) * itemsize) % 16 == 0
                        if s == 1 and p.vecs_vec:
                            assert (vecs_off + lo * itemsize) % 16 == 0
                assert (seen == 1).all()
            if n > 5000:
                assert p.items == (n - 1) // vec + 2
                assert p.uniform == (mat_off % 16 == 0 or n % vec == 0)
            if s > 1 and p.vecs_vec:
                assert s % vec == 0 and p.sb % vec == 0 and vecs_off % 16 == 0
            # A warp's staged vecs block: 32 items of vec rows of 8 values,
            # one contiguous aligned span starting at the items' first row.
            assert p.stage_vecs == (s == 8 and p.uniform
                                    and vecs_off % 16 == 0)
            if p.stage_vecs:
                assert p.gz == 1 and p.sb == 8
                first = p.heads[0] - vec        # item 0's first vecs row
                assert (vecs_off + first * 8 * itemsize) % 16 == 0
            assert p.uniform == (len(set(p.heads)) == 1)


@pytest.mark.cuda
def test_fused_dots_on_card(cuda_device):
    rng = np.random.default_rng(11)
    cases = [(5, 100003, 1), (5, 100003, 8), (11, 5000, 16), (3, 70000, 20),
             (20, 3000, 2), (1, 4097, 1), (17, 4099, 1), (17, 4099, 8),
             (5, 1001, 3), (1, 1, 1), (5, 1 << 20, 1), (5, 1 << 20, 8)]
    for dt in (torch.float64, torch.float32):
        for k, n, s in cases:
            for off in (0, 1):   # 1: both bases one element off the grid
                mbuf = torch.tensor(rng.standard_normal(k * n + off),
                                    dtype=dt, device=cuda_device)
                vbuf = torch.tensor(rng.standard_normal(n * s + off),
                                    dtype=dt, device=cuda_device)
                m = mbuf[off:].view(k, n)
                vecs = vbuf[off:].view(n, s)
                before = _build.LAUNCHES["fused_dots"]
                got = tfd.fused_dots_mrhs(m, vecs)
                assert _build.LAUNCHES["fused_dots"] == before + 1
                assert torch.equal(got, tfd.fused_dots_mrhs(m, vecs))
                _assert_dots(got.cpu().numpy(),
                             tfd.fused_dots_plain(m, vecs).cpu().numpy(),
                             m.cpu().numpy(), vecs.cpu().numpy())
                if s == 1:
                    one = tfd.fused_dots(m, vecs[:, 0])
                    assert torch.equal(one, got[:, 0])


@pytest.mark.cuda
def test_fused_axpy3_on_card(cuda_device):
    rng = np.random.default_rng(12)
    for dt in (torch.float32, torch.float64):
        for n in (1, 1000, 4099):
            x, y, z = (torch.tensor(rng.standard_normal(n), dtype=dt,
                                    device=cuda_device) for _ in range(3))
            for c in ((0.5, -1.25, 2.0), (0.0, 0.0, 1.0), (1e3, -1e-3, 0.1)):
                assert torch.equal(tfa.fused_axpy3(x, y, z, *c),
                                   tfa.fused_axpy3_plain(x, y, z, *c))
            # an unaligned view takes the element-wise path
            assert torch.equal(tfa.fused_axpy3(x[1:], y[1:], z[1:], 0.5, 2, 3),
                               tfa.fused_axpy3_plain(x[1:], y[1:], z[1:], 0.5,
                                                     2, 3))


@pytest.mark.cuda
def test_decode_attention_on_card(cuda_device):
    rng = np.random.default_rng(13)
    for (b, h, hkv, d, s, kv_len, bs, dt) in [
            (2, 8, 2, 64, 1000, 900, 256, torch.float32),
            (1, 4, 4, 32, 512, 512, 128, torch.float32),
            (3, 6, 1, 16, 300, 123, 512, torch.float32),
            (2, 16, 8, 128, 2048, 1999, 512, torch.bfloat16),
            (1, 4, 2, 256, 700, 0, 64, torch.float32),
            (1, 32, 2, 64, 999, 998, 100, torch.float32)]:
        q = torch.tensor(rng.standard_normal((b, h, d)), dtype=torch.float32,
                         device=cuda_device)
        k, v = (torch.tensor(rng.standard_normal((b, s, hkv, d)),
                             device=cuda_device).to(dt) for _ in range(2))
        qg = q.reshape(b, hkv, h // hkv, d)
        o, m, l = tda.decode_attention_stats(qg, k, v, kv_len, bs)
        op, mp, lp = tda.decode_attention_stats_plain(qg, k, v, kv_len)
        torch.testing.assert_close(o / l, op / lp, rtol=ATT_TOL, atol=ATT_TOL)
        torch.testing.assert_close(m, mp, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(l, lp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,bs,kv_len", [
    (300, 128, 300), (300, 128, 123), (300, 128, 0), (300, 128, -1),
    (300, 128, 305), (300, 128, 391), (256, 128, 300)])
@pytest.mark.parametrize("shape", [(), (1, 1)])
def test_decode_attention_tensor_kv_len_equals_int(s, bs, kv_len, shape):
    """kv_len as a 0-d or (1, 1) integer tensor (the JAX wrappers' device
    scalar) gives the integer path's result, bit for bit: the clamps and
    the edge folding run as tensor selects of the same expressions."""
    rng = np.random.default_rng(s + kv_len + 7)
    b, h, hkv, d = 2, 4, 2, 32
    q, k, v = (torch.tensor(_normal(rng, sh))
               for sh in ((b, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    kt = torch.tensor(kv_len, dtype=torch.int32).reshape(shape)
    for got, want in zip(
            tops.decode_attention_stats(q, k, v, kt, block_s=bs),
            tops.decode_attention_stats(q, k, v, kv_len, block_s=bs)):
        assert torch.equal(got, want)
    assert torch.equal(tops.decode_attention(q, k, v, kt, block_s=bs),
                       tops.decode_attention(q, k, v, kv_len, block_s=bs))
    with pytest.raises(ValueError, match="one integer"):
        tops.decode_attention_stats(q, k, v, torch.tensor([1, 2]))


@pytest.mark.cuda
def test_decode_attention_device_kv_len_on_card(cuda_device):
    """On the card a device kv_len is read by the kernel, with no host
    synchronisation, and gives the integer path's bits."""
    rng = np.random.default_rng(17)
    b, h, hkv, d, s, bs = 2, 16, 8, 128, 3000, 512
    q = torch.tensor(rng.standard_normal((b, h, d)), dtype=torch.float32,
                     device=cuda_device)
    k, v = (torch.tensor(rng.standard_normal((b, s, hkv, d)),
                         dtype=torch.float32, device=cuda_device)
            for _ in range(2))
    for kv_len in (s, 2345, 0, -1, s + 5, 3072 + 7):
        want = tops.decode_attention_stats(q, k, v, kv_len, block_s=bs)
        kt = torch.tensor([[kv_len]], dtype=torch.int32, device=cuda_device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tops.decode_attention_stats(q, k, v, kt, block_s=bs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for g, w in zip(got, want):
            assert torch.equal(g, w), kv_len
