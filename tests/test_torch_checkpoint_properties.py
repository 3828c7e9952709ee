"""Hypothesis property tests of the port's checkpoint format
(``repro_torch.checkpoint.format``), mirroring
``tests/test_checkpoint_properties.py`` over arbitrary payloads:

* save -> load is bitwise lossless (arrays and meta);
* any truncation of the file raises a typed :class:`CheckpointError`;
* any single-byte corruption either raises a typed error or provably
  changed nothing (a flip in zip bookkeeping the reader never trusts);
* a foreign format version always refuses with
  :class:`CheckpointVersionError`.

Unlike the reference, every exception the reader raises is a typed
:class:`CheckpointCorruptError`: the pinned example (one float64 leaf,
the byte at 0.79296875 of the file plus 19) corrupts the zip's "version
needed to extract", which the reference lets through as ``zipfile``'s
``NotImplementedError``.  Draws are derandomized and no example database
is read or written, so every run checks the same examples.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="hypothesis not installed")
from hypothesis import example, given, settings, strategies as st  # noqa: E402

from repro_torch.checkpoint import (CKPT_VERSION,  # noqa: E402
                                    CheckpointCorruptError, CheckpointError,
                                    CheckpointVersionError, content_hash,
                                    load_checkpoint, save_checkpoint)

HAVE_JAX = importlib.util.find_spec("jax") is not None

SET = dict(max_examples=25, deadline=None, derandomize=True, database=None)

_DTYPES = [np.float64, np.float32, np.int64, np.int32, np.bool_]

# The reference's failing example: one float64 0-d leaf.
PINNED = {"leaf_000": np.zeros((), np.float64)}


@st.composite
def payloads(draw):
    """A checkpoint payload: 1..5 named arrays of small shapes and mixed
    dtypes, deterministic from a drawn seed."""
    n_leaves = draw(st.integers(1, 5))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n_leaves):
        dt = _DTYPES[draw(st.integers(0, len(_DTYPES) - 1))]
        ndim = draw(st.integers(0, 3))
        shape = tuple(draw(st.integers(1, 5)) for _ in range(ndim))
        a = rng.standard_normal(shape)
        out[f"leaf_{i:03d}"] = (a > 0) if dt is np.bool_ \
            else a.astype(dt) if np.issubdtype(dt, np.floating) \
            else (a * 100).astype(dt)
    return out


def _flip(path: str, pos: float, delta: int) -> None:
    raw = bytearray(open(path, "rb").read())
    i = min(int(pos * len(raw)), len(raw) - 1)
    raw[i] = (raw[i] + delta) % 256
    with open(path, "wb") as f:
        f.write(bytes(raw))


@given(payload=payloads(), tag=st.text(
    alphabet=st.characters(min_codepoint=32, max_codepoint=126), max_size=20))
@settings(**SET)
def test_save_load_bitwise(tmp_path_factory, payload, tag):
    path = str(tmp_path_factory.mktemp("ckpt") / "ckpt_0000000001.npz")
    meta_in = {"kind": "prop", "tag": tag, "count": len(payload)}
    stored = save_checkpoint(path, payload, meta_in)
    assert stored["version"] == CKPT_VERSION
    assert stored["sha256"] == content_hash(payload)
    back, meta = load_checkpoint(path)
    assert set(back) == set(payload)
    for k in payload:
        assert back[k].dtype == payload[k].dtype
        assert back[k].shape == payload[k].shape
        assert back[k].tobytes() == payload[k].tobytes()
    assert meta["tag"] == tag and meta["count"] == len(payload)


@given(payload=payloads(), frac=st.floats(0.01, 0.99))
@settings(**SET)
def test_truncation_is_typed(tmp_path_factory, payload, frac):
    path = str(tmp_path_factory.mktemp("ckpt") / "ckpt_0000000001.npz")
    save_checkpoint(path, payload, {"kind": "prop"})
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:max(1, int(len(raw) * frac))])
    with pytest.raises(CheckpointError):
        load_checkpoint(path)


@given(payload=payloads(), pos=st.floats(0.0, 1.0), delta=st.integers(1, 255))
@example(payload=PINNED, pos=0.79296875, delta=19)
@settings(**SET)
def test_single_byte_corruption_never_loads_silently(tmp_path_factory,
                                                     payload, pos, delta):
    """Flip one byte anywhere: a typed refusal, or a load BITWISE equal
    to the original (the flip hit bookkeeping the reader never trusts)."""
    path = str(tmp_path_factory.mktemp("ckpt") / "ckpt_0000000001.npz")
    save_checkpoint(path, payload, {"kind": "prop"})
    clean, clean_meta = load_checkpoint(path)
    _flip(path, pos, delta)
    try:
        back, meta = load_checkpoint(path)
    except CheckpointError:
        return                         # typed refusal: the contract
    assert set(back) == set(clean)
    for k in clean:
        assert back[k].tobytes() == clean[k].tobytes()
        assert back[k].dtype == clean[k].dtype
    assert meta == clean_meta


def test_pinned_example_is_a_corrupt_checkpoint(tmp_path):
    """The pinned example raises ``CheckpointCorruptError`` in the port
    (the reference raises zipfile's ``NotImplementedError`` there)."""
    path = str(tmp_path / "ckpt_0000000001.npz")
    save_checkpoint(path, PINNED, {"kind": "prop"})
    raw = open(path, "rb").read()
    _flip(path, 0.79296875, 19)
    with pytest.raises(CheckpointCorruptError, match="version 6.4"):
        load_checkpoint(path)
    if HAVE_JAX:
        from repro.checkpoint import load_checkpoint as jload

        with pytest.raises(NotImplementedError):
            jload(path)
    with open(path, "wb") as f:
        f.write(raw)
    assert load_checkpoint(path)[0]["leaf_000"].tobytes() == \
        PINNED["leaf_000"].tobytes()


@given(payload=payloads(), version=st.integers(-5, 50))
@settings(**SET)
def test_foreign_version_refused(tmp_path_factory, payload, version):
    if version == CKPT_VERSION:
        version += 1
    path = str(tmp_path_factory.mktemp("ckpt") / "ckpt_0000000001.npz")
    save_checkpoint(path, payload, {"kind": "prop"})
    _, meta = load_checkpoint(path)
    meta["version"] = version
    blob = np.frombuffer(json.dumps(meta, sort_keys=True).encode(),
                         dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, __meta__=blob, **payload)
    with pytest.raises(CheckpointVersionError):
        load_checkpoint(path)


def test_reserved_keys_rejected(tmp_path):
    with pytest.raises(ValueError):
        save_checkpoint(str(tmp_path / "x.npz"), {"__meta__": np.zeros(1)},
                        {})


def test_missing_file_is_filenotfound(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "nope.npz"))
    # Not a CheckpointError: "no checkpoint yet" is the cold-start signal.
    assert not issubclass(FileNotFoundError, CheckpointCorruptError)
    assert not os.path.exists(str(tmp_path / "nope.npz"))
