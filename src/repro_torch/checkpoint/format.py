"""Content-hashed, versioned on-disk checkpoint format: the counterpart of
``repro/checkpoint/format.py``, byte-compatible with it both ways.

One checkpoint = one ``.npz`` file holding the solver-state payload
(named numpy arrays) plus a ``__meta__`` uint8 JSON blob carrying the
format version, a sha256 content hash over every payload array (name +
dtype + shape + bytes, in sorted key order), and the solver configuration
the state belongs to.  Writes are atomic (temp file + ``os.replace``), so a
process killed mid-save never leaves a half-written file that a later
restore would trust.

Every failure surfaces as a typed :class:`CheckpointError` subclass.  One
repair against the JAX package: ``load_checkpoint`` maps EVERY exception
raised while reading the file to :class:`CheckpointCorruptError`
(``zipfile``'s ``NotImplementedError`` for a corrupted version byte,
``zlib.error``, ``UnicodeDecodeError`` included), where the reference's
``except`` list lets some through.  ``FileNotFoundError`` stays the
signal of a missing file only.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

# Format version of the on-disk layout (the JAX package's).  Loads of
# other versions raise CheckpointVersionError.
CKPT_VERSION = 1

_META_KEY = "__meta__"


class CheckpointError(RuntimeError):
    """Base class for every checkpoint save/restore failure."""


class CheckpointCorruptError(CheckpointError):
    """The file is unreadable, truncated, or fails its content hash."""


class CheckpointVersionError(CheckpointError):
    """The file's format version differs from :data:`CKPT_VERSION`."""


class CheckpointMismatchError(CheckpointError):
    """The stored state does not match the restoring solver's
    configuration (different l / maxit / state structure / dtype /
    operator size)."""


class CheckpointCertificationError(CheckpointError):
    """The restored iterate failed the true-residual certification: the
    state decoded cleanly but does not reproduce the residual recorded at
    save time."""


def content_hash(payload: dict[str, np.ndarray]) -> str:
    """sha256 over the payload arrays: key, NUL, dtype, shape and raw bytes
    in sorted key order."""
    h = hashlib.sha256()
    for k in sorted(payload):
        a = np.ascontiguousarray(payload[k])
        h.update(k.encode())
        h.update(b"\x00")
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.data if a.size else b"")
    return h.hexdigest()


def save_checkpoint(path: str, payload: dict[str, np.ndarray],
                    meta: dict) -> dict:
    """Write ``payload`` + ``meta`` atomically to ``path``.

    The stored meta gains ``version`` and ``sha256`` keys; the enriched
    dict is returned.  Keys starting with ``__`` are reserved.
    """
    for k in payload:
        if k.startswith("__"):
            raise ValueError(f"payload key {k!r} is reserved")
    arrays = {k: np.asarray(v) for k, v in payload.items()}
    return _write_checkpoint(path, arrays, meta, content_hash(arrays))


def _write_checkpoint(path: str, arrays: dict[str, np.ndarray], meta: dict,
                      sha256: str) -> dict:
    """``save_checkpoint`` with the payload's ``content_hash`` given (the
    snapshot callback times the hash and the write apart)."""
    meta = dict(meta)
    meta["version"] = CKPT_VERSION
    meta["sha256"] = sha256
    blob = np.frombuffer(json.dumps(meta, sort_keys=True).encode("utf-8"),
                         dtype=np.uint8)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **{_META_KEY: blob}, **arrays)
        os.replace(tmp, path)                       # atomic commit
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return meta


def load_checkpoint(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Load and verify one checkpoint; returns ``(payload, meta)``.

    Raises FileNotFoundError for a missing file (the caller's "no
    checkpoint yet" signal), :class:`CheckpointCorruptError` for anything
    unreadable or hash-mismatched, and :class:`CheckpointVersionError` for
    a foreign format version.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with np.load(path, allow_pickle=False) as z:
            files = list(z.files)
            if _META_KEY not in files:
                raise CheckpointCorruptError(f"{path}: no {_META_KEY} entry")
            meta = json.loads(bytes(np.asarray(z[_META_KEY])))
            payload = {k: np.asarray(z[k]) for k in files if k != _META_KEY}
        if not isinstance(meta, dict):
            raise CheckpointCorruptError(f"{path}: meta is not an object")
    except CheckpointError:
        raise
    except Exception as e:      # whatever the reader raised: unreadable
        raise CheckpointCorruptError(
            f"{path}: unreadable checkpoint ({type(e).__name__}: {e})"
        ) from e
    version = meta.get("version")
    if version != CKPT_VERSION:
        raise CheckpointVersionError(
            f"{path}: format version {version!r} != {CKPT_VERSION}")
    recorded = meta.get("sha256")
    actual = content_hash(payload)
    if recorded != actual:
        raise CheckpointCorruptError(
            f"{path}: content hash mismatch (stored {recorded!r}, "
            f"computed {actual!r})")
    return payload, meta
