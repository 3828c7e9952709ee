"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ``ctypes``.  All sources are compiled at first use,
in parallel (one ``nvcc`` per source), into ``build/<hash>/`` beside this
module, where ``<hash>`` covers every source, header and flag, so an edit
rebuilds and an unchanged tree reuses the libraries.  The threads of a
process take a lock, and the processes sharing a checkout (the ranks of a
group) an ``fcntl`` lock on ``build/<hash>.lock``, so only one compiles
and the others load what it built.

``--fmad=false`` keeps every multiply and add separately rounded, in the
order the plain PyTorch versions use, which makes the kernels' row
updates bitwise equal to those versions on the card.

``LAUNCHES`` counts kernel launches by wrapper name: each wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
SOURCES = (
    "fused_iter_stencil2d5.cu",
    "fused_iter_stencil3d7.cu",
    "fused_iter_stencil3d27.cu",
    "fused_iter_diagonal.cu",
    "fused_iter_ell.cu",
    "fused_iter_stencil2d5_halo.cu",
    "fused_iter_stencil3d7_halo.cu",
    "fused_iter_ell_halo.cu",
    "stencil_spmv.cu",
    "ell_spmv.cu",
    "fused_dots.cu",
    "fused_axpy.cu",
    "decode_attention.cu",
)
HEADERS = ("fused_iter.cuh", "bulk_copy.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_build_dir: str | None = None


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for base in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = os.path.join(base, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_all() -> str:
    """Compile every source not yet built for this hash; returns the
    build directory.  Raises with nvcc's output if a build fails."""
    global _build_dir
    with _lock:
        if _build_dir is not None:
            return _build_dir
        out_dir = os.path.join(BUILD_ROOT, source_hash())
        os.makedirs(out_dir, exist_ok=True)
        with open(out_dir + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            _compile(out_dir)
        _build_dir = out_dir
        return out_dir


def _compile(out_dir: str) -> None:
    """Compile every source whose library is missing from ``out_dir``."""
    nvcc = None
    procs = []
    for src in SOURCES:
        lib = os.path.join(out_dir, src[:-3] + ".so")
        if os.path.isfile(lib):
            continue
        nvcc = nvcc or _nvcc()
        tmp = f"{lib}.{os.getpid()}.tmp"
        log = open(os.path.join(out_dir, src[:-3] + ".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, src)]
        procs.append((src, lib, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for src, lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            with open(log.name) as f:
                failed.append(f"{src} (rc {rc}):\n{f.read()}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The built library ``csrc/<name>.cu`` with ``argtypes`` set from
    ``signatures`` (every C entry returns ``cudaError_t`` as an int).
    Entries are typed on every call, so a library first loaded for one of
    its entries has the others typed when they are asked for."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(os.path.join(build_all(), name + ".so"))
        _libs[name] = lib
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        if f.argtypes != argtypes:
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (its launch was refused
    or an earlier asynchronous fault surfaced)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
