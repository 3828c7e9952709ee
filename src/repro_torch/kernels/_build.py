"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ``ctypes``.  All sources are compiled at first use,
in parallel (one ``nvcc`` per source), into ``build/<hash>/`` beside this
module, where ``<hash>`` covers every source, header and flag, so an edit
rebuilds and an unchanged tree reuses the libraries.

``--fmad=false`` keeps every multiply and add separately rounded, in the
order the plain PyTorch versions use, which makes the kernels' row
updates bitwise equal to those versions on the card.

``LAUNCHES`` counts kernel launches by wrapper name: each wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
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
    "stencil_spmv.cu",
)
HEADERS = ("fused_iter.cuh",)
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
        nvcc = _nvcc()
        procs = []
        for src in SOURCES:
            lib = os.path.join(out_dir, src[:-3] + ".so")
            if os.path.isfile(lib):
                continue
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
        _build_dir = out_dir
        return out_dir


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The built library ``csrc/<name>.cu`` with ``argtypes`` set from
    ``signatures`` (every C entry returns ``cudaError_t`` as an int)."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(os.path.join(build_all(), name + ".so"))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (its launch was refused
    or an earlier asynchronous fault surfaced)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
