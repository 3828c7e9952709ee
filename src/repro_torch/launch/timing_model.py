"""Analytic per-kernel timing models for the CG benchmarks (the port's
copy of ``benchmarks/timing_model.py``, kept inside the package; ``CORI``,
``V5E`` and the kernel-time arithmetic unchanged, ``H100`` added).

Three hardware profiles:

  * ``cori``  — Cori Phase-I-like (Haswell + Aries dragonfly, 16 ranks/node):
    used to REPRODUCE the paper's Figs. 2-4 regime (µs-scale software
    all-reduce latency growing ~log2(P), memory-bound SPMV).
  * ``v5e``   — TPU v5e pod (197 TFLOP/s bf16, 819 GB/s HBM, 50 GB/s ICI,
    hardware collectives): the JAX package's target; per-hop ICI latency
    with mesh-diameter tree depth.
  * ``h100``  — one NVIDIA H100 SXM card, the port's target: datasheet
    rates until ``launch.autotune.recalibrate_profile`` replaces them with
    ones measured on the card.

``CORI`` and ``V5E`` describe other machines; no number of theirs is the
H100's.

Kernel times for a stencil problem with N unknowns on P workers:
  t_spmv  = max(flops/peak, bytes/hbm_bw) + halo_bytes/link_bw + t_msg
  t_axpy  = vector stream bytes / hbm_bw            (perfectly parallel)
  t_glred = alpha * ceil(log2 P) + payload/link_bw  (latency dominated)

These are MODELS (this container cannot time a pod); every parameter is
explicit and the benchmarks print them alongside results.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class HWProfile:
    name: str
    flop_rate: float        # per worker, FLOP/s (f64 for cori)
    mem_bw: float           # per worker, bytes/s
    link_bw: float          # network per worker, bytes/s
    alpha: float            # per-TREE-STAGE latency of the software
                            # all-reduce (s) — the monolithic glred term
    hops: str = "log2"      # tree depth model: log2 | mesh2d
    # Per-RING-HOP latency of one point-to-point neighbour message (s):
    # the staged ladder's unit cost (DESIGN.md §14).  A ring hop is a
    # bare nearest-neighbour send — no software tree stage, no
    # async-progress thread hand-off — so it is substantially cheaper
    # than ``alpha``; None falls back to ``alpha`` (pessimistic).
    alpha_hop: float | None = None

    @property
    def hop_latency(self) -> float:
        return self.alpha if self.alpha_hop is None else self.alpha_hop


CORI = HWProfile(
    name="cori-haswell",
    flop_rate=36.8e9,       # 2.3 GHz Haswell core * 16 flops/cycle (f64 AVX2)
    mem_bw=7.2e9,           # ~115 GB/s per node / 16 ranks
    link_bw=1.0e9,          # Aries per-rank effective
    alpha=10e-6,            # MPI software latency per tree stage incl. the
                            # async-progress/thread-safety overhead the
                            # paper itself flags as significant (§5)
    alpha_hop=2.0e-6,       # Aries nearest-neighbour put latency: no MPI
                            # software tree stage on the critical path
)

V5E = HWProfile(
    name="tpu-v5e",
    flop_rate=197e12 * 0.03,  # stencils are VPU/memory bound, not MXU: ~3%
    mem_bw=819e9,
    link_bw=50e9,
    alpha=1.0e-6,
    hops="mesh2d",
    alpha_hop=1.0e-6,         # ICI is already per-hop
)

# NVIDIA's H100 SXM datasheet, not a measurement: 34 TFLOP/s fp64 outside
# the tensor cores, 3.35 TB/s HBM3, NVLink 4 at 450 GB/s one way, all at the
# full 700 W.  The datasheet gives no latency: ``alpha`` and ``alpha_hop``
# are placeholders of the order of a kernel launch (5 us, 2 us) until
# ``recalibrate_profile`` puts the card's measured reduction in their place.
H100 = HWProfile(
    name="nvidia-h100-sxm",
    flop_rate=34e12,
    mem_bw=3.35e12,
    link_bw=450e9,
    alpha=5.0e-6,
    alpha_hop=2.0e-6,
)


def ring_hop_time(hw: HWProfile, payload: int) -> float:
    """Seconds for ONE staged-ladder hop: a point-to-point neighbour
    message carrying the full dot-block payload (DESIGN.md §14)."""
    return hw.hop_latency + payload / hw.link_bw


def tree_depth(hw: HWProfile, p: int) -> float:
    if hw.hops == "mesh2d":
        side = max(int(math.sqrt(p)), 1)
        return 2 * (side - 1) or 1
    return max(math.ceil(math.log2(max(p, 2))), 1)


def stencil_kernel_times(hw: HWProfile, n: int, p: int,
                         stencil_pts: int = 5, dsize: int = 8,
                         halo_elems: int | None = None,
                         glred_payload: int = 64,
                         prec_factor: float = 1.0) -> dict:
    """Per-iteration kernel times (seconds) for a CG iteration on an
    N-unknown stencil problem over P workers.  ``prec_factor`` scales the
    local-solve cost of the preconditioner relative to the bare SPMV
    (block-Jacobi + per-block ILU ~ 3x, as in the paper's SNES ex48 runs)."""
    n_loc = n / p
    flops = 2.0 * stencil_pts * n_loc
    if hw.name.startswith("cori"):
        # PETSc AIJ (CSR): per row, nnz*(8B value + 4B col idx) + x + y.
        # The TPU port is MATRIX-FREE (stencil weights in registers), which
        # is the DESIGN.md §2 hardware adaptation — ~4x fewer bytes.
        bytes_spmv = n_loc * (stencil_pts * 12.0 + 2 * dsize)
    else:
        bytes_spmv = 3.0 * dsize * n_loc        # read x, write y (+halo reuse)
    if halo_elems is None:
        halo_elems = int(n_loc ** (1 / 2)) if stencil_pts == 5 \
            else int(n_loc ** (2 / 3))
    t_spmv_stream = prec_factor * max(flops / hw.flop_rate,
                                      bytes_spmv / hw.mem_bw)
    t_spmv_comm = 2 * halo_elems * dsize / hw.link_bw + 2 * hw.alpha
    t_spmv = t_spmv_stream + t_spmv_comm
    # one AXPY/DOT pass = 3 streams (2 read + 1 write) over n_loc
    t_axpy1 = 3.0 * dsize * n_loc / hw.mem_bw
    t_glred = hw.alpha * tree_depth(hw, p) + glred_payload / hw.link_bw
    # spmv_stream / spmv_comm expose the split so the autotuner can
    # recalibrate the HBM-stream part against a MEASURED bytes/iteration
    # (cost_analysis; launch.autotune.model_iteration_time) while the
    # halo/latency part stays analytic.
    return {"spmv": t_spmv, "axpy1": t_axpy1, "glred": t_glred,
            "spmv_stream": t_spmv_stream, "spmv_comm": t_spmv_comm}


def diagonal_kernel_times(hw: HWProfile, n: int, p: int, dsize: int = 8,
                          glred_payload: int = 64) -> dict:
    """The paper's "one-point stencil" communication-bound toy: SPMV is a
    single elementwise stream, no halo."""
    n_loc = n / p
    t_spmv = 3.0 * dsize * n_loc / hw.mem_bw
    t_axpy1 = 3.0 * dsize * n_loc / hw.mem_bw
    t_glred = hw.alpha * tree_depth(hw, p) + glred_payload / hw.link_bw
    return {"spmv": t_spmv, "axpy1": t_axpy1, "glred": t_glred}
