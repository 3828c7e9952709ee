// Fused-iteration superkernel: one whole p(l)-CG vector phase in one pass
// over the (NV, N) state slab, for sm_90a.
//
// Replaces the Pallas kernel of repro/kernels/fused_iter.py
// (build_fused_iteration -> fiter, body `kernel`, with its SPMV plug-ins
// resident_spmv, diagonal_spmv and ell_spmv, single-device and
// halo-extended).  It computes, per column j of the slab:
// the SPMV of the ring-top z, the pointwise (Jacobi) preconditioner, the
// pipeline-fill copies, the K4 basis recurrences (ghysels or stable), the
// ring writes, the K6 x/p updates and the (2l+1) local dot-block products,
// and reduces the products to per-block partials.
//
// Bound: device-memory bytes.  Every slab row the iteration touches is read
// once and every updated row written once (17 distinct rows of N doubles in
// a late iteration at l = 2 with Jacobi), plus an ELL operator's cols and
// vals once; the arithmetic is a few dozen flops per column.  The design keeps one column per thread so each thread
// has a dozen independent coalesced loads in flight, and nothing of the
// slab is staged in shared memory.
//
// Design notes:
// * In place across blocks.  Row writes are per column and a thread loads
//   every operand row it needs at its column before it stores anything, so
//   the slab is updated in place, as the Pallas kernel's aliased output is.
// * The stencil and ELL SPMVs read the ring-top row at other blocks'
//   columns, so the wrapper's first launch copies that row to its own
//   buffer (the Pallas wrapper's `prepare(z_top)`); no block reads a row
//   another block writes.  No row of the phase writes the ring-top row
//   either (kernels/fused_iter.py `check_z_top_not_written`), so the
//   staged ELL kernel below reads it in place and takes no copy.
// * The ELL plug-in gathers from that copy, one row of W slots per thread,
//   and sums the slots in ell_rowsum's left-to-right order.  Its cols and
//   vals are row-major (n, W), so a thread reading its own row's slots
//   from device memory makes a warp's slot loads strided.  The staged ELL
//   kernels copy each block's tile of cols and vals, two contiguous spans,
//   into shared memory by two 1-D bulk copies on an mbarrier
//   (bulk_copy.cuh; a ragged last tile or a misaligned base by coalesced
//   ordinary loads into the same buffer), and the threads sum their rows
//   from there, ELL_CHUNK gathers issued before their sums.  The ELL halo
//   plug-in takes the same staged kernels, its gathers from the prepared
//   operand.  A W too wide for ELL_TILE_BYTES (the wrapper's plan,
//   kernels/fused_iter.py `ell_tile_plan`) keeps the direct reads, and so
//   does the runtime-depth kernel.
// * Store order and masks follow the plain version exactly: every mask is a
//   select, and a masked-off row write (which in the plain version stores
//   the row's original value back) is skipped only when no earlier write of
//   the same iteration hit that row, so it could not change anything.
// * --fmad=false and the plain version's order of operations make every row
//   update bitwise equal to the plain PyTorch version on the card.
// * No atomics.  The compile-time kernels reduce each block's (2l+1)
//   products in shared memory by a fixed pairwise tree over the 256
//   threads.  The runtime-depth kernel and the staged ELL kernels sum
//   each product across its warp (warp_sums8: a fixed butterfly over the
//   32 lanes), then the warp sums by a fixed tree (warps_sum): a block's 8
//   as ((w0 + w1) + (w2 + w3)) + ((w4 + w5) + (w6 + w7)), each 64-row
//   group's 2 as w0 + w1.  A second launch
//   sums the per-block partials in a fixed order (strided per thread, then
//   a tree).  The result is deterministic run to run.  These orders differ
//   from XLA's and from torch.sum's, and are the only reason the partials
//   differ from the plain version's.
// * idx and scal are read from device memory inside the kernels, so a
//   launch needs no host synchronisation.
// * Depth.  l <= LMAX is instantiated at compile time (per-thread arrays in
//   registers).  Deeper pipelines take fused_iter_kernel_rt, which keeps
//   l as a runtime argument.  Its loops have runtime bounds, so it loads
//   the operand rows in chunks of compile-time width (RT_REC_CHUNK depths
//   of the recurrence, three rows each; RT_CHUNK fill rows or products),
//   every load of a chunk before its arithmetic, for several loads in
//   flight a thread.  It keeps only the l fill and l recurrence values in
//   dynamic shared memory (they wait for the stores: every load of the
//   phase precedes its first store).  Each product is taken as its operand
//   row arrives (u_new is known from (K1) on) and summed across the warp
//   at once, so a product needs 8 doubles of a block, not 256.  The
//   registers (64 a thread, RT_MIN_BLOCKS) and the shared memory,
//   rt_smem_bytes(l) (about 4.2 KB a depth), set how many blocks an SM
//   holds (4 at l = 9 and 12, 3 at l = 16, 2 at l = 27), and the shared
//   memory bounds the depth (l <= 54 on an H100, 232 448 bytes a block).
//   Measured against one loop that issues a chunk of recurrence rows and
//   of products together (fewer round trips, but 80 registers: 3 blocks),
//   these split loops at 4 blocks were faster at l = 9 and 12 and level on
//   the depth ladder's l = 16 rung (scripts/superkernel_ab.py).  Both
//   kernels compute (K1) and (K6) by the same helpers and every row value
//   by the same expression, so their rows are bitwise the same.
// * Halo-extended plug-ins (a shard of a row partition).  The operand is
//   built outside the kernel (the wrapper's `prepare`, the Pallas
//   plug-in's halo exchange) and read in place of the ring-top copy:
//   stencils as (nxl + 2) x-planes whose planes 0 and nxl + 1 hold the
//   neighbours' boundary planes (zero at the domain's ends), so there is no
//   domain-edge test on x; ELL as [own | from prev | from next] through the
//   partition plan's remapped column indices.
// * Slab form (the JAX package vmaps the Pallas kernel over a slab of s
//   right-hand sides): a second grid dimension over the s columns of an
//   (s, NV, N) slab, one launch.  Column c reads its own idx and scal rows
//   (each column is at its own cycle index), its own ring-top copy (a halo
//   plug-in: its own prepared operand, at c * zs) and writes its own
//   partials; the preconditioner's inverse diagonal, the
//   diagonal and the ELL cols/vals are shared.  A column's blocks and its
//   partials sum are the single-column launch's, in the same order, so
//   every column's rows and dots are bitwise those of a single-column
//   launch.  s = 1 is the single-column launch.  The bound is s times the
//   slab bytes of one column plus the shared operator data once.
// * The staged ELL kernel takes the slab in one block per row tile instead
//   (a grid of one dimension): the block stages its tile of cols and vals
//   once and runs the vector phase of column 0, 1, ..., s - 1 in turn from
//   that one copy, so the operator (66 MB at the ice sheet's 500 000 rows,
//   more than the L2) comes from device memory once a launch and not once
//   a column.  For a shard's row count its blocks are of ELL_ROWS = 64
//   rows (fused_iter_kernel_slab_ell); one column keeps BLOCK-row blocks
//   (fused_iter_kernel_staged).  Both take a partial for each ELL_ROWS rows
//   as a sum of warp sums (the runtime-depth kernel's butterfly), so each
//   column's rows and partials are still the single-column launch's.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk_copy.cuh"

namespace fi {

constexpr int BLOCK = 256;
constexpr int NWARP = BLOCK / 32;
constexpr int LMAX = 8;
constexpr int RT_REC_CHUNK = 4;   // runtime depth: recurrence depths loaded
                                  // together (3 rows each)
constexpr int RT_CHUNK = 8;       // runtime depth: fill rows or products
                                  // loaded together (warp_sums8's width)
constexpr int RT_MIN_BLOCKS = 4;  // runtime depth: blocks an SM must hold
                                  // (caps the registers at 64 a thread)
constexpr int ELL_CHUNK = 8;                // gathers issued before their sums
constexpr int ELL_ROWS = 64;     // staged ELL kernel: rows (threads) a block
constexpr int ELL_WARPS = ELL_ROWS / 32;
constexpr int ELL_TILE_BYTES = 16 * 1024;   // most a staged tile may take
                                            // (W <= 21 at ELL_ROWS rows)
constexpr int SETUP_COLS = 8;   // staged ELL kernel: columns set up at once

enum { SPMV_2D5 = 0, SPMV_3D7 = 1, SPMV_3D27 = 2, SPMV_DIAG = 3,
       SPMV_ELL = 4, SPMV_2D5_HALO = 5, SPMV_3D7_HALO = 6,
       SPMV_ELL_HALO = 7 };

// Dynamic shared memory of the staged ELL kernels at depth l, w slots a
// row and a slab of s columns.  One column (fused_iter_kernel_staged): the
// (BLOCK, w) tile of vals and cols.  A slab (fused_iter_kernel_slab_ell):
// the (ELL_ROWS, w) tile, then for min(s, SETUP_COLS) columns the (2l+1,
// ELL_WARPS) warp sums, the scalar vector, the index vector and two store
// masks.
__host__ __device__ constexpr long long staged_smem_bytes(int l, int w,
                                                          int s) {
  return s == 1 ? (long long)BLOCK * w * 12
                : (long long)ELL_ROWS * w * 12 +
                      (long long)(s < SETUP_COLS ? s : SETUP_COLS) *
                          ((2 * l + 1) * ELL_WARPS * 8 + (8 + l) * 8 +
                           (8 * l + 9) * 4 + 2 * l * 4);
}

// Blocks an SM must hold of the slab ELL kernel at depth l <= 2: 9 (at
// most 113 registers a thread), so that every operand row of a column is
// in flight at once without spilling.
__host__ __device__ constexpr int slab_min_blocks(int l) {
  return l <= 2 ? 9 : 1;
}

// Plug-ins whose operand the wrapper prepares (a halo-extended vector).
__host__ __device__ constexpr bool is_halo(int kind) {
  return kind == SPMV_2D5_HALO || kind == SPMV_3D7_HALO ||
         kind == SPMV_ELL_HALO;
}

// Dynamic shared memory of fused_iter_kernel_rt at depth l: the l fill and
// l recurrence values of each thread and the (2l+1) products' warp sums
// (doubles), the scalar vector, then the index vector and the two store
// masks (ints).
__host__ __device__ constexpr long long rt_smem_bytes(int l) {
  return (long long)2 * l * BLOCK * 8 + (2 * l + 1) * NWARP * 8 +
         (8 + l) * 8 + (8 * l + 9) * 4 + 2 * l * 4;
}

struct Spmv {
  const double* z;     // resident copy of the ring-top row (stencils, ELL),
                       // or the prepared halo-extended operand
  const double* d;     // diagonal (SPMV_DIAG)
  int nx, ny, nz;
  double coef;         // eps_z (3D7) or centre weight (3D27)
  const int* cols;     // (n, w) ELL column indices (SPMV_ELL), or the
                       // block's staged (BLOCK, w) tile of them
  const double* vals;  // (n, w) ELL values (SPMV_ELL), or the staged tile
  int w;               // ELL slots per row
};

// An ELL row from the staged tile: ell_rowsum's chain, acc = v_0 z_0, then
// acc = acc + v_s z_s in slot order, the gathers of ELL_CHUNK slots issued
// before any is summed (the same sums as the direct loop below).
__device__ __forceinline__ double ell_row_staged(
    const double* v, const int* c, int w, const double* __restrict__ z) {
  double acc = 0.0;
  for (int s0 = 0; s0 < w; s0 += ELL_CHUNK) {
    double g[ELL_CHUNK];
#pragma unroll
    for (int u = 0; u < ELL_CHUNK; ++u)
      g[u] = (s0 + u < w) ? __ldg(z + c[s0 + u]) : 0.0;
#pragma unroll
    for (int u = 0; u < ELL_CHUNK; ++u) {
      if (s0 + u < w) {
        const double p = v[s0 + u] * g[u];
        acc = (s0 + u == 0) ? p : acc + p;
      }
    }
  }
  return acc;
}

// az[j] with the plain version's term order; grid points outside the domain
// read 0.0, as the zero-padded plain expression does.  TILE: the ELL
// plug-in reads row j's slots from the block's staged tile (sp.cols and
// sp.vals point there), at the thread's row of it.
template <int KIND, bool TILE = false>
__device__ __forceinline__ double spmv_at(const Spmv& sp, long long j,
                                          double zj) {
  if constexpr (KIND == SPMV_DIAG) {
    return sp.d[j] * zj;
  } else if constexpr ((KIND == SPMV_ELL || KIND == SPMV_ELL_HALO) && TILE) {
    const int r = threadIdx.x * sp.w;
    return ell_row_staged(sp.vals + r, sp.cols + r, sp.w, sp.z);
  } else if constexpr (KIND == SPMV_ELL || KIND == SPMV_ELL_HALO) {
    const int* c = sp.cols + j * sp.w;
    const double* v = sp.vals + j * sp.w;
    const double* z = sp.z;
    double acc = v[0] * z[c[0]];
    for (int s = 1; s < sp.w; ++s) acc = acc + v[s] * z[c[s]];
    return acc;
  } else if constexpr (KIND == SPMV_2D5) {
    const long long ny = sp.ny;
    const long long ix = j / ny, iy = j - ix * ny;
    const double* z = sp.z;
    const double g = z[j];
    const double up = ix > 0 ? z[j - ny] : 0.0;
    const double dn = ix < sp.nx - 1 ? z[j + ny] : 0.0;
    const double lf = iy > 0 ? z[j - 1] : 0.0;
    const double rt = iy < ny - 1 ? z[j + 1] : 0.0;
    return 4.0 * g - up - dn - lf - rt;
  } else if constexpr (KIND == SPMV_2D5_HALO) {
    // Own rows start one x-plane into the (nxl + 2, ny) operand.
    const long long ny = sp.ny;
    const long long iy = j % ny;
    const double* z = sp.z + ny;
    const double g = z[j];
    const double up = z[j - ny];
    const double dn = z[j + ny];
    const double lf = iy > 0 ? z[j - 1] : 0.0;
    const double rt = iy < ny - 1 ? z[j + 1] : 0.0;
    return 4.0 * g - up - dn - lf - rt;
  } else if constexpr (KIND == SPMV_3D7_HALO) {
    const long long ny = sp.ny, nz = sp.nz;
    const long long sx = ny * nz;
    const long long iz = j % nz, iy = (j / nz) % ny;
    const double* z = sp.z + sx;
    const double ez = sp.coef;
    const double g = z[j];
    const double xm = z[j - sx];
    const double xp = z[j + sx];
    const double ym = iy > 0 ? z[j - nz] : 0.0;
    const double yp = iy < ny - 1 ? z[j + nz] : 0.0;
    const double zm = iz > 0 ? z[j - 1] : 0.0;
    const double zp = iz < nz - 1 ? z[j + 1] : 0.0;
    return (4.0 + 2.0 * ez) * g - xm - xp - ym - yp - ez * zm - ez * zp;
  } else if constexpr (KIND == SPMV_3D7) {
    const long long ny = sp.ny, nz = sp.nz;
    const long long sx = ny * nz;
    const long long iz = j % nz, t = j / nz;
    const long long iy = t % ny, ix = t / ny;
    const double* z = sp.z;
    const double ez = sp.coef;
    const double g = z[j];
    const double xm = ix > 0 ? z[j - sx] : 0.0;
    const double xp = ix < sp.nx - 1 ? z[j + sx] : 0.0;
    const double ym = iy > 0 ? z[j - nz] : 0.0;
    const double yp = iy < ny - 1 ? z[j + nz] : 0.0;
    const double zm = iz > 0 ? z[j - 1] : 0.0;
    const double zp = iz < nz - 1 ? z[j + 1] : 0.0;
    return (4.0 + 2.0 * ez) * g - xm - xp - ym - yp - ez * zm - ez * zp;
  } else {
    const long long nx = sp.nx, ny = sp.ny, nz = sp.nz;
    const long long sx = ny * nz;
    const long long iz = j % nz, t = j / nz;
    const long long iy = t % ny, ix = t / ny;
    const double* z = sp.z;
    double out = sp.coef * z[j];
#pragma unroll
    for (int di = -1; di <= 1; ++di)
#pragma unroll
      for (int dj = -1; dj <= 1; ++dj)
#pragma unroll
        for (int dk = -1; dk <= 1; ++dk) {
          const int order = (di != 0) + (dj != 0) + (dk != 0);
          if (order == 0) continue;
          const double w = order == 1 ? 1.0 : (order == 2 ? 0.5 : 0.25);
          const bool in = ix + di >= 0 && ix + di < nx && iy + dj >= 0 &&
                          iy + dj < ny && iz + dk >= 0 && iz + dk < nz;
          const double v = in ? z[j + di * sx + dj * nz + dk] : 0.0;
          out = out - w * v;
        }
    return out;
  }
}

// The ring-top row of column blockIdx.y to that column's copy, COPY_ILP
// elements a thread loaded before any is stored.
constexpr int COPY_ILP = 4;
__global__ void copy_row(const double* __restrict__ S, long long n,
                         long long ld, long long cs,
                         const int* __restrict__ idx, int idx_size, int pos,
                         double* __restrict__ z) {
  S += blockIdx.y * cs;
  z += blockIdx.y * n;
  const double* src = S + idx[(long long)blockIdx.y * idx_size + pos] * ld;
  for (long long j0 = (long long)blockIdx.x * blockDim.x * COPY_ILP +
                      threadIdx.x;
       j0 < n; j0 += (long long)gridDim.x * blockDim.x * COPY_ILP) {
    double v[COPY_ILP];
#pragma unroll
    for (int u = 0; u < COPY_ILP; ++u) {
      const long long j = j0 + (long long)u * blockDim.x;
      v[u] = j < n ? src[j] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < COPY_ILP; ++u) {
      const long long j = j0 + (long long)u * blockDim.x;
      if (j < n) z[j] = v[u];
    }
  }
}

// copy_row for s columns on `stream`.
inline void copy_rows(const double* S, long long n, long long ld, long long cs,
                      int s, const int* idx, int idx_size, int pos, double* z,
                      cudaStream_t stream) {
  const long long want = (n + BLOCK * COPY_ILP - 1) / (BLOCK * COPY_ILP);
  const dim3 grid((unsigned)(want < 65535 ? want : 65535), (unsigned)s);
  copy_row<<<grid, BLOCK, 0, stream>>>(S, n, ld, cs, idx, idx_size, pos, z);
}

// Positions in the index vector and the scalar vector at depth L
// (idx_layout(L) and scal_layout(L) of kernels/fused_iter.py).
struct Ix {
  int FILL, REC_W, REC_A, REC_B, REC_C, Z_TOP, ZL_IM1, Z_W, U_I, U_IM1, U_W,
      P_IM, MAT_V, MAT_Z, F_FILL, F_LATE, F_FIRST, F_UPD, IDX_SIZE;
  __device__ __forceinline__ explicit Ix(int L)
      : FILL(0), REC_W(L), REC_A(2 * L), REC_B(3 * L), REC_C(4 * L),
        Z_TOP(5 * L), ZL_IM1(5 * L + 1), Z_W(5 * L + 2), U_I(5 * L + 3),
        U_IM1(5 * L + 4), U_W(5 * L + 5), P_IM(5 * L + 6), MAT_V(5 * L + 7),
        MAT_Z(6 * L + 7), F_FILL(7 * L + 6), F_LATE(8 * L + 6),
        F_FIRST(8 * L + 7), F_UPD(8 * L + 8), IDX_SIZE(8 * L + 9) {}
};
enum { SIG_I = 0, GAM_NEW = 1, D2 = 2, DLT_SAFE = 3, ZET_PREV = 4,
       D_PREV = 5, ETA_NEW_SAFE = 6, ETA0_SAFE = 7, C1 = 8 };

// A thread's per-depth values in the compile-time kernels: register arrays.
template <int L>
struct RegVals {
  double fill_[L], rec_[L], prod_[2 * L + 1];
  __device__ __forceinline__ double& fill(int k) { return fill_[k]; }
  __device__ __forceinline__ double& rec(int k) { return rec_[k]; }
  __device__ __forceinline__ double& prod(int k) { return prod_[k]; }
};

// Store mask t of a block (t < L: store_fill[t], else store_rec[t - L]): a
// masked write stores the row's original value, so it is skipped unless an
// earlier write of this iteration targeted the same row.
__device__ __forceinline__ int store_mask(int L, const Ix& ix,
                                          const int* idx, int t) {
  if (t < L) {
    bool s = idx[ix.F_FILL + t] != 0;
    for (int k2 = 0; k2 < t; ++k2)
      s = s || idx[ix.FILL + k2] == idx[ix.FILL + t];
    return s;
  }
  const int k = t - L;
  bool s = idx[ix.F_LATE] != 0;
  for (int k2 = 0; k2 < L; ++k2)
    s = s || idx[ix.FILL + k2] == idx[ix.REC_W + k];
  for (int k2 = 0; k2 < k; ++k2)
    s = s || idx[ix.REC_W + k2] == idx[ix.REC_W + k];
  return s;
}

// One column's two store masks (store_mask's tests) worked out by one
// thread in its own loops (the compile-time kernels; the same masks through
// store_mask made them ~3 % slower at l = 2).
__device__ __forceinline__ void column_masks(int L, const Ix& ix,
                                             const int* idx, int* store_fill,
                                             int* store_rec) {
  const bool late_ = idx[ix.F_LATE] != 0;
  for (int k = 0; k < L; ++k) {
    bool s = idx[ix.F_FILL + k] != 0;
    for (int k2 = 0; k2 < k; ++k2)
      s = s || idx[ix.FILL + k2] == idx[ix.FILL + k];
    store_fill[k] = s;
  }
  for (int k = 0; k < L; ++k) {
    bool s = late_;
    for (int k2 = 0; k2 < L; ++k2)
      s = s || idx[ix.FILL + k2] == idx[ix.REC_W + k];
    for (int k2 = 0; k2 < k; ++k2)
      s = s || idx[ix.REC_W + k2] == idx[ix.REC_W + k];
    store_rec[k] = s;
  }
}

// Every block loads the index and scalar vectors to shared memory and works
// out the two store masks: thread 0 alone (column_masks), or thread t mask
// t (SPREAD, the runtime-depth kernel: at l = 54 one thread would take
// ~4 000 comparisons).
template <bool SPREAD = false>
__device__ __forceinline__ void block_setup(
    int L, const int* __restrict__ idx_g, const double* __restrict__ scal_g,
    int* idx, double* scal, int* store_fill, int* store_rec) {
  const Ix ix(L);
  const int tid = threadIdx.x;
  for (int t = tid; t < ix.IDX_SIZE; t += BLOCK) idx[t] = idx_g[t];
  for (int t = tid; t < 8 + L; t += BLOCK) scal[t] = scal_g[t];
  __syncthreads();
  if constexpr (SPREAD) {
    for (int t = tid; t < 2 * L; t += BLOCK)
      (t < L ? store_fill[t] : store_rec[t - L]) = store_mask(L, ix, idx, t);
  } else if (tid == 0) {
    column_masks(L, ix, idx, store_fill, store_rec);
  }
  __syncthreads();
}

// (K1) at column j: the SPMV of the ring-top row, the pointwise
// preconditioner, u_new, z_new and the pipeline-fill value z_fill.
struct K1 {
  double u_new, z_new, z_fill;
};

// (K1) from its operands: the SPMV value az, the rows zt, ui, uim1 and
// (ghysels) zl at column j, and (PREC) the inverse diagonal there.
template <bool STABLE, bool PREC>
__device__ __forceinline__ K1 k1_combine(double az, double zt, double ui,
                                         double uim1, double zl, double dinv,
                                         bool late,
                                         const double* __restrict__ scal) {
  const double u_new0 = az - scal[SIG_I] * ui;
  const double u_new =
      late ? (u_new0 - scal[GAM_NEW] * ui - scal[D2] * uim1) / scal[DLT_SAFE]
           : u_new0;
  if constexpr (STABLE) {
    const double z_new = PREC ? dinv * u_new : u_new;
    return {u_new, z_new, z_new};
  } else {
    const double z_new0 = PREC ? dinv * u_new0 : u_new0;
    const double z_new = late ? (z_new0 - scal[GAM_NEW] * zt -
                                 scal[D2] * zl) / scal[DLT_SAFE]
                              : z_new0;
    return {u_new, z_new, z_new0};
  }
}

template <int KIND, bool STABLE, bool PREC, bool TILE = false>
__device__ __forceinline__ K1 k1_values(
    const double* S, long long ld, long long j, const Ix& ix,
    const int* __restrict__ idx, const double* __restrict__ scal,
    const Spmv& sp, const double* __restrict__ inv_diag) {
  auto row = [&](int r) -> const double* { return S + (long long)r * ld; };
  const double zt = row(idx[ix.Z_TOP])[j];
  const double ui = row(idx[ix.U_I])[j];
  const double uim1 = row(idx[ix.U_IM1])[j];
  const double az = spmv_at<KIND, TILE>(sp, j, zt);
  const double dinv = PREC ? inv_diag[j] : 0.0;
  const double zl = STABLE ? 0.0 : row(idx[ix.ZL_IM1])[j];
  return k1_combine<STABLE, PREC>(az, zt, ui, uim1, zl, dinv,
                                  idx[ix.F_LATE] != 0, scal);
}

// (K6) the values the x and p rows take at column j, read before any store.
struct K6 {
  double x, p;
};

// (K6) from the old x and p, row 0 and row p_im at column j.
__device__ __forceinline__ K6 k6_combine(double x_old, double p_old,
                                         double s0, double p_im, const Ix& ix,
                                         const int* __restrict__ idx,
                                         const double* __restrict__ scal) {
  const double p_first = s0 / scal[ETA0_SAFE];
  const double p_new = (p_im - scal[D_PREV] * p_old) / scal[ETA_NEW_SAFE];
  const double x_new = x_old + scal[ZET_PREV] * p_old;
  const bool do_upd = idx[ix.F_UPD] != 0;
  const bool is_first = idx[ix.F_FIRST] != 0;
  return {do_upd ? x_new : x_old,
          is_first ? p_first : (do_upd ? p_new : p_old)};
}

__device__ __forceinline__ K6 k6_values(const double* S, long long ld,
                                        int u_off, long long j, const Ix& ix,
                                        const int* __restrict__ idx,
                                        const double* __restrict__ scal) {
  return k6_combine(S[(long long)(u_off + 4) * ld + j],
                    S[(long long)(u_off + 3) * ld + j], S[j],
                    S[(long long)idx[ix.P_IM] * ld + j], ix, idx, scal);
}

// The phase's last four stores, in the plain version's order.
__device__ __forceinline__ void store_tail(double* S, long long ld, int u_off,
                                           long long j, const Ix& ix,
                                           const int* __restrict__ idx,
                                           const K1& h, const K6& k6) {
  S[(long long)idx[ix.Z_W] * ld + j] = h.z_new;
  S[(long long)idx[ix.U_W] * ld + j] = h.u_new;
  S[(long long)(u_off + 4) * ld + j] = k6.x;
  S[(long long)(u_off + 3) * ld + j] = k6.p;
}

// One column's vector phase at compile-time depth L (loops unroll,
// values in registers).  For a column j < n: the kernels zero the products
// of columns past it outside this call, since an early return here made
// the kernel slower (scripts/superkernel_ab.py sets two checkouts side by
// side).
// Every operand row is loaded before any store; the (2l+1) dot-block
// products are taken after the stores.  TILE: the SPMV reads the staged
// ELL tile (spmv_at).
template <int KIND, bool STABLE, bool PREC, int L, bool TILE = false>
__device__ __forceinline__ void vector_phase(
    double* S, long long ld, int rb, const int* __restrict__ idx,
    const double* __restrict__ scal, const int* __restrict__ store_fill,
    const int* __restrict__ store_rec, const Spmv& sp,
    const double* __restrict__ inv_diag, RegVals<L>& v) {
  const Ix ix(L);
  const long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const int u_off = (L + 1) * rb;
  auto row = [&](int r) -> double* { return S + (long long)r * ld; };
  const bool late = idx[ix.F_LATE] != 0;

  // ---- (K1) SPMV + pointwise preconditioner
  const K1 h = k1_values<KIND, STABLE, PREC, TILE>(S, ld, j, ix, idx, scal,
                                                   sp, inv_diag);

  // ---- pipeline-fill copies (values; stored below)
#pragma unroll
  for (int k = 0; k < L; ++k) {
    double f = 0.0;
    if (store_fill[k])
      f = idx[ix.F_FILL + k] != 0 ? h.z_fill : row(idx[ix.FILL + k])[j];
    v.fill(k) = f;
  }

  // ---- (K4) basis recurrences, masked late
#pragma unroll
  for (int k = 0; k < L; ++k) {
    double r = 0.0;
    if (late) {
      const double zk1 = row(idx[ix.REC_A + k])[j];
      const double zm1 = row(idx[ix.REC_B + k])[j];
      const double zm2 = row(idx[ix.REC_C + k])[j];
      r = (zk1 + scal[C1 + k] * zm1 - scal[D2] * zm2) / scal[DLT_SAFE];
    } else if (k == 0 || store_rec[k]) {
      r = row(idx[ix.REC_W + k])[j];
    }
    v.rec(k) = r;
  }

  // ---- (K5) dot-block operand rows, read before any store (kept in the
  // products' places, multiplied by u_new after the stores)
#pragma unroll
  for (int t = 0; t < L; ++t) v.prod(t) = row(idx[ix.MAT_V + t])[j];
  v.prod(L) = v.rec(0);
#pragma unroll
  for (int t = 0; t < L - 1; ++t)
    v.prod(L + 1 + t) = row(idx[ix.MAT_Z + t])[j];
  v.prod(2 * L) = h.z_new;

  // ---- (K6) solution / search-direction updates
  const K6 k6 = k6_values(S, ld, u_off, j, ix, idx, scal);

  // ---- stores, in the plain version's order
#pragma unroll
  for (int k = 0; k < L; ++k)
    if (store_fill[k]) row(idx[ix.FILL + k])[j] = v.fill(k);
#pragma unroll
  for (int k = 0; k < L; ++k)
    if (store_rec[k]) row(idx[ix.REC_W + k])[j] = v.rec(k);
  store_tail(S, ld, u_off, j, ix, idx, h, k6);

#pragma unroll
  for (int k = 0; k < 2 * L + 1; ++k) v.prod(k) = v.prod(k) * h.u_new;
}

// The warp's sums of v[0..7] (one value of each a lane): a fixed butterfly
// that halves the values a lane holds at lane offsets 16, 8 and 4, then
// adds across offsets 2 and 1.  Every lane whose bits 4..2 spell
// q = 4 b4 + 2 b3 + b2 returns the sum of v[q] over the 32 lanes.
__device__ __forceinline__ double warp_sums8(double (&v)[8]) {
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int w = 4, off = 16; w >= 1; w >>= 1, off >>= 1) {
    const bool hi = (lane & off) != 0;
#pragma unroll
    for (int q = 0; q < w; ++q) {
      const double send = hi ? v[q] : v[q + w];
      const double keep = hi ? v[q + w] : v[q];
      v[q] = keep + __shfl_xor_sync(FULL, send, off);
    }
  }
  double s = v[0];
  s = s + __shfl_xor_sync(FULL, s, 2);
  s = s + __shfl_xor_sync(FULL, s, 1);
  return s;
}

// One column's vector phase at runtime depth L (the runtime-depth kernel).
// Every thread of the block takes part, for the warp sums: a thread past n
// reads column 0, contributes zero products and stores nothing.  Loads come
// in chunks (RT_REC_CHUNK, RT_CHUNK), all of a chunk before its arithmetic;
// every load precedes the first store.  fill_s and rec_s ([L][BLOCK]) keep
// the values for the stores; product k's warp sum goes to red[k][warp].
template <int KIND, bool STABLE, bool PREC>
__device__ __forceinline__ void vector_phase_rt(
    double* S, long long n, long long ld, int rb, int L,
    const int* __restrict__ idx, const double* __restrict__ scal,
    const int* __restrict__ store_fill, const int* __restrict__ store_rec,
    const Spmv& sp, const double* __restrict__ inv_diag,
    double* __restrict__ fill_s, double* __restrict__ rec_s,
    double* __restrict__ red) {
  static_assert(RT_CHUNK == 8, "warp_sums8 sums 8 products");
  const Ix ix(L);
  const int tid = threadIdx.x, lane = tid & 31, ND = 2 * L + 1;
  const long long jn = (long long)blockIdx.x * BLOCK + tid;
  const bool in = jn < n;
  const long long j = in ? jn : 0;
  const int u_off = (L + 1) * rb;
  auto row = [&](int r) -> double* { return S + (long long)r * ld; };
  const bool late = idx[ix.F_LATE] != 0;

  // ---- (K1) and (K6): their loads in flight together
  const K1 h =
      k1_values<KIND, STABLE, PREC>(S, ld, j, ix, idx, scal, sp, inv_diag);
  const K6 k6 = k6_values(S, ld, u_off, j, ix, idx, scal);

  // ---- pipeline-fill copies (values, for the stores)
  for (int k0 = 0; k0 < L; k0 += RT_CHUNK) {
    double f[RT_CHUNK];
#pragma unroll
    for (int u = 0; u < RT_CHUNK; ++u) {
      const int k = k0 + u;
      f[u] = k < L && store_fill[k] && idx[ix.F_FILL + k] == 0
                 ? row(idx[ix.FILL + k])[j]
                 : h.z_fill;
    }
#pragma unroll
    for (int u = 0; u < RT_CHUNK; ++u)
      if (k0 + u < L && store_fill[k0 + u])
        fill_s[(k0 + u) * BLOCK + tid] = f[u];
  }

  // ---- (K4) basis recurrences, masked late
  if (late) {
    for (int k0 = 0; k0 < L; k0 += RT_REC_CHUNK) {
      double a[RT_REC_CHUNK], b[RT_REC_CHUNK], c[RT_REC_CHUNK];
#pragma unroll
      for (int u = 0; u < RT_REC_CHUNK; ++u) {
        const int k = k0 + u;
        a[u] = b[u] = c[u] = 0.0;
        if (k < L) {
          a[u] = row(idx[ix.REC_A + k])[j];
          b[u] = row(idx[ix.REC_B + k])[j];
          c[u] = row(idx[ix.REC_C + k])[j];
        }
      }
#pragma unroll
      for (int u = 0; u < RT_REC_CHUNK; ++u) {
        const int k = k0 + u;
        if (k < L)
          rec_s[k * BLOCK + tid] =
              (a[u] + scal[C1 + k] * b[u] - scal[D2] * c[u]) /
              scal[DLT_SAFE];
      }
    }
  } else {
    for (int k0 = 0; k0 < L; k0 += RT_CHUNK) {
      double r[RT_CHUNK];
#pragma unroll
      for (int u = 0; u < RT_CHUNK; ++u) {
        const int k = k0 + u;
        r[u] = k < L && (k == 0 || store_rec[k]) ? row(idx[ix.REC_W + k])[j]
                                                 : 0.0;
      }
#pragma unroll
      for (int u = 0; u < RT_CHUNK; ++u)
        if (k0 + u < L) rec_s[(k0 + u) * BLOCK + tid] = r[u];
    }
  }
  const double rec0 = rec_s[tid];

  // ---- (K5) the dot-block products, each taken as its operand arrives and
  // summed across the warp at once.  Product k's operand: row mat_v[k]
  // (k < L), rec(0) (k = L), row mat_z[k - L - 1] (L < k < 2L; mat_z
  // follows mat_v in idx), z_new (k = 2L).
  const int q = (lane >> 4 & 1) * 4 + (lane >> 3 & 1) * 2 + (lane >> 2 & 1);
  for (int k0 = 0; k0 < ND; k0 += RT_CHUNK) {
    double v[RT_CHUNK];
#pragma unroll
    for (int u = 0; u < RT_CHUNK; ++u) {
      const int k = k0 + u;
      v[u] = k < 2 * L && k != L ? row(idx[ix.MAT_V + k - (k > L)])[j]
                                 : (k == L ? rec0 : h.z_new);
    }
#pragma unroll
    for (int u = 0; u < RT_CHUNK; ++u)
      v[u] = in && k0 + u < ND ? v[u] * h.u_new : 0.0;
    const double sum = warp_sums8(v);
    if ((lane & 3) == 0 && k0 + q < ND) red[(k0 + q) * NWARP + (tid >> 5)] = sum;
  }

  // ---- stores, in the plain version's order
  if (!in) return;
  for (int k = 0; k < L; ++k)
    if (store_fill[k]) row(idx[ix.FILL + k])[j] = fill_s[k * BLOCK + tid];
  for (int k = 0; k < L; ++k)
    if (store_rec[k]) row(idx[ix.REC_W + k])[j] = rec_s[k * BLOCK + tid];
  store_tail(S, ld, u_off, j, ix, idx, h, k6);
}

// Per-block partials of the ND products in red ([ND][BLOCK]) of the
// compile-time kernels: a fixed pairwise tree.
template <int ND>
__device__ __forceinline__ void block_partials(double* red,
                                               double* __restrict__ part) {
  const int tid = threadIdx.x;
  __syncthreads();
#pragma unroll
  for (int s = BLOCK / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int k = 0; k < ND; ++k)
        red[k * BLOCK + tid] = red[k * BLOCK + tid] + red[k * BLOCK + tid + s];
    }
    __syncthreads();
  }
  for (int k = tid; k < ND; k += BLOCK)
    part[(long long)k * gridDim.x + blockIdx.x] = red[k * BLOCK];
}

// Column blockIdx.y's slab, index and scalar rows, operand and partials
// (the kernel's own pointer arguments, moved in place).
#define FI_TO_COLUMN(LL)                                 \
  do {                                                   \
    const long long c_ = blockIdx.y;                     \
    S += c_ * cs;                                        \
    idx_g += c_ * (8 * (LL) + 9);                        \
    scal_g += c_ * (8 + (LL));                           \
    if (sp.z != nullptr) sp.z += c_ * zs;                \
    part += c_ * (2 * (LL) + 1) * (long long)gridDim.x;  \
  } while (0)

template <int KIND, int L, bool STABLE, bool PREC>
__global__ void __launch_bounds__(BLOCK)
    fused_iter_kernel(double* S, long long n, long long ld, long long cs,
                      int rb, const int* __restrict__ idx_g,
                      const double* __restrict__ scal_g, Spmv sp,
                      long long zs, const double* __restrict__ inv_diag,
                      double* __restrict__ part) {
  constexpr int ND = 2 * L + 1;
  __shared__ int idx[8 * L + 9];
  __shared__ double scal[8 + L];
  __shared__ int store_fill[L], store_rec[L];
  __shared__ double red[ND * BLOCK];
  FI_TO_COLUMN(L);
  block_setup(L, idx_g, scal_g, idx, scal, store_fill, store_rec);
  RegVals<L> v;
  if ((long long)blockIdx.x * BLOCK + threadIdx.x < n) {
    vector_phase<KIND, STABLE, PREC, L>(S, ld, rb, idx, scal, store_fill,
                                        store_rec, sp, inv_diag, v);
  } else {
#pragma unroll
    for (int k = 0; k < ND; ++k) v.prod(k) = 0.0;
  }
#pragma unroll
  for (int k = 0; k < ND; ++k) red[k * BLOCK + threadIdx.x] = v.prod(k);
  block_partials<ND>(red, part);
}

// The sum of a block's NW warp sums w[0 .. NW-1] of one product: a fixed
// pairwise tree, ((w0 + w1) + (w2 + w3)) + ((w4 + w5) + (w6 + w7)) at 8.
template <int NW>
__device__ __forceinline__ double warps_sum(const double* w) {
  static_assert(NW == 1 || NW == 2 || NW == 4 || NW == 8, "NW warps");
  if constexpr (NW == 1) {
    return w[0];
  } else {
    return warps_sum<NW / 2>(w) + warps_sum<NW / 2>(w + NW / 2);
  }
}

// The warp's sums of its ND products (warp_sums8, 8 products at a time),
// to ws[k * NW + warp] for product k, in a block of NW warps.
template <int ND, int NW>
__device__ __forceinline__ void warp_sums(const double (&prod)[ND],
                                          double* ws) {
  const int lane = threadIdx.x & 31;
  const int q = (lane >> 4 & 1) * 4 + (lane >> 3 & 1) * 2 + (lane >> 2 & 1);
#pragma unroll
  for (int k0 = 0; k0 < ND; k0 += 8) {
    double v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = k0 + u < ND ? prod[k0 + u] : 0.0;
    const double sum = warp_sums8(v);
    if ((lane & 3) == 0 && k0 + q < ND)
      ws[(k0 + q) * NW + (threadIdx.x >> 5)] = sum;
  }
}

// The staged ELL kernel's setup of `cnt` columns (at most SETUP_COLS): their
// index and scalar vectors to shared memory, then thread c works out column
// c's two store masks (column_masks).  Two barriers for all cnt columns.
__device__ __forceinline__ void stage_setup(int L, int cnt,
                                            const int* __restrict__ idx_g,
                                            const double* __restrict__ scal_g,
                                            int* idx_s, double* scal_s,
                                            int* mask_s) {
  const Ix ix(L);
  const int tid = threadIdx.x;
  for (int t = tid; t < cnt * ix.IDX_SIZE; t += ELL_ROWS) idx_s[t] = idx_g[t];
  for (int t = tid; t < cnt * (8 + L); t += ELL_ROWS) scal_s[t] = scal_g[t];
  __syncthreads();
  if (tid < cnt)
    column_masks(L, ix, idx_s + tid * ix.IDX_SIZE, mask_s + tid * 2 * L,
                 mask_s + tid * 2 * L + L);
  __syncthreads();
}

// One column's vector phase in the slab ELL kernel at row j, the thread's
// row of the block's tile (tv, tc): vector_phase's values and stores, with
// every operand row loaded before any is used, then (the first column of a
// bulk-copied tile) the tile awaited on tile_bar, then the row's gathers
// from z: the rows are in flight together, during the tile's arrival and
// the gathers (an operation on a load's value holds its warp until the
// load arrives, so taking the recurrences as their rows arrive cost a third
// more time).  The products come back in prod.
template <bool STABLE, bool PREC, int L>
__device__ __forceinline__ void vector_phase_staged(
    double* S, long long ld, int rb, long long j, const int* __restrict__ idx,
    const double* __restrict__ scal, const int* __restrict__ store_fill,
    const int* __restrict__ store_rec, const double* tv, const int* tc,
    int w, const double* __restrict__ z, const double* __restrict__ inv_diag,
    uint64_t* tile_bar, double (&prod)[2 * L + 1]) {
  const Ix ix(L);
  const int u_off = (L + 1) * rb;
  auto row = [&](int r) -> double* { return S + (long long)r * ld; };
  const bool late = idx[ix.F_LATE] != 0;

  // ---- every operand row of the phase
  const double zt = row(idx[ix.Z_TOP])[j];
  const double ui = row(idx[ix.U_I])[j];
  const double uim1 = row(idx[ix.U_IM1])[j];
  const double zl = STABLE ? 0.0 : row(idx[ix.ZL_IM1])[j];
  const double dinv = PREC ? inv_diag[j] : 0.0;
  double fill[L], ra[L], rb_[L], rc[L];
#pragma unroll
  for (int k = 0; k < L; ++k)
    fill[k] = store_fill[k] && idx[ix.F_FILL + k] == 0
                  ? row(idx[ix.FILL + k])[j]
                  : 0.0;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    ra[k] = rb_[k] = rc[k] = 0.0;
    if (late) {
      ra[k] = row(idx[ix.REC_A + k])[j];
      rb_[k] = row(idx[ix.REC_B + k])[j];
      rc[k] = row(idx[ix.REC_C + k])[j];
    } else if (k == 0 || store_rec[k]) {
      ra[k] = row(idx[ix.REC_W + k])[j];
    }
  }
#pragma unroll
  for (int t = 0; t < L; ++t) prod[t] = row(idx[ix.MAT_V + t])[j];
#pragma unroll
  for (int t = 0; t < L - 1; ++t) prod[L + 1 + t] = row(idx[ix.MAT_Z + t])[j];
  const double x_old = row(u_off + 4)[j], p_old = row(u_off + 3)[j];
  // row 0 and row p_im only where (K6) takes them (the first update, and
  // every update): a late phase reads neither more than its bound counts
  const double s0 = idx[ix.F_FIRST] != 0 ? S[j] : 0.0;
  const double p_im = idx[ix.F_UPD] != 0 ? row(idx[ix.P_IM])[j] : 0.0;

  // ---- (K1) and (K6); the SPMV's slots from the tile
  if (tile_bar != nullptr) bulk::mbar_wait(tile_bar, 0);
  const int r = threadIdx.x * w;
  const K1 h = k1_combine<STABLE, PREC>(ell_row_staged(tv + r, tc + r, w, z),
                                        zt, ui, uim1, zl, dinv, late, scal);
  const K6 k6 = k6_combine(x_old, p_old, s0, p_im, ix, idx, scal);

  // ---- the fill and recurrence values, and the stores in vector_phase's
  // order
#pragma unroll
  for (int k = 0; k < L; ++k)
    if (store_fill[k]) {
      if (idx[ix.F_FILL + k] != 0) fill[k] = h.z_fill;
      row(idx[ix.FILL + k])[j] = fill[k];
    }
#pragma unroll
  for (int k = 0; k < L; ++k) {
    if (late)
      ra[k] = (ra[k] + scal[C1 + k] * rb_[k] - scal[D2] * rc[k]) /
              scal[DLT_SAFE];
    if (store_rec[k]) row(idx[ix.REC_W + k])[j] = ra[k];
  }
  store_tail(S, ld, u_off, j, ix, idx, h, k6);
  prod[L] = ra[0];
  prod[2 * L] = h.z_new;
#pragma unroll
  for (int k = 0; k < 2 * L + 1; ++k) prod[k] = prod[k] * h.u_new;
}

// The compile-time kernel for the ELL plug-ins with the operator staged,
// for a slab of s > 1 columns.  Block b stages rows [b ELL_ROWS, b ELL_ROWS
// + ELL_ROWS) of cols and vals in dynamic shared memory ((ELL_ROWS, w)
// values, then (ELL_ROWS, w) indices; both spans 16-byte aligned), by bulk
// copy if b < bulk_tiles, else by ordinary loads, and runs the vector phase
// of column 0, 1, ..., s - 1 in turn from that one copy, so the operator
// comes from device memory once a launch.  A column gathers from its
// ring-top row in place (no row of the phase writes it:
// check_z_top_not_written in kernels/fused_iter.py), or the halo plug-in
// (SPMV_ELL_HALO) from the column's prepared operand, sp.z + c * zs.
//
// Its design is for a shard's row count (125 000 at the ice sheet's 4
// shards), where blocks of 256 rows and 64 registers a thread were all
// resident in one wave, in step, with a dozen loads in flight a thread
// (PERF.md, row 1hs):
// * blocks of 64 rows (2 warps), 9 an SM at up to 113 registers, so a
//   thread has every operand row of a column in flight
//   (vector_phase_staged) and a shard's 1 954 blocks refill the SMs as
//   they finish, out of step;
// * stage_setup puts the index and scalar vectors and store masks of up to
//   SETUP_COLS columns in shared memory at once, and no barrier separates
//   those columns: each warp sums its products at once (warp_sums, the
//   runtime-depth kernel's butterfly) into the chunk's (column, product,
//   warp) sums, and after one barrier a chunk a block's partial is their
//   sum (warps_sum: w0 + w1).
// One column runs fused_iter_kernel_staged instead, with the same
// partials; each column's rows and partials here are that launch's.
template <int KIND, int L, bool STABLE, bool PREC>
__global__ void __launch_bounds__(ELL_ROWS, slab_min_blocks(L))
    fused_iter_kernel_slab_ell(double* S, long long n, long long ld,
                             long long cs, int rb, int s,
                             const int* __restrict__ idx_g,
                             const double* __restrict__ scal_g, Spmv sp,
                             long long zs,
                             const double* __restrict__ inv_diag,
                             double* __restrict__ part,
                             long long bulk_tiles) {
  constexpr int ND = 2 * L + 1;
  const Ix ix(L);
  __shared__ __align__(8) uint64_t bar;
  extern __shared__ __align__(16) unsigned char tile[];
  const int tid = threadIdx.x, w = sp.w;
  const int sg = s < SETUP_COLS ? s : SETUP_COLS;
  const long long r0 = (long long)blockIdx.x * ELL_ROWS;
  const long long j = r0 + tid;
  double* const tv = (double*)tile;
  int* const tc = (int*)(tile + (size_t)ELL_ROWS * w * sizeof(double));
  double* const ws = (double*)(tile + (size_t)ELL_ROWS * w * 12);
  double* const scal_s = ws + sg * ND * ELL_WARPS;
  int* const idx_s = (int*)(scal_s + sg * (8 + L));
  int* const mask_s = idx_s + sg * ix.IDX_SIZE;
  const bool by_copy = blockIdx.x < bulk_tiles;
  if (by_copy) {
    if (tid == 0) {
      const uint32_t vbytes = (uint32_t)(ELL_ROWS * w * sizeof(double));
      const uint32_t cbytes = (uint32_t)(ELL_ROWS * w * sizeof(int));
      bulk::mbar_init(&bar, 1);
      bulk::mbar_init_fence();
      bulk::mbar_expect_tx(&bar, vbytes + cbytes);
      bulk::copy(tv, sp.vals + r0 * w, vbytes, &bar);
      bulk::copy(tc, sp.cols + r0 * w, cbytes, &bar);
    }
  } else {
    const int ne = (int)((n - r0 < ELL_ROWS ? n - r0 : ELL_ROWS) * w);
    const long long e0 = r0 * w;
    for (int e = tid; e < ne; e += ELL_ROWS) {
      tv[e] = sp.vals[e0 + e];
      tc[e] = sp.cols[e0 + e];
    }
  }
  for (int c0 = 0; c0 < s; c0 += SETUP_COLS) {
    // (the first chunk's barriers also publish the mbarrier or the tile;
    // a later chunk's follow the barrier before the last chunk's sums)
    const int cnt = s - c0 < SETUP_COLS ? s - c0 : SETUP_COLS;
    stage_setup(L, cnt, idx_g + (long long)c0 * ix.IDX_SIZE,
                scal_g + (long long)c0 * (8 + L), idx_s, scal_s, mask_s);
    for (int q = 0; q < cnt; ++q) {
      const long long c = c0 + q;
      const int* idx = idx_s + q * ix.IDX_SIZE;
      const int* store_fill = mask_s + q * 2 * L;
      const double* z = is_halo(KIND)
                            ? sp.z + c * zs
                            : S + c * cs + (long long)idx[ix.Z_TOP] * ld;
      double prod[ND];
      if (j < n) {
        vector_phase_staged<STABLE, PREC, L>(
            S + c * cs, ld, rb, j, idx, scal_s + q * (8 + L), store_fill,
            store_fill + L, tv, tc, w, z, inv_diag,
            c == 0 && by_copy ? &bar : nullptr, prod);
      } else {
#pragma unroll
        for (int k = 0; k < ND; ++k) prod[k] = 0.0;
      }
      warp_sums<ND, ELL_WARPS>(prod, ws + q * ND * ELL_WARPS);
    }
    __syncthreads();
    for (int t = tid; t < cnt * ND; t += ELL_ROWS)
      part[((c0 + t / ND) * ND + t % ND) * (long long)gridDim.x +
           blockIdx.x] = warps_sum<ELL_WARPS>(ws + t * ELL_WARPS);
  }
}

// The one-column staged ELL kernel (a slab of s = 1): one block of BLOCK
// threads a BLOCK-row tile, staged as the slab kernel stages its tiles, and
// vector_phase on it; 64 registers a thread, so that a shard's rows are all
// resident at once (a latency-bound launch: the slab kernel's 113
// registers left a third of them for a second wave).  Its partials are the
// slab kernel's: each ELL_ROWS-row group of warps sums its products by
// warp_sums and warps_sum into that group's slot of the `groups` (=
// ceil(n / ELL_ROWS)) partials, so a slab's column is bitwise this launch.
template <int KIND, int L, bool STABLE, bool PREC>
__global__ void __launch_bounds__(BLOCK)
    fused_iter_kernel_staged(double* S, long long n, long long ld, int rb,
                             const int* __restrict__ idx_g,
                             const double* __restrict__ scal_g, Spmv sp,
                             const double* __restrict__ inv_diag,
                             double* __restrict__ part, long long bulk_tiles,
                             int groups) {
  constexpr int ND = 2 * L + 1, NG = NWARP / ELL_WARPS;
  __shared__ int idx[8 * L + 9];
  __shared__ double scal[8 + L];
  __shared__ int store_fill[L], store_rec[L];
  __shared__ double ws[ND * NWARP];
  __shared__ __align__(8) uint64_t bar;
  extern __shared__ __align__(16) unsigned char tile[];
  const int tid = threadIdx.x, w = sp.w;
  const long long r0 = (long long)blockIdx.x * BLOCK;
  double* const tv = (double*)tile;
  int* const tc = (int*)(tile + (size_t)BLOCK * w * sizeof(double));
  const bool by_copy = blockIdx.x < bulk_tiles;
  if (by_copy) {
    if (tid == 0) {
      const uint32_t vbytes = (uint32_t)(BLOCK * w * sizeof(double));
      const uint32_t cbytes = (uint32_t)(BLOCK * w * sizeof(int));
      bulk::mbar_init(&bar, 1);
      bulk::mbar_init_fence();
      bulk::mbar_expect_tx(&bar, vbytes + cbytes);
      bulk::copy(tv, sp.vals + r0 * w, vbytes, &bar);
      bulk::copy(tc, sp.cols + r0 * w, cbytes, &bar);
    }
  } else {
    const int ne = (int)((n - r0 < BLOCK ? n - r0 : BLOCK) * w);
    const long long e0 = r0 * w;
    for (int e = tid; e < ne; e += BLOCK) {
      tv[e] = sp.vals[e0 + e];
      tc[e] = sp.cols[e0 + e];
    }
  }
  // (block_setup's barriers publish the mbarrier or the tile)
  block_setup(L, idx_g, scal_g, idx, scal, store_fill, store_rec);
  if (by_copy) bulk::mbar_wait(&bar, 0);
  Spmv spt = sp;
  spt.cols = tc;
  spt.vals = tv;
  if constexpr (!is_halo(KIND)) spt.z = S + (long long)idx[Ix(L).Z_TOP] * ld;
  RegVals<L> v;
  if (r0 + tid < n) {
    vector_phase<KIND, STABLE, PREC, L, true>(S, ld, rb, idx, scal,
                                              store_fill, store_rec, spt,
                                              inv_diag, v);
  } else {
#pragma unroll
    for (int k = 0; k < ND; ++k) v.prod(k) = 0.0;
  }
  warp_sums<ND, NWARP>(v.prod_, ws);
  __syncthreads();
  for (int t = tid; t < ND * NG; t += BLOCK) {
    const long long g = (long long)blockIdx.x * NG + t % NG;
    if (g < groups)
      part[(t / NG) * (long long)groups + g] =
          warps_sum<ELL_WARPS>(ws + t / NG * NWARP + t % NG * ELL_WARPS);
  }
}

// The vector phase with the depth l a runtime argument, for l > LMAX, in
// rt_smem_bytes(l) of dynamic shared memory: vector_phase_rt, then each
// product's 8 warp sums added by a fixed tree into the block's partial.
template <int KIND, bool STABLE, bool PREC>
__global__ void __launch_bounds__(BLOCK, RT_MIN_BLOCKS)
    fused_iter_kernel_rt(double* S, long long n, long long ld, long long cs,
                         int rb, int L, const int* __restrict__ idx_g,
                         const double* __restrict__ scal_g, Spmv sp,
                         long long zs, const double* __restrict__ inv_diag,
                         double* __restrict__ part) {
  static_assert(NWARP == 8, "the tree below adds 8 warp sums");
  const int ND = 2 * L + 1;
  FI_TO_COLUMN(L);
  extern __shared__ double smem[];
  double* const fill_s = smem;                     // [L][BLOCK]
  double* const rec_s = fill_s + L * BLOCK;        // [L][BLOCK]
  double* const red = rec_s + L * BLOCK;           // [ND][NWARP]
  double* const scal = red + ND * NWARP;           // [8 + L]
  int* const idx = (int*)(scal + 8 + L);           // [8L + 9]
  int* const store_fill = idx + 8 * L + 9;         // [L]
  int* const store_rec = store_fill + L;           // [L]
  block_setup<true>(L, idx_g, scal_g, idx, scal, store_fill, store_rec);
  vector_phase_rt<KIND, STABLE, PREC>(S, n, ld, rb, L, idx, scal, store_fill,
                                      store_rec, sp, inv_diag, fill_s, rec_s,
                                      red);
  __syncthreads();
  for (int k = threadIdx.x; k < ND; k += BLOCK)
    part[(long long)k * gridDim.x + blockIdx.x] =
        warps_sum<NWARP>(red + k * NWARP);
}

// Row k of column blockIdx.y's (nd, nb) per-block partials summed in a
// fixed order: thread t adds blocks t, t + BLOCK, ... in index order
// (SUM_BATCH loaded at a time before they are added: whole batches, then
// one masked), then a pairwise tree whose last five levels are warp 0's
// shuffles (the same sums: red[t] + red[t + s] for t < s).
constexpr int SUM_BATCH = 16;
__global__ void __launch_bounds__(BLOCK)
    sum_partials(const double* __restrict__ part, int nb,
                 double* __restrict__ out) {
  __shared__ double red[BLOCK];
  const int k = blockIdx.x, tid = threadIdx.x;
  part += (long long)blockIdx.y * gridDim.x * nb + (long long)k * nb;
  out += (long long)blockIdx.y * gridDim.x;
  double acc = 0.0, v[SUM_BATCH];
  int b0 = tid;
  for (; b0 + (SUM_BATCH - 1) * BLOCK < nb; b0 += SUM_BATCH * BLOCK) {
#pragma unroll
    for (int u = 0; u < SUM_BATCH; ++u) v[u] = part[b0 + u * BLOCK];
#pragma unroll
    for (int u = 0; u < SUM_BATCH; ++u) acc = acc + v[u];
  }
  if (b0 < nb) {
#pragma unroll
    for (int u = 0; u < SUM_BATCH; ++u)
      v[u] = b0 + u * BLOCK < nb ? part[b0 + u * BLOCK] : 0.0;
#pragma unroll
    for (int u = 0; u < SUM_BATCH; ++u)
      if (b0 + u * BLOCK < nb) acc = acc + v[u];
  }
  red[tid] = acc;
  __syncthreads();
  for (int s = BLOCK / 2; s >= 32; s >>= 1) {
    if (tid < s) red[tid] = red[tid] + red[tid + s];
    __syncthreads();
  }
  if (tid < 32) {
    double v = red[tid];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, s);
    if (tid == 0) out[k] = v;
  }
}

struct Args {
  double* S;
  long long n;
  long long ld;  // row stride of S (n for a whole slab, more for a column block)
  int s;         // columns of the slab form (1: one column)
  long long cs;  // column stride of S: the distance between two columns' slabs
  int rb;
  const int* idx;     // (s, 8l + 9)
  const double* scal; // (s, 8 + l)
  Spmv sp;
  double* zbuf;       // (s, zs): each column's ring-top copy or halo operand
  long long zs;
  const double* inv_diag;
  double* part;       // (s, 2l + 1, nblocks)
  int nblocks;
  double* partials;   // (s, 2l + 1)
  int tile_bytes;     // the staged ELL kernel's tile (0: not staged)
  long long bulk_tiles;  // its tiles that arrive by bulk copy
  cudaStream_t stream;
};

// The SPMV operand: a halo plug-in reads the operand the wrapper prepared
// (passed as zbuf); the stencils and ELL read a copy of the ring-top row
// taken here; the diagonal reads none.
template <int KIND>
void set_operand(Args& a, int l) {
  if constexpr (is_halo(KIND)) {
    a.sp.z = a.zbuf;
  } else if constexpr (KIND != SPMV_DIAG) {
    copy_rows(a.S, a.n, a.ld, a.cs, a.s, a.idx, 8 * l + 9, 5 * l, a.zbuf,
              a.stream);
    a.sp.z = a.zbuf;
    a.zs = a.n;
  }
}

template <int KIND, int L, bool STABLE, bool PREC>
cudaError_t launch(Args a) {
  set_operand<KIND>(a, L);
  const dim3 grid((unsigned)a.nblocks, (unsigned)a.s);
  fused_iter_kernel<KIND, L, STABLE, PREC><<<grid, BLOCK, 0, a.stream>>>(
      a.S, a.n, a.ld, a.cs, a.rb, a.idx, a.scal, a.sp, a.zs, a.inv_diag,
      a.part);
  sum_partials<<<dim3(2 * L + 1, a.s), BLOCK, 0, a.stream>>>(
      a.part, a.nblocks, a.partials);
  return cudaGetLastError();
}

// The staged ELL kernels: a slab (s > 1) one block of ELL_ROWS threads an
// ELL_ROWS-row tile (a.nblocks of them) for all s columns, in
// staged_smem_bytes of dynamic shared memory (at most 22.4 KB: no opt-in);
// one column the one-column kernel, whose BLOCK-row tile it opts in to
// once per device.  No copy of the ring-top rows (zbuf: the halo plug-in's
// prepared operands, else unused).
template <int KIND, int L, bool STABLE, bool PREC>
cudaError_t launch_staged(Args a) {
  if (a.tile_bytes != ELL_ROWS * a.sp.w * 12 ||
      a.tile_bytes > ELL_TILE_BYTES || a.bulk_tiles < 0 ||
      a.bulk_tiles > a.n / ELL_ROWS ||
      a.nblocks != (a.n + ELL_ROWS - 1) / ELL_ROWS ||
      (a.bulk_tiles > 0 && (((uintptr_t)a.sp.cols | (uintptr_t)a.sp.vals) %
                            bulk::ALIGN) != 0))
    return cudaErrorInvalidValue;
  static_assert(staged_smem_bytes(LMAX, ELL_TILE_BYTES / (ELL_ROWS * 12),
                                  SETUP_COLS) <= 48 * 1024,
                "the slab ELL kernel needs no shared memory opt-in");
  if constexpr (is_halo(KIND)) a.sp.z = a.zbuf;
  if (a.s == 1) {
    static long long allowed[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64) return cudaErrorInvalidValue;
    const long long smem = staged_smem_bytes(L, a.sp.w, 1);
    if (allowed[dev] < smem) {
      e = cudaFuncSetAttribute(
          fused_iter_kernel_staged<KIND, L, STABLE, PREC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      allowed[dev] = smem;
    }
    // (bulk_tiles > 0: the bases are aligned, and so is every full tile)
    fused_iter_kernel_staged<KIND, L, STABLE, PREC>
        <<<(unsigned)((a.n + BLOCK - 1) / BLOCK), BLOCK, (size_t)smem,
           a.stream>>>(a.S, a.n, a.ld, a.rb, a.idx, a.scal, a.sp,
                       a.inv_diag, a.part,
                       a.bulk_tiles > 0 ? a.n / BLOCK : 0, a.nblocks);
  } else {
    fused_iter_kernel_slab_ell<KIND, L, STABLE, PREC>
        <<<a.nblocks, ELL_ROWS, (size_t)staged_smem_bytes(L, a.sp.w, a.s),
           a.stream>>>(a.S, a.n, a.ld, a.cs, a.rb, a.s, a.idx, a.scal, a.sp,
                       a.zs, a.inv_diag, a.part, a.bulk_tiles);
  }
  sum_partials<<<dim3(2 * L + 1, a.s), BLOCK, 0, a.stream>>>(
      a.part, a.nblocks, a.partials);
  return cudaGetLastError();
}

// The runtime-depth kernel; it opts in to the card's largest dynamic
// shared memory and carveout once per device and refuses a depth that does
// not fit.
template <int KIND, bool STABLE, bool PREC>
cudaError_t launch_rt(Args a, int l) {
  static bool opted[64] = {};
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  const long long smem = rt_smem_bytes(l);
  if (smem > optin || dev >= 64) return cudaErrorInvalidValue;
  if (!opted[dev]) {
    // the largest carveout, so that as many blocks as fit share an SM
    e = cudaFuncSetAttribute(fused_iter_kernel_rt<KIND, STABLE, PREC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fused_iter_kernel_rt<KIND, STABLE, PREC>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    opted[dev] = true;
  }
  set_operand<KIND>(a, l);
  fused_iter_kernel_rt<KIND, STABLE, PREC>
      <<<dim3(a.nblocks, a.s), BLOCK, (size_t)smem, a.stream>>>(
          a.S, a.n, a.ld, a.cs, a.rb, l, a.idx, a.scal, a.sp, a.zs,
          a.inv_diag, a.part);
  sum_partials<<<dim3(2 * l + 1, a.s), BLOCK, 0, a.stream>>>(
      a.part, a.nblocks, a.partials);
  return cudaGetLastError();
}

template <int KIND, int L>
cudaError_t dispatch(int l, bool stable, bool prec, const Args& a) {
  if constexpr (L > LMAX) {
    if (stable)
      return prec ? launch_rt<KIND, true, true>(a, l)
                  : launch_rt<KIND, true, false>(a, l);
    return prec ? launch_rt<KIND, false, true>(a, l)
                : launch_rt<KIND, false, false>(a, l);
  } else {
    if (l != L) return dispatch<KIND, L + 1>(l, stable, prec, a);
    if constexpr (KIND == SPMV_ELL || KIND == SPMV_ELL_HALO) {
      if (a.tile_bytes > 0) {
        if (stable)
          return prec ? launch_staged<KIND, L, true, true>(a)
                      : launch_staged<KIND, L, true, false>(a);
        return prec ? launch_staged<KIND, L, false, true>(a)
                    : launch_staged<KIND, L, false, false>(a);
      }
    }
    if (a.tile_bytes != 0) return cudaErrorInvalidValue;
    if (stable)
      return prec ? launch<KIND, L, true, true>(a)
                  : launch<KIND, L, true, false>(a);
    return prec ? launch<KIND, L, false, true>(a)
                : launch<KIND, L, false, false>(a);
  }
}

}  // namespace fi

// C entries for one SPMV kind.  NAME launches (the copy of the ring-top
// row,) the superkernel (compile-time depth for l <= LMAX, the runtime-depth
// kernel above) and the partials sum on `stream`, and returns
// cudaGetLastError(); for a halo plug-in `zbuf` is the prepared operand.
// `ld` is the slab's row stride: n for a whole slab, the wider slab's row
// for a block of its columns (a virtual shard's, updated in place).
// `s` columns, `cs` elements apart in S (s = 1: one column); idx, scal,
// zbuf (`zs` apart: n for the ring-top copies), part and partials hold one
// row per column.  `tile_bytes` > 0 (the ELL plug-ins at l <= LMAX only)
// launches the staged ELL kernel with that tile, its first `bulk_tiles`
// tiles by bulk copy; the runtime-depth kernel ignores both.
// NAME_ring_top copies each column's ring-top row (position `pos` of its
// idx row, `idx_size` apart) to `out` (s, n) by copy_row: the halo
// plug-ins' operand is prepared from it outside the kernel.
// NAME_smem_optin writes the current device's largest dynamic shared memory
// a block can opt in to, which bounds the runtime-depth kernel.
#define FI_DEFINE_ENTRY(NAME, KIND)                                          \
  extern "C" int NAME(int l, int stable, int prec, void* S, long long n,     \
                      long long ld, int s, long long cs, int rb,             \
                      const void* idx, const void* scal, void* zbuf,         \
                      long long zs, const void* inv_diag, void* part,        \
                      int nblocks, void* partials, int nx, int ny, int nz,   \
                      double coef, const void* d, const void* cols,          \
                      const void* vals, int w, int tile_bytes,               \
                      long long bulk_tiles, void* stream) {                  \
    if (s < 1 || s > 65535) return (int)cudaErrorInvalidValue;               \
    fi::Args a;                                                              \
    a.S = (double*)S;                                                        \
    a.n = n;                                                                 \
    a.ld = ld;                                                               \
    a.s = s;                                                                 \
    a.cs = cs;                                                               \
    a.rb = rb;                                                               \
    a.idx = (const int*)idx;                                                 \
    a.scal = (const double*)scal;                                            \
    a.sp.z = nullptr;                                                        \
    a.sp.d = (const double*)d;                                               \
    a.sp.nx = nx;                                                            \
    a.sp.ny = ny;                                                            \
    a.sp.nz = nz;                                                            \
    a.sp.coef = coef;                                                        \
    a.sp.cols = (const int*)cols;                                            \
    a.sp.vals = (const double*)vals;                                         \
    a.sp.w = w;                                                              \
    a.zbuf = (double*)zbuf;                                                  \
    a.zs = zs;                                                               \
    a.inv_diag = (const double*)inv_diag;                                    \
    a.part = (double*)part;                                                  \
    a.nblocks = nblocks;                                                     \
    a.partials = (double*)partials;                                          \
    a.tile_bytes = tile_bytes;                                               \
    a.bulk_tiles = bulk_tiles;                                               \
    a.stream = (cudaStream_t)stream;                                         \
    return (int)fi::dispatch<KIND, 1>(l, stable != 0, prec != 0, a);         \
  }                                                                          \
  extern "C" int NAME##_ring_top(const void* S, long long n, long long ld,   \
                                 int s, long long cs, const void* idx,       \
                                 int idx_size, int pos, void* out,           \
                                 void* stream) {                             \
    if (s < 1 || s > 65535) return (int)cudaErrorInvalidValue;               \
    fi::copy_rows((const double*)S, n, ld, cs, s, (const int*)idx, idx_size, \
                  pos, (double*)out, (cudaStream_t)stream);                  \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" int NAME##_smem_optin(int* out) {                               \
    int dev = 0;                                                             \
    cudaError_t e = cudaGetDevice(&dev);                                     \
    if (e != cudaSuccess) return (int)e;                                     \
    return (int)cudaDeviceGetAttribute(                                      \
        out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);                  \
  }
