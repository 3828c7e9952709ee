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
//   another block writes.
// * The ELL plug-in gathers from that copy, one row of W slots per thread
//   (row-major (n, W) cols/vals, so a warp's slot loads are strided), and
//   sums the slots in ell_rowsum's left-to-right order.
// * Store order and masks follow the plain version exactly: every mask is a
//   select, and a masked-off row write (which in the plain version stores
//   the row's original value back) is skipped only when no earlier write of
//   the same iteration hit that row, so it could not change anything.
// * --fmad=false and the plain version's order of operations make every row
//   update bitwise equal to the plain PyTorch version on the card.
// * No atomics.  Each block reduces its (2l+1) products in shared memory by
//   a fixed pairwise tree; a second launch sums the per-block partials in a
//   fixed order (strided per thread, then a tree).  The result is
//   deterministic run to run.  That order differs from XLA's and from
//   torch.sum's, and is the only reason the partials differ from the plain
//   version's.
// * idx and scal are read from device memory inside the kernels, so a
//   launch needs no host synchronisation.
// * Depth.  l <= LMAX is instantiated at compile time (per-thread arrays in
//   registers).  Deeper pipelines take fused_iter_kernel_rt, which keeps
//   l as a runtime argument and the per-thread values (the l fill and l
//   recurrence values, the 2l+1 products) in dynamic shared memory; its
//   size, rt_smem_bytes(l), is what bounds the depth (l <= 27 on an H100,
//   232 448 bytes a block).  Both kernels run one vector_phase, templated
//   on where those values live, so their rows are bitwise the same.
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
//   (each column is at its own cycle index), its own ring-top copy and
//   writes its own partials; the preconditioner's inverse diagonal, the
//   diagonal and the ELL cols/vals are shared.  A column's blocks and its
//   partials sum are the single-column launch's, in the same order, so
//   every column's rows and dots are bitwise those of a single-column
//   launch.  s = 1 is the single-column launch.  The bound is s times the
//   slab bytes of one column plus the shared operator data once.
#pragma once

#include <cuda_runtime.h>

namespace fi {

constexpr int BLOCK = 256;
constexpr int LMAX = 8;

enum { SPMV_2D5 = 0, SPMV_3D7 = 1, SPMV_3D27 = 2, SPMV_DIAG = 3,
       SPMV_ELL = 4, SPMV_2D5_HALO = 5, SPMV_3D7_HALO = 6,
       SPMV_ELL_HALO = 7 };

// Plug-ins whose operand the wrapper prepares (a halo-extended vector).
constexpr bool is_halo(int kind) {
  return kind == SPMV_2D5_HALO || kind == SPMV_3D7_HALO ||
         kind == SPMV_ELL_HALO;
}

// Dynamic shared memory of fused_iter_kernel_rt at depth l: the (2l+1)
// products, l fill and l recurrence values of each thread (doubles), the
// scalar vector, then the index vector and the two store masks (ints).
__host__ __device__ constexpr long long rt_smem_bytes(int l) {
  return (long long)(4 * l + 1) * BLOCK * 8 + (8 + l) * 8 + (8 * l + 9) * 4 +
         2 * l * 4;
}

struct Spmv {
  const double* z;     // resident copy of the ring-top row (stencils, ELL),
                       // or the prepared halo-extended operand
  const double* d;     // diagonal (SPMV_DIAG)
  int nx, ny, nz;
  double coef;         // eps_z (3D7) or centre weight (3D27)
  const int* cols;     // (n, w) ELL column indices (SPMV_ELL)
  const double* vals;  // (n, w) ELL values (SPMV_ELL)
  int w;               // ELL slots per row
};

// az[j] with the plain version's term order; grid points outside the domain
// read 0.0, as the zero-padded plain expression does.
template <int KIND>
__device__ __forceinline__ double spmv_at(const Spmv& sp, long long j,
                                          double zj) {
  if constexpr (KIND == SPMV_DIAG) {
    return sp.d[j] * zj;
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

// The ring-top row of column blockIdx.y to that column's copy.
__global__ void copy_row(const double* __restrict__ S, long long n,
                         long long ld, long long cs,
                         const int* __restrict__ idx, int idx_size, int pos,
                         double* __restrict__ z) {
  S += blockIdx.y * cs;
  z += blockIdx.y * n;
  const long long r = idx[(long long)blockIdx.y * idx_size + pos];
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (long long)gridDim.x * blockDim.x)
    z[j] = S[r * ld + j];
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

// Where a thread's per-depth values live.  Compile-time depth: register
// arrays.  Runtime depth: dynamic shared memory, [k][BLOCK] so a warp's
// accesses are conflict-free, the products in the reduction buffer.
template <int L>
struct RegVals {
  double fill_[L], rec_[L], prod_[2 * L + 1];
  __device__ __forceinline__ double& fill(int k) { return fill_[k]; }
  __device__ __forceinline__ double& rec(int k) { return rec_[k]; }
  __device__ __forceinline__ double& prod(int k) { return prod_[k]; }
};
struct SmemVals {
  double *red, *fill_, *rec_;
  int tid;
  __device__ __forceinline__ double& fill(int k) {
    return fill_[k * BLOCK + tid];
  }
  __device__ __forceinline__ double& rec(int k) {
    return rec_[k * BLOCK + tid];
  }
  __device__ __forceinline__ double& prod(int k) {
    return red[k * BLOCK + tid];
  }
};

// Every block loads the index and scalar vectors to shared memory, and its
// thread 0 works out the two store masks: a masked write stores the row's
// original value, so it is skipped unless an earlier write of this
// iteration targeted the same row.
__device__ __forceinline__ void block_setup(
    int L, const int* __restrict__ idx_g, const double* __restrict__ scal_g,
    int* idx, double* scal, int* store_fill, int* store_rec) {
  const Ix ix(L);
  const int tid = threadIdx.x;
  for (int t = tid; t < ix.IDX_SIZE; t += BLOCK) idx[t] = idx_g[t];
  for (int t = tid; t < 8 + L; t += BLOCK) scal[t] = scal_g[t];
  __syncthreads();
  if (tid == 0) {
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
  __syncthreads();
}

// One column's vector phase, written once for both kernels: LC is the
// compile-time depth (loops unroll, V = RegVals<LC>) or 0 (depth l at run
// time, V = SmemVals).  For a column j < n: the kernels zero the products
// of columns past it outside this call, since an early return here made
// the compile-time kernel slower (scripts/superkernel_ab.py sets two
// checkouts side by side).
// Every operand row is loaded before any store; the (2l+1) dot-block
// products are taken after the stores.
template <int KIND, bool STABLE, bool PREC, int LC, class V>
__device__ __forceinline__ void vector_phase(
    double* S, long long ld, int rb, int l, const int* __restrict__ idx,
    const double* __restrict__ scal, const int* __restrict__ store_fill,
    const int* __restrict__ store_rec, const Spmv& sp,
    const double* __restrict__ inv_diag, V& v) {
  const int L = LC > 0 ? LC : l;
  const Ix ix(L);
  const long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  const int u_off = (L + 1) * rb;
  double* const x_row = S + (long long)(u_off + 4) * ld;
  double* const p_row = S + (long long)(u_off + 3) * ld;
  auto row = [&](int r) -> double* { return S + (long long)r * ld; };
  const bool late = idx[ix.F_LATE] != 0;
  const double zt = row(idx[ix.Z_TOP])[j];
  const double ui = row(idx[ix.U_I])[j];
  const double uim1 = row(idx[ix.U_IM1])[j];

  // ---- (K1) SPMV + pointwise preconditioner
  const double az = spmv_at<KIND>(sp, j, zt);
  const double u_new0 = az - scal[SIG_I] * ui;
  const double u_new =
      late ? (u_new0 - scal[GAM_NEW] * ui - scal[D2] * uim1) / scal[DLT_SAFE]
           : u_new0;
  double z_new, z_fill;
  if constexpr (STABLE) {
    z_new = PREC ? inv_diag[j] * u_new : u_new;
    z_fill = z_new;
  } else {
    const double z_new0 = PREC ? inv_diag[j] * u_new0 : u_new0;
    const double zl = row(idx[ix.ZL_IM1])[j];
    z_new = late ? (z_new0 - scal[GAM_NEW] * zt - scal[D2] * zl) /
                       scal[DLT_SAFE]
                 : z_new0;
    z_fill = z_new0;
  }

  // ---- pipeline-fill copies (values; stored below)
#pragma unroll
  for (int k = 0; k < L; ++k) {
    double f = 0.0;
    if (store_fill[k])
      f = idx[ix.F_FILL + k] != 0 ? z_fill : row(idx[ix.FILL + k])[j];
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
  v.prod(2 * L) = z_new;

  // ---- (K6) solution / search-direction updates
  const double x_old = x_row[j];
  const double p_old = p_row[j];
  const double p_first = S[j] / scal[ETA0_SAFE];
  const double p_new =
      (row(idx[ix.P_IM])[j] - scal[D_PREV] * p_old) / scal[ETA_NEW_SAFE];
  const double x_new = x_old + scal[ZET_PREV] * p_old;
  const bool do_upd = idx[ix.F_UPD] != 0;
  const bool is_first = idx[ix.F_FIRST] != 0;

  // ---- stores, in the plain version's order
#pragma unroll
  for (int k = 0; k < L; ++k)
    if (store_fill[k]) row(idx[ix.FILL + k])[j] = v.fill(k);
#pragma unroll
  for (int k = 0; k < L; ++k)
    if (store_rec[k]) row(idx[ix.REC_W + k])[j] = v.rec(k);
  row(idx[ix.Z_W])[j] = z_new;
  row(idx[ix.U_W])[j] = u_new;
  x_row[j] = do_upd ? x_new : x_old;
  p_row[j] = is_first ? p_first : (do_upd ? p_new : p_old);

#pragma unroll
  for (int k = 0; k < 2 * L + 1; ++k) v.prod(k) = v.prod(k) * u_new;
}

// Per-block partials of the nd products in red ([nd][BLOCK]): a fixed
// pairwise tree, the same at either depth path.
template <int NDC>
__device__ __forceinline__ void block_partials(double* red, int nd,
                                               double* __restrict__ part) {
  const int ND = NDC > 0 ? NDC : nd;
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
    vector_phase<KIND, STABLE, PREC, L>(S, ld, rb, L, idx, scal, store_fill,
                                        store_rec, sp, inv_diag, v);
  } else {
#pragma unroll
    for (int k = 0; k < ND; ++k) v.prod(k) = 0.0;
  }
#pragma unroll
  for (int k = 0; k < ND; ++k) red[k * BLOCK + threadIdx.x] = v.prod(k);
  block_partials<ND>(red, ND, part);
}

// The same vector phase with the depth l a runtime argument, for l > LMAX:
// the per-thread values in dynamic shared memory (rt_smem_bytes(l)).
template <int KIND, bool STABLE, bool PREC>
__global__ void __launch_bounds__(BLOCK)
    fused_iter_kernel_rt(double* S, long long n, long long ld, long long cs,
                         int rb, int L, const int* __restrict__ idx_g,
                         const double* __restrict__ scal_g, Spmv sp,
                         long long zs, const double* __restrict__ inv_diag,
                         double* __restrict__ part) {
  const int ND = 2 * L + 1;
  FI_TO_COLUMN(L);
  extern __shared__ double smem[];
  double* const red = smem;                        // [ND][BLOCK]
  double* const fill_val = red + ND * BLOCK;       // [L][BLOCK]
  double* const rec_val = fill_val + L * BLOCK;    // [L][BLOCK]
  double* const scal = rec_val + L * BLOCK;        // [8 + L]
  int* const idx = (int*)(scal + 8 + L);           // [8L + 9]
  int* const store_fill = idx + 8 * L + 9;         // [L]
  int* const store_rec = store_fill + L;           // [L]
  block_setup(L, idx_g, scal_g, idx, scal, store_fill, store_rec);
  SmemVals v{red, fill_val, rec_val, (int)threadIdx.x};
  if ((long long)blockIdx.x * BLOCK + threadIdx.x < n) {
    vector_phase<KIND, STABLE, PREC, 0>(S, ld, rb, L, idx, scal, store_fill,
                                        store_rec, sp, inv_diag, v);
  } else {
    for (int k = 0; k < ND; ++k) v.prod(k) = 0.0;
  }
  block_partials<0>(red, ND, part);
}

// Row k of column blockIdx.y's (nd, nb) per-block partials summed in a
// fixed order: thread t adds blocks t, t + BLOCK, ... in index order, then
// a pairwise tree.
__global__ void __launch_bounds__(BLOCK)
    sum_partials(const double* __restrict__ part, int nb,
                 double* __restrict__ out) {
  __shared__ double red[BLOCK];
  const int k = blockIdx.x, tid = threadIdx.x;
  part += (long long)blockIdx.y * gridDim.x * nb;
  out += (long long)blockIdx.y * gridDim.x;
  double acc = 0.0;
  for (int b = tid; b < nb; b += BLOCK) acc = acc + part[(long long)k * nb + b];
  red[tid] = acc;
  __syncthreads();
  for (int s = BLOCK / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = red[tid] + red[tid + s];
    __syncthreads();
  }
  if (tid == 0) out[k] = red[0];
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
    const long long want = (a.n + BLOCK - 1) / BLOCK;
    const dim3 grid((unsigned)(want < 65535 ? want : 65535), (unsigned)a.s);
    copy_row<<<grid, BLOCK, 0, a.stream>>>(a.S, a.n, a.ld, a.cs, a.idx,
                                           8 * l + 9, 5 * l, a.zbuf);
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

// The runtime-depth kernel; it opts in to the card's largest dynamic
// shared memory once per device and refuses a depth that does not fit.
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
    e = cudaFuncSetAttribute(fused_iter_kernel_rt<KIND, STABLE, PREC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
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
// row per column.
// NAME_smem_optin writes the current device's largest dynamic shared memory
// a block can opt in to, which bounds the runtime-depth kernel.
#define FI_DEFINE_ENTRY(NAME, KIND)                                          \
  extern "C" int NAME(int l, int stable, int prec, void* S, long long n,     \
                      long long ld, int s, long long cs, int rb,             \
                      const void* idx, const void* scal, void* zbuf,         \
                      long long zs, const void* inv_diag, void* part,        \
                      int nblocks, void* partials, int nx, int ny, int nz,   \
                      double coef, const void* d, const void* cols,          \
                      const void* vals, int w, void* stream) {               \
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
    a.stream = (cudaStream_t)stream;                                         \
    return (int)fi::dispatch<KIND, 1>(l, stable != 0, prec != 0, a);         \
  }                                                                          \
  extern "C" int NAME##_smem_optin(int* out) {                               \
    int dev = 0;                                                             \
    cudaError_t e = cudaGetDevice(&dev);                                     \
    if (e != cudaSuccess) return (int)e;                                     \
    return (int)cudaDeviceGetAttribute(                                      \
        out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);                  \
  }
