// Fused-iteration superkernel: one whole p(l)-CG vector phase in one pass
// over the (NV, N) state slab, for sm_90a.
//
// Replaces the Pallas kernel of repro/kernels/fused_iter.py
// (build_fused_iteration -> fiter, body `kernel`, with its SPMV plug-ins
// resident_spmv and diagonal_spmv).  It computes, per column j of the slab:
// the SPMV of the ring-top z, the pointwise (Jacobi) preconditioner, the
// pipeline-fill copies, the K4 basis recurrences (ghysels or stable), the
// ring writes, the K6 x/p updates and the (2l+1) local dot-block products,
// and reduces the products to per-block partials.
//
// Bound: device-memory bytes.  Every slab row the iteration touches is read
// once and every updated row written once (17 distinct rows of N doubles in
// a late iteration at l = 2 with Jacobi); the arithmetic is a few dozen
// flops per column.  The design keeps one column per thread so each thread
// has a dozen independent coalesced loads in flight, and nothing of the
// slab is staged in shared memory.
//
// Design notes:
// * In place across blocks.  Row writes are per column and a thread loads
//   every operand row it needs at its column before it stores anything, so
//   the slab is updated in place, as the Pallas kernel's aliased output is.
// * The stencil SPMV reads the ring-top row at other blocks' columns, so the
//   wrapper's first launch copies that row to its own buffer (the Pallas
//   wrapper's `prepare(z_top)`); no block reads a row another block writes.
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
#pragma once

#include <cuda_runtime.h>

namespace fi {

constexpr int BLOCK = 256;
constexpr int LMAX = 6;

enum { SPMV_2D5 = 0, SPMV_3D7 = 1, SPMV_3D27 = 2, SPMV_DIAG = 3 };

struct Spmv {
  const double* z;  // resident copy of the ring-top row (stencils)
  const double* d;  // diagonal (SPMV_DIAG)
  int nx, ny, nz;
  double coef;      // eps_z (3D7) or centre weight (3D27)
};

// az[j] with the plain version's term order; grid points outside the domain
// read 0.0, as the zero-padded plain expression does.
template <int KIND>
__device__ __forceinline__ double spmv_at(const Spmv& sp, long long j,
                                          double zj) {
  if constexpr (KIND == SPMV_DIAG) {
    return sp.d[j] * zj;
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

__global__ void copy_row(const double* __restrict__ S, long long n,
                         const int* __restrict__ idx, int pos,
                         double* __restrict__ z) {
  const long long r = idx[pos];
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (long long)gridDim.x * blockDim.x)
    z[j] = S[r * n + j];
}

template <int KIND, int L, bool STABLE, bool PREC>
__global__ void __launch_bounds__(BLOCK)
    fused_iter_kernel(double* S, long long n, int rb,
                      const int* __restrict__ idx_g,
                      const double* __restrict__ scal_g, Spmv sp,
                      const double* __restrict__ inv_diag,
                      double* __restrict__ part) {
  constexpr int ND = 2 * L + 1;
  // idx_layout(L) and scal_layout(L) of kernels/fused_iter.py.
  constexpr int FILL = 0, REC_W = L, REC_A = 2 * L, REC_B = 3 * L,
                REC_C = 4 * L, Z_TOP = 5 * L, ZL_IM1 = 5 * L + 1,
                Z_W = 5 * L + 2, U_I = 5 * L + 3, U_IM1 = 5 * L + 4,
                U_W = 5 * L + 5, P_IM = 5 * L + 6, MAT_V = 5 * L + 7,
                MAT_Z = 6 * L + 7, F_FILL = 7 * L + 6, F_LATE = 8 * L + 6,
                F_FIRST = 8 * L + 7, F_UPD = 8 * L + 8, IDX_SIZE = 8 * L + 9;
  constexpr int SIG_I = 0, GAM_NEW = 1, D2 = 2, DLT_SAFE = 3, ZET_PREV = 4,
                D_PREV = 5, ETA_NEW_SAFE = 6, ETA0_SAFE = 7, C1 = 8,
                SCAL_SIZE = 8 + L;

  __shared__ int idx[IDX_SIZE];
  __shared__ double scal[SCAL_SIZE];
  __shared__ int store_fill[L], store_rec[L];
  __shared__ double red[ND][BLOCK];

  const int tid = threadIdx.x;
  if (tid < IDX_SIZE) idx[tid] = idx_g[tid];
  if (tid < SCAL_SIZE) scal[tid] = scal_g[tid];
  __syncthreads();
  if (tid == 0) {
    // A masked write stores the row's original value; skip it unless an
    // earlier write of this iteration targeted the same row.
    const bool late_ = idx[F_LATE] != 0;
    for (int k = 0; k < L; ++k) {
      bool s = idx[F_FILL + k] != 0;
      for (int k2 = 0; k2 < k; ++k2) s = s || idx[FILL + k2] == idx[FILL + k];
      store_fill[k] = s;
    }
    for (int k = 0; k < L; ++k) {
      bool s = late_;
      for (int k2 = 0; k2 < L; ++k2) s = s || idx[FILL + k2] == idx[REC_W + k];
      for (int k2 = 0; k2 < k; ++k2)
        s = s || idx[REC_W + k2] == idx[REC_W + k];
      store_rec[k] = s;
    }
  }
  __syncthreads();

  const long long j = (long long)blockIdx.x * BLOCK + tid;
  const int u_off = (L + 1) * rb;
  double* const x_row = S + (long long)(u_off + 4) * n;
  double* const p_row = S + (long long)(u_off + 3) * n;
  double prod[ND];
  if (j < n) {
    auto row = [&](int r) -> double* { return S + (long long)r * n; };
    const bool late = idx[F_LATE] != 0;
    const double zt = row(idx[Z_TOP])[j];
    const double ui = row(idx[U_I])[j];
    const double uim1 = row(idx[U_IM1])[j];

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
      const double zl = row(idx[ZL_IM1])[j];
      z_new = late ? (z_new0 - scal[GAM_NEW] * zt - scal[D2] * zl) /
                         scal[DLT_SAFE]
                   : z_new0;
      z_fill = z_new0;
    }

    // ---- pipeline-fill copies (values; stored below)
    double fill_val[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      fill_val[k] = 0.0;
      if (store_fill[k])
        fill_val[k] = idx[F_FILL + k] != 0 ? z_fill : row(idx[FILL + k])[j];
    }

    // ---- (K4) basis recurrences, masked late
    double rec_val[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      rec_val[k] = 0.0;
      if (late) {
        const double zk1 = row(idx[REC_A + k])[j];
        const double zm1 = row(idx[REC_B + k])[j];
        const double zm2 = row(idx[REC_C + k])[j];
        rec_val[k] = (zk1 + scal[C1 + k] * zm1 - scal[D2] * zm2) /
                     scal[DLT_SAFE];
      } else if (k == 0 || store_rec[k]) {
        rec_val[k] = row(idx[REC_W + k])[j];
      }
    }

    // ---- (K5) dot-block operand rows, read before any store
    double mat[ND];
#pragma unroll
    for (int t = 0; t < L; ++t) mat[t] = row(idx[MAT_V + t])[j];
    mat[L] = rec_val[0];
#pragma unroll
    for (int t = 0; t < L - 1; ++t) mat[L + 1 + t] = row(idx[MAT_Z + t])[j];
    mat[2 * L] = z_new;

    // ---- (K6) solution / search-direction updates
    const double x_old = x_row[j];
    const double p_old = p_row[j];
    const double p_first = S[j] / scal[ETA0_SAFE];
    const double p_new =
        (row(idx[P_IM])[j] - scal[D_PREV] * p_old) / scal[ETA_NEW_SAFE];
    const double x_new = x_old + scal[ZET_PREV] * p_old;
    const bool do_upd = idx[F_UPD] != 0;
    const bool is_first = idx[F_FIRST] != 0;

    // ---- stores, in the plain version's order
#pragma unroll
    for (int k = 0; k < L; ++k)
      if (store_fill[k]) row(idx[FILL + k])[j] = fill_val[k];
#pragma unroll
    for (int k = 0; k < L; ++k)
      if (store_rec[k]) row(idx[REC_W + k])[j] = rec_val[k];
    row(idx[Z_W])[j] = z_new;
    row(idx[U_W])[j] = u_new;
    x_row[j] = do_upd ? x_new : x_old;
    p_row[j] = is_first ? p_first : (do_upd ? p_new : p_old);

#pragma unroll
    for (int k = 0; k < ND; ++k) prod[k] = mat[k] * u_new;
  } else {
#pragma unroll
    for (int k = 0; k < ND; ++k) prod[k] = 0.0;
  }

  // ---- per-block partials: fixed pairwise tree in shared memory
#pragma unroll
  for (int k = 0; k < ND; ++k) red[k][tid] = prod[k];
  __syncthreads();
#pragma unroll
  for (int s = BLOCK / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int k = 0; k < ND; ++k) red[k][tid] = red[k][tid] + red[k][tid + s];
    }
    __syncthreads();
  }
  if (tid < ND) part[(long long)tid * gridDim.x + blockIdx.x] = red[tid][0];
}

// Row k of the (nd, nb) per-block partials summed in a fixed order: thread t
// adds blocks t, t + BLOCK, ... in index order, then a pairwise tree.
__global__ void __launch_bounds__(BLOCK)
    sum_partials(const double* __restrict__ part, int nb,
                 double* __restrict__ out) {
  __shared__ double red[BLOCK];
  const int k = blockIdx.x, tid = threadIdx.x;
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
  int rb;
  const int* idx;
  const double* scal;
  Spmv sp;
  double* zbuf;
  const double* inv_diag;
  double* part;
  int nblocks;
  double* partials;
  cudaStream_t stream;
};

template <int KIND, int L, bool STABLE, bool PREC>
cudaError_t launch(Args a) {
  if (KIND != SPMV_DIAG) {
    const long long want = (a.n + BLOCK - 1) / BLOCK;
    const int grid = (int)(want < 65535 ? want : 65535);
    copy_row<<<grid, BLOCK, 0, a.stream>>>(a.S, a.n, a.idx, 5 * L, a.zbuf);
    a.sp.z = a.zbuf;
  }
  fused_iter_kernel<KIND, L, STABLE, PREC><<<a.nblocks, BLOCK, 0, a.stream>>>(
      a.S, a.n, a.rb, a.idx, a.scal, a.sp, a.inv_diag, a.part);
  sum_partials<<<2 * L + 1, BLOCK, 0, a.stream>>>(a.part, a.nblocks,
                                                   a.partials);
  return cudaGetLastError();
}

template <int KIND, int L>
cudaError_t dispatch(int l, bool stable, bool prec, const Args& a) {
  if constexpr (L > LMAX) {
    return cudaErrorInvalidValue;
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

// C entry for one SPMV kind: launches (copy of the ring-top row,) the
// superkernel and the partials sum on `stream`; returns cudaGetLastError().
#define FI_DEFINE_ENTRY(NAME, KIND)                                          \
  extern "C" int NAME(int l, int stable, int prec, void* S, long long n,     \
                      int rb, const void* idx, const void* scal, void* zbuf, \
                      const void* inv_diag, void* part, int nblocks,         \
                      void* partials, int nx, int ny, int nz, double coef,   \
                      const void* d, void* stream) {                         \
    fi::Args a;                                                              \
    a.S = (double*)S;                                                        \
    a.n = n;                                                                 \
    a.rb = rb;                                                               \
    a.idx = (const int*)idx;                                                 \
    a.scal = (const double*)scal;                                            \
    a.sp.z = nullptr;                                                        \
    a.sp.d = (const double*)d;                                               \
    a.sp.nx = nx;                                                            \
    a.sp.ny = ny;                                                            \
    a.sp.nz = nz;                                                            \
    a.sp.coef = coef;                                                        \
    a.zbuf = (double*)zbuf;                                                  \
    a.inv_diag = (const double*)inv_diag;                                    \
    a.part = (double*)part;                                                  \
    a.nblocks = nblocks;                                                     \
    a.partials = (double*)partials;                                          \
    a.stream = (cudaStream_t)stream;                                         \
    return (int)fi::dispatch<KIND, 1>(l, stable != 0, prec != 0, a);         \
  }
