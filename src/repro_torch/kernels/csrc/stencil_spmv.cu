// Standalone matrix-free stencil SPMV kernels for sm_90a.
//
// Replace the Pallas kernels of repro/kernels/stencil_spmv.py:
//   stencil2d5 (_stencil2d5_kernel): Dirichlet 5-point Laplacian,
//     out = 4 g - up - dn - left - right;
//   stencil3d7 (_stencil3d7_kernel): anisotropic 7-point Laplacian,
//     out = (4 + 2 eps_z) g - x- - x+ - y- - y+ - eps_z z- - eps_z z+.
//
// Bound: device-memory bytes (one read of g, one write of out; the
// neighbour reads hit L1/L2).  One thread per output point along the
// contiguous axis, so every load and store of a warp is coalesced; the
// Pallas version's halo rows are not needed: a thread reads its neighbours
// straight from device memory, and points outside the domain read 0.
// Term order follows the plain expressions and the build uses
// --fmad=false, so the result is bitwise equal to the plain version.
//
// Slab form (the JAX package vmaps these kernels over a slab of
// right-hand sides): an (s, nx, ny[, nz]) input of s grids, one launch,
// the grid's index on the second grid dimension.  Each grid's points run
// the single-grid expression, so every row of the result is bitwise the
// single-grid launch's.  The bound is the same bytes per grid, s times.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    stencil2d5_kernel(const T* __restrict__ g, T* __restrict__ out, int nx,
                      int ny) {
  const long long n = (long long)nx * ny;
  const long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (j >= n) return;
  g += blockIdx.y * n;  // this grid of the slab
  out += blockIdx.y * n;
  const long long ix = j / ny, iy = j - ix * ny;
  const T c = g[j];
  const T up = ix > 0 ? g[j - ny] : T(0);
  const T dn = ix < nx - 1 ? g[j + ny] : T(0);
  const T lf = iy > 0 ? g[j - 1] : T(0);
  const T rt = iy < ny - 1 ? g[j + 1] : T(0);
  out[j] = T(4) * c - up - dn - lf - rt;
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    stencil3d7_kernel(const T* __restrict__ g, T* __restrict__ out, int nx,
                      int ny, int nz, T ez) {
  const long long sx = (long long)ny * nz;
  const long long n = (long long)nx * sx;
  const long long j = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (j >= n) return;
  g += blockIdx.y * n;  // this grid of the slab
  out += blockIdx.y * n;
  const long long iz = j % nz, t = j / nz;
  const long long iy = t % ny, ix = t / ny;
  const T c = g[j];
  const T xm = ix > 0 ? g[j - sx] : T(0);
  const T xp = ix < nx - 1 ? g[j + sx] : T(0);
  const T ym = iy > 0 ? g[j - nz] : T(0);
  const T yp = iy < ny - 1 ? g[j + nz] : T(0);
  const T zm = iz > 0 ? g[j - 1] : T(0);
  const T zp = iz < nz - 1 ? g[j + 1] : T(0);
  out[j] = (T(4) + T(2) * ez) * c - xm - xp - ym - yp - ez * zm - ez * zp;
}

dim3 grid(long long n, int s) {
  return dim3((unsigned)((n + BLOCK - 1) / BLOCK), (unsigned)s);
}

}  // namespace

// `s` grids of nx x ny (x nz) points each, contiguous: s = 1 is one grid.
extern "C" int stencil2d5_launch(int is_f32, const void* g, void* out, int s,
                                 int nx, int ny, void* stream) {
  if (s < 1 || s > 65535) return (int)cudaErrorInvalidValue;
  const dim3 gr = grid((long long)nx * ny, s);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f32)
    stencil2d5_kernel<float><<<gr, BLOCK, 0, st>>>(
        (const float*)g, (float*)out, nx, ny);
  else
    stencil2d5_kernel<double><<<gr, BLOCK, 0, st>>>(
        (const double*)g, (double*)out, nx, ny);
  return (int)cudaGetLastError();
}

extern "C" int stencil3d7_launch(int is_f32, const void* g, void* out, int s,
                                 int nx, int ny, int nz, double eps_z,
                                 void* stream) {
  if (s < 1 || s > 65535) return (int)cudaErrorInvalidValue;
  const dim3 gr = grid((long long)nx * ny * nz, s);
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f32)
    stencil3d7_kernel<float><<<gr, BLOCK, 0, st>>>(
        (const float*)g, (float*)out, nx, ny, nz, (float)eps_z);
  else
    stencil3d7_kernel<double><<<gr, BLOCK, 0, st>>>(
        (const double*)g, (double*)out, nx, ny, nz, eps_z);
  return (int)cudaGetLastError();
}
