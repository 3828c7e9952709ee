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

int blocks(long long n) { return (int)((n + BLOCK - 1) / BLOCK); }

}  // namespace

extern "C" int stencil2d5_launch(int is_f32, const void* g, void* out, int nx,
                                 int ny, void* stream) {
  const long long n = (long long)nx * ny;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f32)
    stencil2d5_kernel<float><<<blocks(n), BLOCK, 0, st>>>(
        (const float*)g, (float*)out, nx, ny);
  else
    stencil2d5_kernel<double><<<blocks(n), BLOCK, 0, st>>>(
        (const double*)g, (double*)out, nx, ny);
  return (int)cudaGetLastError();
}

extern "C" int stencil3d7_launch(int is_f32, const void* g, void* out, int nx,
                                 int ny, int nz, double eps_z, void* stream) {
  const long long n = (long long)nx * ny * nz;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f32)
    stencil3d7_kernel<float><<<blocks(n), BLOCK, 0, st>>>(
        (const float*)g, (float*)out, nx, ny, nz, (float)eps_z);
  else
    stencil3d7_kernel<double><<<blocks(n), BLOCK, 0, st>>>(
        (const double*)g, (double*)out, nx, ny, nz, eps_z);
  return (int)cudaGetLastError();
}
