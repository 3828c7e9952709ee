// Standalone padded-row ELL SpMV kernel for sm_90a.
//
// Replaces the Pallas kernel of repro/kernels/ell_spmv.py (ell_spmv,
// body _ell_spmv_kernel): y[r] = sum_s vals[r, s] * x[cols[r, s]] over the
// (R, W) slots of an ELL operator, with x at least R long (the
// distributed path passes [own | halo]).
//
// Bound: device-memory bytes.  Each row reads W (column, value) pairs
// (12 bytes a slot in fp64) and gathers W entries of x; the arithmetic is
// 2 W flops a row.  One thread per row, rows bounds-checked (no padding to
// a block multiple).  The row-major (R, W) layout makes a warp's loads of
// one slot strided by W elements; the W loads of a row then hit the same
// cache lines, so the strided pattern costs L1 traffic rather than device
// memory bytes, but it is what holds this first version back.  x is
// gathered through the read-only cache; after RCM neighbouring rows touch
// neighbouring entries of x.
//
// Order of summation: the explicit left-to-right chain of ell_rowsum
// (kernels/ref.py), not the Pallas kernel's .sum(axis=1).  With
// --fmad=false the result is bitwise equal to the plain version and to
// SparseOp's plain apply.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

template <typename T>
__global__ void __launch_bounds__(BLOCK)
    ell_spmv_kernel(const T* __restrict__ x, const int* __restrict__ cols,
                    const T* __restrict__ vals, T* __restrict__ y,
                    long long rows, int w) {
  const long long r = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (r >= rows) return;
  const int* c = cols + r * w;
  const T* v = vals + r * w;
  T acc = v[0] * __ldg(x + c[0]);
  for (int s = 1; s < w; ++s) acc = acc + v[s] * __ldg(x + c[s]);
  y[r] = acc;
}

}  // namespace

extern "C" int ell_spmv_launch(int is_f32, const void* x, const void* cols,
                               const void* vals, void* y, long long rows,
                               int w, void* stream) {
  if (rows == 0) return 0;
  const long long nb = (rows + BLOCK - 1) / BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f32)
    ell_spmv_kernel<float><<<(unsigned)nb, BLOCK, 0, st>>>(
        (const float*)x, (const int*)cols, (const float*)vals, (float*)y,
        rows, w);
  else
    ell_spmv_kernel<double><<<(unsigned)nb, BLOCK, 0, st>>>(
        (const double*)x, (const int*)cols, (const double*)vals, (double*)y,
        rows, w);
  return (int)cudaGetLastError();
}
