// Fused three-term recurrence for sm_90a.
//
// Replaces the Pallas kernel of repro/kernels/fused_axpy.py (fused_axpy3,
// body _fused_axpy_kernel): out = ((x + c1*y) + c2*z) * s over 1-D
// vectors, computed in fp32 and cast back to the inputs' type (fp32 or
// fp64), the scalars rounded to fp32 by the caller.
//
// Bound: device-memory bytes, three reads and one write per element (16
// bytes in fp32); the four flops an element are nothing beside them.  The
// design moves those bytes once and in wide loads: each thread takes one
// 16-byte vector of every operand (4 floats or 2 doubles) when all four
// pointers are 16-byte aligned, and the last n % V elements (or all of
// them, when a pointer is not aligned) one at a time.  No padding to a
// block multiple: the grid covers n exactly.
//
// With --fmad=false every multiply and add is rounded on its own, in the
// order of the plain version (kernels/ref.py fused_axpy3_ref), so the
// result is bitwise equal to it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 256;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename T>
__device__ __forceinline__ T axpy3(T x, T y, T z, float c1, float c2,
                                   float s) {
  const float a = (float)x, b = (float)y, c = (float)z;
  return (T)(((a + c1 * b) + c2 * c) * s);
}

// Threads [0, nvec) each take one V-wide vector; threads [nvec, nvec +
// tail) each take one of the elements after the last whole vector.
template <typename T, int V>
__global__ void __launch_bounds__(BLOCK)
    fused_axpy3_kernel(const T* __restrict__ x, const T* __restrict__ y,
                       const T* __restrict__ z, T* __restrict__ out,
                       long long nvec, long long tail, float c1, float c2,
                       float s) {
  const long long i = (long long)blockIdx.x * BLOCK + threadIdx.x;
  if (i < nvec) {
    using W = Vec<T, V>;
    const W a = reinterpret_cast<const W*>(x)[i];
    const W b = reinterpret_cast<const W*>(y)[i];
    const W c = reinterpret_cast<const W*>(z)[i];
    W r;
#pragma unroll
    for (int j = 0; j < V; ++j) r.v[j] = axpy3(a.v[j], b.v[j], c.v[j], c1, c2, s);
    reinterpret_cast<W*>(out)[i] = r;
  } else if (i < nvec + tail) {
    const long long e = nvec * V + (i - nvec);
    out[e] = axpy3(x[e], y[e], z[e], c1, c2, s);
  }
}

template <typename T>
int launch(const void* x, const void* y, const void* z, void* out,
           long long n, float c1, float c2, float s, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(z) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const long long nvec = aligned ? n / V : 0;
  const long long tail = n - nvec * V;
  const long long nb = (nvec + tail + BLOCK - 1) / BLOCK;
  fused_axpy3_kernel<T, V><<<(unsigned)nb, BLOCK, 0, st>>>(
      (const T*)x, (const T*)y, (const T*)z, (T*)out, nvec, tail, c1, c2, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_axpy3_launch(int is_f32, const void* x, const void* y,
                                  const void* z, void* out, long long n,
                                  float c1, float c2, float s, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f32) return launch<float>(x, y, z, out, n, c1, c2, s, st);
  return launch<double>(x, y, z, out, n, c1, c2, s, st);
}
