// Fused dot-product block for sm_90a.
//
// Replaces the Pallas kernel of repro/kernels/fused_dots.py
// (fused_dots_mrhs, and fused_dots, its S = 1 case; body
// _fused_dots_kernel): out (K, S) = mat (K, N) @ vecs (N, S), each operand
// cast to fp32, products and sums in fp32, the result cast back to mat's
// type (fp32 or fp64).
//
// Bound: device-memory bytes.  The block reads K*N + N*S values and does
// 2*K*N*S flops, at most 2*K*S/(K + S) flops a value: a few flops a byte
// at K = 5, S = 8, far below what the card's fp32 units need to be the
// limit.  So mat is streamed once for all S columns, as on the TPU.
//
// The Pallas kernel carries one (K, S) accumulator through a sequential
// grid; here blocks run in parallel, so:
//   pass 1: a fixed number of blocks (set by N alone) walk N with a grid
//     stride; each thread keeps a KC x SB register tile of partial sums for
//     a chunk of KC rows and SB columns, reads every mat value of its rows
//     once and its vecs row once per row chunk, and the block folds its
//     threads' tiles in a fixed tree (warp shuffles, then warps in order)
//     into one fp32 partial per (block, k, s);
//   pass 2: one block per (k, s) sums the blocks' partials in a fixed order
//     and casts to mat's type.
// No atomics: the result is the same on every run.  Rows are split into
// chunks of KC over gridDim.y so the tile stays in registers (mat is still
// read once; vecs once per chunk); S > 16 is split over gridDim.z (mat then
// read once per 16 columns).
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int MAX_BLOCKS = 1024;

template <typename T, int KC, int SB>
__global__ void __launch_bounds__(BLOCK)
    fused_dots_pass1(const T* __restrict__ mat, const T* __restrict__ vecs,
                     float* __restrict__ part, long long n, int k, int s) {
  const int k0 = blockIdx.y * KC;
  const int s0 = blockIdx.z * SB;
  float acc[KC][SB];
#pragma unroll
  for (int a = 0; a < KC; ++a)
#pragma unroll
    for (int b = 0; b < SB; ++b) acc[a][b] = 0.0f;

  const long long stride = (long long)gridDim.x * BLOCK;
#pragma unroll 2
  for (long long i = (long long)blockIdx.x * BLOCK + threadIdx.x; i < n;
       i += stride) {
    float v[SB];
#pragma unroll
    for (int b = 0; b < SB; ++b)
      v[b] = (s0 + b < s) ? (float)vecs[i * s + s0 + b] : 0.0f;
#pragma unroll
    for (int a = 0; a < KC; ++a) {
      if (k0 + a < k) {
        const float m = (float)mat[(long long)(k0 + a) * n + i];
#pragma unroll
        for (int b = 0; b < SB; ++b) acc[a][b] = acc[a][b] + m * v[b];
      }
    }
  }

  // Fixed-order block reduction: a shuffle tree inside each warp (lane 0
  // holds the warp's sum), then the warps' sums added in warp order.
  __shared__ float red[WARPS][KC * SB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < KC; ++a)
#pragma unroll
    for (int b = 0; b < SB; ++b) {
      float x = acc[a][b];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x = x + __shfl_down_sync(0xffffffffu, x, o);
      if (lane == 0) red[warp][a * SB + b] = x;
    }
  __syncthreads();
  for (int t = threadIdx.x; t < KC * SB; t += BLOCK) {
    const int a = t / SB, b = t % SB;
    if (k0 + a >= k || s0 + b >= s) continue;
    float x = red[0][t];
    for (int w = 1; w < WARPS; ++w) x = x + red[w][t];
    part[((long long)blockIdx.x * k + k0 + a) * s + s0 + b] = x;
  }
}

// One block per output (k, s): thread t sums partials t, t + BLOCK, ... in
// order, then the same fixed tree as pass 1.
template <typename T>
__global__ void __launch_bounds__(BLOCK)
    fused_dots_pass2(const float* __restrict__ part, T* __restrict__ out,
                     int nb, int ks) {
  const int o = blockIdx.x;
  float x = 0.0f;
  for (int b = threadIdx.x; b < nb; b += BLOCK)
    x = x + part[(long long)b * ks + o];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = x + __shfl_down_sync(0xffffffffu, x, d);
  __shared__ float red[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = red[0];
    for (int w = 1; w < WARPS; ++w) t = t + red[w];
    out[o] = (T)t;
  }
}

template <typename T, int KC, int SB>
void pass1(const void* mat, const void* vecs, float* part, long long n, int k,
           int s, int nb, cudaStream_t st) {
  const dim3 grid(nb, (k + KC - 1) / KC, (s + SB - 1) / SB);
  fused_dots_pass1<T, KC, SB><<<grid, BLOCK, 0, st>>>(
      (const T*)mat, (const T*)vecs, part, n, k, s);
}

// Register tile: SB = the smallest of 1, 2, 4, 8, 16 that holds min(S, 16)
// columns, KC = 64 / SB rows (at most 16), so a thread keeps <= 64 sums.
template <typename T>
int launch(const void* mat, const void* vecs, void* part, void* out,
           long long n, int k, int s, int nb, cudaStream_t st) {
  float* p = (float*)part;
  if (s <= 1)
    pass1<T, 16, 1>(mat, vecs, p, n, k, s, nb, st);
  else if (s <= 2)
    pass1<T, 16, 2>(mat, vecs, p, n, k, s, nb, st);
  else if (s <= 4)
    pass1<T, 16, 4>(mat, vecs, p, n, k, s, nb, st);
  else if (s <= 8)
    pass1<T, 8, 8>(mat, vecs, p, n, k, s, nb, st);
  else
    pass1<T, 4, 16>(mat, vecs, p, n, k, s, nb, st);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  fused_dots_pass2<T><<<k * s, BLOCK, 0, st>>>(p, (T*)out, nb, k * s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_dots_launch(int is_f32, const void* mat,
                                 const void* vecs, void* part, void* out,
                                 long long n, int k, int s, int nb,
                                 void* stream) {
  if (n == 0 || k == 0 || s == 0) return 0;
  if (nb < 1 || nb > MAX_BLOCKS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f32) return launch<float>(mat, vecs, part, out, n, k, s, nb, st);
  return launch<double>(mat, vecs, part, out, n, k, s, nb, st);
}
