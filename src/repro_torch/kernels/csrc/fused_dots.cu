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
// limit.  So mat is streamed once for all S columns, as on the TPU, and the
// design is about keeping enough bytes in flight:
//
// * A register tile sized to the call: KC x SB partial sums a thread, KC
//   the rows of one row chunk (K split into ceil(K / 8) chunks over
//   gridDim.y, KC = ceil(K / chunks) <= 8) and SB = 1 for S = 1, else 8
//   (S > 8 split over gridDim.z; fewer columns are masked).  At K = 5,
//   S = 1 a thread holds 5 sums, not 16.  Two column widths keep the
//   build small.
// * 16-byte loads.  A work item is one 16-byte vector of each of the KC
//   rows (4 fp32 or 2 fp64 values, VEC below) and the matching vecs rows,
//   so a thread has KC + 1 or more independent 16-byte loads in flight.
//   Row k of mat starts at element k*N, so for N*size not a multiple of 16
//   the rows sit differently against the 16-byte grid: row k's vectors
//   start at its own head h_k (the first element on a 16-byte boundary), and
//   the items before its first and after its last whole vector (its head
//   and tail, < VEC elements each) are read element by element.  Item q'
//   covers elements h_k + (q' - 1) * VEC .. + VEC - 1 of every row, so
//   q' = 0 is the heads.  The wrapper's launch plan (kernels/fused_dots.py
//   `plan`) counts the items and says whether all rows share one head and
//   whether vecs can be read as vectors too.  At S = 8 (the serve slab's
//   width) with one head and aligned vecs, a warp stages its items' vecs
//   rows through shared memory so that its loads are coalesced (a kernel
//   of its own: 48 instantiations in all).
// * A persistent grid: SMs x resident blocks (cudaOccupancyMaxActive-
//   BlocksPerMultiprocessor), divided over the row and column chunks, so
//   all blocks run in one wave and walk the items with a grid stride.
// * One launch.  Each block folds its threads' tiles in a fixed tree (warp
//   shuffles, then warps in order) into one fp32 partial per (block, k, s);
//   the last block to finish, found by a ticket counter (an atomic used
//   only to count arrivals), sums the partials of every output in block
//   order and resets the counter to 0 for the next launch on the stream.
//   No atomic touches a sum: the order of the sums depends on the grid,
//   which depends on the card, never on the run.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int N = 4;
  __device__ __forceinline__ static void get(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  }
};
template <>
struct Vec<double> {
  using type = double2;
  static constexpr int N = 2;
  __device__ __forceinline__ static void get(const double* p, float* o) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    o[0] = (float)v.x;
    o[1] = (float)v.y;
  }
};

enum { UNIFORM = 1, VECS_VEC = 2, STAGE_VECS = 4 };

// m[j] = row[i0 + j] for j < VEC, 0 outside [0, n).
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ row,
                                         long long i0, long long n,
                                         float* m) {
  constexpr int V = Vec<T>::N;
  if (i0 >= 0 && i0 + V <= n) {
    Vec<T>::get(row + i0, m);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j)
      m[j] = (i0 + j >= 0 && i0 + j < n) ? (float)row[i0 + j] : 0.0f;
  }
}

// vv[j][b] = vecs[i0 + j, s0 + b] for j < VEC, b < SB; 0 outside.
template <typename T, int SB>
__device__ __forceinline__ void load_vecs(const T* __restrict__ vecs,
                                          long long i0, long long n, int s,
                                          int s0, bool as_vec,
                                          float (&vv)[Vec<T>::N][SB]) {
  constexpr int V = Vec<T>::N;
  if constexpr (SB == 1) {
    float t[V];
    if (as_vec) {
      load_row(vecs, i0, n, t);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        t[j] = (i0 + j >= 0 && i0 + j < n) ? (float)vecs[i0 + j] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) vv[j][0] = t[j];
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long i = i0 + j;
      const bool in = i >= 0 && i < n;
      const T* r = vecs + i * s + s0;
      if (as_vec) {  // s % V == 0 and SB % V == 0: whole vectors in or out
#pragma unroll
        for (int c = 0; c < SB; c += V) {
          if (in && s0 + c < s) {
            Vec<T>::get(r + c, &vv[j][c]);
          } else {
#pragma unroll
            for (int u = 0; u < V; ++u) vv[j][c + u] = 0.0f;
          }
        }
      } else {
#pragma unroll
        for (int b = 0; b < SB; ++b)
          vv[j][b] = (in && s0 + b < s) ? (float)r[b] : 0.0f;
      }
    }
  }
}

// STAGE: the S = 8 path that stages vecs through shared memory, built as
// its own kernel so that its registers do not cost the other path
// occupancy, and held to 128 registers: two blocks an SM.
template <typename T, int KC, int SB, bool STAGE>
__global__ void __launch_bounds__(BLOCK, STAGE ? 2 : 1)
    fused_dots_kernel(const T* __restrict__ mat, const T* __restrict__ vecs,
                      float* __restrict__ part, T* __restrict__ out,
                      unsigned* __restrict__ ticket, long long n, int k,
                      int s, long long items, int flags) {
  constexpr int V = Vec<T>::N;
  const int k0 = blockIdx.y * KC;
  const int s0 = blockIdx.z * SB;
  const bool uniform = flags & UNIFORM;
  const bool as_vec = flags & VECS_VEC;
  // Row a's head: the first element on a 16-byte boundary.
  int head[KC];
#pragma unroll
  for (int a = 0; a < KC; ++a) {
    const int r = k0 + a < k ? k0 + a : k - 1;
    const uintptr_t p = (uintptr_t)(mat + (long long)r * n);
    head[a] = (int)(((16u - (unsigned)(p & 15u)) & 15u) / sizeof(T));
  }
  float acc[KC][SB];
#pragma unroll
  for (int a = 0; a < KC; ++a)
#pragma unroll
    for (int b = 0; b < SB; ++b) acc[a][b] = 0.0f;

  const long long stride = (long long)gridDim.x * BLOCK;
  if constexpr (STAGE) {
    // S = 8, one head for every row, vecs 16-byte aligned: an item's vecs
    // rows are 128 contiguous bytes and a warp's 32 items 4 KB.  Read
    // directly, lane l's 16-byte loads would stride 128 bytes across the
    // warp; instead the warp reads its 4 KB in eight coalesced 16-byte
    // loads a lane into a padded shared buffer (pitch 16 bytes over an
    // item: conflict-free 16-byte reads), and each lane takes its item.
    constexpr int PITCH = V * 8 + 4;  // floats an item takes in the buffer
    __shared__ __align__(16) float stage[WARPS][32 * PITCH];
    const int lane = threadIdx.x & 31;
    float* buf = stage[threadIdx.x >> 5];
    for (long long qb = (long long)blockIdx.x * BLOCK + (threadIdx.x & ~31);
         qb < items; qb += stride) {
      // Every load of the item first (its KC mat vectors and the warp's
      // eight vecs chunks), so that one latency covers them all.
      const long long base = (qb + lane - 1) * V;
      float m[KC][V];
#pragma unroll
      for (int a = 0; a < KC; ++a) {
        if (k0 + a < k) {
          load_row(mat + (long long)(k0 + a) * n, base + head[a], n, m[a]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) m[a][j] = 0.0f;
        }
      }
      const long long r0 = (qb - 1) * V + head[0];  // the block's first row
      float f[8][V];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int g = c * 32 + lane;     // its 16-byte chunk: V elements
        const long long r = r0 + g * V / 8;
        if (r >= 0 && r < n) {
          Vec<T>::get(vecs + r0 * 8 + (long long)g * V, f[c]);
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u) f[c][u] = 0.0f;
        }
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int g = c * 32 + lane;
        float* d = buf + (g / 8) * PITCH + (g % 8) * V;
#pragma unroll
        for (int u = 0; u < V; ++u) d[u] = f[c][u];
      }
      __syncwarp();
      float vv[V][SB];
      const float4* it = reinterpret_cast<const float4*>(buf + lane * PITCH);
#pragma unroll
      for (int c = 0; c < V * 2; ++c) {
        const float4 t = it[c];
        vv[c / 2][(c % 2) * 4 + 0] = t.x;
        vv[c / 2][(c % 2) * 4 + 1] = t.y;
        vv[c / 2][(c % 2) * 4 + 2] = t.z;
        vv[c / 2][(c % 2) * 4 + 3] = t.w;
      }
#pragma unroll
      for (int a = 0; a < KC; ++a)
#pragma unroll
        for (int j = 0; j < V; ++j)
#pragma unroll
          for (int b = 0; b < SB; ++b)
            acc[a][b] = acc[a][b] + m[a][j] * vv[j][b];
      __syncwarp();
    }
  } else {
#pragma unroll 2
    for (long long q = (long long)blockIdx.x * BLOCK + threadIdx.x; q < items;
         q += stride) {
      const long long base = (q - 1) * V;
      float vv[V][SB];
      if (uniform)
        load_vecs<T, SB>(vecs, base + head[0], n, s, s0, as_vec, vv);
#pragma unroll
      for (int a = 0; a < KC; ++a) {
        if (k0 + a < k) {
          const long long i0 = base + head[a];
          float m[V];
          load_row(mat + (long long)(k0 + a) * n, i0, n, m);
          if (!uniform) load_vecs<T, SB>(vecs, i0, n, s, s0, as_vec, vv);
#pragma unroll
          for (int j = 0; j < V; ++j)
#pragma unroll
            for (int b = 0; b < SB; ++b)
              acc[a][b] = acc[a][b] + m[j] * vv[j][b];
        }
      }
    }
  }

  // Fixed-order block reduction: a shuffle tree inside each warp (lane 0
  // holds the warp's sum), then the warps' sums added in warp order.
  __shared__ float red[WARPS][KC * SB];
  __shared__ bool last;
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
  const int nbx = gridDim.x;
  for (int t = threadIdx.x; t < KC * SB; t += BLOCK) {
    const int a = t / SB, b = t % SB;
    if (k0 + a >= k || s0 + b >= s) continue;
    float x = red[0][t];
    for (int w = 1; w < WARPS; ++w) x = x + red[w][t];
    part[((long long)(k0 + a) * s + s0 + b) * nbx + blockIdx.x] = x;
  }

  // The last block to arrive sums every output's partials in block order.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned blocks = gridDim.x * gridDim.y * gridDim.z;
    last = atomicAdd(ticket, 1u) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = warp; o < k * s; o += WARPS) {
    const float* p = part + (long long)o * nbx;
    float x = 0.0f;
    for (int b = lane; b < nbx; b += 32) x = x + __ldcg(p + b);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      x = x + __shfl_down_sync(0xffffffffu, x, d);
    if (lane == 0) out[o] = (T)x;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <typename T, int KC, int SB, bool STAGE>
int run(bool occupancy_only, int* blocks, const void* mat, const void* vecs,
        void* part, void* out, void* ticket, long long n, int k, int s,
        long long items, int flags, int gx, cudaStream_t st) {
  if (occupancy_only)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fused_dots_kernel<T, KC, SB, STAGE>, BLOCK, 0);
  const dim3 grid(gx, (k + KC - 1) / KC, (s + SB - 1) / SB);
  fused_dots_kernel<T, KC, SB, STAGE><<<grid, BLOCK, 0, st>>>(
      (const T*)mat, (const T*)vecs, (float*)part, (T*)out,
      (unsigned*)ticket, n, k, s, items, flags);
  return (int)cudaGetLastError();
}

template <typename T, int KC>
int by_sb(int sb, bool occ, int* blocks, const void* mat, const void* vecs,
          void* part, void* out, void* ticket, long long n, int k, int s,
          long long items, int flags, int gx, cudaStream_t st) {
  switch (sb) {
    case 1: return run<T, KC, 1, false>(occ, blocks, mat, vecs, part, out,
                                        ticket, n, k, s, items, flags, gx, st);
    case 8:
      if (flags & STAGE_VECS)
        return run<T, KC, 8, true>(occ, blocks, mat, vecs, part, out, ticket,
                                   n, k, s, items, flags, gx, st);
      return run<T, KC, 8, false>(occ, blocks, mat, vecs, part, out, ticket,
                                  n, k, s, items, flags, gx, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int by_kc(int kc, int sb, bool occ, int* blocks, const void* mat,
          const void* vecs, void* part, void* out, void* ticket, long long n,
          int k, int s, long long items, int flags, int gx, cudaStream_t st) {
#define FD_KC(C)                                                          \
  case C:                                                                 \
    return by_sb<T, C>(sb, occ, blocks, mat, vecs, part, out, ticket, n, k, \
                       s, items, flags, gx, st);
  switch (kc) {
    FD_KC(1) FD_KC(2) FD_KC(3) FD_KC(4) FD_KC(5) FD_KC(6) FD_KC(7) FD_KC(8)
  }
#undef FD_KC
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Blocks of the (kc, sb, flags) kernel one SM holds: the wrapper's plan
// sizes the persistent grid with it.
extern "C" int fused_dots_occupancy(int is_f32, int kc, int sb, int flags,
                                    int* blocks) {
  if (is_f32)
    return by_kc<float>(kc, sb, true, blocks, nullptr, nullptr, nullptr,
                        nullptr, nullptr, 0, 0, 0, 0, flags, 0, nullptr);
  return by_kc<double>(kc, sb, true, blocks, nullptr, nullptr, nullptr,
                       nullptr, nullptr, 0, 0, 0, 0, flags, 0, nullptr);
}

// part: k * s * gx fp32 partials; ticket: one unsigned, 0 between launches.
extern "C" int fused_dots_launch(int is_f32, const void* mat,
                                 const void* vecs, void* part, void* out,
                                 void* ticket, long long n, int k, int s,
                                 int kc, int sb, long long items, int flags,
                                 int gx, void* stream) {
  if (n == 0 || k == 0 || s == 0) return 0;
  if (gx < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f32)
    return by_kc<float>(kc, sb, false, nullptr, mat, vecs, part, out, ticket,
                        n, k, s, items, flags, gx, st);
  return by_kc<double>(kc, sb, false, nullptr, mat, vecs, part, out, ticket,
                       n, k, s, items, flags, gx, st);
}
