// Split-KV decode attention (one query token, GQA) for sm_90a.
//
// Replaces the Pallas kernel of repro/kernels/decode_attention.py
// (decode_attention_stats, body _decode_attn_kernel): for each batch row b
// and KV head h, the G query heads q[b, h, g, :] attend over the cache's
// first kv_len positions with an online softmax in fp32; scores past
// kv_len are -1e30.  Outputs are the Pallas kernel's: the unnormalized
// o (B, Hkv, G, D) with m and l (B, Hkv, G, 1), all fp32.  The cache is
// read in the callers' (B, S, Hkv, D) layout (fp32 or bf16), so no
// transposed copy of it is made.
//
// Bound: device-memory bytes.  Every valid key and value row is read once
// (2*D values a row); the work on it is 4*G*D flops, about G flops a byte
// in fp32, far below the card's fp32 rate.  The design spreads those reads
// over the whole card and keeps enough of them in flight:
//   split pass: one block per (block_s keys, b, h, chunk of GC query heads).
//     Each warp takes UNR keys at a time: its lanes load the k and v rows
//     (DPL consecutive values a lane, one vector load each), every lane
//     gets the G scores through a butterfly of shuffles (the same value on
//     every lane), and the warp updates its own (m, l, acc) once for the
//     UNR keys.  The warps' states are then merged in warp order into one
//     partial (m, l, o) per block;
//   merge pass: one block per (b, h, g) merges the blocks' partials along
//     the sequence: m = their max, then l and o rescaled by exp(m_i - m)
//     and summed, each warp over a fixed residue class of the splits and
//     the warps in order.
// Without the split, the long_500k shape (B * Hkv = 8) would fill 8 of
// 132 SMs.  Keys at or past kv_len are not read: their weight is exactly
// 0 once any key is valid.  With kv_len = 0 every key is read, masked and
// weighs exp(0) = 1, as in the Pallas kernel (m = -1e30, l = S, o = sum v).
//
// kv_len on the device: when `kv_dev` is given, both passes read kv_len
// from it (already clamped to [0, S] by the wrapper), so a decode step
// whose length lives on the card needs no host synchronisation.  The grid
// is then sized for the whole cache; split blocks past ceil(eff / block_s)
// return at once and the merge pass stops there, so the result is the
// integer path's, bit for bit (the partials' stride is the only change).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int WARPS = 8;       // warps of a split block
constexpr int UNR = 4;         // keys a warp loads before it updates
constexpr int MWARPS = 32;     // warps of a merge block

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int N, typename T>
__device__ __forceinline__ void load_row(const T* p, bool ok, float (&r)[N]) {
  if (ok) {
    const Vec<T, N> w = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
    for (int j = 0; j < N; ++j) r[j] = to_f(w.v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) r[j] = 0.0f;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = x + __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// kv_len and the length the splits cover (eff_len: kv_len, or S when it is
// 0), from the device when kv_dev is given.
__device__ __forceinline__ void kv_lengths(const int* kv_dev, int s_len,
                                           int& kv_len, int& eff_len) {
  if (kv_dev != nullptr) {
    kv_len = *kv_dev;
    eff_len = kv_len > 0 ? kv_len : s_len;
  }
}

// Partials: pm, pl (BH, G, nsplit) and po (BH, G, nsplit, D), fp32.
template <typename T, int GC, int DPL>
__global__ void __launch_bounds__(WARPS * 32)
    decode_split(const float* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ pm,
                 float* __restrict__ pl, float* __restrict__ po, int s_len,
                 int hkv, int g_tot, int d, int kv_len, int eff_len,
                 int block_s, float scale, const int* __restrict__ kv_dev) {
  const int split = blockIdx.x, nsplit = gridDim.x;
  kv_lengths(kv_dev, s_len, kv_len, eff_len);
  if (split * block_s >= eff_len) return;
  const int bh = blockIdx.y, b = bh / hkv, h = bh % hkv;
  const int g0 = blockIdx.z * GC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = lane * DPL;
  const bool lane_on = d0 < d;

  float qr[GC][DPL];
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      qr[g][j] = (lane_on && g0 + g < g_tot)
                     ? q[((long long)bh * g_tot + g0 + g) * d + d0 + j]
                     : 0.0f;

  float m[GC], l[GC], acc[GC][DPL];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = NEG;
    l[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[g][j] = 0.0f;
  }

  const int start = split * block_s;
  const int end = min(start + block_s, eff_len);
  const long long row = (long long)hkv * d;           // one position's stride
  const long long base = ((long long)b * s_len) * row + (long long)h * d + d0;
  for (int s0 = start + warp * UNR; s0 < end; s0 += WARPS * UNR) {
    float kr[UNR][DPL], vr[UNR][DPL];
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const bool ok = lane_on && s0 + u < end;
      const long long off = base + (long long)(s0 + u) * row;
      load_row<DPL>(k + off, ok, kr[u]);
      load_row<DPL>(v + off, ok, vr[u]);
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float sc[UNR];
      float mt = m[g];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        float x = qr[g][0] * kr[u][0];
#pragma unroll
        for (int j = 1; j < DPL; ++j) x = x + qr[g][j] * kr[u][j];
        x = warp_sum(x) * scale;
        sc[u] = (s0 + u < kv_len) ? x : NEG;
        if (s0 + u < end) mt = fmaxf(mt, sc[u]);
      }
      const float alpha = expf(m[g] - mt);
      float p[UNR], ps = 0.0f;
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        p[u] = (s0 + u < end) ? expf(sc[u] - mt) : 0.0f;
        ps = ps + p[u];
      }
      l[g] = l[g] * alpha + ps;
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        float a = acc[g][j] * alpha;
#pragma unroll
        for (int u = 0; u < UNR; ++u) a = a + p[u] * vr[u][j];
        acc[g][j] = a;
      }
      m[g] = mt;
    }
  }

  // Merge the warps' states in warp order.
  __shared__ float sm_m[GC], sm_l[GC];
  __shared__ float sm_o[GC][32 * DPL];
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (w == 0) {
          if (lane_on)
#pragma unroll
            for (int j = 0; j < DPL; ++j) sm_o[g][d0 + j] = acc[g][j];
          if (lane == 0) {
            sm_m[g] = m[g];
            sm_l[g] = l[g];
          }
        } else {
          const float mo = sm_m[g], lo = sm_l[g];
          const float mn = fmaxf(mo, m[g]);
          const float a = expf(mo - mn), c = expf(m[g] - mn);
          if (lane_on)
#pragma unroll
            for (int j = 0; j < DPL; ++j)
              sm_o[g][d0 + j] = sm_o[g][d0 + j] * a + acc[g][j] * c;
          __syncwarp();
          if (lane == 0) {
            sm_m[g] = mn;
            sm_l[g] = lo * a + l[g] * c;
          }
        }
      }
    }
    __syncthreads();
  }

  for (int t = threadIdx.x; t < GC * d; t += WARPS * 32) {
    const int g = t / d, e = t % d;
    if (g0 + g >= g_tot) continue;
    const long long r = ((long long)bh * g_tot + g0 + g) * nsplit + split;
    po[r * d + e] = sm_o[g][e];
    if (e == 0) {
      pm[r] = sm_m[g];
      pl[r] = sm_l[g];
    }
  }
}

// One block per (b, h, g).  Outputs o (BH, G, D), m and l (BH, G).
template <int DPL>
__global__ void __launch_bounds__(MWARPS * 32)
    decode_merge(const float* __restrict__ pm, const float* __restrict__ pl,
                 const float* __restrict__ po, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 int nsplit, int d, int s_len, int block_s,
                 const int* __restrict__ kv_dev) {
  const long long r0 = (long long)blockIdx.x * nsplit;
  if (kv_dev != nullptr) {
    int kv_len = 0, eff_len = 0;
    kv_lengths(kv_dev, s_len, kv_len, eff_len);
    nsplit = (eff_len + block_s - 1) / block_s;   // the stride stays r0's
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = lane * DPL;
  const bool lane_on = d0 < d;
  __shared__ float red[MWARPS];
  __shared__ float sm_o[MWARPS][32 * DPL + 1];
  __shared__ float sm_l[MWARPS];

  // The max is exact in any order.
  float mx = NEG;
  for (int i = threadIdx.x; i < nsplit; i += MWARPS * 32)
    mx = fmaxf(mx, pm[r0 + i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < MWARPS; ++w) mx = fmaxf(mx, red[w]);

  float ls = 0.0f, a[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) a[j] = 0.0f;
#pragma unroll 4
  for (int i = warp; i < nsplit; i += MWARPS) {
    const float c = expf(pm[r0 + i] - mx);
    ls = ls + pl[r0 + i] * c;
    if (lane_on) {
      const float* src = po + (r0 + i) * d + d0;
#pragma unroll
      for (int j = 0; j < DPL; ++j) a[j] = a[j] + src[j] * c;
    }
  }
  if (lane_on)
#pragma unroll
    for (int j = 0; j < DPL; ++j) sm_o[warp][d0 + j] = a[j];
  if (lane == 0) sm_l[warp] = ls;
  __syncthreads();
  for (int e = threadIdx.x; e < d; e += MWARPS * 32) {
    float x = sm_o[0][e];
    for (int w = 1; w < MWARPS; ++w) x = x + sm_o[w][e];
    o[(long long)blockIdx.x * d + e] = x;
  }
  if (threadIdx.x == 0) {
    float x = sm_l[0];
    for (int w = 1; w < MWARPS; ++w) x = x + sm_l[w];
    l_out[blockIdx.x] = x;
    m_out[blockIdx.x] = mx;
  }
}

template <typename T, int GC, int DPL>
void split(const float* q, const void* k, const void* v, float* pm, float* pl,
           float* po, int b, int s, int hkv, int g, int d, int kv_len,
           int eff_len, int block_s, int nsplit, float scale,
           const int* kv_dev, cudaStream_t st) {
  const dim3 grid(nsplit, b * hkv, (g + GC - 1) / GC);
  decode_split<T, GC, DPL><<<grid, WARPS * 32, 0, st>>>(
      q, (const T*)k, (const T*)v, pm, pl, po, s, hkv, g, d, kv_len, eff_len,
      block_s, scale, kv_dev);
}

// GC = the smallest of 1, 2, 4, 8 that holds min(G, 8) query heads.
template <typename T, int DPL>
void split_gc(const float* q, const void* k, const void* v, float* pm,
              float* pl, float* po, int b, int s, int hkv, int g, int d,
              int kv_len, int eff_len, int block_s, int nsplit, float scale,
              const int* kv_dev, cudaStream_t st) {
#define DA_SPLIT(GC)                                                         \
  split<T, GC, DPL>(q, k, v, pm, pl, po, b, s, hkv, g, d, kv_len, eff_len,  \
                    block_s, nsplit, scale, kv_dev, st)
  if (g <= 1)
    DA_SPLIT(1);
  else if (g <= 2)
    DA_SPLIT(2);
  else if (g <= 4)
    DA_SPLIT(4);
  else
    DA_SPLIT(8);
#undef DA_SPLIT
}

template <int DPL>
int launch(int is_bf16, const float* q, const void* k, const void* v,
           float* part, float* o, float* m, float* l, int b, int s, int hkv,
           int g, int d, int kv_len, int eff_len, int block_s, int nsplit,
           float scale, const int* kv_dev, cudaStream_t st) {
  const long long rows = (long long)b * hkv * g * nsplit;
  float* pm = part;
  float* pl = part + rows;
  float* po = part + 2 * rows;
  if (is_bf16)
    split_gc<__nv_bfloat16, DPL>(q, k, v, pm, pl, po, b, s, hkv, g, d, kv_len,
                                 eff_len, block_s, nsplit, scale, kv_dev, st);
  else
    split_gc<float, DPL>(q, k, v, pm, pl, po, b, s, hkv, g, d, kv_len,
                         eff_len, block_s, nsplit, scale, kv_dev, st);
  const int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  decode_merge<DPL><<<b * hkv * g, MWARPS * 32, 0, st>>>(
      pm, pl, po, o, m, l, nsplit, d, s, block_s, kv_dev);
  return (int)cudaGetLastError();
}

}  // namespace

// part holds (B*Hkv*G*nsplit) * (D + 2) floats; nsplit = ceil(eff_len /
// block_s), eff_len = kv_len, or S when kv_len is 0; dpl = the values of a
// row each lane holds (1, 2, 4 or 8; D <= 32 * dpl, D % dpl == 0).  With
// kv_dev (an int32 on the device, in [0, S]) kv_len and eff_len are read
// there and nsplit is ceil(S / block_s).
extern "C" int decode_attention_launch(int is_bf16, const void* q,
                                       const void* k, const void* v,
                                       void* part, void* o, void* m, void* l,
                                       int b, int s, int hkv, int g, int d,
                                       int kv_len, int eff_len, int block_s,
                                       int nsplit, int dpl, float scale,
                                       const void* kv_dev, void* stream) {
  if (b == 0 || hkv == 0 || g == 0 || nsplit == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define DA_LAUNCH(DPL)                                                      \
  return launch<DPL>(is_bf16, (const float*)q, k, v, (float*)part,          \
                     (float*)o, (float*)m, (float*)l, b, s, hkv, g, d,      \
                     kv_len, eff_len, block_s, nsplit, scale,               \
                     (const int*)kv_dev, st)
  switch (dpl) {
    case 1: DA_LAUNCH(1);
    case 2: DA_LAUNCH(2);
    case 4: DA_LAUNCH(4);
    case 8: DA_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DA_LAUNCH
}
