// Standalone padded-row ELL SpMV kernel for sm_90a.
//
// Replaces the Pallas kernel of repro/kernels/ell_spmv.py (ell_spmv,
// body _ell_spmv_kernel): y[r] = sum_s vals[r, s] * x[cols[r, s]] over the
// (R, W) slots of an ELL operator, with x at least R long (the
// distributed path passes [own | halo]).
//
// Bound: device-memory bytes.  Each row reads W (column, value) pairs
// (12 bytes a slot in fp64) and gathers W entries of x; the arithmetic is
// 2 W flops a row.  x (4 MB at 500 000 rows) stays in the 50 MB L2, so the
// stream that sets the time is cols and vals.
//
// The (R, W) layout is row-major, so one thread per row reading its slots
// straight from device memory makes a warp's load of one slot touch 32
// sectors W elements apart and use 4 or 8 bytes of each: the rest is used
// only if it survives in L1 until the row's next slot.  This kernel stages
// instead.  A block owns tiles of R_B rows (R_B = blockDim.x, one thread a
// row) walked with a grid stride over a persistent grid.  A tile's
// R_B * W values and R_B * W column indices are each one contiguous span,
// so one thread copies them into shared memory with two 1-D bulk copies
// (cp.async.bulk, the TMA's 1-D form) that complete on an mbarrier, into
// a ring of `stages` buffers: the next tiles are in flight while the
// threads sum the one that has arrived.  Each thread then sums its row from
// shared memory (slot stride W: an odd W is free of bank conflicts in both
// 4- and 8-byte words; an even W costs up to gcd(W, 32)-way conflicts) and
// gathers x through the read-only path, CHUNK gathers issued together.
//
// A bulk copy needs 16-byte-aligned addresses and a size that is a multiple
// of 16 bytes.  R_B is a multiple of 32, so every full tile qualifies when
// both base pointers are 16-byte aligned; the wrapper's launch plan
// (kernels/ell_spmv.py `plan`) passes the number of tiles that go by bulk
// copy (all full tiles, or none for a misaligned base).  The ragged last
// tile and the tiles of a misaligned operator are loaded into the same
// shared buffer by coalesced ordinary loads.  An operator too wide to
// stage 32 rows twice in shared memory runs the direct kernel: one thread
// a row, straight from device memory.
//
// Order of summation: the explicit left-to-right chain of ell_rowsum
// (kernels/ref.py), not the Pallas kernel's .sum(axis=1).  With
// --fmad=false the result is bitwise equal to the plain version and to
// SparseOp's plain apply.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int DIRECT_BLOCK = 256;
constexpr int MAX_TILE_ROWS = 256;
constexpr int MAX_STAGES = 4;
constexpr int CHUNK = 8;   // x gathers of a row issued before their sums

// ell_rowsum's chain: acc = v_0 x_0, then acc = acc + v_s x_s in slot
// order.  The first term is taken as it is (0 + p would turn -0.0 to +0.0).
template <typename T>
__device__ __forceinline__ T row_sum(const T* v, const int* c, int w,
                                     const T* __restrict__ x) {
  T acc = T(0);
  for (int s0 = 0; s0 < w; s0 += CHUNK) {
    T g[CHUNK];
#pragma unroll
    for (int u = 0; u < CHUNK; ++u)
      g[u] = (s0 + u < w) ? __ldg(x + c[s0 + u]) : T(0);
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      if (s0 + u < w) {
        const T p = v[s0 + u] * g[u];
        acc = (s0 + u == 0) ? p : acc + p;
      }
    }
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(DIRECT_BLOCK)
    ell_spmv_direct(const T* __restrict__ x, const int* __restrict__ cols,
                    const T* __restrict__ vals, T* __restrict__ y,
                    long long rows, int w) {
  const long long r = (long long)blockIdx.x * DIRECT_BLOCK + threadIdx.x;
  if (r >= rows) return;
  y[r] = row_sum(vals + r * w, cols + r * w, w, x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <typename T>
__global__ void __launch_bounds__(MAX_TILE_ROWS)
    ell_spmv_staged(const T* __restrict__ x, const int* __restrict__ cols,
                    const T* __restrict__ vals, T* __restrict__ y,
                    long long rows, int w, int stages, long long bulk_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[MAX_STAGES];
  const int rb = blockDim.x, tid = threadIdx.x;
  const int tile = rb * w;  // elements of one tile in each array
  // Ring layout: `stages` value tiles, then `stages` column tiles; every
  // tile starts 16-byte aligned since rb is a multiple of 32.
  T* sv = (T*)smem;
  int* sc = (int*)(smem + (size_t)stages * tile * sizeof(T));
  const long long tiles = (rows + rb - 1) / rb;
  const uint32_t vbytes = (uint32_t)tile * sizeof(T);
  const uint32_t cbytes = (uint32_t)tile * 4u;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](long long t, int s) {
    mbar_expect_tx(&bars[s], vbytes + cbytes);
    bulk_copy(sv + (size_t)s * tile, vals + t * tile, vbytes, &bars[s]);
    bulk_copy(sc + (size_t)s * tile, cols + t * tile, cbytes, &bars[s]);
  };
  // Prologue: the block's first `stages` tiles go in flight at once.
  if (tid == 0)
    for (int i = 0; i < stages; ++i) {
      const long long t = blockIdx.x + (long long)i * gridDim.x;
      if (t < bulk_tiles) issue(t, i);
    }

  // Bulk tiles are a prefix of the tile order, so a stage's barrier
  // completes one phase per bulk tile that used it: one parity bit each.
  uint32_t parity = 0;
  int s = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    T* tv = sv + (size_t)s * tile;
    int* tc = sc + (size_t)s * tile;
    const long long r0 = t * rb;
    const int nr = (int)(rows - r0 < rb ? rows - r0 : rb);
    if (t < bulk_tiles) {
      mbar_wait(&bars[s], (parity >> s) & 1u);
      parity ^= 1u << s;
    } else {
      // The ragged last tile, or any tile of a misaligned operator:
      // coalesced ordinary loads into the same buffer.  No bulk copy is
      // pending on this stage (bulk tiles come first).
      const long long e0 = r0 * w;
      const int ne = nr * w;
#pragma unroll 4
      for (int e = tid; e < ne; e += rb) {
        tv[e] = vals[e0 + e];
        tc[e] = cols[e0 + e];
      }
      __syncthreads();
    }
    if (tid < nr) y[r0 + tid] = row_sum(tv + tid * w, tc + tid * w, w, x);
    __syncthreads();  // every thread is done with this stage
    const long long tn = t + (long long)stages * gridDim.x;
    if (tid == 0 && tn < bulk_tiles) {
      // Order the generic-proxy reads of the buffer before the async
      // proxy's writes into it.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(tn, s);
    }
    s = (s + 1 == stages) ? 0 : s + 1;
  }
}

// Opt in to the dynamic shared memory a launch asks for.  The default
// limit is 48 KB including the static barriers, so every size is set, once
// per device (the attribute is a device's own).
constexpr int MAX_DEVICES = 64;

template <typename T>
cudaError_t allow_smem(int bytes) {
  static int allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && bytes <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(ell_spmv_staged<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = bytes;
  return e;
}

template <typename T>
int occupancy(int threads, int smem_bytes, int* blocks) {
  cudaError_t e = allow_smem<T>(smem_bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ell_spmv_staged<T>, threads, smem_bytes);
}

template <typename T>
int launch(int staged, const void* x, const void* cols, const void* vals,
           void* y, long long rows, int w, int tile_rows, int stages,
           long long bulk_tiles, int grid, int smem_bytes, cudaStream_t st) {
  if (!staged) {
    const long long nb = (rows + DIRECT_BLOCK - 1) / DIRECT_BLOCK;
    ell_spmv_direct<T><<<(unsigned)nb, DIRECT_BLOCK, 0, st>>>(
        (const T*)x, (const int*)cols, (const T*)vals, (T*)y, rows, w);
    return (int)cudaGetLastError();
  }
  if (tile_rows < 32 || tile_rows > MAX_TILE_ROWS || tile_rows % 32 ||
      stages < 1 || stages > MAX_STAGES || grid < 1 ||
      (long long)stages * tile_rows * w * (long long)(sizeof(T) + 4) >
          smem_bytes)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem<T>(smem_bytes);
  if (e != cudaSuccess) return (int)e;
  ell_spmv_staged<T><<<grid, tile_rows, smem_bytes, st>>>(
      (const T*)x, (const int*)cols, (const T*)vals, (T*)y, rows, w, stages,
      bulk_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the staged kernel one SM holds at this block size and shared
// memory: the wrapper sizes its persistent grid with it.
extern "C" int ell_spmv_occupancy(int is_f32, int threads, int smem_bytes,
                                  int* blocks) {
  return is_f32 ? occupancy<float>(threads, smem_bytes, blocks)
                : occupancy<double>(threads, smem_bytes, blocks);
}

extern "C" int ell_spmv_launch(int is_f32, int staged, const void* x,
                               const void* cols, const void* vals, void* y,
                               long long rows, int w, int tile_rows,
                               int stages, long long bulk_tiles, int grid,
                               int smem_bytes, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return is_f32 ? launch<float>(staged, x, cols, vals, y, rows, w, tile_rows,
                                stages, bulk_tiles, grid, smem_bytes, st)
                : launch<double>(staged, x, cols, vals, y, rows, w, tile_rows,
                                 stages, bulk_tiles, grid, smem_bytes, st);
}
