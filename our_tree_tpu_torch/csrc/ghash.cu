// Segmented GHASH scan for Hopper (sm_90a):
//   y_j = H_{s_j} ((y_{j-1} keep_j) ^ x_j),   y_{-1} = y0,
// every row's y written, in GCM's field (ghash.cuh has the arithmetic).
//
// The GHASH half of the GCM dispatch seam (aead/gcm.py
// gcm_crypt_ghash_words): x is the ciphertext stream XOR each segment's
// injected AAD state, keep is 0 where a segment (or a J0 row) starts and the
// slots pick each row's key. This is not the port of a TPU kernel: the
// reference runs the recurrence as a sequential lax.scan of a 128 x 128 GF(2)
// bit-matrix product a row inside one XLA program
// (our_tree_tpu/aead/gcm.py:118-143, ghash_words at :94-104). The plain
// version is ghash_scan_plain (ops/cuda_ghash.py), a torch row loop of small
// operations.
//
// Bound. A row reads 16 bytes of x, 16 of inject, 4 of slot and 4 of keep and
// writes 16 of y, 56 bytes, against one field multiply of some 900 integer
// instructions: far on the operations' side. A row depends on the one
// before, so one 256 MiB seal (a single segment of 2^24 rows) must be
// parallel within the segment, and a serve rung (at most 4,096 rows) is
// bound by the dependent path of the scan plus three launches.
//
// Design: a scan over the rows' affine maps (ghash.cuh), in three launches.
//  1. ghash_map_kernel: each thread composes the maps of its chunk of
//     rows_per_thread consecutive rows (two multiplies by H a row, sharing
//     the column reads); the thread block scans its threads' maps (warp
//     shuffles, then the warps' maps), stores each thread's exclusive prefix
//     and the block's whole map.
//  2. ghash_carry_kernel: one thread block scans the blocks' maps and applies
//     them to y0: the state entering each block.
//  3. ghash_rows_kernel: each thread applies its prefix to its block's state
//     (the state entering its chunk) and runs its rows again from there,
//     writing every y (one multiply by H a row).
// rows_per_thread grows with N (1 up to 2^16 rows, at most 64), so a rung has
// one row a thread and 2^24 rows have 2^18 threads. Each thread block builds
// its keys' column tables in shared memory from H (2 KiB a key, 128 KiB at
// K = 64). Three multiplies a row against the sequential definition's one,
// and the compositions of the scans (about ten a thread): what the
// parallelism within a segment costs.
// Constant time: addresses depend on the row, the public slot and the
// column's index, never on H, x or y; there are no tables indexed by secret
// data (docs/ANALYSIS.md:88-103).

#include <cstdint>
#include <cuda_runtime.h>

#include "ghash.cuh"

namespace {

using ghash::Elem;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Threads the scan aims for before it gives a thread more than one row.
constexpr long long kTargetThreads = 1ll << 16;
constexpr long long kMaxRowsPerThread = 64;

struct Plan {
  long long rows;     // rows a thread
  long long blocks;   // thread blocks of launches 1 and 3
};

Plan plan(long long n) {
  long long rows = (n + kTargetThreads - 1) / kTargetThreads;
  rows = rows < 1 ? 1 : (rows > kMaxRowsPerThread ? kMaxRowsPerThread : rows);
  const long long threads = (n + rows - 1) / rows;
  return Plan{rows, (threads + kThreads - 1) / kThreads};
}

__device__ __forceinline__ Elem shfl_up(const Elem& e, int d) {
  Elem r;
  for (int c = 0; c < 4; ++c) r.w[c] = __shfl_up_sync(0xffffffffu, e.w[c], d);
  return r;
}

// The thread block's exclusive scan: (a, b) in, the composed map of the
// threads before this one out. warp_maps holds 2 kWarps elements.
__device__ __forceinline__ void block_scan(Elem& a, Elem& b, Elem* warp_maps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    Elem pa = shfl_up(a, d), pb = shfl_up(b, d);
    if (lane >= d) {
      ghash::compose(pa, pb, a, b);
      a = pa;
      b = pb;
    }
  }
  if (lane == 31) {
    warp_maps[2 * warp] = a;
    warp_maps[2 * warp + 1] = b;
  }
  Elem ea = shfl_up(a, 1), eb = shfl_up(b, 1);
  if (lane == 0) {
    ea = ghash::one();
    eb = ghash::zero();
  }
  __syncthreads();
  Elem wa = ghash::one(), wb = ghash::zero();
  for (int w = 0; w < warp; ++w) ghash::compose(wa, wb, warp_maps[2 * w], warp_maps[2 * w + 1]);
  ghash::compose(wa, wb, ea, eb);
  a = wa;
  b = wb;
}

template <int T>
__global__ void __launch_bounds__(T)
ghash_map_kernel(ghash::Rows in, const uint32_t* __restrict__ hkeys, long long rows, long long n,
                 Elem* __restrict__ prefix, Elem* __restrict__ block_maps) {
  extern __shared__ Elem col[];
  __shared__ Elem warp_maps[2 * kWarps];
  ghash::build_columns(hkeys, in.k, col, threadIdx.x, T);
  __syncthreads();
  const long long t = blockIdx.x * (long long)T + threadIdx.x;
  const long long r0 = t * rows < n ? t * rows : n;
  const long long r1 = r0 + rows < n ? r0 + rows : n;
  Elem a, b;
  ghash::chunk_map(in, col, r0, r1, a, b);
  Elem ea = a, eb = b;
  block_scan(ea, eb, warp_maps);
  prefix[2 * t] = ea;
  prefix[2 * t + 1] = eb;
  if (threadIdx.x == T - 1) {
    ghash::compose(ea, eb, a, b);
    block_maps[2 * blockIdx.x] = ea;
    block_maps[2 * blockIdx.x + 1] = eb;
  }
}

template <int T>
__global__ void __launch_bounds__(T)
ghash_carry_kernel(const Elem* __restrict__ block_maps, long long blocks,
                   const uint32_t* __restrict__ y0, Elem* __restrict__ carry) {
  __shared__ Elem warp_maps[2 * kWarps];
  const long long per = (blocks + T - 1) / T;
  const long long g0 = threadIdx.x * per < blocks ? threadIdx.x * per : blocks;
  const long long g1 = g0 + per < blocks ? g0 + per : blocks;
  Elem a = ghash::one(), b = ghash::zero();
  for (long long g = g0; g < g1; ++g) ghash::compose(a, b, block_maps[2 * g], block_maps[2 * g + 1]);
  block_scan(a, b, warp_maps);
  Elem y = ghash::apply(Elem{{y0[0], y0[1], y0[2], y0[3]}}, a, b);
  for (long long g = g0; g < g1; ++g) {
    carry[g] = y;
    y = ghash::apply(y, block_maps[2 * g], block_maps[2 * g + 1]);
  }
}

template <int T>
__global__ void __launch_bounds__(T)
ghash_rows_kernel(ghash::Rows in, const uint32_t* __restrict__ hkeys, long long rows, long long n,
                  const Elem* __restrict__ prefix, const Elem* __restrict__ carry,
                  uint32_t* __restrict__ ys) {
  extern __shared__ Elem col[];
  ghash::build_columns(hkeys, in.k, col, threadIdx.x, T);
  __syncthreads();
  const long long t = blockIdx.x * (long long)T + threadIdx.x;
  const long long r0 = t * rows;
  if (r0 >= n) return;
  const long long r1 = r0 + rows < n ? r0 + rows : n;
  const Elem y = ghash::apply(carry[blockIdx.x], prefix[2 * t], prefix[2 * t + 1]);
  ghash::chunk_run(in, col, r0, r1, y, ys);
}

long long scratch_elems(const Plan& p) { return 2 * p.blocks * kThreads + 3 * p.blocks; }

}  // namespace

// u32 words of scratch a scan of n rows needs (the wrapper allocates it).
extern "C" long long ot_ghash_scratch_words(long long n) {
  return n <= 0 ? 0 : 4 * scratch_elems(plan(n));
}

// The launch plan for n rows: out[0] rows a thread, out[1] thread blocks.
extern "C" void ot_ghash_plan(long long n, long long* out) {
  const Plan p = plan(n < 1 ? 1 : n);
  out[0] = p.rows;
  out[1] = p.blocks;
}

// C interface for ctypes. x, inject (or NULL), ys: (n, 4) u32 LE words,
// 16-byte aligned; slots, keep: (n,) int32; hkeys: (k, 4) u32 H words; y0:
// 4 u32 words; scratch: ot_ghash_scratch_words(n) u32 words, 16-byte aligned;
// all on the card, 1 <= k <= 64. Three launches on the stream; returns the
// first cudaError_t that is not 0, else 0.
extern "C" int ot_ghash_scan(const void* x, const void* inject, const void* slots,
                             const void* keep, const void* hkeys, const void* y0, void* ys,
                             void* scratch, long long n, int k, void* stream) {
  if (n <= 0 || k < 1 || k > ghash::kMaxSlots || x == nullptr || slots == nullptr ||
      keep == nullptr || hkeys == nullptr || y0 == nullptr || ys == nullptr ||
      scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(n);
  if (p.blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)k * ghash::kColumns * sizeof(Elem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute((const void*)ghash_map_kernel<kThreads>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute((const void*)ghash_rows_kernel<kThreads>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const ghash::Rows in{static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(inject),
                       static_cast<const int32_t*>(slots), static_cast<const int32_t*>(keep), k};
  const uint32_t* h = static_cast<const uint32_t*>(hkeys);
  Elem* prefix = static_cast<Elem*>(scratch);
  Elem* block_maps = prefix + 2 * p.blocks * kThreads;
  Elem* carry = block_maps + 2 * p.blocks;
  const unsigned int grid = (unsigned int)p.blocks;
  ghash_map_kernel<kThreads><<<grid, kThreads, smem, st>>>(in, h, p.rows, n, prefix, block_maps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ghash_carry_kernel<kThreads><<<1, kThreads, 0, st>>>(block_maps, p.blocks,
                                                       static_cast<const uint32_t*>(y0), carry);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ghash_rows_kernel<kThreads><<<grid, kThreads, smem, st>>>(in, h, p.rows, n, prefix, carry,
                                                            static_cast<uint32_t*>(ys));
  return (int)cudaGetLastError();
}
