// Segmented GHASH for Hopper (sm_90a):
//   y_j = H_{s_j} ((y_{j-1} keep_j) ^ x_j),   y_{-1} = y0,
// in GCM's field (ghash.cuh has the arithmetic), in two forms:
//  * ghash_at (ot_ghash_at): y at the named rows only, two launches; the
//    form gcm_seal, gcm_open and ghash_words take (each reads one row);
//  * ghash_scan (ot_ghash_scan): every row's y, three launches; the seam's
//    every-row contract.
//
// The GHASH half of the GCM dispatch seam (aead/gcm.py
// gcm_crypt_ghash_words): x is the ciphertext stream XOR each segment's
// injected AAD state, keep is 0 where a segment (or a J0 row) starts and the
// slots pick each row's key. This is not the port of a TPU kernel: the
// reference runs the recurrence as a sequential lax.scan of a 128 x 128 GF(2)
// bit-matrix product a row inside one XLA program
// (our_tree_tpu/aead/gcm.py:118-143, ghash_words at :94-104). The plain
// version is ghash_scan_plain (ops/cuda_ghash.py), a torch row loop of small
// operations, and ghash_at_plain its rows at the named rows.
//
// Bound. A row reads 16 bytes of x, 16 of inject, 4 of slot and 4 of keep
// (and the every-row form writes 16 of y), 40 or 56 bytes, against one
// 128 x 128 GF(2) product (2 x 16,384 bit operations as a matrix product; a
// few hundred instructions as ghash.cuh writes it): on the operations'
// side. A row depends on the one before, so one 256 MiB seal (a single
// segment of 2^24 rows) must be parallel within the segment, and a serve
// rung (at most 4,096 rows) is bound by the scan's dependent path and its
// launches.
//
// Design: a scan over the rows' affine maps (ghash.cuh).
//  1. ghash_map_kernel: each thread block prepares its keys' H and a table
//     of their powers H^1..H^rows in shared memory; each thread runs its
//     chunk of rows_per_thread consecutive rows by Horner (one product by H
//     a row), its a read from the table; the thread block scans its
//     threads' maps (warp shuffles, then the warps' maps) and stores the
//     block's whole map. The every-row form stores each thread's exclusive
//     prefix; ghash_at stores, for each named row in the chunk, the map of
//     the block's rows up to it.
//  2. ghash_carry_kernel: one thread block scans the blocks' maps and
//     applies them to y0: the state entering each block. ghash_at then
//     applies each named row's map to its block's state and stores its y:
//     ghash_at is done.
//  3. ghash_rows_kernel (every row): each thread applies its prefix to its
//     block's state and runs its rows again from there, writing every y
//     (one product a row).
// rows_per_thread grows with N (1 up to 2^16 rows, at most 256, and at most
// kTableElems / K so the table fits), so a rung has one row a thread and
// 2^24 rows have 2^16 threads, one wave on the card.
// Constant time: addresses depend on the row, the public slot, the power's
// public index and the named rows (public), never on H, x or y; there are
// no tables indexed by secret data (docs/ANALYSIS.md:88-103).

#include <cstdint>
#include <cuda_runtime.h>

#include "ghash.cuh"

namespace {

using ghash::Elem;
using ghash::Prep;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Threads the scan aims for before it gives a thread more than one row.
constexpr long long kTargetThreads = 1ll << 16;
constexpr long long kMaxRowsPerThread = 256;
// The most powers a thread block's table holds (K x rows_per_thread).
constexpr long long kTableElems = 4096;
// Thread blocks of the map launch resident on an SM (its register cap):
// 2^24 rows are 513 thread blocks, one wave at four an SM.
constexpr int kMapBlocksPerSm = 4;
// Rows a thread of the rows launch stages in shared memory before its warp
// writes them out (128 bytes, one line).
constexpr int kStage = 8;

struct Plan {
  long long rows;     // rows a thread
  long long blocks;   // thread blocks of launches 1 and 3
};

Plan plan(long long n, int k) {
  long long cap = kTableElems / k;
  cap = cap < 1 ? 1 : (cap > kMaxRowsPerThread ? kMaxRowsPerThread : cap);
  long long rows = (n + kTargetThreads - 1) / kTargetThreads;
  rows = rows < 1 ? 1 : (rows > cap ? cap : rows);
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

// Shared memory of a launch: k prepared keys, and the table of k x rows
// powers where one is kept.
size_t keys_smem(int k, long long rows, bool table) {
  return (size_t)k * sizeof(Prep) + (table ? (size_t)k * rows * sizeof(Elem) : 0);
}

// The rows launch's: its keys, and its stage where a thread has kStage rows
// or more.
size_t rows_smem(int k, long long rows) {
  return keys_smem(k, rows, false) + (rows < kStage ? 0 : (size_t)kThreads * (kStage + 1) * 16);
}

// Launch 1. NAMED (ghash_at): named[0..n_named) are the sorted named rows;
// each thread stores, for each in its chunk, the map of its block's rows up
// to it in named_maps and the block in named_blk. Otherwise each thread
// stores its exclusive prefix within the block.
template <int T, int NAMED>
__global__ void __launch_bounds__(T, kMapBlocksPerSm)
ghash_map_kernel(ghash::Rows in, const uint32_t* __restrict__ hkeys, long long rows, long long n,
                 const long long* __restrict__ named, long long n_named,
                 Elem* __restrict__ named_maps, int* __restrict__ named_blk,
                 Elem* __restrict__ prefix, Elem* __restrict__ block_maps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Elem warp_maps[2 * kWarps];
  Prep* h = reinterpret_cast<Prep*>(smem);
  Elem* pw = reinterpret_cast<Elem*>(smem + (size_t)in.k * sizeof(Prep));
  ghash::build_keys(hkeys, in.k, (int)rows, h, pw, threadIdx.x, T);
  const ghash::Keys keys{h, pw, (int)rows};
  const long long t = blockIdx.x * (long long)T + threadIdx.x;
  const long long r0 = t * rows < n ? t * rows : n;
  const long long r1 = r0 + rows < n ? r0 + rows : n;
  long long e0 = 0, e1 = 0;
  if (NAMED) {
    e0 = ghash::lower_bound(named, n_named, r0);
    e1 = e0 + ghash::lower_bound(named + e0, n_named - e0, r1);
  }
  Elem a, b;
  ghash::chunk_map(in, keys, r0, r1, named, e0, e1, named_maps, named_blk, a, b);
  Elem ea = a, eb = b;
  block_scan(ea, eb, warp_maps);
  if (NAMED) {
    for (long long e = e0; e < e1; ++e) {
      Elem pa = ea, pb = eb;
      ghash::compose(pa, pb, named_maps[2 * e], named_maps[2 * e + 1]);
      named_maps[2 * e] = pa;
      named_maps[2 * e + 1] = pb;
      named_blk[e] = (int)blockIdx.x;
    }
  } else {
    prefix[2 * t] = ea;
    prefix[2 * t + 1] = eb;
  }
  if (threadIdx.x == T - 1) {
    ghash::compose(ea, eb, a, b);
    block_maps[2 * blockIdx.x] = ea;
    block_maps[2 * blockIdx.x + 1] = eb;
  }
}

// Launch 2, one thread block: the state entering each block, carry[g];
// then, for ghash_at, each named row's y from its block's state (word-bit
// basis, out[e]).
template <int T>
__global__ void __launch_bounds__(T)
ghash_carry_kernel(const Elem* __restrict__ block_maps, long long blocks,
                   const uint32_t* __restrict__ y0, Elem* __restrict__ carry,
                   const Elem* __restrict__ named_maps, const int* __restrict__ named_blk,
                   long long n_named, uint32_t* __restrict__ out) {
  __shared__ Elem warp_maps[2 * kWarps];
  const long long per = (blocks + T - 1) / T;
  const long long g0 = threadIdx.x * per < blocks ? threadIdx.x * per : blocks;
  const long long g1 = g0 + per < blocks ? g0 + per : blocks;
  Elem a = ghash::one(), b = ghash::zero();
  for (long long g = g0; g < g1; ++g) ghash::compose(a, b, block_maps[2 * g], block_maps[2 * g + 1]);
  block_scan(a, b, warp_maps);
  Elem y = ghash::apply(ghash::flip(Elem{{y0[0], y0[1], y0[2], y0[3]}}), a, b);
  for (long long g = g0; g < g1; ++g) {
    carry[g] = y;
    y = ghash::apply(y, block_maps[2 * g], block_maps[2 * g + 1]);
  }
  if (n_named == 0) return;
  __syncthreads();
  for (long long e = threadIdx.x; e < n_named; e += T)
    ghash::store_row(out, e, ghash::flip(ghash::apply(carry[named_blk[e]], named_maps[2 * e],
                                                      named_maps[2 * e + 1])));
}

// Launch 3 of the every-row form. A thread's rows lie rows_per_thread rows
// from its neighbours', so a store of one row a thread would write 32
// separate 16-byte pieces a warp instruction; with at least kStage rows a
// thread, each thread puts kStage rows' y in shared memory and the warp
// writes them out as whole 128-byte lines, four threads' rows an
// instruction.
template <int T>
__global__ void __launch_bounds__(T)
ghash_rows_kernel(ghash::Rows in, const uint32_t* __restrict__ hkeys, long long rows, long long n,
                  const Elem* __restrict__ prefix, const Elem* __restrict__ carry,
                  uint32_t* __restrict__ ys) {
  extern __shared__ __align__(16) unsigned char smem[];
  Prep* h = reinterpret_cast<Prep*>(smem);
  ghash::build_keys(hkeys, in.k, (int)rows, h, nullptr, threadIdx.x, T);
  const long long t = blockIdx.x * (long long)T + threadIdx.x;
  const long long r0 = t * rows < n ? t * rows : n;
  const long long r1 = r0 + rows < n ? r0 + rows : n;
  if (rows < kStage) {
    if (r0 < r1)
      ghash::chunk_run(in, h, r0, r1, ghash::apply(carry[blockIdx.x], prefix[2 * t],
                                                   prefix[2 * t + 1]), ys);
    return;
  }
  uint4* stage = reinterpret_cast<uint4*>(smem + (size_t)in.k * sizeof(Prep));
  const int lane = threadIdx.x & 31, warp0 = threadIdx.x - lane;
  Elem y = r0 < r1 ? ghash::apply(carry[blockIdx.x], prefix[2 * t], prefix[2 * t + 1])
                   : ghash::zero();
  ghash::RawRow ahead = r0 < r1 ? ghash::load_raw(in, r0) : ghash::RawRow{};
  for (long long g = 0; g < rows; g += kStage) {
#pragma unroll 1
    for (int i = 0; i < kStage; ++i) {
      const long long r = r0 + g + i;
      if (r >= r1) break;
      const ghash::RawRow cur = ahead;
      if (r + 1 < r1) ahead = ghash::load_raw(in, r + 1);
      const uint32_t km = 0u - ((uint32_t)cur.keep & 1u);
      y = ghash::mul(ghash::exor(ghash::masked(y, km), ghash::raw_x(cur)),
                     h[ghash::clamp_slot(cur.slot, in.k)]);
      const Elem f = ghash::flip(y);
      stage[threadIdx.x * (kStage + 1) + i] = make_uint4(f.w[0], f.w[1], f.w[2], f.w[3]);
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 32; q += 32 / kStage) {
      const int src = warp0 + q + lane / kStage;
      const long long ts = blockIdx.x * (long long)T + src;
      const long long r = ts * rows + g + lane % kStage, end = ts * rows + rows;
      if (r < n && r < end)
        reinterpret_cast<uint4*>(ys)[r] = stage[src * (kStage + 1) + lane % kStage];
    }
    __syncwarp();
  }
}

// Scratch in elements: the every-row form's prefixes, the blocks' maps and
// carries; ghash_at's named maps and their blocks (one int each).
long long scratch_elems(const Plan& p, bool named, long long n_named) {
  return (named ? 2 * n_named + (n_named + 3) / 4 : 2 * p.blocks * kThreads) + 3 * p.blocks;
}

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_args(long long n, int k, const void* x, const void* slots, const void* keep,
              const void* hkeys, const void* y0, const void* out, const void* scratch) {
  return n <= 0 || k < 1 || k > ghash::kMaxSlots || x == nullptr || slots == nullptr ||
         keep == nullptr || hkeys == nullptr || y0 == nullptr || out == nullptr ||
         scratch == nullptr;
}

}  // namespace

// u32 words of scratch a launch over n rows and k keys needs (the wrapper
// allocates it): the every-row form (n_named < 0) or ghash_at with n_named
// named rows.
extern "C" long long ot_ghash_scratch_words(long long n, int k, long long n_named) {
  if (n <= 0 || k < 1) return 0;
  return 4 * scratch_elems(plan(n, k), n_named >= 0, n_named);
}

// The launch plan for n rows and k keys: out[0] rows a thread, out[1] thread
// blocks of launches 1 and 3.
extern "C" void ot_ghash_plan(long long n, int k, long long* out) {
  const Plan p = plan(n < 1 ? 1 : n, k < 1 ? 1 : k);
  out[0] = p.rows;
  out[1] = p.blocks;
}

// C interface for ctypes. x, inject (or NULL), ys: (n, 4) u32 LE words,
// 16-byte aligned; slots, keep: (n,) int32; hkeys: (k, 4) u32 H words; y0:
// 4 u32 words; scratch: ot_ghash_scratch_words(n, k, -1) u32 words, 16-byte
// aligned; all on the card, 1 <= k <= 64. Every row's y into ys: three
// launches on the stream; returns the first cudaError_t that is not 0, else 0.
extern "C" int ot_ghash_scan(const void* x, const void* inject, const void* slots,
                             const void* keep, const void* hkeys, const void* y0, void* ys,
                             void* scratch, long long n, int k, void* stream) {
  if (bad_args(n, k, x, slots, keep, hkeys, y0, ys, scratch)) return (int)cudaErrorInvalidValue;
  const Plan p = plan(n, k);
  if (p.blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t map_smem = keys_smem(k, p.rows, true), row_smem = rows_smem(k, p.rows);
  cudaError_t e = allow_smem((const void*)ghash_map_kernel<kThreads, 0>, map_smem);
  if (e == cudaSuccess) e = allow_smem((const void*)ghash_rows_kernel<kThreads>, row_smem);
  if (e != cudaSuccess) return (int)e;
  const ghash::Rows in{static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(inject),
                       static_cast<const int32_t*>(slots), static_cast<const int32_t*>(keep), k};
  const uint32_t* h = static_cast<const uint32_t*>(hkeys);
  Elem* prefix = static_cast<Elem*>(scratch);
  Elem* block_maps = prefix + 2 * p.blocks * kThreads;
  Elem* carry = block_maps + 2 * p.blocks;
  const unsigned int grid = (unsigned int)p.blocks;
  ghash_map_kernel<kThreads, 0><<<grid, kThreads, map_smem, st>>>(
      in, h, p.rows, n, nullptr, 0, nullptr, nullptr, prefix, block_maps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ghash_carry_kernel<kThreads><<<1, kThreads, 0, st>>>(
      block_maps, p.blocks, static_cast<const uint32_t*>(y0), carry, nullptr, nullptr, 0, nullptr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ghash_rows_kernel<kThreads><<<grid, kThreads, row_smem, st>>>(in, h, p.rows, n, prefix, carry,
                                                               static_cast<uint32_t*>(ys));
  return (int)cudaGetLastError();
}

// y at the named rows only: rows_out, (n_named,) int64 on the card, sorted,
// each in [0, n); out: (n_named, 4) u32 words, 16-byte aligned; scratch:
// ot_ghash_scratch_words(n, k, n_named) words; the rest as ot_ghash_scan. A
// vector that is not sorted or not in range gives wrong rows for its
// entries, never an access outside the arrays (the wrapper refuses one on
// the CPU). Two launches; n_named >= 1.
extern "C" int ot_ghash_at(const void* x, const void* inject, const void* slots, const void* keep,
                           const void* hkeys, const void* y0, const void* rows_out, void* out,
                           void* scratch, long long n, long long n_named, int k, void* stream) {
  if (bad_args(n, k, x, slots, keep, hkeys, y0, out, scratch) || rows_out == nullptr ||
      n_named < 1)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(n, k);
  if (p.blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t map_smem = keys_smem(k, p.rows, true);
  cudaError_t e = allow_smem((const void*)ghash_map_kernel<kThreads, 1>, map_smem);
  if (e != cudaSuccess) return (int)e;
  const ghash::Rows in{static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(inject),
                       static_cast<const int32_t*>(slots), static_cast<const int32_t*>(keep), k};
  Elem* named_maps = static_cast<Elem*>(scratch);
  int* named_blk = reinterpret_cast<int*>(named_maps + 2 * n_named);
  Elem* block_maps = named_maps + 2 * n_named + (n_named + 3) / 4;
  Elem* carry = block_maps + 2 * p.blocks;
  const long long* named = static_cast<const long long*>(rows_out);
  ghash_map_kernel<kThreads, 1><<<(unsigned int)p.blocks, kThreads, map_smem, st>>>(
      in, static_cast<const uint32_t*>(hkeys), p.rows, n, named, n_named, named_maps, named_blk,
      nullptr, block_maps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ghash_carry_kernel<kThreads><<<1, kThreads, 0, st>>>(
      block_maps, p.blocks, static_cast<const uint32_t*>(y0), carry, named_maps, named_blk,
      n_named, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
