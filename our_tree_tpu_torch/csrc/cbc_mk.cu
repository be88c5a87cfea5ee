// Multi-key scattered CBC decrypt for Hopper (sm_90a):
// out[j] = D_{rks_dec[slot[j]]}(c[j]) ^ prev[j], every block's XOR word given.
//
// The serve path's cbc batches. P_i = D(C_i) ^ C_(i-1) reads only ciphertext,
// so a batch of many requests under K keys is one data-parallel launch: the
// batcher lays out the PREV stream (each request's IV at its first block,
// then its own ciphertext shifted by one block) beside the ciphertext and
// the public slot vector. This is not the port of a TPU kernel: the
// reference's multi-key CBC decrypt is the bitsliced jnp circuit
// _multikey_cbc_bitslice (our_tree_tpu/models/aes.py:595-606) inside one XLA
// program, and MULTIKEY_CBC's T-table oracle. The plain version is
// cbc_scattered_multikey_plain (our_tree_tpu_torch/ops/cuda_aes.py), a torch
// composition of hundreds of small operations a call.
//
// Bound. Per block the function reads 16 bytes of ciphertext, 16 of PREV and
// 4 of slot and writes 16: 52 bytes against the inverse cipher's boolean
// circuit. A serve rung (at most 4,096 blocks) is bound by neither bytes nor
// operations but by the dependent path through one block's rounds plus the
// launch; chip_smoke.py records the roofline and latency bounds beside the
// time, at the rungs and at 256 MiB.
//
// Design: ctr_mk.cu's block form with the decrypt core (aes_block_inv.cuh),
// one block per thread, 128 threads a thread block.
//   * Each thread block turns the K decrypt schedules into plane-form round
//     keys in shared memory once, K * (NR+1) * 8 words (30 KB at K = 64,
//     NR = 14).
//   * Each thread reads its public slot, clamps it into [0, K) (below 0 to
//     0, from K up to K - 1: a bad slot vector can give wrong output for its
//     blocks but never a read outside the schedules; the wrapper refuses
//     such a vector on the CPU), and computes D(c) ^ prev under its slot's
//     key planes.
//   * Each thread issues its block's loads (slot, ciphertext, PREV) before
//     the prologue, so their round trip overlaps the prologue's.
//   * Where a rung's time goes (chip_smoke.py phase 9, the stamped
//     instantiation cbc_mk_stamped_kernel, on an H100): about 1.0 us of
//     launch floor, 0.37 us of prologue to the barrier, 2.5 us of rounds and
//     the store. With one warp on each SM sub-partition the rounds are bound
//     by its integer pipe, one LOP3 or SHF every 2 cycles, so the inverse
//     round moves its shifts and disjoint ORs to IMADs on the FMA pipe
//     (aes_block_inv.cuh). Phase 9 times the design variants it was chosen
//     over (VARIANTS_SOURCE): its former round, the loads after the barrier,
//     the rounds unrolled with the next round's key planes loaded ahead
//     (the straight-line code misses the instruction cache), and 32 or 64
//     threads a thread block (a longer prologue).
//   * One form only: the serve rungs are at most 4,096 blocks, which
//     ctr_mk serves with its block form (kBlockFormMax = 2^18 there). Where
//     a group form (32 blocks a thread, aes_inv_bitslice.cuh's rounds)
//     would pay, at 256 MiB, is read from chip_smoke.py phase 9 (PERF.md).
// Constant time: load addresses depend on the block index, the round and
// the public slot, never on key or data; there are no tables.

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_block_inv.cuh"

namespace {

constexpr int kThreads = 128;
// The most schedules one launch takes (the wrapper's cap).
constexpr int kMaxSlots = 64;
// int64 words a warp's row of stamps holds (cbc_mk_stamped_kernel).
constexpr int kStampWords = 8;

// The stamped instantiation's clocks. Each read is a volatile asm with a
// memory clobber, so it keeps its place among the loads and stores; a read
// that follows a volatile store of a value cannot issue before that value
// is in its register.
__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : : "memory");
  return t;
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : : "memory");
  return t;
}

__device__ __forceinline__ long long clock_after(uint32_t dep, long long* sink) {
  long long t;
  asm volatile("st.volatile.global.u32 [%1], %2;\n\tmov.u64 %0, %%clock64;"
               : "=l"(t) : "l"(sink), "r"(dep) : "memory");
  return t;
}

// One thread's block: D_{rks_dec[slot[j]]}(in[j]) ^ prev[j]. With STAMP (the
// instrumented instantiation only; the production kernel never sets it),
// lane 0 of each warp that holds a block writes its warp's row of stamps:
// SM cycles at entry, after the key-plane prologue's barrier, once the
// block's loads have arrived, after the last round and once the store is
// visible (a fence), then the global timer in ns at entry and at the end,
// then the SM's id.
template <int NR, bool STAMP>
__device__ __forceinline__ void cbc_mk_body(const uint4* __restrict__ in, uint4* __restrict__ out,
                                            const uint4* __restrict__ prev,
                                            const int32_t* __restrict__ slots,
                                            const uint32_t* __restrict__ rks_dec,
                                            long long n_blocks, int k, long long* stamps) {
  constexpr int kRounds = NR + 1;
  // K decrypt schedules' key planes, slot j's round r at kp + 8 (j kRounds + r).
  extern __shared__ uint32_t kp[];
  long long t[5] = {0, 0, 0, 0, 0}, g0 = 0;
  long long* row = nullptr;
  if constexpr (STAMP) {
    row = stamps + kStampWords * ((blockIdx.x * (long long)kThreads + threadIdx.x) / 32);
    t[0] = clock_now();
    g0 = global_ns();
  }
  // The block's loads go out first, so their round trip overlaps the
  // prologue's; their registers are free until the rounds start.
  const long long j = blockIdx.x * (long long)kThreads + threadIdx.x;
  const bool live = j < n_blocks;
  int raw = 0;
  uint4 c = make_uint4(0u, 0u, 0u, 0u), p = c;
  if (live) {
    raw = slots[j];
    c = in[j];
    p = prev[j];
  }
  for (int i = threadIdx.x; i < k * kRounds; i += kThreads)
    aes_block::round_key_planes(rks_dec + (i / kRounds) * 4 * kRounds, i % kRounds, kp + 8 * i);
  __syncthreads();
  if constexpr (STAMP) t[1] = clock_now();
  if (!live) return;
  const int sl = min(max(raw, 0), k - 1);
  if constexpr (STAMP)
    t[2] = clock_after(c.x ^ c.y ^ c.z ^ c.w ^ p.x ^ p.y ^ p.z ^ p.w ^ (uint32_t)sl, row + 7);
  uint32_t s[8];
  aes_block::pack(c, s);
  aes_block::decrypt_block<NR>(s, kp + 8 * kRounds * sl);
  if constexpr (STAMP)
    t[3] = clock_after(s[0] ^ s[1] ^ s[2] ^ s[3] ^ s[4] ^ s[5] ^ s[6] ^ s[7], row + 7);
  const uint4 d = aes_block::unpack(s);
  out[j] = make_uint4(d.x ^ p.x, d.y ^ p.y, d.z ^ p.z, d.w ^ p.w);
  if constexpr (STAMP) {
    __threadfence();
    t[4] = clock_now();
    const long long g1 = global_ns();
    if ((threadIdx.x & 31) == 0) {
      unsigned int sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      for (int i = 0; i < 5; ++i) row[i] = t[i];
      row[5] = g0;
      row[6] = g1;
      row[7] = sm;
    }
  }
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
cbc_mk_block_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                    const uint4* __restrict__ prev, const int32_t* __restrict__ slots,
                    const uint32_t* __restrict__ rks_dec, long long n_blocks, int k) {
  cbc_mk_body<NR, false>(in, out, prev, slots, rks_dec, n_blocks, k, nullptr);
}

// The instrumented instantiation (chip_smoke.py phase 9's breakdown).
template <int NR>
__global__ void __launch_bounds__(kThreads)
cbc_mk_stamped_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                      const uint4* __restrict__ prev, const int32_t* __restrict__ slots,
                      const uint32_t* __restrict__ rks_dec, long long n_blocks, int k,
                      long long* stamps) {
  cbc_mk_body<NR, true>(in, out, prev, slots, rks_dec, n_blocks, k, stamps);
}

template <int NR>
cudaError_t launch(const void* in, void* out, const void* prev, const void* slots,
                   const void* rks_dec, long long n_blocks, int k, long long* stamps,
                   cudaStream_t stream) {
  const unsigned int grid = (unsigned int)((n_blocks + kThreads - 1) / kThreads);
  const size_t smem = (size_t)k * 8 * (NR + 1) * sizeof(uint32_t);
  const uint4* src = static_cast<const uint4*>(in);
  const uint4* prv = static_cast<const uint4*>(prev);
  const int32_t* sl = static_cast<const int32_t*>(slots);
  const uint32_t* rk = static_cast<const uint32_t*>(rks_dec);
  if constexpr (NR == 10) {
    if (stamps != nullptr) {
      cbc_mk_stamped_kernel<NR><<<grid, kThreads, smem, stream>>>(
          src, static_cast<uint4*>(out), prv, sl, rk, n_blocks, k, stamps);
      return cudaGetLastError();
    }
  }
  cbc_mk_block_kernel<NR><<<grid, kThreads, smem, stream>>>(
      src, static_cast<uint4*>(out), prv, sl, rk, n_blocks, k);
  return cudaGetLastError();
}

bool bad_args(long long n_blocks, int k, const void* slots) {
  return n_blocks <= 0 || k < 1 || k > kMaxSlots || slots == nullptr ||
         n_blocks > (long long)kThreads * 0x7FFFFFFFll;
}

}  // namespace

// C interface for ctypes. in/out/prev: (n_blocks, 4) u32 LE words, 16-byte
// aligned; slots: (n_blocks,) int32 schedule index per block; rks_dec: (k,
// 4*(nr+1)) u32 InvMixColumns-folded decrypt schedules, all on the card;
// 1 <= k <= 64. Returns the cudaError_t of the launch (0 on success).
extern "C" int ot_cbc_mk(const void* in, void* out, const void* prev, const void* slots,
                         const void* rks_dec, long long n_blocks, int k, int nr, void* stream) {
  if (bad_args(n_blocks, k, slots)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nr) {
    case 10: return (int)launch<10>(in, out, prev, slots, rks_dec, n_blocks, k, nullptr, st);
    case 12: return (int)launch<12>(in, out, prev, slots, rks_dec, n_blocks, k, nullptr, st);
    case 14: return (int)launch<14>(in, out, prev, slots, rks_dec, n_blocks, k, nullptr, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same launch through the instrumented instantiation, nr 10 only (the
// serve rungs' measurement): stamps, (ceil(n_blocks / 32), 8) int64 on the
// card, zeroed by the caller, gets one row a warp (cbc_mk_body). Not a path
// of the port: chip_smoke.py phase 9 reads where a launch's time goes.
extern "C" int ot_cbc_mk_stamped(const void* in, void* out, const void* prev, const void* slots,
                                 const void* rks_dec, long long n_blocks, int k, int nr,
                                 void* stamps, void* stream) {
  if (bad_args(n_blocks, k, slots) || nr != 10 || stamps == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch<10>(in, out, prev, slots, rks_dec, n_blocks, k,
                         static_cast<long long*>(stamps), static_cast<cudaStream_t>(stream));
}
