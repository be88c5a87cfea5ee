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
//   * One form only: the serve rungs are at most 4,096 blocks, which
//     ctr_mk serves with its block form (kBlockFormMax = 2^16 there). Where
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

template <int NR>
__global__ void __launch_bounds__(kThreads)
cbc_mk_block_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                    const uint4* __restrict__ prev, const int32_t* __restrict__ slots,
                    const uint32_t* __restrict__ rks_dec, long long n_blocks, int k) {
  constexpr int kRounds = NR + 1;
  // K decrypt schedules' key planes, slot j's round r at kp + 8 (j kRounds + r).
  extern __shared__ uint32_t kp[];
  for (int i = threadIdx.x; i < k * kRounds; i += kThreads)
    aes_block::round_key_planes(rks_dec + (i / kRounds) * 4 * kRounds, i % kRounds, kp + 8 * i);
  __syncthreads();

  const long long j = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (j >= n_blocks) return;
  const int sl = min(max(slots[j], 0), k - 1);
  out[j] = aes_block::cbc_dec_block<NR>(in[j], prev[j], kp + 8 * kRounds * sl);
}

template <int NR>
cudaError_t launch(const void* in, void* out, const void* prev, const void* slots,
                   const void* rks_dec, long long n_blocks, int k, cudaStream_t stream) {
  const unsigned int grid = (unsigned int)((n_blocks + kThreads - 1) / kThreads);
  const size_t smem = (size_t)k * 8 * (NR + 1) * sizeof(uint32_t);
  cbc_mk_block_kernel<NR><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), static_cast<const uint4*>(prev),
      static_cast<const int32_t*>(slots), static_cast<const uint32_t*>(rks_dec), n_blocks, k);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. in/out/prev: (n_blocks, 4) u32 LE words, 16-byte
// aligned; slots: (n_blocks,) int32 schedule index per block; rks_dec: (k,
// 4*(nr+1)) u32 InvMixColumns-folded decrypt schedules, all on the card;
// 1 <= k <= 64. Returns the cudaError_t of the launch (0 on success).
extern "C" int ot_cbc_mk(const void* in, void* out, const void* prev, const void* slots,
                         const void* rks_dec, long long n_blocks, int k, int nr, void* stream) {
  if (n_blocks <= 0 || k < 1 || k > kMaxSlots || slots == nullptr ||
      n_blocks > (long long)kThreads * 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nr) {
    case 10: return (int)launch<10>(in, out, prev, slots, rks_dec, n_blocks, k, st);
    case 12: return (int)launch<12>(in, out, prev, slots, rks_dec, n_blocks, k, st);
    case 14: return (int)launch<14>(in, out, prev, slots, rks_dec, n_blocks, k, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
