// Chained CBC / CFB128 encryption for Hopper (sm_90a), S streams of N blocks
// in one launch: CBC C_i = E(P_i ^ C_(i-1)) (seq_encrypt_kernel<NR, 0>) or
// CFB128 C_i = P_i ^ E(C_(i-1)) (seq_encrypt_kernel<NR, 1>), C_(-1) = the
// stream's IV; it writes every C_i and each stream's last one as its new IV.
//
// Replaces, on the sequential encrypts, the one-block use of the TPU kernel
// _aes_kernel (our_tree_tpu/ops/pallas_aes.py:259-273, launched at :358):
// the reference runs these recurrences as a lax.scan over a T-table gather
// (our_tree_tpu/models/aes.py:704-716, :800-807, the batch at :751), and
// the port used to launch its ECB kernel once per block step, each launch
// walking a whole 32-block bitsliced group to make one block. Here the loop
// over the N blocks runs inside the kernel. The plain version is
// cuda_aes.seq_encrypt_plain (the per-block loop over bitslice.encrypt_words).
//
// Bound. A stream is a recurrence: block i cannot start before block i - 1
// ends, so one stream's time is N times the dependent path through one
// block's rounds times the card's dependent-issue latency, whatever the
// bytes (32 per block) or the operations. With S streams the path is the
// same and S threads share the SMs. chip_smoke.py reports the latency bound
// (the path counted in the kernel's SASS times the latency the ceiling
// probe's long chain measures) beside the roofline bound.
//
// Design.
//   * One thread per stream, a warp per thread block, so up to 132 streams
//     each get an SM's scheduler to themselves. The block is held in the
//     per-block bitsliced form of aes_block.cuh (8 planes in registers), and
//     the chain stays in planes from block to block.
//   * Each thread block turns the schedule into (NR+1)*8 key planes in
//     shared memory once; every thread reads the same address (a broadcast).
//   * The next plaintext block's load is issued before the current block's
//     rounds, so its latency hides behind them; stores are not waited on.
//   * The round loop is rolled (each round straight-line) to keep the loop
//     in the instruction cache of a single warp.
// Constant time: no tables; addresses depend only on the stream, the block
// index and the round.

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_block.cuh"

namespace {

constexpr int kThreads = 32;

template <int NR, int CFB>
__global__ void __launch_bounds__(kThreads)
seq_encrypt_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                   const uint4* __restrict__ iv, uint4* __restrict__ iv_out,
                   const uint32_t* __restrict__ rk, int s, long long n) {
  static_assert(NR + 1 <= kThreads, "one thread per round key");
  __shared__ uint32_t kp[8 * (NR + 1)];
  if (threadIdx.x <= NR) aes_block::round_key_planes(rk, threadIdx.x, kp + 8 * threadIdx.x);
  __syncthreads();
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= s) return;
  iv_out[j] = aes_block::chain_stream<NR, CFB>(in + j * n, out + j * n, n, iv[j], kp);
}

template <int NR, int CFB>
cudaError_t launch(const void* in, void* out, const void* iv, void* iv_out, const void* rk,
                   int s, long long n, cudaStream_t stream) {
  const unsigned int grid = (unsigned int)((s + kThreads - 1) / kThreads);
  seq_encrypt_kernel<NR, CFB><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), static_cast<const uint4*>(iv),
      static_cast<uint4*>(iv_out), static_cast<const uint32_t*>(rk), s, n);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. in/out: (s, n, 4) u32 LE words, stream j at block
// j*n; iv/iv_out: (s, 4) u32 words; all 16-byte aligned on the card; rk:
// 4*(nr+1) u32 encrypt schedule on the card; cfb: 0 for CBC, 1 for CFB128.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ot_seq_encrypt(const void* in, void* out, const void* iv, void* iv_out,
                              const void* rk, int s, long long n, int cfb, int nr,
                              void* stream) {
  if (s <= 0 || n <= 0 || (cfb != 0 && cfb != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nr * 2 + cfb) {
    case 20: return (int)launch<10, 0>(in, out, iv, iv_out, rk, s, n, st);
    case 21: return (int)launch<10, 1>(in, out, iv, iv_out, rk, s, n, st);
    case 24: return (int)launch<12, 0>(in, out, iv, iv_out, rk, s, n, st);
    case 25: return (int)launch<12, 1>(in, out, iv, iv_out, rk, s, n, st);
    case 28: return (int)launch<14, 0>(in, out, iv, iv_out, rk, s, n, st);
    case 29: return (int)launch<14, 1>(in, out, iv, iv_out, rk, s, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
