// Chained CBC / CFB128 encryption for Hopper (sm_90a), S streams of N blocks
// in one launch: CBC C_i = E(P_i ^ C_(i-1)) or CFB128 C_i = P_i ^ E(C_(i-1)),
// C_(-1) = the stream's IV; it writes every C_i and each stream's last one as
// its new IV.
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
// ends. So one stream's time is N times the larger of two things, both fixed
// by how the form lays a block out: the block's dependent path (each step's
// latency: about 4 cycles for an integer instruction, about 26 for a shuffle,
// chip_smoke.py phase 9's chases), and the issue slots its instructions take
// on the warp that runs them (one warp instruction every 2 cycles on a
// sub-partition's integer pipe, and as many on its FMA pipe). With S streams
// the path is the same, and the issue is that of the warps each sub-partition
// holds. chip_smoke.py phase 9 prints both for each form at each shape it
// times, with the former bound (the thread form's SASS depth) beside them.
//
// Design. Four forms (seq_form.cuh), the auto form choosing by S:
//   * The thread form (seq_encrypt_kernel): one thread a stream, 32 streams
//     sharing each one-warp thread block, the block in the per-block
//     bitsliced form of aes_block.cuh (8 planes in registers) and the chain
//     in planes from block to block; the block's key planes are made once in
//     shared memory. A block costs its warp about 2,600 integer
//     instructions, so one stream is bound by one warp's issue, not by its
//     path; it is the form for the most streams, where every sub-partition is
//     busy and its 32 streams a warp cost the fewest issue slots a stream.
//   * The lane forms (seq_lanes_kernel<NR, CFB, Q>): 4Q lanes a stream, a lane
//     a column word and Q lanes a column (aes_lanes.cuh), 8/Q streams a warp
//     and four warps a thread block, one on each sub-partition. A round is a
//     register-held S-box lookup, log2(Q) + 1 shuffles and MixColumns on the
//     word: about 80 integer-pipe instructions a lane at Q = 1, 50 at Q = 2
//     and 36 at Q = 4, beside a few IMADs (at Q = 1 also the 64 S-box words'
//     moves), on a path of 15 integer steps and log2(Q) + 1 shuffles. The
//     16-lane form has the shortest round, at one or few streams; the 4-lane
//     form the fewest instructions a stream, at thousands.
//   * Each lane keeps its round-key words in registers, the rounds unrolled;
//     the next plaintext word is loaded before the current block's rounds,
//     so its latency hides behind them; stores are not waited on.
// Constant time: no table in memory (the lane forms' S-box is in registers,
// picked by PRMT selectors and bit selects); addresses depend only on the
// stream, the block index and the round, and every shuffle's source lane only
// on the lane's place in its block.

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_block.cuh"
#include "aes_lanes.cuh"
#include "seq_form.cuh"

// The form a launch of s streams takes (seq_form: `form` itself when it names
// one, the auto form's choice for 0, -1 for an unknown code).
extern "C" int ot_seq_encrypt_form(int s, int form) { return seq_form(s, form); }

namespace {

constexpr int kThreads = 32;
// Threads of a lane-form thread block: four warps, one on each of the SM's
// sub-partitions.
constexpr int kLaneThreads = 128;

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

// The lane forms: 4Q lanes a stream (aes_lanes.cuh), 8/Q streams a warp. Lane
// 4Q g + Q c + q reads and keeps word c of stream g's blocks; the lanes with
// q = 0 write it. A warp with no stream returns whole; the lanes of a stream
// past s run with the others (the shuffles take every lane) but neither read
// nor write.
template <int NR, int CFB, int Q>
__global__ void __launch_bounds__(kLaneThreads)
seq_lanes_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 const uint32_t* __restrict__ iv, uint32_t* __restrict__ iv_out,
                 const uint32_t* __restrict__ rk, int s, long long n) {
  constexpr int kStreams = 8 / Q;
  const unsigned int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * kLaneThreads + threadIdx.x) / 32 * kStreams;
  if (first >= s) return;
  const long long j = first + lane / (4 * Q);
  const int c = (lane / Q) & 3;
  const bool live = j < s, writer = live && lane % Q == 0;
  aes_lanes::Lane<Q, uint32_t> l;
  aes_lanes::lane_setup<Q>((uint32_t)lane, l);
  uint32_t k[NR + 1];
#pragma unroll
  for (int r = 0; r <= NR; ++r) k[r] = rk[4 * r + c];
  const uint32_t* src = in + (live ? j : 0) * n * 4 + c;
  uint32_t* dst = out + j * n * 4 + c;
  uint32_t chain = live ? iv[4 * j + c] : 0u;
  uint32_t next = live ? src[0] : 0u;
#pragma unroll 1
  for (long long i = 0; i < n; ++i) {
    const uint32_t p = next;
    if (live && i + 1 < n) next = src[4 * (i + 1)];
    chain = aes_lanes::chain_step<NR, CFB>(p, chain, l, k);
    if (writer) dst[4 * i] = chain;
  }
  if (writer) iv_out[4 * j + c] = chain;
}

template <int NR, int CFB>
cudaError_t launch(const void* in, void* out, const void* iv, void* iv_out, const void* rk,
                   int s, long long n, int form, cudaStream_t stream) {
  if (form == kSeqThread) {
    const unsigned int grid = (unsigned int)((s + kThreads - 1) / kThreads);
    seq_encrypt_kernel<NR, CFB><<<grid, kThreads, 0, stream>>>(
        static_cast<const uint4*>(in), static_cast<uint4*>(out), static_cast<const uint4*>(iv),
        static_cast<uint4*>(iv_out), static_cast<const uint32_t*>(rk), s, n);
    return cudaGetLastError();
  }
  const auto* win = static_cast<const uint32_t*>(in);
  const auto* wiv = static_cast<const uint32_t*>(iv);
  const auto* wrk = static_cast<const uint32_t*>(rk);
  auto* wout = static_cast<uint32_t*>(out);
  auto* wiv_out = static_cast<uint32_t*>(iv_out);
  const int per_warp = 32 / seq_lanes(form);  // streams a warp, 8 / Q
  const long long warps = (s + per_warp - 1) / per_warp;
  const unsigned int grid = (unsigned int)((warps * 32 + kLaneThreads - 1) / kLaneThreads);
  switch (form) {
    case kSeqLanes4:
      seq_lanes_kernel<NR, CFB, 1><<<grid, kLaneThreads, 0, stream>>>(win, wout, wiv, wiv_out,
                                                                       wrk, s, n);
      break;
    case kSeqLanes8:
      seq_lanes_kernel<NR, CFB, 2><<<grid, kLaneThreads, 0, stream>>>(win, wout, wiv, wiv_out,
                                                                       wrk, s, n);
      break;
    default:
      seq_lanes_kernel<NR, CFB, 4><<<grid, kLaneThreads, 0, stream>>>(win, wout, wiv, wiv_out,
                                                                       wrk, s, n);
      break;
  }
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. in/out: (s, n, 4) u32 LE words, stream j at block
// j*n; iv/iv_out: (s, 4) u32 words; all 16-byte aligned on the card; rk:
// 4*(nr+1) u32 encrypt schedule on the card; cfb: 0 for CBC, 1 for CFB128;
// form: 0 (auto: ot_seq_encrypt_form decides by s) or a form's code.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ot_seq_encrypt(const void* in, void* out, const void* iv, void* iv_out,
                              const void* rk, int s, long long n, int cfb, int nr, int form,
                              void* stream) {
  if (s <= 0 || n <= 0 || (cfb != 0 && cfb != 1)) return (int)cudaErrorInvalidValue;
  form = seq_form(s, form);
  if (form < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nr * 2 + cfb) {
    case 20: return (int)launch<10, 0>(in, out, iv, iv_out, rk, s, n, form, st);
    case 21: return (int)launch<10, 1>(in, out, iv, iv_out, rk, s, n, form, st);
    case 24: return (int)launch<12, 0>(in, out, iv, iv_out, rk, s, n, form, st);
    case 25: return (int)launch<12, 1>(in, out, iv, iv_out, rk, s, n, form, st);
    case 28: return (int)launch<14, 0>(in, out, iv, iv_out, rk, s, n, form, st);
    case 29: return (int)launch<14, 1>(in, out, iv, iv_out, rk, s, n, form, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
