// Counter-synthesising AES-CTR for Hopper (sm_90a): out[j] = data[j] ^ E_K(base + j).
//
// Replaces the TPU kernel _ctr_gen_kernel (our_tree_tpu/ops/pallas_aes.py:601-612,
// launched at :626), which serves every fused-CTR engine name of the reference.
// The plain version of the same arithmetic is our_tree_tpu_torch/ops/bitslice.py.
//
// Bound. Per 16-byte block the kernel reads 16 bytes and writes 16 bytes, but
// the cipher is a boolean circuit of about 50 two-input gates per byte (about
// 25 three-input LOP3 instructions at best). At 64 integer instructions per
// clock per SM the card runs out of issue slots long before HBM runs out of
// bytes, so the kernel is bound by operations (chip_smoke.py counts them).
//
// Design. Each thread owns 32 consecutive blocks and holds the AES state as
// 128 bit planes in registers (plane 8p+b = bit b of state byte p, lane bit t
// = block t of the group), so every gate does 32 blocks of work:
//   * counters never touch memory: a bitsliced 128-bit ripple adder makes
//     the counter planes from the base counter and the 64-bit block index
//     (bits 0..4 of the index are constant lane masks, bits 5..68 are
//     broadcast bits of the thread's group index), with full carry to bit 127;
//   * AddRoundKey XORs full-lane masks that each thread block builds once in
//     shared memory from the schedule;
//   * SubBytes is the 115-gate Boyar-Peralta circuit, ShiftRows is register
//     renaming, MixColumns is xtime as a plane shuffle plus XOR;
//   * four 32x32 bit transposes turn the keystream planes back into words,
//     which are XORed with the data and stored. Blocks past n are masked.
// Two forms, chosen per launch by ot_ctr_gen (form 0, auto: the block form up
// to kCtrGenBlockFormMax blocks, the group form above; 1 and 2 force one), as
// ecb.cu's encrypt forms are:
//   * the group form above (ctr_gen_kernel), for bulk CTR (the 256 MiB main
//     path): 32 blocks a thread, bound by operations;
//   * the block form (ctr_gen_block_kernel): one block a thread on the
//     per-block core of aes_block.cuh, for few blocks. A call of AES.crypt_ctr
//     that ends mid-block makes its last keystream block with one launch over
//     one block (models/aes.py), which in the group form is one thread
//     walking a whole 32-block group, bound by that thread's path. Each
//     thread makes its counter (base + j with a full 128-bit carry,
//     ctr_gen.cuh counter_block) and issues its data load before the thread
//     block turns the schedule into key planes in shared memory; the rounds
//     are aes_block.cuh's rolled encrypt_block (the choices ecb.cu's block
//     form measured against their alternatives).
// Constant time: no load address depends on key or data, only on the block
// index, the round and the word number; the form depends only on the block
// count. The arithmetic is in ctr_gen.cuh (counter synthesis),
// aes_bitslice.cuh (rounds, transposes) and aes_block.cuh (one block).

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_block.cuh"
#include "ctr_gen.cuh"

namespace {

constexpr int kThreads = 128;
// The most blocks the auto form sends to the block form: the largest size of
// chip_smoke.py phase 9's crossing table (both forms at 1 to 2^20 blocks, in a
// CUDA graph) at which the block form was the faster; PERF.md holds the
// table.
constexpr long long kCtrGenBlockFormMax = 1ll << 16;
enum Form { kAuto = 0, kGroup = 1, kBlock = 2 };

template <int NR>
__global__ void __launch_bounds__(kThreads)
ctr_gen_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
               const uint32_t* __restrict__ ctr_be, const uint32_t* __restrict__ rk,
               long long n_blocks) {
  // Full-lane round-key masks, built once per thread block.
  __shared__ uint32_t kmask[(NR + 1) * 128];
#pragma unroll
  for (int r = 0; r <= NR; ++r)
    kmask[128 * r + threadIdx.x] = ctr_gen::key_mask(rk, 128 * r + threadIdx.x);
  __syncthreads();

  const unsigned long long g = blockIdx.x * (unsigned long long)kThreads + threadIdx.x;
  const long long first = (long long)(g * 32ull);
  if (first >= n_blocks) return;

  uint32_t s[128];
  ctr_gen::keystream_group<NR>(s, ctr_be, kmask, g);

#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const long long j = first + t;
    if (j < n_blocks) {
      uint4 d = data[j];
      d.x ^= s[t];
      d.y ^= s[32 + t];
      d.z ^= s[64 + t];
      d.w ^= s[96 + t];
      out[j] = d;
    }
  }
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
ctr_gen_block_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
                     const uint32_t* __restrict__ ctr_be, const uint32_t* __restrict__ rk,
                     long long n_blocks) {
  static_assert(NR + 1 <= kThreads, "one thread per round key");
  __shared__ uint32_t kp[8 * (NR + 1)];
  const long long j = blockIdx.x * (long long)kThreads + threadIdx.x;
  const bool live = j < n_blocks;
  // The block's load and its counter go out before the key planes are made,
  // so their round trips overlap.
  const uint4 d = live ? data[j] : make_uint4(0u, 0u, 0u, 0u);
  uint32_t c[4];
  ctr_gen::counter_block(ctr_be, (unsigned long long)j, c);
  if (threadIdx.x <= NR) aes_block::round_key_planes(rk, threadIdx.x, kp + 8 * threadIdx.x);
  __syncthreads();
  if (live) out[j] = aes_block::ctr_block<NR>(make_uint4(c[0], c[1], c[2], c[3]), d, kp);
}

template <int NR>
cudaError_t launch(const void* data, void* out, const void* ctr_be, const void* rk,
                   long long n_blocks, int form, cudaStream_t stream) {
  const uint4* src = static_cast<const uint4*>(data);
  uint4* dst = static_cast<uint4*>(out);
  const uint32_t* ctr = static_cast<const uint32_t*>(ctr_be);
  const uint32_t* keys = static_cast<const uint32_t*>(rk);
  if (form == kBlock) {
    const unsigned int grid = (unsigned int)((n_blocks + kThreads - 1) / kThreads);
    ctr_gen_block_kernel<NR><<<grid, kThreads, 0, stream>>>(src, dst, ctr, keys, n_blocks);
  } else {
    const long long groups = (n_blocks + 31) / 32;
    const unsigned int grid = (unsigned int)((groups + kThreads - 1) / kThreads);
    ctr_gen_kernel<NR><<<grid, kThreads, 0, stream>>>(src, dst, ctr, keys, n_blocks);
  }
  return cudaGetLastError();
}

}  // namespace

// The form a launch of n_blocks takes: form 1 (group) or 2 (block) as given,
// form 0 (auto) the block form up to kCtrGenBlockFormMax blocks; -1 for a bad
// form.
extern "C" int ot_ctr_gen_form(long long n_blocks, int form) {
  if (form == kAuto) return n_blocks <= kCtrGenBlockFormMax ? kBlock : kGroup;
  return form == kGroup || form == kBlock ? form : -1;
}

// C interface for ctypes. data/out: (n_blocks, 4) u32 LE words, 16-byte aligned;
// ctr_be: 4 u32 big-endian counter words on the card; rk: 4*(nr+1) u32 words;
// form: 0 auto, 1 group, 2 block (ot_ctr_gen_form). Returns the cudaError_t of
// the launch (0 on success).
extern "C" int ot_ctr_gen(const void* data, void* out, const void* ctr_be, const void* rk,
                          long long n_blocks, int form, int nr, void* stream) {
  form = ot_ctr_gen_form(n_blocks, form);
  if (n_blocks <= 0 || form < 0) return (int)cudaErrorInvalidValue;
  if ((form == kBlock ? n_blocks : (n_blocks + 31) / 32) > (long long)kThreads * 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nr) {
    case 10: return (int)launch<10>(data, out, ctr_be, rk, n_blocks, form, st);
    case 12: return (int)launch<12>(data, out, ctr_be, rk, n_blocks, form, st);
    case 14: return (int)launch<14>(data, out, ctr_be, rk, n_blocks, form, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
