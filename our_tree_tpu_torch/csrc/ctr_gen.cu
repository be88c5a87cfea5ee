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
// Constant time: no load address depends on key or data, only on the block
// index, the round and the word number. The arithmetic is in ctr_gen.cuh
// (counter synthesis) and aes_bitslice.cuh (rounds, transposes).

#include <cstdint>
#include <cuda_runtime.h>

#include "ctr_gen.cuh"

namespace {

constexpr int kThreads = 128;

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
cudaError_t launch(const void* data, void* out, const void* ctr_be, const void* rk,
                   long long n_blocks, cudaStream_t stream) {
  const long long groups = (n_blocks + 31) / 32;
  const unsigned int grid = (unsigned int)((groups + kThreads - 1) / kThreads);
  ctr_gen_kernel<NR><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(data), static_cast<uint4*>(out),
      static_cast<const uint32_t*>(ctr_be), static_cast<const uint32_t*>(rk), n_blocks);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. data/out: (n_blocks, 4) u32 LE words, 16-byte aligned;
// ctr_be: 4 u32 big-endian counter words on the card; rk: 4*(nr+1) u32 words.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ot_ctr_gen(const void* data, void* out, const void* ctr_be, const void* rk,
                          long long n_blocks, int nr, void* stream) {
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  if ((n_blocks + 31) / 32 > (long long)kThreads * 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nr) {
    case 10: return (int)launch<10>(data, out, ctr_be, rk, n_blocks, st);
    case 12: return (int)launch<12>(data, out, ctr_be, rk, n_blocks, st);
    case 14: return (int)launch<14>(data, out, ctr_be, rk, n_blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
