// Counter synthesis of the ctr_gen kernel (ctr_gen.cu). The group form: the
// keystream of one group of 32 consecutive counter blocks, held as 128 bit
// planes in registers (plane 8p+b = bit b of state byte p, lane bit t = block
// t of the group). Its only memory reads are the base counter and the
// round-key masks, at addresses fixed by the round and plane number. The
// round arithmetic is aes_bitslice.cuh's, shared with the ECB kernels. The
// block form: one counter block as LE words (counter_block), encrypted by
// aes_block.cuh's per-block core.
//
// Without nvcc the same code compiles as host C++, so the CPU tests run it
// against the plain torch version (tests/test_torch_ctr_host.py).

#pragma once

#include <cstdint>

#include "aes_bitslice.cuh"

namespace ctr_gen {

// Counter block base + j as the block's LE words: base is 4 big-endian u32
// words (word 0 most significant), the addition of the 64-bit block index
// carries through all 128 bits and wraps mod 2^128.
__device__ __forceinline__ void counter_block(const uint32_t* ctr_be, unsigned long long j,
                                              uint32_t (&le)[4]) {
  const unsigned long long lo = (((unsigned long long)ctr_be[2] << 32) | ctr_be[3]) + j;
  const unsigned long long hi =
      (((unsigned long long)ctr_be[0] << 32) | ctr_be[1]) + (unsigned long long)(lo < j);
  const uint32_t be[4] = {(uint32_t)(hi >> 32), (uint32_t)hi, (uint32_t)(lo >> 32), (uint32_t)lo};
#pragma unroll
  for (int c = 0; c < 4; ++c)
    le[c] = (be[c] >> 24) | ((be[c] >> 8) & 0xFF00u) | ((be[c] << 8) & 0xFF0000u) | (be[c] << 24);
}

using aes_bitslice::aes_round;
using aes_bitslice::key_mask;
using aes_bitslice::transpose32;

// Bit t of iota_mask(q) is bit q of t: bits 0..4 of the block index within a group.
__device__ __forceinline__ constexpr uint32_t iota_mask(int q) {
  return q == 0 ? 0xAAAAAAAAu : q == 1 ? 0xCCCCCCCCu : q == 2 ? 0xF0F0F0F0u
       : q == 3 ? 0xFF00FF00u : 0xFFFF0000u;
}

// Keystream of group g: on return s[32c + t] is word c (little-endian) of
// E_K(base + 32g + t), t = 0..31, the addition wrapping mod 2^128. base is
// 4 big-endian u32 words (word 0 most significant); kmask holds
// key_mask(rk, i) for i < 128(NR+1).
template <int NR>
__device__ __forceinline__ void keystream_group(uint32_t (&s)[128], const uint32_t* ctr_be,
                                                const uint32_t* kmask, unsigned long long g) {
  // Counter planes with AddRoundKey 0: a bitsliced ripple adder of base and
  // the 64-bit block index 32g + t. Bits 0..4 of the index are the lane masks,
  // bits 5..68 broadcast bits of g; the carry runs through all 128 bits.
  {
    const uint32_t base[4] = {ctr_be[0], ctr_be[1], ctr_be[2], ctr_be[3]};
    uint32_t carry = 0u;
#pragma unroll
    for (int q = 0; q < 128; ++q) {
      const uint32_t bq = 0u - ((base[3 - (q >> 5)] >> (q & 31)) & 1u);
      const uint32_t jq = q < 5 ? iota_mask(q)
                        : q < 69 ? 0u - (uint32_t)((g >> (q - 5)) & 1ull) : 0u;
      const uint32_t x = bq ^ jq;
      s[8 * (15 - (q >> 3)) + (q & 7)] = (x ^ carry) ^ kmask[8 * (15 - (q >> 3)) + (q & 7)];
      carry = (bq & jq) | (carry & x);
    }
  }

  // The round loop is not unrolled, to keep the code inside the instruction
  // cache; each round is straight-line.
#pragma unroll 1
  for (int r = 1; r < NR; ++r) aes_round<false>(s, kmask + 128 * r);
  aes_round<true>(s, kmask + 128 * NR);

  // Planes of column c are s[32c .. 32c+31] (row 8a+b = byte 4c+a, bit b);
  // after the transpose s[32c + t] is word c of block t's keystream.
#pragma unroll
  for (int c = 0; c < 4; ++c) transpose32(&s[32 * c]);
}

}  // namespace ctr_gen
