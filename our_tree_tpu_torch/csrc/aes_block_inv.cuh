// Per-block bitsliced AES decryption (cbc_mk.cu): the inverse of
// aes_block.cuh's encrypt_block in the same layout. One thread holds one
// 16-byte block as 8 bit planes in 8 registers, plane b = bit b of each state
// byte, lane p = byte p of the block (lane 4c + r is row r of column c), each
// plane's 16 lanes kept twice (bits 0-15 and 16-31) so that a rotation of the
// lanes is one 32-bit rotate. The round is the equivalent inverse cipher's,
// with the InvMixColumns-folded decrypt schedule (rk_dec[0] the whitening
// key), the form bitslice.decrypt_round takes:
//
//   InvSubBytes     aes_bitslice::inv_sbox (aes_inv_bitslice.cuh), the
//                   dedicated inverse S-box of the ECB decrypt kernel. It is
//                   plane-wise, so it runs on the 8 per-block planes as
//                   aes_block.cuh runs the forward Boyar-Peralta circuit.
//   InvShiftRows    row r rotates its four columns back by r: a rotate of the
//                   plane by 16 - 4r lanes, masked to row r's lanes.
//   InvMixColumns   MixColumns after the pre-transform a_r ^= 4(a_r ^ a_(r+2))
//                   (the matrix identity InvMixColumns = MixColumns x
//                   circ(05, 00, 04, 00)): aes_block::mix_columns is reused,
//                   and the pre-transform is one 2-lane in-nibble rotate, an
//                   XOR and 4(.) as xtime renaming. Chosen over a direct form
//                   of 14/11/13/9 by count: about 46 plane operations on top
//                   of the forward layer's 75 (121 in all), where the direct
//                   form, MixColumns plus 4(w) plus 8(a_0 ^ .. ^ a_3) with the
//                   all-row sum made by one more rotate, counts about 164
//                   (and 132 with the forward layer's t reused). The dependent
//                   path is 4 steps for the pre-transform and 5 for
//                   MixColumns with AddRoundKey (a step: one funnel shift or
//                   one function of at most three registers), 12 a round with
//                   InvShiftRows' 3; chip_smoke.py's latency bound counts
//                   these beside the inverse S-box circuit's own depth.
//   AddRoundKey     8 XORs with the round's decrypt key planes, made by
//                   aes_block::round_key_planes from rk_dec.
//
// Constant time: no tables, and no address that depends on key or data (the
// kernel reads key planes at offsets fixed by the round and the public slot).
// Without nvcc the same code compiles as host C++, so
// tests/test_torch_cbc_mk_host.py runs it with g++ against the plain torch
// version and against aes_block.cuh's encrypt_block.

#pragma once

#include <cstdint>

#include "aes_block.cuh"
#include "aes_inv_bitslice.cuh"

namespace aes_block {

// InvShiftRows of one plane: new lane 4c + r = old lane 4((c - r) % 4) + r,
// row r (lanes r, r+4, r+8, r+12) rotated by 16 - 4r lanes (a rotate by 16
// leaves the duplicated lanes as they are).
__device__ __forceinline__ uint32_t inv_shift_rows(uint32_t x) {
  return (x & 0x11111111u) | (rotr(x, 12) & 0x22222222u) | (rotr(x, 8) & 0x44444444u) |
         (rotr(x, 4) & 0x88888888u);
}

// InvMixColumns on planes, in place: the pre-transform d_r = a_r ^ 4(a_r ^
// a_(r+2)), then MixColumns. 4(.) is xtime twice, plane renaming and XORs.
__device__ __forceinline__ void inv_mix_columns(uint32_t (&s)[8]) {
  uint32_t w[8], x2[8], x4[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) w[b] = s[b] ^ row_after_next(s[b]);
  aes_bitslice::xtime(w, x2);
  aes_bitslice::xtime(x2, x4);
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] ^= x4[b];
  mix_columns(s);
}

// One inverse round with the folded schedule: InvSubBytes, InvShiftRows,
// InvMixColumns unless LAST, AddRoundKey (k: the round's 8 key planes).
template <bool LAST>
__device__ __forceinline__ void inv_block_round(uint32_t (&s)[8], const uint32_t* k) {
  aes_bitslice::inv_sbox(s);
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] = inv_shift_rows(s[b]);
  if (!LAST) inv_mix_columns(s);
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] ^= k[b];
}

// AES decrypt of one block's planes in place under kp, the (NR+1)*8 key
// planes of the decrypt schedule (round r at kp + 8r). The round loop is
// rolled, each round straight-line, as in encrypt_block.
template <int NR>
__device__ __forceinline__ void decrypt_block(uint32_t (&s)[8], const uint32_t* kp) {
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] ^= kp[b];
#pragma unroll 1
  for (int r = 1; r < NR; ++r) inv_block_round<false>(s, kp + 8 * r);
  inv_block_round<true>(s, kp + 8 * NR);
}

// CBC decrypt of one block: D(c) ^ prev under the decrypt key planes kp.
template <int NR>
__device__ __forceinline__ uint4 cbc_dec_block(uint4 c, uint4 prev, const uint32_t* kp) {
  uint32_t s[8];
  pack(c, s);
  decrypt_block<NR>(s, kp);
  const uint4 p = unpack(s);
  return make_uint4(p.x ^ prev.x, p.y ^ prev.y, p.z ^ prev.z, p.w ^ prev.w);
}

}  // namespace aes_block
