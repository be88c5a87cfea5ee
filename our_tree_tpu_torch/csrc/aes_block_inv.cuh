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
//                   circ(05, 00, 04, 00)): the pre-transform is one 2-lane
//                   in-nibble rotate, an XOR and 4(.) as xtime renaming, then
//                   aes_block::mix_columns' form (inv_mix_add_key below).
//                   Chosen over a direct form
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
// Pipes. With one warp on each SM sub-partition (the serve rungs: at most 128
// warps), the rounds are bound by the sub-partition's integer pipe: 16
// lanes a clock (the table's 64 results a clock an SM), one LOP3 or SHF
// every 2 cycles (chip_smoke.py phase 9's breakdown: the rounds take about
// 2 cycles for each such instruction). IMAD issues on the FMA pipe beside
// it. So the linear layers' shifts and ORs of disjoint bits are written as
// multiplies: x >> k as mulhi(x, 2^(32-k)) (IMAD.HI), x << 3 as x * 8, and
// a ^ a_(r+2), whose bits in rows 2-3 repeat those in rows 0-1, as 5 u
// (u | u << 2) for u its rows 0-1.
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

// x >> K as the high 32 bits of x * 2^(32-K): an IMAD.HI on the FMA pipe.
template <int K>
__device__ __forceinline__ uint32_t shr_fma(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __umulhi(x, 1u << (32 - K));
#else
  return (uint32_t)(((uint64_t)x << (32 - K)) >> 32);
#endif
}

// a ^ a_(r+2) of one plane: its rows 0-1 are u = (a ^ a >> 2) & 0x33333333,
// its rows 2-3 the same bits one row pair up, so the plane is u | u << 2 =
// 5 u.
__device__ __forceinline__ uint32_t xor_row_after_next(uint32_t a) {
  return 5u * ((a ^ shr_fma<2>(a)) & 0x33333333u);
}

// InvMixColumns then AddRoundKey on planes, in place: the pre-transform
// a_r ^= 4(a_r ^ a_(r+2)), then MixColumns, t_r = a_r ^ a_(r+1) and
// out_r = xt(t_r) ^ (t_r ^ t_(r+2)) ^ a_r, with the round key (k: its 8
// planes) XORed in the same steps. 4(.) and xt(.) are plane renaming and
// XORs, every XOR of three a LOP3.
__device__ __forceinline__ void inv_mix_add_key(uint32_t (&s)[8], const uint32_t* k) {
  using aes_bitslice::xor3;
  uint32_t w[8], t[8], q[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) w[b] = xor_row_after_next(s[b]);
  // s ^= 4(w), xtime twice: 4(w)_b = w_(b-2), with w_6 also into planes 0,
  // 1, 3, 4 and w_7 into planes 1, 2, 4, 5.
  const uint32_t w67 = w[6] ^ w[7];
  s[0] ^= w[6];
  s[1] ^= w67;
  s[2] = xor3(s[2], w[0], w[7]);
  s[3] = xor3(s[3], w[1], w[6]);
  s[4] = xor3(s[4], w[2], w67);
  s[5] = xor3(s[5], w[3], w[7]);
  s[6] ^= w[4];
  s[7] ^= w[5];
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    // next_row: ((s >> 1) & 0x77777777) | ((s << 3) & 0x88888888).
    t[b] = s[b] ^ ((shr_fma<1>(s[b]) & 0x77777777u) | ((s[b] * 8u) & 0x88888888u));
    q[b] = xor_row_after_next(t[b]);
  }
  // xt(t)_b = t_(b-1), with t_7 also into planes 1, 3, 4 (and t_7 alone
  // into plane 0).
  s[0] = xor3(s[0], q[0], k[0]) ^ t[7];
  s[1] = xor3(xor3(s[1], q[1], k[1]), t[0], t[7]);
  s[2] = xor3(s[2], q[2], k[2]) ^ t[1];
  s[3] = xor3(xor3(s[3], q[3], k[3]), t[2], t[7]);
  s[4] = xor3(xor3(s[4], q[4], k[4]), t[3], t[7]);
  s[5] = xor3(s[5], q[5], k[5]) ^ t[4];
  s[6] = xor3(s[6], q[6], k[6]) ^ t[5];
  s[7] = xor3(s[7], q[7], k[7]) ^ t[6];
}

// One inverse round with the folded schedule: InvSubBytes, InvShiftRows,
// InvMixColumns unless LAST, AddRoundKey (k: the round's 8 key planes).
template <bool LAST>
__device__ __forceinline__ void inv_block_round(uint32_t (&s)[8], const uint32_t* k) {
  aes_bitslice::inv_sbox(s);
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] = inv_shift_rows(s[b]);
  if (LAST) {
#pragma unroll
    for (int b = 0; b < 8; ++b) s[b] ^= k[b];
  } else {
    inv_mix_add_key(s, k);
  }
}

// AES decrypt of one block's planes in place under kp, the (NR+1)*8 key
// planes of the decrypt schedule (round r at kp + 8r). The round loop is
// rolled, each round straight-line, as in encrypt_block: a launch runs the
// code once a warp, and the loop's 4.4 KB stay in the instruction cache
// where the unrolled rounds would be fetched anew (chip_smoke.py phase 9
// times them unrolled, with the key planes loaded a round ahead).
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
