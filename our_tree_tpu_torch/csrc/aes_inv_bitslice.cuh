// Bitsliced AES decryption for the ECB decrypt kernel (ecb.cu), in the
// layout of aes_bitslice.cuh (32 blocks a thread, 128 bit planes, plane
// 8p + b = bit b of state byte p, lane bit t = block t of the group).
//
// Each piece is shaped for Hopper's integer pipe, where one LOP3 computes
// any function of three registers:
//   * inv_sbox: a dedicated inverse S-box. With U, M, B the top linear
//     layer, the 62-gate nonlinear middle and the bottom linear layer of the
//     forward Boyar-Peralta circuit (sbox_bp_circuit, whose output without
//     the 0x63 is A(x^-1)) and A^-1 the linear part of the inverse affine
//     map, InvS(y) = A^-1 B M(U(A^-1 y ^ 0x05)). U' = U A^-1 (8 bits to the
//     middle's 22 inputs, the 0x05 as NOTs) and B' = A^-1 B (the 18
//     products to 8 bits) are new linear layers, synthesised by the
//     distance-guided greedy search of Boyar and Peralta (2012) with every
//     step an XOR of two or three signals: 22 and 17 steps, one LOP3 each,
//     where the forward layers are 23 and 30 two-input XORs. Maximov and
//     Ekdahl (TCHES 2019(4)) carry this line of work further.
//   * inv_mix_column: InvMixColumns plus AddRoundKey of one column, 14a_r ^
//     11a_(r+1) ^ 13a_(r+2) ^ 9a_(r+3) ^ k_r, as 113 steps of 2- or 3-input
//     XORs found by Paar's greedy over the column's 32 state and 32 key
//     planes; each key plane enters the last step of its output plane.
//   * transpose32_prmt: the word<->plane transposes with their 16- and
//     8-bit stages as byte permutes (PRMT), two a pair of words.
// The two generated blocks are the output of
// `python -m our_tree_tpu_torch.ops.xor_programs`, which derives U', B' and
// the InvMixColumns matrix from the forward circuit above and the field,
// checks them over all 256 bytes and on random columns, and prints these
// blocks; tests/test_torch_ecb_host.py holds the two equal and runs this
// header with g++ against the plain version. No table, and no address that
// depends on key or data: the circuit is straight-line logic.

#pragma once

#include <cstdint>

#include "aes_bitslice.cuh"

namespace aes_bitslice {

// One step of the generated programs: a ^ b ^ c (LUT 0x96) or its
// complement (0x69) as one LOP3, written in inline PTX so that the compiler
// keeps each step as it is; from plain C XORs it regroups them and issues
// more instructions. On the host, the same function in C.
__device__ __forceinline__ uint32_t xor3(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDACC__
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x96;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  return a ^ b ^ c;
#endif
}

__device__ __forceinline__ uint32_t xnor3(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDACC__
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x69;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  return ~(a ^ b ^ c);
#endif
}

// Inverse S-box on one byte's planes x[0..7] (LSB first), in place.
__device__ __forceinline__ void inv_sbox(uint32_t* x) {
// BEGIN GENERATED by python -m our_tree_tpu_torch.ops.xor_programs (inv_sbox)
  // U' = U A^-1: 22 steps to the middle's 22 inputs; the 0x05 of the inverse
  // affine map is a NOT (~, xnor3) on the signals it reaches, free in a LOP3.
  const uint32_t y9 = x[3] ^ x[4], y13 = xor3(x[0], x[1], y9), u7 = xnor3(x[2], x[5], x[7]);
  const uint32_t y5 = ~(x[4] ^ x[6]), y17 = xnor3(x[0], x[2], y13), y15 = xnor3(x[2], x[5], y5);
  const uint32_t y14 = xor3(x[3], x[7], y5), y6 = x[3] ^ y14, y16 = y17 ^ y15;
  const uint32_t y8 = x[4] ^ y6, y20 = xnor3(x[0], u7, y16), y4 = xor3(x[0], x[1], y5);
  const uint32_t y19 = ~(x[0] ^ x[3]), y3 = x[4] ^ x[7], y11 = y9 ^ y20;
  const uint32_t y2 = y9 ^ y4, y1 = ~(x[0] ^ y9), y21 = y13 ^ y16;
  const uint32_t y12 = y13 ^ y14, y18 = ~(x[5] ^ y9), y7 = ~(x[1] ^ y21);
  const uint32_t y10 = y17 ^ y11;
  // The forward circuit's nonlinear middle, unchanged (62 gates).
  const uint32_t t2 = y12 & y15, t3 = y3 & y6, t4 = t3 ^ t2, t5 = y4 & u7;
  const uint32_t t6 = t5 ^ t2, t7 = y13 & y16, t8 = y5 & y1, t9 = t8 ^ t7;
  const uint32_t t10 = y2 & y7, t11 = t10 ^ t7, t12 = y9 & y11, t13 = y14 & y17;
  const uint32_t t14 = t13 ^ t12, t15 = y8 & y10, t16 = t15 ^ t12, t17 = t4 ^ t14;
  const uint32_t t18 = t6 ^ t16, t19 = t9 ^ t14, t20 = t11 ^ t16, t21 = t17 ^ y20;
  const uint32_t t22 = t18 ^ y19, t23 = t19 ^ y21, t24 = t20 ^ y18, t25 = t21 ^ t22;
  const uint32_t t26 = t21 & t23, t27 = t24 ^ t26, t28 = t25 & t27, t29 = t28 ^ t22;
  const uint32_t t30 = t23 ^ t24, t31 = t22 ^ t26, t32 = t31 & t30, t33 = t32 ^ t24;
  const uint32_t t34 = t23 ^ t33, t35 = t27 ^ t33, t36 = t24 & t35, t37 = t36 ^ t34;
  const uint32_t t38 = t27 ^ t36, t39 = t29 & t38, t40 = t25 ^ t39, t41 = t40 ^ t37;
  const uint32_t t42 = t29 ^ t33, t43 = t29 ^ t40, t44 = t33 ^ t37, t45 = t42 ^ t41;
  const uint32_t z0 = t44 & y15, z1 = t37 & y6, z2 = t33 & u7, z3 = t43 & y16;
  const uint32_t z4 = t40 & y1, z5 = t29 & y7, z6 = t42 & y11, z7 = t45 & y17;
  const uint32_t z8 = t41 & y10, z9 = t44 & y12, z10 = t37 & y3, z11 = t33 & y4;
  const uint32_t z12 = t43 & y13, z13 = t40 & y5, z14 = t29 & y2, z15 = t42 & y9;
  const uint32_t z16 = t45 & y14, z17 = t41 & y8;
  // B' = A^-1 B: 17 steps from z0..z17 to the output planes.
  const uint32_t g0 = z6 ^ z15, g1 = xor3(z12, z16, g0), g2 = xor3(z8, z13, g1);
  const uint32_t o7 = xor3(z3, z5, g2), o4 = xor3(z0, z2, g2), g5 = xor3(z1, z4, o7);
  const uint32_t o2 = xor3(z0, z3, g5), g7 = xor3(z4, z7, z8), o1 = xor3(z3, g2, g7);
  const uint32_t g9 = xor3(z10, o7, o4), g10 = xor3(z14, o2, g9), o5 = xor3(z11, z13, g10);
  const uint32_t g12 = xor3(z9, z17, g0), o6 = xor3(g1, g10, g12), o0 = xor3(z6, z11, g12);
  const uint32_t g15 = xor3(z17, o1, g9), o3 = xor3(z11, z16, g15);
  x[0] = o0; x[1] = o1; x[2] = o2; x[3] = o3;
  x[4] = o4; x[5] = o5; x[6] = o6; x[7] = o7;
// END GENERATED (inv_sbox)
}

// InvMixColumns of one column a[r][b] (row r, bit b) plus AddRoundKey (km,
// 32 planes), into o[8r + b].
__device__ __forceinline__ void inv_mix_column(const uint32_t (&a)[4][8], const uint32_t* km,
                                               uint32_t* o) {
// BEGIN GENERATED by python -m our_tree_tpu_torch.ops.xor_programs (inv_mix_column)
  // 38 shared steps, then 75 final steps, each output plane's key in its last.
  const uint32_t m0 = a[0][5] ^ a[2][5], m1 = xor3(a[1][5], a[3][5], m0), m2 = xor3(a[0][6], a[2][6], a[3][7]);
  const uint32_t m3 = xor3(a[1][6], a[2][7], a[3][6]), m4 = xor3(a[0][6], a[0][7], a[2][6]), m5 = xor3(a[0][1], a[2][1], m1);
  const uint32_t m6 = xor3(a[0][3], a[1][3], a[1][7]), m7 = xor3(a[0][7], a[2][3], a[3][3]), m8 = xor3(a[0][2], a[2][2], m3);
  const uint32_t m9 = a[1][7] ^ a[3][6], m10 = xor3(a[1][4], a[2][7], a[3][4]), m11 = xor3(a[0][0], a[2][0], a[3][0]);
  const uint32_t m12 = xor3(a[0][4], a[2][4], a[3][7]), m13 = xor3(a[1][2], a[3][2], m2), m14 = xor3(a[1][6], a[3][6], a[3][7]);
  const uint32_t m15 = xor3(a[1][6], m9, m13), m16 = xor3(a[1][1], a[3][1], m1), m17 = xor3(a[3][2], a[3][3], m4);
  const uint32_t m18 = m6 ^ m7, m19 = xor3(a[1][1], a[3][1], m5), m20 = xor3(a[1][0], a[2][7], m2);
  const uint32_t m21 = xor3(a[1][0], a[3][0], m4), m22 = xor3(a[1][2], m8, m17), m23 = xor3(m3, m12, m18);
  const uint32_t m24 = xor3(a[1][0], m6, m11), m25 = xor3(a[0][3], a[2][2], a[3][5]), m26 = xor3(a[1][3], m0, m22);
  const uint32_t m27 = xor3(a[2][4], a[3][4], m19), m28 = xor3(a[0][7], a[1][5], m10), m29 = xor3(a[0][2], a[1][5], m15);
  const uint32_t m30 = xor3(a[0][7], a[2][0], m14), m31 = xor3(a[2][2], m7, m14), m32 = xor3(m2, m10, m18);
  const uint32_t m33 = xor3(a[2][3], m25, m29), m34 = m8 ^ m21, m35 = a[2][6] ^ m12;
  const uint32_t m36 = xor3(a[0][4], a[1][4], m19), m37 = xor3(a[0][0], a[2][0], m15);
  o[0] = xor3(xor3(a[1][7], a[2][0], m1), m21, km[0]);
  o[1] = xor3(xor3(xor3(a[0][0], a[1][0], a[1][7]), a[2][1], m3), m16, km[1]);
  o[2] = xor3(xor3(a[0][1], a[1][1], a[2][2]), m37, km[2]);
  o[3] = xor3(xor3(xor3(xor3(a[0][2], a[1][2], a[1][3]), a[2][3], a[3][3]), m5, m11), m20, km[3]);
  o[4] = xor3(xor3(a[1][4], m6, m8), m27, km[4]);
  o[5] = xor3(xor3(a[0][4], a[1][4], a[2][5]), m33, km[5]);
  o[6] = xor3(xor3(a[0][5], a[1][5], a[2][6]), m23, km[6]);
  o[7] = xor3(xor3(xor3(a[0][6], a[1][6], a[1][7]), m0, m10), m12, km[7]);
  o[8] = xor3(xor3(a[1][7], m1, m3), m11, km[8]);
  o[9] = xor3(xor3(a[2][0], a[3][1], m5), m20, km[9]);
  o[10] = xor3(xor3(a[1][1], a[2][1], a[3][2]), m34, km[10]);
  o[11] = xor3(xor3(xor3(a[0][3], a[1][0], a[1][2]), m11, m16), m31, km[11]);
  o[12] = xor3(xor3(xor3(a[0][4], a[1][3], a[2][3]), a[2][7], m13), m27, km[12]);
  o[13] = xor3(xor3(a[1][4], a[2][4], a[3][5]), m26, km[13]);
  o[14] = xor3(xor3(a[1][5], a[2][5], a[3][6]), m32, km[14]);
  o[15] = xor3(xor3(a[1][6], a[3][5], m28), m35, km[15]);
  o[16] = xor3(xor3(a[0][0], a[3][0], m1), m20, km[16]);
  o[17] = xor3(xor3(a[0][1], a[3][0], m16), m30, km[17]);
  o[18] = xor3(xor3(a[0][2], a[2][1], a[3][1]), m37, km[18]);
  o[19] = xor3(xor3(a[2][2], m5, m17), m24, km[19]);
  o[20] = xor3(xor3(a[0][2], a[3][4], m31), m36, km[20]);
  o[21] = xor3(xor3(a[0][5], a[2][4], a[3][4]), m33, km[21]);
  o[22] = xor3(xor3(a[0][6], a[2][5], a[3][5]), m23, km[22]);
  o[23] = xor3(xor3(xor3(a[0][7], a[1][4], a[3][4]), m0, m9), m35, km[23]);
  o[24] = xor3(xor3(a[0][0], a[1][0], m1), m30, km[24]);
  o[25] = xor3(xor3(xor3(a[0][0], a[1][1], a[1][7]), a[3][0], m4), m5, km[25]);
  o[26] = xor3(xor3(a[0][1], a[1][2], a[3][1]), m34, km[26]);
  o[27] = xor3(xor3(xor3(a[0][2], a[2][3], a[3][2]), m3, m16), m24, km[27]);
  o[28] = xor3(xor3(xor3(a[0][3], a[1][2], a[1][7]), a[2][4], m17), m36, km[28]);
  o[29] = xor3(xor3(a[0][4], a[1][5], a[3][4]), m26, km[29]);
  o[30] = xor3(xor3(a[0][5], a[1][6], a[3][5]), m32, km[30]);
  o[31] = xor3(xor3(xor3(a[0][4], a[0][6], a[2][4]), a[3][5], m9), m28, km[31]);
// END GENERATED (inv_mix_column)
}

// InvShiftRows source of byte i: new[4c+r] = old[4((c-r)%4)+r].
__device__ __forceinline__ constexpr int isr(int i) {
  return 4 * ((i / 4 - i % 4 + 4) % 4) + i % 4;
}

// One inverse round with the InvMixColumns-folded schedule: InvSubBytes,
// InvShiftRows (register renaming), InvMixColumns unless LAST, AddRoundKey
// (km).
template <bool LAST>
__device__ __forceinline__ void aes_inv_round(uint32_t (&s)[128], const uint32_t* km) {
#pragma unroll
  for (int p = 0; p < 16; ++p) inv_sbox(&s[8 * p]);
  uint32_t o[128];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t a[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int b = 0; b < 8; ++b) a[r][b] = s[8 * isr(4 * c + r) + b];
    if (LAST) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int b = 0; b < 8; ++b) o[32 * c + 8 * r + b] = a[r][b] ^ km[32 * c + 8 * r + b];
    } else {
      inv_mix_column(a, km + 32 * c, &o[32 * c]);
    }
  }
#pragma unroll
  for (int k = 0; k < 128; ++k) s[k] = o[k];
}

// __byte_perm on the card; on the host its definition: byte i of the result
// is byte (s >> 4i) & 7 of the pair (b:a), a the low word.
__device__ __forceinline__ uint32_t byte_perm(uint32_t a, uint32_t b, uint32_t s) {
#ifdef __CUDACC__
  return __byte_perm(a, b, s);
#else
  const uint64_t v = (uint64_t)b << 32 | a;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= (uint32_t)(v >> (8 * ((s >> (4 * i)) & 7)) & 0xFFu) << (8 * i);
  return r;
#endif
}

// transpose32 (out[i] bit t = in[t] bit i), its 16- and 8-bit swap stages
// as byte permutes: a pair (a[k], a[k+16]) becomes (low halves, high
// halves), a pair (a[k], a[k+8]) (even bytes, odd bytes) interleaved; the
// 4-, 2- and 1-bit stages are transpose32's masked swaps.
__device__ __forceinline__ void transpose32_prmt(uint32_t* a) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t lo = a[k], hi = a[k + 16];
    a[k] = byte_perm(lo, hi, 0x5410);
    a[k + 16] = byte_perm(lo, hi, 0x7632);
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k & 8) continue;
    const uint32_t lo = a[k], hi = a[k + 8];
    a[k] = byte_perm(lo, hi, 0x6240);
    a[k + 8] = byte_perm(lo, hi, 0x7351);
  }
  uint32_t m = 0x0F0F0F0Fu;
#pragma unroll
  for (int j = 4; j; j >>= 1, m ^= m << j) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (k & j) continue;
      const uint32_t t = ((a[k] >> j) ^ a[k + j]) & m;
      a[k] ^= t << j;
      a[k + j] ^= t;
    }
  }
}

// ECB decrypt of one group of 32 blocks in place. On entry and on return
// s[32c + t] is word c (little-endian) of block t. kmask holds key_mask(rk,
// i) for i < 128(NR+1) of the InvMixColumns-folded decrypt schedule
// (rk_dec[0] the whitening key). The round loop is not unrolled, to keep the
// code inside the instruction cache; each round is straight-line.
template <int NR>
__device__ __forceinline__ void ecb_decrypt_group(uint32_t (&s)[128], const uint32_t* kmask) {
#pragma unroll
  for (int c = 0; c < 4; ++c) transpose32_prmt(&s[32 * c]);
#pragma unroll
  for (int k = 0; k < 128; ++k) s[k] ^= kmask[k];
#pragma unroll 1
  for (int r = 1; r < NR; ++r) aes_inv_round<false>(s, kmask + 128 * r);
  aes_inv_round<true>(s, kmask + 128 * NR);
#pragma unroll
  for (int c = 0; c < 4; ++c) transpose32_prmt(&s[32 * c]);
}

}  // namespace aes_bitslice
