// Bitsliced AES-CTR arithmetic of the ctr_gen kernel (ctr_gen.cu): the
// keystream of one group of 32 consecutive counter blocks, held as 128 bit
// planes in registers (plane 8p+b = bit b of state byte p, lane bit t = block
// t of the group). Its only memory reads are the base counter and the round-key
// masks, at addresses fixed by the round and plane number.
//
// Without nvcc the same code compiles as host C++, so the CPU tests run it
// against the plain torch version (tests/test_torch_ctr_host.py).

#pragma once

#include <cstdint>

#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#endif

namespace ctr_gen {

// Bit t of iota_mask(q) is bit q of t: bits 0..4 of the block index within a group.
__device__ __forceinline__ constexpr uint32_t iota_mask(int q) {
  return q == 0 ? 0xAAAAAAAAu : q == 1 ? 0xCCCCCCCCu : q == 2 ? 0xF0F0F0F0u
       : q == 3 ? 0xFF00FF00u : 0xFFFF0000u;
}

// Full-lane mask of schedule bit i = 128r + 8p + b: bit b of byte p of round
// key r, where byte p is byte p%4 (little-endian) of word 4r + p/4.
__device__ __forceinline__ uint32_t key_mask(const uint32_t* rk, int i) {
  const int r = i >> 7, p = (i >> 3) & 15, b = i & 7;
  return 0u - ((rk[4 * r + (p >> 2)] >> (8 * (p & 3) + b)) & 1u);
}

// Boyar-Peralta forward S-box on one byte's planes x[0..7] (LSB first), in
// place: 115 two-input gates (32 AND, 83 XOR) and four NOTs for the 0x63.
__device__ __forceinline__ void sbox_bp(uint32_t* x) {
  const uint32_t u0 = x[7], u1 = x[6], u2 = x[5], u3 = x[4];
  const uint32_t u4 = x[3], u5 = x[2], u6 = x[1], u7 = x[0];
  const uint32_t y14 = u3 ^ u5, y13 = u0 ^ u6, y9 = u0 ^ u3, y8 = u0 ^ u5;
  const uint32_t t0 = u1 ^ u2, y1 = t0 ^ u7, y4 = y1 ^ u3, y12 = y13 ^ y14;
  const uint32_t y2 = y1 ^ u0, y5 = y1 ^ u6, y3 = y5 ^ y8, t1 = u4 ^ y12;
  const uint32_t y15 = t1 ^ u5, y20 = t1 ^ u1, y6 = y15 ^ u7, y10 = y15 ^ t0;
  const uint32_t y11 = y20 ^ y9, y7 = u7 ^ y11, y17 = y10 ^ y11, y19 = y10 ^ y8;
  const uint32_t y16 = t0 ^ y11, y21 = y13 ^ y16, y18 = u0 ^ y16;
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
  const uint32_t t46 = z15 ^ z16, t47 = z10 ^ z11, t48 = z5 ^ z13, t49 = z9 ^ z10;
  const uint32_t t50 = z2 ^ z12, t51 = z2 ^ z5, t52 = z7 ^ z8, t53 = z0 ^ z3;
  const uint32_t t54 = z6 ^ z7, t55 = z16 ^ z17, t56 = z12 ^ t48, t57 = t50 ^ t53;
  const uint32_t t58 = z4 ^ t46, t59 = z3 ^ t54, t60 = t46 ^ t57, t61 = z14 ^ t57;
  const uint32_t t62 = t52 ^ t58, t63 = t49 ^ t58, t64 = z4 ^ t59, t65 = t61 ^ t62;
  const uint32_t t66 = z1 ^ t63, s0 = t59 ^ t63, s6 = t56 ^ t62, s7 = t48 ^ t60;
  const uint32_t t67 = t64 ^ t65, s3 = t53 ^ t66, s4 = t51 ^ t66, s5 = t47 ^ t65;
  const uint32_t s1 = t64 ^ s3, s2 = t55 ^ t67;
  // Outputs LSB first, with the affine constant 0x63 (bits 0, 1, 5, 6).
  x[0] = ~s7; x[1] = ~s6; x[2] = s5; x[3] = s4;
  x[4] = s3;  x[5] = ~s2; x[6] = ~s1; x[7] = s0;
}

// ShiftRows source of byte i: new[4c+r] = old[4((c+r)%4)+r].
__device__ __forceinline__ constexpr int sr(int i) {
  return 4 * ((i / 4 + i % 4) % 4) + i % 4;
}

// One round: SubBytes, ShiftRows, MixColumns unless LAST, AddRoundKey (km).
template <bool LAST>
__device__ __forceinline__ void aes_round(uint32_t (&s)[128], const uint32_t* km) {
#pragma unroll
  for (int p = 0; p < 16; ++p) sbox_bp(&s[8 * p]);
  uint32_t o[128];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (LAST) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int b = 0; b < 8; ++b)
          o[8 * (4 * c + r) + b] = s[8 * sr(4 * c + r) + b] ^ km[8 * (4 * c + r) + b];
    } else {
      // t_r = a_r ^ a_(r+1); out_r = xt(t_r) ^ t_r ^ t_(r+2) ^ a_r.
      uint32_t t[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int b = 0; b < 8; ++b)
          t[r][b] = s[8 * sr(4 * c + r) + b] ^ s[8 * sr(4 * c + (r + 1) % 4) + b];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t* tr = t[r];
        // xtime over planes: x^8 = x^4 + x^3 + x + 1.
        const uint32_t xt[8] = {tr[7], tr[0] ^ tr[7], tr[1], tr[2] ^ tr[7],
                                tr[3] ^ tr[7], tr[4], tr[5], tr[6]};
        const int i = 4 * c + r;
#pragma unroll
        for (int b = 0; b < 8; ++b)
          o[8 * i + b] = xt[b] ^ tr[b] ^ t[(r + 2) % 4][b] ^ s[8 * sr(i) + b] ^ km[8 * i + b];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 128; ++k) s[k] = o[k];
}

// In-place 32x32 bit transpose of a[0..31]: out[i] bit t = in[t] bit i.
__device__ __forceinline__ void transpose32(uint32_t* a) {
  uint32_t m = 0x0000FFFFu;
#pragma unroll
  for (int j = 16; j; j >>= 1, m ^= m << j) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (k & j) continue;
      const uint32_t t = ((a[k] >> j) ^ a[k + j]) & m;
      a[k] ^= t << j;
      a[k + j] ^= t;
    }
  }
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
