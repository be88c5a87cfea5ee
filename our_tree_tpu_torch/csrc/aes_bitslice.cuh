// Bitsliced AES arithmetic shared by the port's kernels (ctr_gen.cu, ecb.cu,
// ctr_mk.cu):
// the state of one group of 32 blocks held as 128 bit planes in registers
// (plane 8p+b = bit b of state byte p, lane bit t = block t of the group).
// Every function here reads memory only at addresses fixed by the round and
// plane number (the round-key masks) or by the public slot vector (the
// per-block schedules), never at one that depends on key or data.
//
// Without nvcc the same code compiles as host C++, so the CPU tests run it
// against the plain torch version (tests/test_torch_ctr_host.py,
// tests/test_torch_ecb_host.py, tests/test_torch_mk_host.py).

#pragma once

#include <cstdint>

#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#endif

namespace aes_bitslice {

// Full-lane mask of schedule bit i = 128r + 8p + b: bit b of byte p of round
// key r, where byte p is byte p%4 (little-endian) of word 4r + p/4.
__device__ __forceinline__ uint32_t key_mask(const uint32_t* rk, int i) {
  const int r = i >> 7, p = (i >> 3) & 15, b = i & 7;
  return 0u - ((rk[4 * r + (p >> 2)] >> (8 * (p & 3) + b)) & 1u);
}

// Boyar-Peralta forward S-box core on one byte's planes x[0..7] (LSB first),
// in place: 115 two-input gates (32 AND, 83 XOR). With AFFINE the four NOTs
// of the 0x63 constant follow (the S-box); without, the output is the S-box
// XOR 0x63, the linear part of the affine map applied to the field inverse.
template <bool AFFINE>
__device__ __forceinline__ void sbox_bp_circuit(uint32_t* x) {
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
  // Outputs LSB first; the affine constant 0x63 is bits 0, 1, 5, 6.
  if (AFFINE) {
    x[0] = ~s7; x[1] = ~s6; x[2] = s5; x[3] = s4;
    x[4] = s3;  x[5] = ~s2; x[6] = ~s1; x[7] = s0;
  } else {
    x[0] = s7; x[1] = s6; x[2] = s5; x[3] = s4;
    x[4] = s3; x[5] = s2; x[6] = s1; x[7] = s0;
  }
}

// Forward S-box on one byte's planes, in place.
__device__ __forceinline__ void sbox_bp(uint32_t* x) { sbox_bp_circuit<true>(x); }

// A^-1, the linear part of the inverse affine map, on planes:
// A^-1(x) = rotl(x, 1) ^ rotl(x, 3) ^ rotl(x, 6), so out bit i is
// x[i-1] ^ x[i-3] ^ x[i-6] (indices mod 8). 16 XORs.
__device__ __forceinline__ void inv_affine_linear(uint32_t* x) {
  uint32_t y[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = x[(i + 7) & 7] ^ x[(i + 5) & 7] ^ x[(i + 2) & 7];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = y[i];
}

// Inverse S-box on one byte's planes, in place, by conjugating the forward
// core: InvS(x) = A^-1(core(A^-1(x) ^ 0x05)), where core(z) = A(z^-1) is the
// Boyar-Peralta circuit without its 0x63 and A^-1(0x63) = 0x05. 115 gates of
// the core, 32 XORs of the two linear layers and two NOTs (planes 0 and 2).
__device__ __forceinline__ void inv_sbox_bp(uint32_t* x) {
  inv_affine_linear(x);
  x[0] = ~x[0];
  x[2] = ~x[2];
  sbox_bp_circuit<false>(x);
  inv_affine_linear(x);
}

// ShiftRows source of byte i: new[4c+r] = old[4((c+r)%4)+r].
__device__ __forceinline__ constexpr int sr(int i) {
  return 4 * ((i / 4 + i % 4) % 4) + i % 4;
}

// InvShiftRows source of byte i: new[4c+r] = old[4((c-r)%4)+r].
__device__ __forceinline__ constexpr int isr(int i) {
  return 4 * ((i / 4 - i % 4 + 4) % 4) + i % 4;
}

// xtime over planes: x^8 = x^4 + x^3 + x + 1.
__device__ __forceinline__ void xtime(const uint32_t* t, uint32_t* o) {
  o[0] = t[7]; o[1] = t[0] ^ t[7]; o[2] = t[1]; o[3] = t[2] ^ t[7];
  o[4] = t[3] ^ t[7]; o[5] = t[4]; o[6] = t[5]; o[7] = t[6];
}

// MixColumns of one column a[r][b] (row r, bit b) plus AddRoundKey, into
// o[8r + b]: t_r = a_r ^ a_(r+1); out_r = xt(t_r) ^ t_r ^ t_(r+2) ^ a_r ^ k_r.
// Without KEYED the key term is left out (km is not read).
template <bool KEYED = true>
__device__ __forceinline__ void mix_column(const uint32_t (&a)[4][8], const uint32_t* km,
                                           uint32_t* o) {
  uint32_t t[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int b = 0; b < 8; ++b) t[r][b] = a[r][b] ^ a[(r + 1) % 4][b];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t xt[8];
    xtime(t[r], xt);
#pragma unroll
    for (int b = 0; b < 8; ++b)
      o[8 * r + b] = xt[b] ^ t[r][b] ^ t[(r + 2) % 4][b] ^ a[r][b] ^ (KEYED ? km[8 * r + b] : 0u);
  }
}

// One round: SubBytes, ShiftRows, MixColumns unless LAST, AddRoundKey (km).
// Without KEYED the AddRoundKey is left to the caller (km is not read).
template <bool LAST, bool KEYED = true>
__device__ __forceinline__ void aes_round(uint32_t (&s)[128], const uint32_t* km) {
#pragma unroll
  for (int p = 0; p < 16; ++p) sbox_bp(&s[8 * p]);
  uint32_t o[128];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t a[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int b = 0; b < 8; ++b) a[r][b] = s[8 * sr(4 * c + r) + b];
    if (LAST) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int b = 0; b < 8; ++b)
          o[32 * c + 8 * r + b] = a[r][b] ^ (KEYED ? km[32 * c + 8 * r + b] : 0u);
    } else {
      mix_column<KEYED>(a, KEYED ? km + 32 * c : km, &o[32 * c]);
    }
  }
#pragma unroll
  for (int k = 0; k < 128; ++k) s[k] = o[k];
}

// One inverse round with the InvMixColumns-folded schedule: InvSubBytes,
// InvShiftRows, InvMixColumns unless LAST, AddRoundKey (km). InvMixColumns
// is MixColumns of d_r = a_r ^ 4(a_r ^ a_(r+2)); a_r ^ a_(r+2) takes two
// values per column (r = 0, 1), and x4 is two xtimes.
template <bool LAST>
__device__ __forceinline__ void aes_inv_round(uint32_t (&s)[128], const uint32_t* km) {
#pragma unroll
  for (int p = 0; p < 16; ++p) inv_sbox_bp(&s[8 * p]);
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
      uint32_t f[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t t[8], x2[8];
#pragma unroll
        for (int b = 0; b < 8; ++b) t[b] = a[h][b] ^ a[h + 2][b];
        xtime(t, x2);
        xtime(x2, f[h]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int b = 0; b < 8; ++b) a[r][b] ^= f[r & 1][b];
      mix_column(a, km + 32 * c, &o[32 * c]);
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

// ECB of one group of 32 blocks in place. On entry and on return s[32c + t]
// is word c (little-endian) of block t. kmask holds key_mask(rk, i) for
// i < 128(NR+1): the encrypt schedule for the forward direction, the
// InvMixColumns-folded decrypt schedule (rk_dec[0] the whitening key) for
// DECRYPT. The column transposes turn words into planes: after them,
// s[32c + 8a + b] is bit b of byte 4c + a, i.e. plane 8p + b.
template <int NR, bool DECRYPT>
__device__ __forceinline__ void ecb_group(uint32_t (&s)[128], const uint32_t* kmask) {
#pragma unroll
  for (int c = 0; c < 4; ++c) transpose32(&s[32 * c]);
#pragma unroll
  for (int k = 0; k < 128; ++k) s[k] ^= kmask[k];
  // The round loop is not unrolled, to keep the code inside the instruction
  // cache; each round is straight-line.
#pragma unroll 1
  for (int r = 1; r < NR; ++r) {
    if (DECRYPT) aes_inv_round<false>(s, kmask + 128 * r);
    else aes_round<false>(s, kmask + 128 * r);
  }
  if (DECRYPT) aes_inv_round<true>(s, kmask + 128 * NR);
  else aes_round<true>(s, kmask + 128 * NR);
#pragma unroll
  for (int c = 0; c < 4; ++c) transpose32(&s[32 * c]);
}

// ---------------------------------------------------------------------------
// Per-block keys (ctr_mk.cu). A group's 32 blocks may each use one of K
// schedules, kept as words (row stride 4*(NR+1)). Round r's key planes are
// the transpose of the 32 blocks' round-r words (bitslice.multikey_planes in
// the plain version): plane 32c + j is bit j of word c of each block's round
// key, lane t = block t. The slot vector that picks each block's schedule is
// public batch layout, so reading a schedule at a slot-dependent offset and
// branching on whether a group's slots are all equal leak nothing of key or
// data.

// Round r's key planes for a group whose 32 blocks share one schedule rk:
// full-lane masks of its words, made on the fly (bit j shifted up to the sign
// bit, then arithmetically back across the word: two shifts a plane).
__device__ __forceinline__ void add_round_key_uniform(uint32_t (&s)[128], const uint32_t* rk,
                                                      int r) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t w = rk[4 * r + c];
#pragma unroll
    for (int j = 0; j < 32; ++j) s[32 * c + j] ^= (uint32_t)((int32_t)(w << (31 - j)) >> 31);
  }
}

// Round r's key planes for a group whose blocks' schedules differ: block t's
// schedule starts at word off[t * stride] of rks. One column at a time, the
// 32 blocks' round-r words are gathered, transposed into 32 planes and XORed
// into the state, so only 32 key words are live at once. The offsets are read
// through a volatile pointer, every round: hoisted out of the round loop,
// their 32 loop-invariant values spilled the state to local memory.
__device__ __forceinline__ void add_round_key_mixed(uint32_t (&s)[128], const uint32_t* rks,
                                                    const volatile uint16_t* off, int stride,
                                                    int r) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t kw[32];
#pragma unroll
    for (int t = 0; t < 32; ++t) kw[t] = rks[off[t * stride] + 4 * r + c];
    transpose32(kw);
#pragma unroll
    for (int j = 0; j < 32; ++j) s[32 * c + j] ^= kw[j];
  }
}

// Round r's key planes: full-lane masks of the schedule at off0 when UNIFORM,
// per-block planes from the schedules at off[t * stride] otherwise.
template <bool UNIFORM>
__device__ __forceinline__ void add_round_key_mk(uint32_t (&s)[128], const uint32_t* rks,
                                                 uint32_t off0, const volatile uint16_t* off,
                                                 int stride, int r) {
  if (UNIFORM) add_round_key_uniform(s, rks + off0, r);
  else add_round_key_mixed(s, rks, off, stride, r);
}

// AES encrypt of one group of 32 blocks in place, block t under the schedule
// at word offset off[t * stride] of rks. On entry and on return s[32c + t] is
// word c (little-endian) of block t. UNIFORM says every block uses the
// schedule at offset off0 (then off is not read): full-lane key masks,
// otherwise per-block key planes. A separate instantiation per key form
// keeps the branch out of the round loop, so each form gets its own register
// allocation. The round loop is rolled, each round straight-line.
template <int NR, bool UNIFORM>
__device__ __forceinline__ void mk_encrypt_group(uint32_t (&s)[128], const uint32_t* rks,
                                                 uint32_t off0, const volatile uint16_t* off,
                                                 int stride) {
#pragma unroll
  for (int c = 0; c < 4; ++c) transpose32(&s[32 * c]);
  add_round_key_mk<UNIFORM>(s, rks, off0, off, stride, 0);
#pragma unroll 1
  for (int r = 1; r < NR; ++r) {
    aes_round<false, false>(s, nullptr);
    add_round_key_mk<UNIFORM>(s, rks, off0, off, stride, r);
  }
  aes_round<true, false>(s, nullptr);
  add_round_key_mk<UNIFORM>(s, rks, off0, off, stride, NR);
#pragma unroll
  for (int c = 0; c < 4; ++c) transpose32(&s[32 * c]);
}

}  // namespace aes_bitslice
