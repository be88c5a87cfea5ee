// Per-block bitsliced AES arithmetic (seq.cu, the block form of ctr_mk.cu):
// one thread holds one 16-byte block as 8 bit planes in 8 registers. Plane b
// holds bit b of each state byte, lane p = byte p of the block in memory
// order, so lane 4c + r is row r of column c. Each plane's 16 lanes are kept
// twice, in bits 0-15 and again in bits 16-31: a rotation of the 16 lanes is
// then one 32-bit rotate, and every operation below keeps the two copies
// equal. Where aes_bitslice.cuh's group form does 32 blocks per logic
// instruction and pays off only with thousands of groups, this form has one
// block's work per thread and the shortest path through a block: the
// sequential CBC/CFB128 encrypts and the serve rungs (at most 128 groups)
// are bound by that path, not by issue slots.
//
//   SubBytes     aes_bitslice::sbox_bp_circuit<true> on the 8 planes (the
//                Boyar-Peralta circuit the group form runs, reused).
//   ShiftRows    row r rotates its four columns by r: with lane 4c + r that
//                is a rotate of the plane by 4r, masked to row r's lanes.
//   MixColumns   a_(r+1) and a_(r+2) are 1- and 2-lane rotates inside each
//                nibble (a column is a nibble); xtime is plane renaming plus
//                three XORs.
//   AddRoundKey  8 XORs with the round key's planes, made once per thread
//                block by round_key_planes.
//   pack/unpack  two 8x8 bit transposes (bytes 0-7 and 8-15) and byte
//                permutes between uint4 LE words and planes.
//
// Constant time: no tables, and no address that depends on key or data (the
// callers read key planes at offsets fixed by the round and the public slot).
// Without nvcc the same code compiles as host C++ (the shims below), so
// tests/test_torch_seq_host.py runs it against the plain torch version.

#pragma once

#include <cstdint>

#include "aes_bitslice.cuh"

#ifndef __CUDACC__
struct uint4 {
  uint32_t x, y, z, w;
};
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return {x, y, z, w}; }
#endif

namespace aes_block {

// 32-bit rotate right by k (0 < k < 32).
__device__ __forceinline__ uint32_t rotr(uint32_t x, int k) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(x, x, k);
#else
  return (x >> k) | (x << (32 - k));
#endif
}

// Byte n of the result is byte s[4n+2:4n] of the 8 bytes y:x (PRMT).
__device__ __forceinline__ uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#ifdef __CUDA_ARCH__
  return __byte_perm(x, y, s);
#else
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n) r |= (uint32_t)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n);
  return r;
#endif
}

// 8x8 bit transpose of a 64-bit value: bit 8p + b moves to bit 8b + p
// (three delta swaps); an involution.
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  x ^= t ^ (t << 28);
  return x;
}

// uint4 LE words -> planes: p[b] lane q (bits q and 16 + q) = bit b of byte q.
__device__ __forceinline__ void pack(uint4 w, uint32_t (&p)[8]) {
  // After the transposes byte b of lo (hi) holds bit b of bytes 0-7 (8-15).
  const uint64_t lo = transpose8(((uint64_t)w.y << 32) | w.x);
  const uint64_t hi = transpose8(((uint64_t)w.w << 32) | w.z);
  const uint32_t l0 = (uint32_t)lo, l1 = (uint32_t)(lo >> 32);
  const uint32_t h0 = (uint32_t)hi, h1 = (uint32_t)(hi >> 32);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t sel = b | (4 + b) << 4 | b << 8 | (4 + b) << 12;
    p[b] = byte_perm(l0, h0, sel);
    p[4 + b] = byte_perm(l1, h1, sel);
  }
}

// Planes -> uint4 LE words (pack's inverse; reads bits 0-15 of each plane).
__device__ __forceinline__ uint4 unpack(const uint32_t (&p)[8]) {
  uint32_t l[2], h[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // [p0.b0, p1.b0, p0.b1, p1.b1] and the same for planes 2 and 3.
    const uint32_t a = byte_perm(p[4 * half], p[4 * half + 1], 0x5140);
    const uint32_t c = byte_perm(p[4 * half + 2], p[4 * half + 3], 0x5140);
    l[half] = byte_perm(a, c, 0x5410);
    h[half] = byte_perm(a, c, 0x7632);
  }
  const uint64_t lo = transpose8(((uint64_t)l[1] << 32) | l[0]);
  const uint64_t hi = transpose8(((uint64_t)h[1] << 32) | h[0]);
  return make_uint4((uint32_t)lo, (uint32_t)(lo >> 32), (uint32_t)hi, (uint32_t)(hi >> 32));
}

// ShiftRows of one plane: new lane 4c + r = old lane 4((c + r) % 4) + r,
// i.e. row r (lanes r, r+4, r+8, r+12) rotated by 4r lanes.
__device__ __forceinline__ uint32_t shift_rows(uint32_t x) {
  return (x & 0x11111111u) | (rotr(x, 4) & 0x22222222u) | (rotr(x, 8) & 0x44444444u) |
         (rotr(x, 12) & 0x88888888u);
}

// Lane 4c + r <- lane 4c + (r + 1) % 4 and 4c + (r + 2) % 4: the next rows
// of the same column.
__device__ __forceinline__ uint32_t next_row(uint32_t x) {
  return ((x >> 1) & 0x77777777u) | ((x << 3) & 0x88888888u);
}
__device__ __forceinline__ uint32_t row_after_next(uint32_t x) {
  return ((x >> 2) & 0x33333333u) | ((x << 2) & 0xCCCCCCCCu);
}

// MixColumns on planes, in place: t_r = a_r ^ a_(r+1);
// out_r = xt(t_r) ^ t_r ^ t_(r+2) ^ a_r, as aes_bitslice::mix_column.
__device__ __forceinline__ void mix_columns(uint32_t (&s)[8]) {
  uint32_t t[8], xt[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) t[b] = s[b] ^ next_row(s[b]);
  aes_bitslice::xtime(t, xt);
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] ^= xt[b] ^ t[b] ^ row_after_next(t[b]);
}

// One round: SubBytes, ShiftRows, MixColumns unless LAST, AddRoundKey (k:
// the round's 8 key planes).
template <bool LAST>
__device__ __forceinline__ void block_round(uint32_t (&s)[8], const uint32_t* k) {
  aes_bitslice::sbox_bp_circuit<true>(s);
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] = shift_rows(s[b]);
  if (!LAST) mix_columns(s);
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] ^= k[b];
}

// Round r's key planes from a 4*(NR+1)-word schedule: pack of its words.
__device__ __forceinline__ void round_key_planes(const uint32_t* rk, int r, uint32_t* kp) {
  uint32_t p[8];
  pack(make_uint4(rk[4 * r], rk[4 * r + 1], rk[4 * r + 2], rk[4 * r + 3]), p);
#pragma unroll
  for (int b = 0; b < 8; ++b) kp[b] = p[b];
}

// AES encrypt of one block's planes in place under kp, the (NR+1)*8 key
// planes (round r at kp + 8r). The round loop is rolled, each round
// straight-line, so the code stays in the instruction cache.
template <int NR>
__device__ __forceinline__ void encrypt_block(uint32_t (&s)[8], const uint32_t* kp) {
#pragma unroll
  for (int b = 0; b < 8; ++b) s[b] ^= kp[b];
#pragma unroll 1
  for (int r = 1; r < NR; ++r) block_round<false>(s, kp + 8 * r);
  block_round<true>(s, kp + 8 * NR);
}

// One chained encrypt over a stream of n blocks: CBC, C_i = E(P_i ^ C_(i-1)),
// or with CFB, CFB128, C_i = P_i ^ E(C_(i-1)); C_(-1) = iv. Writes every C_i
// and returns the last (iv when n = 0). The chain stays in planes from block
// to block. The next block's load is issued before this block's rounds, so
// it is in flight while they run; stores are not waited on.
template <int NR, int CFB>
__device__ __forceinline__ uint4 chain_stream(const uint4* in, uint4* out, long long n, uint4 iv,
                                              const uint32_t* kp) {
  if (n <= 0) return iv;
  uint32_t c[8];
  pack(iv, c);
  uint4 next = in[0];
#pragma unroll 1
  for (long long i = 0; i < n; ++i) {
    uint32_t p[8];
    pack(next, p);
    if (i + 1 < n) next = in[i + 1];
    if (CFB) {
      encrypt_block<NR>(c, kp);
#pragma unroll
      for (int b = 0; b < 8; ++b) c[b] ^= p[b];
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b) c[b] ^= p[b];
      encrypt_block<NR>(c, kp);
    }
    out[i] = unpack(c);
  }
  return unpack(c);
}

// CTR on one block: data ^ E(ctr) under the key planes kp.
template <int NR>
__device__ __forceinline__ uint4 ctr_block(uint4 ctr, uint4 data, const uint32_t* kp) {
  uint32_t s[8];
  pack(ctr, s);
  encrypt_block<NR>(s, kp);
  const uint4 k = unpack(s);
  return make_uint4(data.x ^ k.x, data.y ^ k.y, data.z ^ k.z, data.w ^ k.w);
}

}  // namespace aes_block
