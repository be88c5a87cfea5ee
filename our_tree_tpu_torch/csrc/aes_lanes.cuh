// AES encryption with a block spread over the lanes of a warp (seq.cu's lane
// forms): a lane holds one column of the state as one 32-bit word (byte r =
// row r, the block's little-endian word c), and Q lanes hold each column, so
// 4Q lanes hold a block and a warp runs 8/Q blocks side by side (seq.cu's
// forms take Q = 1, 2 and 4). The per-block bitsliced form of aes_block.cuh
// spends about 260 integer instructions of one thread on a round; here the
// lanes of a block share that work, and a round costs a lane about 80
// integer-pipe instructions at Q = 1 and about 36 at Q = 4, beside a few
// IMADs on the FMA pipe and log2(Q) + 1 shuffles (chip_smoke.py phase 9
// counts them in the SASS), so one chain of blocks takes fewer of one warp's
// issue slots.
//
//   SubBytes     a lookup held wholly in registers: the lane keeps the 256/Q
//                S-box entries whose top log2(Q) index bits equal its q (the
//                lane's place in its column) as 64/Q words, and looks up its
//                four bytes at once. The low 3 index bits pick a byte of a
//                pair of words (PRMT, one nibble of the selector a byte), the
//                next bits pick between the pair results (bit selects on
//                masks made from the index bit), and the top log2(Q) bits
//                between the lanes of the column: each lane takes its
//                partner's result (a shuffle to lane ^ 1, then ^ 2) where the
//                byte's index bit is not its own. Output byte k holds
//                S(x_pi(k)), pi = (0, 2, 1, 3), which makes the selector two
//                instructions; ShiftRows' permutes undo pi for free.
//   ShiftRows    row r of column c comes from column c + r: three shuffles
//                from the lanes of columns c + 1, c + 2, c + 3 (the same q)
//                and three PRMTs.
//   MixColumns   on the column word: t = a ^ rot8(a), then
//                a ^ xtime(t) ^ t ^ rot16(t) with xtime as a shift, a mask
//                and the byte-sign PRMT, and AddRoundKey folded in (the lane's
//                round-key words are in registers, one a round).
//
// Constant time: the S-box is in registers, written as immediates when the
// kernel starts, and picked by PRMT selectors and bit selects, which read no
// memory; the only addresses are the stream's words and the round keys, and
// every shuffle's source lane is fixed by the lane's place in its column (the
// round's public byte movement), never by key or data.
//
// Without nvcc the same code compiles as host C++ (the Warp type below holds
// the 32 lanes of a warp, and each shuffle is every lane writing, then every
// lane reading), so tests/test_torch_seq_host.py runs it with g++ against
// the JAX reference.

#pragma once

#include <cstdint>

#include "aes_block.cuh"

namespace aes_lanes {

// Word i of the AES S-box (entry 4i + b in byte b). Called with indices fixed
// at compile time, so every word is an immediate and no table is in memory.
__device__ __forceinline__ uint32_t sbox_word(int i) {
  constexpr uint32_t w[64] = {
      0x7B777C63u, 0xC56F6BF2u, 0x2B670130u, 0x76ABD7FEu, 0x7DC982CAu, 0xF04759FAu,
      0xAFA2D4ADu, 0xC072A49Cu, 0x2693FDB7u, 0xCCF73F36u, 0xF1E5A534u, 0x1531D871u,
      0xC323C704u, 0x9A059618u, 0xE2801207u, 0x75B227EBu, 0x1A2C8309u, 0xA05A6E1Bu,
      0xB3D63B52u, 0x842FE329u, 0xED00D153u, 0x5BB1FC20u, 0x39BECB6Au, 0xCF584C4Au,
      0xFBAAEFD0u, 0x85334D43u, 0x7F02F945u, 0xA89F3C50u, 0x8F40A351u, 0xF5389D92u,
      0x21DAB6BCu, 0xD2F3FF10u, 0xEC130CCDu, 0x1744975Fu, 0x3D7EA7C4u, 0x73195D64u,
      0xDC4F8160u, 0x88902A22u, 0x14B8EE46u, 0xDB0B5EDEu, 0x0A3A32E0u, 0x5C240649u,
      0x62ACD3C2u, 0x79E49591u, 0x6D37C8E7u, 0xA94ED58Du, 0xEAF4566Cu, 0x08AE7A65u,
      0x2E2578BAu, 0xC6B4A61Cu, 0x1F74DDE8u, 0x8A8BBD4Bu, 0x66B53E70u, 0x0EF60348u,
      0xB9573561u, 0x9E1DC186u, 0x1198F8E1u, 0x948ED969u, 0xE9871E9Bu, 0xDF2855CEu,
      0x0D89A18Cu, 0x6842E6BFu, 0x0F2D9941u, 0x16BB54B0u};
  return w[i];
}

// PRMT: byte n of the result is byte s[4n+2:4n] of the 8 bytes b:a, or,
// where bit 4n+3 of s is set, that byte's sign bit in all 8 bits.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
#else
  const uint64_t v = ((uint64_t)b << 32) | a;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n) {
    const uint32_t nib = (s >> (4 * n)) & 15;
    uint32_t byte = (uint32_t)(v >> (8 * (nib & 7))) & 0xFF;
    if (nib & 8) byte = byte & 0x80 ? 0xFF : 0;
    r |= byte << (8 * n);
  }
  return r;
#endif
}

// High 32 bits of a * b (IMAD.HI, on the FMA pipe).
__device__ __forceinline__ uint32_t mulhi(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

#ifdef __CUDACC__
__device__ __forceinline__ uint32_t shfl(uint32_t v, uint32_t src) {
  return __shfl_sync(0xFFFFFFFFu, v, (int)src);
}
__device__ __forceinline__ uint32_t shfl_xor(uint32_t v, int m) {
  return __shfl_xor_sync(0xFFFFFFFFu, v, m);
}
#else
// The 32 lanes of a warp on the host, in lockstep: every operation acts on
// each lane's word, and a shuffle reads what every lane held before it.
struct Warp {
  uint32_t v[32];
  Warp() : v{} {}
  Warp(uint32_t x) {  // the same word in every lane  // NOLINT: implicit
    for (uint32_t& w : v) w = x;
  }
};
#define OT_WARP_OP(op)                                         \
  inline Warp operator op(const Warp& a, const Warp& b) {      \
    Warp r;                                                    \
    for (int l = 0; l < 32; ++l) r.v[l] = a.v[l] op b.v[l];    \
    return r;                                                  \
  }
OT_WARP_OP(^)
OT_WARP_OP(&)
OT_WARP_OP(|)
OT_WARP_OP(+)
OT_WARP_OP(-)
OT_WARP_OP(*)
#undef OT_WARP_OP
inline Warp operator~(const Warp& a) {
  Warp r;
  for (int l = 0; l < 32; ++l) r.v[l] = ~a.v[l];
  return r;
}
inline Warp operator>>(const Warp& a, int k) {
  Warp r;
  for (int l = 0; l < 32; ++l) r.v[l] = a.v[l] >> k;
  return r;
}
inline Warp prmt(const Warp& a, const Warp& b, const Warp& s) {
  Warp r;
  for (int l = 0; l < 32; ++l) r.v[l] = prmt(a.v[l], b.v[l], s.v[l]);
  return r;
}
inline Warp mulhi(const Warp& a, const Warp& b) {
  Warp r;
  for (int l = 0; l < 32; ++l) r.v[l] = mulhi(a.v[l], b.v[l]);
  return r;
}
inline Warp shfl(const Warp& v, const Warp& src) {
  Warp r;
  for (int l = 0; l < 32; ++l) r.v[l] = v.v[src.v[l] & 31];
  return r;
}
inline Warp shfl_xor(const Warp& v, int m) {
  Warp r;
  for (int l = 0; l < 32; ++l) r.v[l] = v.v[l ^ m];
  return r;
}
#endif

// log2 of Q, the lanes of a column (a power of two up to 8).
template <int Q>
struct Log2 {
  static constexpr int value = Q >= 8 ? 3 : Q >= 4 ? 2 : Q >= 2 ? 1 : 0;
};

// Bits of b where m is set, of a elsewhere (one LOP3).
template <class W>
__device__ __forceinline__ W bit_select(W m, W b, W a) {
  return (b & m) | (a & ~m);
}

// Byte k is 0xFF where bit j of byte pi(k) of x is set: the sign bytes of x
// shifted left by 7 - j (a multiply), picked in pi's order.
template <class W>
__device__ __forceinline__ W index_bit_mask(W x, int j) {
  return prmt(j == 7 ? x : x * W(1u << (7 - j)), W(0u), W(0xB9A8u));
}

// What a lane keeps for its place in the block: its part of the S-box, one
// mask a lane step of SubBytes (all ones where its bit of q is 1), and the
// lanes that hold its row 1-3 bytes' columns after SubBytes.
template <int Q, class W>
struct Lane {
  static constexpr int kLog = Log2<Q>::value;
  W table[64 / Q];
  W own[kLog > 0 ? kLog : 1];
  W src[3];
};

// The lane set-up for lane id `lane` (0-31): lane 4Q g + Q c + q holds column
// c of the warp's block g, q its place among the column's Q lanes.
template <int Q, class W>
__device__ __forceinline__ void lane_setup(W lane, Lane<Q, W>& l) {
  constexpr int kLog = Log2<Q>::value;
  const W q = lane & W(Q - 1);
  W pick[Q];  // all ones in the lane whose q is k
#pragma unroll
  for (int k = 0; k < Q; ++k) pick[k] = W(0u) - (((q ^ W(k)) - W(1u)) >> 31);
#pragma unroll
  for (int i = 0; i < 64 / Q; ++i) {
    W t = W(sbox_word(i)) & pick[0];
#pragma unroll
    for (int k = 1; k < Q; ++k) t = t | (W(sbox_word(k * (64 / Q) + i)) & pick[k]);
    l.table[i] = t;
  }
  l.own[0] = W(0u);
#pragma unroll
  for (int s = 0; s < kLog; ++s) l.own[s] = W(0u) - ((lane >> s) & W(1u));
  const W base = lane & W(~(4u * Q - 1));
  const W col = (lane >> kLog) & W(3u);
#pragma unroll
  for (int r = 1; r < 4; ++r) l.src[r - 1] = base | (((col + W(r)) & W(3u)) * W(Q)) | q;
}

// SubBytes of the column word x: byte k of the result is S(byte pi(k) of x),
// the same in the Q lanes of the column.
template <int Q, class W>
__device__ __forceinline__ W sub_bytes(W x, const Lane<Q, W>& l) {
  constexpr int kLog = Log2<Q>::value;
  constexpr int kPairs = 32 / Q;
  constexpr int kLevels = 5 - kLog;  // index bits 3 .. 7 - kLog, in the lane
  // Selector nibble k = the low 3 bits of byte pi(k): bytes 0 and 1 in place,
  // bytes 2 and 3 moved down 12 bits onto nibbles 1 and 3.
  const W a = x & W(0x07070707u);
  const W sel = a + mulhi(a, W(1u << 20));
  W c[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) c[p] = prmt(l.table[2 * p], l.table[2 * p + 1], sel);
  // Level lv halves the candidates by index bit 3 + lv. The inner loop's trip
  // count is fixed, so it unrolls before the outer one and every index of c
  // is a constant (c stays in registers).
#pragma unroll
  for (int lv = 0; lv < kLevels; ++lv) {
    const W m = index_bit_mask(x, 3 + lv);
#pragma unroll
    for (int i = 0; i < kPairs / 2; ++i)
      if (i < (kPairs >> (lv + 1))) c[i] = bit_select(m, c[2 * i + 1], c[2 * i]);
  }
#pragma unroll
  for (int s = 0; s < kLog; ++s) {
    const W swap = index_bit_mask(x, 8 - kLog + s) ^ l.own[s];
    c[0] = bit_select(swap, shfl_xor(c[0], 1 << s), c[0]);
  }
  return c[0];
}

// ShiftRows of SubBytes' output s (bytes in pi's order): row r of the
// column is byte pi(r) of the word of column c + r's lane (the same q).
template <int Q, class W>
__device__ __forceinline__ W shift_rows(W s, const Lane<Q, W>& l) {
  const W w1 = shfl(s, l.src[0]), w2 = shfl(s, l.src[1]), w3 = shfl(s, l.src[2]);
  return prmt(prmt(s, w1, W(0x3260u)), prmt(w2, w3, W(0x7100u)), W(0x7610u));
}

// MixColumns of the column word y, then AddRoundKey k: t = a ^ a_(r+1),
// out = a ^ xtime(t) ^ t ^ t_(r+2) ^ k.
template <class W>
__device__ __forceinline__ W mix_column_key(W y, W k) {
  const W t = y ^ prmt(y, y, W(0x0321u));
  const W u = ((t * W(2u)) & W(0xFEFEFEFEu)) ^ t;
  const W v = (prmt(t, W(0u), W(0xBA98u)) & W(0x1B1B1B1Bu)) ^ prmt(t, t, W(0x1032u));
  return u ^ v ^ (y ^ k);
}

// AES encrypt of the column word x of a block under k, the lane's NR + 1
// round-key words (word c of each round key). The rounds are unrolled, so
// the key words stay in registers.
template <int NR, int Q, class W>
__device__ __forceinline__ W encrypt_column(W x, const Lane<Q, W>& l, const W (&k)[NR + 1]) {
  x = x ^ k[0];
#pragma unroll
  for (int r = 1; r < NR; ++r) x = mix_column_key(shift_rows(sub_bytes(x, l), l), k[r]);
  return shift_rows(sub_bytes(x, l), l) ^ k[NR];
}

// One step of a chained encrypt: CBC, E(p ^ c), or with CFB, CFB128,
// p ^ E(c); c the previous ciphertext's column word.
template <int NR, int CFB, int Q, class W>
__device__ __forceinline__ W chain_step(W p, W c, const Lane<Q, W>& l, const W (&k)[NR + 1]) {
  return CFB ? p ^ encrypt_column<NR>(c, l, k) : encrypt_column<NR>(p ^ c, l, k);
}

}  // namespace aes_lanes
