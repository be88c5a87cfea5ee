// The arithmetic of the GHASH kernels (ghash.cu): multiplication in GCM's
// field GF(2^128) on integer multiplies, the affine step of the segmented
// Horner recurrence, the composition of two steps, and a chunk of rows run
// either way.
//
// Elements come in as 4 u32 words in the word-bit basis, the dispatch
// layout: a block's 16 bytes as little-endian words, word-bit k being bit
// k % 8 of byte k / 8. GCM's element is the block's bytes read as a
// big-endian int in the reflected bit order, so word-bit k is the
// coefficient of x^(k ^ 7). The polynomial basis (bit p of the 128-bit
// value, in word p / 32, is the coefficient of x^p) is the same words with
// the bits of each byte reversed (flip, a bit reverse and a byte permute).
// Everything below works in the polynomial basis: a row's x is flipped once
// on load and its y once on store, and the maps and states that pass
// between launches stay in the polynomial basis.
//
// The product (mul): a 128 x 128 -> 256-bit carry-less multiply, then the
// reduction mod P = x^128 + x^7 + x^2 + x + 1.
//  * A 32 x 32 -> 64-bit carry-less product is 16 integer products
//    (uint64_t)a * b, which nvcc issues as IMAD.WIDE.U32 on the FMA pipe:
//    each operand is split into its bits at positions = i mod 4 (masks
//    0x11111111 << i), so an integer product of two parts has its terms 4
//    positions apart; at most 8 terms meet at a position, the count's
//    carries stay below the next position of the same class, and the
//    product's bit at a position of class (i + j) mod 4 is the carry-less
//    one. Two products whose counts peak 4 positions apart sum to at most
//    15 terms a position, so those pairs share one IMAD.WIDE (the add is
//    its addend); the four classes are masked out and merged.
//  * Karatsuba over 32-bit limbs: 9 such products for 128 x 128.
//  * The reduction folds the top 128 bits down twice: a word w at x^(128 +
//    32 i) comes back as w (1 + x + x^2 + x^7) at x^(32 i), whose shifts
//    are multiplies by 2, 4 and 128 (IMAD for the low word, IMAD.HI for the
//    high), again on the FMA pipe.
// A multiplier is prepared once (prepare: its 9 Karatsuba operands, each
// split into 4 parts, 36 words); a key's H is prepared once a launch and
// kept in shared memory, the map of a scan step once a composition.
//
// Constant time: no branch and no address depends on H, x or y (addresses
// depend on the row, the public slot and the power's public index, branches
// on the public keep flags and slots), and integer multiplies on this card
// take the same time whatever their operands.
//
// The recurrence (our_tree_tpu/aead/gcm.py:130-143):
//   y_j = H_{s_j} ((y_{j-1} keep_j) ^ x_j),   y_{-1} = y0,
// where only keep_j's low bit counts. Each row is the affine map
// y -> y a_j ^ b_j with a_j = keep_j H_{s_j} and b_j = x_j H_{s_j}. The field's
// product commutes, so the map of one row and then another is
// (a, b) then (a', b') = (a a', b a' ^ b'): associative whatever the slots,
// so the scan over rows is a scan over these pairs (ghash.cu). A chunk's b
// is its rows run by Horner from 0, one product a row; its a is the product
// of its rows' keep_j H_{s_j}, which is 0 after a restart and otherwise
// H_s^m for a run of m rows on one slot: read from a table of powers made
// once a launch, with one general product at a slot change.
//
// Without nvcc the same code compiles as host C++, so
// tests/test_torch_ghash_host.py runs it against the plain torch version
// (ops/cuda_ghash.ghash_scan_plain) and the port's gf128_mul.

#pragma once

#include <cstdint>

#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#endif

#ifdef __CUDA_ARCH__
#define GHASH_SYNC() __syncthreads()
#else
#define GHASH_SYNC() ((void)0)
#endif

namespace ghash {

// The most keys one launch takes (the wrapper's cap, ctr_mk's kMaxSlots).
constexpr int kMaxSlots = 64;
// Words of a prepared multiplier: 9 Karatsuba operands x 4 parts.
constexpr int kPrepWords = 36;

struct alignas(16) Elem {
  uint32_t w[4];
};

// A multiplier prepared for mul: w[4 o + i] = operand o & (0x11111111 << i).
struct alignas(16) Prep {
  uint32_t w[kPrepWords];
};

__device__ __forceinline__ Elem zero() { return Elem{{0u, 0u, 0u, 0u}}; }

// The field's one in the polynomial basis.
__device__ __forceinline__ Elem one() { return Elem{{1u, 0u, 0u, 0u}}; }

__device__ __forceinline__ Elem exor(const Elem& a, const Elem& b) {
  return Elem{{a.w[0] ^ b.w[0], a.w[1] ^ b.w[1], a.w[2] ^ b.w[2], a.w[3] ^ b.w[3]}};
}

__device__ __forceinline__ Elem masked(const Elem& a, uint32_t m) {
  return Elem{{a.w[0] & m, a.w[1] & m, a.w[2] & m, a.w[3] & m}};
}

// The bits of each byte reversed: word-bit basis <-> polynomial basis (two
// instructions on the card: a bit reverse, which also reverses the bytes,
// and a byte permute that puts them back).
__device__ __forceinline__ uint32_t flip_word(uint32_t v) {
#ifdef __CUDA_ARCH__
  return __byte_perm(__brev(v), 0u, 0x0123u);
#else
  v = ((v >> 1) & 0x55555555u) | ((v & 0x55555555u) << 1);
  v = ((v >> 2) & 0x33333333u) | ((v & 0x33333333u) << 2);
  return ((v >> 4) & 0x0F0F0F0Fu) | ((v & 0x0F0F0F0Fu) << 4);
#endif
}

__device__ __forceinline__ Elem flip(const Elem& a) {
  return Elem{{flip_word(a.w[0]), flip_word(a.w[1]), flip_word(a.w[2]), flip_word(a.w[3])}};
}

// The high word of a * b (IMAD.HI on the card).
__device__ __forceinline__ uint32_t mulhi(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// The 9 Karatsuba operands of a (limbs a0..a3, a0 the lowest), each split
// into its 4 classes of bit positions: s[4 o + i] = operand o & (0x11111111 << i).
// Operands: a0, a1, a0^a1, a2, a3, a2^a3, a0^a2, a1^a3, a0^a1^a2^a3.
__device__ __forceinline__ void split(const Elem& a, uint32_t (&s)[kPrepWords]) {
  const uint32_t u = a.w[0] ^ a.w[2], v = a.w[1] ^ a.w[3];
  const uint32_t ops[9] = {a.w[0], a.w[1], a.w[0] ^ a.w[1], a.w[2], a.w[3], a.w[2] ^ a.w[3],
                           u, v, u ^ v};
#pragma unroll
  for (int o = 0; o < 9; ++o)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[4 * o + i] = ops[o] & (0x11111111u << i);
}

__device__ __forceinline__ Prep prepare(const Elem& b) {
  Prep p;
  split(b, p.w);
  return p;
}

// The carry-less product of two split 32-bit operands: 16 integer products,
// three pairs of them summed in one multiply-add (class 0: parts (0, 0)
// and (1, 3); class 1: (0, 1) and (2, 3), (1, 0) and (3, 2); class 2:
// (0, 2) and (3, 3)), each class masked to its positions.
__device__ __forceinline__ uint64_t clmul32(const uint32_t* x, const uint32_t* y) {
  const uint64_t z0 = ((uint64_t)x[0] * y[0] + (uint64_t)x[1] * y[3]) ^ (uint64_t)x[2] * y[2] ^
                      (uint64_t)x[3] * y[1];
  const uint64_t z1 = ((uint64_t)x[0] * y[1] + (uint64_t)x[2] * y[3]) ^
                      ((uint64_t)x[1] * y[0] + (uint64_t)x[3] * y[2]);
  const uint64_t z2 = ((uint64_t)x[0] * y[2] + (uint64_t)x[3] * y[3]) ^ (uint64_t)x[1] * y[1] ^
                      (uint64_t)x[2] * y[0];
  const uint64_t z3 = (uint64_t)x[0] * y[3] ^ (uint64_t)x[1] * y[2] ^ (uint64_t)x[2] * y[1] ^
                      (uint64_t)x[3] * y[0];
  return (z0 & 0x1111111111111111ull) | (z1 & 0x2222222222222222ull) |
         (z2 & 0x4444444444444444ull) | (z3 & 0x8888888888888888ull);
}

// 64 x 64 -> 128 by Karatsuba from its three 32-bit products.
__device__ __forceinline__ void karatsuba64(uint64_t p0, uint64_t p1, uint64_t pm, uint32_t* r) {
  const uint64_t m = pm ^ p0 ^ p1;
  r[0] = (uint32_t)p0;
  r[1] = (uint32_t)(p0 >> 32) ^ (uint32_t)m;
  r[2] = (uint32_t)p1 ^ (uint32_t)(m >> 32);
  r[3] = (uint32_t)(p1 >> 32);
}

// c (8 words, degree <= 254) mod P: each high word w at x^(128 + 32 i) is
// w (1 + x + x^2 + x^7) at x^(32 i), 39 bits, the shifts as multiplies; the
// 7 bits the top word's fold puts at x^128 fold once more.
__device__ __forceinline__ Elem reduce(const uint32_t (&c)[8]) {
  uint32_t r[4] = {c[0], c[1], c[2], c[3]};
  uint32_t t = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = c[4 + i];
    const uint32_t lo = w ^ (w * 2u) ^ (w * 4u) ^ (w * 128u);
    const uint32_t hi = mulhi(w, 2u) ^ mulhi(w, 4u) ^ mulhi(w, 128u);
    r[i] ^= lo;
    if (i < 3) r[i + 1] ^= hi;
    else t = hi;
  }
  r[0] ^= t ^ (t * 2u) ^ (t * 4u) ^ (t * 128u);
  return Elem{{r[0], r[1], r[2], r[3]}};
}

// a * b in the polynomial basis, b prepared.
__device__ __forceinline__ Elem mul(const Elem& a, const Prep& b) {
  uint32_t x[kPrepWords];
  split(a, x);
  uint64_t p[9];
#pragma unroll
  for (int o = 0; o < 9; ++o) p[o] = clmul32(x + 4 * o, b.w + 4 * o);
  uint32_t lo[4], hi[4], mid[4];
  karatsuba64(p[0], p[1], p[2], lo);
  karatsuba64(p[3], p[4], p[5], hi);
  karatsuba64(p[6], p[7], p[8], mid);
  uint32_t c[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) mid[i] ^= lo[i] ^ hi[i];
  c[0] = lo[0];
  c[1] = lo[1];
  c[2] = lo[2] ^ mid[0];
  c[3] = lo[3] ^ mid[1];
  c[4] = hi[0] ^ mid[2];
  c[5] = hi[1] ^ mid[3];
  c[6] = hi[2];
  c[7] = hi[3];
  return reduce(c);
}

__device__ __forceinline__ Elem mul(const Elem& a, const Elem& b) { return mul(a, prepare(b)); }

// The map (a, b) followed by the map (ag, bg), in place: (a ag, b ag ^ bg).
__device__ __forceinline__ void compose(Elem& a, Elem& b, const Elem& ag, const Elem& bg) {
  const Prep p = prepare(ag);
  a = mul(a, p);
  b = exor(mul(b, p), bg);
}

// The map (a, b) applied to y: y a ^ b.
__device__ __forceinline__ Elem apply(const Elem& y, const Elem& a, const Elem& b) {
  return exor(mul(y, a), b);
}

// One row's words of a (rows, 4) u32 array.
__device__ __forceinline__ Elem load_row(const uint32_t* p, long long r) {
#ifdef __CUDACC__
  const uint4 v = reinterpret_cast<const uint4*>(p)[r];
  return Elem{{v.x, v.y, v.z, v.w}};
#else
  return Elem{{p[4 * r], p[4 * r + 1], p[4 * r + 2], p[4 * r + 3]}};
#endif
}

__device__ __forceinline__ void store_row(uint32_t* p, long long r, const Elem& e) {
#ifdef __CUDACC__
  reinterpret_cast<uint4*>(p)[r] = make_uint4(e.w[0], e.w[1], e.w[2], e.w[3]);
#else
  for (int c = 0; c < 4; ++c) p[4 * r + c] = e.w[c];
#endif
}

// The scan's inputs: x and, where given, inject ((n, 4) words, XORed), the
// (n,) public slots and keep flags, and the number of keys.
struct Rows {
  const uint32_t* x;
  const uint32_t* inject;
  const int32_t* slots;
  const int32_t* keep;
  int k;
};

// A slot clamped into [0, k): a bad slot vector gives wrong output for its
// rows, never a read outside the tables (the wrapper refuses one on the
// CPU), as ctr_mk and cbc_mk do.
__device__ __forceinline__ int clamp_slot(int s, int k) {
  return s < 0 ? 0 : (s >= k ? k - 1 : s);
}

// One row's inputs as loaded, not yet used: the chunk loops load the next
// row's while the current row's product runs (a thread's rows are strided
// from its neighbours', so each load is a round trip of its own).
struct RawRow {
  Elem x, inject;
  int slot, keep;
};

__device__ __forceinline__ RawRow load_raw(const Rows& in, long long r) {
  return RawRow{load_row(in.x, r), in.inject ? load_row(in.inject, r) : zero(), in.slots[r],
                in.keep[r]};
}

// The row's x ^ inject in the polynomial basis.
__device__ __forceinline__ Elem raw_x(const RawRow& row) { return flip(exor(row.x, row.inject)); }

// The keys as a launch holds them (in shared memory on the card): each
// key's prepared H, and where a table is kept, pw[rows s + m - 1] = H_s^m
// for m = 1..rows, all in the polynomial basis.
struct Keys {
  const Prep* h;
  const Elem* pw;
  int rows;
};

// Fills h[s] (and, if pw is not null, the powers up to H_s^rows) for the k
// keys of hkeys ((k, 4) words), work items striped over thread tid of
// nthreads, which all call it. The table doubles: level L makes
// H^(L+1)..H^(2L) as H^(i-L) H^L, one product an item.
__device__ __forceinline__ void build_keys(const uint32_t* hkeys, int k, int rows, Prep* h,
                                           Elem* pw, int tid, int nthreads) {
  for (int s = tid; s < k; s += nthreads) {
    const Elem hs = flip(Elem{{hkeys[4 * s], hkeys[4 * s + 1], hkeys[4 * s + 2],
                               hkeys[4 * s + 3]}});
    h[s] = prepare(hs);
    if (pw) pw[rows * s] = hs;
  }
  GHASH_SYNC();
  if (!pw) return;
  for (int level = 1; level < rows; level *= 2) {
    const int top = 2 * level < rows ? 2 * level : rows;
    for (int i = tid; i < k * (top - level); i += nthreads) {
      const int s = i / (top - level), m = level + i % (top - level);
      pw[rows * s + m] = mul(pw[rows * s + m - level], pw[rows * s + level - 1]);
    }
    GHASH_SYNC();
  }
}

// The a of a run of rows since the chunk's start: 0 once a restart has
// passed (dead); else base H_s^m, with base the product over the runs on
// earlier slots (base_one: no earlier run, base = 1).
struct RunA {
  Elem base;
  bool base_one, dead;
  int slot, m;
};

__device__ __forceinline__ Elem run_a(const RunA& st, const Keys& keys) {
  if (st.dead) return zero();
  if (st.m == 0) return st.base;
  const Elem p = keys.pw[keys.rows * st.slot + st.m - 1];
  return st.base_one ? p : mul(st.base, p);
}

// A named row's run state packed into one int while its chunk runs: m (9
// bits), slot (6), base_one, dead.
__device__ __forceinline__ int pack_run(const RunA& st) {
  return st.m | st.slot << 9 | (int)st.base_one << 15 | (int)st.dead << 16;
}

__device__ __forceinline__ RunA unpack_run(const Elem& base, int v) {
  return RunA{base, ((v >> 15) & 1) != 0, ((v >> 16) & 1) != 0, (v >> 9) & 63, v & 511};
}

// The map of rows [r0, r1) into (a, b): b by Horner from 0, one product by
// H a row; a from the table (run_a). The rows named in named[e0..e1)
// (sorted, each in [r0, r1)) get their own map of rows [r0, row] in
// named_maps[2 e], [2 e + 1]; named_state[e] holds the run's state on the
// way (their a is made after the loop, so the loop holds one product).
// rows - the table's length - is at least r1 - r0, at most 511.
__device__ __forceinline__ void chunk_map(const Rows& in, const Keys& keys, long long r0,
                                          long long r1, const long long* named, long long e0,
                                          long long e1, Elem* named_maps, int* named_state,
                                          Elem& a, Elem& b) {
  RunA st{one(), true, false, 0, 0};
  b = zero();
  long long e = e0;
  long long next = e < e1 ? named[e] : -1;
  RawRow ahead = r0 < r1 ? load_raw(in, r0) : RawRow{};
  for (long long r = r0; r < r1; ++r) {
    const RawRow cur = ahead;
    if (r + 1 < r1) ahead = load_raw(in, r + 1);
    const int s = clamp_slot(cur.slot, in.k);
    const bool kept = cur.keep & 1;
    if (!kept) {
      st.dead = true;
    } else if (!st.dead && s != st.slot && st.m > 0) {
      st.base = run_a(st, keys);
      st.base_one = false;
      st.m = 0;
    }
    st.slot = s;
    ++st.m;
    b = mul(exor(masked(b, kept ? 0xFFFFFFFFu : 0u), raw_x(cur)), keys.h[s]);
    while (next == r) {
      named_maps[2 * e] = st.base;
      named_maps[2 * e + 1] = b;
      named_state[e] = pack_run(st);
      ++e;
      next = e < e1 ? named[e] : -1;
    }
  }
  a = run_a(st, keys);
  for (e = e0; e < e1; ++e)
    named_maps[2 * e] = run_a(unpack_run(named_maps[2 * e], named_state[e]), keys);
}

// Rows [r0, r1) run from y, the state before row r0 (polynomial basis),
// every row's y stored in the word-bit basis.
__device__ __forceinline__ void chunk_run(const Rows& in, const Prep* h, long long r0,
                                          long long r1, Elem y, uint32_t* ys) {
  RawRow ahead = r0 < r1 ? load_raw(in, r0) : RawRow{};
  for (long long r = r0; r < r1; ++r) {
    const RawRow cur = ahead;
    if (r + 1 < r1) ahead = load_raw(in, r + 1);
    const uint32_t km = 0u - ((uint32_t)cur.keep & 1u);
    y = mul(exor(masked(y, km), raw_x(cur)), h[clamp_slot(cur.slot, in.k)]);
    store_row(ys, r, flip(y));
  }
}

// The first index e in [0, n) with named[e] >= r (n if none): named is
// sorted.
__device__ __forceinline__ long long lower_bound(const long long* named, long long n, long long r) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) / 2;
    if (named[mid] < r) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

}  // namespace ghash
