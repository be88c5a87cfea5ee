// The arithmetic of the GHASH scan kernel (ghash.cu): multiplication in
// GCM's field GF(2^128), the affine step of the segmented Horner recurrence,
// the composition of two steps, and a chunk of rows run either way.
//
// Elements are 4 u32 words in the word-bit basis, the dispatch layout: a
// block's 16 bytes as little-endian words, word-bit k being bit k % 8 of byte
// k / 8. GCM's element is the block's bytes read as a big-endian int in the
// reflected bit order, so word-bit k is the coefficient of x^(k ^ 7) and the
// field's one is word-bit 7 (word 0 = 0x80). The polynomial basis (bit p of
// the 128-bit value, in word p / 32, is the coefficient of x^p) is the same
// words with the bits of each byte reversed (flip); there, multiplying by x
// is a shift left by one with the bit that leaves x^127 folded back as
// x^7 + x^2 + x + 1 (0x87).
//
// Two multiplies, both by masks alone (no branch and no address depends on
// an element or a key):
//  * mul_h: y * H through H's column table, col[k] = e_k * H with e_k the
//    element whose only set word-bit is k (the columns of the reference's
//    gf128_mul_matrix_words(h)). The product is the XOR of the columns that
//    y's bits select: 128 steps of one mask (0 - bit) and four AND-XORs, the
//    table read at the step's public index. build_columns makes the table
//    from H: x^q H for q < 32 by doublings, then three jumps of x^32 (a word
//    shift and a 39-bit fold).
//  * mul_g: a * g for two elements, bit-serial (SP 800-38D algorithm 1 in the
//    polynomial basis) as four interleaved chains of 32 steps; composing two
//    steps needs it, and so does applying a composed map.
//
// The recurrence (our_tree_tpu/aead/gcm.py:130-143):
//   y_j = H_{s_j} ((y_{j-1} keep_j) ^ x_j),   y_{-1} = y0,
// where only keep_j's low bit counts. Each row is the affine map
// y -> y a_j ^ b_j with a_j = keep_j H_{s_j} and b_j = x_j H_{s_j}. The field's
// product commutes, so the map of one row and then another is
// (a, b) then (a', b') = (a a', b a' ^ b'): associative whatever the slots,
// so the scan over rows is a scan over these pairs (ghash.cu).
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

namespace ghash {

// The most keys one scan takes (the wrapper's cap, ctr_mk's kMaxSlots).
constexpr int kMaxSlots = 64;
// Columns of one key's table.
constexpr int kColumns = 128;

struct alignas(16) Elem {
  uint32_t w[4];
};

__device__ __forceinline__ Elem zero() { return Elem{{0u, 0u, 0u, 0u}}; }

// The field's one, word-bit 7.
__device__ __forceinline__ Elem one() { return Elem{{0x80u, 0u, 0u, 0u}}; }

__device__ __forceinline__ Elem exor(const Elem& a, const Elem& b) {
  return Elem{{a.w[0] ^ b.w[0], a.w[1] ^ b.w[1], a.w[2] ^ b.w[2], a.w[3] ^ b.w[3]}};
}

__device__ __forceinline__ Elem masked(const Elem& a, uint32_t m) {
  return Elem{{a.w[0] & m, a.w[1] & m, a.w[2] & m, a.w[3] & m}};
}

// The bits of each byte reversed: word-bit basis <-> polynomial basis.
__device__ __forceinline__ uint32_t flip_word(uint32_t v) {
  v = ((v >> 1) & 0x55555555u) | ((v & 0x55555555u) << 1);
  v = ((v >> 2) & 0x33333333u) | ((v & 0x33333333u) << 2);
  return ((v >> 4) & 0x0F0F0F0Fu) | ((v & 0x0F0F0F0Fu) << 4);
}

__device__ __forceinline__ Elem flip(const Elem& a) {
  return Elem{{flip_word(a.w[0]), flip_word(a.w[1]), flip_word(a.w[2]), flip_word(a.w[3])}};
}

// v * x in the polynomial basis.
__device__ __forceinline__ void mul_x(uint32_t* v) {
  const uint32_t carry = 0u - (v[3] >> 31);
  v[3] = (v[3] << 1) | (v[2] >> 31);
  v[2] = (v[2] << 1) | (v[1] >> 31);
  v[1] = (v[1] << 1) | (v[0] >> 31);
  v[0] = (v[0] << 1) ^ (carry & 0x87u);
}

// v * x^32 in the polynomial basis: the top word T leaves and T (x^7 + x^2 +
// x + 1), of degree at most 38, comes back at the bottom.
__device__ __forceinline__ void mul_x32(uint32_t* v) {
  const uint32_t t = v[3];
  const uint32_t lo = t ^ (t << 1) ^ (t << 2) ^ (t << 7);
  const uint32_t hi = (t >> 31) ^ (t >> 30) ^ (t >> 25);
  v[3] = v[2];
  v[2] = v[1];
  v[1] = v[0] ^ hi;
  v[0] = lo;
}

// The column tables of k keys: col[128 s + k'] = e_k' * H_s, with hkeys the
// (k, 4) H words. Work items (s, q), q < 32, are striped over thread tid of
// nthreads: x^q H_s by q doublings, then x^(32 m + q) H_s for m = 1..3 by
// jumps; x^p is e_(p ^ 7).
__device__ __forceinline__ void build_columns(const uint32_t* hkeys, int k, Elem* col, int tid,
                                              int nthreads) {
  for (int i = tid; i < 32 * k; i += nthreads) {
    const int s = i >> 5, q = i & 31;
    uint32_t v[4];
    for (int c = 0; c < 4; ++c) v[c] = flip_word(hkeys[4 * s + c]);
    for (int j = 0; j < q; ++j) mul_x(v);
    for (int m = 0; m < 4; ++m) {
      col[kColumns * s + ((32 * m + q) ^ 7)] =
          Elem{{flip_word(v[0]), flip_word(v[1]), flip_word(v[2]), flip_word(v[3])}};
      mul_x32(v);
    }
  }
}

// y * H through H's columns. The word loop stays rolled (one trip of 32
// unrolled steps); two accumulators halve the XOR chain.
__device__ __forceinline__ Elem mul_h(const Elem& y, const Elem* col) {
  uint32_t z0[4] = {0u, 0u, 0u, 0u}, z1[4] = {0u, 0u, 0u, 0u};
  uint32_t cur = y.w[0], n1 = y.w[1], n2 = y.w[2], n3 = y.w[3];
#pragma unroll 1
  for (int w = 0; w < 4; ++w) {
    const Elem* c = col + 32 * w;
#pragma unroll
    for (int b = 0; b < 32; b += 2) {
      const uint32_t m0 = 0u - ((cur >> b) & 1u), m1 = 0u - ((cur >> (b + 1)) & 1u);
      const Elem c0 = c[b], c1 = c[b + 1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        z0[i] ^= c0.w[i] & m0;
        z1[i] ^= c1.w[i] & m1;
      }
    }
    cur = n1;
    n1 = n2;
    n2 = n3;
  }
  return Elem{{z0[0] ^ z1[0], z0[1] ^ z1[1], z0[2] ^ z1[2], z0[3] ^ z1[3]}};
}

// a * H and b * H at once, each column read once for both.
__device__ __forceinline__ void mul_h2(Elem& a, Elem& b, const Elem* col) {
  uint32_t za[4] = {0u, 0u, 0u, 0u}, zb[4] = {0u, 0u, 0u, 0u};
  uint32_t ca = a.w[0], a1 = a.w[1], a2 = a.w[2], a3 = a.w[3];
  uint32_t cb = b.w[0], b1 = b.w[1], b2 = b.w[2], b3 = b.w[3];
#pragma unroll 1
  for (int w = 0; w < 4; ++w) {
    const Elem* c = col + 32 * w;
#pragma unroll
    for (int bit = 0; bit < 32; ++bit) {
      const uint32_t ma = 0u - ((ca >> bit) & 1u), mb = 0u - ((cb >> bit) & 1u);
      const Elem cv = c[bit];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        za[i] ^= cv.w[i] & ma;
        zb[i] ^= cv.w[i] & mb;
      }
    }
    ca = a1;
    a1 = a2;
    a2 = a3;
    cb = b1;
    b1 = b2;
    b2 = b3;
  }
  a = Elem{{za[0], za[1], za[2], za[3]}};
  b = Elem{{zb[0], zb[1], zb[2], zb[3]}};
}

// r[i] = a[i] * g for N elements a[i] sharing the multiplier g: the chains
// walk x^(32 m + i) g for m < 4 at once, each step masked by a's coefficient
// of that power.
template <int N>
__device__ __forceinline__ void mul_g(const Elem* a, const Elem& g, Elem* r) {
  uint32_t pa[N][4], z[N][4], v[4][4];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pa[n][c] = flip_word(a[n].w[c]);
      z[n][c] = 0u;
    }
#pragma unroll
  for (int c = 0; c < 4; ++c) v[0][c] = flip_word(g.w[c]);
#pragma unroll
  for (int m = 1; m < 4; ++m) {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[m][c] = v[m - 1][c];
    mul_x32(v[m]);
  }
#pragma unroll 1
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const uint32_t bm = 0u - ((pa[n][m] >> i) & 1u);
#pragma unroll
        for (int c = 0; c < 4; ++c) z[n][c] ^= v[m][c] & bm;
      }
      mul_x(v[m]);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n)
    r[n] = Elem{{flip_word(z[n][0]), flip_word(z[n][1]), flip_word(z[n][2]), flip_word(z[n][3])}};
}

// The map (a, b) followed by the map (ag, bg), in place: (a ag, b ag ^ bg).
__device__ __forceinline__ void compose(Elem& a, Elem& b, const Elem& ag, const Elem& bg) {
  const Elem in[2] = {a, b};
  Elem out[2];
  mul_g<2>(in, ag, out);
  a = out[0];
  b = exor(out[1], bg);
}

// The map (a, b) applied to y: y a ^ b.
__device__ __forceinline__ Elem apply(const Elem& y, const Elem& a, const Elem& b) {
  Elem r;
  mul_g<1>(&y, a, &r);
  return exor(r, b);
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

__device__ __forceinline__ Elem row_x(const Rows& in, long long r) {
  const Elem x = load_row(in.x, r);
  return in.inject ? exor(x, load_row(in.inject, r)) : x;
}

// Row r's slot, clamped into [0, k): a bad slot vector gives wrong output
// for its rows, never a read outside the tables (the wrapper refuses one on
// the CPU), as ctr_mk and cbc_mk do.
__device__ __forceinline__ int row_slot(const Rows& in, long long r) {
  const int s = in.slots[r];
  return s < 0 ? 0 : (s >= in.k ? in.k - 1 : s);
}

// The map of rows [r0, r1) composed into (a, b).
__device__ __forceinline__ void chunk_map(const Rows& in, const Elem* col, long long r0,
                                          long long r1, Elem& a, Elem& b) {
  a = one();
  b = zero();
  for (long long r = r0; r < r1; ++r) {
    const uint32_t km = 0u - ((uint32_t)in.keep[r] & 1u);
    a = masked(a, km);
    b = exor(masked(b, km), row_x(in, r));
    mul_h2(a, b, col + kColumns * row_slot(in, r));
  }
}

// Rows [r0, r1) run from y, the state before row r0, every row's y stored.
__device__ __forceinline__ void chunk_run(const Rows& in, const Elem* col, long long r0,
                                          long long r1, Elem y, uint32_t* ys) {
  for (long long r = r0; r < r1; ++r) {
    const uint32_t km = 0u - ((uint32_t)in.keep[r] & 1u);
    y = mul_h(exor(masked(y, km), row_x(in, r)), col + kColumns * row_slot(in, r));
    store_row(ys, r, y);
  }
}

}  // namespace ghash
