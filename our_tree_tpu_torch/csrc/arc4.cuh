// The arithmetic of the ARC4 PRGA kernel (arc4.cu): one step of the
// keystream generator, the layout of a stream's state in shared memory, and
// the loop that runs one stream for a given number of bytes, optionally
// XORing the keystream into data.
//
// One step, on the state (x, y, m[256]) of the reference's arc4_context:
//
//   x = (x + 1) & 255;  a = m[x];  y = (y + a) & 255;  b = m[y];
//   m[x] = b;  m[y] = a;  k = m[(a + b) & 255]
//
// k is read after the two writes, as the reference's scan reads the
// updated permutation (our_tree_tpu/models/arc4.py:71-78).
//
// Layout. A thread block holds one stream per thread, LANES streams, in
// LANES * 256 32-bit words of shared memory, one word per state byte: m[i]
// of lane t is word i * LANES + t, whose bank is t mod 32 whatever i is, so
// the threads of a warp never share a bank (each reads only its own
// stream). A word per byte keeps the address one multiply-add from the
// index, which sits on the byte-to-byte dependent path; packing four bytes
// a word would take five more instructions an access there. (A plain
// [lane][256] layout would put every lane at the same bank whenever the
// indexes agree mod 32.)
//
// The loop groups four bytes into one 32-bit load of data and one 32-bit
// store of output when both rows are 4-byte aligned, and goes a byte at a
// time otherwise and for the tail. Without nvcc the same code compiles as
// host C++, so tests/test_torch_arc4_host.py runs it against the plain torch
// version (ops/cuda_arc4.prga_plain).
//
// The PRGA indexes its state by secret bytes, as the reference's scan does:
// it is not constant time (ROADMAP.md queue 3).

#pragma once

#include <cstdint>

#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#endif

namespace arc4 {

// Words of one row of the state in device memory: x, y, m[0..255], each a
// u32 holding a byte (the reference's (S, 258) prep_batch_words layout).
constexpr int kStateWords = 258;

// Shared-memory words a thread block of LANES streams holds.
template <int LANES>
constexpr int kSharedWords = 256 * LANES;

// One lane's view of the interleaved shared-memory state.
template <int LANES>
struct Lane {
  uint32_t* base;  // shared memory + lane

  __device__ __forceinline__ uint32_t ld(uint32_t i) const { return base[i * LANES]; }
  __device__ __forceinline__ void st(uint32_t i, uint32_t v) const { base[i * LANES] = v; }
};

template <int LANES>
__device__ __forceinline__ Lane<LANES> lane_of(uint32_t* smem, int lane) {
  return Lane<LANES>{smem + lane};
}

// One PRGA step: advances (x, y, m) and returns the keystream byte.
template <class M>
__device__ __forceinline__ uint32_t step(const M& m, uint32_t& x, uint32_t& y) {
  x = (x + 1) & 255u;
  const uint32_t a = m.ld(x);
  y = (y + a) & 255u;
  const uint32_t b = m.ld(y);
  m.st(x, b);
  m.st(y, a);
  return m.ld((a + b) & 255u);
}

// Load a state row (x, y, m[256] as u32 words) into the lane; each value
// is masked to a byte.
template <class M>
__device__ __forceinline__ void load_state(const M& m, const uint32_t* row, uint32_t& x,
                                           uint32_t& y) {
  x = row[0] & 255u;
  y = row[1] & 255u;
  for (int i = 0; i < 256; ++i) m.st(i, row[2 + i] & 255u);
}

template <class M>
__device__ __forceinline__ void store_state(const M& m, uint32_t* row, uint32_t x, uint32_t y) {
  row[0] = x;
  row[1] = y;
  for (int i = 0; i < 256; ++i) row[2 + i] = m.ld(i);
}

// len keystream bytes of one stream into out (or data ^ keystream when data
// is not null). x and y are carried in and out; the state in m advances.
template <class M>
__device__ __forceinline__ void run(const M& m, uint32_t& x, uint32_t& y, const uint8_t* data,
                                    uint8_t* out, long long len) {
  long long i = 0;
  const bool words = ((reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(data)) & 3) == 0;
  if (words) {
    const uint32_t* d4 = reinterpret_cast<const uint32_t*>(data);
    uint32_t* o4 = reinterpret_cast<uint32_t*>(out);
    for (; i + 4 <= len; i += 4) {
      // Little-endian: byte j of the group is bits 8j..8j+7 of the word.
      uint32_t k = step(m, x, y);
      k |= step(m, x, y) << 8;
      k |= step(m, x, y) << 16;
      k |= step(m, x, y) << 24;
      o4[i >> 2] = data ? (d4[i >> 2] ^ k) : k;
    }
  }
  for (; i < len; ++i) {
    const uint32_t k = step(m, x, y);
    out[i] = (uint8_t)(data ? (data[i] ^ k) : k);
  }
}

}  // namespace arc4
