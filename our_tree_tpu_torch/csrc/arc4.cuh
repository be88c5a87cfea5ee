// The arithmetic of the ARC4 PRGA kernel (arc4.cu): the layout of a stream's
// state in shared memory, the warp-wide copy of a block's states in and out,
// and the lookahead schedule that runs one stream for a given number of
// bytes, optionally XORing the keystream into data.
//
// One step, on the state (x, y, m[256]) of the reference's arc4_context:
//
//   x = x + 1;  a = m[x];  y = y + a;  b = m[y];  m[x] = b;  m[y] = a;
//   k = m[a + b]                                  (all mod 256)
//
// k is read after the two writes, as the reference's scan reads the
// updated permutation (our_tree_tpu/models/arc4.py:71-78).
//
// Layout. A thread block holds one stream per thread, LANES streams, in
// LANES * 256 32-bit words of shared memory, one word per state byte: m[i]
// of lane t is word i * LANES + t, whose bank is t mod 32 whatever i is, so
// the threads of a warp never share a bank (each reads only its own
// stream). A state byte v is held as v << 24, in shared memory and in
// registers (x, y, a, b): a sum of two wraps mod 256 by itself, and the
// byte's address in its lane, v * 4 * LANES, is one shift of it (v >> 17 for
// 32 lanes). So y + a costs one add and no mask.
//
// Schedule. Written as above, a byte's load of m[x] comes after the
// previous byte's stores, which wait on its load of b = m[y], whose address
// waits on its load of a: two dependent shared-memory loads a byte. Here
// the loads run ahead of the stores that precede them in the function and
// are corrected by selects against those stores. Slot j finishes byte j
// (its stores and keystream byte) and chains byte j+2 (its y), in this order
// (Prga::slot, kLookahead = 4; m_i is the state after byte i):
//
//   1. a_{j+2} = m_{j+1}[x_{j+2}] was read as P_{j+2} in slot j-2, after
//      byte j-2's stores. The stores since then that can land on x_{j+2}
//      are m[y_i] = a_i for i = j-1, j, j+1; the stores m[x_i] cannot, as
//      x_i != x_{j+2} for i within 255 bytes. So a_{j+2} is P_{j+2} with a_i
//      put in wherever y_i == x_{j+2}, oldest first, since a later store
//      overwrites an earlier one. Only the last select, against y_{j+1},
//      waits for the byte before: y_{j+2} is picked between x_{j+2} +
//      a_{j+1} (where x_{j+2} == y_{j+1}, so that a_{j+2} == a_{j+1}) and
//      y_{j+1} plus the rest, two sums made at once, by one compare.
//   2. b_j = m_{j-1}[y_j] was read as b'_j in slot j-2, after byte j-2's
//      stores. Byte j-1's stores m[x_{j-1}] = b_{j-1}, then m[y_{j-1}] =
//      a_{j-1}, came since: b_j is b'_j, then b_{j-1} where y_j == x_{j-1},
//      then a_{j-1} where y_j == y_{j-1} (the later store; where x_{j-1} ==
//      y_{j-1}, a_{j-1} == b_{j-1}). Then the stores m[x_j] = b_j and m[y_j]
//      = a_j, and k_j = m_j[a_j + b_j], read between byte j's stores and
//      byte j+1's, needs no correction.
//   3. b'_{j+2} = m[y_{j+2}] and P_{j+4} = m[x_{j+4}] are read, after byte
//      j's stores, two slots before they are used.
//
// Every correction is a compare and a select, never a branch: the lanes of
// a warp collide at different bytes. The loads and stores are written in
// the order the corrections assume, and the compiler keeps the order of
// shared-memory accesses that may alias. A call starts from virtual bytes
// -1 and 0 whose stores would write m[x_0] and m[y_0] back as they are, so
// the first bytes' corrections against them are exact with no special
// case; the last slots chain two bytes past the end, which only loads.
// With one warp an SM, as at the port's launch shapes, the time a byte is
// what the warp issues; chip_smoke.py phase 9 reads the compiled loop.
//
// Output. Keystream bytes leave four at a time as one 32-bit store (with a
// 32-bit load of data when fused) once the row is 4-byte aligned, each
// word one group after its bytes were read, so that no group waits on its
// own last load, eight groups a trip; the head before alignment and the
// tail go a byte at a time. Without nvcc the same code compiles as host
// C++, so tests/test_torch_arc4_host.py runs it against the plain torch
// version (ops/cuda_arc4.prga_plain), the host oracle and the JAX
// package's scan.
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

// Shared-memory words a thread block of LANES streams holds for its states,
// and for the stage of the copy in and out (LANES rows of LANES + 1 words).
template <int LANES>
constexpr int kSharedWords = 256 * LANES;
template <int LANES>
constexpr int kStageWords = LANES * (LANES + 1);

// A byte as the schedule holds it, and one step of x.
constexpr int kByteShift = 24;
constexpr uint32_t kOne = 1u << kByteShift;

// Slots a load of m[x] runs ahead of the stores; the chain of y runs two
// ahead. On an H100 this schedule, eight groups a trip, beat the chain one
// slot ahead with the loads of m[x] three, at one or two groups a trip, at
// every launch shape the port uses (PERF.md).
constexpr int kLookahead = 4;

constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

// One lane's view of the interleaved shared-memory state, indexed by held
// bytes (v << 24).
template <int LANES>
struct Lane {
  static_assert((LANES & (LANES - 1)) == 0, "LANES must be a power of two");
  static constexpr int kAddrShift = kByteShift - 2 - log2_of(LANES);
  uint32_t* base;  // shared memory + lane

  __device__ __forceinline__ uint32_t* at(uint32_t v) const {
    return reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(base) + (v >> kAddrShift));
  }
  __device__ __forceinline__ uint32_t ld(uint32_t v) const { return *at(v); }
  __device__ __forceinline__ void st(uint32_t v, uint32_t w) const { *at(v) = w; }
};

template <int LANES>
__device__ __forceinline__ Lane<LANES> lane_of(uint32_t* smem, int lane) {
  return Lane<LANES>{smem + lane};
}

// The copy of a block's state rows in and out of shared memory, a chunk of
// LANES words of every row at a time, through a stage of LANES rows of
// LANES + 1 words: the device-memory side moves one row's chunk with
// consecutive lanes on consecutive words, the interleaved side one word of
// every lane's own row, and the stage's odd stride keeps both sides free of
// bank conflicts. Each copy is two phases a chunk, with a warp barrier
// between them (the host build runs each phase for every lane in turn).
template <int LANES>
constexpr int kChunks = (kStateWords + LANES - 1) / LANES;

// In, phase 1: lane reads word c * LANES + lane of each of the block's rows.
template <int LANES>
__device__ __forceinline__ void stage_in(const uint32_t* rows, int nrows, int c, int lane,
                                         uint32_t* stage) {
  const int w = c * LANES + lane;
  if (w >= kStateWords) return;
#pragma unroll 8
  for (int r = 0; r < nrows; ++r) stage[r * (LANES + 1) + lane] = rows[(long long)r * kStateWords + w];
}

// In, phase 2: lane takes its own row's chunk from the stage, each value
// masked to a byte and held as v << 24.
template <int LANES>
__device__ __forceinline__ void unstage_in(const uint32_t* stage, int c, const Lane<LANES>& m,
                                           int lane, uint32_t& x, uint32_t& y) {
#pragma unroll 8
  for (int k = 0; k < LANES; ++k) {
    const int w = c * LANES + k;
    if (w >= kStateWords) break;
    const uint32_t v = (stage[lane * (LANES + 1) + k] & 255u) << kByteShift;
    if (w == 0) {
      x = v;
    } else if (w == 1) {
      y = v;
    } else {
      m.st((uint32_t)(w - 2) << kByteShift, v);
    }
  }
}

// Out, phase 1: lane puts its own row's chunk into the stage as bytes.
template <int LANES>
__device__ __forceinline__ void stage_out(uint32_t* stage, int c, const Lane<LANES>& m, int lane,
                                          uint32_t x, uint32_t y) {
#pragma unroll 8
  for (int k = 0; k < LANES; ++k) {
    const int w = c * LANES + k;
    if (w >= kStateWords) break;
    const uint32_t v = w == 0 ? x : w == 1 ? y : m.ld((uint32_t)(w - 2) << kByteShift);
    stage[lane * (LANES + 1) + k] = v >> kByteShift;
  }
}

// Out, phase 2: lane writes word c * LANES + lane of each of the block's rows.
template <int LANES>
__device__ __forceinline__ void unstage_out(const uint32_t* stage, int nrows, int c, int lane,
                                            uint32_t* rows) {
  const int w = c * LANES + lane;
  if (w >= kStateWords) return;
#pragma unroll 8
  for (int r = 0; r < nrows; ++r) rows[(long long)r * kStateWords + w] = stage[r * (LANES + 1) + lane];
}

// One stream's PRGA under the lookahead schedule (the header's note): the
// chain of y two bytes ahead of the stores, the loads of m[x] kLookahead.
template <int LANES>
struct Prga {
  static constexpr int D = kLookahead;
  static_assert(D >= 4, "the loads of m[x] run two slots ahead of the chain");

  Lane<LANES> m;
  uint32_t xj;                  // x_j of the byte the next slot finishes
  uint32_t y[D - 1], a[D - 1];  // y_{j+1-i}, a_{j+1-i}: y[1] is y_j
  uint32_t p[D - 2];            // P_{j+2} .. P_{j+D-1}: m[x] as read, not yet corrected
  uint32_t b1, b2;              // b'_j, b'_{j+1}: m[y] as read
  uint32_t bprev;               // b_{j-1}

  // Starts from (x, y) held as bytes << 24: bytes -1 and 0 are virtual,
  // their stores writing m[x_0] and m[y_0] back as they are, and bytes 1
  // and 2 are chained.
  __device__ __forceinline__ Prga(const Lane<LANES>& lane, uint32_t x0, uint32_t y0) : m(lane) {
    const uint32_t a0 = m.ld(y0);
#pragma unroll
    for (int i = 0; i < D - 1; ++i) {
      y[i] = y0;
      a[i] = a0;
    }
#pragma unroll
    for (int i = 0; i < D - 2; ++i) p[i] = m.ld(x0 + (uint32_t)(i + 1) * kOne);
    xj = x0 - kOne;
    b1 = b2 = m.ld(x0);
    slot<false>();
    slot<false>();
  }

  // Chains byte j + 2 and, when kFinish, finishes byte j (its stores) and
  // returns its keystream byte, held as k << 24.
  template <bool kFinish = true>
  __device__ __forceinline__ uint32_t slot() {
    // a_{j+2}: P_{j+2} with the stores of m[y] since it was read, oldest
    // first; the last, against y_{j+1}, is on the byte-to-byte path, so
    // y_{j+2} is picked from two sums made at once.
    const uint32_t x2 = xj + 2 * kOne;
    uint32_t an = p[0];
#pragma unroll
    for (int i = D - 2; i >= 1; --i) an = x2 == y[i] ? a[i] : an;
    const bool hit = x2 == y[0];
    const uint32_t yn = hit ? x2 + a[0] : y[0] + an;
    an = hit ? a[0] : an;
    // b_j: b'_j with byte j-1's stores m[x_{j-1}] = b_{j-1}, m[y_{j-1}] = a_{j-1}.
    uint32_t b = b1, k = 0;
    if (kFinish) {
      b = y[1] == xj - kOne ? bprev : b;
      b = y[1] == y[2] ? a[2] : b;
      m.st(xj, b);
      m.st(y[1], a[1]);
      k = m.ld(a[1] + b);
    }
    const uint32_t bn = m.ld(yn);  // b'_{j+2}, after byte j's stores
#pragma unroll
    for (int i = 0; i + 1 < D - 2; ++i) p[i] = p[i + 1];
    p[D - 3] = m.ld(xj + (uint32_t)D * kOne);
#pragma unroll
    for (int i = D - 2; i > 0; --i) {
      y[i] = y[i - 1];
      a[i] = a[i - 1];
    }
    y[0] = yn;
    a[0] = an;
    b1 = b2;
    b2 = bn;
    bprev = b;
    xj += kOne;
    return k;
  }

  // (x, y) after the bytes finished so far, held as bytes << 24.
  __device__ __forceinline__ void state(uint32_t& x, uint32_t& y_out) const {
    x = xj - kOne;
    y_out = y[2];
  }
};

template <bool kFused>
__device__ __forceinline__ void put_byte(const uint8_t* data, uint8_t* out, long long i,
                                         uint32_t k) {
  const uint32_t v = k >> kByteShift;
  out[i] = (uint8_t)(kFused ? (data[i] ^ v) : v);
}

// len keystream bytes of one stream into out (data ^ keystream when
// kFused). x and y (held as bytes << 24) are carried in and out; the state
// in m advances.
template <bool kFused, int LANES>
__device__ __forceinline__ void run(const Lane<LANES>& m, uint32_t& x, uint32_t& y,
                                    const uint8_t* data, uint8_t* out, long long len) {
  Prga<LANES> g(m, x, y);
  const bool words =
      !kFused || ((reinterpret_cast<uintptr_t>(out) ^ reinterpret_cast<uintptr_t>(data)) & 3) == 0;
  long long head = words ? (long long)((0 - reinterpret_cast<uintptr_t>(out)) & 3) : len;
  if (head > len) head = len;
  long long i = 0;
  for (; i < head; ++i) put_byte<kFused>(data, out, i, g.slot());
  const long long groups = (len - head) >> 2;
  if (groups > 0) {
    // Little-endian: byte i of a group is bits 8i..8i+7 of its word. The
    // word of group q - 1 is put together while group q runs.
    const uint32_t* d4 = kFused ? reinterpret_cast<const uint32_t*>(data + head) : nullptr;
    uint32_t* o4 = reinterpret_cast<uint32_t*>(out + head);
    uint32_t k0 = g.slot(), k1 = g.slot(), k2 = g.slot(), k3 = g.slot();
#pragma unroll 8
    for (long long q = 1; q < groups; ++q) {
      const uint32_t d = kFused ? d4[q - 1] : 0u;
      uint32_t w = k0 >> 24;
      k0 = g.slot();
      w |= k1 >> 16;
      k1 = g.slot();
      w |= k2 >> 8;
      k2 = g.slot();
      w |= k3;
      k3 = g.slot();
      o4[q - 1] = w ^ d;
    }
    const uint32_t w = (k0 >> 24) | (k1 >> 16) | (k2 >> 8) | k3;
    o4[groups - 1] = kFused ? (d4[groups - 1] ^ w) : w;
    i = head + 4 * groups;
  }
  for (; i < len; ++i) put_byte<kFused>(data, out, i, g.slot());
  g.state(x, y);
}

}  // namespace arc4
