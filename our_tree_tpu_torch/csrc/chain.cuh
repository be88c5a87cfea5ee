// The arithmetic of the integer-logic ceiling probe (chain.cu): for one 32-bit
// word x, `ilp` independent two-word feedback chains, each stepped `chain`
// times and XOR-reduced.
//
//   a_i = x ^ c1_i, b_i = x ^ c2_i,  c1_i = seed1 * (2i + 1), c2_i = seed2 * (2i + 1)
//   repeat chain times: (a_i, b_i) <- (b_i, a_i ^ (b_i & k)), with k = k0 = k1
//   (a chain longer than kUnrolled steps runs as a rolled loop of 128-step
//   runs: the latency instantiation, one word through 65,536 dependent steps)
//   result = XOR over i of (a_i ^ b_i)
//
// The work must survive compilation, and two things could shrink it. Per bit
// the step is linear over GF(2) with period 6 whatever k is, so a compiler
// that noticed would cut 128 steps to 2; and every state of a chain is a
// function of three values (a, b, k), so a pass that fuses logic into
// three-input LOP3s could in principle fuse the whole chain. Hence: on the
// card each step is one LOP3 (lookup table 0x78 = a ^ (b & c)) in inline PTX,
// opaque to the front end, and the steps alternate between two mask
// registers k0 and k1, which the caller sets equal but the compiler cannot
// know to be, so two steps always read four values and no two fuse.
// chip_smoke.py counts the LOP3s in the compiled SASS. Without nvcc the same
// code compiles as host C++ (the step as plain C++), so
// tests/test_torch_chain_host.py runs it against the plain torch version.

#pragma once

#include <cstdint>

#ifndef __CUDACC__
#define __device__
#define __forceinline__ inline
#endif

namespace chain {

// Steps unrolled in one run: the probe's regimes unroll their whole chain.
constexpr int kUnrolled = 128;

__device__ __forceinline__ uint32_t step(uint32_t a, uint32_t b, uint32_t k) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x78;" : "=r"(r) : "r"(a), "r"(b), "r"(k));
  return r;
#else
  return a ^ (b & k);
#endif
}

// STEPS feedback steps of each of the ILP chains, unrolled; the masks
// alternate k0, k1 from step to step (STEPS is even or the whole chain).
template <int STEPS, int ILP>
__device__ __forceinline__ void run(uint32_t (&a)[ILP], uint32_t (&b)[ILP], uint32_t k0,
                                    uint32_t k1) {
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
#pragma unroll
    for (int i = 0; i < ILP; ++i) {
      const uint32_t t = step(a[i], b[i], (s & 1) ? k1 : k0);
      a[i] = b[i];
      b[i] = t;
    }
  }
}

template <int CHAIN, int ILP>
__device__ __forceinline__ uint32_t element(uint32_t x, uint32_t k0, uint32_t k1,
                                            uint32_t seed1, uint32_t seed2) {
  uint32_t a[ILP], b[ILP];
#pragma unroll
  for (int i = 0; i < ILP; ++i) {
    a[i] = x ^ (seed1 * (2u * i + 1u));
    b[i] = x ^ (seed2 * (2u * i + 1u));
  }
  if constexpr (CHAIN <= kUnrolled) {
    run<CHAIN, ILP>(a, b, k0, k1);
  } else {
    // A longer chain (the latency probe) is a rolled loop of unrolled runs.
    static_assert(CHAIN % kUnrolled == 0, "a long chain is whole runs");
#pragma unroll 1
    for (int o = 0; o < CHAIN / kUnrolled; ++o) run<kUnrolled, ILP>(a, b, k0, k1);
  }
  uint32_t acc = a[0] ^ b[0];
#pragma unroll
  for (int i = 1; i < ILP; ++i) acc = acc ^ a[i] ^ b[i];
  return acc;
}

}  // namespace chain
