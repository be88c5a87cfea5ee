// AES-ECB for Hopper (sm_90a), both directions:
// out[j] = E_K(in[j]) (ecb_encrypt_kernel, ecb_encrypt_block_kernel) or
// D_K(in[j]) (ecb_decrypt_kernel).
//
// Replaces the TPU kernel _aes_kernel (our_tree_tpu/ops/pallas_aes.py:259-273,
// launched at :358 by _crypt_planes_pallas), the ECB core of every Pallas
// engine name in both directions. The TPU kernel's three boundary layouts
// (planes, grouped, dense) exist for TPU tile padding; one kernel per
// direction serves them all. The plain versions of the same arithmetic are
// bitslice.encrypt_words and bitslice.decrypt_words
// (our_tree_tpu_torch/ops/bitslice.py), whose inverse S-box is the tower
// form: the kernel's dedicated inverse circuit and the plain version are two
// independent formulations that must agree.
//
// Bound. Per 16-byte block the kernel reads 16 bytes and writes 16 bytes, but
// the cipher is a boolean circuit of about 50 two-input gates per byte. At 64
// integer instructions per clock per SM the card runs out of issue slots long
// before HBM runs out of bytes, so both kernels are bound by operations:
// 14,120 a group of 32 blocks at nr 10 (chip_smoke.py's ecb_ops_per_group,
// the same count for both directions). Each kernel issues its own SASS at
// about 90 % of the card's integer rate, so its time is its instruction count.
//
// Design: ctr_gen's shape (ctr_gen.cu), with the counters replaced by loads.
//   * Each thread owns one group of 32 consecutive blocks; 128 threads make a
//     thread block. The state is 128 bit planes in registers, so each logic
//     instruction does 32 blocks of work.
//   * Each thread block builds the full-lane round-key masks once in shared
//     memory, (NR+1)*128 words.
//   * The thread loads its 32 blocks as uint4 (zero past n), and four 32x32
//     bit transposes turn them into planes. The round loop is rolled, each
//     round straight-line; four transposes turn the planes back into words,
//     and only blocks below n are stored.
//   * Encrypt (aes_bitslice.cuh): Boyar-Peralta S-box, ShiftRows as register
//     renaming, MixColumns as xtime plus XOR.
//   * Decrypt (aes_inv_bitslice.cuh), written for LOP3, which computes any
//     function of three registers: a dedicated inverse S-box,
//     A^-1 B M(U(A^-1 y ^ 0x05)) around the forward circuit's 62-gate middle
//     M, whose linear layers U' = U A^-1 and B' = A^-1 B were derived from
//     the forward layers and synthesised as 22 and 17 steps of 2- or 3-input
//     XORs (ops/xor_programs.py; the constant 0x05 as NOTs that LOP3
//     absorbs); InvShiftRows as register renaming; InvMixColumns plus
//     AddRoundKey as 113 such steps a column, each key plane in the last
//     step of its output plane; the InvMixColumns-folded schedule; the
//     transposes' 16- and 8-bit stages as byte permutes.
//   * A warp's uint4 loads and stores stride 512 bytes (each thread reads its
//     own 512 contiguous bytes); staging through shared memory for coalescing
//     is later work.
//
// Encrypt has two forms, chosen per launch by ot_ecb_encrypt (form 0, auto:
// the block form up to kEcbBlockFormMax blocks, the group form above; 1 and
// 2 force one), as ctr_mk.cu's two forms are:
//   * the group form above (ecb_encrypt_kernel), for bulk ECB: 32 blocks a
//     thread, bound by operations;
//   * the block form (ecb_encrypt_block_kernel): one block a thread on the
//     per-block core of aes_block.cuh, for few blocks. One block in the group
//     form is one thread walking a whole 32-block group (22,324 integer
//     instructions, 24 us of card): the one-block launches of byte-granular
//     CFB128 (models/aes.py AES._ecb1, one a partial step) are bound by that
//     thread's path, not by the card's rates. Each thread issues its block's
//     load before the thread block turns the schedule into key planes in
//     shared memory, so the two round trips overlap; the rounds are
//     aes_block.cuh's rolled encrypt_block. chip_smoke.py phase 9 times both
//     choices against their alternatives, the load after the barrier and
//     the rounds unrolled with the key planes loaded a round ahead (whose
//     straight-line code misses the instruction cache), in turns on the
//     card (PERF.md).
// Constant time: no address depends on key or data, only on the block index,
// the round and the word number; there are no tables. The form depends only
// on the block count.

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_block.cuh"
#include "aes_inv_bitslice.cuh"

namespace {

constexpr int kThreads = 128;
// The most blocks the auto form sends to the block form: the largest size of
// chip_smoke.py phase 9's crossing table (both forms at 1 to 2^20 blocks, in a
// CUDA graph and back to back) at which the block form was the faster;
// PERF.md holds the table.
constexpr long long kEcbBlockFormMax = 1ll << 16;
enum Form { kAuto = 0, kGroup = 1, kBlock = 2 };

template <int NR, bool DECRYPT>
__device__ __forceinline__ void ecb_body(const uint4* __restrict__ in, uint4* __restrict__ out,
                                         const uint32_t* __restrict__ rk, long long n_blocks) {
  // Full-lane round-key masks, built once per thread block.
  __shared__ uint32_t kmask[(NR + 1) * 128];
#pragma unroll
  for (int r = 0; r <= NR; ++r)
    kmask[128 * r + threadIdx.x] = aes_bitslice::key_mask(rk, 128 * r + threadIdx.x);
  __syncthreads();

  const unsigned long long g = blockIdx.x * (unsigned long long)kThreads + threadIdx.x;
  const long long first = (long long)(g * 32ull);
  if (first >= n_blocks) return;

  uint32_t s[128];
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const long long j = first + t;
    const uint4 d = j < n_blocks ? in[j] : make_uint4(0u, 0u, 0u, 0u);
    s[t] = d.x;
    s[32 + t] = d.y;
    s[64 + t] = d.z;
    s[96 + t] = d.w;
  }

  if constexpr (DECRYPT) aes_bitslice::ecb_decrypt_group<NR>(s, kmask);
  else aes_bitslice::ecb_encrypt_group<NR>(s, kmask);

#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const long long j = first + t;
    if (j < n_blocks) out[j] = make_uint4(s[t], s[32 + t], s[64 + t], s[96 + t]);
  }
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
ecb_encrypt_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                   const uint32_t* __restrict__ rk, long long n_blocks) {
  ecb_body<NR, false>(in, out, rk, n_blocks);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
ecb_decrypt_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                   const uint32_t* __restrict__ rk_dec, long long n_blocks) {
  ecb_body<NR, true>(in, out, rk_dec, n_blocks);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
ecb_encrypt_block_kernel(const uint4* __restrict__ in, uint4* __restrict__ out,
                         const uint32_t* __restrict__ rk, long long n_blocks) {
  static_assert(NR + 1 <= kThreads, "one thread per round key");
  __shared__ uint32_t kp[8 * (NR + 1)];
  const long long j = blockIdx.x * (long long)kThreads + threadIdx.x;
  const bool live = j < n_blocks;
  // The block's load goes out before the key planes are made, so its round
  // trip overlaps theirs.
  const uint4 x = live ? in[j] : make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x <= NR) aes_block::round_key_planes(rk, threadIdx.x, kp + 8 * threadIdx.x);
  __syncthreads();
  if (live) out[j] = aes_block::ecb_block<NR>(x, kp);
}

template <int NR, bool DECRYPT>
cudaError_t launch(const void* in, void* out, const void* rk, long long n_blocks,
                   cudaStream_t stream) {
  const long long groups = (n_blocks + 31) / 32;
  const unsigned int grid = (unsigned int)((groups + kThreads - 1) / kThreads);
  const uint4* src = static_cast<const uint4*>(in);
  uint4* dst = static_cast<uint4*>(out);
  const uint32_t* keys = static_cast<const uint32_t*>(rk);
  if constexpr (DECRYPT) {
    ecb_decrypt_kernel<NR><<<grid, kThreads, 0, stream>>>(src, dst, keys, n_blocks);
  } else {
    ecb_encrypt_kernel<NR><<<grid, kThreads, 0, stream>>>(src, dst, keys, n_blocks);
  }
  return cudaGetLastError();
}

template <int NR>
cudaError_t launch_block(const void* in, void* out, const void* rk, long long n_blocks,
                         cudaStream_t stream) {
  const unsigned int grid = (unsigned int)((n_blocks + kThreads - 1) / kThreads);
  ecb_encrypt_block_kernel<NR><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint4*>(in), static_cast<uint4*>(out), static_cast<const uint32_t*>(rk),
      n_blocks);
  return cudaGetLastError();
}

template <bool DECRYPT>
int dispatch(const void* in, void* out, const void* rk, long long n_blocks, int form, int nr,
             void* stream) {
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  if ((form == kBlock ? n_blocks : (n_blocks + 31) / 32) > (long long)kThreads * 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (form == kBlock) {
    switch (nr) {
      case 10: return (int)launch_block<10>(in, out, rk, n_blocks, st);
      case 12: return (int)launch_block<12>(in, out, rk, n_blocks, st);
      case 14: return (int)launch_block<14>(in, out, rk, n_blocks, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (nr) {
    case 10: return (int)launch<10, DECRYPT>(in, out, rk, n_blocks, st);
    case 12: return (int)launch<12, DECRYPT>(in, out, rk, n_blocks, st);
    case 14: return (int)launch<14, DECRYPT>(in, out, rk, n_blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The form an encrypt launch of n_blocks takes: form 1 (group) or 2 (block)
// as given, form 0 (auto) the block form up to kEcbBlockFormMax blocks; -1
// for a bad form.
extern "C" int ot_ecb_encrypt_form(long long n_blocks, int form) {
  if (form == kAuto) return n_blocks <= kEcbBlockFormMax ? kBlock : kGroup;
  return form == kGroup || form == kBlock ? form : -1;
}

// C interface for ctypes. in/out: (n_blocks, 4) u32 LE words, 16-byte aligned;
// rk: 4*(nr+1) u32 words on the card, the encrypt schedule for ot_ecb_encrypt
// and the InvMixColumns-folded decrypt schedule for ot_ecb_decrypt; form: 0
// auto, 1 group, 2 block (ot_ecb_encrypt_form). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int ot_ecb_encrypt(const void* in, void* out, const void* rk, long long n_blocks,
                              int form, int nr, void* stream) {
  form = ot_ecb_encrypt_form(n_blocks, form);
  if (form < 0) return (int)cudaErrorInvalidValue;
  return dispatch<false>(in, out, rk, n_blocks, form, nr, stream);
}

extern "C" int ot_ecb_decrypt(const void* in, void* out, const void* rk_dec,
                              long long n_blocks, int nr, void* stream) {
  return dispatch<true>(in, out, rk_dec, n_blocks, kGroup, nr, stream);
}
