// Bitsliced AES-ECB for Hopper (sm_90a), both directions:
// out[j] = E_K(in[j]) (ecb_encrypt_kernel) or D_K(in[j]) (ecb_decrypt_kernel).
//
// Replaces the TPU kernel _aes_kernel (our_tree_tpu/ops/pallas_aes.py:259-273,
// launched at :358 by _crypt_planes_pallas), the ECB core of every Pallas
// engine name in both directions. The TPU kernel's three boundary layouts
// (planes, grouped, dense) exist for TPU tile padding; one kernel per
// direction serves them all. The plain versions of the same arithmetic are
// bitslice.encrypt_words and bitslice.decrypt_words
// (our_tree_tpu_torch/ops/bitslice.py), whose inverse S-box is the tower
// form: the kernel's conjugated Boyar-Peralta inverse and the plain version
// are two independent formulations that must agree.
//
// Bound. Per 16-byte block the kernel reads 16 bytes and writes 16 bytes, but
// the cipher is a boolean circuit of about 50 two-input gates per byte. At 64
// integer instructions per clock per SM the card runs out of issue slots long
// before HBM runs out of bytes, so the kernel is bound by operations
// (chip_smoke.py counts them).
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
//   * Encrypt: Boyar-Peralta S-box, ShiftRows as register renaming,
//     MixColumns as xtime plus XOR. Decrypt: the inverse S-box as the
//     Boyar-Peralta core conjugated by the inverse affine map (chosen to
//     reuse the forward core ctr_gen runs, not a dedicated inverse circuit
//     such as Maximov and Ekdahl's, TCHES 2019(4)), InvShiftRows,
//     InvMixColumns as MixColumns of a x4 pre-transform, and the
//     InvMixColumns-folded schedule.
//   * A warp's uint4 loads and stores stride 512 bytes (each thread reads its
//     own 512 contiguous bytes); staging through shared memory for coalescing
//     is later work.
// Constant time: no address depends on key or data, only on the block index,
// the round and the word number; there are no tables. The arithmetic is in
// aes_bitslice.cuh.

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_bitslice.cuh"

namespace {

constexpr int kThreads = 128;

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

  aes_bitslice::ecb_group<NR, DECRYPT>(s, kmask);

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

template <bool DECRYPT>
int dispatch(const void* in, void* out, const void* rk, long long n_blocks, int nr,
             void* stream) {
  if (n_blocks <= 0) return (int)cudaErrorInvalidValue;
  if ((n_blocks + 31) / 32 > (long long)kThreads * 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nr) {
    case 10: return (int)launch<10, DECRYPT>(in, out, rk, n_blocks, st);
    case 12: return (int)launch<12, DECRYPT>(in, out, rk, n_blocks, st);
    case 14: return (int)launch<14, DECRYPT>(in, out, rk, n_blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface for ctypes. in/out: (n_blocks, 4) u32 LE words, 16-byte aligned;
// rk: 4*(nr+1) u32 words on the card, the encrypt schedule for ot_ecb_encrypt
// and the InvMixColumns-folded decrypt schedule for ot_ecb_decrypt.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ot_ecb_encrypt(const void* in, void* out, const void* rk, long long n_blocks,
                              int nr, void* stream) {
  return dispatch<false>(in, out, rk, n_blocks, nr, stream);
}

extern "C" int ot_ecb_decrypt(const void* in, void* out, const void* rk_dec,
                              long long n_blocks, int nr, void* stream) {
  return dispatch<true>(in, out, rk_dec, n_blocks, nr, stream);
}
