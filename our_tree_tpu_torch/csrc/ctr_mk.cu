// Multi-key scattered AES-CTR for Hopper (sm_90a):
// out[i] = data[i] ^ E_{rks[slot[i]]}(ctr_le[i]), every block's counter given.
//
// Replaces the TPU kernel _ctr_scat_mk_kernel (our_tree_tpu/ops/pallas_aes.py:
// 767-781, launched at :800 by _ctr_scat_mk_pallas), the multi-key seam of
// every Pallas engine name, which the serve path runs for every batch. With
// slots == NULL (K = 1) it also replaces _ctr_kernel (pallas_aes.py:476-482,
// launched at :491 by _ctr_planes_pallas, entry ctr_crypt_words): single-key
// CTR over materialised counters. The TPU kernel's dense (128, W) boundary and
// its slot lane masks exist for TPU tiling; none of that is carried over. The
// plain versions are ctr_scattered_multikey_plain and
// ctr_crypt_words_explicit_plain (our_tree_tpu_torch/ops/cuda_aes.py).
//
// Bound. Per block the function reads 16 bytes of data, 16 of counter and 4
// of slot and writes 16: 52 bytes against the same boolean circuit as ECB
// (about 50 two-input gates per byte). At 256 MiB it is bound by operations,
// like ecb.cu. At a serve rung it is bound by neither: its time is the
// dependent path through a thread's work plus the launch, which the block
// form below shortens; chip_smoke.py records both bounds and both forms.
//
// Two forms, chosen per launch by ot_ctr_mk (form 0, auto: the block form up
// to kBlockFormMax blocks, the group form above; 1 and 2 force one):
//
// Block form (ctr_mk_block_kernel<NR>): one block per thread in the
// per-block bitsliced form of aes_block.cuh. A serve rung is at most 4,096
// blocks, 128 groups: the group form puts them on one 128-thread block of one
// SM, where one thread's serial pass through a whole group is the launch's
// time; the block form spreads them over 4,096 threads on 32 SMs, and a
// thread's pass is one block's rounds.
//   * Each thread block turns the K schedules into plane-form round keys in
//     shared memory once, K * (NR+1) * 8 words (30 KB at K = 64, NR = 14).
//   * Each thread XORs in its own slot's key planes, so there are no uniform
//     and mixed groups in this form. The slot is clamped into [0, K) as in
//     the group form.
//
// Group form (ctr_mk_kernel<NR>): ecb.cu's shape, reusing its rounds
// (aes_bitslice.cuh).
//   * Each thread owns one group of 32 consecutive blocks; 128 threads make a
//     thread block. It loads its 32 counters as uint4 (zero past n), turns
//     them into 128 planes, runs the rounds, turns the keystream back into
//     words, XORs the data words (XOR commutes with the transpose) and stores
//     the blocks below n.
//   * The K schedules are kept as words in shared memory, K * 4(NR+1) u32,
//     loaded once per thread block (1,920 bytes at K = 8, NR = 14). K copies
//     of ecb.cu's full-lane masks would take 45-61 KB at K = 8.
//   * Uniform group (all 32 slots equal: every group of a K = 1 call and every
//     group inside a request of 32 or more blocks): AddRoundKey XORs
//     full-lane masks made on the fly from the slot's words, as key_mask does.
//     The form is chosen per warp: uniform only if every group of the warp is.
//   * Mixed group: per round, one column at a time, the 32 blocks' round-key
//     words are read from shared memory by slot, transposed into 32 planes
//     and XORed in. Each thread's 32 schedule offsets live in shared memory,
//     not in registers.
//   * The two key forms are two instantiations of the group function, so the
//     round loop has no branch and each form its own register allocation;
//     the mixed form re-reads its offsets every round (a volatile read), and
//     neither form spills.
//   * The masked select of the TPU kernel (key planes = OR_k key_k & mask_k)
//     costs 2K operations per plane per round, 16 at K = 8 and 128 at the cap
//     of 64; the transposes cost the same at every K, so they were chosen.
//   * A slot outside [0, K) is clamped into it (below 0 to 0, from K up to
//     K - 1), so a bad slot vector can give wrong output for its blocks but
//     never a read outside the schedules. The wrapper refuses such a vector
//     on the CPU.
// Constant time: load addresses depend on the block index, the round, the
// word number and the public slot vector, never on key or data; the one
// data-dependent-looking branch (uniform or mixed) reads only slots, and the
// form depends only on the block count. There are no tables.

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_bitslice.cuh"
#include "aes_block.cuh"

namespace {

constexpr int kThreads = 128;
// The most schedules one launch takes (the wrapper's cap).
constexpr int kMaxSlots = 64;
// The most blocks the auto form sends to the block form: the largest size
// of chip_smoke.py phase 9's table (both forms at 32 to 2^24 blocks, K = 8,
// one slot and random slots) at which the block form was the faster with
// one slot as well as with random slots; PERF.md holds the table.
constexpr long long kBlockFormMax = 1ll << 16;
enum Form { kAuto = 0, kGroup = 1, kBlock = 2 };

template <int NR>
__global__ void __launch_bounds__(kThreads)
ctr_mk_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
              const uint4* __restrict__ ctr, const int32_t* __restrict__ slots,
              const uint32_t* __restrict__ rks, long long n_blocks, int k) {
  constexpr int kWords = 4 * (NR + 1);
  // K schedules as words, then each thread's 32 schedule offsets (u16,
  // offset t of thread i at [t * kThreads + i]).
  extern __shared__ uint32_t smem[];
  uint32_t* keys = smem;
  uint16_t* offs = reinterpret_cast<uint16_t*>(smem + k * kWords);
  for (int i = threadIdx.x; i < k * kWords; i += kThreads) keys[i] = rks[i];
  __syncthreads();

  const unsigned long long g = blockIdx.x * (unsigned long long)kThreads + threadIdx.x;
  const long long first = (long long)(g * 32ull);
  if (first >= n_blocks) return;

  bool uniform = true;
  uint32_t off0 = 0;
  if (slots != nullptr) {
    const int s0 = min(max(slots[first], 0), k - 1);
    off0 = (uint32_t)(s0 * kWords);
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const long long j = first + t;
      // Padding past n rides the group's first slot, so a short last group
      // of one request stays uniform; its output is not stored.
      const int sl = j < n_blocks ? min(max(slots[j], 0), k - 1) : s0;
      offs[t * kThreads + threadIdx.x] = (uint16_t)(sl * kWords);
      uniform &= sl == s0;
    }
  }

  uint32_t s[128];
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const long long j = first + t;
    const uint4 c = j < n_blocks ? ctr[j] : make_uint4(0u, 0u, 0u, 0u);
    s[t] = c.x;
    s[32 + t] = c.y;
    s[64 + t] = c.z;
    s[96 + t] = c.w;
  }

  // One key form per warp: a warp whose groups disagree would run both
  // forms one after the other, so any mixed group sends the whole warp down
  // the mixed form (which is right for a uniform group too).
  uniform = __all_sync(__activemask(), uniform);
  if (uniform) aes_bitslice::mk_encrypt_group<NR, true>(s, keys, off0, offs, kThreads);
  else aes_bitslice::mk_encrypt_group<NR, false>(s, keys, off0, offs + threadIdx.x, kThreads);

#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const long long j = first + t;
    if (j < n_blocks) {
      const uint4 d = data[j];
      out[j] = make_uint4(d.x ^ s[t], d.y ^ s[32 + t], d.z ^ s[64 + t], d.w ^ s[96 + t]);
    }
  }
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
ctr_mk_block_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
                    const uint4* __restrict__ ctr, const int32_t* __restrict__ slots,
                    const uint32_t* __restrict__ rks, long long n_blocks, int k) {
  constexpr int kRounds = NR + 1;
  // K schedules' key planes, slot j's round r at kp + 8 (j kRounds + r).
  extern __shared__ uint32_t kp[];
  for (int i = threadIdx.x; i < k * kRounds; i += kThreads)
    aes_block::round_key_planes(rks + (i / kRounds) * 4 * kRounds, i % kRounds, kp + 8 * i);
  __syncthreads();

  const long long j = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (j >= n_blocks) return;
  const int sl = slots != nullptr ? min(max(slots[j], 0), k - 1) : 0;
  out[j] = aes_block::ctr_block<NR>(ctr[j], data[j], kp + 8 * kRounds * sl);
}

template <int NR>
cudaError_t launch_block(const void* data, void* out, const void* ctr, const void* slots,
                         const void* rks, long long n_blocks, int k, cudaStream_t stream) {
  const unsigned int grid = (unsigned int)((n_blocks + kThreads - 1) / kThreads);
  const size_t smem = (size_t)k * 8 * (NR + 1) * sizeof(uint32_t);
  ctr_mk_block_kernel<NR><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint4*>(data), static_cast<uint4*>(out),
      static_cast<const uint4*>(ctr), static_cast<const int32_t*>(slots),
      static_cast<const uint32_t*>(rks), n_blocks, k);
  return cudaGetLastError();
}

template <int NR>
cudaError_t launch(const void* data, void* out, const void* ctr, const void* slots,
                   const void* rks, long long n_blocks, int k, int form, cudaStream_t stream) {
  if (form == kBlock) return launch_block<NR>(data, out, ctr, slots, rks, n_blocks, k, stream);
  const long long groups = (n_blocks + 31) / 32;
  const unsigned int grid = (unsigned int)((groups + kThreads - 1) / kThreads);
  const size_t smem = (size_t)k * 4 * (NR + 1) * sizeof(uint32_t) +
                      (slots != nullptr ? 32 * kThreads * sizeof(uint16_t) : 0);
  ctr_mk_kernel<NR><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint4*>(data), static_cast<uint4*>(out),
      static_cast<const uint4*>(ctr), static_cast<const int32_t*>(slots),
      static_cast<const uint32_t*>(rks), n_blocks, k);
  return cudaGetLastError();
}

}  // namespace

// The form a launch of n_blocks takes: form 1 (group) or 2 (block) as given,
// form 0 (auto) the block form up to kBlockFormMax blocks; -1 for a bad form.
extern "C" int ot_ctr_mk_form(long long n_blocks, int form) {
  if (form == kAuto) return n_blocks <= kBlockFormMax ? kBlock : kGroup;
  return form == kGroup || form == kBlock ? form : -1;
}

// C interface for ctypes. data/out/ctr_le: (n_blocks, 4) u32 LE words, 16-byte
// aligned; slots: (n_blocks,) int32 schedule index per block, or NULL for one
// schedule (then k must be 1); rks: (k, 4*(nr+1)) u32 encrypt schedules, all
// on the card; 1 <= k <= 64; form: 0 auto, 1 group, 2 block
// (ot_ctr_mk_form). Returns the cudaError_t of the launch (0 on success).
extern "C" int ot_ctr_mk(const void* data, void* out, const void* ctr_le, const void* slots,
                         const void* rks, long long n_blocks, int k, int form, int nr,
                         void* stream) {
  form = ot_ctr_mk_form(n_blocks, form);
  if (n_blocks <= 0 || k < 1 || k > kMaxSlots || (slots == nullptr && k != 1) || form < 0)
    return (int)cudaErrorInvalidValue;
  if ((form == kBlock ? n_blocks : (n_blocks + 31) / 32) > (long long)kThreads * 0x7FFFFFFFll)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nr) {
    case 10: return (int)launch<10>(data, out, ctr_le, slots, rks, n_blocks, k, form, st);
    case 12: return (int)launch<12>(data, out, ctr_le, slots, rks, n_blocks, k, form, st);
    case 14: return (int)launch<14>(data, out, ctr_le, slots, rks, n_blocks, k, form, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
