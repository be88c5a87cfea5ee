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
// Group form (ctr_mk_kernel<NR>): ecb.cu's shape, for the bulk launches (the
// whole message of every gcm_seal and gcm_open, K = 1 with an all-zero slot
// vector; bulk multi-key CTR). Redesigned after measuring its former design
// (chip_smoke.py phase 9 builds it beside this one and stamps each warp's
// phases; PERF.md):
//   * Bound. At 256 MiB it is bound by operations, as ECB: a uniform group
//     runs ecb_encrypt_kernel's rounds (1,907 LOP3 a round). At K = 1 it
//     issues about 80 % of the integer rate; the rest is the counters'
//     loads, which all warps of an SM issue at once (a third of a warp's
//     time), and the store.
//   * Each thread owns one group of 32 blocks; 128 threads make a thread
//     block. It turns its 32 counters into 128 planes (byte-permute
//     transposes, transpose32_prmt), runs the rounds, turns the keystream
//     back into words, XORs the data words (XOR commutes with the
//     transpose) and stores the blocks below n. At K > 1 the group is 32
//     consecutive blocks, so a request's run of slots stays in one group; at
//     K = 1 (every slot clamps to 0, so the slot vector is not read) lane l
//     of a warp takes blocks l, l + 32, ... of the warp's 1,024, so that
//     each of the warp's loads and stores is 512 contiguous bytes.
//   * The prologue (K > 1). A thread's 32 slots are 128 contiguous bytes,
//     read as 8 16-byte loads (one at a time only for the ragged last group
//     or a slot vector not 16-byte aligned); its 32 counters are issued
//     right after them, both before the thread block's key prologue, so
//     their round trips overlap it. The warp votes on the slots it holds in
//     registers, and only a warp that falls back to the transposes (below)
//     writes offsets. The former design read 32 scalar slots with the lanes
//     128 B apart and wrote 32 offsets before its vote, every warp: at the
//     seal's launch about 0.15 ms of its 1.01.
//   * Keys as full-lane masks in shared memory, built once a thread block
//     (aes_mk.cuh: 128 (NR+1) + 4 words a schedule, 5,648 B at nr 10 and
//     7,696 B at nr 14), for K up to kMaskSlotsMax. A uniform warp runs
//     ECB's keyed rounds on its slot's masks, the key folded into
//     MixColumns' XORs; the former design made each round's masks from the
//     words with two shifts a plane on the integer pipe (2,157 a round).
//     The cap: at 255 registers an SM holds 2 of these 128-thread blocks,
//     so each may take about 113 KB of the 227 KB of shared memory. K = 8
//     schedules' masks take 45-62 KB (with the words and the offsets below
//     55-72 KB, above the 48 KB that needs
//     cudaFuncAttributeMaxDynamicSharedMemorySize) and keep 2 blocks an SM;
//     16 at nr 14 would not (an earlier note counted K copies of the masks
//     as too many; against 113 KB a block they are not).
//     Building K masks costs K (NR+1) stores a thread, about 5 % of a warp's
//     time at K = 8. Above the cap the keys stay words (K * 4(NR+1) u32) and
//     a uniform warp makes its masks on the fly, as the former design did.
//   * Mixed warps (a group whose 32 blocks do not share a slot). With the
//     masks in shared memory and at most kSelectSlots distinct slots in each
//     group of the warp, a round's key plane is the select
//     XOR_d (mask_d & lanes_d) over the group's distinct slots: the lane
//     sets come from the slots the thread holds, and a plane costs D more
//     three-input operations, no gather and no transpose (2,427 a round
//     against the former 3,794). Otherwise (more distinct slots, or K
//     above the cap) per round and column the 32 blocks' key words are read
//     from shared memory by slot, transposed into 32 planes and XORed in,
//     each thread's 32 offsets in shared memory (aes_bitslice.cuh
//     add_round_key_mixed), as the former design did. On 2 slots instead
//     of 4, more warps fall back, and 256 MiB in runs of 1-300 takes 2.3x
//     as long.
//   * Each key form is an instantiation of its own, so no round loop has a
//     branch and each form gets its own register allocation; the form is
//     chosen per warp.
//   * A slot outside [0, K) is clamped into it (below 0 to 0, from K up to
//     K - 1) on every path, so a bad slot vector can give wrong output for
//     its blocks but never a read outside the schedules. The wrapper refuses
//     such a vector on the CPU.
//   * chip_smoke.py builds this file again with OT_CTR_MK_PROBE for its
//     measurements: the stamped instantiation, the design's steps one at a
//     time, a pipelined K = 1 kernel that was not kept, and each launch's
//     shape and resident blocks. The port's library has none of them.
// Constant time: load addresses depend on the block index, the round, the
// word or plane number and the public slot vector, never on key or data; the
// branches (uniform, select or transposes) read only slots, and the form
// depends only on the block count and K. There are no tables.

#include <cstdint>
#include <cuda_runtime.h>

#include "aes_bitslice.cuh"
#include "aes_block.cuh"
#include "aes_mk.cuh"

namespace {

constexpr int kThreads = 128;
// The most schedules one launch takes (the wrapper's cap).
constexpr int kMaxSlots = 64;
// The most schedules whose masks the group form keeps in shared memory (the
// header note says why 8).
constexpr int kMaskSlotsMax = 8;
// The most distinct slots a group may hold for the select form.
constexpr int kSelectSlots = 4;
// The most blocks the auto form sends to the block form: the largest size
// of chip_smoke.py phase 9's table (both forms at 32 to 2^24 blocks, K = 8,
// one slot and random slots) at which the block form was the faster with
// one slot as well as with random slots; PERF.md holds the table (2^18
// since the table first held 2^17 to 2^19: up to 2^18 the group
// form fills at most 64 SMs, one group a thread).
constexpr long long kBlockFormMax = 1ll << 18;
enum Form { kAuto = 0, kGroup = 1, kBlock = 2 };
// The group kernel's design steps, as flags of its body: keys as masks in
// shared memory (up to kMaskSlotsMax schedules), the select form for mixed
// warps, the slots as 16-byte loads, the byte-permute transposes, two
// distinct slots for the select form instead of kSelectSlots, stamps, at
// K = 1 a warp's blocks dealt to its lanes in turn (lane l takes blocks l,
// l + 32, ... of the warp's 1,024), so that each load and store of the warp
// is 512 contiguous bytes, and at K = 1 the probe build's pipelined kernel
// (ctr_mk_k1_kernel). The port's kernel is kGroupSteps; the others exist
// only in the probe build.
enum Step {
  kMasks = 1, kSelect = 2, kVecSlots = 4, kPrmt = 8, kSelect2 = 16, kStamp = 32, kStrided = 64,
  kPipeline = 128
};
constexpr int kGroupSteps = kMasks | kSelect | kVecSlots | kPrmt | kStrided;
// Each warp's form in the group kernel, as its stamps record it.
enum KeyForm { kUniformMasks = 0, kUniformWords = 1, kSelectMasks = 2, kMixedWords = 3 };
// int64 words a warp's row of stamps holds.
constexpr int kStampWords = 8;

__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : : "memory");
  return t;
}

// The clock once dep is in its register: a volatile store of it comes first.
__device__ __forceinline__ long long clock_after(uint32_t dep, long long* sink) {
  long long t;
  asm volatile("st.volatile.global.u32 [%1], %2;\n\tmov.u64 %0, %%clock64;"
               : "=l"(t) : "l"(sink), "r"(dep) : "memory");
  return t;
}

__device__ __forceinline__ int clamp_slot(int s, int k) { return min(max(s, 0), k - 1); }

// Shared memory of a group-form launch: the masks (when kept), the words, and
// the mixed-word form's offsets (with a slot vector).
template <int NR, int STEPS>
size_t group_smem(int k, bool slots) {
  const bool masked = (STEPS & kMasks) && k <= kMaskSlotsMax;
  return sizeof(uint32_t) * ((masked ? (size_t)k * aes_mk::kMaskStride<NR> : 0) +
                             (size_t)k * 4 * (NR + 1)) +
         (slots ? 32 * kThreads * sizeof(uint16_t) : 0);
}

// One thread's group of 32 blocks. With kStamp (the probe build's
// instrumented instantiation only), lane 0 of each warp that holds a block
// writes its warp's row of stamps: SM cycles at entry, once the slots have
// arrived (the counters' loads issued), after the key prologue's barrier,
// once the counters have arrived, after the vote and the form's set-up,
// after the last round, once the store is visible (a fence); then the SM's
// id times 4 plus the warp's KeyForm.
template <int NR, int STEPS>
__device__ __forceinline__ void ctr_mk_body(const uint4* __restrict__ data,
                                            uint4* __restrict__ out,
                                            const uint4* __restrict__ ctr,
                                            const int32_t* __restrict__ slots,
                                            const uint32_t* __restrict__ rks, long long n_blocks,
                                            int k, long long* stamps) {
  constexpr int kWords = 4 * (NR + 1);
  constexpr int kStride = aes_mk::kMaskStride<NR>;
  constexpr bool kStamped = (STEPS & kStamp) != 0;
  constexpr int D = (STEPS & kSelect2) ? 2 : kSelectSlots;
  const bool masked = (STEPS & kMasks) && k <= kMaskSlotsMax;
  // The masks (when kept), the K schedules as words, then each thread's 32
  // schedule offsets for the mixed-word form (u16, offset t of thread i at
  // [t * kThreads + i]).
  extern __shared__ uint4 smem4[];
  uint32_t* const masks = reinterpret_cast<uint32_t*>(smem4);
  uint32_t* const keys = masks + (masked ? k * kStride : 0);
  uint16_t* const offs = reinterpret_cast<uint16_t*>(keys + k * kWords);
  long long t[7] = {0, 0, 0, 0, 0, 0, 0};
  long long* row = nullptr;
  if constexpr (kStamped) {
    row = stamps + kStampWords * ((blockIdx.x * (long long)kThreads + threadIdx.x) / 32);
    t[0] = clock_now();
  }

  const unsigned long long g = blockIdx.x * (unsigned long long)kThreads + threadIdx.x;
  const long long first = (long long)(g * 32ull);
  // Block i of this thread's group: at K = 1 (every slot clamps to 0, so the
  // slot vector need not be read) lane l of a warp takes blocks l, l + 32,
  // ... of the warp's 1,024; otherwise the thread takes 32 consecutive
  // blocks, so that a request's run of slots stays in one group.
  const bool strided = (STEPS & kStrided) && k == 1;
  const long long base = strided ? first - 31 * (long long)(threadIdx.x & 31) : first;
  const int step = strided ? 32 : 1;
  const bool live = base < n_blocks;
  const int nv = live ? (int)min(32ll, n_blocks - first) : 0;

  // The slots (clamped; padding past n rides the group's first slot, so a
  // short last group of one request stays uniform; its output is not
  // stored), then the counters, before the key prologue.
  int sl[32];
  if (slots != nullptr && live && !strided) {
    if ((STEPS & kVecSlots) && nv == 32 &&
        (reinterpret_cast<uintptr_t>(slots) & 15) == 0) {
      const int4* v = reinterpret_cast<const int4*>(slots + first);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int4 x = v[q];
        sl[4 * q] = x.x;
        sl[4 * q + 1] = x.y;
        sl[4 * q + 2] = x.z;
        sl[4 * q + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) sl[i] = i < nv ? slots[first + i] : slots[first];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) sl[i] = 0;
  }
  uint32_t s[128];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const long long j = base + i * step;
    const uint4 c = j < n_blocks ? ctr[j] : make_uint4(0u, 0u, 0u, 0u);
    s[i] = c.x;
    s[32 + i] = c.y;
    s[64 + i] = c.z;
    s[96 + i] = c.w;
  }
  bool uniform = true;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sl[i] = clamp_slot(sl[i], k);
    uniform &= sl[i] == sl[0];
  }
  const int s0 = sl[0];
  if constexpr (kStamped) t[1] = clock_after((uint32_t)s0 ^ (uint32_t)uniform, row + 7);

  for (int i = threadIdx.x; i < k * kWords; i += kThreads) keys[i] = rks[i];
  if (masked) aes_mk::build_masks<NR>(rks, k, masks, threadIdx.x, kThreads);
  __syncthreads();
  if constexpr (kStamped) {
    t[2] = clock_now();
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < 128; ++i) x ^= s[i];
    t[3] = clock_after(x, row + 7);
  }

  // One key form a warp (the whole warp votes, lanes past n as uniform): a
  // warp whose groups disagree would run two forms one after the other.
  int form = masked ? kUniformMasks : kUniformWords;
  uint32_t soff[D], lanes[D];
  if (!__all_sync(0xFFFFFFFFu, uniform)) {
    form = kMixedWords;
    if constexpr ((STEPS & kSelect) != 0) {
      if (masked) {
        int sd[D];
        const int distinct = aes_mk::group_slots<D>(sl, sd, lanes);
#pragma unroll
        for (int d = 0; d < D; ++d) soff[d] = (uint32_t)(sd[d] * kStride);
        if (__all_sync(0xFFFFFFFFu, distinct <= D)) form = kSelectMasks;
      }
    }
    if (form == kMixedWords) {
#pragma unroll
      for (int i = 0; i < 32; ++i) offs[i * kThreads + threadIdx.x] = (uint16_t)(sl[i] * kWords);
    }
  }
  if (!live) return;
  if constexpr (kStamped) t[4] = clock_now();

  constexpr bool kP = (STEPS & kPrmt) != 0;
  if (form == kUniformMasks) {
    aes_mk::encrypt_group_masked<NR, kP>(s, masks + s0 * kStride);
  } else if (form == kUniformWords) {
    aes_bitslice::mk_encrypt_group<NR, true>(s, keys, (uint32_t)(s0 * kWords), offs, kThreads);
  } else if (form == kMixedWords) {
    aes_bitslice::mk_encrypt_group<NR, false>(s, keys, (uint32_t)(s0 * kWords),
                                              offs + threadIdx.x, kThreads);
  } else if constexpr ((STEPS & kSelect) != 0) {
    aes_mk::encrypt_group_select<NR, D, kP>(s, masks, soff, lanes);
  }
  if constexpr (kStamped) {
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < 128; ++i) x ^= s[i];
    t[5] = clock_after(x, row + 7);
  }

#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const long long j = base + i * step;
    if (j < n_blocks) {
      const uint4 d = data[j];
      out[j] = make_uint4(d.x ^ s[i], d.y ^ s[32 + i], d.z ^ s[64 + i], d.w ^ s[96 + i]);
    }
  }
  if constexpr (kStamped) {
    __threadfence();
    t[6] = clock_now();
    if ((threadIdx.x & 31) == 0) {
      unsigned int sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      for (int i = 0; i < 7; ++i) row[i] = t[i];
      row[7] = 4ll * sm + form;
    }
  }
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
ctr_mk_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
              const uint4* __restrict__ ctr, const int32_t* __restrict__ slots,
              const uint32_t* __restrict__ rks, long long n_blocks, int k) {
  ctr_mk_body<NR, kGroupSteps>(data, out, ctr, slots, rks, n_blocks, k, nullptr);
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

// A group-form launch of the kernel body<NR, STEPS>: the grid, its shared
// memory, and the opt-in above 48 KB.
template <int NR, int STEPS, class Kernel>
cudaError_t launch_group(Kernel kernel, const void* data, void* out, const void* ctr,
                         const void* slots, const void* rks, long long n_blocks, int k,
                         cudaStream_t stream, long long* stamps = nullptr) {
  const long long groups = (n_blocks + 31) / 32;
  const unsigned int grid = (unsigned int)((groups + kThreads - 1) / kThreads);
  const size_t smem = group_smem<NR, STEPS>(k, slots != nullptr);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const uint4* d = static_cast<const uint4*>(data);
  const uint4* c = static_cast<const uint4*>(ctr);
  const int32_t* sl = static_cast<const int32_t*>(slots);
  const uint32_t* rk = static_cast<const uint32_t*>(rks);
  if constexpr ((STEPS & kStamp) != 0)
    kernel<<<grid, kThreads, smem, stream>>>(d, static_cast<uint4*>(out), c, sl, rk, n_blocks, k,
                                             stamps);
  else
    kernel<<<grid, kThreads, smem, stream>>>(d, static_cast<uint4*>(out), c, sl, rk, n_blocks, k);
  return cudaGetLastError();
}

template <int NR>
cudaError_t launch(const void* data, void* out, const void* ctr, const void* slots,
                   const void* rks, long long n_blocks, int k, int form, cudaStream_t stream) {
  if (form == kBlock) return launch_block<NR>(data, out, ctr, slots, rks, n_blocks, k, stream);
  return launch_group<NR, kGroupSteps>(ctr_mk_kernel<NR>, data, out, ctr, slots, rks, n_blocks,
                                       k, stream);
}

bool bad_args(long long n_blocks, int k, const void* slots, int form) {
  return n_blocks <= 0 || k < 1 || k > kMaxSlots || (slots == nullptr && k != 1) || form < 0 ||
         (form == kBlock ? n_blocks : (n_blocks + 31) / 32) > (long long)kThreads * 0x7FFFFFFFll;
}

}  // namespace


#ifdef OT_CTR_MK_PROBE
// chip_smoke.py's measurement builds of this file (nvcc -DOT_CTR_MK_PROBE=c,
// a library of its own for each code c, so that they compile in parallel; nr
// 10 only): the group kernel with the design's steps one at a time, its
// stamped instantiation, and each launch's shape. None of it is in the
// port's library.
namespace {

// The pipelined K = 1 kernel: tiles of 1,024 blocks a warp takes in turn.
constexpr int kTilesPerWarp = 4;

// Shared memory of a pipelined K = 1 launch: the schedule's masks and each
// warp's 1,024 counters.
template <int NR>
size_t k1_smem() {
  return sizeof(uint32_t) * aes_mk::kMaskStride<NR> + (kThreads / 32) * 1024 * sizeof(uint4);
}

// 16 bytes from global to shared memory without a register (cp.async; zero
// fill when !full, src then unread).
__device__ __forceinline__ void copy16_async(uint4* dst, const uint4* src, bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(full ? 16 : 0) : "memory");
}

// Lane l's 32 counters of tile t (blocks t * 1,024 + l + 32 i) into its own
// slots of the warp's buffer (buf[32 i + l]), asynchronously.
__device__ __forceinline__ void prefetch_tile(uint4* buf, const uint4* __restrict__ ctr,
                                              long long t, int lane, long long n_blocks) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const long long j = t * 1024 + 32 * i + lane;
    copy16_async(buf + 32 * i + lane, ctr + (j < n_blocks ? j : 0), j < n_blocks);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// A design not kept (PERF.md: about 2 % slower than the port's
// kernel at K = 1): the group form at K = 1 pipelined. Each warp takes
// kTilesPerWarp consecutive tiles of 1,024 blocks, lane l blocks l, l + 32,
// ... of each, and while it runs one tile's rounds the next tile's counters
// come into its 16 KB of shared memory by cp.async, so after the first tile
// no warp waits for its counters. The keys are the one schedule's masks;
// the rounds are a uniform group's (aes_mk::encrypt_group_masked).
template <int NR, bool PRMT>
__global__ void __launch_bounds__(kThreads)
ctr_mk_k1_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
                 const uint4* __restrict__ ctr, const uint32_t* __restrict__ rk,
                 long long n_blocks) {
  extern __shared__ uint4 smem4[];
  uint32_t* const masks = reinterpret_cast<uint32_t*>(smem4);
  uint4* const buf = smem4 + aes_mk::kMaskStride<NR> / 4 + (threadIdx.x / 32) * 1024;
  const int lane = threadIdx.x & 31;
  const long long tiles = (n_blocks + 1023) / 1024;
  long long t = (blockIdx.x * (long long)kThreads + threadIdx.x) / 32 * kTilesPerWarp;
  const long long end = min(t + kTilesPerWarp, tiles);
  if (t < end) prefetch_tile(buf, ctr, t, lane, n_blocks);
  aes_mk::build_masks<NR>(rk, 1, masks, threadIdx.x, kThreads);
  __syncthreads();
  for (; t < end; ++t) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    uint32_t s[128];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const uint4 c = buf[32 * i + lane];
      s[i] = c.x;
      s[32 + i] = c.y;
      s[64 + i] = c.z;
      s[96 + i] = c.w;
    }
    // Each lane refills only its own slots, which it has just read.
    if (t + 1 < end) prefetch_tile(buf, ctr, t + 1, lane, n_blocks);
    aes_mk::encrypt_group_masked<NR, PRMT>(s, masks);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const long long j = t * 1024 + 32 * i + lane;
      if (j < n_blocks) {
        const uint4 d = data[j];
        out[j] = make_uint4(d.x ^ s[i], d.y ^ s[32 + i], d.z ^ s[64 + i], d.w ^ s[96 + i]);
      }
    }
  }
}

// A launch of the pipelined K = 1 kernel (every slot of a K = 1 launch
// clamps to 0, so the slot vector is not read).
template <int NR, bool PRMT>
cudaError_t launch_k1(const void* data, void* out, const void* ctr, const void* rks,
                      long long n_blocks, cudaStream_t stream) {
  const long long warps = ((n_blocks + 1023) / 1024 + kTilesPerWarp - 1) / kTilesPerWarp;
  const unsigned int grid = (unsigned int)((warps * 32 + kThreads - 1) / kThreads);
  const size_t smem = k1_smem<NR>();
  const cudaError_t e = cudaFuncSetAttribute(
      ctr_mk_k1_kernel<NR, PRMT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  ctr_mk_k1_kernel<NR, PRMT><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint4*>(data), static_cast<uint4*>(out), static_cast<const uint4*>(ctr),
      static_cast<const uint32_t*>(rks), n_blocks);
  return cudaGetLastError();
}

// A group-form launch with the design steps STEPS: at K = 1 the pipelined
// kernel if STEPS has it, else the body's kernel.
template <int NR, int STEPS, class Kernel>
cudaError_t launch_steps(Kernel kernel, const void* data, void* out, const void* ctr,
                         const void* slots, const void* rks, long long n_blocks, int k,
                         cudaStream_t stream, long long* stamps = nullptr) {
  if constexpr ((STEPS & kPipeline) != 0) {
    if (k == 1) return launch_k1<NR, (STEPS & kPrmt) != 0>(data, out, ctr, rks, n_blocks, stream);
  }
  return launch_group<NR, STEPS>(kernel, data, out, ctr, slots, rks, n_blocks, k, stream, stamps);
}

template <int STEPS>
__global__ void __launch_bounds__(kThreads)
ctr_mk_steps_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
                    const uint4* __restrict__ ctr, const int32_t* __restrict__ slots,
                    const uint32_t* __restrict__ rks, long long n_blocks, int k) {
  ctr_mk_body<10, STEPS>(data, out, ctr, slots, rks, n_blocks, k, nullptr);
}

template <int NR>
__global__ void __launch_bounds__(kThreads)
ctr_mk_stamped_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
                      const uint4* __restrict__ ctr, const int32_t* __restrict__ slots,
                      const uint32_t* __restrict__ rks, long long n_blocks, int k,
                      long long* stamps) {
  ctr_mk_body<NR, kGroupSteps | kStamp>(data, out, ctr, slots, rks, n_blocks, k, stamps);
}

// The probe's kernels by code: 0 the port's kernel, 1 the new prologue alone
// (the former word forms, each thread's blocks consecutive), 2 without the
// select form (mixed warps by transposes), 3 the select form on at most 2
// slots, 4 without the byte-permute transposes, 5 the slots as scalar
// loads, 6 the port's kernel stamped, 7 each thread's blocks consecutive at
// K = 1 too, 8 the pipelined kernel at K = 1.
constexpr int kProbeCode = OT_CTR_MK_PROBE;
constexpr int kProbeSteps[] = {kGroupSteps, kVecSlots, kGroupSteps & ~kSelect,
                               kGroupSteps | kSelect2, kGroupSteps & ~kPrmt,
                               kGroupSteps & ~kVecSlots, kGroupSteps | kStamp,
                               kGroupSteps & ~kStrided, kGroupSteps | kPipeline};
constexpr int kSteps = kProbeSteps[kProbeCode];

auto probe_kernel() {
  if constexpr (kProbeCode == 0) return ctr_mk_kernel<10>;
  else if constexpr (kProbeCode == 6) return ctr_mk_stamped_kernel<10>;
  else return ctr_mk_steps_kernel<kSteps>;
}

}  // namespace

// Launch this build's kernel on ot_ctr_mk's arguments at nr 10, in the
// group form; the stamped one (code 6) writes one row a warp to stamps,
// (ceil(n_blocks / 1024), 8) int64 on the card, zeroed by the caller.
extern "C" int ot_ctr_mk_probe(const void* data, void* out, const void* ctr_le, const void* slots,
                               const void* rks, long long n_blocks, int k, void* stamps,
                               void* stream) {
  if (bad_args(n_blocks, k, slots, kGroup) || (kProbeCode == 6 && stamps == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)launch_steps<10, kSteps>(probe_kernel(), data, out, ctr_le, slots, rks, n_blocks,
                                       k, static_cast<cudaStream_t>(stream),
                                       static_cast<long long*>(stamps));
}

// The shape of such a launch with or without a slot vector: shape[0..2] =
// grid, dynamic shared memory, resident thread blocks an SM (the occupancy
// API).
extern "C" int ot_ctr_mk_probe_shape(long long n_blocks, int k, int slots, long long* shape) {
  if ((kSteps & kPipeline) != 0 && k == 1) {
    const size_t smem = k1_smem<10>();
    const auto kernel = ctr_mk_k1_kernel<10, (kSteps & kPrmt) != 0>;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int blocks = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
    const long long warps = ((n_blocks + 1023) / 1024 + kTilesPerWarp - 1) / kTilesPerWarp;
    shape[0] = (warps * 32 + kThreads - 1) / kThreads;
    shape[1] = (long long)smem;
    shape[2] = blocks;
    return (int)e;
  }
  const size_t smem = group_smem<10, kSteps>(k, slots != 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        probe_kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_kernel(), kThreads, smem);
  shape[0] = ((n_blocks + 31) / 32 + kThreads - 1) / kThreads;
  shape[1] = (long long)smem;
  shape[2] = blocks;
  return (int)e;
}
#else
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
  if (bad_args(n_blocks, k, slots, form)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nr) {
    case 10: return (int)launch<10>(data, out, ctr_le, slots, rks, n_blocks, k, form, st);
    case 12: return (int)launch<12>(data, out, ctr_le, slots, rks, n_blocks, k, form, st);
    case 14: return (int)launch<14>(data, out, ctr_le, slots, rks, n_blocks, k, form, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // OT_CTR_MK_PROBE
