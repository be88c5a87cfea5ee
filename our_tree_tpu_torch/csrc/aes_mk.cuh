// The multi-key group forms of ctr_mk.cu's group kernel (ctr_mk_kernel) on
// the K schedules' full-lane round-key masks in shared memory (up to the
// kernel's mask cap, kMaskSlotsMax): a group of 32 blocks in 128 bit planes,
// as in aes_bitslice.cuh, each block under the schedule its public slot
// names. Above the cap the kernel keeps the word forms of aes_bitslice.cuh
// (mk_encrypt_group), whose keys are made from the schedule words.
//   * Masks: schedule s's mask i (key_mask of its words) at
//     masks[s * kMaskStride<NR> + i]. The 4 words of padding a schedule put
//     slot s's masks 4s banks along, so the threads of a warp that read one
//     plane under up to 8 different slots hit 8 different banks (and one
//     slot is a broadcast), and every schedule's masks stay 16-byte aligned.
//   * Uniform group (every block on one slot): ECB's rounds (ecb_encrypt_group
//     with the slot's masks), the key folded into MixColumns' XORs.
//   * Mixed group with at most D distinct slots: plane i of a round's key is
//     XOR_d (mask_d[i] & lanes_d), lanes_d the blocks (lane bits) on the d-th
//     distinct slot: one AND and D - 1 three-input XOR-ANDs a plane, no
//     gather and no transpose.
//   * PRMT: the word<->plane transposes with their 16- and 8-bit stages as
//     byte permutes (transpose32_prmt, aes_inv_bitslice.cuh).
// Mask offsets come only from the public slot vector, the round and the
// plane; nothing here reads an address that depends on key or data. Compiles
// as host C++ without nvcc (tests/test_torch_mk_host.py).

#pragma once

#include <cstdint>

#include "aes_bitslice.cuh"
#include "aes_inv_bitslice.cuh"

namespace aes_mk {

using aes_bitslice::sr;
using aes_bitslice::xtime;

// Words one schedule's masks take in shared memory: 128 (NR+1) masks and 4
// words of padding.
template <int NR>
constexpr int kMaskStride = 128 * (NR + 1) + 4;

// Schedules [0, k) of rks (rows of 4 (NR+1) words) as full-lane masks at
// masks, built by threads tid, tid + threads, ...
template <int NR>
__device__ __forceinline__ void build_masks(const uint32_t* rks, int k, uint32_t* masks, int tid,
                                            int threads) {
  for (int s = 0; s < k; ++s)
    for (int i = tid; i < 128 * (NR + 1); i += threads)
      masks[s * kMaskStride<NR> + i] = aes_bitslice::key_mask(rks + s * 4 * (NR + 1), i);
}

// The four word<->plane transposes of a group (each its own inverse).
template <bool PRMT>
__device__ __forceinline__ void transpose_group(uint32_t (&s)[128]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (PRMT) aes_bitslice::transpose32_prmt(&s[32 * c]);
    else aes_bitslice::transpose32(&s[32 * c]);
  }
}

// AES encrypt of one group of 32 blocks in place, all under the schedule
// whose masks are at kmask. On entry and on return s[32c + t] is word c of
// block t. Without PRMT this is ecb_encrypt_group.
template <int NR, bool PRMT>
__device__ __forceinline__ void encrypt_group_masked(uint32_t (&s)[128], const uint32_t* kmask) {
  transpose_group<PRMT>(s);
#pragma unroll
  for (int k = 0; k < 128; ++k) s[k] ^= kmask[k];
#pragma unroll 1
  for (int r = 1; r < NR; ++r) aes_bitslice::aes_round<false>(s, kmask + 128 * r);
  aes_bitslice::aes_round<true>(s, kmask + 128 * NR);
  transpose_group<PRMT>(s);
}

// Round r's key planes for a group on up to D slots: plane i is
// XOR_d (masks[off[d] + 128 r + i] & lanes[d]). The lane sets are disjoint
// and cover the group; an unused d has lanes 0 (and any valid offset).
template <int D>
struct SelectKey {
  const uint32_t* m[D];
  uint32_t l[D];

  __device__ __forceinline__ SelectKey(const uint32_t* masks, const uint32_t (&off)[D],
                                       const uint32_t (&lanes)[D], int r) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      m[d] = masks + off[d] + 128 * r;
      l[d] = lanes[d];
    }
  }

  __device__ __forceinline__ uint32_t operator()(int i) const {
    uint32_t k = m[0][i] & l[0];
#pragma unroll
    for (int d = 1; d < D; ++d) k ^= m[d][i] & l[d];
    return k;
  }
};

// One round with its key planes from key(i): aes_bitslice::aes_round (keyed)
// with the key read through a function.
template <bool LAST, class Key>
__device__ __forceinline__ void aes_round_with(uint32_t (&s)[128], const Key& key) {
#pragma unroll
  for (int p = 0; p < 16; ++p) aes_bitslice::sbox_bp(&s[8 * p]);
  uint32_t o[128];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t a[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int b = 0; b < 8; ++b) a[r][b] = s[8 * sr(4 * c + r) + b];
    if (LAST) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int b = 0; b < 8; ++b) o[32 * c + 8 * r + b] = a[r][b] ^ key(32 * c + 8 * r + b);
    } else {
      uint32_t t[4][8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int b = 0; b < 8; ++b) t[r][b] = a[r][b] ^ a[(r + 1) % 4][b];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t xt[8];
        xtime(t[r], xt);
#pragma unroll
        for (int b = 0; b < 8; ++b)
          o[32 * c + 8 * r + b] = xt[b] ^ t[r][b] ^ t[(r + 2) % 4][b] ^ a[r][b] ^
                                  key(32 * c + 8 * r + b);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 128; ++k) s[k] = o[k];
}

// AES encrypt of one group of 32 blocks in place, block t under the slot d
// whose lanes[d] holds bit t, slot d's masks at masks + off[d]. On entry and
// on return s[32c + t] is word c of block t.
template <int NR, int D, bool PRMT>
__device__ __forceinline__ void encrypt_group_select(uint32_t (&s)[128], const uint32_t* masks,
                                                     const uint32_t (&off)[D],
                                                     const uint32_t (&lanes)[D]) {
  transpose_group<PRMT>(s);
  {
    const SelectKey<D> key(masks, off, lanes, 0);
#pragma unroll
    for (int k = 0; k < 128; ++k) s[k] ^= key(k);
  }
#pragma unroll 1
  for (int r = 1; r < NR; ++r) aes_round_with<false>(s, SelectKey<D>(masks, off, lanes, r));
  aes_round_with<true>(s, SelectKey<D>(masks, off, lanes, NR));
  transpose_group<PRMT>(s);
}

// The distinct slots of a group of 32 blocks, at most D of them, in order of
// first appearance: slot[d] and the lane bits lanes[d] of its blocks. Returns
// how many distinct slots the group holds if at most D, else a number above D
// (the caller takes another form; slot and lanes then describe the first D).
// sl[t] is block t's slot, already clamped. Unused d keep slot[0] and lanes 0.
template <int D>
__device__ __forceinline__ int group_slots(const int (&sl)[32], int (&slot)[D],
                                           uint32_t (&lanes)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    slot[d] = sl[0];
    lanes[d] = 0u;
  }
  int n = 0;
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    bool seen = false;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const bool hit = d < n && slot[d] == sl[t];
      lanes[d] |= hit ? 1u << t : 0u;
      seen |= hit;
    }
    if (!seen) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (d == n) {
          slot[d] = sl[t];
          lanes[d] = 1u << t;
        }
      }
      ++n;
    }
  }
  return n;
}

}  // namespace aes_mk
