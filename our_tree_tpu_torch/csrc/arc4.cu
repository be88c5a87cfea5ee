// The ARC4 keystream generator (PRGA) for Hopper (sm_90a): S independent
// streams, each continued from its (x, y, m[256]) state for len bytes, the
// state written back so that a stream resumes across calls; with a data
// pointer the keystream is XORed into the data in the same pass.
//
// Counterpart of the JAX package's compiled scans, which are XLA loops and
// not Pallas kernels: keystream_scan and keystream_scan_batch
// (our_tree_tpu/models/arc4.py:59-94), prep_batch_words (:113-137) and the
// fused RC4 scan (our_tree_tpu/models/rc4.py:29-43). In PyTorch the plain
// counterpart of one compiled device loop is a Python loop of several small
// launches a byte (ops/cuda_arc4.prga_plain); this kernel is the loop on
// the card, one launch a call.
//
// Bound. Within a stream every byte depends on the one before through the
// state: a step is three shared-memory loads, two stores and a few integer
// operations, and from one byte to the next the load of m[x] waits on the
// stores, which wait on the load of b = m[y], whose address waits on the
// load of a = m[x]. So one stream runs at the latency of that recurrence,
// two dependent loads and two dependent integer steps (y + a, the address)
// a byte, whatever the bytes. Across streams the work is independent, so
// with many streams the card is bound by its shared-memory and integer
// issue rates or, for the keystream it writes, by device memory.
// chip_smoke.py reports the latency bound (that recurrence at the measured
// latencies; the longest path through this kernel's compiled loop beside
// it) and the bytes bound.
//
// Design.
//   * One thread a stream, one warp a thread block, so 4,096 streams fill
//     128 SMs with a warp each and a single stream owns an SM's scheduler.
//   * The 256-byte permutation lives in shared memory, a 32-bit word a
//     byte, interleaved across the warp's 32 lanes (arc4.cuh), so the lanes
//     never share a bank and an address is one multiply-add from its index:
//     32 KB a block.
//   * The state comes from and goes back to device memory once a launch;
//     keystream and data move four bytes a load or store when the rows are
//     4-byte aligned.
// Not constant time: the state is indexed by secret bytes, as in the
// reference (ROADMAP.md queue 3).

#include <cstdint>
#include <cuda_runtime.h>

#include "arc4.cuh"

namespace {

constexpr int kLanes = 32;

// state_in and state_out may be one buffer: a thread reads its whole row
// before the loop and writes it after.
template <int LANES>
__global__ void __launch_bounds__(LANES)
arc4_prga_kernel(const uint32_t* state_in, uint32_t* state_out,
                 const uint8_t* __restrict__ data, uint8_t* __restrict__ out, int s,
                 long long len) {
  __shared__ uint32_t smem[arc4::kSharedWords<LANES>];
  const long long j = (long long)blockIdx.x * LANES + threadIdx.x;
  if (j >= s) return;
  const arc4::Lane<LANES> m = arc4::lane_of<LANES>(smem, threadIdx.x);
  uint32_t x, y;
  arc4::load_state(m, state_in + j * arc4::kStateWords, x, y);
  arc4::run(m, x, y, data ? data + j * len : nullptr, out + j * len, len);
  arc4::store_state(m, state_out + j * arc4::kStateWords, x, y);
}

}  // namespace

// C interface for ctypes. state_in/state_out: (s, 258) u32 words on the
// card ([x, y, m[256]], each a byte), which may be the same buffer; data
// (may be null) and out: (s, len) bytes, row after row.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ot_arc4_prga(const void* state_in, void* state_out, const void* data, void* out,
                            int s, long long len, void* stream) {
  if (s <= 0 || len < 0) return (int)cudaErrorInvalidValue;
  const unsigned int grid = (unsigned int)((s + kLanes - 1) / kLanes);
  arc4_prga_kernel<kLanes><<<grid, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(state_in), static_cast<uint32_t*>(state_out),
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out), s, len);
  return (int)cudaGetLastError();
}
