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
// state, but only y + a has to wait for the byte before: the loads can run
// ahead of the stores they would otherwise wait on and be corrected
// afterwards (arc4.cuh). What this layout cannot escape is the issue of the
// work itself: the state is indexed by data, so it lives in shared memory,
// a word a byte, and each byte of each stream needs three loads and two
// stores there, which an SM serves at about one warp-wide access a cycle
// over four warps but one warp at about one every four cycles (chip_smoke.py
// measures both); and one dependent integer step, the add y + a.
// chip_smoke.py reports the larger of the two (the issue bound of this
// word-per-byte layout, at a measured shared-memory rate for the warps each
// SM holds at the launch's shape; the dependent step, at a measured latency)
// as the latency bound, beside the bytes bound. It is the layout's floor,
// not the function's: with four bytes a word, the loads of m[x], which walk
// consecutive indices, could be fetched four at a time. The recurrence of
// the step as written (two dependent loads and two dependent integer steps
// a byte) and the longest path through this kernel's compiled loop are
// printed as diagnostics.
//
// Design.
//   * One thread a stream, one warp a thread block, so 4,096 streams fill
//     128 SMs with a warp each and a single stream owns an SM's scheduler:
//     with one warp, the time a byte is what the warp issues a byte.
//   * The 256-byte permutation lives in shared memory, a 32-bit word a
//     byte, interleaved across the warp's 32 lanes (arc4.cuh), so the lanes
//     never share a bank; a byte is held as v << 24, so that it wraps by
//     itself and is its own address after one shift: 32 KB a block.
//   * The lookahead schedule (arc4.cuh): the chain of y runs two bytes
//     ahead of the stores, the load of m[x] four and the load of m[y] two,
//     each corrected by compare-and-selects against the stores it passed;
//     the byte-to-byte path is one compare and one select, and the loop
//     runs 32 bytes a trip.
//   * The states move in and out of device memory once a launch, a warp at
//     a time through a padded stage (coalesced on one side, conflict-free on
//     the other); keystream and data move four bytes a load or store once a
//     row is 4-byte aligned.
// Not constant time: the state is indexed by secret bytes, as in the
// reference (ROADMAP.md queue 3).

#include <cstdint>
#include <cuda_runtime.h>

#include "arc4.cuh"

namespace {

constexpr int kLanes = 32;

// state_in and state_out may be one buffer: the warp reads all of its rows
// before the loop and writes them after.
template <int LANES>
__global__ void __launch_bounds__(LANES)
arc4_prga_kernel(const uint32_t* state_in, uint32_t* state_out,
                 const uint8_t* __restrict__ data, uint8_t* __restrict__ out, int s,
                 long long len) {
  __shared__ uint32_t smem[arc4::kSharedWords<LANES>];
  __shared__ uint32_t stage[arc4::kStageWords<LANES>];
  const int lane = threadIdx.x;
  const long long j0 = (long long)blockIdx.x * LANES;
  const int nrows = (int)(s - j0 < LANES ? s - j0 : LANES);
  const arc4::Lane<LANES> m = arc4::lane_of<LANES>(smem, lane);
  const uint32_t* rows_in = state_in + j0 * arc4::kStateWords;
  uint32_t* rows_out = state_out + j0 * arc4::kStateWords;
  uint32_t x = 0, y = 0;
  for (int c = 0; c < arc4::kChunks<LANES>; ++c) {
    arc4::stage_in<LANES>(rows_in, nrows, c, lane, stage);
    __syncwarp();
    if (lane < nrows) arc4::unstage_in<LANES>(stage, c, m, lane, x, y);
    __syncwarp();
  }
  if (lane < nrows) {
    const long long j = j0 + lane;
    if (data) {
      arc4::run<true>(m, x, y, data + j * len, out + j * len, len);
    } else {
      arc4::run<false>(m, x, y, nullptr, out + j * len, len);
    }
  }
  __syncwarp();
  for (int c = 0; c < arc4::kChunks<LANES>; ++c) {
    if (lane < nrows) arc4::stage_out<LANES>(stage, c, m, lane, x, y);
    __syncwarp();
    arc4::unstage_out<LANES>(stage, nrows, c, lane, rows_out);
    __syncwarp();
  }
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
