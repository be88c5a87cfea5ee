// Integer-logic ceiling probe for Hopper (sm_90a): per 32-bit word, `ilp`
// independent two-word feedback chains (a, b) <- (b, a ^ (b & k)), `chain`
// steps each, XOR-reduced (the arithmetic is in chain.cuh).
//
// Replaces the TPU kernel _chain_kernel (scripts/vpu_ceiling.py:47-71,
// launched at :79), the reference's VPU ceiling probe. It is a probe: its
// speed is the measurement. harness/ceiling.py times it by the reference's
// chained method, and chip_smoke.py times it alone and turns the times into
// the card's measured integer instruction rate and streaming rate, which then
// bound the AES kernels beside NVIDIA's table figures.
//
// Bound. With chain = 1 each word costs 5 logical operations against 8 bytes
// of HBM traffic (one read, one write): bound by bytes, and the `stream`
// regime measures the streaming rate. With chain = 128 each word costs
// 2·128·ilp operations (one LOP3 a step) against the same 8 bytes: bound by
// integer issue, and the `compute` regimes measure its rate; ilp = 1 is one
// dependent chain per thread, ilp = 4 and 8 give the scheduler independent
// chains to interleave.
//
// Design. One word per thread per trip of a grid-stride loop (not unrolled, so
// the SASS loop body is one element's work), one full wave of thread blocks.
// The TPU kernel's (8, lanes) tiling exists only for TPU tile padding and is
// not carried. The mask (passed twice, as k0 and k1) and the chain seeds are
// kernel arguments, not constants, so that nothing about the chain is known
// when it is compiled; each step is a LOP3 in inline PTX (chain.cuh says
// why). The probe's four regimes are instantiated, (chain, ilp) in
// {(1,1), (128,1), (128,4), (128,8)}, and one more, (65536, 1): launched over
// one word it is a single dependent chain long enough that the launch is a
// few percent of its time, so chip_smoke.py reads the card's dependent-issue
// latency from it (the latency bounds of the per-block kernels).

#include <cstdint>
#include <cuda_runtime.h>

#include "chain.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2,048 threads: a full SM
constexpr uint32_t kSeed1 = 0x9E3779B9u;
constexpr uint32_t kSeed2 = 0x85EBCA6Bu;

template <int CHAIN, int ILP>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, long long n,
             uint32_t k0, uint32_t k1, uint32_t seed1, uint32_t seed2) {
  const long long stride = (long long)gridDim.x * kThreads;
#pragma unroll 1
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    out[i] = chain::element<CHAIN, ILP>(x[i], k0, k1, seed1, seed2);
}

template <int CHAIN, int ILP>
cudaError_t launch(const void* x, void* out, long long n, uint32_t k, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const long long wave = (long long)sms * kBlocksPerSm;
  const unsigned int grid = (unsigned int)(blocks < wave ? blocks : wave);
  chain_kernel<CHAIN, ILP><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n, k, k, kSeed1, kSeed2);
  return cudaGetLastError();
}

}  // namespace

// C interface for ctypes. x/out: n u32 words on the card; (chain, ilp) one of
// the four regimes; k: the chain mask. Returns the cudaError_t of the launch
// (0 on success).
extern "C" int ot_chain(const void* x, void* out, long long n, int chain, int ilp, uint32_t k,
                        void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chain == 1 && ilp == 1) return (int)launch<1, 1>(x, out, n, k, st);
  if (chain == 128 && ilp == 1) return (int)launch<128, 1>(x, out, n, k, st);
  if (chain == 128 && ilp == 4) return (int)launch<128, 4>(x, out, n, k, st);
  if (chain == 128 && ilp == 8) return (int)launch<128, 8>(x, out, n, k, st);
  if (chain == 65536 && ilp == 1) return (int)launch<65536, 1>(x, out, n, k, st);
  return (int)cudaErrorInvalidValue;
}
