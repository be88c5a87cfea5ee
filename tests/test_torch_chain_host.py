"""The ceiling probe kernel's arithmetic (``csrc/chain.cuh``: seeds, chain
steps, reduction) compiled as host C++ with g++ and held bit-exact against
the plain torch version (``harness.ceiling.chain_plain``) for the four
regimes the kernel instantiates and its long latency chain. The kernel's grid-stride loop, its inline
PTX step and its launch run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from our_tree_tpu_torch.harness import ceiling
from our_tree_tpu_torch.runtime import cuda_build

HOST_SOURCE = r"""
#include "chain.cuh"

template <int CHAIN, int ILP>
static void run(const uint32_t* x, uint32_t* out, long long n, uint32_t k, uint32_t s1,
                uint32_t s2) {
  for (long long i = 0; i < n; ++i) out[i] = chain::element<CHAIN, ILP>(x[i], k, k, s1, s2);
}

extern "C" int chain_host(const uint32_t* x, uint32_t* out, long long n, int c, int ilp,
                          uint32_t k, uint32_t s1, uint32_t s2) {
  if (c == 1 && ilp == 1) { run<1, 1>(x, out, n, k, s1, s2); return 0; }
  if (c == 128 && ilp == 1) { run<128, 1>(x, out, n, k, s1, s2); return 0; }
  if (c == 128 && ilp == 4) { run<128, 4>(x, out, n, k, s1, s2); return 0; }
  if (c == 128 && ilp == 8) { run<128, 8>(x, out, n, k, s1, s2); return 0; }
  if (c == 65536 && ilp == 1) { run<65536, 1>(x, out, n, k, s1, s2); return 0; }
  return 1;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's arithmetic as host C++")
    out = tmp_path_factory.mktemp("chain_host")
    (out / "chain_host.cpp").write_text(HOST_SOURCE)
    so = out / "libchain_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
                    "-o", str(so), str(out / "chain_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    u32 = ctypes.c_uint32
    lib.chain_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int, u32, u32, u32]
    lib.chain_host.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("name,chain,ilp", [*ceiling.REGIMES, ceiling.LATENCY])
def test_host_chain_matches_plain(host_lib, name, chain, ilp):
    n = 4097 if chain <= 128 else 3  # the latency chain runs over one word on the card
    x = np.random.default_rng(chain * 10 + ilp).integers(0, 2**32, n, dtype=np.uint64)
    x = x.astype(np.uint32)
    got = np.zeros_like(x)
    rc = host_lib.chain_host(x.ctypes.data, got.ctypes.data, x.size, chain, ilp, ceiling.K,
                             ceiling.SEED1, ceiling.SEED2)
    assert rc == 0
    want = ceiling.chain_plain(torch.from_numpy(x.view(np.int32)), chain, ilp)
    np.testing.assert_array_equal(got, want.numpy().view(np.uint32))
