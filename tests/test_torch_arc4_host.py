"""The ARC4 kernel's arithmetic (``csrc/arc4.cuh``: the PRGA step, the
interleaved shared-memory layout and the per-stream loop with its
four-byte groups and byte tail) compiled as host C++ with g++ and held
bit-exact against the plain torch version (``cuda_arc4.prga_plain``) on
random states: keystream and fused XOR, aligned and unaligned rows, and a
resume seam inside a 32-byte run. The kernel's launch runs only on the card
(``tests/test_torch_cuda.py``). Integer cryptography: the tolerance is
zero."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from our_tree_tpu_torch.ops import cuda_arc4
from our_tree_tpu_torch.runtime import cuda_build

HOST_SOURCE = r"""
#include "arc4.cuh"

// S streams, each run in lane (j % LANES) of an interleaved buffer laid out
// as one thread block's shared memory, the kernel's layout.
extern "C" int host_prga(const uint32_t* state_in, uint32_t* state_out, const uint8_t* data,
                         uint8_t* out, int s, long long len, long long data_stride,
                         long long out_stride, long long offset) {
  constexpr int kLanes = 32;
  static uint32_t smem[arc4::kSharedWords<kLanes>];
  for (int j = 0; j < s; ++j) {
    const arc4::Lane<kLanes> m = arc4::lane_of<kLanes>(smem, j % kLanes);
    uint32_t x, y;
    arc4::load_state(m, state_in + j * arc4::kStateWords, x, y);
    arc4::run(m, x, y, data ? data + j * data_stride + offset : nullptr,
              out + j * out_stride + offset, len);
    arc4::store_state(m, state_out + j * arc4::kStateWords, x, y);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's arithmetic as host C++")
    out = tmp_path_factory.mktemp("arc4_host")
    (out / "arc4.cpp").write_text(HOST_SOURCE)
    so = out / "libarc4_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
                    "-o", str(so), str(out / "arc4.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.host_prga.argtypes = [vp, vp, vp, vp, ctypes.c_int, ll, ll, ll, ll]
    lib.host_prga.restype = ctypes.c_int
    return lib


def _states(s, seed):
    rng = np.random.default_rng(seed)
    rows = np.empty((s, 258), np.int32)
    rows[:, :2] = rng.integers(0, 256, (s, 2))
    rows[:, 2:] = np.stack([rng.permutation(256) for _ in range(s)])
    return rows


def _host(lib, state, length, data=None, offset=0):
    """(new state, output) of the host build; rows start ``offset`` bytes
    into buffers padded by 8, so an odd offset exercises the byte path."""
    s = state.shape[0]
    stride = length + 8
    out = np.zeros((s, stride), np.uint8)
    new = np.zeros_like(state)
    dbuf = None
    if data is not None:
        dbuf = np.zeros((s, stride), np.uint8)
        dbuf[:, offset:offset + length] = data
    assert lib.host_prga(state.ctypes.data, new.ctypes.data,
                         None if dbuf is None else dbuf.ctypes.data, out.ctypes.data, s, length,
                         stride, stride, offset) == 0
    return new, out[:, offset:offset + length]


@pytest.mark.parametrize("s", [1, 5, 33])
@pytest.mark.parametrize("length", [0, 1, 3, 4, 31, 257])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("fused", [False, True])
def test_host_build_matches_plain(host_lib, s, length, offset, fused):
    state = _states(s, seed=1000 * s + length)
    data = (np.random.default_rng(length).integers(0, 256, (s, length), dtype=np.uint8)
            if fused else None)
    new, out = _host(host_lib, state, length, data, offset)
    want_state, want = cuda_arc4.prga_plain(torch.from_numpy(state), length,
                                            None if data is None else torch.from_numpy(data))
    np.testing.assert_array_equal(out, want.numpy())
    np.testing.assert_array_equal(new, want_state.numpy())


@pytest.mark.parametrize("seam", [1, 13, 16, 31])
def test_resume_seam_inside_a_32_byte_run(host_lib, seam):
    """Two calls of ``seam`` and ``32 - seam`` bytes, the state carried,
    equal one call of 32 (keystream and fused XOR)."""
    state = _states(7, seed=seam)
    data = np.random.default_rng(seam).integers(0, 256, (7, 32), dtype=np.uint8)
    for d in (None, data):
        mid, first = _host(host_lib, state, seam, None if d is None else d[:, :seam])
        end, second = _host(host_lib, mid, 32 - seam, None if d is None else d[:, seam:])
        one_state, one = cuda_arc4.prga_plain(torch.from_numpy(state), 32,
                                              None if d is None else torch.from_numpy(d))
        np.testing.assert_array_equal(np.concatenate([first, second], axis=1), one.numpy())
        np.testing.assert_array_equal(end, one_state.numpy())


def test_ptxas_report_keys_the_arc4_kernel():
    """The kernel's name is read by its length prefix, so the digits of
    nvcc's internal namespace id do not run into it."""
    ns = "_INTERNAL_e111995_7_arc4_cu_312f317d"
    report = "\n".join([
        f"ptxas info    : Compiling entry function '_ZN{len(ns)}{ns}16arc4_prga_kernelILi32EEEv"
        "PKjPjPKhPhixxx' for 'sm_90a'",
        "ptxas info    : Used 86 registers, 32768 bytes smem",
    ])
    assert cuda_build.ptxas_kernels(report) == {
        "arc4_prga_kernel<32>": {"registers": 86, "smem": 32768}}
