"""The ARC4 kernel's arithmetic (``csrc/arc4.cuh``: the PRGA step, the
interleaved shared-memory layout and the per-stream loop with its
four-byte groups and byte tail) compiled as host C++ with g++ and held
bit-exact against the plain torch version (``cuda_arc4.prga_plain``) on
random states and on states where the lookahead schedule's corrections
fire often (``arc4_states.collision_states``): keystream and fused XOR,
aligned and unaligned rows, every length up to three trips of the main loop
and three bytes, resumes at every offset within a trip, and the JAX
package's scan. The kernel's launch runs only on the card
(``tests/test_torch_cuda.py``). Integer cryptography: the tolerance is
zero."""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from our_tree_tpu.models import arc4 as jarc4
from our_tree_tpu_torch.models import arc4
from our_tree_tpu_torch.ops import cuda_arc4
from our_tree_tpu_torch.runtime import cuda_build

from arc4_states import collision_states

HOST_SOURCE = r"""
#include "arc4.cuh"

// S streams in thread blocks of kLanes, as the kernel runs them: each
// block's rows copied into an interleaved buffer laid out as one block's
// shared memory through the stage, a chunk at a time (each phase for every
// lane in turn, where the kernel puts a warp barrier), each lane's stream
// run under the lookahead schedule, and the rows copied back.
extern "C" int host_prga(const uint32_t* state_in, uint32_t* state_out, const uint8_t* data,
                         uint8_t* out, int s, long long len, long long data_stride,
                         long long out_stride, long long offset) {
  constexpr int kLanes = 32;
  static uint32_t smem[arc4::kSharedWords<kLanes>];
  static uint32_t stage[arc4::kStageWords<kLanes>];
  for (int j0 = 0; j0 < s; j0 += kLanes) {
    const int nrows = s - j0 < kLanes ? s - j0 : kLanes;
    uint32_t x[kLanes] = {}, y[kLanes] = {};
    for (int c = 0; c < arc4::kChunks<kLanes>; ++c) {
      for (int t = 0; t < kLanes; ++t)
        arc4::stage_in<kLanes>(state_in + (long long)j0 * arc4::kStateWords, nrows, c, t, stage);
      for (int t = 0; t < nrows; ++t)
        arc4::unstage_in<kLanes>(stage, c, arc4::lane_of<kLanes>(smem, t), t, x[t], y[t]);
    }
    for (int t = 0; t < nrows; ++t) {
      const long long j = j0 + t;
      const arc4::Lane<kLanes> m = arc4::lane_of<kLanes>(smem, t);
      if (data) {
        arc4::run<true>(m, x[t], y[t], data + j * data_stride + offset,
                        out + j * out_stride + offset, len);
      } else {
        arc4::run<false>(m, x[t], y[t], nullptr, out + j * out_stride + offset, len);
      }
    }
    for (int c = 0; c < arc4::kChunks<kLanes>; ++c) {
      for (int t = 0; t < nrows; ++t)
        arc4::stage_out<kLanes>(stage, c, arc4::lane_of<kLanes>(smem, t), t, x[t], y[t]);
      for (int t = 0; t < kLanes; ++t)
        arc4::unstage_out<kLanes>(stage, nrows, c, t,
                                  state_out + (long long)j0 * arc4::kStateWords);
    }
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


def _collisions(s, seed):
    """``arc4_states.collision_states`` as (S, 258) int32 rows, and the (x, y, m) form."""
    ref = collision_states(s, seed)
    return arc4.state_from_numpy(ref, "cpu").numpy(), ref


#: Bytes of one trip of the kernel's main loop: eight four-byte groups.
TRIP = 32
#: Every length up to three trips and three bytes (the loads run up to four
#: bytes ahead, and a group's word is written a group late), then longer
#: runs, where each kind of collision recurs many times.
COLLISION_LENGTHS = list(range(0, 3 * TRIP + 3 + 1)) + [300, 1024]


@pytest.mark.parametrize("length", COLLISION_LENGTHS)
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("fused", [False, True])
def test_host_build_on_collision_states(host_lib, length, offset, fused):
    """33 streams, the six kinds of ``arc4_states.collision_states`` in
    turn, at every row alignment: keystream, fused XOR and the state after,
    against the plain version and, for the keystream and state, the host
    oracle."""
    state, (x, y, m) = _collisions(33, seed=length)
    data = (np.random.default_rng(length + 1).integers(0, 256, (33, length), dtype=np.uint8)
            if fused else None)
    new, out = _host(host_lib, state, length, data, offset)
    want_state, want = cuda_arc4.prga_plain(torch.from_numpy(state), length,
                                            None if data is None else torch.from_numpy(data))
    np.testing.assert_array_equal(out, want.numpy())
    np.testing.assert_array_equal(new, want_state.numpy())
    ks = out ^ data if fused else out
    for i in range(33):
        oracle, (ox, oy, om) = arc4.keystream_np((int(x[i]), int(y[i]), m[i]), length)
        np.testing.assert_array_equal(ks[i], oracle)
        assert (new[i, 0], new[i, 1]) == (ox, oy)
        np.testing.assert_array_equal(new[i, 2:], om)


@pytest.mark.parametrize("seam", range(0, TRIP + 1))
@pytest.mark.parametrize("fused", [False, True])
def test_resume_at_every_offset_within_a_trip(host_lib, seam, fused):
    """On collision states, two calls of ``seam`` and ``2 * TRIP + 8 -
    seam`` bytes, the state carried, equal one call: the second call starts
    its lookahead afresh at every offset within a trip of the main loop."""
    total = 2 * TRIP + 8
    state, _ = _collisions(12, seed=100 + seam)
    data = (np.random.default_rng(seam).integers(0, 256, (12, total), dtype=np.uint8)
            if fused else None)
    mid, first = _host(host_lib, state, seam, None if data is None else data[:, :seam])
    end, second = _host(host_lib, mid, total - seam, None if data is None else data[:, seam:])
    one_state, one = cuda_arc4.prga_plain(torch.from_numpy(state), total,
                                          None if data is None else torch.from_numpy(data))
    np.testing.assert_array_equal(np.concatenate([first, second], axis=1), one.numpy())
    np.testing.assert_array_equal(end, one_state.numpy())


@pytest.mark.parametrize("length", [15, 99, 300])
def test_host_build_matches_jax_scan_on_collision_states(host_lib, length):
    """The host build against the JAX package's ``keystream_scan_batch`` on
    the collision states."""
    state, (x, y, m) = _collisions(12, seed=7 + length)
    (wx, wy, wm), wks = jarc4.keystream_scan_batch(
        (jnp.asarray(x), jnp.asarray(y), jnp.asarray(m)), length)
    new, out = _host(host_lib, state, length)
    np.testing.assert_array_equal(out, np.asarray(wks))
    np.testing.assert_array_equal(new[:, 0], np.asarray(wx))
    np.testing.assert_array_equal(new[:, 1], np.asarray(wy))
    np.testing.assert_array_equal(new[:, 2:], np.asarray(wm))


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
