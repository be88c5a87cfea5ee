"""The multi-key CTR kernel's arithmetic (``csrc/aes_bitslice.cuh``:
``mk_encrypt_group`` with its uniform and per-block key forms) compiled as
host C++ with g++ and held bit-exact against the plain torch version
(``bitslice.encrypt_words_multikey``). The kernel's loads, stores, slot
clamp and ragged tail run only on the card (``tests/test_torch_cuda.py``)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from our_tree_tpu_torch.ops import bitslice
from our_tree_tpu_torch.ops.keyschedule import expand_key_enc
from our_tree_tpu_torch.runtime import cuda_build
from our_tree_tpu_torch.utils import packing

HOST_SOURCE = r"""
#include "aes_bitslice.cuh"

// Encrypt groups of 32 counter blocks, block i under schedule slots[i] of rks
// (k rows of 4*(NR+1) words); uniform groups take the full-lane-mask form, as
// the kernel decides.
template <int NR>
static void run(const uint32_t* rks, const int32_t* slots, const uint32_t* in, int groups,
                uint32_t* out, int* uniform_groups) {
  constexpr int kWords = 4 * (NR + 1);
  for (int g = 0; g < groups; ++g) {
    uint32_t s[128];
    uint16_t off[32];
    bool uniform = true;
    for (int t = 0; t < 32; ++t) {
      for (int c = 0; c < 4; ++c) s[32 * c + t] = in[4 * (32 * g + t) + c];
      off[t] = (uint16_t)(slots[32 * g + t] * kWords);
      uniform &= off[t] == off[0];
    }
    *uniform_groups += uniform;
    if (uniform) aes_bitslice::mk_encrypt_group<NR, true>(s, rks, off[0], off, 1);
    else aes_bitslice::mk_encrypt_group<NR, false>(s, rks, off[0], off, 1);
    for (int t = 0; t < 32; ++t)
      for (int c = 0; c < 4; ++c) out[4 * (32 * g + t) + c] = s[32 * c + t];
  }
}

extern "C" int mk_groups(const uint32_t* rks, int nr, const int32_t* slots, const uint32_t* in,
                         int groups, uint32_t* out, int* uniform_groups) {
  switch (nr) {
    case 10: run<10>(rks, slots, in, groups, out, uniform_groups); return 0;
    case 12: run<12>(rks, slots, in, groups, out, uniform_groups); return 0;
    case 14: run<14>(rks, slots, in, groups, out, uniform_groups); return 0;
    default: return 1;
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's arithmetic as host C++")
    out = tmp_path_factory.mktemp("mk_host")
    (out / "mk_groups.cpp").write_text(HOST_SOURCE)
    so = out / "libmk_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
                    "-o", str(so), str(out / "mk_groups.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.mk_groups.argtypes = [vp, ctypes.c_int, vp, vp, ctypes.c_int, vp, vp]
    lib.mk_groups.restype = ctypes.c_int
    return lib


def _stack(k, bits, seed):
    """(nr, (k, 4*(nr+1)) uint32 schedules of k random keys)."""
    rng = np.random.default_rng(seed)
    rows = [expand_key_enc(rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes())
            for _ in range(k)]
    return rows[0][0], np.stack([r for _, r in rows]).astype(np.uint32)


def _host(lib, rks, nr, slots, ctr):
    rks = np.ascontiguousarray(rks, np.uint32)
    slots = np.ascontiguousarray(slots, np.int32)
    ctr = np.ascontiguousarray(ctr, np.uint32)
    assert ctr.shape[0] % 32 == 0
    out = np.zeros_like(ctr)
    uniform = ctypes.c_int(0)
    rc = lib.mk_groups(rks.ctypes.data, nr, slots.ctypes.data, ctr.ctypes.data,
                       ctr.shape[0] // 32, out.ctypes.data, ctypes.byref(uniform))
    assert rc == 0
    return out, uniform.value


def _plain(rks, nr, slots, ctr):
    rk_blocks = packing.words_tensor(rks, "cpu")[packing.words_tensor(
        slots.astype(np.uint32), "cpu").long()]
    return packing.words_numpy(bitslice.encrypt_words_multikey(
        packing.words_tensor(ctr, "cpu"), rk_blocks, nr))


def _slot_patterns(k, groups, seed):
    """Named slot vectors of 32 * groups blocks over k schedules."""
    n = 32 * groups
    rng = np.random.default_rng(seed)
    runs, pos = np.zeros(n, np.int32), 0
    while pos < n:
        length = int(rng.integers(1, 80))
        runs[pos: pos + length] = rng.integers(k)
        pos += length
    return {
        "uniform": np.full(n, k - 1, np.int32),
        "alternating": (np.arange(n) % min(k, 2)).astype(np.int32),
        "lane_boundary": ((np.arange(n) // 8 + np.arange(n) // 32) % k).astype(np.int32),
        "independent": rng.integers(0, k, n).astype(np.int32),
        "runs": runs,
    }


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("k", [1, 3, 8, 64])
def test_host_multikey_groups_match_plain(host_lib, bits, k):
    nr, rks = _stack(k, bits, seed=bits + k)
    groups = 3
    ctr = np.random.default_rng(k).integers(0, 2**32, (32 * groups, 4),
                                            dtype=np.uint64).astype(np.uint32)
    for name, slots in _slot_patterns(k, groups, seed=k + bits).items():
        got, uniform = _host(host_lib, rks, nr, slots, ctr)
        np.testing.assert_array_equal(got, _plain(rks, nr, slots, ctr), err_msg=name)
        if name == "uniform" or k == 1:
            assert uniform == groups, name
        elif name in ("alternating", "lane_boundary"):
            assert uniform == 0, name


def test_host_uniform_group_is_single_key_encrypt(host_lib):
    """A uniform group under slot s is plain single-key ECB under rks[s]."""
    nr, rks = _stack(8, 128, seed=5)
    ctr = np.arange(64 * 4, dtype=np.uint32).reshape(64, 4)
    slots = np.full(64, 5, np.int32)
    got, uniform = _host(host_lib, rks, nr, slots, ctr)
    assert uniform == 2
    want = bitslice.encrypt_words(packing.words_tensor(ctr, "cpu"),
                                  packing.words_tensor(rks[5], "cpu"), nr)
    np.testing.assert_array_equal(got, packing.words_numpy(want))


def test_host_zero_schedule_slots_are_harmless(host_lib):
    """Unused slots hold the all-zero schedule (the serve path's closed K):
    blocks on real slots are unchanged by what rides the zero rows."""
    nr, rks = _stack(8, 128, seed=9)
    rks[3:] = 0
    ctr = np.random.default_rng(1).integers(0, 2**32, (64, 4), dtype=np.uint64).astype(np.uint32)
    slots = (np.arange(64) % 8).astype(np.int32)
    got, _ = _host(host_lib, rks, nr, slots, ctr)
    np.testing.assert_array_equal(got, _plain(rks, nr, slots, ctr))
