"""The CUDA kernel's arithmetic (``csrc/ctr_gen.cuh``: counter synthesis,
rounds, transposes) compiled as host C++ with g++ and held bit-exact against
the plain torch version, including block indices past 2^37 (where the TPU
kernel's shortcut stops) up to the top of the 64-bit index; and the block
form's counter (``counter_block``, carries across bits 32, 64 and 127) and
its one-block keystream on ``aes_block.cuh``. The kernel's loads, stores and
ragged-tail mask run only on the card (``tests/test_torch_cuda.py``)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from our_tree_tpu_torch.ops import cuda_aes
from our_tree_tpu_torch.ops.keyschedule import expand_key_enc
from our_tree_tpu_torch.runtime import cuda_build
from our_tree_tpu_torch.utils import packing

HOST_SOURCE = r"""
#include "aes_block.cuh"
#include "ctr_gen.cuh"

template <int NR>
static void run(const uint32_t* ctr_be, const uint32_t* rk,
                const unsigned long long* groups, int n, uint32_t* out) {
  uint32_t kmask[(NR + 1) * 128];
  for (int i = 0; i < (NR + 1) * 128; ++i) kmask[i] = ctr_gen::key_mask(rk, i);
  for (int k = 0; k < n; ++k) {
    uint32_t s[128];
    ctr_gen::keystream_group<NR>(s, ctr_be, kmask, groups[k]);
    for (int i = 0; i < 128; ++i) out[128 * k + i] = s[i];
  }
}

extern "C" int keystream_groups(const uint32_t* ctr_be, const uint32_t* rk, int nr,
                                const unsigned long long* groups, int n, uint32_t* out) {
  switch (nr) {
    case 10: run<10>(ctr_be, rk, groups, n, out); return 0;
    case 12: run<12>(ctr_be, rk, groups, n, out); return 0;
    case 14: run<14>(ctr_be, rk, groups, n, out); return 0;
    default: return 1;
  }
}

// The block form: block j's counter as LE words, and its keystream block.
extern "C" void counter_blocks(const uint32_t* ctr_be, const unsigned long long* js, int n,
                               uint32_t* out) {
  for (int k = 0; k < n; ++k) {
    uint32_t le[4];
    ctr_gen::counter_block(ctr_be, js[k], le);
    for (int c = 0; c < 4; ++c) out[4 * k + c] = le[c];
  }
}

template <int NR>
static void block_run(const uint32_t* ctr_be, const uint32_t* rk,
                      const unsigned long long* js, int n, uint32_t* out) {
  uint32_t kp[8 * (NR + 1)];
  for (int r = 0; r <= NR; ++r) aes_block::round_key_planes(rk, r, kp + 8 * r);
  for (int k = 0; k < n; ++k) {
    uint32_t c[4];
    ctr_gen::counter_block(ctr_be, js[k], c);
    const uint4 ks = aes_block::ctr_block<NR>(make_uint4(c[0], c[1], c[2], c[3]),
                                              make_uint4(0u, 0u, 0u, 0u), kp);
    out[4 * k] = ks.x;
    out[4 * k + 1] = ks.y;
    out[4 * k + 2] = ks.z;
    out[4 * k + 3] = ks.w;
  }
}

extern "C" int keystream_blocks(const uint32_t* ctr_be, const uint32_t* rk, int nr,
                                const unsigned long long* js, int n, uint32_t* out) {
  switch (nr) {
    case 10: block_run<10>(ctr_be, rk, js, n, out); return 0;
    case 12: block_run<12>(ctr_be, rk, js, n, out); return 0;
    case 14: block_run<14>(ctr_be, rk, js, n, out); return 0;
    default: return 1;
  }
}
"""

#: Counter starts whose additions carry across 32, 64 and 128 bits.
WRAP_NONCES = [
    "000102030405060708090a0bfffffffb",
    "0001020304050607fffffffffffffff9",
    "fffffffffffffffffffffffffffffff0",
    "ffffffffffffffffffffffffffffffff",
    "f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff",
]

#: Group indices g (blocks 32g .. 32g+31) on both sides of block index 2^37,
#: 2^43 and 2^63, and the largest 64-bit group index.
LARGE_GROUPS = [2**32 - 1, 2**32, 2**38 - 1, 2**38, 2**58 - 1, 2**64 - 1]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's arithmetic as host C++")
    out = tmp_path_factory.mktemp("ctr_gen_host")
    (out / "keystream_groups.cpp").write_text(HOST_SOURCE)
    so = out / "libctr_gen_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
                    "-o", str(so), str(out / "keystream_groups.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.keystream_groups.argtypes = [vp, vp, ctypes.c_int, vp, ctypes.c_int, vp]
    lib.keystream_groups.restype = ctypes.c_int
    lib.keystream_blocks.argtypes = [vp, vp, ctypes.c_int, vp, ctypes.c_int, vp]
    lib.keystream_blocks.restype = ctypes.c_int
    lib.counter_blocks.argtypes = [vp, vp, ctypes.c_int, vp]
    lib.counter_blocks.restype = None
    return lib


def _host_keystream(lib, ctr_be, rk, nr, groups):
    """(len(groups) * 32, 4) uint32 keystream words of the given groups."""
    ctr_be = np.ascontiguousarray(ctr_be, np.uint32)
    rk = np.ascontiguousarray(rk, np.uint32)
    g = np.asarray(groups, np.uint64)
    out = np.zeros((len(g), 4, 32), np.uint32)
    rc = lib.keystream_groups(ctr_be.ctypes.data, rk.ctypes.data, nr, g.ctypes.data,
                              len(g), out.ctypes.data)
    assert rc == 0
    return out.transpose(0, 2, 1).reshape(-1, 4)


def _plain_keystream(hexnonce, rk, nr, first_block, n):
    """Keystream of blocks first_block .. first_block + n - 1 from the plain
    version, with the 128-bit start counter added in Python integers."""
    start = (int(hexnonce, 16) + first_block) % (1 << 128)
    ctr = np.array([(start >> (96 - 32 * k)) & 0xFFFFFFFF for k in range(4)], np.uint32)
    zeros = packing.words_tensor(np.zeros((n, 4), np.uint32), "cpu")
    ks = cuda_aes.ctr_crypt_words_fused_plain(
        zeros, packing.words_tensor(ctr, "cpu"), packing.words_tensor(rk, "cpu"), nr)
    return packing.words_numpy(ks)


def _ctr_be(hexnonce):
    return packing.np_bytes_to_words(np.frombuffer(bytes.fromhex(hexnonce), np.uint8)).byteswap()


def _key(bits, seed):
    return np.random.default_rng(seed).integers(0, 256, bits // 8, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("hexnonce", WRAP_NONCES)
def test_host_keystream_matches_plain_across_wraps(host_lib, bits, hexnonce):
    nr, rk = expand_key_enc(_key(bits, bits))
    got = _host_keystream(host_lib, _ctr_be(hexnonce), rk, nr, [0, 1, 2, 3])
    np.testing.assert_array_equal(got, _plain_keystream(hexnonce, rk, nr, 0, 128))


@pytest.mark.parametrize("group", LARGE_GROUPS)
@pytest.mark.parametrize("hexnonce", [WRAP_NONCES[1], WRAP_NONCES[3], WRAP_NONCES[4]])
def test_host_keystream_at_large_block_indices(host_lib, group, hexnonce):
    bits = (128, 192, 256)[LARGE_GROUPS.index(group) % 3]
    nr, rk = expand_key_enc(_key(bits, group % 1000))
    got = _host_keystream(host_lib, _ctr_be(hexnonce), rk, nr, [group])
    np.testing.assert_array_equal(got, _plain_keystream(hexnonce, rk, nr, 32 * group, 32))


#: (start counter, block indices) whose additions carry across bit 32, bit
#: 64 (the two 64-bit halves) and bit 127 (the wrap mod 2^128).
COUNTER_CASES = [
    ("000102030405060708090a0bfffffffb", [0, 4, 5, 6]),
    ("0001020304050607fffffffffffffff9", [6, 7, 8, 2**40]),
    ("00000000000000000000000000000001", [2**64 - 2, 2**64 - 1]),
    ("7fffffffffffffffffffffffffffffff", [0, 1, 2]),
    ("fffffffffffffffffffffffffffffff0", [15, 16, 17, 2**63]),
    ("ffffffffffffffffffffffffffffffff", [0, 1, 2**64 - 1]),
]


@pytest.mark.parametrize("hexnonce,js", COUNTER_CASES, ids=[c[0] for c in COUNTER_CASES])
def test_block_form_counter_carries(host_lib, hexnonce, js):
    g = np.asarray(js, np.uint64)
    out = np.zeros((len(js), 4), np.uint32)
    host_lib.counter_blocks(np.ascontiguousarray(_ctr_be(hexnonce)).ctypes.data, g.ctypes.data,
                            len(js), out.ctypes.data)
    for j, got in zip(js, out):
        want = ((int(hexnonce, 16) + j) % (1 << 128)).to_bytes(16, "big")
        assert packing.np_words_to_bytes(got).tobytes() == want, (hexnonce, j)


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("hexnonce", [WRAP_NONCES[1], WRAP_NONCES[2], WRAP_NONCES[3]])
def test_block_form_keystream_matches_plain(host_lib, bits, hexnonce):
    """One block a thread: each block's keystream equals the plain
    version's at the same block index, across the 64- and 128-bit wraps."""
    nr, rk = expand_key_enc(_key(bits, bits + 1))
    js = [0, 1, 6, 7, 15, 16, 31, 32]
    g = np.asarray(js, np.uint64)
    out = np.zeros((len(js), 4), np.uint32)
    rc = host_lib.keystream_blocks(np.ascontiguousarray(_ctr_be(hexnonce)).ctypes.data,
                                   np.ascontiguousarray(rk, np.uint32).ctypes.data, nr,
                                   g.ctypes.data, len(js), out.ctypes.data)
    assert rc == 0
    np.testing.assert_array_equal(out, _plain_keystream(hexnonce, rk, nr, 0, 33)[js])
