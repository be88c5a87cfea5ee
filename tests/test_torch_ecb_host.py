"""The ECB kernels' arithmetic (``csrc/aes_bitslice.cuh``: both S-boxes, both
round forms, the transposes, ``ecb_group``) compiled as host C++ with g++ and
held bit-exact against the plain torch version. The kernels' loads, stores and
ragged-tail mask run only on the card (``tests/test_torch_cuda.py``)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

from our_tree_tpu_torch.ops import bitslice, tables
from our_tree_tpu_torch.ops.keyschedule import expand_key_dec, expand_key_enc
from our_tree_tpu_torch.runtime import cuda_build
from our_tree_tpu_torch.utils import packing

HOST_SOURCE = r"""
#include "aes_bitslice.cuh"

template <int NR, bool DECRYPT>
static void run(const uint32_t* rk, const uint32_t* in, int groups, uint32_t* out) {
  uint32_t kmask[(NR + 1) * 128];
  for (int i = 0; i < (NR + 1) * 128; ++i) kmask[i] = aes_bitslice::key_mask(rk, i);
  for (int g = 0; g < groups; ++g) {
    uint32_t s[128];
    for (int t = 0; t < 32; ++t)
      for (int c = 0; c < 4; ++c) s[32 * c + t] = in[4 * (32 * g + t) + c];
    aes_bitslice::ecb_group<NR, DECRYPT>(s, kmask);
    for (int t = 0; t < 32; ++t)
      for (int c = 0; c < 4; ++c) out[4 * (32 * g + t) + c] = s[32 * c + t];
  }
}

extern "C" int ecb_groups(const uint32_t* rk, int nr, int decrypt, const uint32_t* in,
                          int groups, uint32_t* out) {
  switch (nr * 2 + (decrypt ? 1 : 0)) {
    case 20: run<10, false>(rk, in, groups, out); return 0;
    case 21: run<10, true>(rk, in, groups, out); return 0;
    case 24: run<12, false>(rk, in, groups, out); return 0;
    case 25: run<12, true>(rk, in, groups, out); return 0;
    case 28: run<14, false>(rk, in, groups, out); return 0;
    case 29: run<14, true>(rk, in, groups, out); return 0;
    default: return 1;
  }
}

extern "C" void sbox_planes(uint32_t* x, int inverse) {
  if (inverse) aes_bitslice::inv_sbox_bp(x);
  else aes_bitslice::sbox_bp(x);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' arithmetic as host C++")
    out = tmp_path_factory.mktemp("ecb_host")
    (out / "ecb_groups.cpp").write_text(HOST_SOURCE)
    so = out / "libecb_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
                    "-o", str(so), str(out / "ecb_groups.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    lib.ecb_groups.argtypes = [vp, ctypes.c_int, ctypes.c_int, vp, ctypes.c_int, vp]
    lib.ecb_groups.restype = ctypes.c_int
    lib.sbox_planes.argtypes = [vp, ctypes.c_int]
    lib.sbox_planes.restype = None
    return lib


def _host_ecb(lib, rk, nr, decrypt, words):
    rk = np.ascontiguousarray(rk, np.uint32)
    words = np.ascontiguousarray(words, np.uint32)
    assert words.shape[0] % 32 == 0
    out = np.zeros_like(words)
    rc = lib.ecb_groups(rk.ctypes.data, nr, int(decrypt), words.ctypes.data,
                        words.shape[0] // 32, out.ctypes.data)
    assert rc == 0
    return out


def _host_sbox(lib, inverse):
    """The host S-box on all 256 inputs: 8 groups of 32 lanes."""
    x = np.arange(256, dtype=np.uint32).reshape(8, 32)
    got = np.zeros(256, np.uint32)
    for k in range(8):
        planes = np.array([sum(int((x[k, t] >> b) & 1) << t for t in range(32))
                           for b in range(8)], np.uint32)
        lib.sbox_planes(planes.ctypes.data, int(inverse))
        for t in range(32):
            got[32 * k + t] = sum(((int(planes[b]) >> t) & 1) << b for b in range(8))
    return got


@pytest.mark.parametrize("inverse", [False, True])
def test_host_sbox_exhaustive(host_lib, inverse):
    want = tables.INV_SBOX if inverse else tables.SBOX
    np.testing.assert_array_equal(_host_sbox(host_lib, inverse), want)


def _case(bits, groups):
    rng = np.random.default_rng(bits + groups)
    key = rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes()
    words = rng.integers(0, 2**32, (32 * groups, 4), dtype=np.uint64).astype(np.uint32)
    nr, rk = expand_key_enc(key)
    return nr, rk, expand_key_dec(key)[1], words


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_host_encrypt_group_matches_plain(host_lib, bits):
    nr, rk, _, words = _case(bits, 2)
    want = bitslice.encrypt_words(packing.words_tensor(words, "cpu"),
                                  packing.words_tensor(rk, "cpu"), nr)
    got = _host_ecb(host_lib, rk, nr, False, words)
    np.testing.assert_array_equal(got, packing.words_numpy(want))


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_host_decrypt_group_matches_plain(host_lib, bits):
    nr, _, rk_dec, words = _case(bits, 2)
    want = bitslice.decrypt_words(packing.words_tensor(words, "cpu"),
                                  packing.words_tensor(rk_dec, "cpu"), nr)
    got = _host_ecb(host_lib, rk_dec, nr, True, words)
    np.testing.assert_array_equal(got, packing.words_numpy(want))


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_host_decrypt_inverts_encrypt(host_lib, bits):
    nr, rk, rk_dec, words = _case(bits, 3)
    ct = _host_ecb(host_lib, rk, nr, False, words)
    assert not np.array_equal(ct, words)
    np.testing.assert_array_equal(_host_ecb(host_lib, rk_dec, nr, True, ct), words)
