"""The per-block inverse AES core (``csrc/aes_block_inv.cuh``) compiled as
host C++ with g++: ``decrypt_block`` and ``cbc_dec_block`` (under per-slot
key planes, slots clamped as the ``cbc_mk`` kernel clamps them) held
bit-exact against the plain torch versions (``bitslice.decrypt_words`` and
``cuda_aes.cbc_scattered_multikey_plain``), and ``decrypt_block`` undoing
``aes_block.cuh``'s ``encrypt_block``. The inverse round's linear layers
(``inv_mix_add_key``: shifts as multiplies, a ^ a_(r+2) as 5 u) are also
held, plane for plane, against the MixColumns-based form they replace, on
random planes. The kernel's thread layout, shared
memory and launch run only on the card (``tests/test_torch_cuda.py``).
Integer cryptography: the tolerance is zero."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from our_tree_tpu_torch.ops import bitslice, cuda_aes
from our_tree_tpu_torch.ops.keyschedule import dec_schedule_from_enc, expand_key_enc
from our_tree_tpu_torch.runtime import cuda_build
from our_tree_tpu_torch.utils import packing

HOST_SOURCE = r"""
#include "aes_block_inv.cuh"

template <int NR>
static void planes_of(const uint32_t* rk, uint32_t* kp) {
  for (int r = 0; r <= NR; ++r) aes_block::round_key_planes(rk, r, kp + 8 * r);
}

static uint4 load(const uint32_t* w, long long i) {
  return make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

static void store(uint32_t* w, long long i, uint4 v) {
  w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
}

template <int NR>
static void decrypt(const uint32_t* rk_dec, const uint32_t* in, long long n, uint32_t* out) {
  uint32_t kp[8 * (NR + 1)];
  planes_of<NR>(rk_dec, kp);
  for (long long i = 0; i < n; ++i) {
    uint32_t s[8];
    aes_block::pack(load(in, i), s);
    aes_block::decrypt_block<NR>(s, kp);
    store(out, i, aes_block::unpack(s));
  }
}

template <int NR>
static void round_trip(const uint32_t* rk, const uint32_t* rk_dec, const uint32_t* in,
                       long long n, uint32_t* out) {
  uint32_t kp[8 * (NR + 1)], kd[8 * (NR + 1)];
  planes_of<NR>(rk, kp);
  planes_of<NR>(rk_dec, kd);
  for (long long i = 0; i < n; ++i) {
    uint32_t s[8];
    aes_block::pack(load(in, i), s);
    aes_block::encrypt_block<NR>(s, kp);
    aes_block::decrypt_block<NR>(s, kd);
    store(out, i, aes_block::unpack(s));
  }
}

template <int NR>
static void cbc(const uint32_t* rks_dec, int k, const int32_t* slots, const uint32_t* c,
                const uint32_t* prev, uint32_t* out, long long n) {
  constexpr int kWords = 4 * (NR + 1);
  uint32_t kp[64 * 8 * (NR + 1)];
  for (int j = 0; j < k; ++j) planes_of<NR>(rks_dec + j * kWords, kp + j * 8 * (NR + 1));
  for (long long i = 0; i < n; ++i) {
    int sl = slots[i] < 0 ? 0 : slots[i];
    sl = sl < k ? sl : k - 1;
    store(out, i, aes_block::cbc_dec_block<NR>(load(c, i), load(prev, i),
                                               kp + sl * 8 * (NR + 1)));
  }
}

extern "C" int block_decrypt(const uint32_t* rk_dec, int nr, const uint32_t* in, long long n,
                             uint32_t* out) {
  switch (nr) {
    case 10: decrypt<10>(rk_dec, in, n, out); return 0;
    case 12: decrypt<12>(rk_dec, in, n, out); return 0;
    case 14: decrypt<14>(rk_dec, in, n, out); return 0;
    default: return 1;
  }
}

extern "C" int block_round_trip(const uint32_t* rk, const uint32_t* rk_dec, int nr,
                                const uint32_t* in, long long n, uint32_t* out) {
  switch (nr) {
    case 10: round_trip<10>(rk, rk_dec, in, n, out); return 0;
    case 12: round_trip<12>(rk, rk_dec, in, n, out); return 0;
    case 14: round_trip<14>(rk, rk_dec, in, n, out); return 0;
    default: return 1;
  }
}

// InvMixColumns then AddRoundKey of 8 planes, as the kernel runs it
// (inv_mix_add_key) and as the MixColumns-based form: a ^= 4(a ^ a_(r+2)),
// then aes_block::mix_columns, then the key.
extern "C" void inv_mix_planes(const uint32_t* in, const uint32_t* k, uint32_t* got,
                               uint32_t* want) {
  uint32_t s[8], r[8], w[8], x2[8], x4[8];
  for (int b = 0; b < 8; ++b) s[b] = r[b] = in[b];
  aes_block::inv_mix_add_key(s, k);
  for (int b = 0; b < 8; ++b) w[b] = r[b] ^ aes_block::row_after_next(r[b]);
  aes_bitslice::xtime(w, x2);
  aes_bitslice::xtime(x2, x4);
  for (int b = 0; b < 8; ++b) r[b] ^= x4[b];
  aes_block::mix_columns(r);
  for (int b = 0; b < 8; ++b) {
    got[b] = s[b];
    want[b] = r[b] ^ k[b];
  }
}

extern "C" int block_cbc(const uint32_t* rks_dec, int k, int nr, const int32_t* slots,
                         const uint32_t* c, const uint32_t* prev, uint32_t* out, long long n) {
  if (k < 1 || k > 64) return 1;
  switch (nr) {
    case 10: cbc<10>(rks_dec, k, slots, c, prev, out, n); return 0;
    case 12: cbc<12>(rks_dec, k, slots, c, prev, out, n); return 0;
    case 14: cbc<14>(rks_dec, k, slots, c, prev, out, n); return 0;
    default: return 1;
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's arithmetic as host C++")
    out = tmp_path_factory.mktemp("cbc_mk_host")
    (out / "block_inv.cpp").write_text(HOST_SOURCE)
    so = out / "libblock_inv_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
                    "-o", str(so), str(out / "block_inv.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.block_decrypt.argtypes = [vp, ci, vp, ll, vp]
    lib.block_round_trip.argtypes = [vp, vp, ci, vp, ll, vp]
    lib.block_cbc.argtypes = [vp, ci, ci, vp, vp, vp, vp, ll]
    for fn in (lib.block_decrypt, lib.block_round_trip, lib.block_cbc):
        fn.restype = ci
    lib.inv_mix_planes.argtypes = [vp, vp, vp, vp]
    lib.inv_mix_planes.restype = None
    return lib


def _u32(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _schedules(bits, seed):
    """(nr, encrypt schedule, decrypt schedule) of a random key."""
    nr, rk = expand_key_enc(np.random.default_rng(seed).integers(
        0, 256, bits // 8, dtype=np.uint8).tobytes())
    return nr, rk, dec_schedule_from_enc(nr, rk)


def _c(a, dtype=np.uint32):
    return np.ascontiguousarray(a, dtype)


def _t(a):
    return packing.words_tensor(np.asarray(a, np.uint32), "cpu")


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_decrypt_block_matches_plain(host_lib, bits):
    nr, _rk, rk_dec = _schedules(bits, seed=bits)
    w = _c(_u32(np.random.default_rng(bits + 1), 257, 4))
    # Blocks whose bytes are all equal, or one bit set, exercise every lane.
    w[:8] = np.uint32(0x01010101) * np.arange(8, dtype=np.uint32)[:, None]
    w[8:136] = 0
    w[8:136].reshape(-1)[np.arange(128) * 4 + np.arange(128) // 32] = (
        np.uint32(1) << (np.arange(128) % 32).astype(np.uint32))
    out = np.zeros_like(w)
    assert host_lib.block_decrypt(_c(rk_dec).ctypes.data, nr, w.ctypes.data, w.shape[0],
                                  out.ctypes.data) == 0
    want = bitslice.decrypt_words(_t(w), _t(rk_dec), nr)
    np.testing.assert_array_equal(out, packing.words_numpy(want))


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_decrypt_block_inverts_encrypt_block(host_lib, bits):
    nr, rk, rk_dec = _schedules(bits, seed=bits + 7)
    w = _c(_u32(np.random.default_rng(bits + 8), 100, 4))
    out = np.zeros_like(w)
    assert host_lib.block_round_trip(_c(rk).ctypes.data, _c(rk_dec).ctypes.data, nr,
                                     w.ctypes.data, w.shape[0], out.ctypes.data) == 0
    np.testing.assert_array_equal(out, w)


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("n", [1, 31, 33, 100])
def test_cbc_dec_block_matches_plain(host_lib, bits, k, n):
    """Random slots over K decrypt schedules, the upper half of them the
    unused all-zero schedule, against the plain version."""
    rng = np.random.default_rng(bits * 1000 + k * 100 + n)
    nr = _schedules(bits, seed=0)[0]
    rks = np.stack([_schedules(bits, seed=int(s))[2] for s in rng.integers(1, 1 << 30, k)])
    rks[(k + 1) // 2:] = 0
    slots = rng.integers(0, k, n).astype(np.int32)
    c, prev = _c(_u32(rng, n, 4)), _c(_u32(rng, n, 4))
    out = np.zeros_like(c)
    assert host_lib.block_cbc(_c(rks).ctypes.data, k, nr, slots.ctypes.data, c.ctypes.data,
                              prev.ctypes.data, out.ctypes.data, n) == 0
    want = cuda_aes.cbc_scattered_multikey_plain(_t(c), _t(prev), _t(rks),
                                                 torch.from_numpy(slots), nr)
    np.testing.assert_array_equal(out, packing.words_numpy(want))


def test_cbc_dec_block_clamps_a_bad_slot(host_lib):
    """A slot outside [0, K) reads slot 0 (below) or K - 1 (above), as the
    kernel clamps it; the CPU wrapper refuses such a vector."""
    nr, _rk, rk_dec = _schedules(128, seed=3)
    rks = np.stack([rk_dec, _schedules(128, seed=4)[2]])
    slots = np.array([-5, 0, 1, 2, 99], np.int32)
    rng = np.random.default_rng(5)
    c, prev = _c(_u32(rng, 5, 4)), _c(_u32(rng, 5, 4))
    out = np.zeros_like(c)
    assert host_lib.block_cbc(_c(rks).ctypes.data, 2, nr, slots.ctypes.data, c.ctypes.data,
                              prev.ctypes.data, out.ctypes.data, 5) == 0
    clamped = torch.from_numpy(np.clip(slots, 0, 1))
    want = cuda_aes.cbc_scattered_multikey_plain(_t(c), _t(prev), _t(rks), clamped, nr)
    np.testing.assert_array_equal(out, packing.words_numpy(want))
    with pytest.raises(ValueError, match="key_slots"):
        cuda_aes.cbc_scattered_multikey(_t(c), _t(prev), _t(rks), torch.from_numpy(slots), nr)


def test_inv_mix_add_key_matches_the_mixcolumns_form(host_lib):
    """The kernel's InvMixColumns with AddRoundKey (multiplies for the
    shifts, 5 u for a ^ a_(r+2), the key in the last XORs) equals the
    pre-transform, ``mix_columns`` and the key XOR on 200 random sets of 8
    planes, each with both 16-lane copies."""
    rng = np.random.default_rng(17)
    for _ in range(200):
        half = _u32(rng, 16) & np.uint32(0xFFFF)
        planes = _c(half[:8] | (half[:8] << np.uint32(16)))
        key = _c(half[8:] | (half[8:] << np.uint32(16)))
        got, want = np.zeros(8, np.uint32), np.zeros(8, np.uint32)
        host_lib.inv_mix_planes(planes.ctypes.data, key.ctypes.data, got.ctypes.data,
                                want.ctypes.data)
        np.testing.assert_array_equal(got, want)
