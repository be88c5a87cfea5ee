"""The ECB kernels' arithmetic (``csrc/aes_bitslice.cuh`` and
``csrc/aes_inv_bitslice.cuh``: both S-boxes, both round forms, the
transposes, ``ecb_encrypt_group`` and ``ecb_decrypt_group``; and the encrypt
block form's per-block ``ecb_block`` from ``csrc/aes_block.cuh``) compiled as host C++ with g++ and held bit-exact against the plain torch
version, and the
decrypt header's generated blocks held equal to what
``ops/xor_programs.py`` derives. The kernels' loads, stores and ragged-tail
mask run only on the card (``tests/test_torch_cuda.py``)."""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from our_tree_tpu.ops import bitslice as jbitslice
from our_tree_tpu_torch.ops import bitslice, tables, xor_programs
from our_tree_tpu_torch.ops.keyschedule import expand_key_dec, expand_key_enc
from our_tree_tpu_torch.runtime import cuda_build
from our_tree_tpu_torch.utils import packing

HOST_SOURCE = r"""
#include "aes_block.cuh"
#include "aes_inv_bitslice.cuh"

template <int NR, bool DECRYPT>
static void run(const uint32_t* rk, const uint32_t* in, int groups, uint32_t* out) {
  uint32_t kmask[(NR + 1) * 128];
  for (int i = 0; i < (NR + 1) * 128; ++i) kmask[i] = aes_bitslice::key_mask(rk, i);
  for (int g = 0; g < groups; ++g) {
    uint32_t s[128];
    for (int t = 0; t < 32; ++t)
      for (int c = 0; c < 4; ++c) s[32 * c + t] = in[4 * (32 * g + t) + c];
    if (DECRYPT) aes_bitslice::ecb_decrypt_group<NR>(s, kmask);
    else aes_bitslice::ecb_encrypt_group<NR>(s, kmask);
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
  if (inverse) aes_bitslice::inv_sbox(x);
  else aes_bitslice::sbox_bp(x);
}

// a: one column's 32 planes (8r + b = bit b of row r), km: its 32 key planes.
extern "C" void inv_mix_planes(const uint32_t* a, const uint32_t* km, uint32_t* o) {
  uint32_t col[4][8];
  for (int i = 0; i < 32; ++i) col[i / 8][i % 8] = a[i];
  aes_bitslice::inv_mix_column(col, km, o);
}

// The encrypt block form's arithmetic: the key planes as the kernel's
// prologue makes them, then one block at a time through ecb_block.
template <int NR>
static void blocks(const uint32_t* rk, const uint32_t* in, long long n, uint32_t* out) {
  uint32_t kp[8 * (NR + 1)];
  for (int r = 0; r <= NR; ++r) aes_block::round_key_planes(rk, r, kp + 8 * r);
  for (long long i = 0; i < n; ++i) {
    const uint4 o = aes_block::ecb_block<NR>(
        make_uint4(in[4 * i], in[4 * i + 1], in[4 * i + 2], in[4 * i + 3]), kp);
    out[4 * i] = o.x; out[4 * i + 1] = o.y; out[4 * i + 2] = o.z; out[4 * i + 3] = o.w;
  }
}

extern "C" int ecb_blocks(const uint32_t* rk, int nr, const uint32_t* in, long long n,
                          uint32_t* out) {
  switch (nr) {
    case 10: blocks<10>(rk, in, n, out); return 0;
    case 12: blocks<12>(rk, in, n, out); return 0;
    case 14: blocks<14>(rk, in, n, out); return 0;
    default: return 1;
  }
}

extern "C" void transpose_words(uint32_t* a, int prmt) {
  if (prmt) aes_bitslice::transpose32_prmt(a);
  else aes_bitslice::transpose32(a);
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
    lib.inv_mix_planes.argtypes = [vp, vp, vp]
    lib.inv_mix_planes.restype = None
    lib.transpose_words.argtypes = [vp, ctypes.c_int]
    lib.transpose_words.restype = None
    lib.ecb_blocks.argtypes = [vp, ctypes.c_int, vp, ctypes.c_longlong, vp]
    lib.ecb_blocks.restype = ctypes.c_int
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


def _host_sbox(lib, inverses, x=None):
    """The header's S-boxes on all 256 inputs (8 groups of 32 lanes), or on
    ``x``: each of ``inverses`` in turn (True: the inverse S-box)."""
    x = np.arange(256, dtype=np.uint32) if x is None else np.asarray(x, np.uint32)
    x = x.reshape(8, 32)
    got = np.zeros(256, np.uint32)
    for k in range(8):
        planes = np.array([sum(int((x[k, t] >> b) & 1) << t for t in range(32))
                           for b in range(8)], np.uint32)
        for inverse in inverses:
            lib.sbox_planes(planes.ctypes.data, int(inverse))
        for t in range(32):
            got[32 * k + t] = sum(((int(planes[b]) >> t) & 1) << b for b in range(8))
    return got


@pytest.mark.parametrize("inverse", [False, True])
def test_host_sbox_exhaustive(host_lib, inverse):
    """Every byte in every lane: the groups put byte 32k + t in lane t."""
    want = tables.INV_SBOX if inverse else tables.SBOX
    np.testing.assert_array_equal(_host_sbox(host_lib, [inverse]), want)
    # And each byte in the other lanes: rotate the bytes across the lanes.
    for shift in (1, 13, 31):
        x = np.roll(np.arange(256, dtype=np.uint32).reshape(8, 32), shift, axis=1).reshape(-1)
        np.testing.assert_array_equal(_host_sbox(host_lib, [inverse], x), want[x])


def test_host_inv_sbox_matches_tower_forms(host_lib):
    """The dedicated inverse circuit over all 256 bytes against the port's
    plain tower form and the JAX reference's inverse S-box, the same bytes
    through each."""
    x = np.arange(256, dtype=np.int64)
    planes = [-((x >> b) & 1) for b in range(8)]
    port = bitslice.inv_sbox_planes([torch.from_numpy(p.astype(np.int32)) for p in planes])
    ref = jbitslice.inv_sbox_planes([jnp.asarray(p.astype(np.uint32)) for p in planes])
    port_b = sum((o.numpy().astype(np.int64) & 1) << b for b, o in enumerate(port))
    ref_b = sum((np.asarray(o).astype(np.int64) & 1) << b for b, o in enumerate(ref))
    got = _host_sbox(host_lib, [True])
    np.testing.assert_array_equal(got, port_b)
    np.testing.assert_array_equal(got, ref_b)


@pytest.mark.parametrize("order", [(False, True), (True, False)], ids=["inv_after_s", "s_after_inv"])
def test_host_sbox_round_trip(host_lib, order):
    """InvS(S(x)) and S(InvS(x)) are x for all 256 bytes, through the header."""
    np.testing.assert_array_equal(_host_sbox(host_lib, order), np.arange(256))


def test_host_inv_mix_column_matches_plain(host_lib):
    """inv_mix_column plus its key planes on random columns against the
    port's bitslice.inv_mixcolumns_planes and the JAX reference's (4
    columns, 32 lanes each)."""
    rng = np.random.default_rng(7)
    for _ in range(4):
        state = rng.integers(-2**31, 2**31, (8, 16, 1), dtype=np.int64).astype(np.int32)
        keys = rng.integers(-2**31, 2**31, (8, 16), dtype=np.int64).astype(np.int32)
        out = bitslice.inv_mixcolumns_planes([torch.from_numpy(state[b]) for b in range(8)])
        want = np.stack([out[b].numpy()[:, 0] for b in range(8)]) ^ keys
        ref = jbitslice.inv_mixcolumns_planes([jnp.asarray(state[b].view(np.uint32))
                                               for b in range(8)])
        np.testing.assert_array_equal(
            np.stack([np.asarray(ref[b])[:, 0] for b in range(8)]).view(np.int32) ^ keys, want)
        for c in range(4):
            col = np.array([state[b, 4 * c + r, 0] for r in range(4) for b in range(8)],
                           np.int32).view(np.uint32)
            km = np.array([keys[b, 4 * c + r] for r in range(4) for b in range(8)],
                          np.int32).view(np.uint32)
            got = np.zeros(32, np.uint32)
            host_lib.inv_mix_planes(col.ctypes.data, km.ctypes.data, got.ctypes.data)
            np.testing.assert_array_equal(
                got, np.array([want[b, 4 * c + r] for r in range(4) for b in range(8)],
                              np.int32).view(np.uint32))


def test_host_transpose_prmt_matches_transpose32(host_lib):
    """The decrypt path's byte-permute transpose equals transpose32 and, like
    it, is an involution."""
    rng = np.random.default_rng(9)
    for _ in range(8):
        a = rng.integers(0, 2**32, 32, dtype=np.uint64).astype(np.uint32)
        got, want = a.copy(), a.copy()
        host_lib.transpose_words(got.ctypes.data, 1)
        host_lib.transpose_words(want.ctypes.data, 0)
        np.testing.assert_array_equal(got, want)
        host_lib.transpose_words(got.ctypes.data, 1)
        np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("block", sorted(xor_programs.BLOCKS))
def test_xor_programs_reproduce_header(block):
    """The header's generated blocks are what the searches derive now."""
    assert xor_programs.header_block(block) == xor_programs.BLOCKS[block]()


def test_xor_programs_circuits_on_the_host():
    """The derived programs themselves: InvS over all 256 bytes against the
    table, InvMixColumns plus AddRoundKey on random columns; and their costs
    in 3-input steps (22 and 17 for the S-box layers, 113 for a column)."""
    xor_programs.check_inv_sbox()
    xor_programs.check_inv_mix()
    up, bp = xor_programs.inv_sbox_program()
    assert (len(up), len(bp)) == (22, 17)
    assert xor_programs.steps_of(*xor_programs.inv_mix_program()) == 113


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


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_host_block_form_encrypt_matches_plain(host_lib, bits):
    """The ECB block form's per-block encrypt (``ecb_block``: pack, the rolled
    ``encrypt_block``, unpack) on 1, 2, 31 and 161 blocks, among them blocks
    whose bytes are all equal or that hold one bit, against the plain
    version."""
    nr, rk, _, words = _case(bits, 6)
    words = np.ascontiguousarray(words[:33 + 128])
    words[33:] = 0
    words[33:].reshape(-1)[np.arange(128) * 4 + np.arange(128) // 32] = (
        np.uint32(1) << (np.arange(128) % 32).astype(np.uint32))
    words[:8] = np.uint32(0x01010101) * np.arange(8, dtype=np.uint32)[:, None]
    rk = np.ascontiguousarray(rk, np.uint32)
    for n in (1, 2, 31, words.shape[0]):
        out = np.zeros((n, 4), np.uint32)
        assert host_lib.ecb_blocks(rk.ctypes.data, nr, words.ctypes.data, n,
                                   out.ctypes.data) == 0
        want = bitslice.encrypt_words(packing.words_tensor(words[:n], "cpu"),
                                      packing.words_tensor(rk, "cpu"), nr)
        np.testing.assert_array_equal(out, packing.words_numpy(want))
