"""The per-block bitsliced AES core (``csrc/aes_block.cuh``) compiled as host
C++ with g++: ``encrypt_block`` held bit-exact against the plain torch
version (``bitslice.encrypt_words``); the chained CBC/CFB128 loop the
``seq_encrypt`` kernel runs (``chain_stream``) against the JAX package's
``cbc_encrypt_words``, ``cfb128_encrypt_words`` and
``cbc_encrypt_words_batch``; and the block form of ``ctr_mk``
(``ctr_block`` under per-slot key planes, slots clamped as the kernel
clamps them) against ``ctr_scattered_multikey_plain``. The kernels' thread
layout, shared memory and launch run only on the card
(``tests/test_torch_cuda.py``). Integer cryptography: the tolerance is
zero."""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from our_tree_tpu.models import aes as jaes
from our_tree_tpu_torch.ops import bitslice, cuda_aes
from our_tree_tpu_torch.ops.keyschedule import expand_key_enc
from our_tree_tpu_torch.runtime import cuda_build
from our_tree_tpu_torch.utils import packing

HOST_SOURCE = r"""
#include "aes_block.cuh"

template <int NR>
static void planes_of(const uint32_t* rk, uint32_t* kp) {
  for (int r = 0; r <= NR; ++r) aes_block::round_key_planes(rk, r, kp + 8 * r);
}

template <int NR>
static void encrypt(const uint32_t* rk, const uint32_t* in, long long n, uint32_t* out) {
  uint32_t kp[8 * (NR + 1)];
  planes_of<NR>(rk, kp);
  for (long long i = 0; i < n; ++i) {
    uint32_t s[8];
    aes_block::pack(make_uint4(in[4 * i], in[4 * i + 1], in[4 * i + 2], in[4 * i + 3]), s);
    aes_block::encrypt_block<NR>(s, kp);
    const uint4 o = aes_block::unpack(s);
    out[4 * i] = o.x; out[4 * i + 1] = o.y; out[4 * i + 2] = o.z; out[4 * i + 3] = o.w;
  }
}

template <int NR, int CFB>
static void seq(const uint32_t* rk, const uint32_t* in, uint32_t* out, const uint32_t* iv,
                uint32_t* iv_out, int s, long long n) {
  uint32_t kp[8 * (NR + 1)];
  planes_of<NR>(rk, kp);
  const uint4* src = reinterpret_cast<const uint4*>(in);
  uint4* dst = reinterpret_cast<uint4*>(out);
  for (int j = 0; j < s; ++j) {
    const uint4 v = make_uint4(iv[4 * j], iv[4 * j + 1], iv[4 * j + 2], iv[4 * j + 3]);
    const uint4 last = aes_block::chain_stream<NR, CFB>(src + j * n, dst + j * n, n, v, kp);
    iv_out[4 * j] = last.x; iv_out[4 * j + 1] = last.y;
    iv_out[4 * j + 2] = last.z; iv_out[4 * j + 3] = last.w;
  }
}

template <int NR>
static void ctr(const uint32_t* rks, int k, const int32_t* slots, const uint32_t* c,
                const uint32_t* d, uint32_t* out, long long n) {
  constexpr int kWords = 4 * (NR + 1);
  uint32_t kp[64 * 8 * (NR + 1)];
  for (int j = 0; j < k; ++j) planes_of<NR>(rks + j * kWords, kp + j * 8 * (NR + 1));
  for (long long i = 0; i < n; ++i) {
    int sl = slots[i] < 0 ? 0 : slots[i];
    sl = sl < k ? sl : k - 1;
    const uint4 o = aes_block::ctr_block<NR>(
        make_uint4(c[4 * i], c[4 * i + 1], c[4 * i + 2], c[4 * i + 3]),
        make_uint4(d[4 * i], d[4 * i + 1], d[4 * i + 2], d[4 * i + 3]), kp + sl * 8 * (NR + 1));
    out[4 * i] = o.x; out[4 * i + 1] = o.y; out[4 * i + 2] = o.z; out[4 * i + 3] = o.w;
  }
}

extern "C" int block_encrypt(const uint32_t* rk, int nr, const uint32_t* in, long long n,
                             uint32_t* out) {
  switch (nr) {
    case 10: encrypt<10>(rk, in, n, out); return 0;
    case 12: encrypt<12>(rk, in, n, out); return 0;
    case 14: encrypt<14>(rk, in, n, out); return 0;
    default: return 1;
  }
}

extern "C" int block_seq(const uint32_t* rk, int nr, int cfb, const uint32_t* in, uint32_t* out,
                         const uint32_t* iv, uint32_t* iv_out, int s, long long n) {
  switch (nr * 2 + (cfb ? 1 : 0)) {
    case 20: seq<10, 0>(rk, in, out, iv, iv_out, s, n); return 0;
    case 21: seq<10, 1>(rk, in, out, iv, iv_out, s, n); return 0;
    case 24: seq<12, 0>(rk, in, out, iv, iv_out, s, n); return 0;
    case 25: seq<12, 1>(rk, in, out, iv, iv_out, s, n); return 0;
    case 28: seq<14, 0>(rk, in, out, iv, iv_out, s, n); return 0;
    case 29: seq<14, 1>(rk, in, out, iv, iv_out, s, n); return 0;
    default: return 1;
  }
}

extern "C" int block_ctr(const uint32_t* rks, int k, int nr, const int32_t* slots,
                         const uint32_t* c, const uint32_t* d, uint32_t* out, long long n) {
  if (k < 1 || k > 64) return 1;
  switch (nr) {
    case 10: ctr<10>(rks, k, slots, c, d, out, n); return 0;
    case 12: ctr<12>(rks, k, slots, c, d, out, n); return 0;
    case 14: ctr<14>(rks, k, slots, c, d, out, n); return 0;
    default: return 1;
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel's arithmetic as host C++")
    out = tmp_path_factory.mktemp("seq_host")
    (out / "block.cpp").write_text(HOST_SOURCE)
    so = out / "libblock_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", f"-I{cuda_build.CSRC}",
                    "-o", str(so), str(out / "block.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.block_encrypt.argtypes = [vp, ci, vp, ll, vp]
    lib.block_seq.argtypes = [vp, ci, ci, vp, vp, vp, vp, ci, ll]
    lib.block_ctr.argtypes = [vp, ci, ci, vp, vp, vp, vp, ll]
    for fn in (lib.block_encrypt, lib.block_seq, lib.block_ctr):
        fn.restype = ci
    return lib


def _u32(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _key(bits, seed):
    return expand_key_enc(np.random.default_rng(seed).integers(
        0, 256, bits // 8, dtype=np.uint8).tobytes())


def _c(a, dtype=np.uint32):
    return np.ascontiguousarray(a, dtype)


def _host_seq(lib, rk, nr, cfb, w, iv):
    """(S, N, 4) words and (S, 4) IVs through ``chain_stream``."""
    w, iv, rk = _c(w), _c(iv), _c(rk)
    out, iv_out = np.zeros_like(w), np.zeros_like(iv)
    assert lib.block_seq(rk.ctypes.data, nr, int(cfb), w.ctypes.data, out.ctypes.data,
                         iv.ctypes.data, iv_out.ctypes.data, w.shape[0], w.shape[1]) == 0
    return out, iv_out


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_encrypt_block_matches_plain(host_lib, bits):
    nr, rk = _key(bits, seed=bits)
    w = _c(_u32(np.random.default_rng(bits + 1), 257, 4))
    # Blocks whose bytes are all equal, or one bit set, exercise every lane.
    w[:8] = np.uint32(0x01010101) * np.arange(8, dtype=np.uint32)[:, None]
    w[8:136] = 0
    w[8:136].reshape(-1)[np.arange(128) * 4 + np.arange(128) // 32] = (
        np.uint32(1) << (np.arange(128) % 32).astype(np.uint32))
    out = np.zeros_like(w)
    assert host_lib.block_encrypt(_c(rk).ctypes.data, nr, w.ctypes.data, w.shape[0],
                                  out.ctypes.data) == 0
    want = bitslice.encrypt_words(packing.words_tensor(w, "cpu"), packing.words_tensor(rk, "cpu"),
                                  nr)
    np.testing.assert_array_equal(out, packing.words_numpy(want))


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("n", [0, 1, 5, 33])
@pytest.mark.parametrize("mode", ["cbc", "cfb128"])
def test_chained_stream_matches_reference(host_lib, bits, n, mode):
    nr, rk = _key(bits, seed=3 * bits + n)
    rng = np.random.default_rng(bits + n)
    w, iv = _u32(rng, 1, n, 4), _u32(rng, 1, 4)
    got, got_iv = _host_seq(host_lib, rk, nr, mode == "cfb128", w, iv)
    ref = jaes.cbc_encrypt_words if mode == "cbc" else jaes.cfb128_encrypt_words
    want, want_iv = ref(jnp.asarray(w[0]), jnp.asarray(iv[0]), jnp.asarray(rk), nr)
    np.testing.assert_array_equal(got[0], np.asarray(want).reshape(n, 4))
    np.testing.assert_array_equal(got_iv[0], np.asarray(want_iv))


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("n", [0, 1, 5, 33])
@pytest.mark.parametrize("s", [1, 3])
def test_chained_batch_matches_reference(host_lib, bits, n, s):
    nr, rk = _key(bits, seed=5 * bits + n + s)
    rng = np.random.default_rng(7 * bits + n + s)
    w, iv = _u32(rng, s, n, 4), _u32(rng, s, 4)
    got, got_iv = _host_seq(host_lib, rk, nr, False, w, iv)
    if n == 0:
        # No block step: the reference returns its input and the IVs as given.
        np.testing.assert_array_equal(got_iv, iv)
        return
    want, want_iv = jaes.cbc_encrypt_words_batch(jnp.asarray(w), jnp.asarray(iv),
                                                 jnp.asarray(rk), nr)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_iv, np.asarray(want_iv))
    for j in range(s):  # each stream is the single-stream chain
        one, one_iv = jaes.cbc_encrypt_words(jnp.asarray(w[j]), jnp.asarray(iv[j]),
                                             jnp.asarray(rk), nr)
        np.testing.assert_array_equal(got[j], np.asarray(one))
        np.testing.assert_array_equal(got_iv[j], np.asarray(one_iv))


def _slots(pattern, k, n, rng):
    if pattern == "uniform":
        return np.full(n, k - 1, np.int32)
    if pattern == "runs":
        out, pos = np.zeros(n, np.int32), 0
        while pos < n:
            length = int(rng.integers(1, 40))
            out[pos: pos + length] = rng.integers(k)
            pos += length
        return out
    return rng.integers(0, k, n).astype(np.int32)


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("pattern", ["uniform", "runs", "random"])
def test_ctr_block_form_matches_plain(host_lib, bits, k, pattern):
    rng = np.random.default_rng(bits * k + len(pattern))
    rows = [_key(bits, seed=int(rng.integers(1 << 30))) for _ in range(k)]
    nr, rks = rows[0][0], _c(np.stack([r for _, r in rows]))
    n = 97
    slots = _slots(pattern, k, n, rng)
    c, d = _c(_u32(rng, n, 4)), _c(_u32(rng, n, 4))
    out = np.zeros_like(d)
    assert host_lib.block_ctr(rks.ctypes.data, k, nr, slots.ctypes.data, c.ctypes.data,
                              d.ctypes.data, out.ctypes.data, n) == 0
    t = lambda a: packing.words_tensor(a, "cpu")  # noqa: E731
    want = cuda_aes.ctr_scattered_multikey_plain(t(d), t(c), t(rks), t(slots.astype(np.uint32)), nr)
    np.testing.assert_array_equal(out, packing.words_numpy(want))


def test_ctr_block_form_clamps_a_bad_slot(host_lib):
    """A slot outside [0, K) is clamped (below 0 to 0, from K up to K - 1), as
    the kernel does, so no key plane outside the K schedules is read."""
    rng = np.random.default_rng(4)
    rows = [_key(128, seed=i) for i in range(3)]
    nr, rks = 10, _c(np.stack([r for _, r in rows]))
    slots = np.array([0, 7, -5, 2, 1, 99, -1, 2], np.int32)
    c, d = _c(_u32(rng, 8, 4)), _c(_u32(rng, 8, 4))
    out = np.zeros_like(d)
    assert host_lib.block_ctr(rks.ctypes.data, 3, nr, slots.ctypes.data, c.ctypes.data,
                              d.ctypes.data, out.ctypes.data, 8) == 0
    t = lambda a: packing.words_tensor(a, "cpu")  # noqa: E731
    want = cuda_aes.ctr_scattered_multikey_plain(
        t(d), t(c), t(rks), t(np.clip(slots, 0, 2).astype(np.uint32)), nr)
    np.testing.assert_array_equal(out, packing.words_numpy(want))
