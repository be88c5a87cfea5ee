"""The multi-key CBC decrypt of the ``cbc`` serve mode held bit-exact against
the JAX reference on the same numpy inputs: the port's
``bitslice.decrypt_words_multikey`` against the reference's, and the port's
seam ``models.aes.cbc_decrypt_words_scattered_multikey`` (engines
``bitslice``, ``ttable`` and the CUDA engine's wrapper, which on CPU tensors
runs its plain version) against the reference's (engines ``jnp`` and
``bitslice``); NIST SP800-38A F.2.2/F.2.4/F.2.6 in slot 3 of 8 and the
``tests/golden/golden.json`` CBC vectors through the seam; the wrapper's
checks. Integer cryptography: the tolerance is zero."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from our_tree_tpu.models import aes as jaes
from our_tree_tpu.ops import bitslice as jbitslice
from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.ops import bitslice, cuda_aes
from our_tree_tpu_torch.ops.keyschedule import dec_schedule_from_enc, expand_key_enc
from our_tree_tpu_torch.utils import packing

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden.json")
SP800_IV = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
SP800_PT = bytes.fromhex("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
                         "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
#: NIST SP800-38A F.2.2, F.2.4, F.2.6 (CBC-AES128/192/256.Decrypt): key, ciphertext.
SP800_CBC = {
    128: ("2b7e151628aed2a6abf7158809cf4f3c",
          "7649abac8119b246cee98e9b12e9197d5086cb9b507219ee95db113a917678b2"
          "73bed6b8e3c1743b7116e69e222295163ff1caa1681fac09120eca307586e1a7"),
    192: ("8e73b0f7da0e6452c810f32b809079e562f8ead2522c6b7b",
          "4f021db243bc633d7178183a9fa071e8b4d9ada9ad7dedf4e5e738763f69145a"
          "571b242012fb7ae07fa9baac3df102e008b0e27988598881d920a9e64f5615cd"),
    256: ("603deb1015ca71be2b73aef0857d77811f352c073b6108d72d9810a30914dff4",
          "f58c4c04d6e5f1ba779eabfb5f7bfbd69cfc4e967edb808d679f777bc6702c7d"
          "39f23369a9d9bacfa530e26304231461b2eb05e2c39be9fcda6c19078c6a9d1b"),
}
ENGINES = [aes.PLAIN_ENGINE, aes.TTABLE_ENGINE, aes.CUDA_ENGINE]


def _t(w):
    return packing.words_tensor(np.asarray(w, dtype=np.uint32), "cpu")


def _n(t):
    return packing.words_numpy(t)


def _u32(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _dec_stack(bits, k, seed, unused=0):
    """(nr, (k, 4*(nr+1)) uint32 decrypt schedules of random keys); the last
    ``unused`` rows are the all-zero schedule of an unused slot."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(k):
        nr, rk = expand_key_enc(rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes())
        rows.append(dec_schedule_from_enc(nr, rk))
    rks = np.stack(rows)
    if unused:
        rks[k - unused:] = 0
    return nr, rks


def _words(data: bytes) -> np.ndarray:
    return packing.np_bytes_to_words(np.frombuffer(data, np.uint8)).reshape(-1, 4)


def _prev(iv: bytes, ct: bytes) -> np.ndarray:
    """The PREV stream of one request: its IV, then its ciphertext shifted."""
    return _words(iv + ct[:-16])


SIZES = (1, 31, 33, 100)
SLOTS = (1, 3, 8)


def _mk_case(bits, n, k):
    """(nr, (n, 4) words, (n, 4(nr+1)) per-block decrypt schedules): random
    slots over K schedules, the upper half of them unused (zero)."""
    nr, rks = _dec_stack(bits, k, seed=bits + 10 * n + k, unused=k // 2)
    rng = np.random.default_rng(bits * n + k)
    slots = rng.integers(0, k, n)
    return nr, _u32(rng, n, 4), rks[slots]


@pytest.fixture(scope="module")
def reference_decrypts():
    """The reference's ``decrypt_words_multikey`` of every case, one call per
    key length over all its cases laid end to end (blocks are independent,
    so each case's rows are its own output; one eager call each keeps the
    file short)."""
    out = {}
    for bits in (128, 192, 256):
        cases = [(n, k, *_mk_case(bits, n, k)[1:]) for n in SIZES for k in SLOTS]
        nr = _mk_case(bits, 1, 1)[0]
        want = np.asarray(jbitslice.decrypt_words_multikey(
            jnp.asarray(np.concatenate([c[2] for c in cases])),
            jnp.asarray(np.concatenate([c[3] for c in cases])), nr))
        off = 0
        for n, k, _w, _r in cases:
            out[(bits, n, k)] = want[off:off + n]
            off += n
    return out


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", SLOTS)
def test_decrypt_words_multikey_matches_reference(reference_decrypts, bits, n, k):
    """Random slots over K decrypt schedules, the upper half unused (zero)."""
    nr, w, rk_blocks = _mk_case(bits, n, k)
    got = bitslice.decrypt_words_multikey(_t(w), _t(rk_blocks), nr)
    np.testing.assert_array_equal(_n(got), reference_decrypts[(bits, n, k)])


def _seam_case(bits):
    """100 blocks, K = 8 (two slots unused), random slots, random PREV."""
    nr, rks = _dec_stack(bits, 8, seed=bits, unused=2)
    rng = np.random.default_rng(bits + 1)
    slots = rng.integers(0, 6, 100).astype(np.int32)
    return nr, rks, slots, _u32(rng, 100, 4).reshape(-1), _u32(rng, 100, 4).reshape(-1)


@pytest.fixture(scope="module")
def reference_seam():
    """(bits, reference engine) -> the reference seam's output (one jit
    compile each, shared by the port's three engines)."""
    cache = {}

    def get(bits, ref_engine):
        if (bits, ref_engine) not in cache:
            nr, rks, slots, w, prev = _seam_case(bits)
            cache[(bits, ref_engine)] = np.asarray(jaes.cbc_decrypt_words_scattered_multikey(
                jnp.asarray(w), jnp.asarray(prev), jnp.asarray(rks),
                jnp.asarray(slots.astype(np.uint32)), nr, ref_engine))
        return cache[(bits, ref_engine)]

    return get


@pytest.mark.parametrize("bits", [128, 256])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("ref_engine", ["jnp", "bitslice"])
def test_seam_matches_reference(reference_seam, bits, engine, ref_engine):
    """The serve seam on flat (4N,) words against the reference's seam."""
    nr, rks, slots, w, prev = _seam_case(bits)
    got = aes.cbc_decrypt_words_scattered_multikey(_t(w), _t(prev), _t(rks),
                                                   torch.from_numpy(slots), nr, engine)
    assert got.shape == (400,)
    np.testing.assert_array_equal(_n(got), reference_seam(bits, ref_engine))


@pytest.mark.parametrize("engine", ENGINES)
def test_sp800_cbc_decrypt_in_slot_3_of_8(engine):
    """F.2.2, F.2.4 and F.2.6, each in slot 3 of an 8-slot stack (slots 6-7
    unused) with other tenants' blocks interleaved; the KAT's blocks give
    back the plaintext."""
    for bits, (key_hex, ct_hex) in SP800_CBC.items():
        key, ct = bytes.fromhex(key_hex), bytes.fromhex(ct_hex)
        nr, rks = _dec_stack(bits, 8, seed=29 + bits, unused=2)
        rks[3] = dec_schedule_from_enc(*expand_key_enc(key))
        slots = np.array([3, 0, 1, 3, 4, 3, 5, 2, 3, 0], np.int32)
        rng = np.random.default_rng(bits)
        w, prev = _u32(rng, 10, 4), _u32(rng, 10, 4)
        w[slots == 3] = _words(ct)
        prev[slots == 3] = _prev(SP800_IV, ct)
        out = aes.cbc_decrypt_words_scattered_multikey(_t(w), _t(prev), _t(rks),
                                                       torch.from_numpy(slots), nr, engine)
        got = packing.np_words_to_bytes(_n(out)[slots == 3].reshape(-1)).tobytes()
        assert got == SP800_PT, (bits, engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_golden_cbc_vectors_through_the_seam(engine):
    """Every ``aes`` golden vector's CBC ciphertext decrypts back to its
    plaintext, and its plaintext read as ciphertext to ``cbc_dec``, as two
    requests of one two-key batch."""
    with open(GOLDEN, encoding="utf-8") as fh:
        vectors = json.load(fh)["aes"]
    for v in vectors:
        key, iv = bytes.fromhex(v["key"]), bytes.fromhex(v["iv"])
        pt, ct, dec = (bytes.fromhex(v[k]) for k in ("pt", "cbc_ct", "cbc_dec"))
        nr, rk = expand_key_enc(key)
        other = _dec_stack(v["keybits"], 1, seed=v["keybits"])[1][0]
        rks = np.stack([other, dec_schedule_from_enc(nr, rk)])
        w = np.concatenate([_words(ct), _words(pt)])
        prev = np.concatenate([_prev(iv, ct), _prev(iv, pt)])
        slots = np.ones(w.shape[0], np.int32)
        out = aes.cbc_decrypt_words_scattered_multikey(_t(w), _t(prev), _t(rks),
                                                       torch.from_numpy(slots), nr, engine)
        got = packing.np_words_to_bytes(_n(out).reshape(-1)).tobytes()
        assert got == pt + dec, (v["keybits"], engine)


def test_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch):
    """Shapes, dtypes, K and slots are checked before anything runs; CPU
    tensors reach the plain version with no build and no launch counted."""
    def no_build():
        raise AssertionError("a CPU tensor must not reach the kernel build")

    monkeypatch.setattr(cuda_aes.cuda_build, "load", no_build)
    monkeypatch.setattr(cuda_aes.cbc_scattered_multikey, "launches", 0)
    nr, rks = _dec_stack(128, 2, seed=1)
    rks_t = _t(rks)
    w = torch.zeros((8, 4), dtype=torch.int32)
    sl = torch.zeros(8, dtype=torch.int32)
    cbc = cuda_aes.cbc_scattered_multikey
    out = cbc(w, w, rks_t, sl, nr)
    assert torch.equal(out, cuda_aes.cbc_scattered_multikey_plain(w, w, rks_t, sl, nr))
    assert cbc(w[:0], w[:0], rks_t, sl[:0], nr).shape == (0, 4)
    with pytest.raises(TypeError):
        cbc(w.long(), w, rks_t, sl, nr)
    with pytest.raises(TypeError):
        cbc(w, w, rks_t, sl.long(), nr)
    with pytest.raises(ValueError):
        cbc(w, w[:7], rks_t, sl, nr)
    with pytest.raises(ValueError):
        cbc(w, w, rks_t, sl[:7], nr)
    with pytest.raises(ValueError):
        cbc(w, w, rks_t, sl, 12)
    with pytest.raises(ValueError):
        cbc(w, w, rks_t[:, :40].contiguous(), sl, nr)
    with pytest.raises(ValueError, match="schedules"):
        cbc(w, w, torch.zeros((65, 44), dtype=torch.int32), sl, nr)
    with pytest.raises(ValueError, match="key_slots"):
        cbc(w, w, rks_t, torch.full((8,), 2, dtype=torch.int32), nr)
    with pytest.raises(ValueError, match="key_slots"):
        cbc(w, w, rks_t, torch.full((8,), -1, dtype=torch.int32), nr)
    assert cbc.launches == 0
