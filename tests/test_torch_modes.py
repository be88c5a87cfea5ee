"""The port's block modes (ECB, CBC, CFB128 through the ``AES`` context and
the word-level entries) held bit-exact against the JAX reference on the same
numpy inputs, against ``tests/golden/golden.json`` (the reference C
``aes.c``) and against the NIST SP800-38A vectors. Tolerance zero."""

import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from our_tree_tpu.models import aes as jaes
from our_tree_tpu.models import base as jbase
from our_tree_tpu.ops import keyschedule as jks
from our_tree_tpu_torch.models import aes, base
from our_tree_tpu_torch.utils import packing

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden" / "golden.json").read_text())

#: NIST SP800-38A appendix F: the four plaintext blocks and the keys of
#: F.1.1/F.1.3/F.1.5 (ECB), F.2.1/F.2.3/F.2.5 (CBC) and F.3.13 (CFB128).
SP800_PT = ("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
            "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
SP800_IV = "000102030405060708090a0b0c0d0e0f"
SP800_KEY = {
    128: "2b7e151628aed2a6abf7158809cf4f3c",
    192: "8e73b0f7da0e6452c810f32b809079e562f8ead2522c6b7b",
    256: "603deb1015ca71be2b73aef0857d77811f352c073b6108d72d9810a30914dff4",
}
SP800_ECB = {
    128: "3ad77bb40d7a3660a89ecaf32466ef97f5d3d58503b9699de785895a96fdbaaf"
         "43b1cd7f598ece23881b00e3ed0306887b0c785e27e8ad3f8223207104725dd4",
    192: "bd334f1d6e45f25ff712a214571fa5cc974104846d0ad3ad7734ecb3ecee4eef"
         "ef7afd2270e2e60adce0ba2face6444e9a4b41ba738d6c72fb16691603c18e0e",
    256: "f3eed1bdb5d2a03c064b5a7e3db181f8591ccb10d410ed26dc5ba74a31362870"
         "b6ed21b99ca6f4f9f153e7b1beafed1d23304b7a39f9f3ff067d8d8f9e24ecc7",
}
SP800_CBC = {
    128: "7649abac8119b246cee98e9b12e9197d5086cb9b507219ee95db113a917678b2"
         "73bed6b8e3c1743b7116e69e222295163ff1caa1681fac09120eca307586e1a7",
    192: "4f021db243bc633d7178183a9fa071e8b4d9ada9ad7dedf4e5e738763f69145a"
         "571b242012fb7ae07fa9baac3df102e008b0e27988598881d920a9e64f5615cd",
    256: "f58c4c04d6e5f1ba779eabfb5f7bfbd69cfc4e967edb808d679f777bc6702c7d"
         "39f23369a9d9bacfa530e26304231461b2eb05e2c39be9fcda6c19078c6a9d1b",
}
SP800_CFB128_AES128 = ("3b3fd92eb72dad20333449f8e83cfb4ac8a64537a0b3a93fcde3cdad9f1ce58b"
                       "26751f67a3cbb140b1808cf187a4f4dfc04b05357c5d1c0eeac4c66f9ff7f2e6")


def _u8(hexs):
    return np.frombuffer(bytes.fromhex(hexs), np.uint8)


def _t(w):
    return packing.words_tensor(np.asarray(w, dtype=np.uint32), "cpu")


def _n(t):
    return packing.words_numpy(t)


def _key(bits):
    return np.random.default_rng(bits).integers(0, 256, bits // 8, dtype=np.uint8).tobytes()


def _data(seed, n):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_ecb_and_cbc_match_reference(bits):
    key = _key(bits)
    ours, ref = aes.AES(key, device="cpu"), jaes.AES(key, engine="jnp")
    iv = _data(bits + 1, 16)
    bulk, seq = _data(bits, 4096), _data(bits + 2, 1024)
    for mode in (aes.AES_ENCRYPT, aes.AES_DECRYPT):
        np.testing.assert_array_equal(ours.crypt_ecb(mode, bulk), ref.crypt_ecb(mode, bulk))
    _same(ours.crypt_cbc(aes.AES_DECRYPT, iv, bulk), ref.crypt_cbc(aes.AES_DECRYPT, iv, bulk))
    _same(ours.crypt_cbc(aes.AES_ENCRYPT, iv, seq), ref.crypt_cbc(aes.AES_ENCRYPT, iv, seq))


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_cfb128_matches_reference_with_odd_lengths_and_resume(bits):
    key = _key(bits)
    ours, ref = aes.AES(key, device="cpu"), jaes.AES(key, engine="jnp")
    data = _data(bits + 3, 1 + 15 + 17 + 33 + 523)
    for mode in (aes.AES_ENCRYPT, aes.AES_DECRYPT):
        iv = _data(bits + 4, 16)
        _same(ours.crypt_cfb128(mode, 0, iv, data), ref.crypt_cfb128(mode, 0, iv, data))
        # Chunked, carrying iv_off and the feedback register across calls.
        s_o = s_r = (0, iv)
        pos, parts = 0, []
        for size in (1, 15, 17, 33, 523):
            chunk = data[pos: pos + size]
            pos += size
            out_o, *s_o = ours.crypt_cfb128(mode, *s_o, chunk)
            out_r, *s_r = ref.crypt_cfb128(mode, *s_r, chunk)
            _same((out_o, *s_o), (out_r, *s_r))
            parts.append(out_o)
        np.testing.assert_array_equal(np.concatenate(parts),
                                      ours.crypt_cfb128(mode, 0, iv, data)[0])


@pytest.mark.parametrize("mode", [aes.AES_ENCRYPT, aes.AES_DECRYPT], ids=["encrypt", "decrypt"])
@pytest.mark.parametrize("iv_off", [0, 5])
def test_cfb128_byte_chunks_match_reference(mode, iv_off):
    """Byte-granular CFB128 in chunks of 1, 15, 16 and 17 bytes carried across
    calls from iv_off 0 and 5 (the reference C's aes_crypt_cfb128 resume, the
    hex CLI's --iv-off): output and resume state equal the JAX ``AES``
    context's after every call. Each partial step that needs a keystream
    block goes through ``AES._ecb1``, one ECB launch on the card."""
    key = _key(128)
    ours, ref = aes.AES(key, device="cpu"), jaes.AES(key, engine="jnp")
    data = _data(29 + iv_off, 1 + 15 + 16 + 17)
    s_o = s_r = (iv_off, _data(31, 16))
    pos = 0
    for size in (1, 15, 16, 17):
        chunk = data[pos: pos + size]
        pos += size
        out_o, *s_o = ours.crypt_cfb128(mode, *s_o, chunk)
        out_r, *s_r = ref.crypt_cfb128(mode, *s_r, chunk)
        _same((out_o, *s_o), (out_r, *s_r))


@pytest.mark.parametrize("case", GOLDEN["aes"], ids=lambda c: str(c["keybits"]))
def test_golden_vectors(case):
    a = aes.AES(bytes.fromhex(case["key"]), device="cpu")
    assert a.crypt_ecb(aes.AES_ENCRYPT, _u8(case["pt"])).tobytes().hex() == case["ecb_ct"]
    assert a.crypt_ecb(aes.AES_DECRYPT, _u8(case["pt"])).tobytes().hex() == case["ecb_dec_of_pt"]
    ct, iv_out = a.crypt_cbc(aes.AES_ENCRYPT, _u8(case["iv"]), _u8(case["pt"]))
    assert (ct.tobytes().hex(), iv_out.tobytes().hex()) == (case["cbc_ct"], case["cbc_iv_out"])
    pt, div = a.crypt_cbc(aes.AES_DECRYPT, _u8(case["iv"]), _u8(case["pt"]))
    assert (pt.tobytes().hex(), div.tobytes().hex()) == (case["cbc_dec"], case["cbc_dec_iv_out"])
    ct, off, iv_out = a.crypt_cfb128(aes.AES_ENCRYPT, 0, _u8(case["iv"]), _u8(case["pt_odd"]))
    assert (ct.tobytes().hex(), off, iv_out.tobytes().hex()) == (
        case["cfb_ct"], case["cfb_iv_off"], case["cfb_iv_out"])
    pt, _, _ = a.crypt_cfb128(aes.AES_DECRYPT, 0, _u8(case["iv"]), _u8(case["cfb_ct"]))
    assert pt.tobytes().hex() == case["cfb_dec_roundtrip"]


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_nist_sp800_38a_ecb_cbc(bits):
    a = aes.AES(bytes.fromhex(SP800_KEY[bits]), device="cpu")
    pt, iv = _u8(SP800_PT), _u8(SP800_IV)
    assert a.crypt_ecb(aes.AES_ENCRYPT, pt).tobytes().hex() == SP800_ECB[bits]
    assert a.crypt_ecb(aes.AES_DECRYPT, _u8(SP800_ECB[bits])).tobytes().hex() == SP800_PT
    ct, iv_out = a.crypt_cbc(aes.AES_ENCRYPT, iv, pt)
    assert ct.tobytes().hex() == SP800_CBC[bits] and iv_out.tobytes().hex() == SP800_CBC[bits][-32:]
    assert a.crypt_cbc(aes.AES_DECRYPT, iv, ct)[0].tobytes().hex() == SP800_PT


def test_nist_sp800_38a_cfb128_aes128():
    a = aes.AES(bytes.fromhex(SP800_KEY[128]), device="cpu")
    ct, off, _ = a.crypt_cfb128(aes.AES_ENCRYPT, 0, _u8(SP800_IV), _u8(SP800_PT))
    assert ct.tobytes().hex() == SP800_CFB128_AES128 and off == 0
    pt, _, _ = a.crypt_cfb128(aes.AES_DECRYPT, 0, _u8(SP800_IV), ct)
    assert pt.tobytes().hex() == SP800_PT


@pytest.mark.parametrize("engine", ["bitslice", "ttable", aes.CUDA_ENGINE])
def test_every_engine_name_runs_ecb_on_cpu(engine):
    """On CPU tensors the CUDA engine's wrappers take their plain version."""
    nr, rk = jks.expand_key_enc(_key(192))
    dk = jks.expand_key_dec(_key(192))[1]
    w = np.random.default_rng(9).integers(0, 2**32, (33, 4), dtype=np.uint64).astype(np.uint32)
    enc = aes.ecb_encrypt_words(_t(w.reshape(-1)), _t(rk), nr, engine)
    np.testing.assert_array_equal(
        _n(enc), np.asarray(jaes.ecb_encrypt_words(jnp.asarray(w.reshape(-1)), jnp.asarray(rk), nr)))
    dec = aes.ecb_decrypt_words(_t(w), _t(dk), nr, engine)
    np.testing.assert_array_equal(
        _n(dec), np.asarray(jaes.ecb_decrypt_words(jnp.asarray(w), jnp.asarray(dk), nr)))


def test_cbc_encrypt_words_batch_matches_reference():
    nr, rk = jks.expand_key_enc(_key(128))
    rng = np.random.default_rng(11)
    w = rng.integers(0, 2**32, (8, 5, 4), dtype=np.uint64).astype(np.uint32)
    iv = rng.integers(0, 2**32, (8, 4), dtype=np.uint64).astype(np.uint32)
    want = jaes.cbc_encrypt_words_batch(jnp.asarray(w), jnp.asarray(iv), jnp.asarray(rk), nr)
    got = aes.cbc_encrypt_words_batch(_t(w), _t(iv), _t(rk), nr)
    _same([_n(x) for x in got], want)
    # The flat (S, 4N) stream form gives the same words.
    flat = aes.cbc_encrypt_words_batch(_t(w.reshape(8, -1)), _t(iv), _t(rk), nr)
    np.testing.assert_array_equal(_n(flat[0]), np.asarray(want[0]).reshape(8, -1))


def test_word_level_modes_match_reference():
    nr, rk = jks.expand_key_enc(_key(256))
    dk = jks.expand_key_dec(_key(256))[1]
    rng = np.random.default_rng(12)
    w = rng.integers(0, 2**32, 4 * 40, dtype=np.uint64).astype(np.uint32)
    iv = rng.integers(0, 2**32, 4, dtype=np.uint64).astype(np.uint32)
    J = jnp.asarray
    _same([_n(x) for x in aes.cbc_encrypt_words(_t(w), _t(iv), _t(rk), nr)],
          jaes.cbc_encrypt_words(J(w), J(iv), J(rk), nr))
    _same([_n(x) for x in aes.cbc_decrypt_words(_t(w), _t(iv), _t(dk), nr)],
          jaes.cbc_decrypt_words(J(w), J(iv), J(dk), nr))
    _same([_n(x) for x in aes.cfb128_encrypt_words(_t(w), _t(iv), _t(rk), nr)],
          jaes.cfb128_encrypt_words(J(w), J(iv), J(rk), nr))
    _same([_n(x) for x in aes.cfb128_decrypt_words(_t(w), _t(iv), _t(rk), nr)],
          jaes.cfb128_decrypt_words(J(w), J(iv), J(rk), nr))
    empty = aes.cbc_decrypt_words(_t(w[:0]), _t(iv), _t(dk), nr)
    assert empty[0].numel() == 0 and _n(empty[1]).tolist() == iv.tolist()


def test_ctr_keystream_and_scattered_match_reference():
    nr, rk = jks.expand_key_enc(_key(128))
    rng = np.random.default_rng(13)
    ctr = packing.np_bytes_to_words(_u8("0001020304050607fffffffffffffffd")).byteswap()
    idx = np.arange(37, dtype=np.uint32)
    want = jaes.ctr_keystream_words(jnp.asarray(ctr), jnp.asarray(rk), nr, jnp.asarray(idx))
    got = aes.ctr_keystream_words(_t(ctr), _t(rk), nr, torch.from_numpy(idx.astype(np.int64)))
    np.testing.assert_array_equal(_n(got), np.asarray(want))
    data = rng.integers(0, 2**32, (37, 4), dtype=np.uint64).astype(np.uint32)
    ctrs = packing.np_ctr_le_blocks(bytes(_u8("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")), idx)
    want = jaes.ctr_crypt_words_scattered(jnp.asarray(data), jnp.asarray(ctrs), jnp.asarray(rk), nr)
    for d, c in ((data, ctrs), (data.reshape(-1), ctrs.reshape(-1))):
        got = aes.ctr_crypt_words_scattered(_t(d), _t(c), _t(rk), nr)
        np.testing.assert_array_equal(_n(got).reshape(-1), np.asarray(want).reshape(-1))
    # An engine without a fused CTR entry runs keystream then XOR.
    ttable = aes.ctr_crypt_words(_t(data), _t(ctr), _t(rk), nr, aes.TTABLE_ENGINE)
    np.testing.assert_array_equal(
        _n(ttable), np.asarray(jaes.ctr_crypt_words(jnp.asarray(data), jnp.asarray(ctr),
                                                    jnp.asarray(rk), nr)))


def test_aes_cipher_interface():
    key = _key(192)
    pt = _data(14, 64)
    c = base.AESCipher(key, device="cpu")
    assert (c.block_bits, c.block_size, c.key_bits, c.key_size) == (128, 16, 192, 24)
    ref = jbase.AESCipher(key, engine="jnp")
    np.testing.assert_array_equal(c.encrypt(pt), ref.encrypt(pt))
    np.testing.assert_array_equal(c.decrypt(c.encrypt(pt)), pt)
    enc_only = base.AESCipher(device="cpu")
    with pytest.raises(ValueError, match="no key"):
        enc_only.encrypt(pt)
    enc_only.make_key(key, base.DIR_ENCRYPT)
    np.testing.assert_array_equal(enc_only.encrypt(pt), ref.encrypt(pt))
    with pytest.raises(ValueError, match="direction"):
        enc_only.decrypt(pt)
    dec_only = base.AESCipher(device="cpu")
    dec_only.make_key(key, base.DIR_DECRYPT)
    with pytest.raises(ValueError, match="direction"):
        dec_only.encrypt(pt)
    assert base.DIR_BOTH == base.DIR_ENCRYPT | base.DIR_DECRYPT == jbase.DIR_BOTH


def test_bad_lengths_raise():
    a = aes.AES(bytes(16), device="cpu")
    with pytest.raises(ValueError, match="ECB"):
        a.crypt_ecb(aes.AES_ENCRYPT, bytes(17))
    with pytest.raises(ValueError, match="CBC"):
        a.crypt_cbc(aes.AES_DECRYPT, np.zeros(16, np.uint8), bytes(15))
    with pytest.raises(ValueError):
        aes.AES(bytes(15), device="cpu")
