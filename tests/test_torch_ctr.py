"""The port's CTR path (plain fused CTR, the model layer, the AES context)
held bit-exact against the JAX reference on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest

from our_tree_tpu.models import aes as jaes
from our_tree_tpu.ops import keyschedule as jks
from our_tree_tpu.utils import packing as jpacking
from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.ops import cuda_aes
from our_tree_tpu_torch.utils import packing

#: Counter starts whose additions carry across 32, 64 and 128 bits.
WRAP_NONCES = [
    "000102030405060708090a0bfffffffb",   # low word wraps after 5 blocks
    "0001020304050607fffffffffffffff9",   # 64-bit carry after 7 blocks
    "fffffffffffffffffffffffffffffff0",   # 128-bit wrap to zero after 16
    "ffffffffffffffffffffffffffffffff",   # wraps on the second block
]


def _t(w):
    return packing.words_tensor(np.asarray(w, dtype=np.uint32), "cpu")


def _ctr_be(hexnonce):
    return jpacking.np_bytes_to_words(
        np.frombuffer(bytes.fromhex(hexnonce), np.uint8)).byteswap()


def test_plain_fused_ctr_matches_pallas_dense_bp_interpret(monkeypatch):
    """Against the TPU kernel itself (interpret mode, one small tile)."""
    from our_tree_tpu.ops import pallas_aes

    monkeypatch.setattr(pallas_aes, "TILE", 128)
    nr, rk = jks.expand_key_enc(bytes(range(16)))
    ctr = _ctr_be("000102030405060708ffffffffffffff")
    w = np.random.default_rng(53).integers(0, 2**32, (33, 4), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(pallas_aes.ctr_crypt_words_dense_bp(
        jnp.asarray(w), jnp.asarray(ctr), jnp.asarray(rk), nr))
    got = cuda_aes.ctr_crypt_words_fused_plain(_t(w), _t(ctr), _t(rk), nr)
    np.testing.assert_array_equal(packing.words_numpy(got), want)


@pytest.mark.parametrize("bits", [128, 192, 256])
@pytest.mark.parametrize("hexnonce", WRAP_NONCES)
def test_plain_fused_ctr_matches_reference_across_wraps(bits, hexnonce):
    rng = np.random.default_rng(bits)
    key = rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes()
    nr, rk = jks.expand_key_enc(key)
    ctr = _ctr_be(hexnonce)
    w = rng.integers(0, 2**32, (4097, 4), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jaes.ctr_crypt_words(
        jnp.asarray(w), jnp.asarray(ctr), jnp.asarray(rk), nr, "jnp"))
    got = aes.ctr_crypt_words(_t(w), _t(ctr), _t(rk), nr)
    np.testing.assert_array_equal(packing.words_numpy(got), want)
    # The flat (4N,) stream form gives the same words.
    flat = aes.ctr_crypt_words(_t(w.reshape(-1)), _t(ctr), _t(rk), nr, "bitslice")
    np.testing.assert_array_equal(packing.words_numpy(flat), want.reshape(-1))


def test_ctr_le_blocks_matches_reference():
    idx = np.arange(40, dtype=np.uint32)
    for hexnonce in WRAP_NONCES:
        ctr = _ctr_be(hexnonce)
        want = np.asarray(jaes.ctr_le_blocks(jnp.asarray(ctr), jnp.asarray(idx)))
        got = aes.ctr_le_blocks(_t(ctr), packing.words_tensor(idx, "cpu").long())
        np.testing.assert_array_equal(packing.words_numpy(got), want)


def test_add_counter_be_carries_a_64_bit_index():
    """Block offsets past 2^32 (and the TPU kernel's 2^37) carry in full."""
    import torch

    ctr = _ctr_be("0001020304050607fffffff0ffffffff")
    idx = torch.tensor([0, 1, 2**32 + 1, 2**37 + 5, 2**62 + 3], dtype=torch.int64)
    got = packing.words_numpy(aes.add_counter_be(_t(ctr), idx))
    base = int.from_bytes(bytes.fromhex("0001020304050607fffffff0ffffffff"), "big")
    for row, i in zip(got, idx.tolist()):
        v = (base + i) % (1 << 128)
        assert [int(x) for x in row] == [(v >> (96 - 32 * k)) & 0xFFFFFFFF for k in range(4)]


def test_crypt_ctr_chunked_resume_matches_reference():
    key = bytes(range(100, 116))
    nonce = np.frombuffer(bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeef"), np.uint8)
    data = np.random.default_rng(9).integers(0, 256, 1 + 15 + 16 + 17 + 1_000_003,
                                             dtype=np.uint8)
    ours = aes.AES(key, device="cpu")
    ref = jaes.AES(key, engine="jnp")
    state_o = (0, nonce.copy(), np.zeros(16, np.uint8))
    state_r = (0, nonce.copy(), np.zeros(16, np.uint8))
    pos, outs = 0, []
    for size in (1, 15, 16, 17, 1_000_003):
        chunk = data[pos: pos + size]
        pos += size
        out_o, *state_o = ours.crypt_ctr(*state_o, chunk)
        out_r, *state_r = ref.crypt_ctr(*state_r, chunk)
        outs.append(out_o)
        np.testing.assert_array_equal(out_o, out_r)
        assert state_o[0] == state_r[0]
        np.testing.assert_array_equal(state_o[1], state_r[1])
        np.testing.assert_array_equal(state_o[2], state_r[2])
    one_shot = ours.crypt_ctr(0, nonce.copy(), np.zeros(16, np.uint8), data)[0]
    np.testing.assert_array_equal(np.concatenate(outs), one_shot)


def test_nist_sp800_38a_ctr_kat():
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    ctr0 = np.frombuffer(bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"), np.uint8)
    pt = bytes.fromhex(
        "6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
        "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
    ct = ("874d6191b620e3261bef6864990db6ce9806f66b7970fdff8617187bb9fffdff"
          "5ae4df3edbd5d35e5b4f09020db03eab1e031dda2fbe03d1792170a0f3009cee")
    out, n, _, _ = aes.AES(key, device="cpu").crypt_ctr(
        0, ctr0.copy(), np.zeros(16, np.uint8), pt)
    assert out.tobytes().hex() == ct and n == 0


def test_from_schedule_takes_reference_context_arrays():
    key = bytes(range(24))
    ref = jaes.AES(key, engine="jnp")
    ours = aes.AES.from_schedule(ref.nr, np.asarray(ref.rk_enc), np.asarray(ref.rk_dec),
                                 device="cpu")
    np.testing.assert_array_equal(packing.words_numpy(ours.rk_enc), np.asarray(ref.rk_enc))
    np.testing.assert_array_equal(packing.words_numpy(ours.rk_dec), np.asarray(ref.rk_dec))
    nonce = np.frombuffer(bytes.fromhex("00112233445566778899aabbccddeeff"), np.uint8)
    data = np.random.default_rng(4).integers(0, 256, 4099, dtype=np.uint8)
    got = ours.crypt_ctr(0, nonce.copy(), np.zeros(16, np.uint8), data)
    want = ref.crypt_ctr(0, nonce.copy(), np.zeros(16, np.uint8), data)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[3], want[3])
    iv = np.arange(16, dtype=np.uint8)
    np.testing.assert_array_equal(ours.crypt_ecb(0, data[:4096]), ref.crypt_ecb(0, data[:4096]))
    for got, want in zip(ours.crypt_cbc(0, iv, data[:4096]), ref.crypt_cbc(0, iv, data[:4096])):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(ours.crypt_cfb128(1, 3, iv, data[:99]), ref.crypt_cfb128(1, 3, iv, data[:99])):
        np.testing.assert_array_equal(got, want)
