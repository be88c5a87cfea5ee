"""The oracle-only engines of the port against the JAX package's on the CPU:
the T-table engine ``ttable`` (the reference's ``jnp``) through ``AES`` in
CTR, CBC and ECB, and the forward S-box forms ``tower`` and ``chain`` (the
bitsliced ``encrypt_words``'s ``sbox=`` and one ``encrypt_round``) against
the reference's ``encrypt_round(..., sbox=)`` and its cipher. ``auto`` never
picks them on a card: they are not in ``KERNEL_BACKED``
(tests/test_torch_ranking.py walks that rule)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from our_tree_tpu.models import aes as jaes
from our_tree_tpu.ops import bitslice as jbitslice
from our_tree_tpu.ops import keyschedule as jks
from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.ops import bitslice, block


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def _n(t):
    return t.numpy().view(np.uint32)


def test_oracle_engines_are_not_kernel_backed():
    assert aes.KERNEL_BACKED == {aes.CUDA_ENGINE}
    assert {aes.TTABLE_ENGINE, aes.PLAIN_ENGINE} <= set(aes.CORES)
    assert not {aes.TTABLE_ENGINE, aes.PLAIN_ENGINE} & aes.KERNEL_BACKED


@pytest.mark.parametrize("impl", ["tower", "chain", "bp"])
@pytest.mark.parametrize("bits", [128, 192, 256])
def test_sbox_forms_give_the_reference_cipher(impl, bits):
    rng = np.random.default_rng(bits + len(impl))
    key = rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes()
    nr, rk = jks.expand_key_enc(key)
    w = rng.integers(0, 2**32, (40, 4), dtype=np.uint64).astype(np.uint32)
    got = _n(bitslice.encrypt_words(_t(w), _t(rk), nr, sbox=impl))
    np.testing.assert_array_equal(got, np.asarray(jbitslice.encrypt_words(jnp.asarray(w),
                                                                          jnp.asarray(rk), nr)))
    np.testing.assert_array_equal(got, _n(block.encrypt_words(_t(w), _t(rk), nr)))
    # One round on the same planes, against the reference's round with the
    # same S-box form.
    planes = bitslice.to_planes(bitslice._pad32(_t(w))[0])
    kp = bitslice.key_planes(_t(rk), nr)[1]
    jplanes = jbitslice.to_planes(jnp.asarray(np.concatenate([w, np.zeros((24, 4), np.uint32)])))
    jkp = jbitslice.key_planes(jnp.asarray(rk), nr)[1]
    for last in (False, True):
        mine = bitslice.encrypt_round(planes, kp, last, sbox=impl)
        ref = jbitslice.encrypt_round(jplanes, jkp, last, sbox=impl)
        np.testing.assert_array_equal(_n(bitslice.from_planes(mine)),
                                      np.asarray(jbitslice.from_planes(ref)))


@pytest.mark.parametrize("bits", [128, 256])
def test_ttable_context_matches_the_reference_jnp_context(bits):
    rng = np.random.default_rng(bits)
    key = rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes()
    data = rng.integers(0, 256, 16 * 37, dtype=np.uint8)
    nonce, iv = rng.integers(0, 256, 16, dtype=np.uint8), rng.integers(0, 256, 16, dtype=np.uint8)
    mine = aes.AES(key, engine="ttable", device="cpu")
    ref = jaes.AES(key, engine="jnp")
    assert mine.engine == aes.TTABLE_ENGINE
    for got, want in (
            (mine.crypt_ctr(0, nonce.copy(), np.zeros(16, np.uint8), data),
             ref.crypt_ctr(0, nonce.copy(), np.zeros(16, np.uint8), data)),
            (mine.crypt_cbc(aes.AES_ENCRYPT, iv, data), ref.crypt_cbc(jaes.AES_ENCRYPT, iv, data)),
            (mine.crypt_cbc(aes.AES_DECRYPT, iv, data), ref.crypt_cbc(jaes.AES_DECRYPT, iv, data)),
            ((mine.crypt_ecb(aes.AES_DECRYPT, data),), (ref.crypt_ecb(jaes.AES_DECRYPT, data),))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
