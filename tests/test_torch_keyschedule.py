"""The port's device key schedules (``ops.keyschedule.expand_key_enc_device``
and ``expand_key_dec_device``) against the JAX package's on the CPU, for
128-, 192- and 256-bit keys: the FIPS-197 keys and 50 random ones from a
seed, one key at a time and as one batch, and equal to the host
schedules."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from our_tree_tpu.ops import keyschedule as jks
from our_tree_tpu_torch.ops import keyschedule as ks
from our_tree_tpu_torch.utils import packing

#: FIPS-197 appendix A (key expansion) and C (example vectors) keys.
FIPS_KEYS = {
    128: ["2b7e151628aed2a6abf7158809cf4f3c", "000102030405060708090a0b0c0d0e0f"],
    192: ["8e73b0f7da0e6452c810f32b809079e562f8ead2522c6b7b",
          "000102030405060708090a0b0c0d0e0f1011121314151617"],
    256: ["603deb1015ca71be2b73aef0857d77811f352c073b6108d72d9810a30914dff4",
          "000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f"],
}


def _keys(bits):
    rng = np.random.default_rng(bits)
    return [bytes.fromhex(k) for k in FIPS_KEYS[bits]] + [
        rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes() for _ in range(50)]


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_device_schedules_match_the_jax_package(bits):
    keys = _keys(bits)
    words = np.stack([packing.np_bytes_to_words(np.frombuffer(k, np.uint8)) for k in keys])
    batch = torch.from_numpy(words.view(np.int32))
    nr, enc = ks.expand_key_enc_device(batch, bits)
    nr_d, dec = ks.expand_key_dec_device(batch, bits)
    assert nr == nr_d == ks.ROUNDS[bits]
    assert enc.dtype == dec.dtype == torch.int32 and enc.shape == (len(keys), 4 * (nr + 1))
    assert jks.expand_key_enc_device(jnp.asarray(words[0]), bits)[0] == nr
    jenc = jax.vmap(lambda k: jks.expand_key_enc_device(k, bits)[1])(jnp.asarray(words))
    jdec = jax.vmap(lambda k: jks.expand_key_dec_device(k, bits)[1])(jnp.asarray(words))
    np.testing.assert_array_equal(enc.numpy().view(np.uint32), np.asarray(jenc))
    np.testing.assert_array_equal(dec.numpy().view(np.uint32), np.asarray(jdec))
    for i, key in enumerate(keys):
        np.testing.assert_array_equal(enc[i].numpy().view(np.uint32), ks.expand_key_enc(key)[1])
        np.testing.assert_array_equal(dec[i].numpy().view(np.uint32), ks.expand_key_dec(key)[1])
    # One key at a time: the flat schedule.
    _, one = ks.expand_key_enc_device(batch[0], bits)
    assert torch.equal(one, enc[0])


def test_device_schedule_refuses_a_wrong_key_size():
    with pytest.raises(ValueError, match="128/192/256"):
        ks.expand_key_enc_device(torch.zeros(5, dtype=torch.int32), 160)
    with pytest.raises(ValueError, match="4 words"):
        ks.expand_key_enc_device(torch.zeros(6, dtype=torch.int32), 128)
