"""The PyTorch port's host modules and plain bitsliced circuit, held
bit-exact against the JAX reference (our_tree_tpu) on the same numpy
inputs. Integer cryptography: the tolerance is zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from our_tree_tpu.ops import bitslice as jbitslice
from our_tree_tpu.ops import block as jblock
from our_tree_tpu.ops import gf as jgf
from our_tree_tpu.ops import keyschedule as jks
from our_tree_tpu.ops import tables as jtables
from our_tree_tpu.utils import packing as jpacking
from our_tree_tpu_torch.ops import bitslice, gf, keyschedule, tables
from our_tree_tpu_torch.utils import packing


def _t(w):
    return packing.words_tensor(np.asarray(w, dtype=np.uint32), "cpu")


def _n(t):
    return packing.words_numpy(t)


def test_packing_round_trips():
    rng = np.random.default_rng(0)
    b = rng.integers(0, 256, 4 * 37, dtype=np.uint8)
    w = packing.np_bytes_to_words(b)
    np.testing.assert_array_equal(w, jpacking.np_bytes_to_words(b))
    np.testing.assert_array_equal(packing.np_words_to_bytes(w), b)
    np.testing.assert_array_equal(_n(_t(w)), w)
    np.testing.assert_array_equal(
        _n(packing.byteswap32(_t(w))), np.asarray(jpacking.byteswap32(jnp.asarray(w))))
    np.testing.assert_array_equal(_n(packing.byteswap32(packing.byteswap32(_t(w)))), w)
    with pytest.raises(ValueError):
        packing.np_bytes_to_words(b[:5])


def test_np_ctr_le_blocks_matches_reference_across_carries():
    idx = np.arange(300, dtype=np.uint32)
    for hexn in ("000102030405060708090a0bffffff00",
                 "0001020304050607ffffffffffffff00",
                 "ffffffffffffffffffffffffffffff00"):
        nonce = bytes.fromhex(hexn)
        np.testing.assert_array_equal(packing.np_ctr_le_blocks(nonce, idx),
                                      jpacking.np_ctr_le_blocks(nonce, idx))


def test_gf_and_tables_match_reference():
    for a in range(256):
        assert gf.xtime(a) == jgf.xtime(a)
        assert gf.ginv(a) == jgf.ginv(a)
        assert gf.gmul(a, 0x57) == jgf.gmul(a, 0x57)
        assert gf.gpow(a, 7) == jgf.gpow(a, 7)
    np.testing.assert_array_equal(tables.SBOX, jtables.SBOX)
    np.testing.assert_array_equal(tables.INV_SBOX, jtables.INV_SBOX)
    np.testing.assert_array_equal(tables.RCON, jtables.RCON)
    w = np.random.default_rng(1).integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(tables.inv_mix_columns_word(w),
                                  jtables.inv_mix_columns_word(w))


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_key_schedules_match_reference(bits):
    key = np.random.default_rng(bits).integers(0, 256, bits // 8, dtype=np.uint8).tobytes()
    nr, enc = keyschedule.expand_key_enc(key)
    jnr, jenc = jks.expand_key_enc(key)
    assert nr == jnr
    np.testing.assert_array_equal(enc, jenc)
    np.testing.assert_array_equal(keyschedule.expand_key_dec(key)[1],
                                  jks.expand_key_dec(key)[1])
    np.testing.assert_array_equal(keyschedule.dec_schedule_from_enc(nr, enc),
                                  jks.dec_schedule_from_enc(nr, jenc))


def test_bp_sbox_exhaustive():
    x = torch.arange(256, dtype=torch.int32)
    planes = [-((x >> b) & 1) for b in range(8)]
    out = bitslice.sbox_planes(planes, impl="bp")
    val = sum((o & 1).to(torch.int64) << b for b, o in enumerate(out))
    np.testing.assert_array_equal(val.numpy(), jtables.SBOX)
    with pytest.raises(ValueError):
        bitslice.sbox_planes(planes, impl="table")


def test_linear_maps_and_permutations_match_reference():
    np.testing.assert_array_equal(bitslice.MAT_MUL[2], jbitslice.MAT_MUL[2])
    np.testing.assert_array_equal(bitslice.SR_PERM, jbitslice.SR_PERM)
    for k in range(4):
        np.testing.assert_array_equal(bitslice.ROT_PERM[k], jbitslice.ROT_PERM[k])


def test_planes_match_reference():
    w = np.random.default_rng(2).integers(0, 2**32, (96, 4), dtype=np.uint64).astype(np.uint32)
    p = bitslice.to_planes(_t(w))
    np.testing.assert_array_equal(_n(p), np.asarray(jbitslice.to_planes(jnp.asarray(w))))
    np.testing.assert_array_equal(_n(bitslice.from_planes(p)), w)
    nr, rk = jks.expand_key_enc(bytes(range(32)))
    np.testing.assert_array_equal(_n(bitslice.key_planes(_t(rk), nr)),
                                  np.asarray(jbitslice.key_planes(jnp.asarray(rk), nr)))


@pytest.mark.parametrize("last", [False, True])
def test_encrypt_round_matches_reference(last):
    rng = np.random.default_rng(3 + last)
    planes = rng.integers(0, 2**32, (8, 16, 3), dtype=np.uint64).astype(np.uint32)
    kp = (rng.integers(0, 2, (8, 16, 1)) * 0xFFFFFFFF).astype(np.uint32)
    got = bitslice.encrypt_round(_t(planes), _t(kp), last, sbox="bp")
    want = jbitslice.encrypt_round(jnp.asarray(planes), jnp.asarray(kp), last, sbox="bp")
    np.testing.assert_array_equal(_n(got), np.asarray(want))


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_encrypt_words_matches_reference(bits):
    rng = np.random.default_rng(10 + bits)
    key = rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes()
    nr, rk = jks.expand_key_enc(key)
    w = rng.integers(0, 2**32, (77, 4), dtype=np.uint64).astype(np.uint32)
    got = _n(bitslice.encrypt_words(_t(w), _t(rk), nr))
    np.testing.assert_array_equal(
        got, np.asarray(jbitslice.encrypt_words(jnp.asarray(w), jnp.asarray(rk), nr)))
    np.testing.assert_array_equal(
        got, np.asarray(jblock.encrypt_words(jnp.asarray(w), jnp.asarray(rk), nr)))
