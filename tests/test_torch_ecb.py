"""The port's plain ECB circuits (every S-box form, the inverse round, both
directions of the bitsliced and T-table engines) held bit-exact against the
JAX reference on the same numpy inputs, and against the TPU kernel
``_aes_kernel`` itself in interpret mode. Integer cryptography: the
tolerance is zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from our_tree_tpu.ops import bitslice as jbitslice
from our_tree_tpu.ops import block as jblock
from our_tree_tpu.ops import keyschedule as jks
from our_tree_tpu.ops import tables as jtables
from our_tree_tpu_torch.ops import bitslice, block, cuda_aes
from our_tree_tpu_torch.utils import packing


def _t(w):
    return packing.words_tensor(np.asarray(w, dtype=np.uint32), "cpu")


def _n(t):
    return packing.words_numpy(t)


def _all_bytes_planes():
    x = torch.arange(256, dtype=torch.int32)
    return [-((x >> b) & 1) for b in range(8)]


def _byte_values(planes):
    return sum((o & 1).to(torch.int64) << b for b, o in enumerate(planes)).numpy()


def _random_planes(seed, shape=(8, 16, 3)):
    return np.random.default_rng(seed).integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _keys(bits):
    key = np.random.default_rng(bits).integers(0, 256, bits // 8, dtype=np.uint8).tobytes()
    nr, rk = jks.expand_key_enc(key)
    return nr, rk, jks.expand_key_dec(key)[1]


@pytest.mark.parametrize("impl", ["tower", "bp", "chain"])
def test_sbox_forms_exhaustive(impl):
    out = bitslice.sbox_planes(_all_bytes_planes(), impl=impl)
    np.testing.assert_array_equal(_byte_values(out), jtables.SBOX)


def test_inv_sbox_exhaustive():
    out = bitslice.inv_sbox_planes(_all_bytes_planes())
    np.testing.assert_array_equal(_byte_values(out), jtables.INV_SBOX)


def test_unknown_sbox_form_raises():
    with pytest.raises(ValueError):
        bitslice.sbox_planes(_all_bytes_planes(), impl="table")


def test_derived_maps_match_reference():
    for name in ("MAT_SQ", "MAT_AFF", "MAT_AFF_INV", "REDUCE", "ISR_PERM", "TOWER_ISO",
                 "TOWER_ISO_INV", "M_SBOX_IN", "M_SBOX_OUT", "M_ISBOX_IN", "M_ISBOX_OUT",
                 "SUB_ISO", "SUB_ISO_INV", "MAT_DELTA8", "MAT_DELTA4", "MAT_SQ2",
                 "GF16_REDUCE"):
        np.testing.assert_array_equal(getattr(bitslice, name), getattr(jbitslice, name),
                                      err_msg=name)
    np.testing.assert_array_equal(bitslice.MAT_MUL[4], jbitslice.MAT_MUL[4])
    assert (bitslice.TOWER_LAMBDA, bitslice.SUB_LAMBDA) == (jbitslice.TOWER_LAMBDA,
                                                            jbitslice.SUB_LAMBDA)


def test_field_circuits_match_reference():
    p = _random_planes(5, (16, 7))
    a, b = [_t(x) for x in p[:8]], [_t(x) for x in p[8:]]
    ja, jb = [jnp.asarray(x) for x in p[:8]], [jnp.asarray(x) for x in p[8:]]
    for got, want in (
            (bitslice.gf_mul_planes(a, b), jbitslice.gf_mul_planes(ja, jb)),
            (bitslice.gf_inv_planes(a), jbitslice.gf_inv_planes(ja)),
            (bitslice.tower_inv_planes(a), jbitslice.tower_inv_planes(ja)),
            (bitslice.gf16_mul_planes(a[:4], b[:4]), jbitslice.gf16_mul_planes(ja[:4], jb[:4])),
            (bitslice.gf4_mul_planes(a[:2], b[:2]), jbitslice.gf4_mul_planes(ja[:2], jb[:2]))):
        np.testing.assert_array_equal(np.stack([_n(x) for x in got]),
                                      np.stack([np.asarray(x) for x in want]))


def test_inv_mixcolumns_matches_reference():
    p = _random_planes(6)
    got = bitslice.inv_mixcolumns_planes([_t(p[i]) for i in range(8)])
    want = jbitslice.inv_mixcolumns_planes([jnp.asarray(p[i]) for i in range(8)])
    np.testing.assert_array_equal(np.stack([_n(x) for x in got]),
                                  np.stack([np.asarray(x) for x in want]))


@pytest.mark.parametrize("last", [False, True])
def test_decrypt_round_matches_reference(last):
    rng = np.random.default_rng(7 + last)
    planes = _random_planes(8 + last)
    kp = (rng.integers(0, 2, (8, 16, 1)) * 0xFFFFFFFF).astype(np.uint32)
    got = bitslice.decrypt_round(_t(planes), _t(kp), last)
    want = jbitslice.decrypt_round(jnp.asarray(planes), jnp.asarray(kp), last)
    np.testing.assert_array_equal(_n(got), np.asarray(want))


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_decrypt_words_matches_reference(bits):
    nr, _, dk = _keys(bits)
    w = _random_planes(bits, (77, 4))
    want = np.asarray(jblock.decrypt_words(jnp.asarray(w), jnp.asarray(dk), nr))
    np.testing.assert_array_equal(_n(bitslice.decrypt_words(_t(w), _t(dk), nr)), want)
    np.testing.assert_array_equal(
        want, np.asarray(jbitslice.decrypt_words(jnp.asarray(w), jnp.asarray(dk), nr)))


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_ttable_engine_matches_reference(bits):
    nr, rk, dk = _keys(bits)
    w = _random_planes(bits + 1, (45, 4))
    for got, want in (
            (block.encrypt_words(_t(w), _t(rk), nr),
             jblock.encrypt_words(jnp.asarray(w), jnp.asarray(rk), nr)),
            (block.decrypt_words(_t(w), _t(dk), nr),
             jblock.decrypt_words(jnp.asarray(w), jnp.asarray(dk), nr)),
            (block.encrypt_block_fused(_t(w[0]), _t(rk), nr),
             jblock.encrypt_block_fused(jnp.asarray(w[0]), jnp.asarray(rk), nr))):
        np.testing.assert_array_equal(_n(got), np.asarray(want))
    # The tower forward S-box gives the same cipher as the kernels' bp.
    np.testing.assert_array_equal(_n(bitslice.encrypt_words(_t(w), _t(rk), nr, sbox="tower")),
                                  _n(block.encrypt_words(_t(w), _t(rk), nr)))


def test_plain_ecb_matches_pallas_kernel_interpret(monkeypatch):
    """Against ``_aes_kernel`` itself (interpret mode, one small tile), in
    both directions: the dense layout with the bp S-box and the decrypt."""
    from our_tree_tpu.ops import pallas_aes

    monkeypatch.setattr(pallas_aes, "TILE", 128)
    nr, rk, dk = _keys(128)
    w = _random_planes(33, (33, 4))
    enc = np.asarray(pallas_aes.encrypt_words_dense_bp(jnp.asarray(w), jnp.asarray(rk), nr))
    dec = np.asarray(pallas_aes.decrypt_words_dense(jnp.asarray(w), jnp.asarray(dk), nr))
    np.testing.assert_array_equal(_n(bitslice.encrypt_words(_t(w), _t(rk), nr)), enc)
    np.testing.assert_array_equal(_n(bitslice.decrypt_words(_t(w), _t(dk), nr)), dec)


@pytest.mark.parametrize("form", cuda_aes.ECB_FORMS)
def test_encrypt_words_takes_a_form_and_runs_plain_on_cpu(form):
    """Every form of the ECB encrypt wrapper gives the plain version's words
    on the CPU, counting no launch; the form is checked before anything
    runs."""
    nr, rk = jks.expand_key_enc(bytes(range(16)))
    w = np.random.default_rng(5).integers(0, 2**32, (33, 4), dtype=np.uint64).astype(np.uint32)
    before = dict(cuda_aes.encrypt_words.form_launches)
    got = cuda_aes.encrypt_words(_t(w), _t(rk), nr, form=form)
    np.testing.assert_array_equal(_n(got), np.asarray(jbitslice.encrypt_words(
        jnp.asarray(w), jnp.asarray(np.asarray(rk, np.uint32)), nr)))
    assert cuda_aes.encrypt_words.form_launches == before


def test_encrypt_words_refuses_an_unknown_form():
    nr, rk = jks.expand_key_enc(bytes(16))
    with pytest.raises(ValueError, match="form"):
        cuda_aes.encrypt_words(_t(np.zeros((1, 4), np.uint32)), _t(rk), nr, form="tile")
