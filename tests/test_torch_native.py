"""The port's native C tier (``our_tree_tpu_torch.runtime.native``), built
from the port's own copy of the C sources, held against the port's
``AES``/``ARC4`` on the CPU, against the JAX package's native tier, and,
through ``ctr_scattered_words``/``ctr_requests_words``, against the port's
multi-key scattered-CTR seam. Integer cryptography: the tolerance is zero."""

import ctypes

import numpy as np
import pytest
import torch

from our_tree_tpu.runtime import native as jnative
from our_tree_tpu_torch.models import aes, arc4
from our_tree_tpu_torch.ops.keyschedule import expand_key_enc
from our_tree_tpu_torch.resilience import faults
from our_tree_tpu_torch.runtime import native
from our_tree_tpu_torch.utils import packing

RNG = np.random.default_rng(17)
KEY = {bits: RNG.integers(0, 256, bits // 8, np.uint8).tobytes() for bits in (128, 192, 256)}
MSG = RNG.integers(0, 256, 16 * 67, np.uint8)
ODD = RNG.integers(0, 256, 2_003, np.uint8)
IV = RNG.integers(0, 256, 16, np.uint8)


def test_own_build_into_a_fresh_directory(tmp_path, monkeypatch):
    """The library builds from the port's sources into the given directory,
    and the build_fail injection point fails the first attempt only."""
    monkeypatch.setenv("OT_FAULTS", "build_fail:1")
    faults.reset()
    try:
        lib = native.load(build_dir=tmp_path)
    finally:
        monkeypatch.delenv("OT_FAULTS")
        faults.reset()
    built = list(tmp_path.glob("libotcrypt_*.so"))
    assert [p.name for p in built] == [native.library_path(tmp_path).name]
    assert native.CSRC.parent.name == "runtime" and native.CSRC.parent.parent.name == (
        "our_tree_tpu_torch")
    assert lib.ot_aesni_available() in (0, 1)
    ctx = native.AesCtx()
    assert lib.ot_aes_setkey(ctypes.byref(ctx), np.frombuffer(KEY[128], np.uint8), 128) == 0
    assert ctx.nr == 10


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_block_modes_match_port_and_reference(bits):
    # The port's T-table engine: its chained encrypts run as a host loop.
    nat, port, ref = (native.NativeAES(KEY[bits]),
                      aes.AES(KEY[bits], device="cpu", engine="ttable"),
                      jnative.NativeAES(KEY[bits]))
    ct = nat.ecb(MSG, nthreads=3)
    np.testing.assert_array_equal(ct, port.crypt_ecb(aes.AES_ENCRYPT, MSG))
    np.testing.assert_array_equal(ct, ref.ecb(MSG))
    np.testing.assert_array_equal(nat.ecb(ct, encrypt=False, nthreads=2), MSG)
    for enc in (True, False):
        got, got_iv = nat.cbc(IV, MSG, encrypt=enc, nthreads=2)
        want, want_iv = port.crypt_cbc(aes.AES_ENCRYPT if enc else aes.AES_DECRYPT, IV, MSG)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_iv, want_iv)
        np.testing.assert_array_equal(got, ref.cbc(IV, MSG, encrypt=enc)[0])
        out, off, iv2 = nat.cfb128(3, IV, ODD, encrypt=enc)
        want, woff, wiv = port.crypt_cfb128(aes.AES_ENCRYPT if enc else aes.AES_DECRYPT, 3,
                                            IV, ODD)
        np.testing.assert_array_equal(out, want)
        assert off == woff
        np.testing.assert_array_equal(iv2, wiv)
    for t in (1, 3):
        out, nonce = nat.ctr(IV, ODD, nthreads=t)
        want, _, wnonce, _ = port.crypt_ctr(0, IV.copy(), np.zeros(16, np.uint8), ODD)
        np.testing.assert_array_equal(out, want)
        ref_out, ref_nonce = ref.ctr(IV, ODD)
        np.testing.assert_array_equal(out, ref_out)
        np.testing.assert_array_equal(nonce, ref_nonce)
        # The context's counter stays one ahead of the partial block in use.
        np.testing.assert_array_equal(nonce, wnonce)
    with pytest.raises(ValueError):
        native.NativeAES(bytes(5))


def test_arc4_matches_port_and_reference():
    for key in (b"Key", bytes(range(16)), b"\x00" * 13):
        got = native.NativeARC4(key)
        parts = np.concatenate([got.prep(n) for n in (1, 15, 4080)])
        np.testing.assert_array_equal(parts, arc4.ARC4(key, device="cpu").prep(4096))
        np.testing.assert_array_equal(parts, jnative.NativeARC4(key).prep(4096))
        data = RNG.integers(0, 256, 4096, np.uint8)
        np.testing.assert_array_equal(got.crypt(data, parts, nthreads=3), data ^ parts)
    with pytest.raises(ValueError):
        native.NativeARC4(b"")
    with pytest.raises(ValueError):
        native.xor_parallel(np.zeros(4, np.uint8), np.zeros(3, np.uint8))


def test_c_backend_protocol():
    be = native.CBackend()
    ctx = be.make_key(KEY[256])
    w = be.stage_words(MSG)
    np.testing.assert_array_equal(be.block_until_ready(be.ecb_dec(ctx, be.ecb(ctx, w, 2), 1)),
                                  MSG)
    np.testing.assert_array_equal(be.cbc_dec(ctx, be.cbc(ctx, w, be.iv_words(IV), 1),
                                             be.iv_words(IV), 2), MSG)
    np.testing.assert_array_equal(be.ctr(ctx, be.ctr(ctx, w, be.ctr_be_words(IV), 1),
                                         be.ctr_be_words(IV), 3), MSG)
    with pytest.raises(ValueError):
        be.cbc(ctx, w, IV, 2)
    with pytest.raises(ValueError):
        be.cfb128(ctx, w, IV, 2)
    ks = be.arc4_setup_prep(b"Key", MSG.size)
    np.testing.assert_array_equal(be.arc4_crypt(be.to_device(MSG), ks, 2), MSG ^ ks)


def _slot_case(k, n, seed):
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, 256, 16, np.uint8).tobytes() for _ in range(k)]
    rks = np.stack([expand_key_enc(key)[1] for key in keys])
    runs = np.repeat(rng.integers(0, k, n // 4 + 1), 4)[:n].astype(np.int32)
    words = rng.integers(0, 2**32, 4 * n, dtype=np.uint64).astype(np.uint32)
    ctrs = rng.integers(0, 2**32, 4 * n, dtype=np.uint64).astype(np.uint32)
    return rks, runs, words, ctrs


@pytest.mark.parametrize("k", [1, 3])
def test_scattered_words_match_multikey_seam(k):
    n = 41
    rks, slots, words, ctrs = _slot_case(k, n, seed=k)
    ctxs = [native.aes_ctx_from_schedule(10, r) for r in rks]
    got = native.ctr_scattered_words(ctxs, words, ctrs, slots if k > 1 else None, nthreads=2)
    want = aes.ctr_crypt_words_scattered_multikey(
        packing.words_tensor(words, "cpu"), packing.words_tensor(ctrs, "cpu"),
        packing.words_tensor(rks, "cpu"), torch.from_numpy(slots if k > 1 else slots * 0), 10,
        engine="bitslice")
    np.testing.assert_array_equal(got, packing.words_numpy(want))
    # The context primed from the schedule equals setkey's.
    ref = jnative.aes_ctx_from_schedule(10, rks[0])
    assert bytes(ctxs[0].rk) == bytes(ref.rk)
    with pytest.raises(ValueError):
        native.ctr_scattered_words(ctxs, words, ctrs[:-4])
    with pytest.raises(ValueError):
        native.aes_ctx_from_schedule(16, rks[0])


def test_requests_words_match_multikey_seam():
    """Per-request CTR with the counters kept in C: three requests on two
    slots, the uncovered tail zeroed, equal to the seam over the same
    counters."""
    rks, _, words, _ = _slot_case(2, 24, seed=9)
    ctxs = [native.aes_ctx_from_schedule(10, r) for r in rks]
    nonces = [RNG.integers(0, 256, 16, np.uint8).tobytes() for _ in range(3)]
    nonces[2] = bytes.fromhex("ffffffffffffffffffffffffffffffff")  # wraps mid-request
    runs = [(1, 0, 5, nonces[0]), (0, 5, 11, nonces[1]), (1, 16, 6, nonces[2])]
    got = native.ctr_requests_words(ctxs, words, runs, nthreads=2)
    ctr = np.zeros((24, 4), np.uint32)
    slots = np.zeros(24, np.int32)
    for slot, start, nb, nonce in runs:
        ctr[start:start + nb] = packing.np_ctr_le_blocks(nonce, np.arange(nb))
        slots[start:start + nb] = slot
    want = packing.words_numpy(aes.ctr_crypt_words_scattered_multikey(
        packing.words_tensor(words, "cpu"), packing.words_tensor(ctr.reshape(-1), "cpu"),
        packing.words_tensor(rks, "cpu"), torch.from_numpy(slots), 10, engine="bitslice"))
    np.testing.assert_array_equal(got[:88], want[:88])
    assert not got[88:].any()  # blocks 22, 23: no run covers them
    np.testing.assert_array_equal(got, jnative.ctr_requests_words(
        [jnative.aes_ctx_from_schedule(10, r) for r in rks], words, runs))
    with pytest.raises(ValueError):
        native.ctr_requests_words(ctxs, words, [(0, 20, 5, nonces[0])])
    with pytest.raises(ValueError):
        native.ctr_requests_words(ctxs, words, [(2, 0, 1, nonces[0])])
