"""The multi-key scattered-CTR wrappers (``ops/cuda_aes.py``:
``ctr_scattered_multikey``, ``ctr_crypt_words_explicit``) and the port's
multi-key serve seam (``models.aes.ctr_crypt_words_scattered_multikey``)
held bit-exact against the JAX reference on the same numpy inputs: the TPU
kernels ``_ctr_scat_mk_kernel`` and ``_ctr_kernel`` themselves in interpret
mode at small sizes, the reference's ``jnp`` multi-key core at 1,000
blocks, and the NIST SP800-38A F.5.1 KAT in slot 3 of 8. Integer
cryptography: the tolerance is zero."""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from our_tree_tpu.models import aes as jaes
from our_tree_tpu.ops import keyschedule as jks
from our_tree_tpu.ops import pallas_aes
from our_tree_tpu.utils import packing as jpacking
from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.ops import cuda_aes
from our_tree_tpu_torch.utils import packing

NIST_KEY = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
NIST_CTR0 = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
NIST_PT = bytes.fromhex("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
                        "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
NIST_CT = bytes.fromhex("874d6191b620e3261bef6864990db6ce9806f66b7970fdff8617187bb9fffdff"
                        "5ae4df3edbd5d35e5b4f09020db03eab1e031dda2fbe03d1792170a0f3009cee")


def _t(w):
    return packing.words_tensor(np.asarray(w, dtype=np.uint32), "cpu")


def _n(t):
    return packing.words_numpy(t)


def _stack(keys):
    """(nr, (K, 4*(nr+1)) uint32 schedules); None entries are zero rows."""
    nr = next(jks.expand_key_enc(k)[0] for k in keys if k is not None)
    rows = [np.zeros(4 * (nr + 1), np.uint32) if k is None
            else np.asarray(jks.expand_key_enc(k)[1], np.uint32) for k in keys]
    return nr, np.stack(rows)


def _counters(slots, seed):
    """(N, 4) LE counter words: each slot's blocks count up from its own
    nonce, in order (the batcher's layout)."""
    rng = np.random.default_rng(seed)
    ctr = np.empty((slots.size, 4), np.uint32)
    for s in np.unique(slots):
        mine = np.flatnonzero(slots == s)
        nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        ctr[mine] = jpacking.np_ctr_le_blocks(nonce, np.arange(mine.size, dtype=np.uint32))
    return ctr


def _runs(n, k, seed, longest=300):
    rng = np.random.default_rng(seed)
    slots, pos = np.zeros(n, np.int32), 0
    while pos < n:
        length = int(rng.integers(1, longest + 1))
        slots[pos: pos + length] = rng.integers(k)
        pos += length
    return slots


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, (n, 4), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("nr_bits", [128, 192, 256])
@pytest.mark.parametrize("jax_fn", [pallas_aes.ctr_scattered_multikey_dense,
                                    pallas_aes.ctr_scattered_multikey_dense_bp])
def test_plain_matches_pallas_multikey_kernel_interpret(nr_bits, jax_fn):
    """K = 3 interleaved tenants over 34 blocks (one 32-block lane group
    plus a padded one) through ``_ctr_scat_mk_kernel`` in interpret mode."""
    keys = [bytes([i]) * (nr_bits // 8) for i in (1, 2, 3)]
    nr, rks = _stack(keys)
    slots = np.asarray([0, 1, 0, 2, 2, 0, 1, 0, 2, 1, 0] * 3 + [2], np.int32)
    ctr, words = _counters(slots, nr_bits), _words(slots.size, nr_bits)
    want = np.asarray(jax_fn(jnp.asarray(words), jnp.asarray(ctr), jnp.asarray(rks),
                             jnp.asarray(slots.astype(np.uint32)), nr))
    got = cuda_aes.ctr_scattered_multikey(_t(words), _t(ctr), _t(rks), torch.from_numpy(slots), nr)
    np.testing.assert_array_equal(_n(got), want)


@pytest.mark.parametrize("nonce_hex", ["000102030405060708090a0bfffffffb",
                                       "0001020304050607fffffffffffffff9"])
def test_explicit_matches_pallas_ctr_kernel_interpret(nonce_hex):
    """``ctr_crypt_words_explicit`` against ``pallas_aes.ctr_crypt_words``
    (``_ctr_kernel``, interpret mode) at 40 blocks across a 32- and a 64-bit
    counter carry."""
    nr, rk = jks.expand_key_enc(bytes(range(23, 39)))
    ctr = jpacking.np_ctr_le_blocks(bytes.fromhex(nonce_hex), np.arange(40, dtype=np.uint32))
    words = _words(40, 3)
    want = np.asarray(pallas_aes.ctr_crypt_words(jnp.asarray(words), jnp.asarray(ctr),
                                                 jnp.asarray(rk), nr))
    got = cuda_aes.ctr_crypt_words_explicit(_t(words), _t(ctr), _t(rk), nr)
    np.testing.assert_array_equal(_n(got), want)


@pytest.mark.parametrize("bits", [128, 192, 256])
def test_plain_matches_jnp_multikey_core(bits):
    """1,000 blocks, K = 8 (two zero slots), runs of 1-300 blocks, against
    the reference's T-table multi-key core."""
    rng = np.random.default_rng(bits)
    keys = [rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes() for _ in range(6)]
    nr, rks = _stack(keys + [None, None])
    slots = _runs(1000, 6, seed=bits)
    ctr, words = _counters(slots, bits + 1), _words(1000, bits + 2)
    want = np.asarray(jaes.ctr_crypt_words_scattered_multikey(
        words.reshape(-1), ctr.reshape(-1), rks, slots.astype(np.uint32), nr, "jnp"))
    got = cuda_aes.ctr_scattered_multikey(_t(words), _t(ctr), _t(rks), torch.from_numpy(slots), nr)
    np.testing.assert_array_equal(_n(got).reshape(-1), want)


@pytest.mark.parametrize("engine", sorted(aes.MULTIKEY_CTR))
def test_every_engine_matches_reference_entry(engine):
    """The port's serve seam for each registered engine against the JAX
    entry, flat (4N,) words in and out as the batcher hands them."""
    rng = np.random.default_rng(5)
    keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(5)]
    nr, rks = _stack(keys + [None] * 3)
    slots = _runs(200, 5, seed=6, longest=40)
    ctr, words = _counters(slots, 7).reshape(-1), _words(200, 8).reshape(-1)
    want = np.asarray(jaes.ctr_crypt_words_scattered_multikey(
        words, ctr, rks, slots.astype(np.uint32), nr, "jnp"))
    got = aes.ctr_crypt_words_scattered_multikey(_t(words), _t(ctr), _t(rks),
                                                 torch.from_numpy(slots), nr, engine)
    assert got.shape == (800,)
    np.testing.assert_array_equal(_n(got), want)


@pytest.mark.parametrize("engine", sorted(aes.MULTIKEY_CTR))
def test_nist_kat_in_slot_3_of_8(engine):
    """F.5.1 CTR-AES128 riding slot 3 of a K = 8 stack, other tenants'
    blocks interleaved around it and slots 6-7 empty."""
    rng = np.random.default_rng(29)
    others = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(5)]
    nr, rks = _stack(others[:3] + [NIST_KEY] + others[3:] + [None, None])
    slots = np.array([3, 0, 1, 3, 4, 3, 5, 2, 3, 0], np.int32)
    ctr = _counters(slots, 30)
    ctr[slots == 3] = packing.np_ctr_le_blocks(NIST_CTR0, np.arange(4))
    data = np.random.default_rng(31).integers(0, 256, (10, 16), dtype=np.uint8)
    data[slots == 3] = np.frombuffer(NIST_PT, np.uint8).reshape(4, 16)
    got = aes.ctr_crypt_words_scattered_multikey(
        _t(packing.np_bytes_to_words(data.reshape(-1))), _t(ctr.reshape(-1)), _t(rks),
        torch.from_numpy(slots), nr, engine)
    got_b = packing.np_words_to_bytes(_n(got)).reshape(10, 16)
    assert got_b[slots == 3].tobytes() == NIST_CT
    for s in (0, 1, 2, 4, 5):
        ctx = aes.AES(others[s if s < 3 else s - 1], engine="ttable", device="cpu")
        blocks = data[slots == s].reshape(-1)
        nonce = packing.np_words_to_bytes(ctr[slots == s][0])
        want = ctx.crypt_ctr(0, nonce.copy(), np.zeros(16, np.uint8), blocks)[0]
        assert got_b[slots == s].tobytes() == want.tobytes()


@pytest.mark.parametrize("engine", sorted(aes.CORES))
def test_scattered_ctr_every_engine_matches_reference(engine):
    """``aes.ctr_crypt_words_scattered`` per engine against the JAX entry:
    the explicit-counter CTR entry where the engine has one (on the card
    the ``ctr_mk`` kernel with one schedule), ECB of the counters then XOR
    where it does not."""
    nr, rk = jks.expand_key_enc(bytes(range(40, 72)))
    ctr = jpacking.np_ctr_le_blocks(bytes.fromhex("0001020304050607fffffffffffffffd"),
                                    np.arange(45, dtype=np.uint32))
    words = _words(45, 9)
    want = np.asarray(jaes.ctr_crypt_words_scattered(jnp.asarray(words), jnp.asarray(ctr),
                                                     jnp.asarray(rk), nr))
    assert (engine in aes.CTR_EXPLICIT) == (engine != aes.TTABLE_ENGINE)
    got = aes.ctr_crypt_words_scattered(_t(words), _t(ctr), _t(rk), nr, engine)
    np.testing.assert_array_equal(_n(got), want)


def test_explicit_equals_single_slot_multikey():
    nr, rks = _stack([bytes(range(16))])
    ctr, words = _words(77, 1), _words(77, 2)
    a = cuda_aes.ctr_crypt_words_explicit(_t(words), _t(ctr), _t(rks[0]), nr)
    b = cuda_aes.ctr_scattered_multikey(_t(words), _t(ctr), _t(rks),
                                        torch.zeros(77, dtype=torch.int32), nr)
    assert torch.equal(a, b)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    nr, rks = _stack([bytes(16)] * 3)
    w, c = _t(_words(8, 1)), _t(_words(8, 2))
    r = _t(rks)
    s = torch.zeros(8, dtype=torch.int32)
    f = cuda_aes.ctr_scattered_multikey
    with pytest.raises(ValueError, match="1..64"):
        f(w, c, r[:0], s, nr)
    with pytest.raises(ValueError, match="1..64"):
        f(w, c, r[[0] * 65], s, nr)
    assert f(w, c, r[[0] * 64], s, nr).shape == (8, 4)
    with pytest.raises(ValueError, match=r"\[0, 3\)"):
        f(w, c, r, torch.full((8,), 3, dtype=torch.int32), nr)
    with pytest.raises(ValueError, match=r"\[0, 3\)"):
        f(w, c, r, torch.full((8,), -1, dtype=torch.int32), nr)
    with pytest.raises(TypeError):
        f(w, c, r, s.long(), nr)
    with pytest.raises(TypeError):
        f(w.long(), c, r, s, nr)
    with pytest.raises(ValueError):
        f(w, c[:7], r, s, nr)
    with pytest.raises(ValueError):
        f(w, c, r, s[:7], nr)
    with pytest.raises(ValueError):
        f(w, c, r[:, :40], s, nr)
    with pytest.raises(ValueError):
        f(w, c, r, s, 12)
    with pytest.raises(ValueError):
        f(w.t().contiguous().t(), c, r, s, nr)
    with pytest.raises(ValueError):
        cuda_aes.ctr_crypt_words_explicit(w, c, r, nr)
    with pytest.raises(TypeError):
        cuda_aes.ctr_crypt_words_explicit(w, c.long(), r[0], nr)
    empty = f(w[:0], c[:0], r, s[:0], nr)
    assert empty.shape == (0, 4)


def test_cpu_tensors_count_no_launch(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor must not reach the kernel build")

    monkeypatch.setattr(cuda_aes.cuda_build, "load", no_build)
    monkeypatch.setattr(cuda_aes.ctr_scattered_multikey, "launches", 0)
    monkeypatch.setattr(cuda_aes.ctr_crypt_words_explicit, "launches", 0)
    nr, rks = _stack([bytes(16), bytes(range(16))])
    w, c = _t(_words(40, 1)), _t(_words(40, 2))
    aes.ctr_crypt_words_scattered_multikey(w, c, _t(rks), torch.zeros(40, dtype=torch.int32),
                                           nr, aes.CUDA_ENGINE)
    cuda_aes.ctr_crypt_words_explicit(w, c, _t(rks[1]), nr)
    assert cuda_aes.ctr_scattered_multikey.launches == 0
    assert cuda_aes.ctr_crypt_words_explicit.launches == 0


def test_launch_counts_lose_nothing_across_threads(monkeypatch):
    """The lane workers launch from several threads at once; every count
    goes through ``count_launch``'s lock and stays a plain integer."""
    monkeypatch.setattr(cuda_aes.ctr_scattered_multikey, "launches", 0)
    threads, per = 16, 20000

    def work():
        for _ in range(per):
            cuda_aes.count_launch(cuda_aes.ctr_scattered_multikey)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in pool)
    assert cuda_aes.ctr_scattered_multikey.launches == threads * per
    assert type(cuda_aes.ctr_scattered_multikey.launches) is int
    cuda_aes.ctr_scattered_multikey.launches = 0
    assert cuda_aes.ctr_scattered_multikey.launches == 0


def test_resolve_serve_engine(monkeypatch, tmp_path):
    # On the CPU "auto" is the native C tier (the plain version where it
    # cannot build, tests/test_torch_serve_native.py); "native" pins it.
    assert aes.resolve_serve_engine("auto", "cpu") == aes.NATIVE_ENGINE
    assert aes.resolve_serve_engine(None, "cpu") == aes.NATIVE_ENGINE
    assert aes.resolve_serve_engine("native", "cpu") == aes.NATIVE_ENGINE
    assert aes.resolve_serve_engine("bitslice", "cpu") == aes.PLAIN_ENGINE
    assert aes.resolve_serve_engine("ttable", "cpu") == aes.TTABLE_ENGINE
    with pytest.raises(ValueError, match="unknown engine"):
        aes.resolve_serve_engine("pallas", "cpu")
    # On a card "auto" reads the card's engine ranking (none here: the
    # static order).
    monkeypatch.setenv("OT_ENGINE_RANKING", str(tmp_path / "ranking.json"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(aes, "_CARD_NAMES", {0: "a test card"})
    assert aes.resolve_serve_engine("auto", "cuda") == aes.CUDA_ENGINE
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aes.resolve_serve_engine("auto")
