"""AES-GCM in the port (``our_tree_tpu_torch.aead``) held bit-exact against
the JAX package's ``our_tree_tpu.aead`` on the same numpy inputs, the port on
the CPU (``device="cpu"``, the plain versions behind the CUDA engine's
wrappers): ``ghash_words`` with and without y0; the dispatch seam
``gcm_crypt_ghash_words`` against the reference's engines ``jnp`` and
``bitslice`` in both directions, nr 10/12/14 and K 1/3/8 over random segment
layouts, its ``out`` and every row of its ``ys``, fed the reference's own
``hmats``; ``gcm_seal``/``gcm_open`` on the NIST SP 800-38D KATs
(``tests/golden/gcm_kats.json``, which the reference's own tests hold it to)
and on random lengths against the reference and the host GCM; tamper refusals; ``tag_eq_words``; ``_key_material``; the
host half (``aead/ghash.py``) and the GHASH wrapper's checks. Integer
cryptography: the tolerance is zero."""

import json
import pathlib

import numpy as np
import pytest
import torch

from our_tree_tpu.aead import gcm as jgcm
from our_tree_tpu.aead import ghash as jghash
from our_tree_tpu.ops import gf as jgf
from our_tree_tpu_torch.aead import gcm, ghash
from our_tree_tpu_torch.models import aes
from our_tree_tpu_torch.ops import cuda_ghash
from our_tree_tpu_torch.ops.keyschedule import expand_key_enc
from our_tree_tpu_torch.utils import packing

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "gcm_kats.json"
KATS = json.loads(GOLDEN.read_text())["kats"]


def _t(a):
    return packing.words_tensor(np.asarray(a, np.uint32), "cpu")


def _np(t):
    return packing.words_numpy(t)


def _u32(rng, *shape):
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)


def _words(b: bytes) -> np.ndarray:
    return packing.np_bytes_to_words(np.frombuffer(b, np.uint8))


# ---------------------------------------------------------------------------
# The host half.
# ---------------------------------------------------------------------------


def test_host_half_matches_reference():
    rng = np.random.default_rng(1)
    for bits in (128, 192, 256):
        nr, rk = expand_key_enc(rng.bytes(bits // 8))
        block = rng.bytes(16)
        np.testing.assert_array_equal(ghash.np_aes_encrypt_block(nr, rk, block),
                                      jghash.np_aes_encrypt_block(nr, rk, block))
        h = ghash.derive_h(nr, rk)
        assert h == jghash.derive_h(nr, rk)
        for ivlen in (1, 8, 12, 16, 60):
            iv = rng.bytes(ivlen)
            assert ghash.j0_from_iv(h, iv) == jghash.j0_from_iv(h, iv)
        data = rng.bytes(16 * 7)
        assert ghash.ghash_int(h, data, 5) == jghash.ghash_int(h, data, 5)
    j0 = bytes(range(12)) + b"\xff\xff\xff\xfd"
    idx = np.arange(6, dtype=np.uint32)
    np.testing.assert_array_equal(ghash.np_gcm_ctr_blocks(j0, idx),
                                  jghash.np_gcm_ctr_blocks(j0, idx))
    assert ghash.inc32(j0, 5) == jghash.inc32(j0, 5)
    assert ghash.pad16(b"abc") == jghash.pad16(b"abc")
    assert ghash.length_block(20, 33) == jghash.length_block(20, 33)
    with pytest.raises(ValueError):
        ghash.ghash_int(1, b"x")


def test_key_material_matches_reference():
    rng = np.random.default_rng(2)
    for bits in (128, 192, 256):
        key = rng.bytes(bits // 8)
        nr, rk, h, hmat = gcm._key_material(key)
        jnr, jrk, jh, jhmat = jgcm._key_material(key)
        assert nr == jnr and h == jh
        assert rk.dtype == np.uint32 and hmat.dtype == np.uint32
        np.testing.assert_array_equal(rk, jrk)
        np.testing.assert_array_equal(hmat, jhmat)
        assert gcm._key_material(key) is gcm._key_material(key)


def test_key_cache_is_bounded():
    for i in range(70):
        gcm._key_material(bytes([i]) * 16)
    assert len(gcm._KEY_CACHE) <= 64


# ---------------------------------------------------------------------------
# GHASH and the dispatch seam.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nblocks", [1, 5, 32])
@pytest.mark.parametrize("with_y0", [False, True])
def test_ghash_words_matches_reference(nblocks, with_y0):
    rng = np.random.default_rng(10 + nblocks)
    h = int.from_bytes(rng.bytes(16), "big")
    hmat = jgf.gf128_mul_matrix_words(h)
    w = _u32(rng, 4 * nblocks)
    y0 = _u32(rng, 4) if with_y0 else None
    want = np.asarray(jgcm.ghash_words(w, hmat, y0 if with_y0 else None))
    got = gcm.ghash_words(_t(w), hmat, None if y0 is None else _t(y0))
    np.testing.assert_array_equal(_np(got), want)
    # The matrix as a tensor, the state as numpy: the same answer.
    got2 = gcm.ghash_words(_t(w).reshape(-1, 4), torch.from_numpy(hmat.astype(np.int64)), y0)
    np.testing.assert_array_equal(_np(got2), want)
    data = packing.np_words_to_bytes(w).tobytes()
    y0_int = 0 if y0 is None else jgf.block_to_int(packing.np_words_to_bytes(y0).tobytes())
    assert jgf.block_to_int(packing.np_words_to_bytes(_np(got)).tobytes()) == \
        ghash.ghash_int(h, data, y0_int)


def test_ghash_words_of_no_blocks_is_y0():
    y0 = _t([1, 2, 3, 4])
    assert torch.equal(gcm.ghash_words(_t(np.zeros(0, np.uint32)), np.eye(128, dtype=np.uint32),
                                       y0), y0)


def _layout(rng, k, nr_bits):
    """A random batch of at least 150 rows in the serve batcher's GCM
    layout: requests of 0-40 blocks on random slots, each a J0 row (keep 0), payload rows (keep 0 at
    the first) and its AAD state injected at the first payload row; random
    rows (keep 1, random inject) between some of them. Returns the seam's
    numpy arrays and the keys' (nr, rks, hmats) from the JAX package."""
    keys = [rng.bytes(nr_bits // 8) for _ in range(k)]
    mats = [jgcm._key_material(key) for key in keys]
    nr = mats[0][0]
    rks = np.stack([m[1] for m in mats]).astype(np.uint32)
    hmats = np.stack([m[3] for m in mats])
    words, ctr, inject, keep, slots = [], [], [], [], []
    while sum(map(len, keep)) < 150:
        s = int(rng.integers(0, k))
        n = int(rng.integers(0, 41))
        iv = rng.bytes(12)
        j0 = jghash.j0_from_iv(mats[s][2], iv)
        ctr.append(jghash.np_gcm_ctr_blocks(j0, np.arange(n + 1, dtype=np.uint32)))
        words.append(np.concatenate([np.zeros((1, 4), np.uint32), _u32(rng, n, 4)]))
        inj = np.zeros((n + 1, 4), np.uint32)
        if n:
            inj[1] = _u32(rng, 4)
        inject.append(inj)
        kp = np.ones(n + 1, np.uint32)
        kp[:2] = 0
        keep.append(kp)
        slots.append(np.full(n + 1, s, np.uint32))
        if rng.random() < 0.3:  # free rows: the scan carries through them
            m = int(rng.integers(1, 5))
            ctr.append(_u32(rng, m, 4))
            words.append(_u32(rng, m, 4))
            inject.append(_u32(rng, m, 4))
            keep.append(np.ones(m, np.uint32))
            slots.append(rng.integers(0, k, m).astype(np.uint32))
    cat = np.concatenate
    return (cat(words).reshape(-1), cat(ctr).reshape(-1), rks, cat(slots), hmats,
            cat(inject).reshape(-1), cat(keep), nr)


#: The seam's cases: both directions, nr 10/12/14 and K 1/3/8, every
#: combination against the reference's ``jnp`` engine and a third of them
#: (each direction with each key size once, K cycling) also against its
#: ``bitslice`` engine: each reference engine is a compile of its own.
SEAM_CASES = [(d, bits, k, ("jnp", "bitslice") if (i + j) % 3 == 0 else ("jnp",))
              for d in ("seal", "open") for i, bits in enumerate((128, 192, 256))
              for j, k in enumerate((1, 3, 8))]


@pytest.mark.parametrize("direction,nr_bits,k,engines", SEAM_CASES,
                         ids=[f"{d}-{b}-k{k}-{'+'.join(e)}" for d, b, k, e in SEAM_CASES])
def test_seam_matches_reference(direction, nr_bits, k, engines):
    rng = np.random.default_rng(100 * k + nr_bits + (direction == "open"))
    w, c, rks, slots, hmats, inj, keep, nr = _layout(rng, k, nr_bits)
    want = {eng: [np.asarray(a) for a in jgcm.gcm_crypt_ghash_words(
        w, c, rks, slots, hmats, inj, keep, nr, eng, direction)] for eng in engines}
    for eng in engines[1:]:
        np.testing.assert_array_equal(want[eng][0], want["jnp"][0])
        np.testing.assert_array_equal(want[eng][1], want["jnp"][1])
    for engine in (aes.CUDA_ENGINE, "auto"):
        out, ys = gcm.gcm_crypt_ghash_words(
            _t(w), _t(c), _t(rks), torch.from_numpy(slots.astype(np.int32)), hmats, _t(inj),
            torch.from_numpy(keep.astype(np.int32)), nr, engine, direction)
        assert out.shape == ys.shape == (w.size,)
        np.testing.assert_array_equal(_np(out), want["jnp"][0])
        np.testing.assert_array_equal(_np(ys), want["jnp"][1])  # every row, J0 rows too


@pytest.mark.parametrize("direction,nr_bits,k,engines", SEAM_CASES,
                         ids=[f"{d}-{b}-k{k}-{'+'.join(e)}" for d, b, k, e in SEAM_CASES])
def test_seam_rows_match_reference(direction, nr_bits, k, engines):
    """The seam with ``rows`` (``ghash_at`` behind the CUDA engine): the
    named rows of the reference's every-row ``ys`` (each request's last row,
    as the serve modes read them, row 0 and the last row), and the same
    ``out``. The layouts are ``test_seam_matches_reference``'s."""
    rng = np.random.default_rng(100 * k + nr_bits + (direction == "open"))
    w, c, rks, slots, hmats, inj, keep, nr = _layout(rng, k, nr_bits)
    n = keep.size
    want = {eng: [np.asarray(a) for a in jgcm.gcm_crypt_ghash_words(
        w, c, rks, slots, hmats, inj, keep, nr, eng, direction)] for eng in engines}
    starts = np.flatnonzero(keep == 0)
    rows = sorted({0, n - 1, *(int(r) - 1 for r in starts[1:] if r > 0)})
    for eng in engines:
        for engine in (aes.CUDA_ENGINE, "auto"):
            out, ys = gcm.gcm_crypt_ghash_words(
                _t(w), _t(c), _t(rks), torch.from_numpy(slots.astype(np.int32)), hmats,
                _t(inj), torch.from_numpy(keep.astype(np.int32)), nr, engine, direction,
                rows=rows)
            assert tuple(ys.shape) == (len(rows), 4)
            np.testing.assert_array_equal(_np(out), want[eng][0])
            np.testing.assert_array_equal(_np(ys), want[eng][1].reshape(-1, 4)[rows])


def test_ghash_at_is_the_scans_rows_and_checks_them():
    rng = np.random.default_rng(8)
    n, k = 70, 3
    x, inj, hk, y0 = (_t(_u32(rng, *shape)) for shape in ((n, 4), (n, 4), (k, 4), (4,)))
    slots = torch.from_numpy(rng.integers(0, k, n).astype(np.int32))
    keep = torch.from_numpy((rng.random(n) < 0.8).astype(np.int32))
    every = cuda_ghash.ghash_scan(x, hk, slots, keep, y0, inject=inj)
    for rows in ([0], [69], [3, 3, 40], list(range(0, 70, 7)), torch.tensor([5, 6])):
        got = cuda_ghash.ghash_at(x, hk, slots, keep, y0, rows, inject=inj)
        assert torch.equal(got, every[torch.as_tensor(rows, dtype=torch.int64)])
        assert torch.equal(got, cuda_ghash.ghash_at_plain(x, hk, slots, keep, y0, rows, inj))
    assert tuple(cuda_ghash.ghash_at(x, hk, slots, keep, y0, []).shape) == (0, 4)
    for bad in ([70], [-1], [5, 4]):
        with pytest.raises(ValueError, match="rows_out"):
            cuda_ghash.ghash_at(x, hk, slots, keep, y0, bad)
    with pytest.raises(ValueError, match="key_slots"):
        cuda_ghash.ghash_at(x, hk, slots + 3, keep, y0, [1])


def test_seam_takes_hmats_as_a_tensor_and_other_engines():
    rng = np.random.default_rng(7)
    w, c, rks, slots, hmats, inj, keep, nr = _layout(rng, 3, 128)
    want = [np.asarray(a) for a in jgcm.gcm_crypt_ghash_words(
        w, c, rks, slots, hmats, inj, keep, nr, "jnp", "seal")]
    args = (_t(w).reshape(-1, 4), _t(c).reshape(-1, 4), _t(rks),
            torch.from_numpy(slots.astype(np.int32)))
    rest = (_t(inj).reshape(-1, 4), torch.from_numpy(keep.astype(np.int32)), nr)
    for hm, engine in ((torch.from_numpy(hmats.astype(np.int64)), "bitslice"),
                       (hmats, "ttable")):
        out, ys = gcm.gcm_crypt_ghash_words(*args, hm, *rest, engine)
        assert out.shape == ys.shape == (w.size // 4, 4)
        np.testing.assert_array_equal(_np(out).reshape(-1), want[0])
        np.testing.assert_array_equal(_np(ys).reshape(-1), want[1])
    with pytest.raises(ValueError, match="direction"):
        gcm.gcm_crypt_ghash_words(*args, hmats, *rest, "auto", "sideways")


def test_ghash_scan_checks_its_inputs():
    z = torch.zeros((3, 4), dtype=torch.int32)
    hk = torch.ones((2, 4), dtype=torch.int32)
    one, y0 = torch.ones(3, dtype=torch.int32), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"key_slots must lie in \[0, 2\)"):
        cuda_ghash.ghash_scan(z, hk, torch.tensor([0, 2, 1], dtype=torch.int32), one, y0)
    with pytest.raises(TypeError):
        cuda_ghash.ghash_scan(z.long(), hk, one, one, y0)
    with pytest.raises(ValueError, match="hkeys"):
        cuda_ghash.ghash_scan(z, torch.ones((65, 4), dtype=torch.int32), one, one, y0)
    with pytest.raises(ValueError, match="seg_keep"):
        cuda_ghash.ghash_scan(z, hk, one, one[:2], y0)
    empty = cuda_ghash.ghash_scan(z[:0], hk, one[:0], one[:0], y0)
    assert tuple(empty.shape) == (0, 4)


# ---------------------------------------------------------------------------
# The public API.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kat", KATS, ids=lambda k: k["name"])
def test_gcm_kat(kat):
    key, iv = bytes.fromhex(kat["key"]), bytes.fromhex(kat["iv"])
    aad, pt = bytes.fromhex(kat["aad"]), bytes.fromhex(kat["pt"])
    ct, tag = gcm.gcm_seal(key, iv, aad, pt, device="cpu")
    assert ct.hex() == kat["ct"] and tag.hex() == kat["tag"]
    assert gcm.gcm_open(key, iv, aad, ct, tag, device="cpu") == pt


@pytest.mark.parametrize("kat", [k for k in KATS if k["ct"]], ids=lambda k: k["name"])
def test_gcm_kat_tamper_refused(kat):
    key, iv = bytes.fromhex(kat["key"]), bytes.fromhex(kat["iv"])
    aad, ct = bytes.fromhex(kat["aad"]), bytes.fromhex(kat["ct"])
    tag = bytes.fromhex(kat["tag"])
    bad = [(aad, bytes([ct[0] ^ 1]) + ct[1:], tag), (aad, ct, tag[:-1] + bytes([tag[-1] ^ 0x80])),
           (aad, ct, tag[:15])]
    if aad:
        bad.append((bytes([aad[0] ^ 1]) + aad[1:], ct, tag))
    for a, c, t in bad:
        with pytest.raises(gcm.TagMismatchError):
            gcm.gcm_open(key, iv, a, c, t, device="cpu")
        assert jghash.np_gcm_open(key, iv, a, c, t) is None


@pytest.mark.parametrize("keylen", [16, 24, 32])
def test_gcm_random_lengths_match_host_and_reference(keylen):
    """Empty and ragged plaintexts, empty and multi-block AAD, 96-bit and
    other IVs: the port equals the JAX package's host GCM and its own."""
    rng = np.random.default_rng(keylen)
    key = rng.bytes(keylen)
    for ivlen in (12, 8, 16):
        iv = rng.bytes(ivlen)
        for pt_len, aad_len in ((0, 0), (1, 16), (15, 0), (16, 20), (17, 33), (65, 1),
                                (100, 0)):
            pt, aad = rng.bytes(pt_len), rng.bytes(aad_len)
            ct, tag = gcm.gcm_seal(key, iv, aad, pt, device="cpu")
            assert (ct, tag) == jghash.np_gcm_seal(key, iv, aad, pt) \
                == ghash.np_gcm_seal(key, iv, aad, pt), (ivlen, pt_len, aad_len)
            assert gcm.gcm_open(key, iv, aad, ct, tag, device="cpu") == pt
            assert ghash.np_gcm_open(key, iv, aad, ct, tag) == pt


def test_gcm_matches_reference_api_and_refuses_what_it_refuses():
    rng = np.random.default_rng(0xBEEF)
    key, iv = rng.bytes(16), rng.bytes(12)
    pt, aad = rng.bytes(100), rng.bytes(20)
    ct, tag = gcm.gcm_seal(key, iv, aad, pt, device="cpu")
    assert (ct, tag) == jgcm.gcm_seal(key, iv, aad, pt)
    bad = ct[:50] + bytes([ct[50] ^ 4]) + ct[51:]
    assert ghash.np_gcm_open(key, iv, aad, bad, tag) is None
    with pytest.raises(gcm.TagMismatchError):
        gcm.gcm_open(key, iv, aad, bad, tag, device="cpu")


def test_gcm_entry_points_need_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gcm.gcm_seal(bytes(16), bytes(12), b"", b"x")


def test_tag_eq_words_matches_host_twin_and_reference():
    rng = np.random.default_rng(12)
    a = rng.bytes(16)
    for b in (a, a[:15] + bytes([a[15] ^ 1]), bytes([a[0] ^ 0x80]) + a[1:], rng.bytes(16)):
        want = a == b
        assert ghash.np_tag_eq(a, b) is want
        got = gcm.tag_eq_words(_words(a), _words(b))
        assert got.dtype == torch.bool and got.dim() == 0 and bool(got) is want
        assert bool(gcm.tag_eq_words(_t(_words(a)), _t(_words(b)))) is want
        assert bool(jgcm.tag_eq_words(_words(a), _words(b))) is want
    assert ghash.np_tag_eq(a, a[:15]) is False
