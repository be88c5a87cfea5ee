"""The port's GF(2^128) half (``our_tree_tpu_torch.ops.gf``) held against the
JAX package's ``our_tree_tpu.ops.gf`` on random and edge elements: the
bit-serial multiply, the word-bit basis helpers, the multiply-by-H matrix and
its matvec, and the host-only Shoup tables; and the port's torch derivation
of the same matrices (``ops.cuda_ghash.h_matrices``). Integer arithmetic: the
tolerance is zero."""

import numpy as np
import pytest
import torch

from our_tree_tpu.ops import gf as jgf
from our_tree_tpu_torch.ops import cuda_ghash, gf
from our_tree_tpu_torch.utils import packing

#: 0, the field's one, x, x^127 (its product by x crosses the reduction),
#: all ones, the reduction constant R and 1 + x^127.
EDGES = [0, 1 << 127, 1 << 126, 1, (1 << 128) - 1, gf.GCM_R, (1 << 127) | 1]


def _randoms(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "big") for _ in range(n)]


def test_constants_match():
    assert gf.GCM_R == jgf.GCM_R


@pytest.mark.parametrize("seed", [0, 1])
def test_gf128_mul_matches_reference(seed):
    values = EDGES + _randoms(seed, 6)
    for x in values:
        for y in values:
            assert gf.gf128_mul(x, y) == jgf.gf128_mul(x, y), (hex(x), hex(y))


def test_block_and_wordbit_helpers_match_reference():
    for z in EDGES + _randoms(2, 4):
        b = gf.int_to_block(z)
        assert b == jgf.int_to_block(z) and gf.block_to_int(b) == jgf.block_to_int(b) == z
        np.testing.assert_array_equal(gf.int_to_wordbits(z), jgf.int_to_wordbits(z))
        assert gf.int_to_wordbits(z).dtype == np.uint32
    for j in range(128):
        assert gf.wordbit_to_int(j) == jgf.wordbit_to_int(j)
    assert gf.wordbit_to_int(7) == 1 << 127  # the field's one is word-bit 7


@pytest.mark.parametrize("h", EDGES[1:] + _randoms(3, 2), ids=lambda h: f"{h:032x}")
def test_matrix_and_matvec_match_reference(h):
    m = gf.gf128_mul_matrix_words(h)
    np.testing.assert_array_equal(m, jgf.gf128_mul_matrix_words(h))
    assert m.dtype == np.uint32
    for x in EDGES + _randoms(4, 3):
        assert gf.gf128_matvec_words(m, x) == jgf.gf128_matvec_words(m, x) == jgf.gf128_mul(x, h)


def test_shoup_tables_match_reference():
    h = _randoms(5, 1)[0]
    tables, jtables = gf.gf128_tables(h), jgf.gf128_tables(h)
    assert list(tables[0]) == list(jtables[0]) and list(tables[1]) == list(jtables[1])
    for x in EDGES + _randoms(6, 3):
        assert gf.gf128_mul_table(x, tables) == jgf.gf128_mul_table(x, jtables)


def test_torch_h_matrices_match_reference():
    hs = EDGES[1:] + _randoms(7, 3)
    hk = packing.words_tensor(np.stack([packing.np_bytes_to_words(
        np.frombuffer(gf.int_to_block(h), np.uint8)) for h in hs]), "cpu")
    got = cuda_ghash.h_matrices(hk)
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(hs), 128, 128)
    for i, h in enumerate(hs):
        np.testing.assert_array_equal(got[i].numpy().astype(np.uint32),
                                      jgf.gf128_mul_matrix_words(h))


def test_bits_and_words_round_trip():
    w = packing.words_tensor(np.random.default_rng(8).integers(
        0, 2**32, (5, 4), dtype=np.uint64).astype(np.uint32), "cpu")
    bits = cuda_ghash.bits_of(w)
    assert tuple(bits.shape) == (5, 128)
    np.testing.assert_array_equal(bits[2].numpy(), jgf.int_to_wordbits(gf.block_to_int(
        packing.np_words_to_bytes(packing.words_numpy(w[2])).tobytes())))
    assert torch.equal(cuda_ghash.words_of(bits), w)
