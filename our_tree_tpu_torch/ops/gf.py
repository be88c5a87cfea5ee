"""GF(2^8) and GF(2^128) arithmetic on Python ints (host side, table and
matrix derivation).

Copy of ``our_tree_tpu.ops.gf``. The AES field modulus is x^8 + x^4 + x^3 +
x + 1. The GCM field (SP 800-38D section 6.3) has the modulus x^128 + x^7 +
x^2 + x + 1 in the "reflected" bit order: an element is the block's bytes as
a big-endian int, and int bit (127 - j) is the coefficient of x^j. The
dispatch layout packs a block as little-endian u32 words, whose word-bit k is
bit k % 8 of byte k // 8 (the word-bit basis): the field's one is word-bit 7.

Three formulations of the GF(2^128) multiply: ``gf128_mul`` (bit-serial, the
reference every other one is held against), ``gf128_mul_table`` with
``gf128_tables`` (Shoup's byte tables, host only: it indexes tables by
secret bytes, so no card path may call it) and ``gf128_mul_matrix_words``
(multiply-by-H as a 128 x 128 GF(2) matrix in the word-bit basis: column k is
word-bit k times H; the GHASH kernel ``csrc/ghash.cuh`` builds the same
columns from H and reads them at public indices).
"""

from __future__ import annotations

import numpy as np

#: The AES field modulus x^8 + x^4 + x^3 + x + 1.
POLY = 0x11B


def xtime(a: int) -> int:
    """Multiply by x (i.e. 2) in GF(2^8)."""
    a <<= 1
    if a & 0x100:
        a ^= POLY
    return a & 0xFF


def gmul(a: int, b: int) -> int:
    """Carry-less multiply of two field elements, reduced mod POLY."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a = xtime(a)
    return r


def gpow(a: int, e: int) -> int:
    """a**e in GF(2^8) by square-and-multiply."""
    r = 1
    base = a
    while e:
        if e & 1:
            r = gmul(r, base)
        base = gmul(base, base)
        e >>= 1
    return r


def gmul_table(c: int) -> np.ndarray:
    """Multiply-by-constant lookup table: out[x] = c * x in GF(2^8)."""
    return np.array([gmul(c, x) for x in range(256)], dtype=np.uint32)


def ginv(a: int) -> int:
    """Multiplicative inverse; AES convention maps 0 -> 0."""
    return 0 if a == 0 else gpow(a, 254)


# ---------------------------------------------------------------------------
# GF(2^128): the GCM/GHASH field.
# ---------------------------------------------------------------------------

#: The GCM reduction constant: x^128 = x^7 + x^2 + x + 1, reflected.
GCM_R = 0xE1 << 120


def gf128_mul(x: int, y: int) -> int:
    """Bit-serial carry-less multiply in GF(2^128), reduced (SP 800-38D
    algorithm 1 on the big-endian int representation)."""
    z, v = 0, x
    for i in range(128):
        if (y >> (127 - i)) & 1:
            z ^= v
        v = (v >> 1) ^ (GCM_R if v & 1 else 0)
    return z


def block_to_int(b) -> int:
    """16 block bytes -> the field element (big-endian bit string)."""
    return int.from_bytes(bytes(bytearray(b)), "big")


def int_to_block(z: int) -> bytes:
    """Field element -> 16 block bytes."""
    return z.to_bytes(16, "big")


#: x^8 as a field element (int bit 119): the per-byte shift constant of the
#: table variant's Horner step.
_X8 = 1 << 119


def gf128_tables(h: int) -> tuple[np.ndarray, np.ndarray]:
    """Shoup's two tables for a fixed H: ``T0[b]`` = (b as the block's first
    byte) * H and ``R8[c]`` = the reduction feed-in of multiplying an element
    whose last byte is c by x^8; (256,) object arrays of ints. Host only."""
    t0 = np.array([gf128_mul(b << 120, h) for b in range(256)], dtype=object)
    r8 = np.array([gf128_mul(c, _X8) for c in range(256)], dtype=object)
    return t0, r8


def gf128_mul_table(x: int, tables: tuple[np.ndarray, np.ndarray]) -> int:
    """x * H a byte at a time through ``gf128_tables`` (Shoup's method): 16
    lookups indexed by secret bytes a block, so host only, never on the
    card."""
    t0, r8 = tables
    z = 0
    for i in range(15, -1, -1):
        z = (z >> 8) ^ int(r8[z & 0xFF])          # z *= x^8, reduced
        z ^= int(t0[(x >> (8 * (15 - i))) & 0xFF])
    return z


def wordbit_to_int(j: int) -> int:
    """The field element whose only set word-bit is j (word-bit k = bit k % 8
    of byte k // 8 of the block)."""
    b = bytearray(16)
    b[j // 8] = 1 << (j % 8)
    return block_to_int(b)


def int_to_wordbits(z: int) -> np.ndarray:
    """Field element -> (128,) 0/1 uint32 vector in word-bit order."""
    b = np.frombuffer(int_to_block(z), dtype=np.uint8)
    return ((b[:, None] >> np.arange(8, dtype=np.uint8)) & 1).reshape(128).astype(np.uint32)


def gf128_mul_matrix_words(h: int) -> np.ndarray:
    """Multiply-by-H as a (128, 128) GF(2) uint32 matrix in the word-bit
    basis: column j = (word-bit j) * H, so ``(M @ bits(x)) & 1`` is x * H."""
    m = np.empty((128, 128), dtype=np.uint32)
    for j in range(128):
        m[:, j] = int_to_wordbits(gf128_mul(wordbit_to_int(j), h))
    return m


def gf128_matvec_words(m: np.ndarray, x: int) -> int:
    """x * H through the word-bit matrix ``m`` (``gf128_mul_matrix_words``)."""
    out = (m.astype(np.int64) @ int_to_wordbits(x).astype(np.int64)) & 1
    z = 0
    for j in np.flatnonzero(out):
        z |= wordbit_to_int(int(j))
    return z
