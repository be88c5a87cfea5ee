"""GF(2^8) arithmetic on Python ints (host side, table and matrix derivation).

The AES field modulus is x^8 + x^4 + x^3 + x + 1. Copy of the GF(2^8) half
of ``our_tree_tpu.ops.gf``; GF(2^128) comes with the AEAD slice.
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
