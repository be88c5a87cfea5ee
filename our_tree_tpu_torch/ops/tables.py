"""AES constants derived from GF(2^8) arithmetic at import time.

Copy of what the port needs from ``our_tree_tpu.ops.tables``: the S-box,
its inverse, the round constants and InvMixColumns on a packed word (for
the decryption key schedule). Words are little-endian packed: a column
(b0, b1, b2, b3), b0 in row 0, packs as ``b0 | b1<<8 | b2<<16 | b3<<24``.
The T-tables stay behind: the port's cipher is bitsliced.
"""

from __future__ import annotations

import numpy as np

from . import gf


def _rotl8(b: np.ndarray, n: int) -> np.ndarray:
    return ((b << n) | (b >> (8 - n))) & 0xFF


def _make_sbox() -> tuple[np.ndarray, np.ndarray]:
    inv = np.array([gf.ginv(x) for x in range(256)], dtype=np.uint32)
    sbox = (inv ^ _rotl8(inv, 1) ^ _rotl8(inv, 2) ^ _rotl8(inv, 3)
            ^ _rotl8(inv, 4) ^ 0x63).astype(np.uint32)
    inv_sbox = np.zeros(256, dtype=np.uint32)
    inv_sbox[sbox] = np.arange(256, dtype=np.uint32)
    return sbox, inv_sbox


SBOX, INV_SBOX = _make_sbox()

#: Round constants for the key schedule (low byte of the LE word).
RCON = np.array([gf.gpow(2, i) for i in range(10)], dtype=np.uint32)

_MUL = {c: np.array([gf.gmul(c, x) for x in range(256)], dtype=np.uint32)
        for c in (9, 11, 13, 14)}


def inv_mix_columns_word(w: np.ndarray) -> np.ndarray:
    """InvMixColumns on packed LE column words (host side, public data)."""
    m9, m11, m13, m14 = _MUL[9], _MUL[11], _MUL[13], _MUL[14]
    w = np.asarray(w, dtype=np.uint32)
    b0, b1, b2, b3 = w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, (w >> 24) & 0xFF
    s0 = m14[b0] ^ m11[b1] ^ m13[b2] ^ m9[b3]
    s1 = m9[b0] ^ m14[b1] ^ m11[b2] ^ m13[b3]
    s2 = m13[b0] ^ m9[b1] ^ m14[b2] ^ m11[b3]
    s3 = m11[b0] ^ m13[b1] ^ m9[b2] ^ m14[b3]
    return (s0 | (s1 << 8) | (s2 << 16) | (s3 << 24)).astype(np.uint32)
