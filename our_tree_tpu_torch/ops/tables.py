"""AES constants derived from GF(2^8) arithmetic at import time.

Copy of ``our_tree_tpu.ops.tables``: the S-box, its inverse, the forward
and reverse T-tables (for the T-table engine, ``ops/block.py``), the round
constants and InvMixColumns on a packed word (for the decryption key
schedule). Words are little-endian packed: a column (b0, b1, b2, b3), b0 in
row 0, packs as ``b0 | b1<<8 | b2<<16 | b3<<24``.

T-tables: FT0[x] = (2S | S<<8 | S<<16 | 3S<<24) with S = SBOX[x] and
RT0[x] = (14I | 9I<<8 | 13I<<16 | 11I<<24) with I = INV_SBOX[x]; FTi and
RTi are FT0 and RT0 rotated left by 8i bits. The kernels use no tables.
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


def _rotl32(w: np.ndarray, n: int) -> np.ndarray:
    w = w.astype(np.uint64)
    return (((w << n) | (w >> (32 - n))) & 0xFFFFFFFF).astype(np.uint32)


SBOX, INV_SBOX = _make_sbox()

_m2, _m3 = gf.gmul_table(2), gf.gmul_table(3)
FT0 = (_m2[SBOX] | (SBOX << 8) | (SBOX << 16) | (_m3[SBOX] << 24)).astype(np.uint32)
FT1, FT2, FT3 = (_rotl32(FT0, 8 * i) for i in (1, 2, 3))

_m9, _m11, _m13, _m14 = (gf.gmul_table(c) for c in (9, 11, 13, 14))
RT0 = (_m14[INV_SBOX] | (_m9[INV_SBOX] << 8) | (_m13[INV_SBOX] << 16)
       | (_m11[INV_SBOX] << 24)).astype(np.uint32)
RT1, RT2, RT3 = (_rotl32(RT0, 8 * i) for i in (1, 2, 3))

#: Round constants for the key schedule (low byte of the LE word).
RCON = np.array([gf.gpow(2, i) for i in range(10)], dtype=np.uint32)


def inv_mix_columns_word(w: np.ndarray) -> np.ndarray:
    """InvMixColumns on packed LE column words (host side, public data)."""
    w = np.asarray(w, dtype=np.uint32)
    b0, b1, b2, b3 = w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, (w >> 24) & 0xFF
    s0 = _m14[b0] ^ _m11[b1] ^ _m13[b2] ^ _m9[b3]
    s1 = _m9[b0] ^ _m14[b1] ^ _m11[b2] ^ _m13[b3]
    s2 = _m13[b0] ^ _m9[b1] ^ _m14[b2] ^ _m11[b3]
    s3 = _m11[b0] ^ _m13[b1] ^ _m9[b2] ^ _m14[b3]
    return (s0 | (s1 << 8) | (s2 << 16) | (s3 << 24)).astype(np.uint32)
