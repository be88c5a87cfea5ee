"""AES key expansion (host side, numpy).

Copy of ``our_tree_tpu.ops.keyschedule``'s host functions. The schedule is
at most 60 words and sequential, so it runs on the host and is staged to
the card once per key. Words are little-endian packed, a flat array of
4*(nr+1) words; the decryption schedule reverses the round order and
applies InvMixColumns to the interior round keys (equivalent inverse
cipher).
"""

from __future__ import annotations

import numpy as np

from .tables import RCON, SBOX, inv_mix_columns_word

#: key bits -> number of rounds
ROUNDS = {128: 10, 192: 12, 256: 14}


def _sub_word(w: int) -> int:
    return int(SBOX[w & 0xFF] | (SBOX[(w >> 8) & 0xFF] << 8)
               | (SBOX[(w >> 16) & 0xFF] << 16) | (SBOX[(w >> 24) & 0xFF] << 24))


def _rot_word(w: int) -> int:
    # RotWord([a0,a1,a2,a3]) = [a1,a2,a3,a0]: a 32-bit rotate right by 8 in LE.
    return ((w >> 8) | (w << 24)) & 0xFFFFFFFF


def expand_key_enc(key: bytes) -> tuple[int, np.ndarray]:
    """(nr, rk): the round count and the (4*(nr+1),) uint32 encrypt schedule
    for a 16-, 24- or 32-byte key."""
    keybits = len(key) * 8
    if keybits not in ROUNDS:
        raise ValueError(f"AES key must be 128/192/256 bits, got {keybits}")
    nr = ROUNDS[keybits]
    nk = len(key) // 4
    w = [0] * (4 * (nr + 1))
    kb = [int(x) for x in key]
    for i in range(nk):
        w[i] = kb[4 * i] | (kb[4 * i + 1] << 8) | (kb[4 * i + 2] << 16) | (kb[4 * i + 3] << 24)
    for i in range(nk, len(w)):
        t = w[i - 1]
        if i % nk == 0:
            t = _sub_word(_rot_word(t)) ^ int(RCON[i // nk - 1])
        elif nk == 8 and i % nk == 4:
            t = _sub_word(t)
        w[i] = w[i - nk] ^ t
    return nr, np.array(w, dtype=np.uint32)


def dec_schedule_from_enc(nr: int, enc: np.ndarray) -> np.ndarray:
    """The decrypt schedule as a function of the encrypt schedule."""
    dec = np.zeros_like(enc)
    dec[0:4] = enc[4 * nr: 4 * nr + 4]
    for r in range(1, nr):
        dec[4 * r: 4 * r + 4] = inv_mix_columns_word(enc[4 * (nr - r): 4 * (nr - r) + 4])
    dec[4 * nr: 4 * nr + 4] = enc[0:4]
    return dec


def expand_key_dec(key: bytes) -> tuple[int, np.ndarray]:
    """Expand an AES key for decryption (equivalent inverse cipher schedule)."""
    nr, enc = expand_key_enc(key)
    return nr, dec_schedule_from_enc(nr, enc)
