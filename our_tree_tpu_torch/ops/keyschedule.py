"""AES key expansion (host side, numpy).

Copy of ``our_tree_tpu.ops.keyschedule``. The schedule is at most 60 words
and sequential, so the contexts expand it on the host and stage it to the
card once per key. Words are little-endian packed, a flat array of
4*(nr+1) words; the decryption schedule reverses the round order and
applies InvMixColumns to the interior round keys (equivalent inverse
cipher).

``expand_key_enc_device`` and ``expand_key_dec_device`` run the same
recurrence as torch ops on the key tensor's device, for work that rekeys
there: the reference's ``lax.scan`` outside any kernel, here a Python loop
over the public per-step wiring, each step one elementwise op over a batch
of keys.
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


def _device_schedule_consts(keybits: int):
    """The expansion's public per-step wiring: (nr, nk, per step whether it
    rotates, whether it substitutes alone, its round constant)."""
    if keybits not in ROUNDS:
        raise ValueError(f"AES key must be 128/192/256 bits, got {keybits}")
    nr, nk = ROUNDS[keybits], keybits // 32
    steps = []
    for i in range(nk, 4 * (nr + 1)):
        if i % nk == 0:
            steps.append((True, False, int(RCON[i // nk - 1])))
        else:
            steps.append((False, nk == 8 and i % nk == 4, 0))
    return nr, nk, steps


def _as_i32(w):
    """int64 words in [0, 2^32) as int32 with the same bits."""
    import torch

    return (w - ((w & 0x80000000) << 1)).to(torch.int32)


def expand_key_enc_device(key_words, keybits: int):
    """(nr, rk): the encrypt schedule of ``key_words``, (..., keybits/32)
    LE key words (int32 or int64 with the u32 bits), as (..., 4*(nr+1))
    int32 words on the key tensor's device; equal to ``expand_key_enc``
    per key."""
    import torch

    nr, nk, steps = _device_schedule_consts(keybits)
    if key_words.shape[-1] != nk:
        raise ValueError(f"{keybits}-bit keys have {nk} words, got {key_words.shape[-1]}")
    sbox = torch.as_tensor(SBOX.astype(np.int64), device=key_words.device)
    w = list((key_words.to(torch.int64) & 0xFFFFFFFF).unbind(-1))

    def sub_word(x):
        return (sbox[x & 0xFF] | (sbox[(x >> 8) & 0xFF] << 8)
                | (sbox[(x >> 16) & 0xFF] << 16) | (sbox[x >> 24] << 24))

    for rot, sub, rcon in steps:
        t = w[-1]
        if rot:
            t = sub_word(((t >> 8) | (t << 24)) & 0xFFFFFFFF) ^ rcon
        elif sub:
            t = sub_word(t)
        w.append(w[-nk] ^ t)
    return nr, _as_i32(torch.stack(w, -1))


def expand_key_dec_device(key_words, keybits: int):
    """(nr, rk_dec): the InvMixColumns-folded decrypt schedule, the round
    order reversed, of ``key_words`` on its device; equal to
    ``expand_key_dec`` per key."""
    import torch

    from .gf import gmul_table

    nr, enc = expand_key_enc_device(key_words, keybits)
    m9, m11, m13, m14 = (torch.as_tensor(gmul_table(c).astype(np.int64), device=enc.device)
                         for c in (9, 11, 13, 14))
    rounds = (enc.to(torch.int64) & 0xFFFFFFFF).reshape(*enc.shape[:-1], nr + 1, 4).flip(-2)
    mid = rounds[..., 1:nr, :]
    b0, b1, b2, b3 = mid & 0xFF, (mid >> 8) & 0xFF, (mid >> 16) & 0xFF, mid >> 24
    mid = ((m14[b0] ^ m11[b1] ^ m13[b2] ^ m9[b3])
           | ((m9[b0] ^ m14[b1] ^ m11[b2] ^ m13[b3]) << 8)
           | ((m13[b0] ^ m9[b1] ^ m14[b2] ^ m11[b3]) << 16)
           | ((m11[b0] ^ m13[b1] ^ m9[b2] ^ m14[b3]) << 24))
    dec = torch.cat([rounds[..., :1, :], mid, rounds[..., nr:, :]], -2)
    return nr, _as_i32(dec.reshape(*enc.shape))
