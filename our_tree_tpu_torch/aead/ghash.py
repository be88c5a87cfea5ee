"""GHASH and GCM plumbing, the host half (numpy and ints).

Copy of ``our_tree_tpu.aead.ghash`` over the port's own ``ops.gf``,
``ops.keyschedule`` and ``ops.tables``:

* ``np_aes_encrypt_block``: a single-block AES on host bytes, with which H =
  E_K(0^128) is derived (one block in Python costs microseconds beside the
  key expansion that runs with it);
* ``ghash_int``: GHASH on ints (Horner over 16-byte blocks with
  ``gf128_mul``), the reference the kernel's rows are held against and the
  host finisher's per-request tail;
* ``np_gcm_ctr_blocks``: GCM's inc32 counters (only the low 32 bits move,
  mod 2^32, SP 800-38D section 6.2) as (N, 4) u32 LE words, the layout the
  scattered-CTR dispatch takes;
* J0, zero padding, the length block and the constant-time host tag compare;
* ``np_gcm_seal``/``np_gcm_open``: GCM wholly on the host, the reference that
  ``gcm_seal``/``gcm_open`` are held against.
"""

from __future__ import annotations

import numpy as np

from ..ops import gf
from ..ops.keyschedule import expand_key_enc
from ..ops.tables import SBOX

#: ShiftRows as a byte-position permutation (``ops/bitslice.py``'s derivation,
#: recomputed here so this host module needs no torch).
_SR_PERM = np.array([4 * ((i // 4 + i % 4) % 4) + i % 4
                     for i in range(16)])

_MUL2 = gf.gmul_table(2).astype(np.uint8)
_MUL3 = gf.gmul_table(3).astype(np.uint8)

_SBOX_U8 = np.asarray(SBOX, dtype=np.uint8)


def np_aes_encrypt_block(nr: int, rk_words, block16) -> np.ndarray:
    """One AES block encrypt on host bytes. ``rk_words``: the expanded
    encrypt schedule ((4*(nr+1),) u32, the LE-word convention every
    engine shares); ``block16``: 16 input bytes. Returns (16,) u8."""
    s = np.frombuffer(bytes(bytearray(block16)), dtype=np.uint8).copy()
    rkb = np.ascontiguousarray(
        np.asarray(rk_words, dtype="<u4")).view(np.uint8)
    s ^= rkb[0:16]
    for r in range(1, nr + 1):
        s = _SBOX_U8[s[_SR_PERM]]
        if r != nr:
            a = s.reshape(4, 4)  # column-major: row i = column i's bytes
            s = np.empty_like(a)
            for c in range(4):
                a0, a1, a2, a3 = a[c]
                s[c, 0] = _MUL2[a0] ^ _MUL3[a1] ^ a2 ^ a3
                s[c, 1] = a0 ^ _MUL2[a1] ^ _MUL3[a2] ^ a3
                s[c, 2] = a0 ^ a1 ^ _MUL2[a2] ^ _MUL3[a3]
                s[c, 3] = _MUL3[a0] ^ a1 ^ a2 ^ _MUL2[a3]
            s = s.reshape(16)
        s = s ^ rkb[16 * r:16 * (r + 1)]
    return s


def derive_h(nr: int, rk_words) -> int:
    """H = E_K(0^128) as a field element int — the GHASH subkey the
    keycache stores beside the schedule."""
    return gf.block_to_int(np_aes_encrypt_block(nr, rk_words, b"\x00" * 16))


# ---------------------------------------------------------------------------
# GHASH (int reference) + the GCM framing helpers.
# ---------------------------------------------------------------------------


def pad16(b: bytes) -> bytes:
    """Zero-pad to the next 16-byte boundary (GCM's block padding)."""
    r = len(b) % 16
    return b + b"\x00" * (16 - r) if r else b


def length_block(aad_len: int, ct_len: int) -> bytes:
    """[len(A)]_64 || [len(C)]_64, both in BITS (SP 800-38D §7.1)."""
    return ((aad_len * 8).to_bytes(8, "big")
            + (ct_len * 8).to_bytes(8, "big"))


def ghash_int(h: int, data: bytes, y0: int = 0) -> int:
    """Horner GHASH over 16-byte blocks (``data`` must be a multiple of
    16 — callers ``pad16`` first). The int reference twin."""
    if len(data) % 16:
        raise ValueError("GHASH input must be zero-padded to blocks")
    y = y0
    for off in range(0, len(data), 16):
        y = gf.gf128_mul(y ^ gf.block_to_int(data[off:off + 16]), h)
    return y


def j0_from_iv(h: int, iv: bytes) -> bytes:
    """The pre-counter block: IV || 0^31 || 1 for the 96-bit fast path,
    GHASH(H, IV padded || [0]_64 || [len(IV)]_64) otherwise."""
    iv = bytes(bytearray(iv))
    if len(iv) == 12:
        return iv + b"\x00\x00\x00\x01"
    y = ghash_int(h, pad16(iv) + (0).to_bytes(8, "big")
                  + (len(iv) * 8).to_bytes(8, "big"))
    return gf.int_to_block(y)


def inc32(block16: bytes, k: int = 1) -> bytes:
    """The GCM counter increment: low 32 bits + k mod 2^32, upper 96
    bits untouched."""
    b = bytes(bytearray(block16))
    low = (int.from_bytes(b[12:], "big") + k) & 0xFFFFFFFF
    return b[:12] + low.to_bytes(4, "big")


def np_gcm_ctr_blocks(j0: bytes, idx: np.ndarray,
                      out: np.ndarray | None = None) -> np.ndarray:
    """Counter blocks ``inc32^idx[k](J0)`` as (N, 4) u32 LE words — the
    GCM twin of ``utils.packing.np_ctr_le_blocks``, same output layout
    (the scattered-CTR dispatch consumes it unchanged), different
    increment law: only the low 32 bits move. The common case is one
    broadcast of J0's three fixed words plus a vectorised low-word add."""
    b = np.frombuffer(bytes(bytearray(j0)), dtype=np.uint8)
    if b.size != 16:
        raise ValueError("J0 must be 16 bytes")
    le = b.view("<u4")
    idx = np.asarray(idx, dtype=np.uint32)
    if out is None:
        out = np.empty((idx.size, 4), dtype=np.uint32)
    out[:] = le
    ctr0 = np.uint32(int.from_bytes(bytes(b[12:]), "big"))
    with np.errstate(over="ignore"):  # mod-2^32 wrap is the inc32 law
        out[:, 3] = (ctr0 + idx).byteswap()
    return out


def np_tag_eq(a, b) -> bool:
    """Constant-time host tag compare: full XOR fold over every byte,
    ONE terminal equality — no early-exit loop (the tensor twin is
    ``aead.gcm.tag_eq_words``; tests pin the two)."""
    aa = np.frombuffer(bytes(bytearray(a)), dtype=np.uint8)
    bb = np.frombuffer(bytes(bytearray(b)), dtype=np.uint8)
    if aa.size != bb.size:
        return False
    return int(np.bitwise_or.reduce(aa ^ bb)) == 0


# ---------------------------------------------------------------------------
# The pure-host reference GCM (fuzz-parity oracle).
# ---------------------------------------------------------------------------


def np_gcm_seal(key: bytes, iv: bytes, aad: bytes,
                plaintext: bytes) -> tuple[bytes, bytes]:
    """Reference AES-GCM seal entirely on host ints/numpy — the twin
    ``gcm_seal`` is fuzz-pinned against. O(blocks) Python AES: a
    reference, not a fast path."""
    nr, rk = expand_key_enc(bytes(key))
    h = derive_h(nr, rk)
    j0 = j0_from_iv(h, iv)
    pt = bytes(bytearray(plaintext))
    ct = bytearray()
    for i in range(0, len(pt), 16):
        ks = np_aes_encrypt_block(nr, rk, inc32(j0, 1 + i // 16))
        chunk = pt[i:i + 16]
        ct += bytes(np.frombuffer(chunk, np.uint8) ^ ks[:len(chunk)])
    aad = bytes(bytearray(aad))
    s = ghash_int(h, pad16(aad) + pad16(bytes(ct))
                  + length_block(len(aad), len(ct)))
    ek_j0 = np_aes_encrypt_block(nr, rk, j0)
    tag = bytes(np.frombuffer(gf.int_to_block(s), np.uint8) ^ ek_j0)
    return bytes(ct), tag


def np_gcm_open(key: bytes, iv: bytes, aad: bytes, ciphertext: bytes,
                tag: bytes) -> bytes | None:
    """Reference AES-GCM open; None on tag mismatch (never partial
    plaintext)."""
    nr, rk = expand_key_enc(bytes(key))
    h = derive_h(nr, rk)
    j0 = j0_from_iv(h, iv)
    ct = bytes(bytearray(ciphertext))
    aad = bytes(bytearray(aad))
    s = ghash_int(h, pad16(aad) + pad16(ct)
                  + length_block(len(aad), len(ct)))
    ek_j0 = np_aes_encrypt_block(nr, rk, j0)
    want = bytes(np.frombuffer(gf.int_to_block(s), np.uint8) ^ ek_j0)
    if not np_tag_eq(want, tag):
        return None
    pt = bytearray()
    for i in range(0, len(ct), 16):
        ks = np_aes_encrypt_block(nr, rk, inc32(j0, 1 + i // 16))
        chunk = ct[i:i + 16]
        pt += bytes(np.frombuffer(chunk, np.uint8) ^ ks[:len(chunk)])
    return bytes(pt)
