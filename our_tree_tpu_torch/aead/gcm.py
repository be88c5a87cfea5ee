"""AES-GCM on the card: the dispatch seam and the public seal/open API
(``our_tree_tpu.aead.gcm``).

GHASH multiplies by a fixed per-key H, which is linear over GF(2), so it
needs no lookup indexed by secret data: the reference carries a 128 x 128 bit
matrix a key and runs a ``lax.scan`` of matrix products. On the card the
GHASH half is the GHASH kernel (``ops/cuda_ghash.py``, ``csrc/ghash.cu``),
which takes H as field elements (column 7 of a key's matrix, word-bit 7
being the field's one) and multiplies on integer multiplies: ``ghash_scan``
for every row, ``ghash_at`` for the rows a caller names.

``gcm_crypt_ghash_words`` is the serve dispatch seam: scattered multi-key
CTR (``models.aes.ctr_crypt_words_scattered_multikey``, on the card the
``ctr_mk`` kernel) and then the segmented Horner GHASH over the ciphertext
stream, two kernel calls a dispatch (``ghash_scan``'s call is three grid
launches; with ``rows`` given the seam calls ``ghash_at``, two). The batch
layout, which ``gcm_seal``/``gcm_open`` build for one request (K = 1) and
the serve batcher for many:

* each request takes 1 + n rows: row 0 carries counter J0 with a zero data
  word, so its CTR output is E_K(J0), the tag's final pad; rows 1..n carry
  the payload under inc32 counters;
* ``seg_keep`` (N,) zeroes the Horner carry at each segment's first row and
  at the J0 rows, whose GHASH lane is discarded;
* ``inject_words`` XORs each request's AAD state Y_aad, computed on the host,
  into its first ciphertext block, which continues the AAD's Horner chain;
* the scan gives the running Y at every row (or at the rows named by
  ``rows``); the host finisher reads each request's last full-block row and
  applies the partial block, the length block and the E_K(J0) pad
  (``ops.gf.gf128_mul`` on ints, one or two multiplies a request).
  ``gcm_seal``/``gcm_open`` name that one row.

``tag_eq_words`` is the constant-time tag compare (a full XOR, one OR fold,
one terminal equality); ``ghash.np_tag_eq`` is its host twin.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import aes as _aes
from ..ops import cuda_ghash, gf
from ..ops.keyschedule import expand_key_enc
from ..utils import packing
from . import ghash as _gh

#: Directions of the seam: GHASH runs over the ciphertext stream, the CTR
#: output when sealing and the input when opening.
SEAL = "seal"
OPEN = "open"


class TagMismatchError(ValueError):
    """``gcm_open``'s authentication failure: no plaintext is returned."""


#: (N, 4) int32 block words <-> (N, 128) 0/1 bits in the word-bit basis of
#: ``gf.gf128_mul_matrix_words`` (bit k = bit k % 32 of word k // 32).
_bits_of = cuda_ghash.bits_of
_words_of = cuda_ghash.words_of


def _as_words(a, device) -> torch.Tensor:
    """u32 words as an int32 tensor on ``device`` (a tensor is moved, numpy
    or a list copied)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32)
    return packing.words_tensor(np.asarray(a, dtype=np.uint32), device)


def _h_words(hmats, device) -> torch.Tensor:
    """(K, 4) int32 H words from (K, 128, 128) multiply-by-H matrices (numpy
    u32, as the keycaches hold them, or a tensor): column 7, the image of
    the field's one. From numpy the words are packed on the host, so only
    the (K, 4) words reach ``device``."""
    if isinstance(hmats, torch.Tensor):
        col = hmats[:, :, 7].to(device=device, dtype=torch.int64)
        return _words_of(col & 1).contiguous()
    bits = (np.asarray(hmats)[:, :, 7] & 1).astype(np.uint32).reshape(-1, 4, 32)
    words = (bits << np.arange(32, dtype=np.uint32)).sum(axis=2, dtype=np.uint32)
    return packing.words_tensor(words, device)


def _ghash_fn(engine: str, rows: bool):
    """The GHASH of an engine, every row or (``rows``) the named rows: the
    kernel's wrapper for the CUDA engine (its plain version on CPU
    tensors), the plain version for the others."""
    if engine == _aes.CUDA_ENGINE:
        return cuda_ghash.ghash_at if rows else cuda_ghash.ghash_scan
    return cuda_ghash.ghash_at_plain if rows else cuda_ghash.ghash_scan_plain


def ghash_words(words, hmat, y0_words=None) -> torch.Tensor:
    """Horner GHASH over (N, 4) int32 block words (or a flat (4N,) stream)
    under the (128, 128) multiply-by-H matrix ``hmat`` (numpy or tensor),
    from the (4,) state ``y0_words`` (zero when None). Returns the final Y as
    (4,) int32 words on ``words``' device: ``ghash_at`` at the last row with
    one key and no restart (on the card the kernel)."""
    w2 = words.reshape(-1, 4).contiguous()
    dev = w2.device
    y0 = (torch.zeros(4, dtype=torch.int32, device=dev) if y0_words is None
          else _as_words(y0_words, dev).reshape(4).contiguous())
    n = w2.shape[0]
    if n == 0:
        return y0.clone()
    hmats = hmat[None] if isinstance(hmat, torch.Tensor) else np.asarray(hmat)[None]
    ys = cuda_ghash.ghash_at(w2, _h_words(hmats, dev),
                             torch.zeros(n, dtype=torch.int32, device=dev),
                             torch.ones(n, dtype=torch.int32, device=dev), y0, [n - 1])
    return ys[0]


def gcm_crypt_ghash_words(words, ctr_le_words, rks, key_slots, hmats, inject_words, seg_keep,
                          nr: int, engine: str = "auto", direction: str = SEAL, rows=None):
    """The GCM dispatch: scattered multi-key CTR, then the segmented GHASH
    over the ciphertext (the module docstring has the batch layout). Returns
    ``(out_words, y_words)``: the CTR result (E_K(J0) on the J0 rows) in
    ``words``' shape and the running GHASH state after every row, in
    ``words``' shape too; with ``rows`` (E sorted row indices, a sequence or
    an int64 tensor) the state at those rows only, as (E, 4). ``words``,
    ``ctr_le_words``, ``inject_words``: (N, 4) or flat (4N,) int32 tensors;
    ``rks``: (K, 4*(nr+1)) int32 schedules; ``key_slots``, ``seg_keep``: (N,)
    int32; ``hmats``: (K, 128, 128) multiply-by-H matrices, numpy u32 (the
    JAX package's keycache layout) or a tensor. ``engine`` as
    ``models.aes.resolve_engine``: the kernels on a card (``ctr_mk``, then
    ``ghash_scan``, or ``ghash_at`` with ``rows``), the plain versions on the
    CPU."""
    if direction not in (SEAL, OPEN):
        raise ValueError(f"direction must be {SEAL!r} or {OPEN!r}, got {direction!r}")
    engine = _aes.resolve_engine(engine, words.device)
    w2 = words.reshape(-1, 4)
    slots = key_slots.to(torch.int32).contiguous()
    out = _aes.ctr_crypt_words_scattered_multikey(w2, ctr_le_words.reshape(-1, 4), rks, slots,
                                                  nr, engine)
    ct = out if direction == SEAL else w2
    args = (ct.contiguous(), _h_words(hmats, words.device), slots,
            seg_keep.to(torch.int32).contiguous(),
            torch.zeros(4, dtype=torch.int32, device=words.device))
    inject = inject_words.reshape(-1, 4).contiguous()
    with _aes.seam_call("ghash_scan" if rows is None else "ghash_at", engine, 0, words.device):
        if rows is not None:
            return out.reshape(words.shape), _ghash_fn(engine, True)(*args, rows, inject)
        ys = _ghash_fn(engine, False)(*args, inject)
    return out.reshape(words.shape), ys.reshape(words.shape)


def tag_eq_words(a, b) -> torch.Tensor:
    """Constant-time 128-bit tag compare of (4,) u32 words (tensors, numpy
    or lists): a full XOR, one OR fold, one terminal equality, no early
    exit. Returns a 0-dim bool tensor."""
    dev = a.device if isinstance(a, torch.Tensor) else "cpu"
    d = _as_words(a, dev).reshape(-1) ^ _as_words(b, dev).reshape(-1)
    return ((d[0] | d[1]) | (d[2] | d[3])) == 0


#: key -> (nr, rk, h, hmat): deriving the multiply-by-H matrix is 128 field
#: multiplies of host int work, and KATs and fuzzing come back to the same few
#: keys. Bounded: the oldest key leaves at 64.
_KEY_CACHE: dict[bytes, tuple] = {}


def _key_material(key: bytes):
    """(nr, rk u32, h int, hmat (128, 128) u32) of ``key``, as the JAX
    package's ``_key_material`` gives them."""
    key = bytes(key)
    hit = _KEY_CACHE.get(key)
    if hit is not None:
        return hit
    nr, rk = expand_key_enc(key)
    rk = np.asarray(rk, dtype=np.uint32)
    h = _gh.derive_h(nr, rk)
    ent = (nr, rk, h, gf.gf128_mul_matrix_words(h))
    if len(_KEY_CACHE) >= 64:
        _KEY_CACHE.pop(next(iter(_KEY_CACHE)))
    _KEY_CACHE[key] = ent
    return ent


def _finish_tag(y_int: int, h: int, tail_ct: bytes, aad_len: int, ct_len: int,
                ek_j0: np.ndarray) -> bytes:
    """The host per-request GHASH tail: the zero-padded partial block if
    any, the length block, then the E_K(J0) pad."""
    if tail_ct:
        y_int = gf.gf128_mul(y_int ^ gf.block_to_int(_gh.pad16(tail_ct)), h)
    y_int = gf.gf128_mul(y_int ^ gf.block_to_int(_gh.length_block(aad_len, ct_len)), h)
    return bytes(np.frombuffer(gf.int_to_block(y_int), np.uint8) ^ np.asarray(ek_j0, np.uint8))


def _gcm_arrays(j0: bytes, data: bytes, y_aad: int):
    """The one-request (K = 1) seam arrays for ``data``'s full blocks as
    numpy u32: row 0 = J0, rows 1..n = payload, the serve batcher's layout.
    Returns (words (4n,), ctr (4n,), inject (4n,), keep (n,), full blocks)."""
    nfull = len(data) // 16
    n = 1 + nfull
    words = np.zeros(4 * n, dtype=np.uint32)
    if nfull:
        words[4:] = packing.np_bytes_to_words(np.frombuffer(data[:16 * nfull], np.uint8))
    ctr = _gh.np_gcm_ctr_blocks(j0, np.arange(n, dtype=np.uint32))
    inject = np.zeros((n, 4), dtype=np.uint32)
    if nfull:
        inject[1] = packing.np_bytes_to_words(np.frombuffer(gf.int_to_block(y_aad), np.uint8))
    keep = np.ones(n, dtype=np.uint32)
    keep[0] = 0
    if nfull:
        keep[1] = 0
    return words, ctr.reshape(-1), inject.reshape(-1), keep, nfull


def _gcm_crypt(key: bytes, iv: bytes, aad: bytes, data: bytes, engine: str, direction: str,
               device):
    """Seal/open's shared core: (crypt output bytes, tag)."""
    nr, rk, h, hmat = _key_material(key)
    j0 = _gh.j0_from_iv(h, iv)
    y_aad = _gh.ghash_int(h, _gh.pad16(aad))
    words, ctr, inject, keep, nfull = _gcm_arrays(j0, data, y_aad)
    dev = _aes.as_device(device)
    engine = _aes.resolve_engine(engine, dev)
    n = 1 + nfull
    # GHASH is read at one row, the last full block's (none without one).
    out, ys = gcm_crypt_ghash_words(
        packing.words_tensor(words, dev).reshape(n, 4),
        packing.words_tensor(ctr, dev).reshape(n, 4), packing.words_tensor(rk[None, :], dev),
        torch.zeros(n, dtype=torch.int32, device=dev), hmat[None, :, :],
        packing.words_tensor(inject, dev).reshape(n, 4),
        packing.words_tensor(keep, dev), nr, engine, direction, rows=[nfull] if nfull else [])
    out = packing.words_numpy(out)
    ek_j0 = packing.np_words_to_bytes(out[0])
    full = packing.np_words_to_bytes(out[1:].reshape(-1)).tobytes()
    tail_in = data[16 * nfull:]
    if tail_in:
        # The partial tail block: one more keystream block on the host
        # (inc32^(nfull + 1)(J0)), XORed over the tail's length.
        ks = _gh.np_aes_encrypt_block(nr, rk, _gh.inc32(j0, 1 + nfull))
        tail_out = bytes(np.frombuffer(tail_in, np.uint8) ^ ks[:len(tail_in)])
    else:
        tail_out = b""
    out_bytes = full + tail_out
    ct = out_bytes if direction == SEAL else bytes(data)
    y_int = (gf.block_to_int(packing.np_words_to_bytes(packing.words_numpy(ys[0])))
             if nfull else y_aad)
    tag = _finish_tag(y_int, h, ct[16 * nfull:], len(aad), len(ct), ek_j0)
    return out_bytes, tag


def gcm_seal(key, iv, aad=b"", plaintext=b"", engine: str = "auto",
             device=None) -> tuple[bytes, bytes]:
    """AES-GCM authenticated encryption (SP 800-38D): ``(ciphertext, tag16)``.
    Any plaintext and AAD lengths; a 96-bit IV takes the fast J0 path, any
    other length derives J0 by GHASH. Runs on the card unless ``device``
    says otherwise (``device="cpu"``: the plain versions); ``engine`` as
    ``models.aes.resolve_engine``."""
    key, iv = bytes(bytearray(key)), bytes(bytearray(iv))
    return _gcm_crypt(key, iv, bytes(bytearray(aad)), bytes(bytearray(plaintext)), engine,
                      SEAL, device)


def gcm_open(key, iv, aad, ciphertext, tag, engine: str = "auto", device=None) -> bytes:
    """AES-GCM authenticated decryption: checks the tag (the constant-time
    ``tag_eq_words``) before returning the plaintext, and raises
    ``TagMismatchError`` on a mismatch, never returning any plaintext."""
    key, iv = bytes(bytearray(key)), bytes(bytearray(iv))
    tag = bytes(bytearray(tag))
    pt, want = _gcm_crypt(key, iv, bytes(bytearray(aad)), bytes(bytearray(ciphertext)), engine,
                          OPEN, device)
    if len(tag) != 16 or not bool(tag_eq_words(
            packing.np_bytes_to_words(np.frombuffer(want, np.uint8)),
            packing.np_bytes_to_words(np.frombuffer(tag, np.uint8)))):
        raise TagMismatchError("GCM tag mismatch")
    return pt
