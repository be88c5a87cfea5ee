"""Byte <-> word packing and 128-bit counter arithmetic.

Every cipher core works on little-endian packed u32 words (block word c
holds bytes 4c..4c+3, byte 4c in the low bits). On the torch side the
words live in ``torch.int32`` tensors carrying the same bits, because
``torch.uint32`` lacks shifts, ``~``, ``+`` and sums on the CPU build.
A right shift on int32 is arithmetic, so every logical shift is masked.

The numpy helpers are host-side and mirror ``our_tree_tpu.utils.packing``.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def i32(v: int) -> int:
    """A u32 bit pattern as the Python int an int32 tensor stores."""
    v &= _M32
    return v - (1 << 32) if v & 0x80000000 else v


def np_bytes_to_words(b: np.ndarray) -> np.ndarray:
    """uint8 array with length % 4 == 0 -> little-endian uint32 words."""
    b = np.ascontiguousarray(b, dtype=np.uint8)
    if b.size % 4:
        raise ValueError("byte length must be a multiple of 4")
    return b.view("<u4").reshape(b.shape[:-1] + (b.shape[-1] // 4,))


def np_words_to_bytes(w: np.ndarray) -> np.ndarray:
    """uint32 words -> little-endian uint8 bytes (a view when possible)."""
    w = np.ascontiguousarray(w, dtype="<u4")
    return w.view(np.uint8).reshape(w.shape[:-1] + (w.shape[-1] * 4,))


def words_tensor(w: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words -> an int32 tensor with the same bits on ``device``."""
    w = np.ascontiguousarray(w, dtype="<u4")
    return torch.from_numpy(w.view(np.int32).copy()).to(device)


def words_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy words with the same bits (a host copy)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def byteswap32(w: torch.Tensor) -> torch.Tensor:
    """Reverse the byte order within each int32 lane (BE <-> LE view)."""
    return (((w & 0xFF) << 24) | ((w & 0xFF00) << 8)
            | ((w >> 8) & 0xFF00) | ((w >> 24) & 0xFF))


def add_counter_be(ctr_be: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """128-bit big-endian add: (4,) BE words + (N,) int64 block offsets.

    Returns (N, 4) int32 BE words. Word 3 is least significant; ``idx``
    is a full 64-bit offset (0 <= idx < 2^63) and the carry ripples
    through all 128 bits, wrapping mod 2^128. Sums go through int64.
    """
    c = ctr_be.to(torch.int64) & _M32
    lo, hi = idx & _M32, idx >> 32
    s3 = c[3] + lo
    s2 = c[2] + hi + (s3 >> 32)
    s1 = c[1] + (s2 >> 32)
    s0 = c[0] + (s1 >> 32)
    s = torch.stack([s0, s1, s2, s3], dim=-1) & _M32
    return (s - ((s & 0x80000000) << 1)).to(torch.int32)


def ctr_le_blocks(ctr_be_words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Counter blocks counter0 + idx as the (N, 4) int32 LE words the
    cipher consumes: the counter's bytes are the BE words' bytes, so each
    word is byteswapped (``our_tree_tpu.models.aes.ctr_le_blocks``)."""
    return byteswap32(add_counter_be(ctr_be_words, idx))


def np_ctr_le_blocks(nonce_counter: np.ndarray | bytes, idx: np.ndarray,
                     out: np.ndarray | None = None) -> np.ndarray:
    """Host-side form of ``ctr_le_blocks``: counter blocks ``nonce + idx``
    as (N, 4) uint32 LE words (``our_tree_tpu.utils.packing``'s). The serve
    batcher builds each request's counters with it, straight into its batch
    array through ``out``; when the low counter word never wraps (the common
    case) the upper words are one broadcast and only the low word is per
    block. ``nonce_counter``: the 16 big-endian counter bytes; ``idx``: (N,)
    offsets below 2^32."""
    b = np.frombuffer(bytes(nonce_counter), dtype=np.uint8)
    if b.size != 16:
        raise ValueError("nonce_counter must be 16 bytes")
    ctr_be = np_bytes_to_words(b).byteswap()  # (4,) big-endian words
    ctr_le = ctr_be.byteswap()                # the same words, LE view
    idx = np.asarray(idx, dtype=np.uint32).reshape(-1)
    if out is None:
        out = np.empty((idx.size, 4), dtype=np.uint32)
    with np.errstate(over="ignore"):  # 128-bit ripple: word wrap intended
        s3 = (ctr_be[3] + idx).astype(np.uint32)
        wrapped = s3 < idx
        if wrapped.any():
            c3 = wrapped.astype(np.uint32)
            s2 = (ctr_be[2] + c3).astype(np.uint32)
            c2 = c3 & (s2 == 0)
            s1 = (ctr_be[1] + c2).astype(np.uint32)
            c1 = c2 & (s1 == 0)
            s0 = (ctr_be[0] + c1).astype(np.uint32)
            out[:, 0] = s0.byteswap()
            out[:, 1] = s1.byteswap()
            out[:, 2] = s2.byteswap()
        else:
            out[:] = ctr_le
        out[:, 3] = s3.byteswap()
    return out
