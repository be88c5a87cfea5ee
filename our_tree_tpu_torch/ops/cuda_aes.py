"""Fused counter-synthesising AES-CTR: the CUDA kernel's wrapper and its
plain torch version.

The kernel (``csrc/ctr_gen.cu``) replaces the TPU kernel ``_ctr_gen_kernel``
(``our_tree_tpu/ops/pallas_aes.py:601-612``, launched at ``:626``):
``out[j] = data[j] ^ E_K(base + j)`` with ``base`` a 128-bit big-endian
counter given as 4 BE u32 words and the add wrapping mod 2^128. One kernel
serves every layout and engine name of the reference (planes, grouped,
dense; the layouts only existed for TPU tile padding), with the
Boyar-Peralta S-box.

What bounds it on an H100 and what the design does about it: it does about
40 integer logic instructions per byte against 2 bytes of HBM traffic, so
it is bound by integer issue slots, not memory. It is bitsliced (32 blocks
per thread, state in 128 registers) so each logic instruction does 32
blocks of work, and it synthesises counters in registers so that only the
data is read and only the output is written. See the source's header.

``ctr_crypt_words_fused`` launches the kernel for CUDA tensors and raises on
anything it cannot launch; only CPU tensors go to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import bitslice
from ..runtime import cuda_build
from ..utils.packing import ctr_le_blocks

NR_VALUES = (10, 12, 14)


def ctr_crypt_words_fused_plain(words: torch.Tensor, ctr_be: torch.Tensor,
                                rk: torch.Tensor, nr: int) -> torch.Tensor:
    """Plain version: materialise counters, bitsliced encrypt, XOR."""
    idx = torch.arange(words.shape[0], dtype=torch.int64, device=words.device)
    return words ^ bitslice.encrypt_words(ctr_le_blocks(ctr_be, idx), rk, nr)


def _check(words: torch.Tensor, ctr_be: torch.Tensor, rk: torch.Tensor,
           nr: int) -> None:
    if nr not in NR_VALUES:
        raise ValueError(f"nr must be one of {NR_VALUES}, got {nr}")
    for name, t, shape in (("words", words, None), ("ctr_be", ctr_be, (4,)),
                           ("rk", rk, (4 * (nr + 1),))):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != words.device:
            raise ValueError(f"{name} is on {t.device}, words on {words.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if words.dim() != 2 or words.shape[1] != 4:
        raise ValueError(f"words must be (N, 4), got {tuple(words.shape)}")


def ctr_crypt_words_fused(words: torch.Tensor, ctr_be: torch.Tensor,
                          rk: torch.Tensor, nr: int) -> torch.Tensor:
    """CTR over (N, 4) int32 LE block words: block j is XORed with
    E_K(ctr_be + j). ``ctr_be``: (4,) int32 BE counter words, read by the
    kernel through a device pointer (so a chain can carry it on the card);
    ``rk``: (4*(nr+1),) int32 encrypt schedule. Symmetric in direction."""
    _check(words, ctr_be, rk, nr)
    if words.device.type == "cpu":
        return ctr_crypt_words_fused_plain(words, ctr_be, rk, nr)
    if words.device.type != "cuda":
        raise ValueError(f"no CTR kernel for device {words.device}")
    out = torch.empty_like(words)
    n = words.shape[0]
    if n == 0:
        return out
    if words.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned")
    lib = cuda_build.load()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.ot_ctr_gen(words.data_ptr(), out.data_ptr(), ctr_be.data_ptr(),
                            rk.data_ptr(), ctypes.c_longlong(n), nr, stream)
    if rc:
        raise RuntimeError(f"ctr_gen launch failed: cudaError {rc}")
    ctr_crypt_words_fused.launches += 1
    return out


#: Kernel launches since the last reset (the main path's proof of route).
ctr_crypt_words_fused.launches = 0
