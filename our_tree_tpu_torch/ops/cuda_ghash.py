"""The GHASH kernels' wrappers and their plain torch versions.

``ghash_scan`` and ``ghash_at`` launch ``csrc/ghash.cu``: the segmented
Horner recurrence of GCM's GHASH over (N, 4) int32 LE block words,

    y_j = H_{s_j} * ((y_{j-1} * keep_j) ^ x_j),   y_{-1} = y0,

in GF(2^128) (only the low bit of ``keep_j`` counts). ``ghash_scan`` returns
every row's y; ``ghash_at`` returns y at the named rows only, which is what
a seal, an open and ``ghash_words`` read (one row each). They are the
counterpart of the JAX package's ``lax.scan`` of a 128 x 128 GF(2) bit-matrix
product a row (``our_tree_tpu/aead/gcm.py:118-143``, and ``ghash_words`` at
``:94-104``), which is an XLA loop, not a Pallas kernel. The kernel runs the
scan in parallel within a segment as a scan over the rows' affine maps
(``ghash_at`` in two launches, ``ghash_scan`` in three; its source has the
design), its field products on integer multiplies.

H is given as field elements, one (4,) row of words a key (``hkeys``, the
block bytes of H = E_K(0^128) packed as LE words); the kernel prepares each
key's H from it. ``h_matrices`` derives the (K, 128, 128) multiply-by-H
matrices in torch for the plain version.

``ghash_scan_plain`` is the plain version: a row loop of float32 matrix
products on 0/1 values (exact: a sum holds at most 128 ones), since torch has
no integer matrix product on CUDA; ``ghash_at_plain`` is its rows at the
named rows. The CPU tests use them, and ``chip_smoke.py`` holds the kernels
against them on the card; nothing on the card's path does.

The wrappers launch the kernel for CUDA tensors and raise on anything they
cannot launch; only CPU tensors go to the plain versions. Each counts its
calls in ``.launches`` (one a call: a call's grid launches count once).
"""

from __future__ import annotations

import ctypes

import torch

from ..runtime import cuda_build
from .cuda_aes import MK_MAX_SLOTS, count_launch

_SHIFTS = torch.arange(32, dtype=torch.int64)


def bits_of(w: torch.Tensor) -> torch.Tensor:
    """(N, 4) int32 block words -> (N, 128) 0/1 int64 bits in word-bit order
    (bit k = bit k % 32 of word k // 32)."""
    return ((w.to(torch.int64)[:, :, None] >> _SHIFTS.to(w.device)) & 1).reshape(w.shape[0], 128)


def words_of(bits: torch.Tensor) -> torch.Tensor:
    """(N, 128) 0/1 bits in word-bit order -> (N, 4) int32 block words."""
    v = (bits.to(torch.int64).reshape(-1, 4, 32) << _SHIFTS.to(bits.device)).sum(-1)
    return (v - ((v & 0x80000000) << 1)).to(torch.int32)


def h_matrices(hkeys: torch.Tensor) -> torch.Tensor:
    """(K, 128, 128) float32 0/1 multiply-by-H matrices in the word-bit basis
    from (K, 4) int32 H words: column k is e_k * H, e_k the element whose
    only set word-bit is k (``ops.gf.gf128_mul_matrix_words``). Word-bit k is
    the coefficient of x^(k ^ 7), so the columns are x^p * H for p < 128, by
    doublings: a shift up by one coefficient, the one that leaves x^127
    folded back onto x^7, x^2, x and 1."""
    perm = torch.arange(128, device=hkeys.device) ^ 7
    v = bits_of(hkeys)[:, perm]  # polynomial basis: bit p is x^p's coefficient
    cols = []
    for _ in range(128):
        cols.append(v[:, perm])
        top = v[:, 127:]
        v = torch.cat([torch.zeros_like(top), v[:, :127]], dim=1)
        v[:, [0, 1, 2, 7]] ^= top
    m = torch.stack(cols, dim=2)  # [:, i, p]: bit i of x^p * H
    return m[:, :, perm].to(torch.float32)


def ghash_scan_plain(x: torch.Tensor, hkeys: torch.Tensor, key_slots: torch.Tensor,
                     seg_keep: torch.Tensor, y0: torch.Tensor,
                     inject: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``ghash_scan``: the recurrence row by row, each
    multiply a float32 matrix product of the row's key's ``h_matrices`` with
    the state's bits, mod 2."""
    if inject is not None:
        x = x ^ inject
    m = h_matrices(hkeys)
    xb = bits_of(x).to(torch.float32)
    keep = (seg_keep.to(torch.int64) & 1).to(torch.float32)
    slots = key_slots.to(torch.int64)
    y = bits_of(y0.reshape(1, 4))[0].to(torch.float32)
    ys = torch.empty_like(xb)
    for j in range(x.shape[0]):
        v = torch.remainder(y * keep[j] + xb[j], 2)
        y = torch.remainder(m[slots[j]] @ v, 2)
        ys[j] = y
    return words_of(ys)


def ghash_at_plain(x: torch.Tensor, hkeys: torch.Tensor, key_slots: torch.Tensor,
                   seg_keep: torch.Tensor, y0: torch.Tensor, rows_out,
                   inject: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``ghash_at``: ``ghash_scan_plain``'s rows at
    ``rows_out`` (a sequence or an int64 tensor)."""
    rows = torch.as_tensor(rows_out, dtype=torch.int64).reshape(-1).to(x.device)
    return ghash_scan_plain(x, hkeys, key_slots, seg_keep, y0, inject)[rows]


def _check(x: torch.Tensor, hkeys: torch.Tensor, key_slots: torch.Tensor,
           seg_keep: torch.Tensor, y0: torch.Tensor, inject: torch.Tensor | None) -> None:
    n = x.shape[0] if x.dim() == 2 else -1
    shapes = {"x": (x, (n, 4)), "hkeys": (hkeys, None), "key_slots": (key_slots, (n,)),
              "seg_keep": (seg_keep, (n,)), "y0": (y0, (4,))}
    if inject is not None:
        shapes["inject"] = (inject, (n, 4))
    for name, (t, shape) in shapes.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if x.dim() != 2 or x.shape[1] != 4:
        raise ValueError(f"x must be (N, 4), got {tuple(x.shape)}")
    if hkeys.dim() != 2 or hkeys.shape[1] != 4 or not 1 <= hkeys.shape[0] <= MK_MAX_SLOTS:
        raise ValueError(f"hkeys must be (K, 4) with 1 <= K <= {MK_MAX_SLOTS}, "
                         f"got {tuple(hkeys.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")


def ghash_scan(x: torch.Tensor, hkeys: torch.Tensor, key_slots: torch.Tensor,
               seg_keep: torch.Tensor, y0: torch.Tensor,
               inject: torch.Tensor | None = None) -> torch.Tensor:
    """The segmented GHASH over (N, 4) int32 LE block words ``x`` (XOR
    ``inject``, (N, 4), where given): every row's state y as (N, 4) int32
    words. ``hkeys``: (K, 4) int32 H words, 1 <= K <= ``MK_MAX_SLOTS``;
    ``key_slots``: (N,) int32 public slot indices, each below K (checked on
    the CPU; the kernel clamps a bad one into range); ``seg_keep``: (N,)
    int32, 0 where the carry restarts; ``y0``: (4,) int32 state before row 0.
    N = 0 launches nothing."""
    _check(x, hkeys, key_slots, seg_keep, y0, inject)
    n, k = x.shape[0], hkeys.shape[0]
    if x.device.type == "cpu":
        if n and (int(key_slots.min()) < 0 or int(key_slots.max()) >= k):
            raise ValueError(f"key_slots must lie in [0, {k})")
        return ghash_scan_plain(x, hkeys, key_slots, seg_keep, y0, inject)
    out = torch.empty_like(x)
    if n == 0:
        return out
    _launch(ghash_scan, "ot_ghash_scan", x, hkeys, key_slots, seg_keep, y0, inject, out, -1,
            (out,))
    return out


def ghash_at(x: torch.Tensor, hkeys: torch.Tensor, key_slots: torch.Tensor,
             seg_keep: torch.Tensor, y0: torch.Tensor, rows_out,
             inject: torch.Tensor | None = None) -> torch.Tensor:
    """``ghash_scan``'s rows at ``rows_out`` only, as (E, 4) int32 words:
    ``rows_out`` is E sorted row indices in [0, N) (a sequence, or an int64
    tensor; public, like the slots). Arguments otherwise as ``ghash_scan``;
    E = 0 launches nothing. On the card the kernel runs one product a row
    and never materialises the other rows (two launches)."""
    _check(x, hkeys, key_slots, seg_keep, y0, inject)
    n, k = x.shape[0], hkeys.shape[0]
    rows = torch.as_tensor(rows_out, dtype=torch.int64).reshape(-1)
    e = rows.shape[0]
    if x.device.type == "cpu":
        if e and (bool((rows[1:] < rows[:-1]).any()) or int(rows[0]) < 0
                  or int(rows[-1]) >= n):
            raise ValueError(f"rows_out must be sorted and lie in [0, {n})")
        if n and (int(key_slots.min()) < 0 or int(key_slots.max()) >= k):
            raise ValueError(f"key_slots must lie in [0, {k})")
        return ghash_at_plain(x, hkeys, key_slots, seg_keep, y0, rows, inject)
    out = torch.empty((e, 4), dtype=torch.int32, device=x.device)
    if e == 0:
        return out
    rows = rows.to(x.device).contiguous()
    _launch(ghash_at, "ot_ghash_at", x, hkeys, key_slots, seg_keep, y0, inject, out, e,
            (rows, out))
    return out


def _launch(wrapper, fn: str, x, hkeys, key_slots, seg_keep, y0, inject, out, n_named: int,
            outs: tuple) -> None:
    """Launch C entry ``fn`` (``ot_ghash_scan``: ``n_named`` -1, ``outs``
    (out,); ``ot_ghash_at``: ``outs`` (rows_out, out)) on the card with
    scratch of its own, and count the call on ``wrapper``; raises if the
    launch failed."""
    n, k = x.shape[0], hkeys.shape[0]
    if any(t.data_ptr() % 16 for t in (x, out) + (() if inject is None else (inject,))):
        raise ValueError("block words must be 16-byte aligned")
    lib = cuda_build.load()
    words = lib.ot_ghash_scratch_words(ctypes.c_longlong(n), k, ctypes.c_longlong(n_named))
    scratch = torch.empty(words, dtype=torch.int32, device=x.device)
    sizes = (ctypes.c_longlong(n),) + (() if n_named < 0 else (ctypes.c_longlong(n_named),))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = getattr(lib, fn)(x.data_ptr(), None if inject is None else inject.data_ptr(),
                              key_slots.data_ptr(), seg_keep.data_ptr(), hkeys.data_ptr(),
                              y0.data_ptr(), *(t.data_ptr() for t in outs), scratch.data_ptr(),
                              *sizes, k, stream)
    if rc:
        raise RuntimeError(f"{fn} launch failed: cudaError {rc}")
    count_launch(wrapper)


def plan(n: int, k: int) -> tuple[int, int]:
    """(rows a thread, thread blocks) of the kernel's launches for N = ``n``
    rows and K = ``k`` keys, as its C entry decides them."""
    out = (ctypes.c_longlong * 2)()
    cuda_build.load().ot_ghash_plan(ctypes.c_longlong(n), k, out)
    return out[0], out[1]


#: Calls that launched the kernel since the last reset (the main path's proof
#: of route).
ghash_scan.launches = 0
ghash_at.launches = 0
