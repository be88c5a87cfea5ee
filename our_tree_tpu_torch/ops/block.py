"""The T-table AES core in plain torch: the port's ``"ttable"`` engine.

Port of ``our_tree_tpu.ops.block`` (the reference's ``"jnp"`` correctness
core): the round structure of the reference C ``AES_FROUND``/``AES_RROUND``
as byte-indexed table gathers, batched over a leading block axis. It runs on
either device and serves as the in-port oracle in tests; ``"auto"`` never
picks it. Its gathers are indexed by key- and data-dependent bytes, so it is
not constant time, as the reference's ``"jnp"`` core is not.

State layout: four int32 columns per block holding u32 LE words.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tables

_TABLES: dict = {}


def _tables(device) -> dict:
    """The tables as int32 tensors on ``device`` (cached)."""
    key = str(device)
    if key not in _TABLES:
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(device)
        _TABLES[key] = {
            "ft": [t(x) for x in (tables.FT0, tables.FT1, tables.FT2, tables.FT3)],
            "rt": [t(x) for x in (tables.RT0, tables.RT1, tables.RT2, tables.RT3)],
            "ftcat": t(np.concatenate([tables.FT0, tables.FT1, tables.FT2, tables.FT3])),
            "fsb": t(tables.SBOX),
            "rsb": t(tables.INV_SBOX),
        }
    return _TABLES[key]


def _tbl(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return t[idx.long()]


def _bytes_of(x: torch.Tensor) -> tuple:
    return x & 0xFF, (x >> 8) & 0xFF, (x >> 16) & 0xFF, (x >> 24) & 0xFF


def _pack_bytes(b0, b1, b2, b3) -> torch.Tensor:
    return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)


def encrypt_words(x: torch.Tensor, rk: torch.Tensor, nr: int) -> torch.Tensor:
    """Encrypt (..., 4) int32 LE words with the (4*(nr+1),) schedule rk."""
    tb = _tables(x.device)
    ft0, ft1, ft2, ft3 = tb["ft"]
    fsb = tb["fsb"]
    a = [x[..., i] ^ rk[i] for i in range(4)]
    for r in range(1, nr):
        k = rk[4 * r: 4 * r + 4]
        b = [_bytes_of(w) for w in a]
        a = [k[j] ^ _tbl(ft0, b[j][0]) ^ _tbl(ft1, b[(j + 1) % 4][1])
             ^ _tbl(ft2, b[(j + 2) % 4][2]) ^ _tbl(ft3, b[(j + 3) % 4][3]) for j in range(4)]
    # Final round: SubBytes + ShiftRows + AddRoundKey, no MixColumns.
    k = rk[4 * nr: 4 * nr + 4]
    b = [_bytes_of(w) for w in a]
    out = [k[j] ^ _pack_bytes(*(_tbl(fsb, b[(j + i) % 4][i]) for i in range(4)))
           for j in range(4)]
    return torch.stack(out, dim=-1)


def encrypt_block_fused(x: torch.Tensor, rk: torch.Tensor, nr: int) -> torch.Tensor:
    """One (4,) block with one gather per round: the 16 T-table indices of a
    round, byte-plane i of word (j + i) mod 4 offset into the concatenated
    (1024,) table, as one vector (the reference's latency form for its
    sequential-mode scans)."""
    tb = _tables(x.device)
    off = torch.arange(4, device=x.device, dtype=torch.int32)

    def rolled_idx(w: torch.Tensor, stride: int) -> torch.Tensor:
        cols = [torch.roll((w >> (8 * i)) & 0xFF, -i) + stride * off[i] for i in range(4)]
        return torch.stack(cols, dim=1).reshape(-1)

    x = x ^ rk[0:4]
    for r in range(1, nr):
        v = _tbl(tb["ftcat"], rolled_idx(x, 256)).reshape(4, 4)
        x = rk[4 * r: 4 * r + 4] ^ v[:, 0] ^ v[:, 1] ^ v[:, 2] ^ v[:, 3]
    sv = _tbl(tb["fsb"], rolled_idx(x, 0)).reshape(4, 4)
    return rk[4 * nr: 4 * nr + 4] ^ _pack_bytes(sv[:, 0], sv[:, 1], sv[:, 2], sv[:, 3])


def decrypt_words(x: torch.Tensor, rk_dec: torch.Tensor, nr: int) -> torch.Tensor:
    """Decrypt (..., 4) int32 LE words with the InvMixColumns-folded
    schedule from ``expand_key_dec``."""
    tb = _tables(x.device)
    rt0, rt1, rt2, rt3 = tb["rt"]
    rsb = tb["rsb"]
    a = [x[..., i] ^ rk_dec[i] for i in range(4)]
    for r in range(1, nr):
        k = rk_dec[4 * r: 4 * r + 4]
        b = [_bytes_of(w) for w in a]
        # Inverse ShiftRows: row i sourced from column (j - i) mod 4.
        a = [k[j] ^ _tbl(rt0, b[j][0]) ^ _tbl(rt1, b[(j + 3) % 4][1])
             ^ _tbl(rt2, b[(j + 2) % 4][2]) ^ _tbl(rt3, b[(j + 1) % 4][3]) for j in range(4)]
    k = rk_dec[4 * nr: 4 * nr + 4]
    b = [_bytes_of(w) for w in a]
    out = [k[j] ^ _pack_bytes(*(_tbl(rsb, b[(j - i) % 4][i]) for i in range(4)))
           for j in range(4)]
    return torch.stack(out, dim=-1)
