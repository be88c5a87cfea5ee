"""The T-table AES core in plain torch: the port's ``"ttable"`` engine.

Port of ``our_tree_tpu.ops.block`` (the reference's ``"jnp"`` correctness
core): the round structure of the reference C ``AES_FROUND``/``AES_RROUND``
as byte-indexed table gathers, batched over a leading block axis. It runs on
either device and serves as the in-port oracle in tests; ``"auto"`` never
picks it. Its gathers are indexed by key- and data-dependent bytes, so it is
not constant time, as the reference's ``"jnp"`` core is not.

State layout: four int32 columns per block holding u32 LE words.

``seq_encrypt_host`` is the engine's chained CBC/CFB128 encrypt on the CPU:
the same rounds over Python integers, a block at a time. A recurrence runs
one block a step, where a batched torch call costs milliseconds of
dispatch for one block; this loop costs tens of microseconds.
``python -m our_tree_tpu_torch.ops.block`` times both on one 64 KiB CBC
stream on the CPU.
"""

from __future__ import annotations

import sys
import time

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


def _host_tables() -> tuple:
    if "host" not in _TABLES:
        _TABLES["host"] = (tuple(tables.FT0.tolist()), tuple(tables.FT1.tolist()),
                           tuple(tables.FT2.tolist()), tuple(tables.FT3.tolist()),
                           tuple(tables.SBOX.tolist()))
    return _TABLES["host"]


def _encrypt_host(a: list, rk: list, nr: int, t: tuple) -> list:
    """One block of four u32 words (Python ints) through the rounds."""
    ft0, ft1, ft2, ft3, sb = t
    a0, a1, a2, a3 = a[0] ^ rk[0], a[1] ^ rk[1], a[2] ^ rk[2], a[3] ^ rk[3]
    for r in range(4, 4 * nr, 4):
        a0, a1, a2, a3 = (
            rk[r] ^ ft0[a0 & 255] ^ ft1[(a1 >> 8) & 255] ^ ft2[(a2 >> 16) & 255] ^ ft3[a3 >> 24],
            rk[r + 1] ^ ft0[a1 & 255] ^ ft1[(a2 >> 8) & 255] ^ ft2[(a3 >> 16) & 255]
            ^ ft3[a0 >> 24],
            rk[r + 2] ^ ft0[a2 & 255] ^ ft1[(a3 >> 8) & 255] ^ ft2[(a0 >> 16) & 255]
            ^ ft3[a1 >> 24],
            rk[r + 3] ^ ft0[a3 & 255] ^ ft1[(a0 >> 8) & 255] ^ ft2[(a1 >> 16) & 255]
            ^ ft3[a2 >> 24])
    k = 4 * nr
    w = (a0, a1, a2, a3)
    return [rk[k + j] ^ (sb[w[j] & 255] | sb[(w[(j + 1) % 4] >> 8) & 255] << 8
                         | sb[(w[(j + 2) % 4] >> 16) & 255] << 16 | sb[w[(j + 3) % 4] >> 24] << 24)
            for j in range(4)]


def seq_encrypt_host(words: torch.Tensor, ivs: torch.Tensor, rk: torch.Tensor, nr: int,
                     cfb: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """S chained encrypts of N blocks on the CPU: CBC, C_i = E(P_i ^
    C_(i-1)), or with ``cfb`` CFB128, C_i = P_i ^ E(C_(i-1)); ``words``
    (S, N, 4) and ``ivs`` (S, 4) int32 CPU tensors. Returns (ciphertext,
    last block per stream)."""
    t = _host_tables()
    keys = rk.numpy().view(np.uint32).tolist()
    w = words.numpy().view(np.uint32)
    out = np.empty_like(w)
    last = ivs.numpy().view(np.uint32).copy()
    for si in range(w.shape[0]):
        iv = last[si].tolist()
        rows = w[si].tolist()
        for i, p in enumerate(rows):
            if cfb:
                e = _encrypt_host(iv, keys, nr, t)
                iv = [p[j] ^ e[j] for j in range(4)]
            else:
                iv = _encrypt_host([p[j] ^ iv[j] for j in range(4)], keys, nr, t)
            out[si, i] = iv
        last[si] = iv
    return torch.from_numpy(out.view(np.int32)), torch.from_numpy(last.view(np.int32))


def main(argv: list[str]) -> int:
    """Time one CBC pass over ``argv[0]`` bytes (default 64 KiB) on the CPU,
    one thread: the per-block torch loop over ``encrypt_words`` against
    ``seq_encrypt_host``, checked equal."""
    nbytes = int(argv[0]) if argv else 1 << 16
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)

    def words(*shape):
        return torch.from_numpy(rng.integers(0, 1 << 32, shape, dtype=np.uint64)
                                .astype(np.uint32).view(np.int32))

    nr, rk, w, iv = 10, words(44), words(1, nbytes // 16, 4), words(1, 4)

    def torch_loop():
        ivb, outs = iv, []
        for i in range(w.shape[1]):
            ivb = encrypt_words((w[:, i] ^ ivb).contiguous(), rk, nr)
            outs.append(ivb)
        return torch.stack(outs, dim=1), ivb

    results = []
    for name, fn in (("per-block torch loop", torch_loop),
                     ("seq_encrypt_host", lambda: seq_encrypt_host(w, iv, rk, nr, False))):
        t0 = time.perf_counter()
        results.append(fn())
        dt = time.perf_counter() - t0
        print(f"{name}: {dt:.3f} s a {nbytes}-byte CBC pass, "
              f"{1e6 * dt * 16 / nbytes:.1f} us a block")
    same = all(torch.equal(a, b) for a, b in zip(*results))
    print("equal" if same else "DIFFER")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
