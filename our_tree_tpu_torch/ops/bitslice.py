"""Bitsliced AES, forward direction, in plain torch.

This is the plain version of the CUDA kernel's arithmetic
(``csrc/ctr_gen.cu``): the same circuit on whole tensors, used for CPU
tensors and as the kernel's yardstick on the card. Port of the forward
half of ``our_tree_tpu.ops.bitslice``; the tower S-box and the inverse
circuit come with the ECB slice.

Data layout (the reference's, so tests compare planes directly): N blocks
(N % 32 == 0) become an ``(8, 16, W)`` int32 tensor, W = N/32, where
``planes[b, p, w]`` holds in bit t bit ``b`` of state byte ``p`` of block
``32*w + t``. State byte p is row p%4, column p//4, and word c of a block
holds bytes 4c..4c+3 little-endian. Every mask is 0 or -1 (all 32 bits).
"""

from __future__ import annotations

import numpy as np
import torch

from . import gf
from ..utils.packing import i32

# ---------------------------------------------------------------------------
# GF(2) linear maps, derived at import time.
# ---------------------------------------------------------------------------


def _linmat(f, n: int = 8) -> np.ndarray:
    """n x n GF(2) matrix of a linear map on n-bit values: column j = f(1<<j)."""
    m = np.zeros((n, n), dtype=np.uint8)
    for j in range(n):
        v = f(1 << j)
        for i in range(n):
            m[i, j] = (v >> i) & 1
    return m


#: Constant multiplier x2 for MixColumns (x4 joins it with InvMixColumns).
MAT_MUL = {2: _linmat(lambda x: gf.gmul(2, x))}

AFF_CONST = 0x63

#: ShiftRows as a permutation of byte positions: new[4c+r] = old[4((c+r)%4)+r].
SR_PERM = np.array([4 * ((i // 4 + i % 4) % 4) + i % 4 for i in range(16)])

#: ROT_PERM[k][i] = the byte position holding a_(r+k) of byte i's column.
ROT_PERM = [np.array([4 * (i // 4) + (i % 4 + k) % 4 for i in range(16)])
            for k in range(4)]


def _xor_cse_schedule(mat: np.ndarray):
    """Greedy XOR common-subexpression factoring of a GF(2) matrix (Paar):
    repeatedly pull the input pair shared by most rows into a new variable.
    Returns (pair_ops, out_rows) as the reference's function does."""
    rows, cols = mat.shape
    terms = [{j for j in range(cols) if mat[i, j]} for i in range(rows)]
    nvars = cols
    pair_ops = []
    while True:
        counts: dict = {}
        for r in terms:
            rs = sorted(r)
            for x in range(len(rs)):
                for y in range(x + 1, len(rs)):
                    counts[(rs[x], rs[y])] = counts.get((rs[x], rs[y]), 0) + 1
        if not counts:
            break
        (j, k), c = max(counts.items(), key=lambda kv: (kv[1], kv[0]))
        if c < 2:
            break
        pair_ops.append((j, k))
        for r in terms:
            if j in r and k in r:
                r.discard(j)
                r.discard(k)
                r.add(nvars)
        nvars += 1
    return pair_ops, [sorted(r) for r in terms]


_CSE_CACHE: dict = {}


def apply_linear(mat: np.ndarray, p: list) -> list:
    """y_i = XOR of p_j over j with mat[i, j] == 1, as a factored XOR
    network (schedule cached per matrix)."""
    key = (mat.shape, mat.tobytes())
    if key not in _CSE_CACHE:
        _CSE_CACHE[key] = _xor_cse_schedule(mat)
    pair_ops, out_rows = _CSE_CACHE[key]
    v = list(p)
    for j, k in pair_ops:
        v.append(v[j] ^ v[k])
    out = []
    for r in out_rows:
        acc = torch.zeros_like(p[0]) if not r else v[r[0]]
        for j in r[1:]:
            acc = acc ^ v[j]
        out.append(acc)
    return out


def xor_const(p: list, c: int) -> list:
    """XOR a constant byte into every lane: invert the planes where c has a 1."""
    return [~x if (c >> i) & 1 else x for i, x in enumerate(p)]


# ---------------------------------------------------------------------------
# S-box, MixColumns, rounds.
# ---------------------------------------------------------------------------


def _bp_sbox_core(p: list) -> list:
    """Boyar-Peralta forward S-box, minus the final 0x63 complement.

    The 115-gate (32 AND + 83 XOR/XNOR) circuit of Boyar & Peralta, "A new
    combinational logic minimization technique with applications to
    cryptology" (SEA 2010); its XNORs are the 0x63 constant, applied by
    the caller. The circuit's U0/S0 are the byte's MSB while plane lists
    are LSB first, hence the reversed pick-up and return order.
    """
    u0, u1, u2, u3, u4, u5, u6, u7 = reversed(p)
    y14 = u3 ^ u5
    y13 = u0 ^ u6
    y9 = u0 ^ u3
    y8 = u0 ^ u5
    t0 = u1 ^ u2
    y1 = t0 ^ u7
    y4 = y1 ^ u3
    y12 = y13 ^ y14
    y2 = y1 ^ u0
    y5 = y1 ^ u6
    y3 = y5 ^ y8
    t1 = u4 ^ y12
    y15 = t1 ^ u5
    y20 = t1 ^ u1
    y6 = y15 ^ u7
    y10 = y15 ^ t0
    y11 = y20 ^ y9
    y7 = u7 ^ y11
    y17 = y10 ^ y11
    y19 = y10 ^ y8
    y16 = t0 ^ y11
    y21 = y13 ^ y16
    y18 = u0 ^ y16
    t2 = y12 & y15
    t3 = y3 & y6
    t4 = t3 ^ t2
    t5 = y4 & u7
    t6 = t5 ^ t2
    t7 = y13 & y16
    t8 = y5 & y1
    t9 = t8 ^ t7
    t10 = y2 & y7
    t11 = t10 ^ t7
    t12 = y9 & y11
    t13 = y14 & y17
    t14 = t13 ^ t12
    t15 = y8 & y10
    t16 = t15 ^ t12
    t17 = t4 ^ t14
    t18 = t6 ^ t16
    t19 = t9 ^ t14
    t20 = t11 ^ t16
    t21 = t17 ^ y20
    t22 = t18 ^ y19
    t23 = t19 ^ y21
    t24 = t20 ^ y18
    t25 = t21 ^ t22
    t26 = t21 & t23
    t27 = t24 ^ t26
    t28 = t25 & t27
    t29 = t28 ^ t22
    t30 = t23 ^ t24
    t31 = t22 ^ t26
    t32 = t31 & t30
    t33 = t32 ^ t24
    t34 = t23 ^ t33
    t35 = t27 ^ t33
    t36 = t24 & t35
    t37 = t36 ^ t34
    t38 = t27 ^ t36
    t39 = t29 & t38
    t40 = t25 ^ t39
    t41 = t40 ^ t37
    t42 = t29 ^ t33
    t43 = t29 ^ t40
    t44 = t33 ^ t37
    t45 = t42 ^ t41
    z0 = t44 & y15
    z1 = t37 & y6
    z2 = t33 & u7
    z3 = t43 & y16
    z4 = t40 & y1
    z5 = t29 & y7
    z6 = t42 & y11
    z7 = t45 & y17
    z8 = t41 & y10
    z9 = t44 & y12
    z10 = t37 & y3
    z11 = t33 & y4
    z12 = t43 & y13
    z13 = t40 & y5
    z14 = t29 & y2
    z15 = t42 & y9
    z16 = t45 & y14
    z17 = t41 & y8
    t46 = z15 ^ z16
    t47 = z10 ^ z11
    t48 = z5 ^ z13
    t49 = z9 ^ z10
    t50 = z2 ^ z12
    t51 = z2 ^ z5
    t52 = z7 ^ z8
    t53 = z0 ^ z3
    t54 = z6 ^ z7
    t55 = z16 ^ z17
    t56 = z12 ^ t48
    t57 = t50 ^ t53
    t58 = z4 ^ t46
    t59 = z3 ^ t54
    t60 = t46 ^ t57
    t61 = z14 ^ t57
    t62 = t52 ^ t58
    t63 = t49 ^ t58
    t64 = z4 ^ t59
    t65 = t61 ^ t62
    t66 = z1 ^ t63
    s0 = t59 ^ t63
    s6 = t56 ^ t62
    s7 = t48 ^ t60
    t67 = t64 ^ t65
    s3 = t53 ^ t66
    s4 = t51 ^ t66
    s5 = t47 ^ t65
    s1 = t64 ^ s3
    s2 = t55 ^ t67
    return [s7, s6, s5, s4, s3, s2, s1, s0]


def sbox_planes(p: list, impl: str = "bp") -> list:
    """Forward S-box on 8 stacked bit planes (LSB first)."""
    if impl != "bp":
        raise NotImplementedError(f"S-box {impl!r} is ported in a later slice")
    return xor_const(_bp_sbox_core(p), AFF_CONST)


def _perm(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """Static byte-position permutation along the leading axis."""
    return x.index_select(0, torch.as_tensor(idx, device=x.device))


def mixcolumns_planes(p: list) -> list:
    """out_r = 2a_r + 3a_(r+1) + a_(r+2) + a_(r+3) = xt(t) ^ t ^ rot2(t) ^ a
    with t = a ^ rot1(a)."""
    t = [x ^ _perm(x, ROT_PERM[1]) for x in p]
    xt = apply_linear(MAT_MUL[2], t)
    return [xt[i] ^ t[i] ^ _perm(t[i], ROT_PERM[2]) ^ p[i] for i in range(8)]


def encrypt_round(planes: torch.Tensor, kp: torch.Tensor, last: bool,
                  sbox: str = "bp") -> torch.Tensor:
    """One forward round on (8, 16, W) planes; kp = (8, 16, 1) key masks."""
    p = sbox_planes([planes[i] for i in range(8)], impl=sbox)
    p = [_perm(x, SR_PERM) for x in p]
    if not last:
        p = mixcolumns_planes(p)
    return torch.stack([p[i] ^ kp[i] for i in range(8)])


# ---------------------------------------------------------------------------
# Plane <-> word transposition and round-key planes.
# ---------------------------------------------------------------------------


def _transpose32_lead(a: torch.Tensor) -> torch.Tensor:
    """Transpose the 32x32 bit matrix held in the leading axis: out[i] bit t
    == in[t] bit i. A five-stage masked-swap ladder; an involution. The
    arithmetic right shift is safe: each stage's mask keeps only bits below
    32 - j."""
    j, m = 16, 0x0000FFFF
    while j:
        sh = a.shape
        b = a.reshape((32 // (2 * j), 2, j) + tuple(sh[1:]))
        lo, hi = b[:, 0], b[:, 1]
        t = ((lo >> j) ^ hi) & i32(m)
        a = torch.stack([lo ^ (t << j), hi ^ t], dim=1).reshape(sh)
        j >>= 1
        m ^= m << j
    return a


_TO_ROWS = np.array([[8 * (p % 4) + b for p in range(16)] for b in range(8)])
_TO_COLS = np.array([[p // 4 for p in range(16)] for _ in range(8)])
_FROM_B = np.array([[i % 8 for _ in range(4)] for i in range(32)])
_FROM_P = np.array([[4 * c + i // 8 for c in range(4)] for i in range(32)])


def to_planes(words: torch.Tensor) -> torch.Tensor:
    """(N, 4) int32 LE words, N % 32 == 0 -> (8, 16, N/32) planes.

    Column c of a 32-block group is a 32x32 bit matrix (row t = word c of
    block t, bit 8a+b = bit b of byte 4c+a); its transpose has row 8a+b =
    plane (byte 4c+a, bit b) with lane bit t = block t."""
    n = words.shape[0]
    tr = _transpose32_lead(words.reshape(n // 32, 32, 4).permute(1, 2, 0))
    dev = words.device
    return tr[torch.as_tensor(_TO_ROWS, device=dev),
              torch.as_tensor(_TO_COLS, device=dev)]


def from_planes(planes: torch.Tensor) -> torch.Tensor:
    """(8, 16, W) planes -> (32*W, 4) int32 LE words (to_planes inverse)."""
    dev = planes.device
    tr = planes[torch.as_tensor(_FROM_B, device=dev),
                torch.as_tensor(_FROM_P, device=dev)]
    w = planes.shape[-1]
    return _transpose32_lead(tr).permute(2, 0, 1).reshape(32 * w, 4)


def key_planes(rk: torch.Tensor, nr: int) -> torch.Tensor:
    """(4*(nr+1),) int32 round keys -> (nr+1, 8, 16, 1) full-lane bit masks."""
    w = rk.to(torch.int64).reshape(nr + 1, 4) & 0xFFFFFFFF
    sh = torch.arange(4, device=rk.device) * 8
    by = ((w[:, :, None] >> sh[None, None, :]) & 0xFF).reshape(nr + 1, 16)
    bits = (by[:, None, :] >> torch.arange(8, device=rk.device)[None, :, None]) & 1
    return (-bits).to(torch.int32)[..., None]


def encrypt_words(words: torch.Tensor, rk: torch.Tensor, nr: int) -> torch.Tensor:
    """Bitsliced batch encrypt of (N, 4) int32 LE words with schedule rk."""
    n = words.shape[0]
    pad = (-n) % 32
    if pad:
        words = torch.cat([words, words.new_zeros((pad, 4))])
    kp = key_planes(rk, nr)
    p = to_planes(words) ^ kp[0]
    for r in range(1, nr):
        p = encrypt_round(p, kp[r], False)
    return from_planes(encrypt_round(p, kp[nr], True))[:n]
