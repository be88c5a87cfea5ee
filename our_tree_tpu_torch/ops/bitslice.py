"""Bitsliced AES in plain torch, both directions.

This is the plain version of the CUDA kernels' arithmetic
(``csrc/ctr_gen.cu``, ``csrc/ecb.cu``, ``csrc/ctr_mk.cu``,
``csrc/cbc_mk.cu``): the same functions on whole tensors, used for CPU
tensors and as the kernels' yardstick on the card. Port of
``our_tree_tpu.ops.bitslice`` without its TPU-only boundary layouts
(``grouped``/``dense`` exist for TPU tile padding).

Data layout (the reference's, so tests compare planes directly): N blocks
(N % 32 == 0) become an ``(8, 16, W)`` int32 tensor, W = N/32, where
``planes[b, p, w]`` holds in bit t bit ``b`` of state byte ``p`` of block
``32*w + t``. State byte p is row p%4, column p//4, and word c of a block
holds bytes 4c..4c+3 little-endian. Every mask is 0 or -1 (all 32 bits).

S-box circuits, chosen per call (there is no environment knob):
``"bp"`` is the 115-gate Boyar-Peralta forward circuit the kernels run;
``"tower"`` is the composite-field form (GF(2^8) as GF(2^4)[x], the 4-bit
inverse one tower level further down), whose inverse direction is the
plain version of the ECB decrypt kernel; ``"chain"`` is x^254 by four
multiplies, an independent formulation for cross-checks. Every linear map
is a GF(2) matrix derived at import time from the field arithmetic.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import gf, tables
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


def _gf2_inv(mat: np.ndarray) -> np.ndarray:
    """Invert a GF(2) matrix by Gauss-Jordan elimination."""
    n = mat.shape[0]
    a = np.concatenate([mat.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r, col])
        a[[col, piv]] = a[[piv, col]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] ^= a[col]
    return a[:, n:]


#: Squaring, linear in characteristic 2.
MAT_SQ = _linmat(lambda x: gf.gmul(x, x))

#: The linear part L of the S-box affine layer, S(x) = L(x^-1) ^ 0x63,
#: derived from the S-box table: L(y) = S(y^-1) ^ S(0).
MAT_AFF = _linmat(lambda y: int(tables.SBOX[gf.ginv(y)]) ^ 0x63)
MAT_AFF_INV = _gf2_inv(MAT_AFF)
AFF_CONST = 0x63

#: Constant multipliers: x2 for MixColumns, x4 for the InvMixColumns
#: pre-transform.
MAT_MUL = {c: _linmat(lambda x, c=c: gf.gmul(c, x)) for c in (2, 4)}

#: Reduction of a degree-14 product: REDUCE[k] = x^k mod POLY.
REDUCE = np.array([gf.gpow(2, k) for k in range(15)], dtype=np.uint16)

#: ShiftRows as a permutation of byte positions: new[4c+r] = old[4((c+r)%4)+r];
#: the inverse rotates by -r.
SR_PERM = np.array([4 * ((i // 4 + i % 4) % 4) + i % 4 for i in range(16)])
ISR_PERM = np.array([4 * ((i // 4 - i % 4) % 4) + i % 4 for i in range(16)])

#: ROT_PERM[k][i] = the byte position holding a_(r+k) of byte i's column.
ROT_PERM = [np.array([4 * (i // 4) + (i % 4 + k) % 4 for i in range(16)])
            for k in range(4)]

# ---------------------------------------------------------------------------
# Composite-field ("tower") S-box derivation: GF(2^8) = GF(2^4)[x]/(x^2+x+λ),
# GF(2^4) = GF(2^2)[u]/(u^2+u+Λ), GF(2^2) = GF(2)[w]/(w^2+w+1). λ, Λ, the
# field isomorphisms and every small linear map are searched or derived
# here from the field arithmetic, as in the reference.
# ---------------------------------------------------------------------------

GF16_POLY = 0b10011  # w^4 + w + 1


def _gf16_mul(a: int, b: int) -> int:
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & 0x10:
            a ^= GF16_POLY
    return r & 0xF


def _pick_lambda() -> int:
    """Smallest λ making x^2 + x + λ irreducible over GF(2^4)."""
    for lam in range(1, 16):
        if all(_gf16_mul(r, r) ^ r ^ lam for r in range(16)):
            return lam
    raise AssertionError("no irreducible x^2+x+λ over GF(2^4)")


TOWER_LAMBDA = _pick_lambda()


def _tower_mul(u: int, v: int) -> int:
    """Multiply in GF(2^4)[x]/(x^2+x+λ); byte = (a<<4)|b for a·x+b."""
    a, b, c, d = u >> 4, u & 0xF, v >> 4, v & 0xF
    ac = _gf16_mul(a, c)
    hi = _gf16_mul(a, d) ^ _gf16_mul(b, c) ^ ac
    lo = _gf16_mul(b, d) ^ _gf16_mul(ac, TOWER_LAMBDA)
    return (hi << 4) | lo


def _find_tower_iso() -> np.ndarray:
    """8x8 GF(2) matrix φ with φ(uv) = φ(u)φ(v) into the tower field, from
    discrete logs: 0x03 generates the AES field; for each tower generator
    h, φ(3^k) = h^k is taken if it is linear."""
    log = {}
    v = 1
    for k in range(255):
        log[v] = k
        v = gf.gmul(v, 0x03)
    for h in range(2, 256):
        powers = [1]
        for _ in range(254):
            powers.append(_tower_mul(powers[-1], h))
        if len(set(powers)) != 255:
            continue
        phi = [0] * 256
        for val, k in log.items():
            phi[val] = powers[k]
        m = np.zeros((8, 8), dtype=np.uint8)
        for j in range(8):
            for i in range(8):
                m[i, j] = (phi[1 << j] >> i) & 1
        if all(int(sum(int(b) << i for i, b in enumerate(
                (m @ [(x >> j) & 1 for j in range(8)]) % 2))) == phi[x]
               for x in range(256)):
            return m
    raise AssertionError("no field isomorphism found")


TOWER_ISO = _find_tower_iso()
TOWER_ISO_INV = _gf2_inv(TOWER_ISO)

#: Merged boundary maps: S = Aff∘inv_tower∘φ (+0x63 after);
#: InvS = φ⁻¹∘inv_tower∘φ∘Aff⁻¹ (0x63 XORed before).
M_SBOX_IN = TOWER_ISO
M_SBOX_OUT = (MAT_AFF @ TOWER_ISO_INV) % 2
M_ISBOX_IN = (TOWER_ISO @ MAT_AFF_INV) % 2
M_ISBOX_OUT = TOWER_ISO_INV

MAT_SQ4 = _linmat(lambda x: _gf16_mul(x, x), 4)
MAT_LAMSQ4 = _linmat(lambda x: _gf16_mul(TOWER_LAMBDA, _gf16_mul(x, x)), 4)


def _gf4_mul(a: int, b: int) -> int:
    """GF(2^2) multiply, poly w^2 + w + 1."""
    r = 0
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & 4:
            a ^= 0b111
    return r & 3


def _pick_lambda4() -> int:
    """Λ in GF(2^2) making u^2 + u + Λ irreducible over GF(2^2)."""
    for lam in range(1, 4):
        if all(_gf4_mul(r, r) ^ r ^ lam for r in range(4)):
            return lam
    raise AssertionError("no irreducible u^2+u+Λ over GF(2^2)")


SUB_LAMBDA = _pick_lambda4()


def _pair_mul(u: int, v: int) -> int:
    """Multiply in GF(2^2)[u]/(u^2+u+Λ); nibble = (a<<2)|b for a·u+b."""
    a, b, c, d = u >> 2, u & 3, v >> 2, v & 3
    ac = _gf4_mul(a, c)
    hi = _gf4_mul(a, d) ^ _gf4_mul(b, c) ^ ac
    lo = _gf4_mul(b, d) ^ _gf4_mul(ac, SUB_LAMBDA)
    return (hi << 2) | lo


def _find_sub_iso() -> np.ndarray:
    """4x4 GF(2) matrix ψ with ψ(uv) = ψ(u)ψ(v), GF(16) w-basis -> pair basis."""
    gen = next(g for g in range(2, 16)
               if len({functools.reduce(lambda x, _: _gf16_mul(x, g),
                                        range(k), 1) for k in range(15)}) == 15)
    log = {}
    v = 1
    for k in range(15):
        log[v] = k
        v = _gf16_mul(v, gen)
    for h in range(2, 16):
        powers = [1]
        for _ in range(14):
            powers.append(_pair_mul(powers[-1], h))
        if len(set(powers)) != 15:
            continue
        psi = [0] * 16
        for val, k in log.items():
            psi[val] = powers[k]
        m = np.zeros((4, 4), dtype=np.uint8)
        for j in range(4):
            for i in range(4):
                m[i, j] = (psi[1 << j] >> i) & 1
        if all(int(sum(int(b) << i for i, b in enumerate(
                (m @ [(x >> j) & 1 for j in range(4)]) % 2))) == psi[x]
               for x in range(16)):
            return m
    raise AssertionError("no GF(16) sub-tower isomorphism found")


SUB_ISO = _find_sub_iso()
SUB_ISO_INV = _gf2_inv(SUB_ISO)

#: δ^-1 = δ² and the Λ·x² map over 2-bit planes; MAT_DELTA4 merges the two
#: δ-terms over [hi; lo] into one map.
MAT_SQ2 = _linmat(lambda x: _gf4_mul(x, x), 2)
MAT_LAMSQ2 = _linmat(lambda x: _gf4_mul(SUB_LAMBDA, _gf4_mul(x, x)), 2)
MAT_DELTA4 = np.concatenate([MAT_LAMSQ2, MAT_SQ2], axis=1)


def _apply4(m: np.ndarray, x: int) -> int:
    return int(sum(int(v) << i for i, v in enumerate(
        (m @ [(x >> j) & 1 for j in range(4)]) % 2)))


def _bilinear_reduction(out_map) -> np.ndarray:
    """(4, 16) GF(2) matrix R with out_k = XOR over R[k, 4i+j] of a_i & b_j,
    R[k, 4i+j] = bit k of out_map(i, j): folds a linear map after a GF(16)
    product into the product."""
    m = np.zeros((4, 16), dtype=np.uint8)
    for i in range(4):
        for j in range(4):
            prod = out_map(i, j)
            for k in range(4):
                m[k, 4 * i + j] = (prod >> k) & 1
    return m


#: w-basis x w-basis -> pair-basis product (ψ folded in).
_MUL_W_W_TO_PAIR = _bilinear_reduction(
    lambda i, j: _apply4(SUB_ISO, _gf16_mul(1 << i, 1 << j)))
#: w-basis x pair-basis -> w-basis product (ψ⁻¹ folded in).
_MUL_W_PAIR_TO_W = _bilinear_reduction(
    lambda i, j: _gf16_mul(1 << i, _apply4(SUB_ISO_INV, 1 << j)))

#: [ψ∘λ(·)² | ψ∘(·)²] over the stacked [a; b] planes: ψ(λa² + b²).
MAT_DELTA8 = np.concatenate([(SUB_ISO @ MAT_LAMSQ4) % 2,
                             (SUB_ISO @ MAT_SQ4) % 2], axis=1)

#: x^k mod (w^4 + w + 1) for the 4-bit schoolbook product's degree-6 terms.
GF16_REDUCE = np.array([functools.reduce(lambda v, _: _gf16_mul(v, 2), range(k), 1)
                        for k in range(7)], dtype=np.uint8)

# ---------------------------------------------------------------------------
# Circuit primitives: a "byte" is a list of 8 same-shaped int32 tensors
# (LSB first); every op is elementwise over them.
# ---------------------------------------------------------------------------


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


#: Reductions of schoolbook partials as GF(2) matrices (degree-k term ->
#: output bits), so the XOR trees go through apply_linear.
_RED8 = np.array([[(int(REDUCE[k]) >> i) & 1 for k in range(15)] for i in range(8)],
                 dtype=np.uint8)
_RED4 = np.array([[(int(GF16_REDUCE[k]) >> i) & 1 for k in range(7)] for i in range(4)],
                 dtype=np.uint8)
#: GF(2^2) product as a bilinear reduction: column 2i+j = a_i & b_j.
_MUL_GF4 = np.array([[(_gf4_mul(1 << i, 1 << j) >> k) & 1 for i in range(2) for j in range(2)]
                     for k in range(2)], dtype=np.uint8)


def _schoolbook(a: list, b: list) -> list:
    """Partial products summed by degree: c[k] = XOR of a_i & b_j, i + j = k."""
    c = [None] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            t = x & y
            c[i + j] = t if c[i + j] is None else c[i + j] ^ t
    return c


def gf_mul_planes(a: list, b: list) -> list:
    """Bitsliced GF(2^8) multiply: schoolbook partials + derived reduction."""
    return apply_linear(_RED8, _schoolbook(a, b))


def gf_inv_planes(x: list) -> list:
    """x^254 (x^-1, 0 -> 0) by the 4-multiply addition chain
    254 = 2 + 12 + 240; squarings are linear."""
    sq = functools.partial(apply_linear, MAT_SQ)
    x2 = sq(x)
    x3 = gf_mul_planes(x2, x)
    x12 = sq(sq(x3))
    x15 = gf_mul_planes(x12, x3)
    x240 = sq(sq(sq(sq(x15))))
    x252 = gf_mul_planes(x240, x12)
    return gf_mul_planes(x252, x2)


def gf16_mul_planes(a: list, b: list) -> list:
    """Bitsliced GF(2^4) multiply: 16 ANDs + the derived 7-term reduction."""
    return apply_linear(_RED4, _schoolbook(a, b))


def gf4_mul_planes(a: list, b: list) -> list:
    """Bitsliced GF(2^2) multiply: 4 ANDs + the derived reduction."""
    return apply_linear(_MUL_GF4, [x & y for x in a for y in b])


def _mul16_planes(a: list, b: list, red: np.ndarray) -> list:
    """GF(16) multiply through a folded bilinear reduction (``red`` picks
    the operand and output bases); column 4i+j of ``red`` is a_i & b_j."""
    return apply_linear(red, [x & y for x in a for y in b])


def tower_inv_planes(p: list) -> list:
    """GF(2^8) inversion in the tower basis: p = [b0..b3, a0..a3] for a·x+b.

    (a·x + b)^-1 = aΔ^-1·x + (a+b)Δ^-1 with Δ = λa² + ab + b². Δ^-1 descends
    one more level: over GF(2^2) pairs δ^-1 = δ², a linear map. Three GF(16)
    and three GF(4) multiplies in all."""
    b, a = p[:4], p[4:]
    ab = _mul16_planes(a, b, _MUL_W_W_TO_PAIR)
    dlin = apply_linear(MAT_DELTA8, a + b)
    delta = [dlin[i] ^ ab[i] for i in range(4)]
    lo, hi = delta[:2], delta[2:]
    hl = gf4_mul_planes(hi, lo)
    dlin2 = apply_linear(MAT_DELTA4, hi + lo)
    d = [dlin2[i] ^ hl[i] for i in range(2)]
    dinv = apply_linear(MAT_SQ2, d)
    hi_out = gf4_mul_planes(hi, dinv)
    lo_out = gf4_mul_planes([hi[i] ^ lo[i] for i in range(2)], dinv)
    dinv4 = lo_out + hi_out
    a_out = _mul16_planes(a, dinv4, _MUL_W_PAIR_TO_W)
    b_out = _mul16_planes([a[i] ^ b[i] for i in range(4)], dinv4, _MUL_W_PAIR_TO_W)
    return b_out + a_out


# ---------------------------------------------------------------------------
# S-boxes, MixColumns, rounds.
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


SBOX_IMPLS = ("tower", "bp", "chain")


def sbox_planes(p: list, impl: str = "bp") -> list:
    """Forward S-box on 8 stacked bit planes (LSB first). ``impl`` picks
    the circuit: "bp" (what the kernels run), "tower" or "chain"."""
    if impl == "bp":
        return xor_const(_bp_sbox_core(p), AFF_CONST)
    if impl == "tower":
        t = tower_inv_planes(apply_linear(M_SBOX_IN, p))
        return xor_const(apply_linear(M_SBOX_OUT, t), AFF_CONST)
    if impl == "chain":
        return xor_const(apply_linear(MAT_AFF, gf_inv_planes(p)), AFF_CONST)
    raise ValueError(f"unknown S-box impl {impl!r}; one of {SBOX_IMPLS}")


def inv_sbox_planes(p: list) -> list:
    """Inverse S-box on 8 stacked bit planes in the tower form, the
    reference's default and the plain version of the ECB decrypt kernel
    (which runs an independent formulation: a dedicated circuit around the
    Boyar-Peralta middle, ``ops/xor_programs.py``)."""
    t = apply_linear(M_ISBOX_IN, xor_const(list(p), AFF_CONST))
    return apply_linear(M_ISBOX_OUT, tower_inv_planes(t))


def _perm(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """Static byte-position permutation along the leading axis."""
    return x.index_select(0, torch.as_tensor(idx, device=x.device))


def mixcolumns_planes(p: list) -> list:
    """out_r = 2a_r + 3a_(r+1) + a_(r+2) + a_(r+3) = xt(t) ^ t ^ rot2(t) ^ a
    with t = a ^ rot1(a)."""
    t = [x ^ _perm(x, ROT_PERM[1]) for x in p]
    xt = apply_linear(MAT_MUL[2], t)
    return [xt[i] ^ t[i] ^ _perm(t[i], ROT_PERM[2]) ^ p[i] for i in range(8)]


def inv_mixcolumns_planes(p: list) -> list:
    """out_r = 14a_r + 11a_(r+1) + 13a_(r+2) + 9a_(r+3), as MixColumns of
    the pre-transform d_r = a_r ^ 4(a_r ^ a_(r+2))."""
    t = [x ^ _perm(x, ROT_PERM[2]) for x in p]
    four = apply_linear(MAT_MUL[4], t)
    return mixcolumns_planes([p[i] ^ four[i] for i in range(8)])


def encrypt_round(planes: torch.Tensor, kp: torch.Tensor, last: bool,
                  sbox: str = "bp") -> torch.Tensor:
    """One forward round on (8, 16, W) planes; kp = (8, 16, 1) key masks."""
    p = sbox_planes([planes[i] for i in range(8)], impl=sbox)
    p = [_perm(x, SR_PERM) for x in p]
    if not last:
        p = mixcolumns_planes(p)
    return torch.stack([p[i] ^ kp[i] for i in range(8)])


def decrypt_round(planes: torch.Tensor, kp: torch.Tensor, last: bool) -> torch.Tensor:
    """One inverse round with the InvMixColumns-folded schedule:
    InvSubBytes, InvShiftRows, InvMixColumns unless ``last``, AddRoundKey."""
    p = inv_sbox_planes([planes[i] for i in range(8)])
    p = [_perm(x, ISR_PERM) for x in p]
    if not last:
        p = inv_mixcolumns_planes(p)
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


def multikey_planes(rk_blocks: torch.Tensor, nr: int) -> torch.Tensor:
    """Per-block round keys -> (nr+1, 8, 16, W) key bit planes.

    ``rk_blocks``: (N, 4*(nr+1)) int32, row i = block i's schedule
    (N % 32 == 0). Where ``key_planes`` broadcasts one key as full-lane
    masks, every block may carry its own key here, so round r's key planes
    are ``to_planes`` of the (N, 4) round-r words. The round circuit only
    meets the key in AddRoundKey, so K keys are a change of layout, not of
    formulation."""
    r = rk_blocks.reshape(rk_blocks.shape[0], nr + 1, 4)
    return torch.stack([to_planes(r[:, i, :].contiguous()) for i in range(nr + 1)])


def _pad32(words: torch.Tensor) -> tuple[torch.Tensor, int]:
    n = words.shape[0]
    pad = (-n) % 32
    if pad:
        words = torch.cat([words, words.new_zeros((pad, 4))])
    return words, n


def _crypt_planes(planes: torch.Tensor, kp: torch.Tensor, nr: int, round_fn) -> torch.Tensor:
    planes = planes ^ kp[0]
    for r in range(1, nr):
        planes = round_fn(planes, kp[r], False)
    return round_fn(planes, kp[nr], True)


def encrypt_words(words: torch.Tensor, rk: torch.Tensor, nr: int,
                  sbox: str = "bp") -> torch.Tensor:
    """Bitsliced batch encrypt of (N, 4) int32 LE words with schedule rk."""
    padded, n = _pad32(words)
    round_fn = functools.partial(encrypt_round, sbox=sbox)
    return from_planes(_crypt_planes(to_planes(padded), key_planes(rk, nr), nr, round_fn))[:n]


def decrypt_words(words: torch.Tensor, rk_dec: torch.Tensor, nr: int) -> torch.Tensor:
    """Bitsliced batch decrypt with the InvMixColumns-folded schedule."""
    padded, n = _pad32(words)
    return from_planes(_crypt_planes(to_planes(padded), key_planes(rk_dec, nr), nr,
                                     decrypt_round))[:n]


def encrypt_words_multikey(words: torch.Tensor, rk_blocks: torch.Tensor,
                           nr: int) -> torch.Tensor:
    """Bitsliced batch encrypt where block i uses its own schedule.

    ``rk_blocks``: (N, 4*(nr+1)) int32 per-block round keys (the caller
    gathers them from a (K, 4*(nr+1)) stack by the public slot vector).
    Padding blocks get the all-zero schedule; their output is dropped."""
    padded, n = _pad32(words)
    pad = padded.shape[0] - rk_blocks.shape[0]
    if pad:
        rk_blocks = torch.cat([rk_blocks, rk_blocks.new_zeros((pad, rk_blocks.shape[1]))])
    out = _crypt_planes(to_planes(padded), multikey_planes(rk_blocks, nr), nr, encrypt_round)
    return from_planes(out)[:n]


def decrypt_words_multikey(words: torch.Tensor, rk_blocks: torch.Tensor,
                           nr: int) -> torch.Tensor:
    """Bitsliced batch decrypt where block i uses its own InvMixColumns-folded
    schedule: the decrypt twin of ``encrypt_words_multikey`` (the parallel
    CBC-decrypt serve seam, ``models.aes.cbc_decrypt_words_scattered_multikey``).
    Padding blocks get the all-zero schedule; their output is dropped."""
    padded, n = _pad32(words)
    pad = padded.shape[0] - rk_blocks.shape[0]
    if pad:
        rk_blocks = torch.cat([rk_blocks, rk_blocks.new_zeros((pad, rk_blocks.shape[1]))])
    out = _crypt_planes(to_planes(padded), multikey_planes(rk_blocks, nr), nr, decrypt_round)
    return from_planes(out)[:n]
