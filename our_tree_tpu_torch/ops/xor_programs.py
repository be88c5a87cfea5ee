"""Straight-line XOR programs for the ECB decrypt kernel's linear layers,
derived from the forward circuit and checked on the host.

The decrypt kernel (``csrc/ecb.cu``, ``ecb_decrypt_kernel``) runs a
dedicated bitsliced inverse S-box and a dedicated InvMixColumns
(``csrc/aes_inv_bitslice.cuh``). Both are derived here, as C, from the
forward circuit in ``csrc/aes_bitslice.cuh`` and from the field; no inverse
circuit is taken from the literature.

Inverse S-box. The Boyar-Peralta forward circuit (``sbox_bp_circuit`` in
``csrc/aes_bitslice.cuh``, whose output without the 0x63 is A(x^-1)) splits
into a top linear layer U (the byte's 8 bits to the 22 signals ``u7``,
``y1``..``y21``), a nonlinear middle M of 62 gates (to the 18 products
``z0``..``z17``) and a bottom linear layer B (to the 8 output bits). With
A^-1 the linear part of the inverse affine map and A^-1(0x63) = 0x05,

    InvS(y) = (A^-1 (y ^ 0x63))^-1 = A^-1 B M(U(A^-1 y ^ 0x05)),

so U' = U A^-1 (8 inputs to 22 outputs, the constant turned into NOTs on
the signals it reaches) and B' = A^-1 B (18 inputs to 8 outputs, no
constant) are new linear layers around the same middle. They are found by
the distance-guided greedy search of Boyar and Peralta (cancellation
allowed; "A new combinational logic minimization technique with
applications to cryptology", SEA 2010, and "A depth-16 circuit for the AES
S-box", 2012), with the cost counted in steps that XOR two or three earlier
signals: on Hopper one LOP3 instruction computes any function of three
registers, so a step is one instruction. Maximov and Ekdahl ("New circuit
minimization techniques for smaller and faster AES SBoxes", TCHES 2019(4))
carry the same line further for both directions.

InvMixColumns. ``out_r = 14a_r ^ 11a_(r+1) ^ 13a_(r+2) ^ 9a_(r+3) ^ k_r`` is
a 32 x 64 GF(2) matrix over one column's 32 state planes and its 32 round-key
planes, synthesised by Paar's cancellation-free greedy ("Optimized
arithmetic for Reed-Solomon encoders", ISIT 1997), scored in the same
3-input steps. Each key plane reaches one output only, so the AddRoundKey
lands in the last step of each output plane.

``python -m our_tree_tpu_torch.ops.xor_programs`` prints the generated C
blocks; ``--check`` compares them with the header's and checks the circuits
over all 256 bytes and on random columns. ``tests/test_torch_ecb_host.py``
holds the header's blocks equal to this module's output.
"""

from __future__ import annotations

import itertools
import random
import re
import sys
from pathlib import Path

import numpy as np

from . import gf, tables

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: Seeds of the searches' tie-breaks: the first of 0..7 (S-box layers) or of
#: 0..399 (InvMixColumns) that gives the fewest steps.
SEED_TOP, SEED_BOTTOM, SEED_INV_MIX = 0, 0, 304
#: The inverse affine map's linear part: out bit i = x[i-1] ^ x[i-3] ^ x[i-6].
A_INV_TAPS = (1, 3, 6)
A_INV_CONST = 0x05
#: InvMixColumns' coefficients of a_r, a_(r+1), a_(r+2), a_(r+3).
INV_MIX_COEFS = (14, 11, 13, 9)
BEGIN = "// BEGIN GENERATED by python -m our_tree_tpu_torch.ops.xor_programs ({name})"
END = "// END GENERATED ({name})"


# ---------------------------------------------------------------------------
# The forward circuit, read from the header.
# ---------------------------------------------------------------------------


def forward_sbox_statements() -> list[tuple[str, str, str, str]]:
    """The 115 gates of ``sbox_bp_circuit`` as (dst, a, op, b), op in {"^", "&"}."""
    text = (CSRC / "aes_bitslice.cuh").read_text()
    start = text.index("void sbox_bp_circuit")
    body = text[start:text.index("// Outputs LSB first", start)]
    stmts = re.findall(r"(\w+) = (\w+) ([\^&]) (\w+)", body)
    if len(stmts) != 115:
        raise ValueError(f"expected 115 gates in sbox_bp_circuit, found {len(stmts)}")
    return stmts


def forward_layers():
    """(top, middle, bottom) of the forward circuit: ``top`` maps each of the
    middle's 22 input signals to its mask over the byte's bits (bit i = plane
    x[i]); ``middle`` is the middle's gates in order; ``bottom[i]`` is output
    plane i (LSB first, before the 0x63) as a mask over z0..z17."""
    stmts = forward_sbox_statements()
    val: dict[str, int | None] = {f"u{i}": 1 << (7 - i) for i in range(8)}
    middle = []
    for d, a, op, b in stmts:
        va, vb = val.get(a), val.get(b)
        if op == "&":
            val[d] = 1 << (8 + int(d[1:])) if d.startswith("z") else None
            middle.append((d, a, op, b))
        elif va is None or vb is None:
            val[d] = None
            middle.append((d, a, op, b))
        else:
            val[d] = va ^ vb
    free = {s for _d, a, _op, b in middle for s in (a, b)} - {d for d, *_ in middle}
    top = {n: val[n] for n in sorted(free, key=lambda n: (n[0], int(n[1:])))}
    if len(top) != 22 or any(v is None or v >> 8 for v in top.values()):
        raise ValueError(f"the middle's inputs are not 22 linear signals: {sorted(free)}")
    bottom = [val[f"s{7 - i}"] >> 8 for i in range(8)]
    return top, middle, bottom


def _a_inv(mask: int) -> int:
    """A linear form over A^-1's outputs, rewritten over its inputs."""
    out = 0
    for i in range(8):
        if mask >> i & 1:
            for k in A_INV_TAPS:
                out ^= 1 << ((i - k) % 8)
    return out


def inverse_layers():
    """(top', middle, bottom'): U' = U A^-1 as {name: (mask over the input
    byte's bits, NOT?)}, the forward middle unchanged, B' = A^-1 B as 8
    masks over z0..z17."""
    top, middle, bottom = forward_layers()
    top_inv = {n: (_a_inv(m), bin(m & A_INV_CONST).count("1") & 1) for n, m in top.items()}
    bottom_inv = [bottom[(i - 1) % 8] ^ bottom[(i - 3) % 8] ^ bottom[(i - 6) % 8]
                  for i in range(8)]
    return top_inv, middle, bottom_inv


# ---------------------------------------------------------------------------
# The two searches. A program is a list of steps (vector, sources): vector a
# mask over the inputs, sources the indices of 2 or 3 earlier signals
# (inputs first, then the steps in order).
# ---------------------------------------------------------------------------


def _xor_of(signals: list[int], idx) -> int:
    v = 0
    for i in idx:
        v ^= signals[i]
    return v


def distance_search(targets: list[int], nbits: int, seed: int) -> list[tuple[int, tuple]]:
    """Boyar-Peralta's distance-guided greedy, 3-input steps, cancellation
    allowed. ``w[v]`` is the fewest signals whose XOR is v, so a target is
    ``w // 2`` steps away. A target at most three signals away is made at
    once; otherwise the step that most lowers the summed distance is taken,
    ties broken by the larger sum of squared distances (Boyar-Peralta's
    rule), then by the seeded generator."""
    rng = random.Random(seed)
    idx = np.arange(1 << nbits, dtype=np.int64)
    signals = [1 << i for i in range(nbits)]
    w = np.full(1 << nbits, 99, np.int16)
    w[0] = 0
    for s in signals:  # adding signal s: w[v] = min(w[v], w[v ^ s] + 1), exact
        w = np.minimum(w, w[idx ^ s] + 1)
    prog: list[tuple[int, tuple]] = []
    todo = [t for t in dict.fromkeys(targets) if t not in signals]

    def add(v: int, src: tuple) -> None:
        nonlocal w
        signals.append(v)
        prog.append((v, src))
        w = np.minimum(w, w[idx ^ v] + 1)

    while todo:
        have = set(signals)
        combos = {}
        for k in (2, 3):
            for c in itertools.combinations(range(len(signals)), k):
                v = _xor_of(signals, c)
                if v and v not in have and v not in combos:
                    combos[v] = c
        direct = [t for t in todo if t in combos]
        if direct:
            t = direct[0] if len(direct) == 1 else rng.choice(direct)
        else:
            tv = np.array(todo, np.int64)
            cand = np.array(list(combos), np.int64)
            dist = np.minimum(w[tv][None, :], w[tv[None, :] ^ cand[:, None]] + 1) // 2
            total, norm = dist.sum(1), (dist.astype(np.int64) ** 2).sum(1)
            sel = np.flatnonzero(total == total.min())
            sel = sel[norm[sel] == norm[sel].max()]
            t = int(cand[sel[rng.randrange(sel.size)]])
        add(t, combos[t])
        todo = [x for x in todo if x != t]
    return prog


def paar_search(rows: list[int], n_inputs: int, seed: int):
    """Paar's cancellation-free greedy in 3-input steps. Each row is a set of
    signals whose XOR it is; a new signal replaces a pair or a triple in
    every row that holds it. A triple saves a step in each such row, a pair
    only in rows of even weight (w signals alone take w // 2 steps), and the
    new signal costs one; the best saving is taken while it is positive,
    ties broken by the seeded generator. Returns (shared steps, rows as the
    signal indices left for each row's own final steps)."""
    rng = random.Random(seed)
    terms = [{j for j in range(n_inputs) if r >> j & 1} for r in rows]
    signals = [1 << j for j in range(n_inputs)]
    prog: list[tuple[int, tuple]] = []
    while True:
        gain: dict[tuple, int] = {}
        for t in terms:
            s = sorted(t)
            for c in itertools.combinations(s, 3):
                gain[c] = gain.get(c, 0) + 1
            if len(s) % 2 == 0:
                for c in itertools.combinations(s, 2):
                    gain[c] = gain.get(c, 0) + 1
        best = max(gain.values(), default=0)
        if best < 2:
            break
        c = rng.choice(sorted(k for k, v in gain.items() if v == best))
        n = len(signals)
        signals.append(_xor_of(signals, c))
        prog.append((signals[-1], c))
        for t in terms:
            if t.issuperset(c):
                t.difference_update(c)
                t.add(n)
    return prog, [sorted(t) for t in terms]


def steps_of(prog, finals=()) -> int:
    """3-input steps of a program plus its rows' own final steps."""
    return len(prog) + sum(len(f) // 2 for f in finals)


# ---------------------------------------------------------------------------
# C emission.
# ---------------------------------------------------------------------------


def _xor(args: list[str], negate: bool = False) -> str:
    """One step in C: two inputs as ``^`` (``~`` for a NOT), three as the
    header's ``xor3``/``xnor3``, one inline-PTX LOP3 each."""
    if len(args) == 2:
        return f"~({args[0]} ^ {args[1]})" if negate else f"{args[0]} ^ {args[1]}"
    if len(args) != 3:
        raise ValueError(f"a step takes 2 or 3 inputs, not {args}")
    return f"{'xnor3' if negate else 'xor3'}({', '.join(args)})"


def _emit_consts(decls: list[str], per_line: int = 3) -> list[str]:
    return ["  const uint32_t " + ", ".join(decls[i:i + per_line]) + ";"
            for i in range(0, len(decls), per_line)]


def inv_sbox_program():
    """(U' program, B' program) of the dedicated inverse S-box."""
    top, _middle, bottom = inverse_layers()
    up = distance_search([m for m, _c in top.values()], 8, SEED_TOP)
    bp = distance_search(bottom, 18, SEED_BOTTOM)
    return up, bp


def inv_sbox_c() -> str:
    """The body of ``inv_sbox``: x[0..7] in, InvS(x) out, in place."""
    top, middle, bottom = inverse_layers()
    up, bp = inv_sbox_program()
    by_vec = {m: (n, c) for n, (m, c) in top.items()}
    lines = [f"  // U' = U A^-1: {len(up)} steps to the middle's 22 inputs; the 0x05 of "
             "the inverse",
             "  // affine map is a NOT (~, xnor3) on the signals it reaches, free in a LOP3."]
    names = [f"x[{i}]" for i in range(8)]
    consts = [0] * 8
    decls = []
    for k, (v, src) in enumerate(up):
        name, want = by_vec.get(v, (f"h{k}", None))
        c = 0
        for i in src:
            c ^= consts[i]
        flip = want is not None and want != c
        if flip:
            c = want
        decls.append(f"{name} = {_xor([names[i] for i in src], flip)}")
        names.append(name)
        consts.append(c)
    lines += _emit_consts(decls)
    missing = set(top) - set(names)
    if missing:
        raise ValueError(f"U' program lacks {sorted(missing)}")
    lines.append("  // The forward circuit's nonlinear middle, unchanged (62 gates).")
    decls = [f"{d} = {a} {op} {b}" for d, a, op, b in middle]
    lines += _emit_consts(decls, 4)
    lines.append(f"  // B' = A^-1 B: {len(bp)} steps from z0..z17 to the output planes.")
    names = [f"z{i}" for i in range(18)]
    out = {v: i for i, v in enumerate(bottom)}
    decls, stores = [], []
    for k, (v, src) in enumerate(bp):
        name = f"o{out[v]}" if v in out else f"g{k}"
        decls.append(f"{name} = {_xor([names[i] for i in src])}")
        names.append(name)
    lines += _emit_consts(decls)
    for i in range(8):
        stores.append(f"x[{i}] = o{i};")
    lines.append("  " + " ".join(stores[:4]))
    lines.append("  " + " ".join(stores[4:]))
    return "\n".join(lines)


def _mul_rows(c: int) -> list[int]:
    """Output bit i of c * x in GF(2^8), as a mask over x's bits."""
    return [sum(((gf.gmul(c, 1 << j) >> i) & 1) << j for j in range(8)) for i in range(8)]


def inv_mix_rows() -> list[int]:
    """InvMixColumns plus AddRoundKey of one column: row 8r + b (output row
    r, bit b) over inputs 8r' + b' (a[r'][b']) and 32 + 8r + b (its key)."""
    mul = {c: _mul_rows(c) for c in INV_MIX_COEFS}
    rows = []
    for r in range(4):
        for b in range(8):
            m = 1 << (32 + 8 * r + b)
            for k, c in enumerate(INV_MIX_COEFS):
                m |= mul[c][b] << (8 * ((r + k) % 4))
            rows.append(m)
    return rows


def inv_mix_program():
    return paar_search(inv_mix_rows(), 64, SEED_INV_MIX)


def inv_mix_c() -> str:
    """The body of ``inv_mix_column``: a[4][8] and km[0..31] in, o[0..31] out."""
    prog, finals = inv_mix_program()
    names = [f"a[{i // 8}][{i % 8}]" for i in range(32)] + [f"km[{i}]" for i in range(32)]
    lines = [f"  // {len(prog)} shared steps, then {sum(len(f) // 2 for f in finals)} "
             "final steps, each output plane's key in its last."]
    decls = []
    for k, (_v, src) in enumerate(prog):
        decls.append(f"m{k} = {_xor([names[i] for i in src])}")
        names.append(f"m{k}")
    lines += _emit_consts(decls)
    for i, f in enumerate(finals):
        key = [j for j in f if 32 <= j < 64]
        rest = [j for j in f if j not in key] + key  # the key plane goes last
        expr = names[rest[0]]
        for j in range(1, len(rest), 2):
            expr = _xor([expr] + [names[x] for x in rest[j:j + 2]])
        lines.append(f"  o[{i}] = {expr};")
    return "\n".join(lines)


BLOCKS = {"inv_sbox": inv_sbox_c, "inv_mix_column": inv_mix_c}


def header_block(name: str) -> str:
    """The generated block ``name`` as it stands in the header."""
    text = (CSRC / "aes_inv_bitslice.cuh").read_text()
    begin, end = BEGIN.format(name=name), END.format(name=name)
    return text[text.index(begin) + len(begin) + 1:text.index(end)].rstrip("\n")


# ---------------------------------------------------------------------------
# Host checks: the programs evaluated with one Python int per plane (bit t of
# plane i = bit i of input t), so all 256 bytes go through at once.
# ---------------------------------------------------------------------------


def _eval_program(prog, inputs: list[int]) -> list[int]:
    sig = list(inputs)
    for _v, src in prog:
        x = 0
        for i in src:
            x ^= sig[i]
        sig.append(x)
    return sig


def check_inv_sbox() -> None:
    """InvS over all 256 bytes through the programs, against the table."""
    top, middle, bottom = inverse_layers()
    up, bp = inv_sbox_program()
    full = (1 << 256) - 1
    planes = [sum(((t >> i) & 1) << t for t in range(256)) for i in range(8)]
    sig = _eval_program(up, planes)
    val = {}
    for n, (m, c) in top.items():
        val[n] = next(s for s, (v, _src) in zip(sig[8:], up) if v == m) ^ (full if c else 0)
    for d, a, op, b in middle:
        val[d] = val[a] ^ val[b] if op == "^" else val[a] & val[b]
    out = _eval_program(bp, [val[f"z{i}"] for i in range(18)])
    got = [sum(((next(s for s, (v, _src) in zip(out[18:], bp) if v == bottom[i]) >> t) & 1) << i
               for i in range(8)) for t in range(256)]
    if got != [int(v) for v in tables.INV_SBOX]:
        raise AssertionError("the dedicated inverse S-box programs disagree with InvS")


def check_inv_mix(trials: int = 64, seed: int = 0) -> None:
    """InvMixColumns plus AddRoundKey through the program on random columns."""
    prog, finals = inv_mix_program()
    rng = np.random.default_rng(seed)
    for _ in range(trials):
        col = rng.integers(0, 256, 4)
        key = rng.integers(0, 256, 4)
        bits = [int(col[j // 8]) >> (j % 8) & 1 for j in range(32)]
        bits += [int(key[j // 8]) >> (j % 8) & 1 for j in range(32)]
        sig = _eval_program(prog, bits)
        got = [0] * 4
        for i, f in enumerate(finals):
            b = 0
            for j in f:
                b ^= sig[j]
            got[i // 8] |= b << (i % 8)
        want = [gf.gmul(14, col[r]) ^ gf.gmul(11, col[(r + 1) % 4]) ^ gf.gmul(13, col[(r + 2) % 4])
                ^ gf.gmul(9, col[(r + 3) % 4]) ^ key[r] for r in range(4)]
        if got != [int(v) for v in want]:
            raise AssertionError(f"InvMixColumns program: {got} != {want}")


def main(argv: list[str]) -> int:
    if argv[:1] == ["--check"]:
        check_inv_sbox()
        check_inv_mix()
        bad = [n for n, fn in BLOCKS.items() if header_block(n) != fn()]
        print("header blocks differ: " + ", ".join(bad) if bad else "ok")
        return 1 if bad else 0
    for name, fn in BLOCKS.items():
        print(BEGIN.format(name=name))
        print(fn())
        print(END.format(name=name))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
