#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: ``python3 chip_smoke.py``.

Drives ``our_tree_tpu_torch`` (never the JAX package) through its main
path, AES-128-CTR over one 256 MiB buffer with the bench chain, and holds
every kernel of that path against its plain torch version on the card.
Phases, in order; any failure raises and the exit code is not 0:

1. the card's name and power limit; build the kernels, print ``ptxas -v``;
2. kernel vs plain version: every counter wrap, nr 10/12/14, ragged N and
   16 MiB random (mismatching words must be 0);
3. NIST SP800-38A F.5.1 CTR KAT and a chunked ``crypt_ctr`` resume;
4. the main path: ``bench.run`` at 256 MiB, iters 5, reps 3, with every
   launch count set to 0 just before and read just after; the digest must
   be 0xa612a647, the reference's digest for this chain;
5. per kernel at the main path's 256 MiB shape: kernel vs plain version,
   time per launch (CUDA events), the plain version's time, the least time
   the card could take (the bytes the function moves over the HBM rate or
   the operations it needs over the integer rate, the larger), the launches
   of 4, the kernel's own SASS instruction count beside the operations, and
   the rest of a chain step (the digest sum).

Standard output ends with the ``kernels`` JSON line, the ``nvidia-smi``
name/power-limit line and ``{"ok": true, "device": {...}}``. Without a card,
or without the rest of the repo beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_BYTES = 256 << 20
MAIN_DIGEST = 0xA612A647
#: H100 SXM HBM3 rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: 32-bit integer add/logic/shift results per clock per SM on compute
#: capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction table).
INT_OPS_PER_CLK_PER_SM = 64
#: Two-input gates of the Boyar-Peralta forward S-box (32 AND, 83 XOR).
BP_SBOX_GATES = 115
#: XORs of one column's MixColumns, the fewest known (Maximov, "AES
#: MixColumn with 92 XOR gates", IACR ePrint 2019/833).
MIXCOLUMN_XORS = 92
WRAP_NONCES = [
    "000102030405060708090a0bfffffffb",   # 32-bit carry after 5 blocks
    "0001020304050607fffffffffffffff9",   # 64-bit carry after 7 blocks
    "fffffffffffffffffffffffffffffff0",   # 128-bit wrap after 16 blocks
    "ffffffffffffffffffffffffffffffff",   # 128-bit wrap after 1 block
    "f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff",   # the bench nonce
]


def log(*a) -> None:
    print(*a, flush=True)


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def sass(so_path: str) -> str:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout


def ctr_ops_per_group(nr: int) -> tuple[float, dict]:
    """Integer operations AES-CTR needs for one group of 32 blocks in bit
    planes, counted from the function, not from the compiled kernel.

    Two-input gates: 16 nr S-boxes, nr - 1 MixColumns of four columns,
    nr + 1 AddRoundKeys of 128 XORs, the counter planes (a full adder of 5
    gates for each of bits 0..4 of the in-group index, whose carry differs by
    lane; above that one XOR and one AND per bit, as the group's high bits
    are the same for all 32 lanes), the keystream XORed into the data (128),
    and four 32x32 bit transposes as swap networks (5 stages of 16 pairs,
    each 4 logic gates and 2 shifts). A LOP3 evaluates any function of three
    inputs, so one instruction stands for at most two two-input gates; that
    fusion is credited in full (gates / 2). Shifts count one each. Moves,
    masks, address and loop arithmetic are not counted. The four NOTs of an
    S-box fold into neighbouring gates."""
    gates = {
        "sbox": 16 * nr * BP_SBOX_GATES,
        "mixcolumns": 4 * (nr - 1) * MIXCOLUMN_XORS,
        "addroundkey": 128 * (nr + 1),
        "counter": 5 * 5 + 2 * (128 - 5),
        "data_xor": 128,
        "transpose": 4 * 5 * 16 * 4,
    }
    shifts = 4 * 5 * 16 * 2
    return sum(gates.values()) / 2 + shifts, {**gates, "shifts": shifts}


def sass_int_ops_per_thread(text: str, nr: int) -> tuple[int, dict]:
    """Integer instructions one thread of ctr_gen_kernel<nr> executes, read
    from the compiled SASS (``cuobjdump -sass``): the straight-line code
    counts once, the round loop's body (the one backward branch) nr - 1
    times. Returns the count and the opcode histogram of that stream."""
    funcs = re.split(r"\n\s*Function : ", text)
    body = [f for f in funcs if f.startswith(f"_ZN") and f"ctr_gen_kernelILi{nr}E" in f.split("\n", 1)[0]]
    if len(body) != 1:
        raise RuntimeError(f"expected one SASS function for nr={nr}, found {len(body)}")
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", body[0])]
    back = []
    for addr, t in ins:
        m = re.search(r"\bBRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))", t)
        if m and m.group(1) is not None and int(m.group(1), 16) < addr:
            back.append((int(m.group(1), 16), addr))
    if len(back) != 1:
        raise RuntimeError(f"expected one backward branch (the round loop), found {back}")
    lo, hi = back[0]
    skip = ("NOP", "EXIT", "BRA", "BAR", "RET", "S2R", "S2UR", "CS2R", "BSSY", "BSYNC",
            "WARPSYNC", "DEPBAR")
    hist: dict = {}
    total = 0
    for addr, t in ins:
        op = t.split()[1] if t.startswith("@") else t.split()[0]
        base = op.split(".")[0]
        if base in skip or base.startswith(("LD", "ST", "U", "ATOM", "RED")):
            continue
        k = nr - 1 if lo <= addr <= hi else 1
        hist[base] = hist.get(base, 0) + k
        total += k
    return total, dict(sorted(hist.items(), key=lambda kv: -kv[1]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from our_tree_tpu_torch import bench
    from our_tree_tpu_torch.models import aes
    from our_tree_tpu_torch.ops import cuda_aes
    from our_tree_tpu_torch.ops.keyschedule import expand_key_enc
    from our_tree_tpu_torch.runtime import cuda_build
    from our_tree_tpu_torch.utils import packing

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. Build.
    t0 = time.perf_counter()
    lib_path = str(cuda_build.library_path())
    cuda_build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.basename(lib_path)}")
    for line in cuda_build.ptxas_report().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("ptxas:", line.strip())

    def events_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps

    def tensors(n, key, hexnonce, seed):
        nr, rk = expand_key_enc(key)
        ctr = packing.np_bytes_to_words(np.frombuffer(bytes.fromhex(hexnonce), np.uint8)).byteswap()
        w = torch.randint(-2**31, 2**31, (n, 4), dtype=torch.int32, device=dev,
                          generator=torch.Generator(dev).manual_seed(seed))
        return w, packing.words_tensor(ctr, dev), packing.words_tensor(rk, dev), nr

    def compare(w, ctr, rk, nr):
        got = cuda_aes.ctr_crypt_words_fused(w, ctr, rk, nr)
        want = cuda_aes.ctr_crypt_words_fused_plain(w, ctr, rk, nr)
        torch.cuda.synchronize()
        diff = (got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF)
        return int((got != want).sum()), int(diff.abs().max()) if diff.numel() else 0

    # 2. Kernel vs plain version on the card.
    mismatches = 0
    cases = 0
    for bits in (128, 192, 256):
        for hexnonce in WRAP_NONCES:
            for n in (1, 31, 33, 1000, 1 << 20):
                if n == 1 << 20 and hexnonce != WRAP_NONCES[1]:
                    continue  # 16 MiB once per key size, across a 64-bit carry
                key = np.random.default_rng(bits).integers(0, 256, bits // 8, dtype=np.uint8)
                m, _ = compare(*tensors(n, key.tobytes(), hexnonce, seed=n + bits))
                mismatches += m
                cases += 1
                if m:
                    log(f"MISMATCH bits={bits} nonce={hexnonce} n={n}: {m} words")
    log(f"kernel vs plain: {cases} cases, {mismatches} mismatching words")
    if mismatches:
        raise SystemExit("kernel disagrees with its plain version")

    # 3. KAT and chunked resume through the AES context on the card.
    kat_key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    ctr0 = np.frombuffer(bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"), np.uint8)
    pt = bytes.fromhex("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
                       "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
    ct = ("874d6191b620e3261bef6864990db6ce9806f66b7970fdff8617187bb9fffdff"
          "5ae4df3edbd5d35e5b4f09020db03eab1e031dda2fbe03d1792170a0f3009cee")
    ctx = aes.AES(kat_key)
    if ctx.engine != aes.CUDA_ENGINE:
        raise SystemExit(f"AES on the card resolved to {ctx.engine}")
    out = ctx.crypt_ctr(0, ctr0.copy(), np.zeros(16, np.uint8), pt)[0]
    if out.tobytes().hex() != ct:
        raise SystemExit("NIST SP800-38A F.5.1 CTR KAT failed")
    log("NIST SP800-38A F.5.1 CTR-AES128 KAT: pass")
    data = np.random.default_rng(7).integers(0, 256, 1 + 15 + 16 + 17 + 1_000_003, dtype=np.uint8)
    state = (0, ctr0.copy(), np.zeros(16, np.uint8))
    parts, pos = [], 0
    for size in (1, 15, 16, 17, 1_000_003):
        o, *state = ctx.crypt_ctr(*state, data[pos: pos + size])
        parts.append(o)
        pos += size
    cpu = aes.AES(kat_key, device="cpu").crypt_ctr(0, ctr0.copy(), np.zeros(16, np.uint8), data)
    if not (np.array_equal(np.concatenate(parts), cpu[0]) and state[0] == cpu[1]
            and np.array_equal(state[1], cpu[2]) and np.array_equal(state[2], cpu[3])):
        raise SystemExit("chunked crypt_ctr on the card differs from one shot on the CPU")
    log("chunked crypt_ctr resume (1, 15, 16, 17, 1000003 bytes): equal to CPU one-shot")

    # 4. The main path, counted.
    cuda_aes.ctr_crypt_words_fused.launches = 0
    line = bench.run(device=dev, nbytes=MAIN_BYTES, iters=5, reps=3)
    launches = cuda_aes.ctr_crypt_words_fused.launches
    log(json.dumps(line))
    if f"digest={MAIN_DIGEST:#010x}" not in line["metric"]:
        raise SystemExit(f"main path digest is not {MAIN_DIGEST:#010x}: {line['metric']}")
    if launches <= 0:
        raise SystemExit("the main path launched no ctr_gen kernel")
    log(f"main path: {line['value']} GB/s median (min {line['value_min']}, max "
        f"{line['value_max']}, {line['reps']} reps), ctr_gen launches {launches}; card: {card}")

    # 5. The kernel at the main path's shape: time, plain time, bound.
    w, ctr, rk, nr = tensors(MAIN_BYTES // 16, bench.KEY, WRAP_NONCES[4], seed=1337)
    m, max_err = compare(w, ctr, rk, nr)
    if m:
        raise SystemExit(f"kernel vs plain at the main shape: {m} mismatching words")
    ms = events_ms(lambda: cuda_aes.ctr_crypt_words_fused(w, ctr, rk, nr), 20)
    plain_ms = events_ms(lambda: cuda_aes.ctr_crypt_words_fused_plain(w, ctr, rk, nr), 2)
    groups = (w.shape[0] + 31) // 32
    fn_ops, parts = ctr_ops_per_group(nr)
    sass_ops, hist = sass_int_ops_per_thread(sass(lib_path), nr)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    int_ops_per_ms = sm_count * INT_OPS_PER_CLK_PER_SM * clock_mhz * 1e3
    ops_ms = groups * fn_ops / int_ops_per_ms
    sass_ms = groups * sass_ops / int_ops_per_ms
    bytes_ms = (2 * w.numel() * 4 + 4 * 4 + rk.numel() * 4) / HBM_BYTES_PER_S * 1e3
    log(f"ctr_gen at {MAIN_BYTES >> 20} MiB: {ms:.4f} ms/launch "
        f"({MAIN_BYTES / ms / 1e6:.2f} GB/s), plain {plain_ms:.2f} ms; card: {card}")
    log(f"bound: {fn_ops} operations per group of 32 blocks ({parts}) x {groups} groups / "
        f"({sm_count} SMs x {INT_OPS_PER_CLK_PER_SM}/clk x {clock_mhz:.0f} MHz) = "
        f"{ops_ms:.4f} ms; bytes {bytes_ms:.4f} ms; kernel at "
        f"{100 * max(ops_ms, bytes_ms) / ms:.1f} % of the bound")
    log(f"kernel's own stream: {sass_ops} SASS integer instructions per thread, "
        f"{sass_ops / fn_ops:.3f}x the operations ({sass_ms:.4f} ms at the integer rate, "
        f"kernel at {100 * sass_ms / ms:.1f} % of that); top opcodes {list(hist.items())[:8]}")
    out = cuda_aes.ctr_crypt_words_fused(w, ctr, rk, nr)
    sum_ms = events_ms(lambda: bench.u32_sum(out), 10)
    log(f"chain step besides the kernel: digest sum {sum_ms:.4f} ms at {MAIN_BYTES >> 20} MiB")
    kernels = [{
        "name": "ctr_gen",
        "route": "cuda",
        "source": "our_tree_tpu_torch/csrc/ctr_gen.cu",
        "replaces": "our_tree_tpu/ops/pallas_aes.py:601",
        "launches": launches,
        "mismatches": m,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
        "ops_per_group": fn_ops,
        "sass_instructions_per_group": sass_ops,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
