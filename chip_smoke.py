#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card: ``python3 chip_smoke.py``.

Drives ``our_tree_tpu_torch`` (never the JAX package) through its five
paths, AES-128-CTR over one 256 MiB buffer with the bench chain, the
ECB/CBC/CFB128 block-mode path over the same size, the measured roofline
(the ceiling probe ``harness.ceiling`` and the serve bench's cost and
profile sections that use its figure), the multi-key CTR serve path
(``serve.bench``, the JAX package's two documented drives at the full
ladder) and the sweep harness (``harness.bench``, with ARC4 and the native C
tier), and holds every kernel of those paths against its plain torch
version on the card. Phases, in order; any failure raises and the exit code
is not 0:

1. the card's name and power limit; build the kernels (one ``nvcc`` per
   source, in parallel), print ``ptxas -v`` per kernel;
2. kernel vs plain version: ``ctr_gen`` at every counter wrap, and both ECB
   kernels, for nr 10/12/14 at N in {1, 31, 33, 1000, 2^20, 2^24 + 7} (the
   last a 256 MiB launch with a ragged tail); ``ctr_mk``
   for nr 10/12/14, K in {1, 3, 8, 64}, N in {1, 31, 33, 1000, 4096, 2^20},
   with one slot, runs of 1-300 blocks, a random slot per block and unused
   zero schedules, and its K = 1 entry over counters from every wrap nonce,
   every case in the auto form and in each form forced (group, block);
   ``seq_encrypt`` (chained CBC and CFB128) for nr 10/12/14, S in {1, 3,
   4096} streams, N in {1, 2, 33, 4096} blocks (up to 33 blocks against the
   whole plain loop, at 4,096 against every plain step at once);
   ``chain`` in its four regimes at N in {1, 31, 4097, 2^20 + 3} words and
   at 64 MiB, and its 65,536-step latency chain over one word (mismatching
   words must be 0); ``arc4_prga`` for S in {1, 7, 32, 4096} streams x {1,
   255, 4096, 2^16, 2^20} bytes, each as keystream, fused XOR and a resume
   across two calls, against the first S rows of one timed plain run a
   length on 4,096 streams (mismatching bytes must be 0);
3. NIST SP800-38A F.5.1 CTR KAT and a chunked ``crypt_ctr`` resume; F.1,
   F.2 and F.3.13 (ECB, CBC, CFB128) in both directions through ``AES`` on
   the card, whose engine must be the CUDA one (each CBC/CFB128 encrypt one
   ``seq_encrypt`` launch), and F.2.1 and F.3.13 through the chained
   kernel's own entries; F.5.1 in slot 3 of 8 through the multi-key serve
   seam;
4. the CTR main path: ``bench.run`` at 256 MiB, iters 5, reps 3; the digest
   must be 0xa612a647, the reference's digest for this chain;
5. the block-mode path at 256 MiB: ECB encrypt and decrypt (round trip, each
   kernel equal to its plain version), the parallel CBC and CFB128 decrypts
   (equal to their plain versions), the sequential CBC and CFB128 encrypts of
   the first 4,096 recovered blocks (they give back the input), and
   ``cbc_encrypt_words_batch`` with 4,096 streams of 64 blocks: each of
   these three exactly one ``seq_encrypt`` launch and no other;
6. the hex CLI on the card decrypts the F.1.2 vector;
7. the ceiling probe: ``harness.ceiling.main`` in this process (counted:
   ``chain`` launched, nothing else), then ``python -m
   our_tree_tpu_torch.harness.ceiling`` at its defaults, whose JSON line
   (the reference's keys) is printed; then each regime's kernel alone at
   64 MiB (CUDA events over at least a second of launches, the SM clock,
   power and temperature sampled by ``nvidia-smi`` meanwhile) and its SASS
   per element: each compute regime must hold about chain x ilp LOP3s per
   element, and ``compute-ilp8`` must reach 10 % of the table's integer
   rate. Printed: the measured integer instruction rate as results per
   clock per SM at the sampled and at the maximum clock beside the table's
   64, the streaming rate beside 3.35 TB/s, the logical-op rate by the
   reference's count, and the ``ctr_mk`` ceiling these imply;
8. the serve path: ``serve.bench`` drive A (``--requests 500
   --mixed-sizes``: 16 B-64 KiB, 4 tenants x 2 keys, ladder 32-4,096 blocks,
   one lane) and drive B (``--requests 300 --tenant-heavy --min-coalesce
   0.5``: 24 tenants, 16 B-1 KiB, so 32-block groups straddle slots); each
   with 0 lost, failed and mismatching, 0 kernel-library builds after
   warmup, the CUDA engine, ``ctr_mk`` launches equal to its engine calls
   and no other kernel launched, its launches by form (every rung's auto
   form, and no other, served); latency, goodput, the stage split and the
   first traffic dispatch beside the p50; then drive A's mix once more in a
   fresh process (``python -m our_tree_tpu_torch.serve.bench``), where
   warmup meets the card first: warmup must count the library load and the
   kernel's first launch, traffic none;
9. the card's dependent-issue latency (the 65,536-step chain over one
   word, cycles per dependent LOP3 at the sampled clock); per kernel at its
   path's shape (256 MiB; ``ctr_mk`` at the 4,096-block rung in each form,
   and at 256 MiB with K = 8 in each form and with its K = 1 entry;
   ``seq_encrypt`` as the batch of 4,096 streams x 64 blocks and as the two
   single-stream encrypts of 4,096 blocks; the one-block ECB launch;
   ``chain`` in each regime at 64 MiB): time per launch (CUDA events, the SM
   clock sampled), the plain version's time, the least time the card could
   take at the table's rates (the bytes the function moves over the HBM rate
   or the operations it needs over 64 results per clock per SM, the larger)
   at the maximum and at the sampled clock, and at the probe's measured
   rates; for the latency-bound launches (the sequential encrypts, the
   rungs, one block) also the latency bound, the dependent path of a
   thread's circuit counted in its SASS times the measured latency; the
   kernel's own SASS instruction count beside the operations (for
   ``ctr_mk`` an upper bound), for both ECB kernels also their round loop's
   (integer instructions, opcode histogram, dependency depth), and the
   forward kernels' counts beside their counts from before the decrypt
   kernel's redesign (``FORWARD_SASS``), which it must leave as they were;
   both ``ctr_mk`` forms at 32 to 2^24 blocks, one slot and a random slot
   per block (the auto form's threshold table); a shared-memory load's
   latency by a dependent-load chase (``CHASE_SOURCE``, built beside the
   kernels), and ``arc4_prga`` at its timing shapes (32 x 2^20 bytes, the
   rc4-batch rows' launch; 1 x 2^20; 4,096 x 2^16): time, plain time, the
   table and measured-rate bounds, and the latency bound (the step's
   recurrence, two dependent LDS and two dependent integer steps a byte, at
   the measured latencies; the compiled main loop's longest path beside it);
10. the sweep harness, ``python -m our_tree_tpu_torch.harness.bench`` in
   processes of its own with ``OT_ARC4_PREP=native``: ``--timing device
   --iters 5 --keybits 128`` over ecb, ecb-dec, ctr, cbc-dec and rc4 at 1,
   16 and 256 MiB; cbc and cfb128 at 64 KiB; cbc-batch and rc4-batch with 32
   streams at 32 MiB; ecb, ctr and rc4 at 16 and 256 MiB with ``--timing
   e2e`` (staging included); the same three on ``--backend c``; rc4 at 1 MiB with
   ``OT_ARC4_PREP=device``; gated on every self-test, parity and XOR line,
   no ``# degraded:`` line, each unit's kernel launched (the harness's
   ``# launches:`` lines) and ``--workers 2`` refused; each row's GB/s is
   printed beside the CTR chain's;
11. drive C, drive A's mix at 10,000 requests with ``--profile-window 1:2``
   and ``--ceiling-gbps`` at the probe's ``ctr_mk`` ceiling, gated as A,
   with a ``torch``-tier profile section that validates, cross-check rows
   equal to the window's dispatches, a cost row per warmed rung and
   ``ctr_mk`` kernels in the exported trace, whose kernel time over the
   window is the card's busy share under the profiler. It comes last, so
   that the profiler touches none of the timings before it.

Phases 4, 5, 7, each drive of 8 and 11 run with every launch count set to
0 just before and read just after, and each run of phase 10 counts its own
launches by unit: each path must have launched each of its kernels.
Standard output ends with the ``kernels`` JSON line (``ctr_gen``,
``ecb_encrypt`` with its one-block launch, ``ecb_decrypt``, ``seq_encrypt``,
``ctr_mk`` with its ``k1_entry`` and its ``block_form``, ``chain``,
``arc4_prga`` with its ``single`` and ``wide`` shapes and the harness rows), the
``nvidia-smi`` name/power-limit line and ``{"ok": true, "device": {...}}``. Without a card,
or without the rest of the repo beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import atexit
import contextlib
import datetime
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_BYTES = 256 << 20
#: The ceiling probe's buffer, its default (``OT_VPU_BYTES``): above the 50 MB L2.
PROBE_BYTES = 64 << 20
#: Least seconds of back-to-back launches per timed kernel, so that the clock
#: sampler (every 100 ms) sees it.
SAMPLED_S = 1.0
#: Drive A's mix, profiled: enough requests that the drive outlasts its
#: window (1 s in, 2 s long) with the profiler running.
PROFILED_REQUESTS = 10000
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
#: The forward kernels' integer SASS at nr 10 as compiled before the decrypt
#: kernel's redesign (per group of 32 blocks, or per block for the one-block
#: forms), printed beside this build's: a decrypt-only change leaves them.
FORWARD_SASS = {"ctr_gen": 21432, "ecb_encrypt": 22324, "ctr_mk_block": 2575, "seq_encrypt": 2637}
BLOCK_IV = "f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"
SEQ_BLOCKS = 4096
#: Phase 2's ARC4 cases: streams x bytes, every pair. The plain version runs
#: once a length, on ARC4_PLAIN_STREAMS streams; a launch on S streams is
#: held against its first S rows (the streams are independent). 2^20 bytes
#: is the harness's length (rc4-batch: 32 streams; rc4 with the keystream on
#: the card: one), 2^16 that of the wide timing shape.
ARC4_STREAMS = (1, 7, 32, 4096)
ARC4_LENGTHS = (1, 255, 4096, 1 << 16, 1 << 20)
ARC4_PLAIN_STREAMS = max(ARC4_STREAMS)
#: Phase 9's timing shapes, (streams, bytes): the rc4-batch rows' launch
#: (the head of the kernels entry), one stream, and 4,096 streams (one warp
#: on each of 128 SMs).
ARC4_TIMED = {"path": (32, 1 << 20), "single": (1, 1 << 20), "wide": (4096, 1 << 16)}
#: Integer operations of one PRGA step that the function needs: three adds
#: and three masks (x + 1, y + a, a + b, each & 255). Its five shared-memory
#: accesses are neither device-memory bytes nor table operations; their
#: latency is what the latency bound counts.
ARC4_OPS_PER_BYTE = 6
#: The step's dependent recurrence from one byte to the next, as the step is
#: written (the next byte's load of m[x] follows this byte's stores, which
#: wait on b): the load of a = m[x], the add y + a, one address step (mask
#: and offset), the load of b = m[y]. Two dependent shared-memory loads and
#: two dependent integer steps a byte; the latency bound counts these.
ARC4_RECURRENCE = {"lds": 2, "int": 2}
#: The sweep harness's rows (phase 10): each mode's kernel, by mode.
HARNESS_KERNEL = {"ecb": "ecb_encrypt", "ecb-dec": "ecb_decrypt", "ctr": "ctr_gen",
                  "cbc-dec": "ecb_decrypt", "cbc": "seq_encrypt", "cfb128": "seq_encrypt",
                  "cbc-batch": "seq_encrypt", "rc4-batch": "arc4_prga"}
#: The dependent shared-memory load chase (phase 9): one thread walks a
#: cycle of shared-memory addresses, each load's address the previous load's
#: value, timed with the SM's cycle counter. Built with its own nvcc beside
#: the kernels' build; a measurement probe, not a kernel of the port.
CHASE_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void smem_chase(int steps, unsigned* out, long long* cycles) {
  __shared__ unsigned s[1024];
  const unsigned base = (unsigned)__cvta_generic_to_shared(s);
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) s[i] = base + 4u * ((i * 97u + 1u) % 1024u);
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned j = base;
  const long long t0 = clock64();
#pragma unroll 32
  for (int k = 0; k < steps; ++k) asm volatile("ld.shared.u32 %0, [%0];" : "+r"(j));
  const long long t1 = clock64();
  out[0] = j;
  cycles[0] = t1 - t0;
}

extern "C" int ot_smem_chase(int steps, void* out, void* cycles) {
  smem_chase<<<1, 32>>>(steps, static_cast<unsigned*>(out), static_cast<long long*>(cycles));
  return (int)cudaGetLastError();
}
"""
#: Phase 2's ECB sizes: ragged tails around one group and one thread block,
#: 16 MiB, and a 256 MiB launch whose last group holds 7 blocks.
ECB_SIZES = (1, 31, 33, 1000, 1 << 20, (1 << 24) + 7)
SP800_PT = ("6bc1bee22e409f96e93d7e117393172aae2d8a571e03ac9c9eb76fac45af8e51"
            "30c81c46a35ce411e5fbc1191a0a52eff69f2445df4f9b17ad2b417be66c3710")
SP800_IV = "000102030405060708090a0b0c0d0e0f"
#: NIST SP800-38A F.1.1/3/5 and F.2.1/3/5: key, ECB ciphertext, CBC ciphertext.
SP800_ECB_CBC = {
    128: ("2b7e151628aed2a6abf7158809cf4f3c",
          "3ad77bb40d7a3660a89ecaf32466ef97f5d3d58503b9699de785895a96fdbaaf"
          "43b1cd7f598ece23881b00e3ed0306887b0c785e27e8ad3f8223207104725dd4",
          "7649abac8119b246cee98e9b12e9197d5086cb9b507219ee95db113a917678b2"
          "73bed6b8e3c1743b7116e69e222295163ff1caa1681fac09120eca307586e1a7"),
    192: ("8e73b0f7da0e6452c810f32b809079e562f8ead2522c6b7b",
          "bd334f1d6e45f25ff712a214571fa5cc974104846d0ad3ad7734ecb3ecee4eef"
          "ef7afd2270e2e60adce0ba2face6444e9a4b41ba738d6c72fb16691603c18e0e",
          "4f021db243bc633d7178183a9fa071e8b4d9ada9ad7dedf4e5e738763f69145a"
          "571b242012fb7ae07fa9baac3df102e008b0e27988598881d920a9e64f5615cd"),
    256: ("603deb1015ca71be2b73aef0857d77811f352c073b6108d72d9810a30914dff4",
          "f3eed1bdb5d2a03c064b5a7e3db181f8591ccb10d410ed26dc5ba74a31362870"
          "b6ed21b99ca6f4f9f153e7b1beafed1d23304b7a39f9f3ff067d8d8f9e24ecc7",
          "f58c4c04d6e5f1ba779eabfb5f7bfbd69cfc4e967edb808d679f777bc6702c7d"
          "39f23369a9d9bacfa530e26304231461b2eb05e2c39be9fcda6c19078c6a9d1b"),
}
#: NIST SP800-38A F.3.13, CFB128-AES128 encrypt.
SP800_CFB128 = ("3b3fd92eb72dad20333449f8e83cfb4ac8a64537a0b3a93fcde3cdad9f1ce58b"
                "26751f67a3cbb140b1808cf187a4f4dfc04b05357c5d1c0eeac4c66f9ff7f2e6")
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


def ecb_ops_per_group(nr: int, decrypt: bool) -> tuple[float, dict]:
    """Integer operations ECB needs for one group of 32 blocks in bit planes,
    by ``ctr_ops_per_group``'s rule (two-input gates / 2 for LOP3 fusion,
    shifts one each, NOTs folded, moves and address arithmetic not counted):
    16 nr S-boxes, nr - 1 MixColumns or InvMixColumns of four columns, nr + 1
    AddRoundKeys of 128 XORs and eight 32x32 transposes (four in, four out).

    Both directions count the same. Encrypt S-boxes are Boyar-Peralta's 115
    gates. The inverse S-box is credited with the same 115: A^-1 on either
    side of that core (linear) and the 0x05 constant (NOTs) fold into its
    top and bottom linear layers, as the decrypt kernel's dedicated circuit
    does (22 and 17 steps of 3-input XOR around the same 62-gate middle).
    InvMixColumns is credited with MixColumns' 92 XORs, a deliberately low
    figure: its matrix is the denser of the two, and the bound must not
    count work the function may not need. The kernel's own form (113 steps
    of 2- or 3-input XOR a column, the key included) is not counted."""
    gates = {
        "sbox": 16 * nr * BP_SBOX_GATES,
        "inv_mixcolumns" if decrypt else "mixcolumns": 4 * (nr - 1) * MIXCOLUMN_XORS,
        "addroundkey": 128 * (nr + 1),
        "transpose": 8 * 5 * 16 * 4,
    }
    shifts = 8 * 5 * 16 * 2
    return sum(gates.values()) / 2 + shifts, {**gates, "shifts": shifts}


_SASS_SKIP = ("NOP", "EXIT", "BRA", "BAR", "RET", "S2R", "S2UR", "CS2R", "BSSY", "BSYNC",
              "WARPSYNC", "DEPBAR")


def sass_function(text: str, kernel: str, targs) -> tuple[list, list]:
    """The instructions [(address, opcode base, text)] of ``kernel``<targs>
    (one int template argument, or a tuple of them) in the compiled SASS
    (``cuobjdump -sass``) and its backward branches [(target, address)], the
    loops."""
    targs = (targs,) if isinstance(targs, int) else tuple(targs)
    mangled = kernel + "I" + "".join(f"Li{a}E" for a in targs) + "E"
    funcs = re.split(r"\n\s*Function : ", text)
    body = [f for f in funcs if f.startswith("_ZN") and mangled in f.split("\n", 1)[0]]
    if len(body) != 1:
        raise RuntimeError(f"expected one SASS function {kernel}<{targs}>, found {len(body)}")
    ins = []
    back = []
    for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", body[0]):
        addr, t = int(a, 16), t.strip()
        op = t.split()[1] if t.startswith("@") else t.split()[0]
        ins.append((addr, op.split(".")[0], t))
        m = re.search(r"\bBRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))", t)
        if m and m.group(1) is not None and int(m.group(1), 16) < addr:
            back.append((int(m.group(1), 16), addr))
    return ins, back


def _is_int_op(base: str) -> bool:
    return not (base in _SASS_SKIP or base.startswith(("LD", "ST", "U", "ATOM", "RED")))


def sass_int_ops_per_thread(text: str, kernel: str, nr: int) -> tuple[int, dict]:
    """Integer instructions one thread of ``kernel``<nr> executes, read
    from the compiled SASS: the straight-line code counts once, the round
    loop's body (the one backward branch) nr - 1 times. Returns the count
    and the opcode histogram of that stream."""
    ins, back = sass_function(text, kernel, nr)
    if len(back) != 1:
        raise RuntimeError(f"expected one backward branch (the round loop), found {back}")
    lo, hi = back[0]
    hist: dict = {}
    total = 0
    for addr, base, _t in ins:
        if not _is_int_op(base):
            continue
        k = nr - 1 if lo <= addr <= hi else 1
        hist[base] = hist.get(base, 0) + k
        total += k
    return total, dict(sorted(hist.items(), key=lambda kv: -kv[1]))


def sass_mk_per_thread(text: str, nr: int) -> dict:
    """``ctr_mk_kernel``<nr>'s integer SASS by key form. The kernel has one
    rolled round loop per key form (the two largest loops; the mixed one
    reads its key words from shared memory, so it has the more LDS) and
    small set-up loops. Per group, a form runs its loop body nr - 1 times
    plus straight-line code; the straight-line code holds both forms' first
    and last rounds, and the set-up loops are counted once, so
    ``*_group`` is an upper bound for one group of that form."""
    ins, back = sass_function(text, "ctr_mk_kernel", nr)
    loops = []
    for lo, hi in back:
        body = [(a, b) for a, b, _t in ins if lo <= a <= hi]
        loops.append({"range": (lo, hi), "int": sum(_is_int_op(b) for _a, b in body),
                      "lds": sum(b == "LDS" for _a, b in body)})
    loops.sort(key=lambda lp: -lp["int"])
    if len(loops) < 2:
        raise RuntimeError(f"expected two round loops in ctr_mk_kernel<{nr}>, found {back}")
    mixed, uniform = sorted(loops[:2], key=lambda lp: -lp["lds"])
    rounds = [mixed["range"], uniform["range"]]
    outside = sum(_is_int_op(b) for a, b, _t in ins
                  if not any(lo <= a <= hi for lo, hi in rounds))
    return {"uniform_round": uniform["int"], "mixed_round": mixed["int"],
            "outside_round_loops": outside,
            "uniform_group": uniform["int"] * (nr - 1) + outside,
            "mixed_group": mixed["int"] * (nr - 1) + outside}


def sass_chain_per_element(text: str, chain: int, ilp: int) -> dict:
    """LOP3s and integer instructions one element of
    ``chain_kernel<chain, ilp>`` costs, read from the compiled SASS: the body
    of the grid-stride loop (the one backward branch), which the source keeps
    rolled so that one trip is one element."""
    ins, back = sass_function(text, "chain_kernel", (chain, ilp))
    if len(back) != 1:
        raise RuntimeError(f"expected one backward branch in chain_kernel<{chain},{ilp}>, "
                           f"found {back}")
    lo, hi = back[0]
    body = [b for a, b, _t in ins if lo <= a <= hi]
    return {"lop3": sum(b == "LOP3" for b in body), "int": sum(_is_int_op(b) for b in body),
            "instructions": len(body)}


def _sass_dst_srcs(base: str, text: str) -> tuple[list, list]:
    """(general registers written, registers read) of one SASS instruction:
    the first operand is the destination when it is a register (its width
    from a .64/.128/.WIDE suffix); RZ, predicates and uniform registers are
    not counted."""
    if text.startswith("@"):
        text = text.split(None, 1)[1]
    parts = text.split(None, 1)
    ops = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 else []
    dst = []
    if ops and re.match(r"R\d+\b", ops[0]):
        opcode = parts[0]
        width = 4 if ".128" in opcode else 2 if (".64" in opcode or ".WIDE" in opcode
                                                 or ops[0].endswith(".64")) else 1
        r0 = int(re.match(r"R(\d+)", ops[0]).group(1))
        dst = list(range(r0, r0 + width))
        ops = ops[1:]
    srcs = []
    for o in ops:
        for m in re.finditer(r"\bR(\d+)(\.64)?", o):
            r = int(m.group(1))
            srcs += [r, r + 1] if m.group(2) else [r]
    return dst, srcs


def sass_dep_depth(ins: list, lo: int, hi: int) -> int:
    """The longest chain of dependent integer instructions among the SASS
    instructions at addresses [lo, hi] (one pass in program order, register
    def-use): the dependency depth of one trip through a loop body. Values
    live on entry, and loaded values, start at depth 0."""
    depth: dict = {}
    best = 0
    for addr, base, text in ins:
        if not lo <= addr <= hi:
            continue
        dst, srcs = _sass_dst_srcs(base, text)
        d = max((depth.get(r, 0) for r in srcs), default=0) + 1 if _is_int_op(base) else 0
        for r in dst:
            depth[r] = d
        best = max(best, d)
    return best


def sass_round_loops(text: str, kernel: str, targs) -> list:
    """The innermost loops of ``kernel``<targs> (loops that hold no other
    loop), largest first: [{"range", "int", "depth", "hist"}], ``int`` the
    integer instructions of one trip, ``depth`` its dependency depth
    (``sass_dep_depth``) and ``hist`` its integer opcodes by count. In the
    AES kernels the largest is the rolled round loop, one round a trip."""
    ins, back = sass_function(text, kernel, targs)
    inner = [(lo, hi) for lo, hi in back
             if not any((a, b) != (lo, hi) and lo <= a and b <= hi for a, b in back)]

    def hist(lo, hi):
        h: dict = {}
        for a, b, _t in ins:
            if lo <= a <= hi and _is_int_op(b):
                h[b] = h.get(b, 0) + 1
        return dict(sorted(h.items(), key=lambda kv: -kv[1]))

    loops = [{"range": (lo, hi), "int": sum(_is_int_op(b) for a, b, _t in ins if lo <= a <= hi),
              "depth": sass_dep_depth(ins, lo, hi), "hist": hist(lo, hi)} for lo, hi in inner]
    if not loops:
        raise RuntimeError(f"no loop in {kernel}<{targs}>")
    return sorted(loops, key=lambda lp: -lp["int"])


class SmiSampler:
    """``nvidia-smi`` reading the SM clock, power draw and temperature every
    100 ms in a child process (line-buffered through ``stdbuf`` where there
    is one), each sample stamped with nvidia-smi's own timestamp, so a late
    read does not shift it; ``between`` summarises the samples of a host
    wall-clock interval. ``close`` ends the child."""

    def __init__(self):
        self.samples: list = []
        cmd = ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,temperature.gpu",
               "--format=csv,noheader,nounits", "-lms", "100"]
        if shutil.which("stdbuf"):
            cmd = ["stdbuf", "-oL", *cmd]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                     text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            parts = [p.strip() for p in line.split(",")]
            try:
                t = datetime.datetime.strptime(parts[0], "%Y/%m/%d %H:%M:%S.%f").timestamp()
                self.samples.append((t, float(parts[1]), float(parts[2]), float(parts[3])))
            except (ValueError, IndexError):
                continue

    def between(self, t0: float, t1: float) -> dict:
        """Median SM clock (MHz), mean and peak power (W), peak temperature
        (C) of the samples in [t0, t1] (``time.time()`` seconds); raises if
        there are none."""
        deadline = time.time() + 3.0  # wait for the first sample after t1 to be read
        while time.time() < deadline and not (self.samples and self.samples[-1][0] >= t1):
            time.sleep(0.05)
        sel = [s for s in list(self.samples) if t0 <= s[0] <= t1]
        if not sel:
            raise RuntimeError(f"no nvidia-smi sample in a {t1 - t0:.3f} s window "
                               f"({len(self.samples)} samples in all)")
        return {"samples": len(sel), "clock_mhz": statistics.median(s[1] for s in sel),
                "power_w_mean": round(statistics.fmean(s[2] for s in sel), 2),
                "power_w_max": max(s[2] for s in sel), "temp_c_max": max(s[3] for s in sel)}

    def close(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def trace_kernels(path: str, t0_us: int, t1_us: int) -> dict:
    """The CUDA kernels and copies of an exported ``torch.profiler`` trace,
    clipped to the window [t0_us, t1_us] (epoch µs; the trace's times are
    ``baseTimeNanoseconds`` plus each event's ``ts``): count and µs per
    category, and the ``ctr_mk`` kernels (either form) among them."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    out = {"kernel_us": 0.0, "kernels": 0, "ctr_mk_kernels": 0, "memcpy_us": 0.0, "memcpys": 0,
           "kernels_in_trace": 0, "ctr_mk_in_trace": 0}
    for ev in doc.get("traceEvents", []):
        cat = ev.get("cat")
        if cat not in ("kernel", "gpu_memcpy") or "dur" not in ev:
            continue
        start = base_us + float(ev["ts"])
        end = start + float(ev["dur"])
        mk = cat == "kernel" and re.search(r"ctr_mk_(?:block_)?kernel", ev.get("name", "")) is not None
        out["kernels_in_trace"] += cat == "kernel"
        out["ctr_mk_in_trace"] += mk
        dur = min(end, t1_us) - max(start, t0_us)
        if dur <= 0:
            continue
        if cat == "kernel":
            out["kernel_us"] += dur
            out["kernels"] += 1
            out["ctr_mk_kernels"] += mk
        else:
            out["memcpy_us"] += dur
            out["memcpys"] += 1
    return out


def sass_weighted_path(ins: list, lo: int, hi: int, lds_cycles: float, alu_cycles: float) -> float:
    """The longest dependent path through the SASS instructions at [lo, hi]
    (one trip of a loop), in cycles: a shared-memory load (LDS) is ready
    ``lds_cycles`` after its address and after the issue of every earlier
    shared-memory store (a thread's shared-memory accesses stay in order), an
    integer instruction ``alu_cycles`` after its inputs; a store issues when
    its address and value are ready. Values live on entry start at 0."""
    ready: dict = {}
    last_store = 0.0
    best = 0.0
    for addr, base, text in ins:
        if not lo <= addr <= hi:
            continue
        dst, srcs = _sass_dst_srcs(base, text)
        start = max((ready.get(r, 0.0) for r in srcs), default=0.0)
        if base == "STS":
            last_store = max(last_store, start)
            continue
        if base == "LDS":
            done = max(start, last_store) + lds_cycles
        elif _is_int_op(base):
            done = start + alu_cycles
        else:
            continue
        for r in dst:
            ready[r] = done
        best = max(best, done)
    return best


def cpu_model() -> str:
    """The host CPU as ``lscpu`` names it (vendor, model name, family and
    model numbers, cores), for the native tier's rows; a virtual machine may
    report its model name as unknown."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return "not read"
    fields = {k.strip(): v for k, v in (ln.split(":", 1) for ln in out.splitlines() if ":" in ln)}
    keys = ("Vendor ID", "Model name", "CPU family", "Model", "CPU(s)", "Flags")
    got = {k: fields[k].strip() for k in keys if k in fields}
    if "Flags" in got:
        got["Flags"] = "aes" if " aes " in f" {got['Flags']} " else "no aes"
    return "; ".join(f"{k} {v}" for k, v in got.items()) or "not read"


def harness_rows(out: str) -> list[dict]:
    """The sweep's result rows: {row, bytes, times_us, gbps} (``gbps`` from
    its ``# derived:`` line, None for n/a), and for RC4 the keygen µs."""
    rows: list[dict] = []
    for line in out.splitlines():
        if re.match(r"(GPU AES-\d+ |C AES-\d+ |RC4)[^,]*, \d+, \d+,", line):
            parts = [p.strip() for p in line.split(",") if p.strip()]
            rows.append({"row": ", ".join(parts[:3]), "bytes": int(parts[1]),
                         "times_us": [int(p) for p in parts[3:]], "gbps": None})
        elif line.startswith("Generated a new key in") and rows:
            rows[-1]["keygen_us"] = int(line.split()[-1].rstrip(","))
        elif rows and re.fullmatch(r"(\d+, )*\d+,", line.strip()):
            rows[-1]["times_us"] = [int(p) for p in line.strip().rstrip(",").split(", ")]
        elif line.startswith("# derived:") and rows:
            m = re.match(r"# derived: ([0-9.e+-]+) GB/s", line)
            rows[-1]["gbps"] = float(m.group(1)) if m else None
    return rows


def mk_ops_per_group(nr: int) -> tuple[float, dict]:
    """Operations multi-key CTR needs for one group of 32 blocks: the ECB
    encrypt count (``ecb_ops_per_group``) plus the keystream XORed into the
    data (128 gates). Every group is credited as uniform: the per-block key
    planes of a mixed group (four transposes a round) are the cost of this
    layout, not work the function needs, so the bound is deliberately
    low."""
    ops, parts = ecb_ops_per_group(nr, decrypt=False)
    return ops + 128 / 2, {**parts, "data_xor": 128}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from our_tree_tpu_torch import bench
    from our_tree_tpu_torch.harness import ceiling
    from our_tree_tpu_torch.models import aes, arc4
    from our_tree_tpu_torch.ops import bitslice, cuda_aes, cuda_arc4
    from our_tree_tpu_torch.ops.keyschedule import expand_key_dec, expand_key_enc
    from our_tree_tpu_torch.runtime import cuda_build
    from our_tree_tpu_torch.utils import packing

    dev = torch.device("cuda")
    card = smi("name,power.limit")
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    wrappers = {"ctr_gen": cuda_aes.ctr_crypt_words_fused,
                "ecb_encrypt": cuda_aes.encrypt_words,
                "ecb_decrypt": cuda_aes.decrypt_words,
                "ctr_mk": cuda_aes.ctr_scattered_multikey,
                "ctr_mk_k1": cuda_aes.ctr_crypt_words_explicit,
                "chain": ceiling.chain,
                "seq_encrypt": cuda_aes.seq_encrypt,
                "arc4_prga": cuda_arc4.prga}
    mk_wrappers = {"ctr_mk": cuda_aes.ctr_scattered_multikey,
                   "ctr_mk_k1": cuda_aes.ctr_crypt_words_explicit}

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0
        for fn in mk_wrappers.values():
            fn.form_launches = {form: 0 for form in fn.form_launches}

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    def form_counts():
        """``ctr_mk`` launches by the form that ran, per wrapper."""
        return {name: dict(fn.form_launches) for name, fn in mk_wrappers.items()}

    # 1. Build.
    t0 = time.perf_counter()
    lib_path = str(cuda_build.library_path())
    # The shared-memory chase of phase 9 builds beside the kernels, at once.
    chase_dir = tempfile.mkdtemp(prefix="ot_chase_")
    atexit.register(shutil.rmtree, chase_dir, True)
    chase_cu, chase_so = os.path.join(chase_dir, "chase.cu"), os.path.join(chase_dir, "chase.so")
    with open(chase_cu, "w", encoding="utf-8") as fh:
        fh.write(CHASE_SOURCE)
    chase_build = subprocess.Popen(
        [shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", cuda_build.ARCH, "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-o", chase_so, chase_cu],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cuda_build.load()
    _, chase_err = chase_build.communicate(timeout=600)
    if chase_build.returncode:
        raise SystemExit(f"the shared-memory chase did not build:\n{chase_err[-3000:]}")
    log(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.basename(lib_path)} (and the "
        f"shared-memory chase)")
    ptxas = cuda_build.ptxas_kernels()
    for name, info in sorted(ptxas.items()):
        log(f"ptxas: {name}: {info}")

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

    def graph_ms(fn, reps=100):
        """Card time per call of ``fn`` with the host out of the way: ``reps``
        calls captured in one CUDA graph, replayed, timed with CUDA events.
        Each launch still pays the card's own launch cost; the host's issue
        time, which paces back-to-back launches of a kernel of a few µs,
        does not enter."""
        fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            graph.replay()
        stop.record()
        stop.synchronize()
        del graph
        return start.elapsed_time(stop) / (5 * reps)

    def random_words(n, seed):
        return torch.randint(-2**31, 2**31, (n, 4), dtype=torch.int32, device=dev,
                             generator=torch.Generator(dev).manual_seed(seed))

    def tensors(n, key, hexnonce, seed):
        nr, rk = expand_key_enc(key)
        ctr = packing.np_bytes_to_words(np.frombuffer(bytes.fromhex(hexnonce), np.uint8)).byteswap()
        return random_words(n, seed), packing.words_tensor(ctr, dev), packing.words_tensor(rk, dev), nr

    def diff(got, want):
        """(mismatching words, largest absolute difference of the u32 values)."""
        torch.cuda.synchronize()
        d = (got.long() & 0xFFFFFFFF) - (want.long() & 0xFFFFFFFF)
        return int((got != want).sum()), int(d.abs().max()) if d.numel() else 0

    def compare(w, ctr, rk, nr):
        return diff(cuda_aes.ctr_crypt_words_fused(w, ctr, rk, nr),
                    cuda_aes.ctr_crypt_words_fused_plain(w, ctr, rk, nr))

    def schedules(key):
        nr, rk = expand_key_enc(key)
        return nr, packing.words_tensor(rk, dev), packing.words_tensor(expand_key_dec(key)[1], dev)

    # 2. Kernels vs plain versions on the card.
    mismatches = 0
    cases = 0
    for bits in (128, 192, 256):
        key = np.random.default_rng(bits).integers(0, 256, bits // 8, dtype=np.uint8).tobytes()
        for hexnonce in WRAP_NONCES:
            for n in (1, 31, 33, 1000, 1 << 20):
                if n == 1 << 20 and hexnonce != WRAP_NONCES[1]:
                    continue  # 16 MiB once per key size, across a 64-bit carry
                m, _ = compare(*tensors(n, key, hexnonce, seed=n + bits))
                mismatches += m
                cases += 1
                if m:
                    log(f"MISMATCH ctr_gen bits={bits} nonce={hexnonce} n={n}: {m} words")
    log(f"ctr_gen vs plain: {cases} cases, {mismatches} mismatching words")
    if mismatches:
        raise SystemExit("ctr_gen disagrees with its plain version")
    ecb_mismatches = {"ecb_encrypt": 0, "ecb_decrypt": 0}
    for bits in (128, 192, 256):
        nr, rk, rk_dec = schedules(np.random.default_rng(bits).integers(
            0, 256, bits // 8, dtype=np.uint8).tobytes())
        for n in ECB_SIZES:
            w = random_words(n, seed=3 * n + bits)
            for name, kernel, plain, sched in (
                    ("ecb_encrypt", cuda_aes.encrypt_words, bitslice.encrypt_words, rk),
                    ("ecb_decrypt", cuda_aes.decrypt_words, bitslice.decrypt_words, rk_dec)):
                m, _ = diff(kernel(w, sched, nr), plain(w, sched, nr))
                ecb_mismatches[name] += m
                if m:
                    log(f"MISMATCH {name} bits={bits} n={n}: {m} words")
            del w
    log(f"ECB kernels vs plain: {3 * len(ECB_SIZES)} cases each (nr 10/12/14, N in {ECB_SIZES}), "
        f"mismatching words {ecb_mismatches}")
    if any(ecb_mismatches.values()):
        raise SystemExit("an ECB kernel disagrees with its plain version")

    def mk_stack(bits, k, seed):
        """(nr, (k, 4*(nr+1)) schedules of k random keys on the card)."""
        rng = np.random.default_rng(seed)
        rows = [expand_key_enc(rng.integers(0, 256, bits // 8, dtype=np.uint8).tobytes())
                for _ in range(k)]
        return rows[0][0], packing.words_tensor(np.stack([r for _, r in rows]), dev)

    def slot_runs(n, k, lengths, seed):
        """(n,) int32 slots on the card: runs of lengths drawn from
        ``lengths`` (a range or a menu), each on a random slot."""
        rng = np.random.default_rng(seed)
        parts, total = [], 0
        while total < n:
            part = rng.choice(lengths, size=(n - total) // int(np.mean(lengths)) + 16)
            parts.append(part)
            total += int(part.sum())
        runs = np.concatenate(parts)
        sl = np.repeat(rng.integers(0, k, runs.size), runs)[:n].astype(np.int32)
        return torch.from_numpy(sl).to(dev)

    mk_mismatch, mk_cases = 0, 0
    mk_form_mismatch = {form: 0 for form in cuda_aes.MK_FORMS}
    for bits in (128, 192, 256):
        for k in (1, 3, 8, 64):
            nr, rks = mk_stack(bits, k, seed=bits * k)
            zero_rks = rks.clone()
            zero_rks[(k + 1) // 2:] = 0
            for n in (1, 31, 33, 1000, 4096, 1 << 20):
                rng = np.random.default_rng(n * k + bits)
                patterns = {
                    "one slot": (rks, torch.full((n,), k - 1, dtype=torch.int32, device=dev)),
                    "runs 1-300": (rks, slot_runs(n, k, np.arange(1, 301), seed=n + k)),
                    "random per block": (rks, torch.from_numpy(
                        rng.integers(0, k, n).astype(np.int32)).to(dev)),
                    "zero schedules": (zero_rks, torch.from_numpy(
                        rng.integers(0, k, n).astype(np.int32)).to(dev)),
                }
                w, c = random_words(n, seed=5 * n + k), random_words(n, seed=7 * n + k)
                for name, (r, sl) in patterns.items():
                    want = cuda_aes.ctr_scattered_multikey_plain(w, c, r, sl, nr)
                    for form in cuda_aes.MK_FORMS:
                        m, _ = diff(cuda_aes.ctr_scattered_multikey(w, c, r, sl, nr, form=form),
                                    want)
                        mk_mismatch += m
                        mk_form_mismatch[form] += m
                        if m:
                            log(f"MISMATCH ctr_mk {form} form bits={bits} K={k} n={n} {name}: "
                                f"{m} words")
                    mk_cases += 1
    k1_mismatch, k1_cases = 0, 0
    for bits in (128, 192, 256):
        nr, rk, _ = schedules(np.random.default_rng(bits + 1).integers(
            0, 256, bits // 8, dtype=np.uint8).tobytes())
        for hexnonce in WRAP_NONCES:
            for n in (1, 33, 1000, 1 << 20):
                if n == 1 << 20 and hexnonce != WRAP_NONCES[1]:
                    continue
                ctr = packing.words_tensor(packing.np_ctr_le_blocks(
                    bytes.fromhex(hexnonce), np.arange(n)), dev)
                w = random_words(n, seed=11 * n + bits)
                want = cuda_aes.ctr_crypt_words_explicit_plain(w, ctr, rk, nr)
                for form in cuda_aes.MK_FORMS:
                    m, _ = diff(cuda_aes.ctr_crypt_words_explicit(w, ctr, rk, nr, form=form), want)
                    k1_mismatch += m
                    mk_form_mismatch[form] += m
                    if m:
                        log(f"MISMATCH ctr_mk K=1 entry, {form} form, bits={bits} "
                            f"nonce={hexnonce} n={n}: {m} words")
                k1_cases += 1
    log(f"ctr_mk vs plain: {mk_cases} cases, {mk_mismatch} mismatching words; its K = 1 entry "
        f"(ctr_crypt_words_explicit): {k1_cases} cases, {k1_mismatch} mismatching words; every "
        f"case in each form (auto, group forced, block forced), mismatching words by form "
        f"{mk_form_mismatch}; launches by form {form_counts()}")
    if mk_mismatch or k1_mismatch:
        raise SystemExit("ctr_mk disagrees with its plain version")
    # seq_encrypt, the chained CBC/CFB128 kernel, against its plain version
    # (the per-block loop). Up to 33 blocks the loop runs whole. At 4,096
    # blocks the loop's 4,096 launch-bound plain steps would take about a
    # minute a case, so every step of it is taken at once from the kernel's
    # own previous block, C_i = E(P_i ^ C_(i-1)) or P_i ^ E(C_(i-1)) for all
    # i in one batched plain encrypt; from C_(-1) = IV on, by induction, the
    # outputs equal the whole loop's exactly when every step agrees.
    def seq_plain_steps(w, ivs, out, rk, nr, cfb):
        prev = torch.cat([ivs[:, None], out[:, :-1]], dim=1)
        if cfb:
            return w ^ bitslice.encrypt_words(prev.reshape(-1, 4), rk, nr).reshape(w.shape)
        return bitslice.encrypt_words((w ^ prev).reshape(-1, 4), rk, nr).reshape(w.shape)

    seq_mismatch, seq_cases = 0, 0
    for bits in (128, 192, 256):
        nr, rk, _ = schedules(np.random.default_rng(bits + 2).integers(
            0, 256, bits // 8, dtype=np.uint8).tobytes())
        for cfb in (False, True):
            for s_n, n in ((s_n, n) for s_n in (1, 3, SEQ_BLOCKS) for n in (1, 2, 33, SEQ_BLOCKS)):
                w = random_words(s_n * n, seed=s_n + 13 * n + bits).reshape(s_n, n, 4)
                ivs = random_words(s_n, seed=s_n + bits + cfb)
                out, iv_out = cuda_aes.seq_encrypt(w, ivs, rk, nr, cfb)
                if n <= 33:
                    want, want_iv = cuda_aes.seq_encrypt_plain(w, ivs, rk, nr, cfb)
                else:
                    want, want_iv = seq_plain_steps(w, ivs, out, rk, nr, cfb), out[:, -1]
                m = diff(out, want)[0] + diff(iv_out, want_iv)[0]
                seq_mismatch += m
                seq_cases += 1
                if m:
                    log(f"MISMATCH seq_encrypt bits={bits} {'cfb128' if cfb else 'cbc'} S={s_n} "
                        f"N={n}: {m} words")
                del w, out
    log(f"seq_encrypt vs plain: {seq_cases} cases (nr 10/12/14, CBC and CFB128, S in 1, 3, "
        f"{SEQ_BLOCKS}, N in 1, 2, 33, {SEQ_BLOCKS}), {seq_mismatch} mismatching words")
    if seq_mismatch:
        raise SystemExit("seq_encrypt disagrees with its plain version")
    chain_words = ceiling.words(PROBE_BYTES)
    chain_mismatch, chain_cases = 0, 0
    for name, c, i in ceiling.REGIMES:
        for n in (1, 31, 4097, (1 << 20) + 3, chain_words):
            x = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                              generator=torch.Generator(dev).manual_seed(n + 10 * i + c))
            m, _ = diff(ceiling.chain(x, c, i), ceiling.chain_plain(x, c, i))
            chain_mismatch += m
            chain_cases += 1
            if m:
                log(f"MISMATCH chain {name} n={n}: {m} words")
    lat_x = torch.tensor([0x2468ACE], dtype=torch.int32, device=dev)
    m, _ = diff(ceiling.chain(lat_x, *ceiling.LATENCY[1:]), ceiling.chain_plain(lat_x, *ceiling.LATENCY[1:]))
    chain_mismatch += m
    chain_cases += 1
    log(f"chain vs plain: {chain_cases} cases (four regimes, n up to {chain_words}, and the "
        f"{ceiling.LATENCY[1]}-step latency chain over one word), {chain_mismatch} mismatching words")
    if chain_mismatch:
        raise SystemExit("chain disagrees with its plain version")
    # arc4_prga against prga_plain: the keystream, the fused XOR and a resume
    # across two calls (a third of the bytes, then the rest), for every
    # streams x bytes pair. The plain version runs once a length on 4,096
    # streams (timed for the kernels line); a launch on S streams is held
    # against its first S rows.
    def arc4_states(s_n, seed):
        rng = np.random.default_rng(seed)
        m = np.stack([rng.permutation(256) for _ in range(s_n)])
        return arc4.state_from_numpy((rng.integers(0, 256, s_n), rng.integers(0, 256, s_n), m),
                                     dev)

    def byte_diff(got, want):
        """(mismatching elements, largest absolute difference among them)."""
        ne = got != want
        bad = int(ne.sum())
        if not bad:
            return 0, 0
        return bad, int((got[ne].to(torch.int64) - want[ne].to(torch.int64)).abs().max())

    arc4_bad, arc4_cases, arc4_inputs = 0, 0, {}
    for n in ARC4_LENGTHS:
        st = arc4_states(ARC4_PLAIN_STREAMS, seed=31 + n)
        data = torch.randint(0, 256, (ARC4_PLAIN_STREAMS, n), dtype=torch.uint8, device=dev,
                             generator=torch.Generator(dev).manual_seed(n))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_st, want = cuda_arc4.prga_plain(st, n)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        want_x = data ^ want
        err = 0
        for s_n in ARC4_STREAMS:
            st_s, data_s, cut = st[:s_n], data[:s_n], n // 3
            got_st, got = cuda_arc4.prga(st_s, n)
            f_st, fused = cuda_arc4.prga(st_s, n, data_s)
            mid, first = cuda_arc4.prga(st_s, cut, data_s[:, :cut].contiguous())
            end, second = cuda_arc4.prga(mid, n - cut, data_s[:, cut:].contiguous())
            torch.cuda.synchronize()
            diffs = [byte_diff(got, want[:s_n]), byte_diff(fused, want_x[:s_n]),
                     byte_diff(first, want_x[:s_n, :cut]), byte_diff(second, want_x[:s_n, cut:])]
            bad = (sum(m for m, _ in diffs)
                   + sum(byte_diff(x, want_st[:s_n])[0] for x in (got_st, f_st, end)))
            err = max([err] + [e for _, e in diffs])
            arc4_bad += bad
            arc4_cases += 1
            if bad:
                log(f"MISMATCH arc4_prga S={s_n} bytes={n}: {bad} bytes or state words")
            del got, fused, first, second
        arc4_inputs[n] = {"states": st, "plain_ms": plain_s * 1e3, "max_abs_err": err}
        del data, want, want_x, want_st
    torch.cuda.empty_cache()
    log(f"arc4_prga vs plain: {arc4_cases} cases (S in {ARC4_STREAMS} x bytes in {ARC4_LENGTHS}, "
        f"against the plain version's first S of {ARC4_PLAIN_STREAMS} streams), each keystream, "
        f"fused XOR and a resume across two calls: {arc4_bad} mismatching bytes or state words; "
        f"the plain version on {ARC4_PLAIN_STREAMS} streams "
        f"{ {n: round(v['plain_ms'], 1) for n, v in arc4_inputs.items()} } ms by length")
    if arc4_bad:
        raise SystemExit("arc4_prga disagrees with its plain version")

    # 3. KATs and chunked resume through the AES context on the card.
    kat_key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    ctr0 = np.frombuffer(bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"), np.uint8)
    pt = bytes.fromhex(SP800_PT)
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
    iv = np.frombuffer(bytes.fromhex(SP800_IV), np.uint8)
    seq_before = cuda_aes.seq_encrypt.launches
    for bits, (key_hex, ecb_hex, cbc_hex) in SP800_ECB_CBC.items():
        kctx = aes.AES(bytes.fromhex(key_hex))
        if kctx.engine != aes.CUDA_ENGINE:
            raise SystemExit(f"AES-{bits} on the card resolved to {kctx.engine}")
        checks = [
            kctx.crypt_ecb(aes.AES_ENCRYPT, pt).tobytes().hex() == ecb_hex,
            kctx.crypt_ecb(aes.AES_DECRYPT, bytes.fromhex(ecb_hex)).tobytes().hex() == SP800_PT,
            kctx.crypt_cbc(aes.AES_ENCRYPT, iv, pt)[0].tobytes().hex() == cbc_hex,
            kctx.crypt_cbc(aes.AES_DECRYPT, iv, bytes.fromhex(cbc_hex))[0].tobytes().hex() == SP800_PT,
        ]
        if bits == 128:
            checks += [
                ctx.crypt_cfb128(aes.AES_ENCRYPT, 0, iv, pt)[0].tobytes().hex() == SP800_CFB128,
                ctx.crypt_cfb128(aes.AES_DECRYPT, 0, iv,
                                 bytes.fromhex(SP800_CFB128))[0].tobytes().hex() == SP800_PT,
            ]
        if not all(checks):
            raise SystemExit(f"NIST SP800-38A KAT failed for AES-{bits}: {checks}")
    # The three CBC encrypts and the CFB128 encrypt each ran the chained kernel
    # once; F.2.1 and F.3.13 once more through its entries, straight.
    kat_seq = cuda_aes.seq_encrypt.launches - seq_before
    nr, rk, _ = schedules(kat_key)
    pt_w = packing.words_tensor(packing.np_bytes_to_words(np.frombuffer(pt, np.uint8)), dev)
    iv_w = packing.words_tensor(packing.np_bytes_to_words(iv), dev)
    straight = {
        "F.2.1": (cuda_aes.cbc_encrypt_words_seq, SP800_ECB_CBC[128][2]),
        "F.3.13": (cuda_aes.cfb128_encrypt_words_seq, SP800_CFB128),
    }
    for name, (fn, want_hex) in straight.items():
        ct_w, iv_out = fn(pt_w.reshape(4, 4), iv_w, rk, nr)
        got_hex = packing.np_words_to_bytes(packing.words_numpy(ct_w).reshape(-1)).tobytes().hex()
        if got_hex != want_hex or got_hex[-32:] != packing.np_words_to_bytes(
                packing.words_numpy(iv_out)).tobytes().hex():
            raise SystemExit(f"NIST SP800-38A {name} through seq_encrypt failed")
    if kat_seq != 4 or cuda_aes.seq_encrypt.launches - seq_before != 6:
        raise SystemExit(f"the CBC/CFB128 KATs made {kat_seq} seq_encrypt launches, not 4")
    log("NIST SP800-38A F.1 and F.2 (ECB, CBC; 128/192/256, both directions) and F.3.13 "
        "(CFB128-AES128, both directions) through AES on the card: pass; its CBC and CFB128 "
        f"encrypts made {kat_seq} seq_encrypt launches (one a call); F.2.1 and F.3.13 through "
        "cbc_encrypt_words_seq and cfb128_encrypt_words_seq (the chained kernel), ciphertext and "
        "new IV: pass")
    # F.5.1 in slot 3 of 8 through the serve seam, other tenants interleaved
    # and slots 6-7 empty.
    others = [np.random.default_rng(29 + i).integers(0, 256, 16, dtype=np.uint8).tobytes()
              for i in range(5)]
    rows = [expand_key_enc(k)[1] for k in others[:3] + [kat_key] + others[3:]]
    rks8 = packing.words_tensor(np.stack(rows + [np.zeros_like(rows[0])] * 2), dev)
    kat_slots = np.array([3, 0, 1, 3, 4, 3, 5, 2, 3, 0], np.int32)
    kat_ctr = np.random.default_rng(30).integers(0, 2**32, (10, 4), dtype=np.uint64).astype(np.uint32)
    kat_ctr[kat_slots == 3] = packing.np_ctr_le_blocks(ctr0.tobytes(), np.arange(4))
    kat_data = np.random.default_rng(31).integers(0, 256, (10, 16), dtype=np.uint8)
    kat_data[kat_slots == 3] = np.frombuffer(pt, np.uint8).reshape(4, 16)
    out = aes.ctr_crypt_words_scattered_multikey(
        packing.words_tensor(packing.np_bytes_to_words(kat_data.reshape(-1)), dev),
        packing.words_tensor(kat_ctr.reshape(-1), dev), rks8,
        torch.from_numpy(kat_slots).to(dev), 10, aes.CUDA_ENGINE)
    got = packing.np_words_to_bytes(packing.words_numpy(out)).reshape(10, 16)
    if got[kat_slots == 3].tobytes().hex() != ct:
        raise SystemExit("NIST SP800-38A F.5.1 in slot 3 of 8 failed")
    log("NIST SP800-38A F.5.1 CTR-AES128 in slot 3 of 8 (ctr_crypt_words_scattered_multikey, "
        "CUDA engine): pass")

    # 4. The CTR main path, counted.
    reset_counts()
    line = bench.run(device=dev, nbytes=MAIN_BYTES, iters=5, reps=3)
    ctr_counts = counts()
    log(json.dumps(line))
    if f"digest={MAIN_DIGEST:#010x}" not in line["metric"]:
        raise SystemExit(f"main path digest is not {MAIN_DIGEST:#010x}: {line['metric']}")
    if ctr_counts["ctr_gen"] <= 0:
        raise SystemExit("the CTR main path launched no ctr_gen kernel")
    ctr_gbps = line["value"]
    log(f"CTR main path: {line['value']} GB/s median (min {line['value_min']}, max "
        f"{line['value_max']}, {line['reps']} reps), launches {ctr_counts}; card: {card}")

    # 5. The block-mode path at 256 MiB, counted.
    nr, rk, rk_dec = schedules(bench.KEY)
    host = np.random.default_rng(bench.SEED).integers(0, 256, MAIN_BYTES, dtype=np.uint8)
    words = packing.words_tensor(packing.np_bytes_to_words(host), dev).reshape(-1, 4)
    ivw = packing.words_tensor(packing.np_bytes_to_words(
        np.frombuffer(bytes.fromhex(BLOCK_IV), np.uint8)), dev)
    eng = aes.CUDA_ENGINE
    reset_counts()
    t0 = time.perf_counter()
    ecb_ct = aes.ecb_encrypt_words(words, rk, nr, eng)
    ecb_pt = aes.ecb_decrypt_words(ecb_ct, rk_dec, nr, eng)
    cbc_pt, cbc_iv = aes.cbc_decrypt_words(words, ivw, rk_dec, nr, eng)
    cfb_pt, cfb_iv = aes.cfb128_decrypt_words(words, ivw, rk, nr, eng)
    seq_calls = {}

    def sequential(name, fn, *args):
        """One sequential encrypt, its launches counted on their own: one
        seq_encrypt launch and no ECB launch."""
        before = counts()
        res = fn(*args)
        seq_calls[name] = {k: v - before[k] for k, v in counts().items() if v != before[k]}
        return res

    cbc_re, _ = sequential("cbc_encrypt_words", aes.cbc_encrypt_words, cbc_pt[:SEQ_BLOCKS], ivw,
                           rk, nr, eng)
    cfb_re, _ = sequential("cfb128_encrypt_words", aes.cfb128_encrypt_words,
                           cfb_pt[:SEQ_BLOCKS], ivw, rk, nr, eng)
    streams = words[:SEQ_BLOCKS * 64].reshape(SEQ_BLOCKS, 64, 4)
    stream_ivs = words[-SEQ_BLOCKS:].contiguous()
    batch_ct, batch_iv = sequential("cbc_encrypt_words_batch", aes.cbc_encrypt_words_batch,
                                    streams, stream_ivs, rk, nr, eng)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    block_counts = counts()
    log(f"block-mode path at {MAIN_BYTES >> 20} MiB: {path_s:.3f} s, launches {block_counts}; "
        f"the sequential encrypts' own launches {seq_calls}")
    if block_counts["ecb_encrypt"] <= 0 or block_counts["ecb_decrypt"] <= 0:
        raise SystemExit(f"the block-mode path did not launch both ECB kernels: {block_counts}")
    if any(c != {"seq_encrypt": 1} for c in seq_calls.values()):
        raise SystemExit(f"a sequential encrypt did not make exactly one seq_encrypt launch and "
                         f"nothing else: {seq_calls}")
    checks = {
        "ecb round trip": bool(torch.equal(ecb_pt, words)),
        "ecb_encrypt == plain": diff(ecb_ct, bitslice.encrypt_words(words, rk, nr))[0] == 0,
        "ecb_decrypt == plain": diff(ecb_pt, bitslice.decrypt_words(ecb_ct, rk_dec, nr))[0] == 0,
        "cbc_decrypt == plain": diff(cbc_pt, aes.cbc_decrypt_words(
            words, ivw, rk_dec, nr, aes.PLAIN_ENGINE)[0])[0] == 0,
        "cfb128_decrypt == plain": diff(cfb_pt, aes.cfb128_decrypt_words(
            words, ivw, rk, nr, aes.PLAIN_ENGINE)[0])[0] == 0,
        "decrypt ivs": bool(torch.equal(cbc_iv, words[-1]) and torch.equal(cfb_iv, words[-1])),
        f"cbc_encrypt of {SEQ_BLOCKS} recovered blocks": bool(torch.equal(cbc_re, words[:SEQ_BLOCKS])),
        f"cfb128_encrypt of {SEQ_BLOCKS} recovered blocks": bool(torch.equal(cfb_re, words[:SEQ_BLOCKS])),
    }
    # The batch's streams decrypt back in one ECB call: P = D(C) ^ C_prev.
    prev = torch.cat([stream_ivs[:, None], batch_ct[:, :-1]], dim=1)
    back = cuda_aes.decrypt_words(batch_ct.reshape(-1, 4), rk_dec, nr).reshape(batch_ct.shape) ^ prev
    checks[f"cbc_encrypt_words_batch {SEQ_BLOCKS} x 64"] = bool(
        torch.equal(back, streams) and torch.equal(batch_iv, batch_ct[:, -1]))
    log(f"block-mode checks: {checks}")
    if not all(checks.values()):
        raise SystemExit(f"block-mode path check failed: {checks}")

    # 6. The hex CLI on the card: F.1.2, ECB-AES128 decrypt.
    key_hex, ecb_hex, _ = SP800_ECB_CBC[128]
    res = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.harness.decrypt", key_hex,
                          ecb_hex[:32]], cwd=ROOT, capture_output=True, text=True, timeout=600)
    if res.returncode != 0 or res.stdout.strip() != SP800_PT[:32]:
        raise SystemExit(f"CLI on the card: rc {res.returncode}, out {res.stdout!r}, "
                         f"err {res.stderr[-2000:]!r}")
    log(f"CLI on the card: decrypt F.1.2 block 1 -> {res.stdout.strip()}: pass")

    # 7. The ceiling probe: its entry point counted in this process, the CLI
    # in its own, then each regime's kernel alone with the clock sampled.
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ceiling.main([])
    probe_counts = counts()
    probe_line = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0 or probe_counts["chain"] <= 0 or any(
            v for n, v in probe_counts.items() if n != "chain"):
        raise SystemExit(f"the ceiling probe's path: rc {rc}, launches {probe_counts}")
    log(f"ceiling probe in this process: launches {probe_counts}")
    res = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.harness.ceiling"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    try:
        cli_line = json.loads(res.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        cli_line = None
    if res.returncode != 0 or cli_line is None:
        raise SystemExit(f"the ceiling probe's CLI: rc {res.returncode}, out "
                         f"{res.stdout[-2000:]!r}, err {res.stderr[-2000:]!r}")
    for text in res.stdout.strip().splitlines()[:-1]:
        log(f"probe CLI: {text}")
    log(json.dumps(cli_line))
    keys = {"chain", "ilp", "sec", "t_ops_per_s", "mem_gb_per_s"}
    if not (cli_line["platform"] == probe_line["platform"] == "gpu"
            and cli_line["device_kind"] == torch.cuda.get_device_name(0)
            and cli_line["bytes"] == PROBE_BYTES
            and all(set(cli_line[n]) == keys for n, _c, _i in ceiling.REGIMES)):
        raise SystemExit(f"the ceiling probe's line lacks the reference's keys: {cli_line}")

    sass_text = sass(lib_path)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    int_ops_per_ms = sm_count * INT_OPS_PER_CLK_PER_SM * clock_mhz * 1e3
    sampler = SmiSampler()
    atexit.register(sampler.close)  # the child ends with the script, however it ends

    def sampled_ms(fn):
        """(ms per launch, the sampler's summary) of back-to-back launches of
        ``fn`` lasting at least ``SAMPLED_S``."""
        reps = max(int(SAMPLED_S * 1e3 / events_ms(fn, 3)), 10)
        t0 = time.time()
        ms = events_ms(fn, reps)
        return ms, sampler.between(t0, time.time())

    x = torch.arange(chain_words, dtype=torch.int32, device=dev)
    regimes = {}
    for name, c, i in ceiling.REGIMES:
        ms, clocks = sampled_ms(lambda c=c, i=i: ceiling.chain(x, c, i))
        regimes[name] = {"chain": c, "ilp": i, "ms": ms, "smi": clocks,
                         **sass_chain_per_element(sass_text, c, i)}
    stream_bytes_per_s = 8 * chain_words / (regimes["stream"]["ms"] / 1e3)
    for name, r in regimes.items():
        per_s = r["int"] * chain_words / (r["ms"] / 1e3)
        r["int_per_clk_per_sm"] = per_s / (sm_count * r["smi"]["clock_mhz"] * 1e6)
        r["int_per_clk_per_sm_at_max"] = per_s / (sm_count * clock_mhz * 1e6)
        r["lop3_per_clk_per_sm"] = r["int_per_clk_per_sm"] * r["lop3"] / r["int"]
        r["t_ops_per_s"] = chain_words * ceiling.ops_per_word(r["chain"], r["ilp"]) / (
            r["ms"] / 1e3) / 1e12
        log(f"probe {name} (chain {r['chain']}, ilp {r['ilp']}) alone: {r['ms']:.4f} ms per "
            f"{PROBE_BYTES >> 20} MiB launch; SASS per element {r['lop3']} LOP3 of {r['int']} "
            f"integer ({r['instructions']} in the loop); {r['int_per_clk_per_sm']:.2f} integer "
            f"results/clk/SM at the sampled {r['smi']['clock_mhz']:.0f} MHz "
            f"({r['int_per_clk_per_sm_at_max']:.2f} at the {clock_mhz:.0f} MHz maximum; LOP3 "
            f"{r['lop3_per_clk_per_sm']:.2f}) against the table's {INT_OPS_PER_CLK_PER_SM}; "
            f"{r['t_ops_per_s']:.3f} T logical ops/s by the reference's count; "
            f"{8 * chain_words / (r['ms'] / 1e3) / 1e12:.4f} TB/s moved; nvidia-smi "
            f"{r['smi']}; card: {card}")
    for name, r in regimes.items():
        if r["chain"] == 1:
            continue
        steps = r["chain"] * r["ilp"]
        if not steps <= r["lop3"] <= 1.1 * steps + 4 * r["ilp"] + 8:
            raise SystemExit(f"chain_kernel<{r['chain']},{r['ilp']}> holds {r['lop3']} LOP3 per "
                             f"element, not about {steps}: it no longer measures the chain")
    if regimes["compute-ilp8"]["int_per_clk_per_sm"] < 0.1 * INT_OPS_PER_CLK_PER_SM:
        raise SystemExit("compute-ilp8 ran under 10 % of the table's integer rate: the probe "
                         "is broken")
    top = max((r for r in regimes.values() if r["chain"] > 1),
              key=lambda r: r["int"] / r["ms"])
    int_per_s = top["int"] * chain_words / (top["ms"] / 1e3)
    measured = {"int_results_per_clk_per_sm": top["int_per_clk_per_sm"],
                "at_max_clock": top["int_per_clk_per_sm_at_max"],
                "sampled_clock_mhz": top["smi"]["clock_mhz"], "from": f"chain_kernel<"
                f"{top['chain']},{top['ilp']}>", "int_per_s": int_per_s,
                "stream_bytes_per_s": stream_bytes_per_s}
    mk_ops10 = mk_ops_per_group(10)[0]
    ceiling_gbps = 1 / max(1 / stream_bytes_per_s, mk_ops10 / (52 * 32) / int_per_s) / 1e9
    log(f"measured: {int_per_s / 1e12:.4f} T integer instructions/s = "
        f"{measured['int_results_per_clk_per_sm']:.2f} results/clk/SM at the sampled "
        f"{measured['sampled_clock_mhz']:.0f} MHz, {measured['at_max_clock']:.2f} at the "
        f"{clock_mhz:.0f} MHz maximum (table: {INT_OPS_PER_CLK_PER_SM}), from {measured['from']}; "
        f"stream {stream_bytes_per_s / 1e12:.4f} TB/s ({100 * stream_bytes_per_s / HBM_BYTES_PER_S:.1f} "
        f"% of the data sheet's {HBM_BYTES_PER_S / 1e12:.2f}); ctr_mk ceiling (nr 10, "
        f"{mk_ops10} operations per 52 x 32 bytes) {ceiling_gbps:.2f} GB/s of modeled traffic; "
        f"card: {card}")

    def measured_bound(ops: float, nbytes: float) -> tuple[float, str]:
        """The least time at the measured rates: (ms, what bounds it)."""
        ops_ms, bytes_ms = ops / int_per_s * 1e3, nbytes / stream_bytes_per_s * 1e3
        return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"

    # 8. The serve path: the JAX package's two documented drives, counted.
    from our_tree_tpu_torch.serve import bench as serve_bench

    def log_first_dispatch(name, line):
        first, d = line["device"]["first_dispatch"], line["device"]
        log(f"serve {name} first traffic dispatch (rung {first['rung']}): window "
            f"{first['window_us']} µs = worker wait {first['worker_wait_us']} + staging "
            f"{first['staging_us']} + card {first['device_us']} + host rest "
            f"{first['host_us']} µs; all dispatches' p50: window {d['window_p50_us']} µs, "
            f"card {d['device_p50_us']} µs; card: {card}")

    def serve_drive(name, argv):
        reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = serve_bench.main(argv)
        wall = time.perf_counter() - t0
        lines = buf.getvalue().strip().splitlines()
        for text in lines[:-1]:
            log(f"serve {name}: {text}")
        line = json.loads(lines[-1])
        got = counts()
        forms = form_counts()["ctr_mk"]
        rung_forms = {r: cuda_aes.MK_FORMS[cuda_build.load().ot_ctr_mk_form(r, 0)]
                      for r in line["config"]["rungs"]}
        dev_stats = line["device"]
        stages = {st: (v["p50_us"], v["p95_us"]) for st, v in line["stages"].items()}
        log(f"serve {name} ({' '.join(argv)}): p50 {line['p50_ms']} ms, p95 {line['p95_ms']} ms, "
            f"p99 {line['p99_ms']} ms, goodput {line['goodput_gbps']} GB/s, "
            f"{dev_stats['dispatches_per_s']} dispatches/s, coalesce "
            f"{line['coalesce_efficiency']}, slot fill {line['slot_fill']}, occupancy "
            f"{line['occupancy']}; stages (p50, p95) µs {stages}; lanes busy "
            f"{dev_stats['busy_s']} s = staging {dev_stats['staging_s']} s + card "
            f"{dev_stats['device_s']} s (device share {dev_stats['device_share']}) + rest, fence "
            f"{dev_stats['fence_s']} s; launches {got}; ctr_mk launches by form {forms} (the auto "
            f"form of each rung: {rung_forms}); {wall:.1f} s wall; card: {card}")
        log_first_dispatch(name, line)
        checks = {
            "rc 0": rc == 0,
            "CUDA engine": line["engine"] == aes.CUDA_ENGINE,
            "0 lost": line["lost"] == 0,
            "0 failed": line["errors"] == {} and line["ok"] == line["requests"],
            "0 mismatches": line["mismatches"] == 0 and line["verified"] > 0,
            "0 steady builds": line["recompiles"] == 0,
            "ctr_mk launches == engine calls": got["ctr_mk"] == line["engine_calls"] > 0,
            "no other kernel": all(v == 0 for n, v in got.items() if n != "ctr_mk"),
            "ctr_mk forms sum to its launches": sum(forms.values()) == got["ctr_mk"],
            "each rung's auto form served": all(
                forms[f] > 0 for f in set(rung_forms.values())) and all(
                forms[f] == 0 for f in forms if f not in rung_forms.values()),
        }
        if "--min-coalesce" in argv:
            checks["coalesce >= 0.5"] = line["coalesce_efficiency"] >= 0.5
        if not all(checks.values()):
            raise SystemExit(f"serve drive {name} failed: {checks}")
        return line, got, forms

    line_a, counts_a, forms_a = serve_drive("A", ["--requests", "500", "--mixed-sizes"])
    line_b, counts_b, forms_b = serve_drive("B", ["--requests", "300", "--tenant-heavy",
                                          "--min-coalesce", "0.5"])
    # Drive A's mix in a fresh process: there the lane's warmup is the first
    # contact with the card (context, library load, first ctr_mk<10> launch).
    argv = ["--requests", "500", "--mixed-sizes"]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.serve.bench", *argv],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    try:
        line = json.loads(res.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        line = None
    if res.returncode != 0 or line is None:
        raise SystemExit(f"serve bench in a fresh process: rc {res.returncode}, "
                         f"out {res.stdout[-2000:]!r}, err {res.stderr[-2000:]!r}")
    checks = {"CUDA engine": line["engine"] == aes.CUDA_ENGINE, "0 lost": line["lost"] == 0,
              "0 failed": line["errors"] == {} and line["ok"] == line["requests"],
              "0 mismatches": line["mismatches"] == 0 and line["verified"] > 0,
              "warmup counted the library load and the first launch":
                  line["compiles"]["warmup"] >= 2,
              "0 steady": line["compiles"]["steady"] == 0}
    log(f"serve A in a fresh process: p50 {line['p50_ms']} ms, p99 {line['p99_ms']} ms, "
        f"builds/loads/first launches: warmup {line['compiles']['warmup']}, steady "
        f"{line['compiles']['steady']}; {wall:.1f} s wall with start-up; card: {card}")
    log_first_dispatch("A (fresh process)", line)
    if not all(checks.values()):
        raise SystemExit(f"serve bench in a fresh process failed: {checks}")

    # 9. Each kernel at its path's shape: time, plain time, both bounds.
    kernels = []

    def timing(name, kernel_fn, plain_fn, got, want, fn_ops, parts, nbytes, nblocks, sass_ops,
               plain_reps=2, nr=10, sass_upper_bound=False):
        """Time one kernel (at least ``SAMPLED_S`` of launches, the SM clock
        sampled) and its plain version at one shape; the entry fields of the
        ``kernels`` line. Bounds: the table rate at the maximum clock
        (``bound_ms``) and at the sampled one, and the probe's measured
        rates (``bound_ms_measured``). ``sass_upper_bound``: ``sass_ops``
        over-counts the stream (``sass_mk_per_thread``), so it is reported
        as a bound and no share of the kernel's time is read from it."""
        m, max_err = diff(got, want)
        if m:
            raise SystemExit(f"{name} vs plain at the path's shape: {m} mismatching words")
        ms, clocks = sampled_ms(kernel_fn)
        plain_ms = events_ms(plain_fn, plain_reps)
        groups = -(-nblocks // 32)
        ops_ms = groups * fn_ops / int_ops_per_ms
        sass_ms = groups * sass_ops / int_ops_per_ms
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        sampled_mhz = clocks["clock_mhz"]
        at_sampled = max(ops_ms * clock_mhz / sampled_mhz, bytes_ms)
        meas_ms, meas_by = measured_bound(groups * fn_ops, nbytes)
        size = f"{nblocks * 16 >> 20} MiB" if nblocks * 16 >= 1 << 20 else f"{nblocks} blocks"
        log(f"{name} at {size}: {ms:.4f} ms/launch ({nblocks * 16 / ms / 1e6:.2f} GB/s), plain "
            f"{plain_ms:.2f} ms; ptxas {ptxas.get(name.split()[0] + '_kernel<' + str(nr) + '>')}; "
            f"card: {card}")
        log(f"{name} bound: {fn_ops} operations per group of 32 blocks ({parts}) x {groups} groups / "
            f"({sm_count} SMs x {INT_OPS_PER_CLK_PER_SM}/clk x {clock_mhz:.0f} MHz) = "
            f"{ops_ms:.4f} ms; bytes {bytes_ms:.4f} ms; kernel at "
            f"{100 * max(ops_ms, bytes_ms) / ms:.1f} % of the bound at the maximum clock, "
            f"{100 * at_sampled / ms:.1f} % of {at_sampled:.4f} ms at the sampled "
            f"{sampled_mhz:.0f} MHz (nvidia-smi {clocks})")
        log(f"{name} bound at the measured rates ({int_per_s / 1e12:.4f} T integer "
            f"instructions/s, {stream_bytes_per_s / 1e12:.4f} TB/s): {meas_ms:.4f} ms "
            f"({meas_by}), kernel at {100 * meas_ms / ms:.1f} %")
        sass_meas_ms = groups * sass_ops / int_per_s * 1e3
        if sass_upper_bound:
            log(f"{name} own stream: at most {sass_ops} SASS integer instructions per group, "
                f"at most {sass_ops / fn_ops:.3f}x the operations")
        else:
            log(f"{name} own stream: {sass_ops} SASS integer instructions per group, "
                f"{sass_ops / fn_ops:.3f}x the operations ({sass_ms:.4f} ms at the table rate, "
                f"kernel at {100 * sass_ms / ms:.1f} % of that at the maximum clock, "
                f"{100 * sass_ms * clock_mhz / sampled_mhz / ms:.1f} % at the sampled clock; "
                f"{sass_meas_ms:.4f} ms at the measured rate, kernel at "
                f"{100 * sass_meas_ms / ms:.1f} %)")
        sass_key = ("sass_instructions_per_group_upper_bound" if sass_upper_bound
                    else "sass_instructions_per_group")
        return {"mismatches": m, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "bound_ms_at_sampled_clock": at_sampled, "sampled_clock_mhz": sampled_mhz,
                "bound_ms_measured": meas_ms, "bound_by_measured": meas_by,
                "measured_int_results_per_clk_per_sm": measured["int_results_per_clk_per_sm"],
                "ops_per_group": fn_ops, sass_key: sass_ops}

    def measure(name, source, replaces, kernel_fn, plain_fn, got, want, fn_ops, parts,
                nbytes, launches):
        sass_ops, hist = sass_int_ops_per_thread(sass_text, f"{name}_kernel", nr)
        entry = timing(name, kernel_fn, plain_fn, got, want, fn_ops, parts, nbytes,
                       MAIN_BYTES // 16, sass_ops, nr=nr)
        log(f"{name} top opcodes {list(hist.items())[:8]}")
        if name.startswith("ecb_"):
            loop = sass_round_loops(sass_text, f"{name}_kernel", nr)[0]
            entry["sass_round_loop"] = loop
            log(f"{name} round loop (one round a trip): {loop['int']} integer instructions, "
                f"dependency depth {loop['depth']}, opcodes {loop['hist']}; ptxas "
                f"{ptxas.get(f'{name}_kernel<{nr}>')}")
        kernels.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches, **entry, "library_ms": None})

    w, ctr, rk_ctr, nr = tensors(MAIN_BYTES // 16, bench.KEY, WRAP_NONCES[4], seed=1337)
    measure("ctr_gen", "our_tree_tpu_torch/csrc/ctr_gen.cu", "our_tree_tpu/ops/pallas_aes.py:601",
            lambda: cuda_aes.ctr_crypt_words_fused(w, ctr, rk_ctr, nr),
            lambda: cuda_aes.ctr_crypt_words_fused_plain(w, ctr, rk_ctr, nr),
            cuda_aes.ctr_crypt_words_fused(w, ctr, rk_ctr, nr),
            cuda_aes.ctr_crypt_words_fused_plain(w, ctr, rk_ctr, nr),
            *ctr_ops_per_group(nr), 2 * w.numel() * 4 + 4 * 4 + rk_ctr.numel() * 4,
            ctr_counts["ctr_gen"])
    out = cuda_aes.ctr_crypt_words_fused(w, ctr, rk_ctr, nr)
    sum_ms = events_ms(lambda: bench.u32_sum(out), 10)
    log(f"chain step besides the kernel: digest sum {sum_ms:.4f} ms at {MAIN_BYTES >> 20} MiB")
    del w, out
    ecb_bytes = 2 * words.numel() * 4 + rk.numel() * 4
    measure("ecb_encrypt", "our_tree_tpu_torch/csrc/ecb.cu", "our_tree_tpu/ops/pallas_aes.py:259",
            lambda: cuda_aes.encrypt_words(words, rk, nr),
            lambda: bitslice.encrypt_words(words, rk, nr),
            ecb_ct, bitslice.encrypt_words(words, rk, nr),
            *ecb_ops_per_group(nr, decrypt=False), ecb_bytes, block_counts["ecb_encrypt"])
    measure("ecb_decrypt", "our_tree_tpu_torch/csrc/ecb.cu", "our_tree_tpu/ops/pallas_aes.py:259",
            lambda: cuda_aes.decrypt_words(ecb_ct, rk_dec, nr),
            lambda: bitslice.decrypt_words(ecb_ct, rk_dec, nr),
            ecb_pt, bitslice.decrypt_words(ecb_ct, rk_dec, nr),
            *ecb_ops_per_group(nr, decrypt=True), ecb_bytes, block_counts["ecb_decrypt"])
    # The card's dependent-issue latency: the 65,536-step chain over one word,
    # each step a LOP3 that waits on the one before; a 128-step launch over
    # the same word, timed in a CUDA graph, stands for the launch's share.
    _lat_name, lat_chain, lat_ilp = ceiling.LATENCY
    lat_ms, lat_smi = sampled_ms(lambda: ceiling.chain(lat_x, lat_chain, lat_ilp))
    lat_short_ms = graph_ms(lambda: ceiling.chain(lat_x, 128, 1))
    lat_loop = sass_round_loops(sass_text, "chain_kernel", (lat_chain, lat_ilp))[0]
    lat_cycles = lat_ms * 1e-3 * lat_smi["clock_mhz"] * 1e6 / lat_chain
    log(f"dependent-issue latency: chain_kernel<{lat_chain},{lat_ilp}> over one word "
        f"{lat_ms * 1e3:.3f} us/launch at the sampled {lat_smi['clock_mhz']:.0f} MHz = "
        f"{lat_cycles:.4f} cycles a dependent LOP3 (its SASS run: {lat_loop['int']} integer "
        f"instructions, dependency depth {lat_loop['depth']}); a 128-step launch in a CUDA graph "
        f"{lat_short_ms * 1e3:.3f} us, {100 * lat_short_ms / lat_ms:.2f} % of it; nvidia-smi "
        f"{lat_smi}; card: {card}")
    if lat_short_ms >= 0.05 * lat_ms or lat_loop["depth"] < 128:
        raise SystemExit("the latency chain is too short against its launch, or its SASS is not "
                         "one dependent LOP3 a step")

    # A shared-memory load's latency: the dependent-load chase, one thread,
    # its own cycle counter.
    import ctypes

    chase = ctypes.CDLL(chase_so)
    chase.ot_smem_chase.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    chase.ot_smem_chase.restype = ctypes.c_int
    chase_steps = 1 << 20
    chase_out = torch.zeros(1, dtype=torch.int32, device=dev)
    chase_cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    per_load = []
    for _ in range(3):
        if chase.ot_smem_chase(chase_steps, chase_out.data_ptr(), chase_cycles.data_ptr()):
            raise SystemExit("the shared-memory chase did not launch")
        torch.cuda.synchronize()
        per_load.append(int(chase_cycles.item()) / chase_steps)
    lds_cycles = min(per_load)
    log(f"shared-memory load latency: {lds_cycles:.3f} cycles a dependent LDS (chase of "
        f"{chase_steps} loads, best of {per_load}); dependent integer step {lat_cycles:.4f} "
        f"cycles; card: {card}")

    def latency_ms(depth: int, mhz: float) -> float:
        """The latency bound: ``depth`` dependent integer instructions at the
        measured cycles each, at the SM clock sampled while the kernel ran."""
        return depth * lat_cycles / (mhz * 1e3)

    def sass_per_block(kernel, targs, nr):
        """(integer SASS instructions a thread runs for one block or group,
        its dependent path, the round loop): the round loop nr - 1 times and
        the rest of the function once (an upper bound where set-up loops run
        more than once); the path counts the round loop only, nr - 1 trips (a
        lower bound: the first key XOR and the last round are left out)."""
        ins, _back = sass_function(sass_text, kernel, targs)
        rl = sass_round_loops(sass_text, kernel, targs)[0]
        lo, hi = rl["range"]
        rest = sum(_is_int_op(b) for a, b, _t in ins if not lo <= a <= hi)
        return rl["int"] * (nr - 1) + rest, rl["depth"] * (nr - 1), rl

    # The one-block ECB launch the sequential encrypts used to make per block.
    one = cbc_pt[:1].contiguous()

    def host_issue_ms(fn):
        """The host's time to issue one launch: 200 launches, no sync."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        issue = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        return issue

    host_us = 1e3 * host_issue_ms(lambda: cuda_aes.encrypt_words(one, rk, nr))
    one_ms, one_smi = sampled_ms(lambda: cuda_aes.encrypt_words(one, rk, nr))
    one_card_ms = graph_ms(lambda: cuda_aes.encrypt_words(one, rk, nr))
    _, ecb_depth, ecb_loop = sass_per_block("ecb_encrypt_kernel", nr, nr)
    one_lat = latency_ms(ecb_depth, one_smi["clock_mhz"])
    one_roof, one_by = measured_bound(ecb_ops_per_group(nr, decrypt=False)[0], 32 + 4 * rk.numel())
    log(f"one-block ecb_encrypt launch: host issue {host_us:.2f} us, {one_ms * 1e3:.2f} us back "
        f"to back at the sampled {one_smi['clock_mhz']:.0f} MHz, {one_card_ms * 1e3:.2f} us of "
        f"card per launch in a CUDA graph; its group's round loop "
        f"{ecb_loop['int']} integer instructions, dependency depth {ecb_loop['depth']}: latency "
        f"bound {ecb_depth} x {lat_cycles:.3f} cycles = {one_lat * 1e3:.4f} us, roofline bound "
        f"{one_roof * 1e3:.5f} us ({one_by}); the graph's launch at "
        f"{100 * max(one_lat, one_roof) / one_card_ms:.1f} % of the larger; card: {card}")
    next(e for e in kernels if e["name"] == "ecb_encrypt")["one_block"] = {
        "ms": one_ms, "card_ms_graph": one_card_ms, "host_issue_ms": host_us / 1e3,
        "sampled_clock_mhz": one_smi["clock_mhz"], "roofline_bound_ms": one_roof,
        "latency_bound_ms": one_lat, "dependent_instructions": ecb_depth}

    # seq_encrypt: the two sequential encrypts of phase 5 (one stream of
    # 4,096 blocks) and the batch (4,096 streams of 64 blocks), each one launch.
    seq_int, seq_depth, seq_loop = {}, {}, {}
    for c in (0, 1):
        seq_int[c], seq_depth[c], seq_loop[c] = sass_per_block("seq_encrypt_kernel", (nr, c), nr)
    log(f"seq_encrypt SASS (nr {nr}): round loop {seq_loop[0]['int']} (CBC) / {seq_loop[1]['int']} "
        f"(CFB128) integer instructions, dependency depth {seq_loop[0]['depth']} / "
        f"{seq_loop[1]['depth']}; about {seq_int[0]} / {seq_int[1]} integer instructions a block; "
        f"ptxas {ptxas.get(f'seq_encrypt_kernel<{nr},0>')} / {ptxas.get(f'seq_encrypt_kernel<{nr},1>')}")
    first = cbc_pt[:SEQ_BLOCKS].contiguous()
    single = {}
    for mode, fn, c in (("cbc_encrypt", aes.cbc_encrypt_words, 0),
                        ("cfb128_encrypt", aes.cfb128_encrypt_words, 1)):
        ms, clocks = sampled_ms(lambda fn=fn: fn(first, ivw, rk, nr, eng))
        lat_b = latency_ms(SEQ_BLOCKS * seq_depth[c], clocks["clock_mhz"])
        single[mode] = {"ms": ms, "us_per_block": 1e3 * ms / SEQ_BLOCKS, "latency_bound_ms": lat_b,
                        "dependent_instructions_per_block": seq_depth[c],
                        "sampled_clock_mhz": clocks["clock_mhz"]}
        log(f"{mode}_words, {SEQ_BLOCKS} blocks in sequence (one seq_encrypt launch): {ms:.4f} ms, "
            f"{1e3 * ms / SEQ_BLOCKS:.4f} us per block; latency bound {SEQ_BLOCKS} blocks x "
            f"{seq_depth[c]} dependent instructions x {lat_cycles:.3f} cycles at "
            f"{clocks['clock_mhz']:.0f} MHz = {lat_b:.4f} ms, kernel at {100 * lat_b / ms:.1f} %; "
            f"card: {card}")
    batch_got = cuda_aes.seq_encrypt(streams, stream_ivs, rk, nr, False)
    batch_want = cuda_aes.seq_encrypt_plain(streams, stream_ivs, rk, nr, False)
    m, batch_err = diff(batch_got[0], batch_want[0])
    m += diff(batch_got[1], batch_want[1])[0]
    if m:
        raise SystemExit(f"seq_encrypt vs plain at the batch's shape: {m} mismatching words")
    batch_ms, batch_smi = sampled_ms(
        lambda: aes.cbc_encrypt_words_batch(streams, stream_ivs, rk, nr, eng))
    batch_plain_ms = events_ms(lambda: cuda_aes.seq_encrypt_plain(streams, stream_ivs, rk, nr,
                                                                  False), 1)
    n_batch = streams.shape[0] * streams.shape[1]
    seq_ops = n_batch / 32 * mk_ops_per_group(nr)[0]
    seq_bytes = 2 * streams.numel() * 4 + 2 * stream_ivs.numel() * 4 + rk.numel() * 4
    seq_ops_ms, seq_bytes_ms = seq_ops / int_ops_per_ms, seq_bytes / HBM_BYTES_PER_S * 1e3
    seq_meas, seq_meas_by = measured_bound(seq_ops, seq_bytes)
    batch_lat = latency_ms(streams.shape[1] * seq_depth[0], batch_smi["clock_mhz"])
    log(f"cbc_encrypt_words_batch, {SEQ_BLOCKS} streams x 64 blocks (one seq_encrypt launch): "
        f"{batch_ms:.4f} ms, {1e3 * batch_ms / 64:.4f} us per step of {SEQ_BLOCKS} blocks; plain "
        f"{batch_plain_ms:.2f} ms; roofline bound {max(seq_ops_ms, seq_bytes_ms):.6f} ms at the "
        f"table rates, {seq_meas:.6f} ms ({seq_meas_by}) at the measured ones; latency bound 64 x "
        f"{seq_depth[0]} x {lat_cycles:.3f} cycles at {batch_smi['clock_mhz']:.0f} MHz = "
        f"{batch_lat:.4f} ms; kernel at {100 * max(seq_meas, batch_lat) / batch_ms:.1f} % of the "
        f"larger; card: {card}")
    del batch_got, batch_want
    kernels.append({
        "name": "seq_encrypt", "route": "cuda", "source": "our_tree_tpu_torch/csrc/seq.cu",
        "replaces": "our_tree_tpu/ops/pallas_aes.py:259", "launches": block_counts["seq_encrypt"],
        "max_abs_err": batch_err, "ms": batch_ms, "plain_ms": batch_plain_ms,
        "bound_ms": max(seq_ops_ms, seq_bytes_ms),
        "bound_by": "operations" if seq_ops_ms >= seq_bytes_ms else "bytes",
        "bound_ms_at_sampled_clock": max(seq_ops_ms * clock_mhz / batch_smi["clock_mhz"],
                                         seq_bytes_ms),
        "sampled_clock_mhz": batch_smi["clock_mhz"], "bound_ms_measured": seq_meas,
        "bound_by_measured": seq_meas_by,
        "measured_int_results_per_clk_per_sm": measured["int_results_per_clk_per_sm"],
        "latency_bound_ms": batch_lat, "dependent_issue_cycles": lat_cycles,
        "dependent_instructions_per_block": seq_depth[0], "library_ms": None,
        "shape": f"{SEQ_BLOCKS} CBC streams x 64 blocks (cbc_encrypt_words_batch); the "
                 f"single-stream encrypts of {SEQ_BLOCKS} blocks under 'single_stream'",
        "sass_round_loop": {"cbc": seq_loop[0], "cfb128": seq_loop[1]},
        "sass_int_per_block": {"cbc": seq_int[0], "cfb128": seq_int[1]},
        "single_stream": single})

    # ctr_mk: the serve path's shape (the 4,096-block rung, K = 8, drive B's
    # pattern of 1-64-block requests on random slots) in each form, then 256
    # MiB with K = 8 in runs of 1-300 blocks in each form and with its K = 1
    # entry; then both forms at every size from 32 blocks to 2^24, one slot
    # and a random slot per block (the auto form's threshold table; the ladder's
    # rungs also with the plain version's time and drives A and B's batches).
    mk = sass_mk_per_thread(sass_text, nr)
    mk_loops = sass_round_loops(sass_text, "ctr_mk_kernel", nr)[:2]
    mk_group_depth = (nr - 1) * min(lp["depth"] for lp in mk_loops)
    blk_int, blk_depth, blk_loop = sass_per_block("ctr_mk_block_kernel", nr, nr)
    log(f"ctr_mk SASS (nr {nr}): group form {mk}, round-loop dependency depths "
        f"{[lp['depth'] for lp in mk_loops]}; block form round loop {blk_loop['int']} integer "
        f"instructions, depth {blk_loop['depth']}, about {blk_int} a block; ptxas "
        f"{ptxas.get(f'ctr_mk_kernel<{nr}>')} / {ptxas.get(f'ctr_mk_block_kernel<{nr}>')}")
    fwd = {e["name"]: e["sass_instructions_per_group"] for e in kernels
           if e["name"] in ("ctr_gen", "ecb_encrypt")}
    fwd.update(ctr_mk_block=blk_int, seq_encrypt=seq_int[0])
    log("forward kernels' integer SASS at nr 10 (this build; before the decrypt redesign): "
        + ", ".join(f"{k} {fwd[k]} ({v}, {'same' if fwd[k] == v else 'differs'})"
                    for k, v in FORWARD_SASS.items())
        + "; per group for ctr_gen and ecb_encrypt, per block for ctr_mk_block and seq_encrypt")
    mk_ops, mk_parts = mk_ops_per_group(nr)
    nr8, rks8 = mk_stack(128, 8, seed=8)
    rung = 4096
    w_r, c_r = random_words(rung, seed=41), random_words(rung, seed=42)
    s_r = slot_runs(rung, 8, np.array([1, 4, 16, 64]), seed=43)
    mixed_groups = int((s_r.reshape(-1, 32) != s_r.reshape(-1, 32)[:, :1]).any(dim=1).sum())
    log(f"ctr_mk serve-shape slots: {mixed_groups} of {rung // 32} groups mixed")
    sass_r = (mk["mixed_group"] * mixed_groups + mk["uniform_group"] * (rung // 32 - mixed_groups)
              ) // (rung // 32)
    mk_bytes = lambda n, k, slots: 48 * n + 4 * n * slots + 4 * k * 4 * (nr8 + 1)  # noqa: E731

    def mk_fn(w, c, sl, form):
        return lambda: cuda_aes.ctr_scattered_multikey(w, c, rks8, sl, nr8, form=form)

    def with_latency(e, depth, fn):
        """Add the card time per launch in a CUDA graph and the latency bound
        (one thread's dependent path) to an entry; the share of the larger
        bound is read against the graph's card time."""
        e["card_ms_graph"] = graph_ms(fn)
        e["latency_bound_ms"] = latency_ms(depth, e["sampled_clock_mhz"])
        e["dependent_instructions"] = depth
        e["share_of_larger_bound"] = (max(e["bound_ms_measured"], e["latency_bound_ms"])
                                      / e["card_ms_graph"])
        return e

    want_r = cuda_aes.ctr_scattered_multikey_plain(w_r, c_r, rks8, s_r, nr8)
    entry = with_latency(timing(
        "ctr_mk", mk_fn(w_r, c_r, s_r, "group"),
        lambda: cuda_aes.ctr_scattered_multikey_plain(w_r, c_r, rks8, s_r, nr8),
        mk_fn(w_r, c_r, s_r, "group")(), want_r, mk_ops, mk_parts, mk_bytes(rung, 8, 1), rung,
        sass_r, plain_reps=5, sass_upper_bound=True), mk_group_depth, mk_fn(w_r, c_r, s_r, "group"))
    block_r = with_latency(timing(
        "ctr_mk_block", mk_fn(w_r, c_r, s_r, "block"),
        lambda: cuda_aes.ctr_scattered_multikey_plain(w_r, c_r, rks8, s_r, nr8),
        mk_fn(w_r, c_r, s_r, "block")(), want_r, mk_ops, mk_parts, mk_bytes(rung, 8, 1), rung,
        32 * blk_int, plain_reps=5, sass_upper_bound=True), blk_depth, mk_fn(w_r, c_r, s_r, "block"))
    for form, e in (("group", entry), ("block", block_r)):
        e["host_issue_ms"] = host_issue_ms(mk_fn(w_r, c_r, s_r, form))
        log(f"ctr_mk {form} form at the {rung}-block rung: host issue "
            f"{e['host_issue_ms'] * 1e3:.2f} us per launch, {e['ms'] * 1e3:.2f} us per launch back "
            f"to back, {e['card_ms_graph'] * 1e3:.2f} us of card per launch in a CUDA graph; "
            f"latency bound {e['dependent_instructions']} x {lat_cycles:.3f} cycles = "
            f"{e['latency_bound_ms'] * 1e3:.4f} us, roofline bound "
            f"{e['bound_ms_measured'] * 1e3:.4f} us; kernel at "
            f"{100 * e['share_of_larger_bound']:.1f} % of the larger (graph time); card: {card}")
    n_big = MAIN_BYTES // 16
    w_b, c_b = random_words(n_big, seed=51), random_words(n_big, seed=52)
    s_b = slot_runs(n_big, 8, np.arange(1, 301), seed=53)
    mixed_b = int((s_b.reshape(-1, 32) != s_b.reshape(-1, 32)[:, :1]).any(dim=1).sum())
    sass_b = (mk["mixed_group"] * mixed_b + mk["uniform_group"] * (n_big // 32 - mixed_b)
              ) // (n_big // 32)
    want_b = cuda_aes.ctr_scattered_multikey_plain(w_b, c_b, rks8, s_b, nr8)
    bulk = timing("ctr_mk K=8 runs 1-300", mk_fn(w_b, c_b, s_b, "group"),
                  lambda: cuda_aes.ctr_scattered_multikey_plain(w_b, c_b, rks8, s_b, nr8),
                  mk_fn(w_b, c_b, s_b, "group")(), want_b, mk_ops, mk_parts,
                  mk_bytes(n_big, 8, 1), n_big, sass_b, sass_upper_bound=True)
    block_bulk = timing("ctr_mk_block K=8 runs 1-300", mk_fn(w_b, c_b, s_b, "block"),
                        lambda: cuda_aes.ctr_scattered_multikey_plain(w_b, c_b, rks8, s_b, nr8),
                        mk_fn(w_b, c_b, s_b, "block")(), want_b, mk_ops, mk_parts,
                        mk_bytes(n_big, 8, 1), n_big, 32 * blk_int, sass_upper_bound=True)
    log(f"ctr_mk at 256 MiB, K = 8 in runs of 1-300 ({mixed_b} of {n_big // 32} groups mixed): "
        f"group form {bulk['ms']:.4f} ms, block form {block_bulk['ms']:.4f} ms: the block form "
        f"{'beats' if block_bulk['ms'] < bulk['ms'] else 'does not beat'} the mixed group form; "
        f"card: {card}")
    del s_b, want_b
    rk1 = rks8[0].contiguous()
    k1 = timing("ctr_mk K=1 entry",
                lambda: cuda_aes.ctr_crypt_words_explicit(w_b, c_b, rk1, nr8),
                lambda: cuda_aes.ctr_crypt_words_explicit_plain(w_b, c_b, rk1, nr8),
                cuda_aes.ctr_crypt_words_explicit(w_b, c_b, rk1, nr8),
                cuda_aes.ctr_crypt_words_explicit_plain(w_b, c_b, rk1, nr8),
                mk_ops, mk_parts, mk_bytes(n_big, 1, 0), n_big, mk["uniform_group"],
                sass_upper_bound=True)
    lib = cuda_build.load()
    table = []
    ladder = line_a["config"]["rungs"]
    for n in sorted({*ladder, 32, 128, 512, 1024, 2048, 4096, 1 << 16, 1 << 20, 1 << 24}):
        w_n, c_n = w_b[:n], c_b[:n]
        for pattern in ("uniform", "mixed"):
            sl = (torch.full((n,), 3, dtype=torch.int32, device=dev) if pattern == "uniform" else
                  torch.randint(0, 8, (n,), dtype=torch.int32, device=dev,
                                generator=torch.Generator(dev).manual_seed(n)))
            row = {"n_blocks": n, "slots": pattern,
                   "auto_form": cuda_aes.MK_FORMS[lib.ot_ctr_mk_form(n, 0)]}
            if n in ladder:  # drives A and B: traffic batches at this rung (warmup adds one each)
                row["drive_batches"] = sum(ln["occupancy"].get(str(n), {}).get("batches", 0)
                                           for ln in (line_a, line_b))
                row["plain_ms"] = events_ms(lambda: cuda_aes.ctr_scattered_multikey_plain(
                    w_n, c_n, rks8, sl, nr8), 2)
            for form in ("group", "block"):
                fn = mk_fn(w_n, c_n, sl, form)
                reps = max(3, int(0.2 / (events_ms(fn, 1) / 1e3)))
                row[f"{form}_ms"] = events_ms(fn, reps)
                if n <= 1 << 16:  # launches of a few µs: back to back, the host paces them
                    row[f"{form}_card_ms_graph"] = graph_ms(fn)
            row["roofline_bound_ms"] = measured_bound(-(-n // 32) * mk_ops, mk_bytes(n, 8, 1))[0]
            row["latency_bound_ms"] = {"group": latency_ms(mk_group_depth, lat_smi["clock_mhz"]),
                                       "block": latency_ms(blk_depth, lat_smi["clock_mhz"])}
            key = "card_ms_graph" if n <= 1 << 16 else "ms"
            row["faster"] = "block" if row[f"block_{key}"] < row[f"group_{key}"] else "group"
            table.append(row)
            log(f"ctr_mk forms at {n} blocks, K = 8, {pattern} slots: group {row['group_ms']:.4f} "
                f"ms, block {row['block_ms']:.4f} ms back to back; in a CUDA graph group "
                f"{row.get('group_card_ms_graph', float('nan')):.4f} ms, block "
                f"{row.get('block_card_ms_graph', float('nan')):.4f} ms (faster: {row['faster']}; auto: "
                f"{row['auto_form']}); roofline bound {row['roofline_bound_ms']:.6f} ms"
                + (f"; plain {row['plain_ms']:.2f} ms, {row['drive_batches']} traffic batches in "
                   f"drives A and B" if "plain_ms" in row else "") + f"; card: {card}")
    del w_b, c_b
    forms_ab = {f: forms_a[f] + forms_b[f] for f in forms_a}
    kernels.append({
        "name": "ctr_mk", "route": "cuda", "source": "our_tree_tpu_torch/csrc/ctr_mk.cu",
        "replaces": "our_tree_tpu/ops/pallas_aes.py:767",
        "launches": counts_a["ctr_mk"] + counts_b["ctr_mk"], **entry, "library_ms": None,
        "shape": f"{rung} blocks, K = 8, drive B's request pattern ({mixed_groups} of "
                 f"{rung // 32} groups mixed), the group form (ctr_mk_kernel)",
        "launches_by_form": forms_ab,
        "sass_by_key_form": mk,
        "at_256MiB_k8_runs": {**bulk, "library_ms": None},
        "k1_entry": {"entry": "ops/cuda_aes.py:ctr_crypt_words_explicit",
                     "counterpart_of": "_ctr_kernel",
                     "replaces": "our_tree_tpu/ops/pallas_aes.py:476",
                     "shape": "256 MiB", **k1, "library_ms": None},
        "block_form": {"name": "ctr_mk_block_kernel", "route": "cuda",
                       "source": "our_tree_tpu_torch/csrc/ctr_mk.cu",
                       "replaces": "our_tree_tpu/ops/pallas_aes.py:767",
                       "launches": forms_ab["block"], **block_r, "library_ms": None,
                       "shape": f"{rung} blocks, K = 8, drive B's request pattern",
                       "sass_round_loop": blk_loop, "sass_int_per_block": blk_int,
                       "at_256MiB_k8_runs": {**block_bulk, "library_ms": None},
                       "forms_table": table},
    })

    # chain: each regime at the probe's 64 MiB, timed alone in phase 7.
    chain_entries = {}
    for name, r in regimes.items():
        c, i = r["chain"], r["ilp"]
        m, max_err = diff(ceiling.chain(x, c, i), ceiling.chain_plain(x, c, i))
        if m:
            raise SystemExit(f"chain {name} vs plain at {PROBE_BYTES >> 20} MiB: {m} words")
        # Operations: the reference's logical count with a LOP3 credited with
        # two, as for the AES kernels; bytes: one word read, one written.
        ops = chain_words * ceiling.ops_per_word(c, i) / 2
        ops_ms, bytes_ms = ops / int_ops_per_ms, 8 * chain_words / HBM_BYTES_PER_S * 1e3
        meas_ms, meas_by = measured_bound(ops, 8 * chain_words)
        sampled_mhz = r["smi"]["clock_mhz"]
        chain_entries[name] = {
            "chain": c, "ilp": i, "mismatches": m, "max_abs_err": max_err, "ms": r["ms"],
            "plain_ms": events_ms(lambda c=c, i=i: ceiling.chain_plain(x, c, i), 2),
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ms_at_sampled_clock": max(ops_ms * clock_mhz / sampled_mhz, bytes_ms),
            "sampled_clock_mhz": sampled_mhz, "bound_ms_measured": meas_ms,
            "bound_by_measured": meas_by,
            "sass_per_element": {k: r[k] for k in ("lop3", "int", "instructions")},
            "int_results_per_clk_per_sm": r["int_per_clk_per_sm"],
            "int_results_per_clk_per_sm_at_max_clock": r["int_per_clk_per_sm_at_max"],
            "t_ops_per_s": r["t_ops_per_s"], "smi": r["smi"]}
        e = chain_entries[name]
        log(f"chain {name} at {PROBE_BYTES >> 20} MiB: {r['ms']:.4f} ms/launch, plain "
            f"{e['plain_ms']:.2f} ms; bound {e['bound_ms']:.4f} ms ({e['bound_by']}; kernel at "
            f"{100 * e['bound_ms'] / r['ms']:.1f} %), at the sampled clock "
            f"{e['bound_ms_at_sampled_clock']:.4f} ms, at the measured rates {meas_ms:.4f} ms "
            f"({meas_by}); ptxas {ptxas.get(f'chain_kernel<{c},{i}>')}; card: {card}")
    head = chain_entries["compute-ilp8"]
    kernels.append({
        "name": "chain", "route": "cuda", "source": "our_tree_tpu_torch/csrc/chain.cu",
        "replaces": "scripts/vpu_ceiling.py:47", "launches": probe_counts["chain"],
        **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                "bound_ms_at_sampled_clock", "sampled_clock_mhz",
                                "bound_ms_measured", "bound_by_measured")},
        "library_ms": None,
        "measured_int_results_per_clk_per_sm": measured["int_results_per_clk_per_sm"],
        "shape": f"{PROBE_BYTES >> 20} MiB, the compute-ilp8 regime; every regime under "
                 "'regimes'",
        "measured": measured, "probe_line": cli_line, "regimes": chain_entries})

    # arc4_prga at its timing shapes: time per launch, bounds and share.
    arc4_loops = sass_round_loops(sass_text, "arc4_prga_kernel", 32)
    arc4_ins, _ = sass_function(sass_text, "arc4_prga_kernel", 32)
    for lp in arc4_loops:
        lo, hi = lp["range"]
        lp["lds"] = sum(b == "LDS" for a, b, _t in arc4_ins if lo <= a <= hi)
        lp["sts"] = sum(b == "STS" for a, b, _t in arc4_ins if lo <= a <= hi)
    # The main loop: the PRGA loop (it stores to shared memory, the state's
    # copy-out loop does not) with the most steps a trip.
    group = max(arc4_loops, key=lambda lp: (lp["sts"] > 0, lp["lds"]))
    bytes_per_trip = group["lds"] // 3
    if bytes_per_trip < 1 or group["lds"] % 3:
        raise SystemExit(f"arc4_prga_kernel's main loop holds {group['lds']} LDS, not three a "
                         f"byte: {group}")
    # The latency bound counts the function's recurrence (ARC4_RECURRENCE);
    # the longest path through the compiled loop, which also counts this
    # build's address arithmetic and each byte's off-recurrence tail, is a
    # diagnostic beside it.
    rec_cycles = ARC4_RECURRENCE["lds"] * lds_cycles + ARC4_RECURRENCE["int"] * lat_cycles
    sass_path = sass_weighted_path(arc4_ins, *group["range"], lds_cycles, lat_cycles)
    sass_cycles = sass_path / bytes_per_trip
    log(f"arc4_prga SASS: main loop {bytes_per_trip} bytes a trip, {group['int']} integer "
        f"instructions, {group['lds']} LDS, {group['sts']} STS, opcodes {group['hist']}; its "
        f"longest dependent path {sass_path:.1f} cycles a trip = {sass_cycles:.2f} cycles a byte; "
        f"the step's recurrence {ARC4_RECURRENCE['lds']} x {lds_cycles:.2f} (a dependent LDS) + "
        f"{ARC4_RECURRENCE['int']} x {lat_cycles:.3f} (a dependent integer step) = "
        f"{rec_cycles:.2f} cycles a byte; ptxas {ptxas.get('arc4_prga_kernel<32>')}")
    log("arc4_prga main loop SASS: " + " | ".join(
        t for a, _b, t in arc4_ins if group["range"][0] <= a <= group["range"][1]))
    arc4_shapes = {}
    for label, (s_n, n) in ARC4_TIMED.items():
        st = arc4_inputs[n]["states"][:s_n]
        ms, clocks = sampled_ms(lambda st=st, n=n: cuda_arc4.prga(st, n))
        nbytes = s_n * n + 2 * s_n * 258 * 4  # keystream written, state read and written
        ops = ARC4_OPS_PER_BYTE * s_n * n
        ops_ms, bytes_ms = ops / int_ops_per_ms, nbytes / HBM_BYTES_PER_S * 1e3
        meas_ms, meas_by = measured_bound(ops, nbytes)
        mhz = clocks["clock_mhz"]
        lat_b = n * rec_cycles / (mhz * 1e3)
        arc4_shapes[label] = {
            "streams": s_n, "bytes_per_stream": n, "ms": ms,
            "plain_ms": arc4_inputs[n]["plain_ms"], "plain_streams": ARC4_PLAIN_STREAMS,
            "max_abs_err": arc4_inputs[n]["max_abs_err"],
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ms_measured": meas_ms, "bound_by_measured": meas_by,
            "latency_bound_ms": lat_b, "larger_bound_ms": max(meas_ms, lat_b),
            "share_of_larger_bound": max(meas_ms, lat_b) / ms,
            "sass_path_latency_ms": n * sass_cycles / (mhz * 1e3),
            "sampled_clock_mhz": mhz, "library_ms": None}
        e = arc4_shapes[label]
        log(f"arc4_prga {label} at {s_n} x {n} bytes: {ms:.4f} ms/launch ({s_n * n / ms / 1e6:.3f} "
            f"GB/s of keystream); plain {e['plain_ms']:.1f} ms (on {ARC4_PLAIN_STREAMS} streams of "
            f"{n} bytes, the first {s_n} of them these); bound {e['bound_ms']:.5f} ms "
            f"({e['bound_by']}, table rates), {meas_ms:.5f} ms at the measured rates ({meas_by}), "
            f"latency bound {n} x {rec_cycles:.2f} cycles at {mhz:.0f} MHz = {lat_b:.4f} ms; "
            f"kernel at {100 * e['share_of_larger_bound']:.1f} % of the larger of the "
            f"measured-rate and latency bounds (the compiled loop's path: "
            f"{e['sass_path_latency_ms']:.4f} ms); nvidia-smi {clocks}; card: {card}")
    head = arc4_shapes["path"]
    arc4_entry = {
        "name": "arc4_prga", "route": "cuda", "source": "our_tree_tpu_torch/csrc/arc4.cu",
        "replaces": "our_tree_tpu/models/arc4.py:59",
        "counterpart_of": "the XLA scans keystream_scan/keystream_scan_batch "
                          "(our_tree_tpu/models/arc4.py:59-94), not a Pallas kernel",
        "launches": None,
        **{k: head[k] for k in ("max_abs_err", "ms", "plain_ms", "plain_streams", "bound_ms",
                                "bound_by", "bound_ms_measured", "bound_by_measured",
                                "latency_bound_ms", "larger_bound_ms", "share_of_larger_bound",
                                "sass_path_latency_ms", "sampled_clock_mhz", "library_ms")},
        "shape": "{0} streams x {1} bytes (rc4-batch's launch); 'single' and 'wide' below".format(
            *ARC4_TIMED["path"]),
        "single": arc4_shapes["single"], "wide": arc4_shapes["wide"],
        "lds_latency_cycles": lds_cycles, "dependent_issue_cycles": lat_cycles,
        "recurrence_cycles_per_byte": rec_cycles, "sass_path_cycles_per_byte": sass_cycles,
        "sass_main_loop": {k: group[k] for k in ("int", "lds", "sts", "depth", "hist")}}
    kernels.append(arc4_entry)

    # 10. The sweep harness (harness.bench) in processes of its own, as a user
    # runs it: the device rows with the native keystream prep, the sequential
    # and batch rows, the same rows on the native C tier, the keystream on the
    # card, and the refusal of a second worker.
    harness_env = {**os.environ, "OT_ARC4_PREP": "native"}

    def harness(name, argv, env=None, expect_rc=0):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "our_tree_tpu_torch.harness.bench", *argv],
                             cwd=ROOT, capture_output=True, text=True, timeout=900,
                             env=env or harness_env)
        wall = time.perf_counter() - t0
        if (res.returncode == 0) != (expect_rc == 0):
            raise SystemExit(f"harness {name}: rc {res.returncode}, out {res.stdout[-2000:]!r}, "
                             f"err {res.stderr[-3000:]!r}")
        launches = {}
        for ln in res.stderr.splitlines():
            m = re.match(r"# launches: (\S+) (\{.*\})$", ln)
            if m:
                launches[m.group(1)] = json.loads(m.group(2))
        for text in res.stdout.strip().splitlines():
            log(f"harness {name}: {text}")
        return res, launches, wall

    common = ["--workers", "1", "--iters", "5", "--keybits", "128", "--timing", "device"]
    runs = {
        "device rows": (["--sizes-mb", "1,16,256", "--modes", "ecb,ecb-dec,ctr,cbc-dec,rc4"],
                        None),
        "sequential rows": (["--sizes-mb", "0.0625", "--modes", "cbc,cfb128"], None),
        "batch rows": (["--sizes-mb", "32", "--modes", "cbc-batch,rc4-batch", "--streams",
                        "32"], None),
        "e2e rows": (["--sizes-mb", "16,256", "--modes", "ecb,ctr,rc4", "--timing", "e2e"], None),
        "c backend rows": (["--backend", "c", "--sizes-mb", "1,16,256", "--modes", "ecb,ctr,rc4"],
                           None),
        "rc4 keystream on the card": (["--sizes-mb", "1", "--modes", "rc4"],
                                      {**os.environ, "OT_ARC4_PREP": "device"}),
    }
    harness_checks, harness_launches, harness_table = {}, {}, []
    for name, (argv, env) in runs.items():
        res, launches, wall = harness(name, common + argv, env)
        out = res.stdout
        verdicts = [ln for ln in out.splitlines()
                    if re.search(r"passed|FAILED|MISMATCH", ln)]
        harness_checks[f"{name}: every check line passed"] = all(
            "passed" in ln for ln in verdicts)
        harness_checks[f"{name}: no degraded line"] = "# degraded:" not in out + res.stderr
        if "rc4" in argv[argv.index("--modes") + 1].split(","):
            harness_checks[f"{name}: ARC4 self-test"] = all(
                f"ARC4 test #{i}: passed" in out for i in (1, 2, 3))
        if "rc4-batch" in argv[argv.index("--modes") + 1]:
            harness_checks[f"{name}: batch parity"] = "RC4-batch parity vs single-stream: passed" in out
        units = {u: c for u, c in launches.items()}
        harness_launches[name] = units
        if "--backend" not in argv:
            for unit, cnt in units.items():
                mode = unit.split(":")[0]
                want = "arc4_prga" if (mode == "rc4" and env is not None) else HARNESS_KERNEL.get(mode)
                if want is not None:
                    harness_checks[f"{name}: {unit} launched {want}"] = cnt.get(want, 0) > 0
        for row in harness_rows(out):
            row["run"] = name
            harness_table.append(row)
            gb = row["gbps"]
            keygen = (f", keygen {row['bytes'] / row['keygen_us'] / 1e3:.4g} GB/s"
                      if row.get("keygen_us") else "")
            log(f"harness row [{name}] {row['row']}: {gb if gb is not None else 'n/a'} GB/s"
                f"{keygen} beside the CTR chain's {ctr_gbps} GB/s; "
                + (f"CPU: {cpu_model()}" if "--backend" in argv else f"card: {card}"))
        log(f"harness {name}: {wall:.1f} s wall; launches by unit {units}")
    res, _, _ = harness("two workers", common + ["--workers", "2", "--sizes-mb", "1", "--modes",
                                                 "ecb"], expect_rc=1)
    harness_checks["--workers 2 refused (queue 1 item 9)"] = "queue 1 item 9" in res.stderr
    log(f"harness checks: {harness_checks}")
    if not all(harness_checks.values()):
        raise SystemExit(f"the sweep harness failed: {harness_checks}")
    arc4_entry["launches"] = (
        sum(c.get("arc4_prga", 0) for c in harness_launches["batch rows"].values())
        + sum(c.get("arc4_prga", 0) for c in harness_launches["rc4 keystream on the card"].values()))
    arc4_entry["harness"] = {"rows": harness_table, "launches_by_unit": harness_launches,
                             "ctr_chain_gbps": ctr_gbps, "native_tier_cpu": cpu_model()}

    # 11. Drive A's mix once more, profiled (torch tier) and costed against
    # the ceiling the probe implies; its summary, trace and records land in
    # a temporary run layout, removed after. It runs last: the profiler's
    # hooks must not touch the timings above.
    from our_tree_tpu_torch.obs import profiler

    trace_root = tempfile.mkdtemp(prefix="ot_profile_")
    os.environ["OT_TRACE_DIR"] = trace_root
    try:
        line_c, _, _ = serve_drive("C", ["--requests", str(PROFILED_REQUESTS), "--mixed-sizes",
                                      "--profile-window", "1:2",
                                      "--ceiling-gbps", f"{ceiling_gbps:.6f}"])
        prof = line_c["profile"] or {}
        cap = prof.get("capture") or {}
        xrows = (prof.get("crosscheck") or {}).get("rows", [])
        cost_rungs = [r["rung"] for r in line_c["cost"]["rows"]]
        tk = (trace_kernels(os.path.join(trace_root, cap["run"], cap["torch_dir"], "trace.json"),
                            cap["t0_us"], cap["t1_us"]) if cap.get("torch_dir") else {})
    finally:
        del os.environ["OT_TRACE_DIR"]
        os.environ.pop("OT_TRACE_RUN", None)
        shutil.rmtree(trace_root, ignore_errors=True)
    window_disp = sum(r["dispatches"] for r in cap.get("rungs", []))
    checks = {
        "profile section": bool(cap),
        "tier torch": cap.get("tier") == "torch",
        "summary valid": profiler.validate_summary(cap) == [],
        "crosscheck rows = window's dispatches": [
            (r["rung"], r["dispatches"]) for r in xrows] == [
            (r["rung"], r["dispatches"]) for r in cap.get("rungs", [])] and window_disp > 0,
        "crosscheck rows modeled": all(r["modeled_dispatch_bytes"] for r in xrows),
        "a cost row per warmed rung": cost_rungs == line_c["config"]["rungs"],
        "trace holds ctr_mk kernels": tk.get("ctr_mk_in_trace", 0) > 0,
    }
    if tk:
        busy = tk["kernel_us"] / (cap["t1_us"] - cap["t0_us"])
        log(f"serve C profiled window: {cap['seconds']} s, {window_disp} dispatches; trace: "
            f"{tk['ctr_mk_kernels']} ctr_mk of {tk['kernels']} kernels in the window "
            f"({tk['ctr_mk_in_trace']} of {tk['kernels_in_trace']} in the whole trace), kernel "
            f"time {tk['kernel_us'] / 1e3:.3f} ms, copies {tk['memcpys']} taking "
            f"{tk['memcpy_us'] / 1e3:.3f} ms; card busy share {100 * busy:.2f} % (idle "
            f"{100 * (1 - busy):.2f} %) under the profiler; lanes' card time in the window "
            f"{cap['device_us'] / 1e3:.3f} ms of {cap['busy_us'] / 1e3:.3f} ms busy; card: {card}")
        for r in xrows:
            log(f"serve C window rung {r['rung']}: {r['dispatches']} dispatches, "
                f"{r['window_gbps']} GB/s moved, utilization {r['utilization']} of "
                f"{ceiling_gbps:.2f} GB/s")
    log(f"serve C cost rows: " + "; ".join(
        f"r{r['rung']} {r['dispatches']} disp {r['achieved_gbps']} GB/s util {r['utilization']}"
        for r in line_c["cost"]["rows"]) + f"; device utilization {line_c['device']['utilization']}")
    if not all(checks.values()):
        raise SystemExit(f"serve drive C's profile failed: {checks}")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
