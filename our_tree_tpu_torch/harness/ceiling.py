"""Measured integer-logic ceiling: ``python -m our_tree_tpu_torch.harness.ceiling``.

Port of ``scripts/vpu_ceiling.py``. A kernel streams 32-bit words through
``ilp`` independent chains of the two-word feedback (a, b) <- (b, a ^ (b & K)),
the XOR/AND mix of the bitsliced AES round, and the achieved rate is
reported in logical operations per second and in bytes moved per second.
Four regimes of one kernel: ``stream`` (one step, bound by memory),
``compute`` (128 dependent steps), ``compute-ilp4`` and ``compute-ilp8``
(4 and 8 independent chains per word, bound by integer issue). Timing is the
reference's chained method: T(1 + k) - T(1) over a chain whose every step
XORs the previous output's sum into the input, ended by the digest's
readback, so launch overhead and asynchronous dispatch cancel.

``chain`` launches ``csrc/chain.cu``, which replaces the TPU kernel
``_chain_kernel`` (``scripts/vpu_ceiling.py:47-71``, launched at ``:79``);
``chain_plain`` is its plain torch version. The wrapper launches the kernel
for a CUDA tensor and raises on anything it cannot launch; only a CPU tensor
goes to the plain version. It counts its launches in ``chain.launches``.

Environment, as the reference: ``OT_VPU_BYTES`` (default 64 MiB, which
exceeds the card's 50 MB L2, so ``stream`` reads HBM) and ``OT_VPU_ITERS``
(default 8). ``--device`` defaults to ``cuda`` and raises without a card;
``--device cpu`` runs the plain version and names the CPU as its device.
The per-regime lines come first, then one JSON line with the reference's
keys: ``platform``, ``device_kind``, ``bytes`` and per regime ``chain``,
``ilp``, ``sec``, ``t_ops_per_s`` and ``mem_gb_per_s``. These are the
chained method's figures; the card's per-clock rate and the SASS it runs are
read by ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

import torch

from ..bench import u32_sum
from ..models.aes import as_device
from ..ops.cuda_aes import count_launch
from ..runtime import cuda_build

TILE = 512  # the reference's lanes per grid step; only the size rounding keeps it
#: The chain mask and the two seeds of the reference kernel.
K = 0xC2B2AE35
SEED1 = 0x9E3779B9
SEED2 = 0x85EBCA6B
#: (name, chain, ilp): the probe's regimes, the kernel's only instantiations.
REGIMES = (("stream", 1, 1), ("compute", 128, 1), ("compute-ilp4", 128, 4),
           ("compute-ilp8", 128, 8))
#: (name, chain, ilp) of the kernel's one other instantiation: one dependent
#: chain of 65,536 steps, which ``chip_smoke.py`` launches over one word to
#: read the card's dependent-issue latency. Not a regime of the probe's line.
LATENCY = ("latency", 1 << 16, 1)


def _i32(v: int) -> int:
    """The int32 with the bits of u32 ``v``."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def ops_per_word(chain: int, ilp: int) -> int:
    """Logical operations per word, the reference's count: 2 per chain step
    per chain, 2 ilp initial XORs and 2 ilp - 1 reduction XORs."""
    return ilp * 2 * chain + 2 * ilp + 2 * ilp - 1


def chain_plain(x: torch.Tensor, chain: int, ilp: int) -> torch.Tensor:
    """Plain version: the chains as int32 tensor operations."""
    k = _i32(K)
    st = [(x ^ _i32(SEED1 * (2 * i + 1)), x ^ _i32(SEED2 * (2 * i + 1))) for i in range(ilp)]
    for _ in range(chain):
        st = [(b, a ^ (b & k)) for a, b in st]
    acc = None
    for a, b in st:
        acc = (a ^ b) if acc is None else acc ^ a ^ b
    return acc


def chain(x: torch.Tensor, chain: int, ilp: int) -> torch.Tensor:
    """The chains over every int32 word of ``x`` (any shape, contiguous);
    (chain, ilp) must be one of ``REGIMES`` or ``LATENCY``."""
    if (chain, ilp) not in {(c, i) for _n, c, i in (*REGIMES, LATENCY)}:
        raise ValueError(f"(chain, ilp) must be one of the regimes {REGIMES} or {LATENCY}, "
                         f"got {(chain, ilp)}")
    if x.dtype != torch.int32:
        raise TypeError(f"x must be int32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type == "cpu":
        return chain_plain(x, chain, ilp)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = cuda_build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ot_chain(x.data_ptr(), out.data_ptr(), ctypes.c_longlong(x.numel()), chain, ilp,
                          K, stream)
    if rc:
        raise RuntimeError(f"ot_chain launch failed: cudaError {rc}")
    count_launch(globals()["chain"])  # the parameter ``chain`` shadows this function
    return out


#: Kernel launches since the last reset.
chain.launches = 0


def chainrun(fn, x: torch.Tensor, k: int) -> torch.Tensor:
    """k chained calls: each feeds ``x ^ acc`` to ``fn`` and sets ``acc`` to
    the u32 sum of the output (mod 2^32); returns the final ``acc`` as a 0-d
    int32 tensor (the reference's ``chainrun``)."""
    acc = torch.zeros((), dtype=torch.int32, device=x.device)
    for _ in range(k):
        acc = u32_sum(fn(x ^ acc))
    return acc


def chained_time(fn, x: torch.Tensor, iters: int) -> float:
    """Seconds per call of ``fn`` by the reference's method: the least of
    two T(1 + iters) minus the least of two T(1), over ``iters``; each T is
    host time up to the digest's readback."""
    def run(k):
        t0 = time.perf_counter()
        int(chainrun(fn, x, k))
        return time.perf_counter() - t0

    run(1)
    t1 = min(run(1) for _ in range(2))
    tk = min(run(1 + iters) for _ in range(2))
    return max(tk - t1, 1e-9) / iters


def words(nbytes: int) -> int:
    """The reference's word count for ``nbytes``: whole (8, 512) tiles, at
    least one."""
    lanes = max(nbytes // 4 // 8, TILE)
    return (lanes - lanes % TILE) * 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m our_tree_tpu_torch.harness.ceiling",
                                 description="integer-logic and streaming ceiling probe")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel; raises without a card) or cpu (the plain version)")
    args = ap.parse_args(argv)
    dev = as_device(args.device)
    n = words(int(os.environ.get("OT_VPU_BYTES", 64 << 20)))
    iters = int(os.environ.get("OT_VPU_ITERS", 8))
    x = torch.arange(n, dtype=torch.int32, device=dev)
    platform, kind = (("gpu", torch.cuda.get_device_name(dev)) if dev.type == "cuda"
                      else (dev.type, dev.type))
    print(f"# {n * 4 >> 20} MiB u32, {n} words, device={platform}/{kind}", flush=True)
    out = {"platform": platform, "device_kind": kind, "bytes": n * 4}
    for name, c, i in REGIMES:
        t = chained_time(lambda v, c=c, i=i: chain(v, c, i), x, iters)
        ops = n * ops_per_word(c, i)
        gbps = n * 8 / t / 1e9  # one u32 read + one write per word
        print(f"{name:12s} chain={c:4d} ilp={i}: {t * 1e3:8.2f} ms  "
              f"{ops / t / 1e12:6.3f} T-u32-ops/s  ({gbps:6.1f} GB/s mem)", flush=True)
        out[name] = {"chain": c, "ilp": i, "sec": t, "t_ops_per_s": ops / t / 1e12,
                     "mem_gb_per_s": gbps}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
