"""AES-128-CTR throughput on one card: ``python -m our_tree_tpu_torch.bench``.

Prints ONE JSON line in the schema of the root ``bench.py``:
  {"metric": ..., "value": GB/s median, "unit": "GB/s", "vs_baseline": ...,
   "value_min": ..., "value_max": ..., "reps": ...}

Method (root ``bench.py:514-598``): key ``bytes(range(16))``, nonce
``f0..ff``, data from ``default_rng(1337)``. Each chain step runs CTR with
the counter ``ctr_be ^ acc`` (the running sum XORed into all four BE
counter words, so no step can be hoisted) and sets ``acc`` to the u32 sum of
the output words; the digest is the final ``acc``. ``acc`` stays a tensor on
the card and the kernel reads the counter through a device pointer, so the
chain never waits on the host. The reported time of ``iters`` steps is
T(1 + iters) - T(1), timed with CUDA events; the line reports the median of
``OT_BENCH_REPS`` (default 3) such measurements with min and max.

Environment: ``OT_BENCH_BYTES`` (default 256 MiB), ``OT_BENCH_ITERS``
(default 5), ``OT_BENCH_REPS`` (default 3), ``OT_BENCH_OP`` (only ``ctr``
is ported). Without a card it raises; tests call ``run(device="cpu")``,
whose line then names the CPU platform.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .models import aes as aes_mod
from .utils import packing

#: Reference bar (root bench.py BASELINES, BASELINE.md): AES-NI CTR, 1 GiB,
#: 8 CPU threads of the reference C implementation.
BASELINE_CTR_GBPS = 0.520
KEY = bytes(range(16))
NONCE = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
SEED = 1337


def u32_sum(out: torch.Tensor) -> torch.Tensor:
    """Sum of the words mod 2^32 as a 0-d int32 tensor with the same bits."""
    s = out.sum(dtype=torch.int64) & 0xFFFFFFFF
    return (s - ((s & 0x80000000) << 1)).to(torch.int32)


class Chain:
    """The chained CTR measurement of one buffer on one device."""

    def __init__(self, nbytes: int, device):
        if nbytes <= 0 or nbytes % 16:
            raise ValueError(f"buffer size must be a positive multiple of 16, got {nbytes}")
        self.device = aes_mod.as_device(device)
        self.nbytes = nbytes
        self.aes = aes_mod.AES(KEY, device=self.device)
        host = np.random.default_rng(SEED).integers(0, 256, nbytes, dtype=np.uint8)
        self.words = packing.words_tensor(packing.np_bytes_to_words(host), self.device)
        nonce = np.frombuffer(NONCE, np.uint8)
        self.ctr_be = packing.words_tensor(
            packing.np_bytes_to_words(nonce).byteswap(), self.device)
        self.crypt = aes_mod.ctr_crypt_fn(self.aes.nr, self.aes.engine)

    def run(self, k: int) -> torch.Tensor:
        """k chained steps; returns the final acc as a 0-d int32 tensor."""
        acc = torch.zeros((), dtype=torch.int32, device=self.device)
        for _ in range(k):
            acc = u32_sum(self.crypt(self.words, self.ctr_be ^ acc, self.aes.rk_enc))
        return acc

    def timed(self, k: int) -> tuple[float, int]:
        """(seconds, digest) of a k-step chain."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            acc = self.run(k)
            stop.record()
            stop.synchronize()
            secs = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            acc = self.run(k)
            secs = time.perf_counter() - t0
        return secs, int(acc.item()) & 0xFFFFFFFF

    def measure(self, iters: int, reps: int) -> tuple[list[float], int]:
        """Sorted GB/s samples of ``reps`` chains and the chain digest."""
        self.timed(1)  # warm-up: kernel build and load
        t1 = min(self.timed(1)[0] for _ in range(2))
        samples, digest = [], 0
        for _ in range(max(reps, 1)):
            tk, digest = self.timed(1 + iters)
            samples.append(iters * self.nbytes / max(tk - t1, 1e-9) / 1e9)
        return sorted(samples), digest


def report_line(nbytes: int, platform: str, engine: str, digest: int,
                samples: list[float]) -> dict:
    s, n = samples, len(samples)
    gbps = s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
    return {
        "metric": f"AES-128-CTR throughput, {nbytes >> 20} MiB buffer, "
                  f"1 {platform} device, engine={engine}, digest={digest:#010x}",
        "value": round(gbps, 4),
        "unit": "GB/s",
        "vs_baseline": round(gbps / BASELINE_CTR_GBPS, 3),
        "value_min": round(samples[0], 4),
        "value_max": round(samples[-1], 4),
        "reps": len(samples),
    }


def run(device=None, nbytes: int | None = None, iters: int | None = None,
        reps: int | None = None) -> dict:
    """Measure and return the JSON line (a dict); arguments default to the
    ``OT_BENCH_*`` environment and then to 256 MiB, 5 iterations, 3 reps."""
    op = os.environ.get("OT_BENCH_OP", "ctr")
    if op != "ctr":
        raise NotImplementedError(f"OT_BENCH_OP={op!r} is not ported yet")
    nbytes = nbytes or int(os.environ.get("OT_BENCH_BYTES", 256 << 20))
    iters = iters or int(os.environ.get("OT_BENCH_ITERS", 5))
    reps = reps or int(os.environ.get("OT_BENCH_REPS", 3))
    chain = Chain(nbytes, device)
    samples, digest = chain.measure(iters, reps)
    platform = "gpu" if chain.device.type == "cuda" else chain.device.type
    return report_line(nbytes, platform, chain.aes.engine, digest, samples)


def main() -> int:
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
