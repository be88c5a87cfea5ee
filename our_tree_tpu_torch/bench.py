"""AES-128 throughput on one card: ``python -m our_tree_tpu_torch.bench``.

Prints ONE JSON line in the schema of the root ``bench.py``:
  {"metric": ..., "value": GB/s median, "unit": "GB/s", "vs_baseline": ...,
   "value_min": ..., "value_max": ..., "reps": ...}

Method (root ``bench.py:514-598``): key ``bytes(range(16))``, nonce
``f0..ff``, data from ``default_rng(1337)``. Each chain step runs the
operation with the running sum ``acc`` threaded into an input its work
depends on, and sets ``acc`` to the u32 sum of the output words; the digest
is the final ``acc``. ``OT_BENCH_OP`` picks the operation, as the root
``bench.py:59-68`` does: ``ctr`` (the default; ``acc`` XORed into all four BE
counter words, so no step can be hoisted), ``ecb`` and ``ecb-dec`` (``acc``
XORed into the data; ``ecb_encrypt_kernel`` and ``ecb_decrypt_kernel`` on
the card). ``acc`` stays a tensor on
the card and the kernel reads the counter through a device pointer, so the
chain never waits on the host. The reported time of ``iters`` steps is
T(1 + iters) - T(1), timed with CUDA events; the line reports the median of
``OT_BENCH_REPS`` (default 3) such measurements with min and max.

Engine (``OT_BENCH_ENGINE``, root ``bench.py:471`` and ``:600-695``): the
default ``probe`` measures each engine of ``ranking.probe_order`` (the
kernels ``cuda`` and the T-table oracle ``ttable``; never the plain
``bitslice``) at ``min(OT_BENCH_BYTES, 256 MiB)``, two iterations, the
best of two samples; stores the ranking under the card's key
(``utils/ranking.py``, ``OT_ENGINE_RANKING``) when the operation is
``ctr``, and measures the headline on ``resolve_engine("auto")``. Two rules
differ from the reference: probe digests that disagree fail the run (the
reference drops the minority, ``bench.py:421-445``; every probe here
holds ``cuda``, so any dissent involves the kernel engine), as does a
headline digest other than ``DEFAULT_DIGEST`` at the default configuration
(``ctr``, 256 MiB, 5 iterations), so a 1-1 split never picks an engine;
and an exception while probing a kernel engine propagates, where a
``ttable`` failure is data. On the CPU ``probe`` means ``auto`` and writes nothing.
Any other value names the engine (``auto``, ``cuda``, ``ttable``,
``bitslice``).

The card is single-tenant for a measurement (``utils/devlock.py``, root
``bench.py:291-353``): ``main`` waits up to 0.3 x ``OT_BENCH_DEADLINE``
(default 1200 s) for a holder of ``OT_BENCH_BUSY_FILE`` (default
``gpu_busy`` under ``TMPDIR``), claims it with a bounded retry and releases
it at the end. Where a live holder outlasts the wait it exits 3, names the holder and
prints no line: the reference reports a native CPU number there, and the
port never measures the CPU in place of the card.

Environment: ``OT_BENCH_BYTES`` (default 256 MiB), ``OT_BENCH_ITERS``
(default 5), ``OT_BENCH_REPS`` (default 3), ``OT_BENCH_OP`` (``ctr``,
``ecb`` or ``ecb-dec``), ``OT_BENCH_ENGINE`` (default ``probe``). Without a
card it raises; tests call ``run(device="cpu")``, whose line then names
the CPU platform.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .models import aes as aes_mod
from .resilience import watchdog
from .utils import devlock, packing, ranking

#: Reference bars per operation (root bench.py BASELINES, BASELINE.md): the
#: reference C library's AES-NI CTR (1 GiB, 8 CPU threads) and ECB (8 CPU
#: threads) rates, CPU numbers; ECB's serves ecb-dec too, as in the root.
BASELINES = {"ctr": 0.520, "ecb": 0.551, "ecb-dec": 0.551}
KEY = bytes(range(16))
NONCE = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
SEED = 1337
#: The chain digest at the default configuration (``ctr``, 256 MiB, 5
#: iterations), the one every correct engine prints.
DEFAULT_DIGEST = 0xA612A647
DEFAULT_CONFIG = ("ctr", 256 << 20, 5)
#: The probe's size cap, its iterations and its samples (root ``bench.py``).
PROBE_CAP = 256 << 20
PROBE_ITERS = 2
PROBE_REPS = 2


def u32_sum(out: torch.Tensor) -> torch.Tensor:
    """Sum of the words mod 2^32 as a 0-d int32 tensor with the same bits."""
    s = out.sum(dtype=torch.int64) & 0xFFFFFFFF
    return (s - ((s & 0x80000000) << 1)).to(torch.int32)


class Chain:
    """The chained measurement of one operation (``ctr``, ``ecb``,
    ``ecb-dec``) over one buffer on one device."""

    def __init__(self, nbytes: int, device, op: str = "ctr", engine: str = "auto"):
        if nbytes <= 0 or nbytes % 16:
            raise ValueError(f"buffer size must be a positive multiple of 16, got {nbytes}")
        if op not in BASELINES:
            raise ValueError(f"OT_BENCH_OP must be ctr|ecb|ecb-dec, got {op!r}")
        self.op = op
        self.device = aes_mod.as_device(device)
        self.nbytes = nbytes
        self.aes = aes_mod.AES(KEY, engine=engine, device=self.device)
        host = np.random.default_rng(SEED).integers(0, 256, nbytes, dtype=np.uint8)
        self.words = packing.words_tensor(packing.np_bytes_to_words(host), self.device)
        nonce = np.frombuffer(NONCE, np.uint8)
        self.ctr_be = packing.words_tensor(
            packing.np_bytes_to_words(nonce).byteswap(), self.device)
        ctx, nr, eng = self.aes, self.aes.nr, self.aes.engine
        if op == "ctr":
            ctr = aes_mod.ctr_crypt_fn(nr, eng)
            self.step = lambda acc: ctr(self.words, self.ctr_be ^ acc, ctx.rk_enc)
        elif op == "ecb":
            self.step = lambda acc: aes_mod.ecb_encrypt_words(self.words ^ acc, ctx.rk_enc, nr, eng)
        else:
            self.step = lambda acc: aes_mod.ecb_decrypt_words(self.words ^ acc, ctx.rk_dec, nr, eng)

    def run(self, k: int) -> torch.Tensor:
        """k chained steps; returns the final acc as a 0-d int32 tensor."""
        acc = torch.zeros((), dtype=torch.int32, device=self.device)
        for _ in range(k):
            acc = u32_sum(self.step(acc))
        return acc

    def timed(self, k: int) -> tuple[float, int]:
        """(seconds, digest) of a k-step chain."""
        if self.device.type == "cuda":
            # The card's waits under the opt-in dispatch deadline
            # (``OT_DISPATCH_DEADLINE``): a wedged card raises, not hangs.
            with watchdog.deadline(watchdog.default_deadline_s(), what="bench chain"):
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
                samples: list[float], op: str = "ctr") -> dict:
    s, n = samples, len(samples)
    # The ratio is of the reported (rounded) value, so the line agrees with
    # itself whatever the measurement's later digits.
    gbps = round(s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2]), 4)
    return {
        "metric": f"AES-128-{op.upper()} throughput, {nbytes >> 20} MiB buffer, "
                  f"1 {platform} device, engine={engine}, digest={digest:#010x}",
        "value": gbps,
        "unit": "GB/s",
        "vs_baseline": round(gbps / BASELINES[op], 3),
        "value_min": round(samples[0], 4),
        "value_max": round(samples[-1], 4),
        "reps": len(samples),
    }


def probe_stage(key: str, measure, op: str = "ctr", nbytes: int = PROBE_CAP) -> tuple[str, dict]:
    """Measure each engine of ``ranking.probe_order(key, CORES)`` with
    ``measure(engine) -> (sorted GB/s samples, digest)``, store the ranking
    under ``key`` (``ctr`` only) and return (the headline's engine,
    ``aes.auto_engine(key)``; {engine: best GB/s}). A kernel engine's
    failure propagates, another engine's is printed and left out; any
    disagreement of the digests raises."""
    probes, digests = {}, {}
    for eng in ranking.probe_order(key, aes_mod.CORES):
        try:
            samples, digests[eng] = measure(eng)
        except Exception as e:
            if eng in aes_mod.KERNEL_BACKED:
                raise
            print(f"# probe {eng}: failed ({type(e).__name__}: {e})"[:500], file=sys.stderr)
            continue
        probes[eng] = samples[-1]
    if len(set(digests.values())) > 1:
        listed = ", ".join(f"{k}={v:#010x}" for k, v in sorted(digests.items()))
        raise RuntimeError(f"probe digests disagree ({listed}): the engines compute other "
                           f"bytes on this device")
    print("# probe GB/s: " + ", ".join(f"{k}={v:.4f}" for k, v in sorted(probes.items())),
          file=sys.stderr)
    if op == "ctr" and ranking.store(key, probes, "bench-probe", nbytes):
        print(f"# ranking persisted to {ranking.path()}", file=sys.stderr)
    return aes_mod.auto_engine(key), probes


def run(device=None, nbytes: int | None = None, iters: int | None = None,
        reps: int | None = None, engine: str = "auto") -> dict:
    """Measure and return the JSON line (a dict); arguments default to the
    ``OT_BENCH_*`` environment and then to 256 MiB, 5 iterations, 3 reps.
    ``engine="probe"`` runs the probe stage first on a card (on the CPU it
    means ``auto``)."""
    op = os.environ.get("OT_BENCH_OP", "ctr")
    nbytes = nbytes or int(os.environ.get("OT_BENCH_BYTES", 256 << 20))
    iters = iters or int(os.environ.get("OT_BENCH_ITERS", 5))
    reps = reps or int(os.environ.get("OT_BENCH_REPS", 3))
    dev = aes_mod.as_device(device)
    if engine == "probe":
        engine = "auto"
        if dev.type == "cuda":
            probe_bytes = min(nbytes, PROBE_CAP)
            engine, _ = probe_stage(
                aes_mod.rank_key(dev),
                lambda eng: Chain(probe_bytes, dev, op, eng).measure(PROBE_ITERS, PROBE_REPS),
                op, probe_bytes)
    chain = Chain(nbytes, dev, op, engine)
    samples, digest = chain.measure(iters, reps)
    if (op, nbytes, iters) == DEFAULT_CONFIG and digest != DEFAULT_DIGEST:
        raise RuntimeError(f"engine {chain.aes.engine}: chain digest {digest:#010x} at the default "
                           f"configuration, expected {DEFAULT_DIGEST:#010x}")
    platform = "gpu" if chain.device.type == "cuda" else chain.device.type
    return report_line(nbytes, platform, chain.aes.engine, digest, samples, op)


class CardBusy(RuntimeError):
    """A live holder of the device lock outlasted the wait."""


def claim_card() -> bool:
    """Wait for a holder of the device lock (0.3 x ``OT_BENCH_DEADLINE``),
    then claim it with a bounded retry; True when this process owns it.
    Raises ``CardBusy`` naming the holder when a live one remains. The
    held-or-owned decision is taken inside the loop on the observation that
    made ``acquire`` fail, so a holder that leaves in between sends the loop
    back to ``acquire``."""
    budget = 0.3 * float(os.environ.get("OT_BENCH_DEADLINE", 1200))
    devlock.wait(budget, poll_s=min(15.0, max(budget, 0.05)),
                 on_wait=lambda p: print(f"# waiting for a concurrent card job ({p})",
                                         file=sys.stderr))
    held = False
    for _ in range(3):
        if devlock.acquire():
            return True
        held = devlock.is_held()
        if held:
            break
    if held:
        raise CardBusy(f"card busy: {devlock.path()} is held by {devlock.holder()}; not "
                       f"measuring (the port never reports the CPU in place of the card)")
    return False


def main() -> int:
    engine = os.environ.get("OT_BENCH_ENGINE", "probe")
    aes_mod.as_device(None)  # raises without a card
    try:
        owned = claim_card()
    except CardBusy as e:
        print(f"# {e}", file=sys.stderr)
        return 3
    try:
        line = run(engine=engine)
    finally:
        devlock.release(owned)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
