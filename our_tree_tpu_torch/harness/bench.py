"""The sweep CLI: ``python -m our_tree_tpu_torch.harness.bench``.

Copy of ``our_tree_tpu.harness.bench`` with the same flags, rows and checks,
on the port's backends (``harness/backends.py``): ``--backend gpu`` (the
default; the card, or the CPU with ``--device cpu``) and ``--backend c`` (the
native C tier). The sweep is sizes x workers x iterations from a fixed seed,
and each row is the reference's CSV format::

    <name>, <msg_bytes>, <workers>, t1, t2, ..., tN,

followed by a ``# derived: X GB/s`` comment line; RC4 also prints its
separately timed keystream line ("Generated a new key in <us>,"), and a run
with ``rc4`` ends with the ARC4 known-answer self-test. The same seed draws
the same keys and messages in the same order as the JAX harness, so the two
print the same lines but for the times, and a journal resumes the same way.
Output goes to stdout and, with ``--out`` or ``--default-out``, to a file
(``results.<host>.gpu`` / ``.c``).

Checked, not assumed: after the sweeps one message runs through every
worker count and is bit-compared (shard invariance), the RC4 XOR phase is
checked against numpy, the batch keystreams against the single-stream one,
and the run ends with the known-answer self-test.

Timing: ``--timing e2e`` (the default) includes host<->device staging;
``device`` reports per-pass device time by the chained difference
(``GpuBackend.chained_device_times_us``: 1 + k data-dependent passes as one
CUDA graph replay, (T(1+k) - T(1)) / k); ``device-sync`` keeps the per-call
convention (kernel plus a synchronize).

Differences from the JAX harness: the device backend is named ``gpu``
(``tpu`` there) and its rows say ``GPU``; ``--engine`` takes the port's
engines (``auto``, ``cuda``, ``bitslice``, ``ttable``); ``--device`` picks
the device. A worker is a rank of a ``torch.distributed`` world, one device
each (ROADMAP.md, "Multi-device"): ``python -m torch.distributed.run
--nproc-per-node N -m our_tree_tpu_torch.harness.bench --workers 1,...,N
...`` runs every row on every rank, a row of W workers sharded over the
first W ranks (``harness/backends.py`` says how each ``--timing`` treats
it), and rank 0 alone prints and writes; ``--dist-backend gloo`` puts ranks
that share one card on gloo. Without a world ``--workers`` above 1 raises
and names that launch. On the gpu backend each unit's kernel launches go to
stderr as ``# launches: <unit> {...}`` (``# launches rank R: ...`` from the
other ranks). Resilience is the reference's: ``--journal`` checkpoints and
resumes, ``--isolate`` runs each unit in a child with a deadline and
quarantines repeat offenders, ``--unquarantine`` releases one,
``--dispatch-deadline`` arms the watchdog around each unit, ``--profile
DIR`` captures the sweep with ``torch.profiler`` into DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

import numpy as np

from ..obs import trace as trace_mod
from ..resilience import degrade as degrade_mod
from ..resilience import faults as faults_mod
from ..resilience import isolate as isolate_mod
from ..resilience import journal as journal_mod
from ..resilience import watchdog as watchdog_mod
from .backends import ENGINES, make_backend

MIB = 1 << 20

#: Fixed nonce and IV, the reference harness's constants.
NONCE = np.frombuffer(bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff"), np.uint8)
IV = np.frombuffer(bytes.fromhex("000102030405060708090a0b0c0d0e0f"), np.uint8)


class Emitter:
    def __init__(self, path: str | None, quiet: bool = False):
        self.f = open(path, "w") if path else None
        self._capture: list[str] | None = None
        self._quiet = quiet  # a rank other than 0 of a world

    def line(self, text: str):
        if not self._quiet:
            print(text, flush=True)
        if self.f:
            self.f.write(text + "\n")
            self.f.flush()
        if self._capture is not None:
            self._capture.append(text)

    def begin_capture(self):
        """Start recording emitted lines (a resumed sweep re-emits a
        completed unit's lines verbatim)."""
        self._capture = []

    def end_capture(self) -> list[str]:
        lines, self._capture = self._capture or [], None
        return lines

    def capture_len(self) -> int:
        """Current capture length: a row checkpoint's slice mark."""
        return len(self._capture or ())

    def capture_since(self, mark: int) -> list[str]:
        """Lines captured since ``mark`` (one worker row's output)."""
        return list((self._capture or [])[mark:])

    def close(self):
        if self.f:
            self.f.close()


def _csv(times_us: list[int]) -> str:
    return "".join(f"{t}, " for t in times_us).rstrip()


def _host(x) -> np.ndarray:
    """A backend's output (a device tensor or a numpy array) on the host."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _whole(backend, x, workers: int, n: int) -> np.ndarray:
    """A call's whole output on the host: a sharded call's rank shards
    gathered (the first ``n`` rows), anything else as it is."""
    gather = getattr(backend, "gather", None)
    return _host(gather(x, workers, n) if gather is not None else x)


def _slowest(backend, times: list, workers: int) -> list:
    """A row's times: under a world, each its slowest rank's."""
    fn = getattr(backend, "row_times", None)
    return fn(times, workers) if fn is not None else times


def _derived(em, nbytes: int, times_us: list[int], floor_us: int = 0):
    """Derived GB/s of the best iteration beside the µs row, as a comment
    line so the rows stay the reference's format. ``floor_us`` entries are
    the chained timing's jitter sentinel (``GpuBackend.FLOOR_US``), left out
    so an artifact never wins the best-of; a row with nothing else gets no
    rate."""
    valid = [t for t in times_us if t > floor_us]
    if not valid:
        if times_us:
            em.line("# derived: n/a (all iterations at/below the chained-"
                    "timing resolution floor)")
        return
    v = nbytes / min(valid) / 1e3
    # Sequential rows land far below 1 MB/s; 3 decimals would print 0.000.
    text = f"{v:.3f}" if v >= 0.1 else f"{v:.3g}"
    em.line(f"# derived: {text} GB/s (best of {len(valid)})")


def _time_us(fn) -> tuple[int, object]:
    """Time ``fn()`` in µs: the dispatch seam every timed region of every
    backend passes through, so an armed ``dispatch_hang`` wedges the sweep
    inside a timed call, for the watchdog or the ``--isolate`` supervisor.
    With ``OT_FAKE_TIME_US`` set every region reports that value (the work
    still runs): the resume tests compare corpora byte for byte."""
    with trace_mod.span("timed-call", seam="harness._time_us"):
        watchdog_mod.injected_hang("dispatch_hang", "harness timed region")
        t0 = time.perf_counter_ns()
        out = fn()
        us = (time.perf_counter_ns() - t0) // 1000
    fake = os.environ.get("OT_FAKE_TIME_US")
    if fake:
        return max(int(fake), 1), out
    return us, out


def _chain_k(size: int, cap_mib: int = 2048, max_k: int = 2048, min_k: int = 4) -> int:
    """Chain length of the chained-difference timing, the one policy every
    chained row shares: inversely proportional to the buffer, so the chained
    work dominates timer noise at small buffers, with ``cap_mib`` bounding
    the total chained bytes and ``max_k`` the passes; the sequential modes
    pass small caps with ``min_k=1``."""
    return max(min_k, min(max_k, (cap_mib * MIB) // max(size, 1)))


def _mode_crypt(backend, mode, ctx, workers, ctr_be=None, ivw=None, chained=True):
    """The one mode dispatch both timing paths share: ``crypt(words, acc)``.
    When ``chained``, the carry goes where the mode's work reads it (CTR:
    the counter, which the keystream depends on; every other mode: the
    data); otherwise it is dropped, so no extra pass enters a timed call."""
    mix = (lambda x, acc: x ^ acc) if chained else (lambda x, acc: x)
    if mode == "ctr":
        return lambda w, acc: backend.ctr(ctx, w, mix(ctr_be, acc), workers)
    if mode == "ecb":
        return lambda w, acc: backend.ecb(ctx, mix(w, acc), workers)
    if mode == "ecb-dec":
        return lambda w, acc: backend.ecb_dec(ctx, mix(w, acc), workers)
    if mode == "cbc":
        return lambda w, acc: backend.cbc(ctx, mix(w, acc), ivw, workers)
    if mode == "cbc-dec":
        return lambda w, acc: backend.cbc_dec(ctx, mix(w, acc), ivw, workers)
    if mode == "cfb128":
        return lambda w, acc: backend.cfb128(ctx, mix(w, acc), ivw, workers)
    raise ValueError(mode)


def run_aes_mode(em, backend, mode, size, workers_list, iters, keybits, rng, timing,
                 stream_chunk=0, rows=None):
    msg = rng.integers(0, 256, size, dtype=np.uint8)
    if mode in ("cbc", "cfb128") and workers_list != [1]:
        # A single chained stream is a recurrence: the row runs one worker
        # and says so.
        hint = ("use cbc-batch for multi-worker scaling" if mode == "cbc"
                else "chained modes scale by batching independent streams")
        em.line(f"{mode.upper()} single-stream is sequential; sweeping "
                f"workers=1 only ({hint}),")
        workers_list = [1]
    streaming = (stream_chunk and mode == "ctr" and size > stream_chunk
                 and hasattr(backend, "ctr_stream"))
    if streaming:
        em.line(f"Streaming {size} bytes in {stream_chunk}-byte chunks "
                "(counter carried across seams; e2e timing),")
    chained_ok = (timing == "device" and not streaming
                  and hasattr(backend, "chained_device_times_us"))
    needs_iv = mode in ("cbc", "cbc-dec", "cfb128")

    def one_row(workers):
        if chained_ok:
            key = rng.integers(0, 256, keybits // 8, dtype=np.uint8).tobytes()
            ctx = backend.make_key(key)
            crypt = _mode_crypt(
                backend, mode, ctx, workers,
                ctr_be=backend.ctr_be_words(NONCE) if mode == "ctr" else None,
                ivw=backend.iv_words(IV) if needs_iv else None)
            words = backend.stage_words(msg)
            backend.block_until_ready(words)
            k = (_chain_k(size, 8, max_k=4, min_k=1)
                 if mode in ("cbc", "cfb128") else _chain_k(size))
            times = _slowest(backend, backend.chained_device_times_us(crypt, words, iters, k),
                             workers)
            label = backend.name.upper()
            em.line(f"{label} AES-{keybits} {mode.upper()}, {size}, "
                    f"{workers}, {_csv(times)}")
            _derived(em, size, times, backend.FLOOR_US)
            return
        times = []
        warmed = False
        for _ in range(iters):
            key = rng.integers(0, 256, keybits // 8, dtype=np.uint8).tobytes()
            ctx = backend.make_key(key)  # untimed, like the reference
            if streaming:
                if not warmed:
                    backend.ctr_stream(ctx, msg, NONCE, stream_chunk, workers)
                    warmed = True
                us, _ = _time_us(
                    lambda: backend.ctr_stream(ctx, msg, NONCE, stream_chunk, workers))
                times.append(us)
                continue
            crypt = _mode_crypt(
                backend, mode, ctx, workers,
                ctr_be=backend.ctr_be_words(NONCE) if mode == "ctr" else None,
                ivw=backend.iv_words(IV) if needs_iv else None,
                chained=False)
            run = lambda w: crypt(w, 0)  # noqa: E731
            if not warmed:
                # One untimed call absorbs the kernel build and first launch.
                backend.block_until_ready(run(backend.stage_words(msg)))
                warmed = True
            if timing in ("device", "device-sync"):
                words = backend.stage_words(msg)
                backend.block_until_ready(words)
                us, out = _time_us(lambda: backend.block_until_ready(run(words)))
            else:
                us, out = _time_us(
                    lambda: backend.block_until_ready(run(backend.stage_words(msg))))
            times.append(us)
        times = _slowest(backend, times, workers)
        label = backend.name.upper()
        em.line(f"{label} AES-{keybits} {mode.upper()}, {size}, {workers}, {_csv(times)}")
        _derived(em, size, times)

    for i, workers in enumerate(workers_list):
        # Per-worker-row resume: a recorded row replays (its lines
        # re-emitted, the RNG restored to its post-row state).
        if rows is not None and rows.replay(workers):
            continue
        with trace_mod.span("row", mode=mode, size=size, workers=workers):
            one_row(workers)
        if rows is not None:
            rows.record(workers, last=(i == len(workers_list) - 1))


def run_cbc_batch(em, backend, size, workers_list, iters, keybits, rng, timing, streams):
    """S independent CBC-encrypt streams: chained modes scale across
    streams, not within one."""
    if not hasattr(backend, "cbc_batch"):
        raise ValueError("cbc-batch requires the gpu backend")
    streams = max(1, min(streams, size // 16))
    per = (size // streams) // 16 * 16
    used = per * streams
    em.line(f"Batch of {streams} independent CBC streams, {per} bytes each,")
    msg = rng.integers(0, 256, (streams, per), dtype=np.uint8)
    inv_key = rng.integers(0, 256, keybits // 8, dtype=np.uint8).tobytes()
    inv_ivs = rng.integers(0, 256, (streams, 16), dtype=np.uint8)
    inv_ref = None
    chained_ok = timing == "device" and hasattr(backend, "chained_device_times_us")
    for workers in workers_list:
        if chained_ok:
            key = rng.integers(0, 256, keybits // 8, dtype=np.uint8).tobytes()
            ctx = backend.make_key(key)
            ivw = backend.stage_batch_words(
                rng.integers(0, 256, (streams, 16), dtype=np.uint8))
            crypt = lambda w, acc: backend.cbc_batch(ctx, w ^ acc, ivw, workers)  # noqa: E731
            words = backend.stage_batch_words(msg)
            backend.block_until_ready(words)
            times = backend.chained_device_times_us(
                crypt, words, iters, _chain_k(used, 64, max_k=16, min_k=1))
        else:
            times = []
            warmed = False
            for _ in range(iters):
                key = rng.integers(0, 256, keybits // 8, dtype=np.uint8).tobytes()
                ctx = backend.make_key(key)
                ivs = rng.integers(0, 256, (streams, 16), dtype=np.uint8)
                ivw = backend.stage_batch_words(ivs)
                run = lambda w: backend.cbc_batch(ctx, w, ivw, workers)  # noqa: E731
                if not warmed:
                    backend.block_until_ready(run(backend.stage_batch_words(msg)))
                    warmed = True
                if timing in ("device", "device-sync"):
                    words = backend.stage_batch_words(msg)
                    backend.block_until_ready(words)
                    us, _ = _time_us(lambda: backend.block_until_ready(run(words)))
                else:
                    us, _ = _time_us(lambda: backend.block_until_ready(
                        run(backend.stage_batch_words(msg))))
                times.append(us)
        times = _slowest(backend, times, workers)
        em.line(f"{backend.name.upper()} AES-{keybits} CBC-BATCHx{streams}, "
                f"{used}, {workers}, {_csv(times)}")
        _derived(em, used, times, getattr(backend, "FLOOR_US", 0) if chained_ok else 0)
        # Worker-count invariance on a fixed key and IV set.
        ctx = backend.make_key(inv_key)
        got = _whole(backend, backend.block_until_ready(
            backend.cbc_batch(ctx, backend.stage_batch_words(msg),
                              backend.stage_batch_words(inv_ivs), workers)), workers, streams)
        if inv_ref is None:
            inv_ref = got
        elif not np.array_equal(got, inv_ref):
            em.line(f"CBC-BATCH SHARD-INVARIANCE FAILED at workers={workers}")
            raise SystemExit(2)
    if len(workers_list) > 1:
        em.line(f"CBC-batch shard invariance {workers_list}: passed")


def run_rc4_batch(em, backend, size, workers_list, iters, rng, streams):
    """S independent RC4 keystreams, one ARC4 kernel launch on the card.
    Device-timed by construction: the keystreams are born and stay on the
    device."""
    if not hasattr(backend, "arc4_prep_batch"):
        raise ValueError("rc4-batch requires the gpu backend")
    streams = max(1, min(streams, size))
    per = size // streams
    used = per * streams
    em.line(f"Batch of {streams} independent RC4 keystreams, {per} bytes "
            "each (device timing: keystreams are born and stay on device),")
    keys = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(streams)]
    # The KSA phase is timed on its own, like the reference's keygen line.
    us, states = _time_us(lambda: backend.arc4_batch_states(keys))
    em.line(f"Generated {streams} key schedules in {us}, ")
    inv_ref = None
    for workers in workers_list:
        backend.block_until_ready(backend.arc4_prep_batch(states, per, workers))  # untimed
        times = []
        out = None
        for _ in range(iters):
            us, out = _time_us(lambda: backend.block_until_ready(
                backend.arc4_prep_batch(states, per, workers)))
            times.append(us)
        times = _slowest(backend, times, workers)
        em.line(f"RC4-KEYGEN-BATCHx{streams}, {used}, {workers}, {_csv(times)}")
        _derived(em, used, times)
        got = _whole(backend, out, workers, streams)
        if inv_ref is None:
            inv_ref = got
        elif not np.array_equal(got, inv_ref):
            em.line(f"RC4-BATCH SHARD-INVARIANCE FAILED at workers={workers}")
            raise SystemExit(2)
    # Stream 0 against the single-stream path's keystream.
    from ..models.arc4 import ARC4

    if not np.array_equal(inv_ref[0], ARC4(keys[0], device=backend.device).prep(per)):
        em.line("RC4-BATCH PARITY FAILED vs single-stream prep")
        raise SystemExit(2)
    em.line("RC4-batch parity vs single-stream: passed")
    if len(workers_list) > 1:
        em.line(f"RC4-batch shard invariance {workers_list}: passed")


def check_shard_invariance(em, backend, size, workers_list, keybits, rng):
    """Same key and data through every worker count -> identical output."""
    msg = rng.integers(0, 256, size, dtype=np.uint8)
    key = rng.integers(0, 256, keybits // 8, dtype=np.uint8).tobytes()
    ctx = backend.make_key(key)
    words = backend.stage_words(msg)
    ctr_be = backend.ctr_be_words(NONCE)
    ref_ecb = ref_ctr = None
    for workers in workers_list:
        n = words.shape[0]
        e = _whole(backend, backend.block_until_ready(backend.ecb(ctx, words, workers)), workers, n)
        c = _whole(backend, backend.block_until_ready(backend.ctr(ctx, words, ctr_be, workers)),
                   workers, n)
        if ref_ecb is None:
            ref_ecb, ref_ctr = e, c
        elif not (np.array_equal(e, ref_ecb) and np.array_equal(c, ref_ctr)):
            em.line(f"SHARD-INVARIANCE FAILED at workers={workers}")
            raise SystemExit(2)
    em.line(f"Shard invariance {workers_list}: passed")


def run_rc4(em, backend, size, workers_list, iters, rng, timing="e2e", rows=None):
    msg = rng.integers(0, 256, size, dtype=np.uint8)
    chained_ok = timing == "device" and hasattr(backend, "chained_device_times_us")

    def one_row(workers):
        em.line(f"RC4, {size}, {workers}, ")
        key = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        # Key schedule and keystream: sequential, timed once a row.
        us, ks = _time_us(lambda: backend.arc4_setup_prep(key, size))
        em.line(f"Generated a new key in {us}, ")
        ks_dev = backend.to_device(_host(ks))
        data_dev = backend.to_device(msg)
        out = backend.block_until_ready(backend.arc4_crypt(data_dev, ks_dev, workers))
        if chained_ok:
            # The XOR phase's rate by the chained difference (the low byte
            # of the carry keeps the passes data-dependent); XOR is far
            # cheaper a byte than AES, so the chain gets more passes.
            crypt = lambda d, acc: backend.arc4_crypt(  # noqa: E731
                d ^ acc.to(d.dtype), ks_dev, workers)
            times = backend.chained_device_times_us(
                crypt, data_dev, iters, _chain_k(size, 8192, 8192))
        else:
            times = []
            for _ in range(iters):
                us, out = _time_us(lambda: backend.block_until_ready(
                    backend.arc4_crypt(data_dev, ks_dev, workers)))
                times.append(us)
        times = _slowest(backend, times, workers)
        em.line(f"{_csv(times)}")
        _derived(em, size, times, getattr(backend, "FLOOR_US", 0) if chained_ok else 0)
        # The XOR phase checked against numpy.
        if out is not None and not np.array_equal(_whole(backend, out, workers, size),
                                                  msg ^ _host(ks)):
            em.line(f"RC4 XOR MISMATCH at workers={workers}")
            raise SystemExit(2)

    for i, workers in enumerate(workers_list):
        if rows is not None and rows.replay(workers):
            continue
        with trace_mod.span("row", mode="rc4", size=size, workers=workers):
            one_row(workers)
        if rows is not None:
            rows.record(workers, last=(i == len(workers_list) - 1))


def arc4_self_test(em, device):
    """The Rescorla (1994) vectors through setup -> prep -> crypt on
    ``device``, printed in the reference's format."""
    from ..models.arc4 import ARC4

    vectors = [
        ("0123456789abcdef", "0123456789abcdef", "75b7878099e0c596"),
        ("0123456789abcdef", "0000000000000000", "7494c2e7104b0879"),
        ("0000000000000000", "0000000000000000", "de188941a3375d3a"),
    ]
    for i, (key, pt, ct) in enumerate(vectors, 1):
        rc = ARC4(bytes.fromhex(key), device=device)
        ks = rc.prep(8)
        out = rc.crypt(np.frombuffer(bytes.fromhex(pt), np.uint8), ks)
        ok = out.tobytes().hex() == ct
        em.line(f"ARC4 test #{i}: {'passed' if ok else 'FAILED'}")
        if not ok:
            raise SystemExit(2)


class _RowCheckpoint:
    """Worker-row checkpoints inside a journaled unit: each completed row
    (its lines and the post-row RNG state) is recorded as it finishes, so a
    unit that dies midway re-runs from its last completed row. ``replay``
    re-emits a recorded row and restores the RNG; the unit's last row is
    never recorded (the unit's own record follows at once)."""

    def __init__(self, journal, unit, em, rng):
        self._journal, self._unit = journal, unit
        self._em, self._rng = em, rng
        self._recs = journal.rows(unit)
        self._mark = 0
        self.replayed = 0

    def replay(self, row) -> bool:
        rec = self._recs.get(str(row))
        if rec is None:
            self._mark = self._em.capture_len()
            return False
        for line in rec.get("lines", []):
            self._em.line(line)
        state = rec.get("rng_state")
        if state is not None:
            self._rng.bit_generator.state = state
        trace_mod.point("row-replayed", unit=self._unit, row=str(row))
        self.replayed += 1
        return True

    def record(self, row, last=False) -> None:
        if last:
            return
        self._journal.record_row(self._unit, str(row), self._em.capture_since(self._mark),
                                 self._rng.bit_generator.state)


def _sweep_config(args, sizes, workers_list, modes) -> dict:
    """The sweep's identity, the journal's config hash: everything that
    shapes the unit sequence or the bytes each unit emits. One function
    shared by the isolate parent, its children and plain journaled runs."""
    return {
        "backend": args.backend, "engine": args.engine, "sizes": sizes,
        "workers": workers_list, "iters": args.iters,
        "keybits": args.keybits, "modes": modes, "streams": args.streams,
        "seed": args.seed, "timing": args.timing,
        "stream_chunk_mb": args.stream_chunk_mb,
    }


def _unit_names(modes, sizes, workers_list) -> list[str]:
    """Ordered unit names as a pure function of the config (the journal's
    replay contract; the isolate parent plans from it without a backend).
    It mirrors the unit list ``main`` builds, which asserts so."""
    names = [f"{mode}:{size}" for mode in modes for size in sizes]
    if len(workers_list) > 1 and {"ecb", "ctr"} & set(modes):
        names.append("shard-invariance")
    if "rc4" in modes:
        names.append("arc4-self-test")
    return names


def main(argv=None) -> int:
    # The trace run id is minted before anything can spawn a child, so
    # isolated children join this run.
    trace_mod.ensure_run()
    ap = argparse.ArgumentParser(
        description="our-tree-tpu benchmark sweep on the PyTorch/CUDA port "
                    "(reference CSV format)")
    ap.add_argument("--backend", default="gpu", choices=("gpu", "c"))
    ap.add_argument("--engine", default="auto", choices=sorted(ENGINES),
                    help="gpu backend engine: cuda (the hand-written kernels), bitslice "
                         "(their plain torch versions), ttable (the T-table oracle: a gather "
                         "path, not constant time), auto (on the card the engine ranking's "
                         "first kernel engine, cuda; bitslice on the CPU)")
    ap.add_argument("--device", default="cuda",
                    help="gpu backend device (default cuda; without a card it raises "
                         "unless --device cpu is passed)")
    ap.add_argument("--sizes-mb", default="1,10,100,1000",
                    help="comma list of message sizes in MiB")
    ap.add_argument("--workers", default="",
                    help="comma list of worker counts (default: 1,2,4,8 capped "
                         "at the device count)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--keybits", type=int, default=256, choices=(128, 192, 256))
    ap.add_argument("--modes", default="ecb,ecb-dec,ctr,cbc-dec,rc4",
                    help="comma list from ecb,ecb-dec,ctr,cbc,cbc-dec,"
                         "cfb128,rc4,cbc-batch,rc4-batch (decrypt rows "
                         "measure the inverse circuit; CTR is symmetric)")
    ap.add_argument("--streams", type=int, default=32,
                    help="independent streams for the batch modes (cbc-batch/rc4-batch)")
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--timing", default="e2e", choices=("e2e", "device", "device-sync"),
                    help="e2e includes host<->device staging; device reports per-pass "
                         "device time by the chained difference (one CUDA graph of 1+k "
                         "dependent passes); device-sync times each call to a synchronize")
    ap.add_argument("--stream-chunk-mb", type=int, default=0, metavar="MB",
                    help="CTR messages larger than this stream through the device in "
                         "MB-sized chunks with the counter carried across seams (gpu "
                         "backend); streamed rows are e2e-timed and announced. 0 disables")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the sweep into DIR "
                         "(gpu backend only)")
    ap.add_argument("--out", default=None,
                    help="also write results to this file (e.g. results.$(hostname).gpu)")
    ap.add_argument("--default-out", action="store_true",
                    help="write to results.<host>.<backend>")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="checkpoint/resume journal (JSONL; env OT_SWEEP_JOURNAL is the "
                         "default): completed units append as they finish, and a rerun with "
                         "the same config skips them, re-emitting their rows and restoring "
                         "the RNG stream. A changed config invalidates the journal")
    ap.add_argument("--isolate", action="store_true",
                    help="run each sweep unit in its own child process with a wall "
                         "deadline (--unit-deadline): a hung unit is SIGKILLed and "
                         "journaled as failed, and a unit that fails --quarantine-after "
                         "times is quarantined (skipped, degraded:[quarantined:<unit>]). "
                         "Requires --journal and an explicit --workers list")
    ap.add_argument("--unit-deadline", type=float, metavar="S",
                    default=float(os.environ.get("OT_UNIT_DEADLINE", 600)),
                    help="--isolate: per-unit wall deadline in seconds (env OT_UNIT_DEADLINE)")
    ap.add_argument("--quarantine-after", type=int, metavar="N",
                    default=int(os.environ.get("OT_QUARANTINE_AFTER", 3)),
                    help="quarantine a unit after N recorded failures, counted across runs "
                         "(env OT_QUARANTINE_AFTER)")
    ap.add_argument("--dispatch-deadline", type=float, metavar="S",
                    default=watchdog_mod.default_deadline_s(),
                    help="watchdog deadline around each unit's work: on expiry the "
                         "stacks are dumped, the unit fails with DispatchTimeout and a "
                         "journaled sweep moves on. 0 disables (env OT_DISPATCH_DEADLINE)")
    ap.add_argument("--unquarantine", action="append", default=None, metavar="UNIT",
                    help="clear UNIT's recorded failure rows from the journal (repeatable); "
                         "requires --journal; no sweep runs")
    ap.add_argument("--isolate-child", default=None, metavar="UNIT",
                    help=argparse.SUPPRESS)  # internal: run exactly UNIT
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="under python -m torch.distributed.run: the ranks' transport (default "
                         "nccl on a card, gloo on the CPU; gloo on a card for ranks that share "
                         "it)")
    args = ap.parse_args(argv)

    sizes = []
    for tok in args.sizes_mb.split(","):
        if not tok:
            continue
        nbytes = int(float(tok) * MIB) // 16 * 16  # whole AES blocks only
        if nbytes <= 0:
            ap.error(f"--sizes-mb entry {tok!r} is below one 16-byte block")
        sizes.append(nbytes)
    modes = [m.strip() for m in args.modes.split(",") if m.strip()]
    journal_path = args.journal or os.environ.get("OT_SWEEP_JOURNAL")

    if args.unquarantine:
        # A ledger edit, not a sweep: no backend, whatever the config hash.
        if not journal_path:
            ap.error("--unquarantine requires --journal "
                     "(or OT_SWEEP_JOURNAL): the journal holds the "
                     "failure rows to clear")
        cleared = journal_mod.clear_failures(journal_path, args.unquarantine)
        for unit, n in sorted(cleared.items()):
            if n:
                trace_mod.point("quarantine-release", unit=unit, cleared=n)
            print(f"# unquarantine: {unit}: cleared {n} failure row(s)"
                  + ("" if n else " — none were on file"), file=sys.stderr, flush=True)
        return 0

    isolate_parent = args.isolate and args.isolate_child is None
    if isolate_parent:
        # The supervising parent never makes a backend (never touches the
        # device), so the config must be derivable without one.
        if not journal_path:
            ap.error("--isolate requires --journal (or OT_SWEEP_JOURNAL): "
                     "the journal is the supervisor's unit ledger")
        if not args.workers:
            ap.error("--isolate requires an explicit --workers list (the "
                     "parent cannot ask the device for a worker cap)")
    if args.workers:
        workers_list = [int(w) for w in args.workers.split(",") if w]

    if isolate_parent:
        out_path = args.out
        if args.default_out and not out_path:
            out_path = f"results.{socket.gethostname().split('.')[0]}.{args.backend}"
        em = Emitter(out_path)
        config = _sweep_config(args, sizes, workers_list, modes)
        names = _unit_names(modes, sizes, workers_list)
        # Every sweep-shaping flag, forwarded so each child derives the same
        # config hash (a child hashing differently would truncate the
        # parent's journal).
        child_config_flags = {
            "backend": ("--backend", args.backend),
            "engine": ("--engine", args.engine),
            "sizes": ("--sizes-mb", args.sizes_mb),
            "workers": ("--workers", args.workers),
            "iters": ("--iters", str(args.iters)),
            "keybits": ("--keybits", str(args.keybits)),
            "modes": ("--modes", args.modes),
            "streams": ("--streams", str(args.streams)),
            "seed": ("--seed", str(args.seed)),
            "timing": ("--timing", args.timing),
            "stream_chunk_mb": ("--stream-chunk-mb", str(args.stream_chunk_mb)),
        }
        assert set(child_config_flags) == set(config), (
            "sweep-config fields without a forwarded child flag: "
            f"{set(config) ^ set(child_config_flags)}")
        child_base = [
            sys.executable, "-m", "our_tree_tpu_torch.harness.bench",
            *(tok for flag in child_config_flags.values() for tok in flag),
            "--device", args.device,
            "--journal", journal_path,
            "--quarantine-after", str(args.quarantine_after),
            "--dispatch-deadline", str(args.dispatch_deadline),
            "--isolate",
        ]
        try:
            with trace_mod.span("sweep", role="supervisor", backend=args.backend,
                                modes=args.modes):
                quarantined = isolate_mod.run_isolated_sweep(
                    units=names,
                    child_argv=lambda unit: child_base + ["--isolate-child", unit],
                    journal_path=journal_path, config=config, emit=em.line,
                    unit_deadline_s=args.unit_deadline,
                    quarantine_after=args.quarantine_after)
            if quarantined:
                print(f"# isolate: quarantined unit(s): {','.join(quarantined)}",
                      file=sys.stderr)
            if degrade_mod.events():
                em.line("# degraded: " + ",".join(degrade_mod.events()))
        finally:
            em.close()
        return 0

    rank = None
    if "WORLD_SIZE" in os.environ and args.isolate_child is None:
        # A rank of a world launched by python -m torch.distributed.run.
        if args.backend != "gpu" or journal_path or args.isolate:
            ap.error("a torch.distributed world drives the gpu backend only, without "
                     "--journal or --isolate")
        from ..parallel import multihost

        multihost.initialize_from_env(device=args.device, backend=args.dist_backend)
        import torch.distributed as tdist

        rank = tdist.get_rank()
    try:
        return _sweep(args, sizes, modes, journal_path, workers_list if args.workers else None,
                      rank=rank or 0)
    finally:
        if rank is not None:
            multihost.shutdown()


def _sweep(args, sizes, modes, journal_path, workers_list, rank: int = 0) -> int:
    """The sweep in this process (rank ``rank`` of a world, or alone)."""
    backend = make_backend(args.backend, args.engine, args.device)
    if not args.workers:
        cap = getattr(backend, "max_workers", 8)
        workers_list = [w for w in (1, 2, 4, 8) if w <= cap] or [1]

    out_path = args.out
    if args.default_out and not out_path:
        out_path = f"results.{socket.gethostname().split('.')[0]}.{args.backend}"
    em = Emitter(out_path if rank == 0 else None, quiet=rank != 0)
    rng = np.random.default_rng(args.seed)  # the reference's srand(1337)

    journal = None
    if journal_path:
        journal = journal_mod.SweepJournal(
            journal_path, _sweep_config(args, sizes, workers_list, modes))
        if journal.pending:
            print(f"# journal: {journal.pending} completed unit(s) on file "
                  f"({journal_path}); resuming", file=sys.stderr)

    # The sweep as an ordered list of named units, the journal's resume
    # granularity; each closure takes the unit's row checkpoint (the batch
    # and check units ignore it: their invariance checks need every row).
    def aes_unit(mode, size):
        return lambda rows=None: run_aes_mode(
            em, backend, mode, size, workers_list, args.iters, args.keybits,
            rng, args.timing, stream_chunk=args.stream_chunk_mb * MIB, rows=rows)

    units = []
    for mode in modes:
        for size in sizes:
            if mode == "rc4":
                units.append((f"rc4:{size}",
                              lambda size=size, rows=None: run_rc4(
                                  em, backend, size, workers_list,
                                  args.iters, rng, args.timing, rows=rows)))
            elif mode == "cbc-batch":
                units.append((f"cbc-batch:{size}",
                              lambda size=size, rows=None: run_cbc_batch(
                                  em, backend, size, workers_list,
                                  args.iters, args.keybits, rng,
                                  args.timing, args.streams)))
            elif mode == "rc4-batch":
                units.append((f"rc4-batch:{size}",
                              lambda size=size, rows=None: run_rc4_batch(
                                  em, backend, size, workers_list,
                                  args.iters, rng, args.streams)))
            else:
                units.append((f"{mode}:{size}", aes_unit(mode, size)))
    if len(workers_list) > 1 and {"ecb", "ctr"} & set(modes):
        units.append(("shard-invariance",
                      lambda rows=None: check_shard_invariance(
                          em, backend, min(sizes), workers_list, args.keybits, rng)))
    if "rc4" in modes:
        units.append(("arc4-self-test", lambda rows=None: arc4_self_test(em, args.device)))
    assert [n for n, _ in units] == _unit_names(modes, sizes, workers_list)

    profiler_cm = None
    if args.profile and args.backend == "gpu":
        from ..obs import profiler as profiler_mod

        profiler_cm = profiler_mod.sweep_capture(args.profile, device=backend.device)
        profiler_cm.__enter__()
    counts = getattr(backend, "launch_counts", None)
    target = args.isolate_child
    try:
        for name, run_unit in units:
            if journal is not None:
                if target is None and journal.fail_count(name) >= args.quarantine_after:
                    # Quarantined in earlier runs: skip it, loudly.
                    trace_mod.point("quarantine", unit=name, fails=journal.fail_count(name))
                    degrade_mod.degrade(f"quarantined:{name}",
                                        f"{journal.fail_count(name)} journaled failure(s)")
                    continue
                # An isolated child consumes by name (take); the in-process
                # path keeps the strict-order skip, which the RNG restore needs.
                entry = ((journal.take(name) if target is not None else journal.skip(name))
                         if journal.is_completed(name) else None)
                if entry is not None:
                    # Completed in an earlier run: re-emit its rows, restore
                    # the RNG and the unit's recorded demotions.
                    for line in entry.get("lines", []):
                        em.line(line)
                    state = entry.get("rng_state")
                    if state is not None:
                        rng.bit_generator.state = state
                    for kind in entry.get("degraded", []):
                        degrade_mod.degrade(kind, "restored from journal")
                    trace_mod.point("unit-replayed", unit=name)
                    continue
            if target is not None and name != target:
                continue  # an isolated child runs only its unit
            before = set(degrade_mod.events())
            launched = counts() if counts else None
            em.begin_capture()
            rows_cp = _RowCheckpoint(journal, name, em, rng) if journal is not None else None
            try:
                with trace_mod.span("unit", unit=name):
                    # unit_crash: the injected stand-in for a child dying
                    # mid-unit; in process the raise escapes main().
                    faults_mod.check("unit_crash", f"unit {name}")
                    with watchdog_mod.deadline(args.dispatch_deadline,
                                               what=f"sweep unit {name}"):
                        run_unit(rows=rows_cp)
            except watchdog_mod.DispatchTimeout as e:
                em.end_capture()
                print(f"# watchdog: {e}", file=sys.stderr, flush=True)
                if target is not None:
                    raise  # the supervisor records the child's failure
                if journal is not None:
                    reason = f"watchdog:{args.dispatch_deadline:.0f}s"
                    journal.record_failure(name, reason)
                    trace_mod.point("unit-failed", unit=name, reason=reason)
                continue
            finally:
                lines = em.end_capture()
            if counts:
                now = counts()
                print(f"# launches{f' rank {rank}' if rank else ''}: {name} "
                      + json.dumps({k: now[k] - launched[k] for k in now}),
                      file=sys.stderr, flush=True)
            if journal is not None:
                journal.record(name, lines, rng.bit_generator.state,
                               [k for k in degrade_mod.events() if k not in before])
            if target is not None:
                return 0  # a child runs exactly one unit
        if target is not None:
            # The target never came up: already journaled, or the configs
            # diverged.
            return 0 if (journal is not None and journal.resumed) else 3
        if journal is not None and journal.resumed:
            print(f"# journal: skipped {journal.resumed} completed unit(s)", file=sys.stderr)
        if degrade_mod.events():
            em.line("# degraded: " + ",".join(degrade_mod.events()))
    finally:
        if profiler_cm is not None:
            profiler_cm.__exit__(None, None, None)
        if journal is not None:
            journal.close()
        em.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
